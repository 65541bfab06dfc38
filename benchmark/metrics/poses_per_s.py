"""poses_per_s: the poses of every graph solved in the window over the
window's seconds (host clock; one client in a closed loop)."""


def read(run):
    if not run.requests or run.window_s <= 0:
        return None
    return sum(r["poses"] for r in run.requests) / run.window_s
