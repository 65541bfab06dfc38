"""device_idle.fixedlag: 1 - (the union of the device's operation intervals in
the traced steps / their length): the share of the window in which the
card ran nothing."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 1.0 - run.trace.busy_s / run.trace.window_s
