"""device_idle.nonparam: 1 - (the union of the device's operation intervals
in the traced requests / their length): the share of a nonparametric solve
in which the card ran nothing."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 1.0 - run.trace.busy_s / run.trace.window_s
