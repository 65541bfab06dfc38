"""freeze_ms.fixedlag: mean milliseconds per window step in the front end's
``fifo_freeze`` span (``frontend/robot_utils.fifo_freeze``), host clock."""

from benchmark import spans


def read(run):
    return spans.span_ms(run, "fifo_freeze")
