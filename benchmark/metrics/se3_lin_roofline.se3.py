"""se3_lin_roofline.se3: one trial linearize of the sphere's LM iteration as a
percent of its roofline: the least time its real factors' bytes take at
3.35 TB/s (the operations' at the float32 peak are less;
``benchmark/roofline_se3.py``) over the ``lm.trial_linearize`` phase's
device time per call in the window; nothing where the program has no such
stamp."""

from benchmark import roofline_se3, spans


def read(run):
    ms = spans.phase_ms(run, "lm.trial_linearize")
    if ms is None or not run.requests:
        return None
    return roofline_se3.share_pct(run.requests[0]["trial_linearize_least_s"], ms / 1e3)
