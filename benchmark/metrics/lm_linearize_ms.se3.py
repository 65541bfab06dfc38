"""lm_linearize_ms.se3: device milliseconds per executed LM iteration in the
captured program's ``lm.linearize`` phase (the trial point's retraction and
the linearize of every batch; for Pose3 the generic f64 residual and f32
``vmap(jacfwd)`` passes), from its %globaltimer stamps in the window."""

from benchmark import spans


def read(run):
    return spans.phase_ms(run, "lm.linearize")
