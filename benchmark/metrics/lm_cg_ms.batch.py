"""lm_cg_ms.batch: device milliseconds per executed LM iteration in the
captured program's ``lm.cg`` phase (the guarded CG polish with its ND solve
sweeps and Hvps), from its %globaltimer stamps in the window: the phase's
nanoseconds over its calls, one an iteration."""

from benchmark import spans


def read(run):
    return spans.phase_ms(run, "lm.cg")
