"""lm_cg_ms.se3: device milliseconds per executed LM iteration in the
captured program's ``lm.cg`` phase (the CG polish preconditioned by the
factorization), from its %globaltimer stamps in the window."""

from benchmark import spans


def read(run):
    return spans.phase_ms(run, "lm.cg")
