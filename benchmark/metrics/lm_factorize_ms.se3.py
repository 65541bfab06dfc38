"""lm_factorize_ms.se3: device milliseconds per executed LM iteration in the
captured program's ``lm.factorize`` phase (the f32 nested-dissection
Cholesky of 6 x 6 blocks), from its %globaltimer stamps in the window."""

from benchmark import spans


def read(run):
    return spans.phase_ms(run, "lm.factorize")
