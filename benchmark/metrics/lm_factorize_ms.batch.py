"""lm_factorize_ms.batch: device milliseconds per executed LM iteration in the
captured program's ``lm.factorize`` phase (the ND multifrontal float32
factorization), from its %globaltimer stamps in the window: the phase's
nanoseconds over its calls, one an iteration."""

from benchmark import spans


def read(run):
    return spans.phase_ms(run, "lm.factorize")
