"""lm_linearize_ms.batch: device milliseconds per executed LM iteration in the
captured program's ``lm.linearize`` phase (the trial point's boxplus and
linearize, K1's normal epilogue), from its %globaltimer stamps in the
window: the phase's nanoseconds over its calls, one an iteration."""

from benchmark import spans


def read(run):
    return spans.phase_ms(run, "lm.linearize")
