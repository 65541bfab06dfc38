"""lm_assemble_ms.batch: device milliseconds per executed LM iteration in the
captured program's ``lm.assemble`` phase (the normal equations' entry values
and the ND fronts' assembly), from its %globaltimer stamps in the window:
the phase's nanoseconds over its calls, one an iteration."""

from benchmark import spans


def read(run):
    return spans.phase_ms(run, "lm.assemble")
