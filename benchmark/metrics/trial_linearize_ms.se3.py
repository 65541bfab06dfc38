"""trial_linearize_ms.se3: device milliseconds per call of the captured
program's ``lm.trial_linearize`` phase (nested in ``lm.linearize``: every
batch linearized at the trial point, without the retraction), from its
%globaltimer stamps in the window; nothing where the program has no such
stamp."""

from benchmark import spans


def read(run):
    return spans.phase_ms(run, "lm.trial_linearize")
