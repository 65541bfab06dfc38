"""chordal_ms.batch: device milliseconds per solve of the captured program's
``lm.chordal`` phase (the chordal stages inside the LM program), from its
%globaltimer stamps in the window."""

from benchmark import spans


def read(run):
    return spans.phase_ms(run, "lm.chordal")
