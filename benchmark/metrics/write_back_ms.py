"""write_back_ms (write_back_ms.batch, write_back_ms.fixedlag): mean
milliseconds per window request in the program's ``solve.write_back`` span
(``graph/lower.write_back``), host clock."""

from benchmark import spans


def read(run):
    return spans.span_ms(run, "solve.write_back")
