"""setup_s: process start to the first timed request (imports, kernel
builds in a fresh checkout, graph building, warm-up solves and captures)."""


def read(run):
    return run.setup_s
