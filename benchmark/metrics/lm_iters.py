"""lm_iters (lm_iters.batch, lm_iters.fixedlag): LM iterations per solve or
fixed-lag step (the solver's stats), mean over the window's requests."""

from benchmark.stats import mean


def read(run):
    return mean(r["iterations"] for r in run.requests)
