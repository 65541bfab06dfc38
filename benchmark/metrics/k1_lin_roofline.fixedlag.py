"""k1_lin_roofline.fixedlag: K1's lin epilogue as a percent of its HBM
roofline in the traced steps: the bytes of each step's real factors (those
touching a free pose, not the padded bucket) at 3.35 TB/s over the mean
device time of a launch in the trace."""

from benchmark import roofline
from benchmark.stats import mean


def read(run):
    if run.trace is None:
        return None
    times = run.trace.kernels("pose2pose2_kernel", "LinEpilogue")
    launches = sum(r["k1"]["lin"] for r in run.traced)
    if not times or not launches:
        return None
    nbytes = sum(r["k1"]["lin"] * r["k1_bytes"]["lin"] for r in run.traced) / launches
    return roofline.share_pct(nbytes, mean(times))
