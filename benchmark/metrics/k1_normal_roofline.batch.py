"""k1_normal_roofline.batch: K1's normal epilogue (csrc/pose2pose2_linearize.cu)
as a percent of its HBM roofline in the traced slice: the bytes a launch
moves on the batch's real factors (benchmark/roofline.py) at 3.35 TB/s over
the mean device time of a launch in the trace."""

from benchmark import roofline
from benchmark.stats import mean


def read(run):
    if run.trace is None:
        return None
    times = run.trace.kernels("pose2pose2_kernel", "NormalEpilogue")
    launches = sum(r["k1"]["normal"] for r in run.traced)
    if not times or not launches:
        return None
    nbytes = sum(r["k1"]["normal"] * r["k1_bytes"]["normal"] for r in run.traced) / launches
    return roofline.share_pct(nbytes, mean(times))
