"""k2_draw_roofline.nonparam: K2's draw epilogue (csrc/pairwise_logw.cu, SE(2)
scores and Gumbel-max labels) as a percent of its HBM roofline in the
traced requests: the bytes of a launch at the requests' shapes
(benchmark/roofline_k2k3.py) at 3.35 TB/s over the mean device time of a
launch in the trace."""

from benchmark import roofline, roofline_k2k3
from benchmark.stats import mean


def read(run):
    if run.trace is None:
        return None
    times = roofline_k2k3.draw_times(run.trace, "Se2Row")
    launches = sum(r.get("k2", 0) for r in run.traced)
    if not times or not launches:
        return None
    nbytes = sum(r["k2"] * r["k2_bytes"] for r in run.traced) / launches
    return roofline.share_pct(nbytes, mean(times))
