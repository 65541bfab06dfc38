"""k3_draw_roofline.nonparam: K3's draw epilogue (csrc/pairwise_logw.cu,
per-dim linear or circular scores and Gumbel-max labels) as a percent of
its HBM roofline in the traced requests: the bytes of a launch at the requests' shapes
(benchmark/roofline_k2k3.py) at 3.35 TB/s over the mean device time of a
launch in the trace."""

from benchmark import roofline, roofline_k2k3
from benchmark.stats import mean


def read(run):
    if run.trace is None:
        return None
    times = roofline_k2k3.draw_times(run.trace, "EuclidRow")
    launches = sum(r.get("k3", 0) for r in run.traced)
    if not times or not launches:
        return None
    nbytes = sum(r["k3"] * r["k3_bytes"] for r in run.traced) / launches
    return roofline.share_pct(nbytes, mean(times))
