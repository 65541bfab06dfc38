"""tools/torch/bench_multimodal.py against tools/bench_multimodal.py on the
CPU. The port's Gibbs draws come from torch generators, the JAX rows' from
JAX's PRNG, so the rows agree in distribution: the same keys and both gates
true, not the same numbers.

- ``hexagonal_7pose`` and ``multihypo_range_bearing`` in both packages at
  the JAX script's sizes (N = 100 particles, 400 for the convolution);
- the other four rows of the port at a small size (N = 30, the honeycomb
  and the tree grown 7 -> 14, beehive-10, the nullhypo convolution at
  N = 200), each gate true, the tree's regrow recycling at least one clique
  with its beliefs and points bit for bit;
- the summary's gates and ``all_gates_pass``.
"""

import os
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
sys.path.insert(0, REPO)

import tools.bench_multimodal as JB  # noqa: E402
from tools.torch import bench_multimodal as BM  # noqa: E402

KERNEL_COUNTS = {"se2_pairwise_logw", "euclid_pairwise_logw", "se2_gibbs_draw",
                 "euclid_gibbs_draw", "k1_lin", "k1_normal"}


@pytest.mark.parametrize("row", ["hexagonal_7pose", "multihypo_range_bearing"])
def test_row_matches_the_jax_script(row):
    jax_fn, port_fn = {"hexagonal_7pose": (JB.bench_hexagonal, BM.bench_hexagonal),
                       "multihypo_range_bearing": (JB.bench_multihypo, BM.bench_multihypo)}[row]
    want = jax_fn()
    got = port_fn(device="cpu")
    assert set(want) <= set(got), set(want) - set(got)
    assert want["accuracy_ok"] and got["accuracy_ok"], (want, got)
    # the CPU launches no kernel; every count is there and 0
    assert set(got["launches"]) == KERNEL_COUNTS and not any(got["launches"].values())


SMALL = {"honeycomb_grow_default": (BM.bench_honeycomb_grow, dict(steps=(7, 14), N=30)),
         "beehive_100pose": (BM.bench_beehive, dict(poses=10, N=30)),
         "bayes_tree_grow": (BM.bench_tree_grow, dict(N=30)),
         "pose3_nullhypo": (BM.bench_nullhypo, dict(N=200))}


@pytest.mark.parametrize("row", sorted(SMALL))
def test_port_row_passes_its_gate_at_a_small_size(row):
    fn, kw = SMALL[row]
    got = fn(device="cpu", **kw)
    gate = got["accuracy_ok"] if "accuracy_ok" in got else got["points_init"]["accuracy_ok"]
    assert gate, got
    assert set(got["launches"]) == KERNEL_COUNTS
    if row == "bayes_tree_grow":
        regrow = got["steps"][-1]
        assert regrow["recycled"] >= 1 and regrow["recycled_variables"] >= 1
        assert regrow["recycled_bit_identical"]
    if row == "beehive_100pose":
        assert len(got["points_init"]["err_by_run_m"]) == 2


def test_summary_rolls_up_every_gate():
    rows = {"a": {"accuracy_ok": True}, "b": {"points_init": {"accuracy_ok": True}}}
    doc = BM.summarize(rows, "cpu")
    assert doc["gates"] == {"a": True, "b": True} and doc["all_gates_pass"]
    rows["c"] = {"accuracy_ok": False}
    assert not BM.summarize(rows, "cpu")["all_gates_pass"]
    assert BM.ROWS == ("hexagonal_7pose", "honeycomb_grow_default", "beehive_100pose",
                       "bayes_tree_grow", "multihypo_range_bearing", "pose3_nullhypo")
