"""The port's sharded nonparametric sweep (rome_tpu_torch/parallel/
multimodal.py) against the JAX package's, over a real gloo process group of
two ranks on the CPU (spawned from tests/torch_ranks.py).

- The hexagonal graph (N = 100, ``init=True``, 3 sweeps, seed 7) at world 2
  against the JAX package's ShardedNonparametricSolver at ndev 2 (key 7):
  tests/test_multimodal_sharded.py's bands (>= 35 of 100 particles within
  3 m / 0.3 rad of the simulated pose, the landmark within 3 m of (20, 0))
  and its symmetric k-NN KL bound (< 2.0 on x0, x3, x6 and l1, the sets
  jittered by 1e-4). The random streams of the two packages differ, so the
  parity is distributional, as the JAX module states for its own shards.
- Every rank ends with the same beliefs.
- The products do not depend on how the variables are split: the masked
  Gibbs product of rows lo..hi drawn from the shared stream equals rows
  lo..hi of the one-piece product, bit for bit, also with an empty slice.
- On the card (``cuda`` marker; skips here): K2 and K3's draw epilogues
  launch gibbs_sweeps x K times per sweep in every rank that holds rows of
  a Pose2 / Point2 type, and the logw epilogues never.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from rome_tpu.canonical.generators import generate_graph_hexagonal  # noqa: E402
from rome_tpu.manifolds.base import T2  # noqa: E402
from rome_tpu.parallel.multimodal import ShardedNonparametricSolver  # noqa: E402
from rome_tpu.solvers.multimodal.metrics import symmetric_kl_knn  # noqa: E402
from rome_tpu.utils.math import sym_rem  # noqa: E402
from rome_tpu_torch.manifolds.base import SE2_  # noqa: E402
from rome_tpu_torch.parallel.distributed import spawn_ranks  # noqa: E402
from rome_tpu_torch.solvers.multimodal.batched import _masked_gibbs  # noqa: E402
from torch_ranks import multimodal_rank  # noqa: E402


@pytest.fixture(scope="module")
def solves():
    ranks = spawn_ranks(multimodal_rank, 2, args=(100, 7, True), device="cpu")
    fg = generate_graph_hexagonal(N=100)
    ShardedNonparametricSolver(fg, Mesh(np.array(jax.devices()[:2]), ("f",)), N=100).solve(
        sweeps=3, key=jax.random.PRNGKey(7))
    return ranks, fg


def test_every_rank_holds_the_same_beliefs(solves):
    ranks, _fg = solves
    for lbl, b in ranks[0]["beliefs"].items():
        assert b.shape[0] == 100 and np.isfinite(b).all(), lbl
        np.testing.assert_array_equal(ranks[1]["beliefs"][lbl], b)


def test_sharded_hexagonal_in_the_bands(solves):
    ranks, fg = solves
    bel = ranks[0]["beliefs"]
    for i in range(7):
        sim = fg.get_ppe(f"x{i}")
        pts = bel[f"x{i}"]
        assert np.sum(np.abs(pts[:, 0] - sim[0]) < 3.0) >= 35, (i, "x")
        assert np.sum(np.abs(pts[:, 1] - sim[1]) < 3.0) >= 35, (i, "y")
        assert np.sum(np.abs(np.vectorize(sym_rem)(pts[:, 2] - sim[2])) < 0.3) >= 35, (i, "theta")
    assert np.sum(np.linalg.norm(bel["l1"] - np.array([20.0, 0]), axis=1) < 3.0) >= 35


def test_sharded_kl_against_the_jax_sharded_solve(solves):
    ranks, fg = solves
    rng = np.random.default_rng(0)
    for lbl in ["x0", "x3", "x6", "l1"]:
        a = np.asarray(fg.variables[lbl].beliefs["default"], np.float64)
        b = np.asarray(ranks[0]["beliefs"][lbl], np.float64)
        a = a + rng.normal(0, 1e-4, a.shape)
        b = b + rng.normal(0, 1e-4, b.shape)
        skl = symmetric_kl_knn(T2, a[:, :2], b[:, :2])
        assert np.isfinite(skl) and skl < 2.0, (lbl, skl)


def test_products_do_not_depend_on_the_split():
    g = torch.Generator().manual_seed(3)
    V, K, N = 7, 3, 30
    msgs = SE2_.normalize(torch.randn((V, K, N, 3), generator=g) * 2.0)
    mask = (torch.rand((V, K), generator=g) > 0.2).to(torch.float32)
    whole = _masked_gibbs(SE2_, msgs, mask, 3, torch.Generator().manual_seed(9))
    after = []
    for lo, hi in ((0, 4), (4, 7), (7, 7)):
        gen = torch.Generator().manual_seed(9)
        part = _masked_gibbs(SE2_, msgs[lo:hi], mask[lo:hi], 3, gen, rows=(lo, V))
        assert part.shape == (hi - lo, N, 3)
        torch.testing.assert_close(part, whole[lo:hi], rtol=0, atol=0)
        after.append(torch.rand(1, generator=gen).item())
    assert len(set(after)) == 1  # the shared stream is in step on every slice


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the draw epilogues have no CPU or interpret mode")
    return "cuda"


@pytest.mark.cuda
def test_draw_launches_in_every_rank_on_the_card(cuda_device):
    ranks = spawn_ranks(multimodal_rank, 2, args=(100, 7, "points"), device=cuda_device)
    # hexagonal: Pose2 K = 3 on both ranks, Point2 (one landmark, K = 2) on rank 0
    per_sweep = {0: (3 * 3, 3 * 2), 1: (3 * 3, 0)}
    for rank, r in enumerate(ranks):
        se2, euclid = (3 * n for n in per_sweep[rank])
        assert r["launches"]["se2_gibbs_draw"] == se2
        assert r["launches"]["euclid_gibbs_draw"] == euclid
        assert r["launches"]["se2_pairwise_logw"] == r["launches"]["euclid_pairwise_logw"] == 0
