"""The Gibbs label draw of the port: K2's and K3's draw epilogues.

A draw scores every candidate kernel j of a row (the K2/K3 log-weights) and
takes the Gumbel-max label argmax_j logw + (-log(-log(max(u, tiny)))) from
uniforms u. The solve paths launch the fused draw on the card; its plain
version is what the wrappers compute on CPU tensors.

- The plain draw is bit-equal to ``kde.categorical(plain logw, gen)`` from
  the same generator state, so the solves' random stream is unchanged: at
  (V, N, Nj) = (1, 100, 100), (22, 100, 100) and (101, 100, 100), for K2 and
  for K3 at dof 1, 2, 3 and 8 with mixed circular masks.
- Ties go to the first index, as ``torch.argmax`` decides.
- Against the JAX package: the Pallas ``se2_pairwise_logw`` /
  ``euclid_pairwise_logw`` run as the JAX tests run them on the CPU
  (interpret mode) plus the same u through numpy give the same labels,
  except at near-ties (the port's pick within 1e-4 * (1 + |max|) of the
  maximum): the two compute the scores in another order (2e-5 apart).
- A seeded loop-engine solve keeps the belief means it had before the draw
  moved into the kernels.
- The wrappers check u and never take the plain path for a CUDA tensor;
  the kernels run only on a card (marker ``cuda``), held there to the plain
  draw by the label rule of ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rome_tpu.ops import pairwise as JP  # noqa: E402
from rome_tpu_torch.manifolds import base as TM  # noqa: E402
from rome_tpu_torch.ops import pairwise as TP  # noqa: E402
from rome_tpu_torch.ops import pairwise_cuda as K  # noqa: E402
from rome_tpu_torch.solvers.multimodal.kde import categorical, pairwise_draw  # noqa: E402

TINY = np.finfo(np.float32).tiny
NEAR_TIE = 1e-4
SHAPES = [(1, 100, 100), (22, 100, 100), (101, 100, 100)]
KERNELS = ["se2", "euclid1", "euclid2", "euclid3", "euclid8"]


def _inputs(kernel, V, N, Nj, seed=0):
    """Seeded (ref, mu, pts, inv_var) float32 arrays and the circular mask
    (None for K2); angles at and next to +-pi."""
    rng = np.random.default_rng(seed)
    dof = 3 if kernel == "se2" else int(kernel[-1])
    ref = rng.uniform(-np.pi, np.pi, (V, N, dof))
    pts = rng.uniform(-np.pi, np.pi, (V, Nj, dof))
    if kernel == "se2":
        ref[..., :2] *= 3.0
        pts[..., :2] *= 3.0
    ref[:, :3, -1] = np.float32(np.pi) - np.float32(1e-6)
    pts[:, :4, -1] = -np.float32(np.pi)
    mu = rng.normal(size=(V, N, dof)) * 0.5
    iv = rng.uniform(0.5, 4.0, (V, dof))
    circ = None if kernel == "se2" else (np.arange(dof) % 2 == 0).astype(np.float32)
    return [a.astype(np.float32) for a in (ref, mu, pts, iv)], circ


def _t(arrs, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in arrs]


def _logw_plain(kernel, arrs, circ):
    if circ is None:
        return TP.se2_pairwise_logw_plain(*arrs)
    return TP.euclid_pairwise_logw_plain(*arrs, circ)


def _draw(kernel, arrs, circ, u):
    if circ is None:
        return K.se2_gibbs_draw(*arrs, u)
    return K.euclid_gibbs_draw(*arrs, circ, u)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("V,N,Nj", SHAPES)
def test_plain_draw_is_categorical_of_plain_logw(kernel, V, N, Nj):
    arrs, circ = _inputs(kernel, V, N, Nj, seed=V + len(kernel))
    arrs = _t(arrs)
    circ = None if circ is None else torch.as_tensor(circ)
    gen = torch.Generator().manual_seed(V * 7 + N)
    want = categorical(_logw_plain(kernel, arrs, circ), gen)
    after_want = torch.rand(4, generator=gen)
    gen = torch.Generator().manual_seed(V * 7 + N)
    u = torch.rand((V, N, Nj), generator=gen, dtype=torch.float32)
    got = _draw(kernel, arrs, circ, u)
    assert got.dtype == torch.int64 and got.shape == (V, N)
    assert torch.equal(got, want)
    # the generator ends where categorical left it: the stream goes on alike
    assert torch.equal(torch.rand(4, generator=gen), after_want)
    if circ is None:
        assert torch.equal(TP.se2_gibbs_draw_plain(*arrs, u), want)
    else:
        assert torch.equal(TP.euclid_gibbs_draw_plain(*arrs, circ, u), want)


@pytest.mark.parametrize("name", ["SE2", "T2", "T3", "SO2"])
def test_draw_dispatch_follows_the_score_dispatch(name):
    man = {"SE2": TM.SE2(), "T2": TM.TranslationGroup(2), "T3": TM.TranslationGroup(3),
           "SO2": TM.SO2()}[name]
    kernel = "se2" if name == "SE2" else f"euclid{man.dof}"
    arrs, _ = _inputs(kernel, 2, 9, 11, seed=3)
    arrs = _t(arrs)
    gen = torch.Generator().manual_seed(1)
    u = torch.rand((2, 9, 11), generator=gen)
    logw = TP.pairwise_logw_for(man)(*arrs)
    assert torch.equal(pairwise_draw(man)(*arrs, u), TP.gumbel_argmax(logw, u))
    assert (TP.pairwise_draw_for(man) is K.se2_gibbs_draw) == (name == "SE2")


def test_ties_go_to_the_first_index():
    u = torch.full((3, 6), 0.5)
    logits = torch.tensor([[0.0] * 6, [0, 1, 3, 3, 1, 3.0], [-np.inf] * 6])
    assert TP.gumbel_argmax(logits, u).tolist() == [0, 2, 0]
    # identical candidates score alike: every row takes the first
    arrs, circ = _inputs("euclid2", 2, 5, 7, seed=4)
    arrs[2][:] = arrs[2][:, :1]
    got = K.euclid_gibbs_draw(*_t(arrs), torch.as_tensor(circ), torch.full((2, 5, 7), 0.3))
    assert got.tolist() == [[0] * 5] * 2
    # the best candidate duplicated at j = 2 and j = 5: j = 2 wins
    arrs, _ = _inputs("se2", 1, 4, 8, seed=5)
    arrs[2][0, 2] = arrs[2][0, 5] = arrs[0][0, 0]
    arrs[1][0, 0] = 0.0
    got = K.se2_gibbs_draw(*_t(arrs), torch.full((1, 4, 8), 0.5))
    assert int(got[0, 0]) == 2


def _near_tie_labels(got, want, total):
    """Rows where ``got`` differs from ``want`` must be near-ties of
    ``total`` (N, Nj); returns the count of differing rows."""
    rows = np.nonzero(got != want)[0]
    mx = total.max(axis=-1)
    gap = mx[rows] - total[rows, got[rows]]
    assert np.all(gap <= NEAR_TIE * (1.0 + np.abs(mx[rows]))), gap
    return len(rows)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("N,Nj", [(37, 101), (100, 100)])
def test_plain_draw_matches_jax_pallas(kernel, N, Nj):
    arrs, circ = _inputs(kernel, 1, N, Nj, seed=N + len(kernel))
    ref, mu, pts, iv = (a[0] for a in arrs)
    if circ is None:
        logw = np.asarray(JP.se2_pairwise_logw(ref, mu, pts, iv))
    else:
        logw = np.asarray(JP.euclid_pairwise_logw(ref, mu, pts, iv, circ))
    u = np.random.default_rng(N).uniform(size=(N, Nj)).astype(np.float32)
    u[0, :5] = 0.0  # clamped to the smallest normal float
    total = logw + (-np.log(-np.log(np.maximum(u, TINY))))
    want = np.argmax(total, axis=-1)
    tc = None if circ is None else torch.as_tensor(circ)
    got = _draw(kernel, _t((ref, mu, pts, iv)), tc, torch.as_tensor(u)).numpy()
    assert got.shape == (N,)
    assert _near_tie_labels(got, want, total) <= 1


def test_seeded_loop_solve_keeps_its_beliefs():
    """The loop engine's Gibbs products (``kde.gibbs_product``) draw their
    labels through the draw dispatch; a seeded CPU solve keeps the belief
    means recorded before the draw moved into the kernels' epilogue (a
    changed random stream moves them by far more than 1e-5)."""
    import rome_tpu_torch as T

    fg = T.generate_graph_hexagonal(N=30)
    T.solve_graph_nonparametric(fg, sweeps=1, N=30, engine="loop", seed=5, device="cpu")
    want = {
        "x0": (-0.025163923824826875, -0.05778571702539921, 0.0407629648844401),
        "x1": (9.881727504730225, 0.03480737457672755, 1.089561398824056),
        "x2": (14.553096516927083, 8.957872772216797, 2.128009223937988),
        "x3": (9.266924254099528, 17.387368138631185, -0.18158891201019287),
        "x4": (-0.17917945782343547, 17.172931702931724, -2.0687236547470094),
        "x5": (-4.409022601445516, 8.26151016553243, -1.0001639127731323),
        "x6": (0.18427487711111704, -0.6214529052376747, 0.10069084167480469),
        "l1": (20.488291041056314, 1.3004565700888633),
    }
    assert list(fg._var_order) == list(want)
    for label, mean in want.items():
        got = np.asarray(fg.variables[label].beliefs["default"], dtype=np.float64).mean(0)
        np.testing.assert_allclose(got, mean, rtol=0, atol=1e-5, err_msg=label)


def test_draw_wrappers_check_u_and_count_no_cpu_launch():
    arrs = _t(_inputs("se2", 2, 5, 6)[0])
    u = torch.rand((2, 5, 6))
    before = dict(K.LAUNCHES)
    assert K.se2_gibbs_draw(*arrs, u).shape == (2, 5)
    assert K.se2_gibbs_draw(*(a[0] for a in arrs), u[0]).shape == (5,)
    assert K.LAUNCHES == before  # the plain path launches nothing
    with pytest.raises(ValueError, match="u must be"):
        K.se2_gibbs_draw(*arrs, u[:, :, :5])
    with pytest.raises(ValueError, match="u must be"):
        K.se2_gibbs_draw(*arrs, u.double())
    with pytest.raises(ValueError, match="u must be"):
        K.se2_gibbs_draw(*arrs, u.transpose(1, 2).contiguous().transpose(1, 2))
    e_arrs, circ = _inputs("euclid3", 1, 4, 0)
    with pytest.raises(ValueError, match="no candidate"):
        K.euclid_gibbs_draw(*_t(e_arrs), torch.as_tensor(circ), torch.rand((1, 4, 0)))
    e_arrs, circ = _inputs("euclid2", 1, 4, 3)
    with pytest.raises(ValueError, match="circ"):
        K.euclid_gibbs_draw(*_t(e_arrs), torch.ones(3), torch.rand((1, 4, 3)))


@pytest.mark.parametrize("kernel", ["se2", "euclid2"])
def test_cuda_tensor_never_takes_the_plain_draw(monkeypatch, kernel):
    """A CUDA-typed tensor reaches the kernel library: a build failure
    raises instead of falling back."""
    def no_build():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(K, "_lib", None)
    monkeypatch.setattr(K, "build", no_build)

    class FakeCuda:
        device = torch.device("cuda", 0)

    monkeypatch.setattr(K, "_check", lambda *a, **k: (1, 4, 5, 2))
    monkeypatch.setattr(K, "_check_circ", lambda *a: None)
    monkeypatch.setattr(K, "_check_u", lambda *a: None)
    monkeypatch.setattr(K, "_batched", lambda *a: (a, False))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        if kernel == "se2":
            K.se2_gibbs_draw(*([FakeCuda()] * 5))
        else:
            K.euclid_gibbs_draw(*([FakeCuda()] * 6))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the draw epilogues have no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("V,N,Nj", [(1, 1, 1), (1, 37, 101)] + SHAPES + [(101, 512, 512)])
def test_cuda_draw_matches_plain(cuda_device, kernel, V, N, Nj):
    arrs, circ = _inputs(kernel, V, N, Nj, seed=13)
    arrs = _t(arrs, cuda_device)
    circ = None if circ is None else torch.as_tensor(circ, device=cuda_device)
    u = torch.rand((V, N, Nj), generator=torch.Generator(device=cuda_device).manual_seed(2),
                   device=cuda_device)
    key = "se2_gibbs_draw" if circ is None else "euclid_gibbs_draw"
    before = K.LAUNCHES[key]
    got = _draw(kernel, arrs, circ, u)
    torch.cuda.synchronize()
    assert K.LAUNCHES[key] == before + 1
    total = (_logw_plain(kernel, arrs, circ)
             - torch.log(-torch.log(u.clamp_min(TINY)))).reshape(V * N, Nj).cpu().numpy()
    want = total.argmax(axis=-1)
    differ = _near_tie_labels(got.reshape(-1).cpu().numpy(), want, total)
    assert differ <= 0.001 * V * N
