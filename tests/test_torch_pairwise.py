"""The Gibbs pairwise-score kernels K2 and K3 of the port against the JAX
package.

- K2's and K3's plain versions (what the wrappers compute on CPU tensors)
  against the Pallas kernels ``se2_pairwise_logw`` / ``euclid_pairwise_logw``
  run as the JAX package's tests run them (interpret mode on the CPU), in
  float32 at rtol = atol = 2e-5 (tests/test_ops_pairwise.py:43): at
  N = Nj = 1 and off every tile (N = 37, Nj = 101), K3 at dof 1, 2, 3, 8
  with mixed circular masks and angles at and near +-pi, and a V > 1 batch
  held to the JAX kernel per variable.
- The static dispatch against ``pairwise_logw_for`` for SE(2), T(2), T(3)
  and SO(2): the same decision, and the chosen function's output.
- The wrappers: float32 only, shapes checked, a CUDA tensor never takes
  the plain version; the kernels themselves run only on a card (marker
  ``cuda``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rome_tpu.manifolds import base as JM  # noqa: E402
from rome_tpu.ops import pairwise as JP  # noqa: E402
from rome_tpu_torch.manifolds import base as TM  # noqa: E402
from rome_tpu_torch.ops import pairwise as TP  # noqa: E402
from rome_tpu_torch.ops import pairwise_cuda as K  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
PI = np.float32(np.pi)


def _se2_inputs(V, N, Nj, seed=0):
    rng = np.random.default_rng(seed)

    def poses(n):
        return np.concatenate(
            [rng.normal(size=(V, n, 2)) * 3, rng.uniform(-np.pi, np.pi, (V, n, 1))], -1
        )

    ref, pts = poses(N), poses(Nj)
    mu = rng.normal(size=(V, N, 3)) * 0.5
    iv = 1.0 / rng.uniform(0.1, 1.0, (V, 3))
    return [a.astype(np.float32) for a in (ref, mu, pts, iv)]


def _euclid_inputs(V, N, Nj, dof, seed=0):
    rng = np.random.default_rng(seed)
    ref = rng.uniform(-np.pi, np.pi, (V, N, dof))
    pts = rng.uniform(-np.pi, np.pi, (V, Nj, dof))
    # angles at and next to the wrap boundary
    ref[:, :3] = PI - np.float32(1e-6)
    pts[:, :4] = -PI + np.float32(1e-6)
    ref[:, 3:5] = -PI
    pts[:, 4:7] = PI
    mu = rng.normal(size=(V, N, dof)) * 0.5
    iv = rng.uniform(0.5, 4.0, (V, dof))
    circ = (np.arange(dof) % 2 == 0).astype(np.float32)
    return [a.astype(np.float32) for a in (ref, mu, pts, iv)], circ


def _t(arrs):
    return [torch.as_tensor(a) for a in arrs]


@pytest.mark.parametrize("N,Nj", [(1, 1), (37, 101), (100, 100)])
def test_k2_plain_matches_pallas(N, Nj):
    ref, mu, pts, iv = (a[0] for a in _se2_inputs(1, N, Nj, seed=N))
    want = np.asarray(JP.se2_pairwise_logw(ref, mu, pts, iv))
    got = K.se2_pairwise_logw(*_t((ref, mu, pts, iv)))
    assert got.shape == (N, Nj) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("dof", [1, 2, 3, 8])
@pytest.mark.parametrize("N,Nj", [(1, 1), (37, 101)])
def test_k3_plain_matches_pallas(dof, N, Nj):
    (ref, mu, pts, iv), circ = _euclid_inputs(1, N, Nj, dof, seed=dof)
    ref, mu, pts, iv = ref[0], mu[0], pts[0], iv[0]
    want = np.asarray(JP.euclid_pairwise_logw(ref, mu, pts, iv, circ))
    got = K.euclid_pairwise_logw(*_t((ref, mu, pts, iv)), torch.as_tensor(circ))
    assert got.shape == (N, Nj)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("kernel", ["se2", "euclid"])
def test_batched_plain_matches_pallas_per_variable(kernel):
    V, N, Nj = 4, 37, 101
    if kernel == "se2":
        arrs = _se2_inputs(V, N, Nj, seed=7)
        got = K.se2_pairwise_logw(*_t(arrs))
        want = [JP.se2_pairwise_logw(*(a[v] for a in arrs)) for v in range(V)]
    else:
        arrs, circ = _euclid_inputs(V, N, Nj, 3, seed=7)
        got = K.euclid_pairwise_logw(*_t(arrs), torch.as_tensor(circ))
        want = [JP.euclid_pairwise_logw(*(a[v] for a in arrs), circ) for v in range(V)]
    assert got.shape == (V, N, Nj)
    np.testing.assert_allclose(got.numpy(), np.stack([np.asarray(w) for w in want]), **TOL)


@pytest.mark.parametrize("name", ["SE2", "T2", "T3", "SO2"])
def test_dispatch_matches_jax(name):
    jman, tman = {
        "SE2": (JM.SE2(), TM.SE2()),
        "T2": (JM.TranslationGroup(2), TM.TranslationGroup(2)),
        "T3": (JM.TranslationGroup(3), TM.TranslationGroup(3)),
        "SO2": (JM.SO2(), TM.SO2()),
    }[name]
    jfn, tfn = JP.pairwise_logw_for(jman), TP.pairwise_logw_for(tman)
    assert (jfn is None) == (tfn is None)
    assert (tfn is K.se2_pairwise_logw) == (jfn is JP.se2_pairwise_logw)
    dof = tman.dof
    if name == "SE2":
        arrs = [a[0] for a in _se2_inputs(1, 9, 11, seed=3)]
    else:
        arrs = [a[0] for a in _euclid_inputs(1, 9, 11, dof, seed=3)[0]]
    want = np.asarray(jfn(*arrs))
    got = tfn(*(t[None] for t in _t(arrs)))[0]
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_wrappers_check_their_inputs_and_count_no_cpu_launch():
    arrs = _t(_se2_inputs(2, 5, 6))
    before = dict(K.LAUNCHES)
    assert K.se2_pairwise_logw(*arrs).shape == (2, 5, 6)
    assert K.LAUNCHES == before  # the plain path launches nothing
    with pytest.raises(TypeError, match="float32"):
        K.se2_pairwise_logw(*(a.double() for a in arrs))
    with pytest.raises(ValueError, match="inv_var"):
        K.se2_pairwise_logw(*arrs[:3], arrs[3][:1])
    with pytest.raises(ValueError, match="dof 3"):
        K.se2_pairwise_logw(*(a[..., :2].contiguous() for a in arrs))
    with pytest.raises(ValueError, match="contiguous"):
        K.se2_pairwise_logw(arrs[0].transpose(0, 1).contiguous().transpose(0, 1), *arrs[1:])
    (e_arrs, circ) = _euclid_inputs(1, 3, 4, 9)
    with pytest.raises(ValueError, match="dof <= 8"):
        K.euclid_pairwise_logw(*_t(e_arrs), torch.as_tensor(circ))
    (e_arrs, circ) = _euclid_inputs(1, 3, 4, 2)
    with pytest.raises(ValueError, match="circ"):
        K.euclid_pairwise_logw(*_t(e_arrs), torch.ones(3))


def test_cuda_tensor_never_takes_the_plain_path(monkeypatch):
    """A CUDA-typed tensor reaches the kernel library: a build failure
    raises instead of falling back; a meta tensor has no path at all."""
    def no_build():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(K, "_lib", None)
    monkeypatch.setattr(K, "build", no_build)
    meta = [torch.zeros(s, device="meta") for s in ((1, 4, 3), (1, 4, 3), (1, 5, 3), (1, 3))]
    with pytest.raises(ValueError, match="no path for device meta"):
        K.se2_pairwise_logw(*meta)

    class FakeCuda:
        device = torch.device("cuda", 0)

    monkeypatch.setattr(K, "_check", lambda *a, **k: (1, 4, 5, 3))
    monkeypatch.setattr(K, "_batched", lambda *a: (a, False))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.se2_pairwise_logw(*([FakeCuda()] * 4))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K2 and K3 have no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("V,N,Nj", [(1, 1, 1), (1, 37, 101), (101, 100, 100), (101, 512, 512)])
def test_k2_cuda_kernel_matches_plain(cuda_device, V, N, Nj):
    arrs = [t.to(cuda_device) for t in _t(_se2_inputs(V, N, Nj, seed=11))]
    before = K.LAUNCHES["se2_pairwise_logw"]
    got = K.se2_pairwise_logw(*arrs)
    torch.cuda.synchronize()
    assert K.LAUNCHES["se2_pairwise_logw"] == before + 1
    torch.testing.assert_close(got, TP.se2_pairwise_logw_plain(*arrs), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dof", [1, 2, 3, 8])
@pytest.mark.parametrize("V,N,Nj", [(1, 37, 101), (74, 100, 100)])
def test_k3_cuda_kernel_matches_plain(cuda_device, dof, V, N, Nj):
    arrs, circ = _euclid_inputs(V, N, Nj, dof, seed=12)
    arrs = [t.to(cuda_device) for t in _t(arrs)]
    circ = torch.as_tensor(circ, device=cuda_device)
    got = K.euclid_pairwise_logw(*arrs, circ)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, TP.euclid_pairwise_logw_plain(*arrs, circ), **TOL)
