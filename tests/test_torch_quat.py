"""The port's unit-quaternion functions (rome_tpu_torch/manifolds/quat.py)
against the JAX package's, in float64 at atol 1e-12 on seeded inputs that
include the Taylor-guard edges: rotations of 0, 1e-7, 1e-3 and pi - 1e-6
rad, negative-w quaternions (the double cover) and Shepperd's four pivot
branches. ``jacfwd`` of qexp/qlog is held to ``jax.jacfwd`` at the same
points, and stays finite in float32 across the guards."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.func import jacfwd, vmap  # noqa: E402

from rome_tpu.manifolds import quat as JQ  # noqa: E402
from rome_tpu.utils.math import skew3 as jskew3  # noqa: E402
from rome_tpu_torch.manifolds import quat as TQ  # noqa: E402
from rome_tpu_torch.utils.math import skew3, wrap_angle  # noqa: E402

ATOL = 1e-12
EDGE_ANGLES = (0.0, 1e-7, 1e-3, np.pi - 1e-6)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _j(fn, *args):
    with jax.enable_x64():
        return np.array(fn(*(jnp.asarray(a) for a in args)))


def _rotvecs(n=200, seed=0):
    """Random rotation vectors, plus each edge angle about a random axis and
    about each coordinate axis."""
    rng = np.random.default_rng(seed)
    phi = rng.normal(0, 1.2, (n, 3))
    axes = rng.normal(size=(len(EDGE_ANGLES), 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    edge = [a * ax for a, ax in zip(EDGE_ANGLES, axes)]
    edge += [a * np.eye(3)[k] for a in EDGE_ANGLES for k in range(3)]
    return np.concatenate([np.asarray(edge), phi])


def _quats(n=200, seed=1):
    """Unit quaternions of both signs of w, edge rotations included."""
    q = _j(JQ.qexp, _rotvecs(n, seed))
    q[1::2] *= -1.0
    return q


def test_identity_normalize_conj():
    np.testing.assert_array_equal(TQ.qidentity().numpy(), _j(lambda: JQ.qidentity(jnp.float64)))
    q = np.random.default_rng(2).normal(size=(64, 4))
    np.testing.assert_allclose(TQ.qnormalize(_t(q)).numpy(), _j(JQ.qnormalize, q), atol=ATOL)
    np.testing.assert_array_equal(TQ.qconj(_t(q)).numpy(), _j(JQ.qconj, q))


@pytest.mark.parametrize("fn", ["qmul", "qrotate"])
def test_binary_matches_jax(fn):
    a = _quats(seed=3)
    b = _quats(seed=4) if fn == "qmul" else np.random.default_rng(5).normal(0, 5, (a.shape[0], 3))
    got = getattr(TQ, fn)(_t(a), _t(b)).numpy()
    np.testing.assert_allclose(got, _j(getattr(JQ, fn), a, b), atol=ATOL)


def test_cross_matches_numpy_and_promotes():
    rng = np.random.default_rng(6)
    a, b = rng.normal(size=(50, 3)), rng.normal(size=(50, 3))
    np.testing.assert_allclose(TQ.cross(_t(a), _t(b)).numpy(), np.cross(a, b), atol=ATOL)
    got = TQ.cross(_t(a), torch.as_tensor(b, dtype=torch.float32))
    assert got.dtype == torch.float64


def test_qexp_matches_jax_at_the_guards():
    phi = _rotvecs(seed=7)
    got = TQ.qexp(_t(phi)).numpy()
    np.testing.assert_allclose(got, _j(JQ.qexp, phi), atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-12)


def test_qlog_matches_jax_at_the_guards():
    q = _quats(seed=8)
    got = TQ.qlog(_t(q)).numpy()
    np.testing.assert_allclose(got, _j(JQ.qlog, q), atol=ATOL)
    # the double cover: q and -q have the same log (w canonicalized >= 0)
    np.testing.assert_allclose(TQ.qlog(_t(-q)).numpy(), got, atol=ATOL)


def test_exp_log_round_trip():
    phi = _rotvecs(seed=9)
    phi = phi[np.linalg.norm(phi, axis=1) < np.pi - 1e-3]
    np.testing.assert_allclose(TQ.qlog(TQ.qexp(_t(phi))).numpy(), phi, atol=1e-9)


def test_matrix_conversions_match_jax():
    q = _quats(seed=10)
    R = _j(JQ.qto_matrix, q)
    np.testing.assert_allclose(TQ.qto_matrix(_t(q)).numpy(), R, atol=ATOL)
    got = TQ.qfrom_matrix(_t(R)).numpy()
    np.testing.assert_allclose(got, _j(JQ.qfrom_matrix, R), atol=ATOL)
    assert np.all(got[:, 0] >= 0.0)
    # each of Shepperd's pivots: the trace, and a rotation of pi about each axis
    piv = np.stack([np.eye(3)] + [2 * np.outer(e, e) - np.eye(3) for e in np.eye(3)])
    np.testing.assert_allclose(TQ.qfrom_matrix(_t(piv)).numpy(), _j(JQ.qfrom_matrix, piv),
                               atol=ATOL)


def test_skew3_and_wrap_angle():
    v = np.random.default_rng(11).normal(size=(20, 3))
    np.testing.assert_array_equal(skew3(_t(v)).numpy(), _j(jskew3, v))
    w = np.random.default_rng(12).normal(size=(3,))
    np.testing.assert_allclose(
        (skew3(_t(v)) @ _t(w)).numpy(), np.cross(v, w), atol=ATOL
    )
    x = np.linspace(-10, 10, 101)
    assert np.all(wrap_angle(_t(x)).numpy() < np.pi)


@pytest.mark.parametrize("fn", ["qexp", "qlog"])
def test_jacfwd_matches_jax(fn):
    """Forward-mode Jacobians at the guard edges, per point (vmap)."""
    pts = _rotvecs(n=40, seed=13) if fn == "qexp" else _quats(n=40, seed=14)
    got = vmap(jacfwd(getattr(TQ, fn)))(_t(pts)).numpy()
    with jax.enable_x64():
        want = np.asarray(jax.vmap(jax.jacfwd(getattr(JQ, fn)))(jnp.asarray(pts)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-9, rtol=1e-9)


@pytest.mark.parametrize("angle", EDGE_ANGLES)
def test_local_jacobian_finite_in_float32(angle):
    """The Jacobian the LM path takes in float32: d/dδ qlog(q_a⁻¹ (q_b ⊗
    qexp(δ))) at δ = 0 for relative rotations at the guard edges stays
    finite and float32, and agrees with the float64 one."""
    axis = np.array([0.3, -0.5, 0.8]) / np.linalg.norm([0.3, -0.5, 0.8])
    qa = _j(JQ.qexp, np.array([0.2, 0.1, -0.4]))
    qb = _j(JQ.qmul, qa, _j(JQ.qexp, angle * axis))

    def f(d, qa, qb):
        return TQ.qlog(TQ.qmul(TQ.qconj(qa), TQ.qmul(qb, TQ.qexp(d))))

    def jac(dtype):
        a, b = (torch.as_tensor(x, dtype=dtype)[None] for x in (qa, qb))
        return vmap(jacfwd(f))(torch.zeros((1, 3), dtype=dtype), a, b)[0]

    J32, J64 = jac(torch.float32), jac(torch.float64)
    assert J32.dtype == torch.float32 and torch.isfinite(J32).all()
    np.testing.assert_allclose(J32.double().numpy(), J64.numpy(), atol=2e-3 if angle > 3 else 2e-5)
