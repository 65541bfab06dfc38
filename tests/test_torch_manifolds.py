"""The port's SE(2) manifold and angle wrap against the JAX package, in
float64 (atol 1e-12) on seeded random points, including angles at and
around the ±pi wrap."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rome_tpu.manifolds.base import SE2_ as JSE2, SO2_ as JSO2  # noqa: E402
from rome_tpu.utils.math import rot2 as jrot2, sym_rem as jsym_rem  # noqa: E402
from rome_tpu_torch.manifolds.base import SE2_ as TSE2, SO2_ as TSO2, T2  # noqa: E402
from rome_tpu_torch.utils.math import rot2, sym_rem, sym_rem_np  # noqa: E402

ATOL = 1e-12
EDGE_ANGLES = np.array(
    [np.pi, -np.pi, 3 * np.pi, -3 * np.pi, np.pi - 1e-15, -np.pi + 1e-15,
     np.pi + 1e-12, 2 * np.pi, 0.0, 1e-17]
)


def _points(n=257, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(0, 3, (n, 3))
    b = rng.normal(0, 3, (n, 3))
    a[: len(EDGE_ANGLES), 2] = EDGE_ANGLES
    b[: len(EDGE_ANGLES), 2] = EDGE_ANGLES[::-1]
    return a, b


def _t(a):
    return torch.as_tensor(a, dtype=torch.float64)


def _j(fn, *args):
    with jax.enable_x64():
        return np.asarray(fn(*(jnp.asarray(a) for a in args)))


def test_sym_rem_matches_jax_bitwise():
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.uniform(-20, 20, 10000), EDGE_ANGLES])
    np.testing.assert_array_equal(sym_rem(_t(x)).numpy(), _j(jsym_rem, x))
    # the float32 wrap is the same arithmetic too
    x32 = x.astype(np.float32)
    np.testing.assert_array_equal(
        sym_rem(torch.as_tensor(x32)).numpy(), np.asarray(jsym_rem(jnp.asarray(x32)))
    )
    # and the 0-dim path used under torch.func.vmap
    np.testing.assert_array_equal(sym_rem(_t(x[5])).numpy(), _j(jsym_rem, x[5]))


def test_sym_rem_range_and_numpy_twin():
    x = np.concatenate([np.linspace(-10, 10, 1001), EDGE_ANGLES])
    w = sym_rem(_t(x)).numpy()
    assert np.all(w >= -np.pi) and np.all(w < np.pi)
    np.testing.assert_allclose(np.cos(w), np.cos(x), atol=1e-12)
    np.testing.assert_allclose(sym_rem_np(x), np.arctan2(np.sin(x), np.cos(x)))


def test_rot2_matches_jax():
    x = np.random.default_rng(2).normal(0, 4, (64,))
    np.testing.assert_allclose(rot2(_t(x)).numpy(), _j(jrot2, x), atol=ATOL)


@pytest.mark.parametrize("op", ["exp", "log", "normalize", "inverse"])
def test_se2_unary_matches_jax(op):
    a, _b = _points()
    got = getattr(TSE2, op)(_t(a)).numpy()
    want = _j(getattr(JSE2, op), a)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("op", ["compose", "boxplus", "local"])
def test_se2_binary_matches_jax(op):
    a, b = _points()
    got = getattr(TSE2, op)(_t(a), _t(b)).numpy()
    want = _j(getattr(JSE2, op), a, b)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_se2_boxplus_local_roundtrip_and_wrap():
    a, b = _points(seed=3)
    ta, tb = _t(a), _t(b)
    back = TSE2.boxplus(ta, TSE2.local(ta, tb))
    np.testing.assert_allclose(back[:, :2].numpy(), b[:, :2], atol=1e-9)
    dth = sym_rem(back[:, 2] - tb[:, 2]).numpy()
    np.testing.assert_allclose(dth, 0.0, atol=1e-9)
    # every angle these ops return lies in [-pi, pi) (inverse, as in the
    # JAX package, negates without wrapping)
    for out in (TSE2.compose(ta, tb), TSE2.exp(ta), TSE2.local(ta, tb)):
        th = out[:, 2].numpy()
        assert np.all(th >= -np.pi - 1e-15) and np.all(th <= np.pi)


@pytest.mark.parametrize("op", ["compose", "local"])
def test_so2_and_translation_match_jax(op):
    a, b = _points(seed=4)
    got = getattr(TSO2, op)(_t(a[:, 2:]), _t(b[:, 2:])).numpy()
    want = _j(getattr(JSO2, op), a[:, 2:], b[:, 2:])
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_array_equal(
        getattr(T2, op)(_t(a[:, :2]), _t(b[:, :2])).numpy(),
        (a[:, :2] + b[:, :2]) if op == "compose" else (b[:, :2] - a[:, :2]),
    )


def test_se2_mixed_precision_promotes_like_jax():
    """float64 poses composed with float32 measurements compute in float64,
    as JAX's type promotion does (the LM residual path relies on it)."""
    a, b = _points(seed=5)
    b32 = b.astype(np.float32)
    got = TSE2.compose(_t(a), torch.as_tensor(b32))
    assert got.dtype == torch.float64
    with jax.enable_x64():
        want = np.asarray(JSE2.compose(jnp.asarray(a), jnp.asarray(b32)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
