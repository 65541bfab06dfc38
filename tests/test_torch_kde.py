"""The port's kernel-density layer against the JAX package.

- ``silverman_bandwidth`` and ``manifold_mean`` on SE(2) and T(2) particle
  sets, float32 on both sides, at atol 1e-5: one density, and a (V, K)
  batch of densities held to the JAX function per density.
- ``ManifoldKernelDensity.logpdf`` at atol 1e-4 (float32 logsumexp).
- The k-NN KL estimators on the same particle sets, at 1e-4.
- ``gibbs_product`` of two offset T(2) clouds (tests/test_multimodal_kl.py:
  93-102) against the JAX package's product: the two engines draw from
  different generators, so their outputs are compared by distribution,
  symmetric k-NN KL below that test's threshold of 0.35.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rome_tpu.manifolds import base as JM  # noqa: E402
from rome_tpu.solvers.multimodal import kde as JK  # noqa: E402
from rome_tpu.solvers.multimodal import metrics as JMet  # noqa: E402
from rome_tpu_torch.manifolds import base as TM  # noqa: E402
from rome_tpu_torch.solvers.multimodal import kde as TK  # noqa: E402
from rome_tpu_torch.solvers.multimodal import metrics as TMet  # noqa: E402

MANS = {"SE2": (JM.SE2(), TM.SE2()), "T2": (JM.T2, TM.T2)}


def _cloud(name, shape, seed):
    rng = np.random.default_rng(seed)
    if name == "SE2":
        pts = np.concatenate(
            [rng.normal(1.0, 0.7, shape + (2,)), rng.uniform(-np.pi, np.pi, shape + (1,))], -1
        )
    else:
        pts = rng.normal(1.0, 0.7, shape + (2,))
    return pts.astype(np.float32)


@pytest.mark.parametrize("name", ["SE2", "T2"])
def test_bandwidth_and_mean_match_jax(name):
    jman, tman = MANS[name]
    pts = _cloud(name, (100,), seed=1)
    np.testing.assert_allclose(
        TK.silverman_bandwidth(tman, torch.as_tensor(pts)).numpy(),
        np.asarray(JK.silverman_bandwidth(jman, jnp.asarray(pts))), rtol=0, atol=1e-5,
    )
    np.testing.assert_allclose(
        TK.manifold_mean(tman, torch.as_tensor(pts)).numpy(),
        np.asarray(JK.manifold_mean(jman, jnp.asarray(pts))), rtol=0, atol=1e-5,
    )


@pytest.mark.parametrize("name", ["SE2", "T2"])
def test_batched_bandwidth_matches_jax_per_density(name):
    jman, tman = MANS[name]
    pts = _cloud(name, (3, 2, 40), seed=2)
    got = TK.silverman_bandwidth(tman, torch.as_tensor(pts)).numpy()
    want = np.stack([
        np.stack([np.asarray(JK.silverman_bandwidth(jman, jnp.asarray(p))) for p in row])
        for row in pts
    ])
    assert got.shape == (3, 2, jman.dof)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["SE2", "T2"])
def test_kde_logpdf_matches_jax(name):
    jman, tman = MANS[name]
    pts, x = _cloud(name, (80,), seed=3), _cloud(name, (7,), seed=4)
    jd = JK.ManifoldKernelDensity.from_points(jman, jnp.asarray(pts))
    td = TK.ManifoldKernelDensity.from_points(tman, torch.as_tensor(pts))
    np.testing.assert_allclose(td.bandwidth.numpy(), np.asarray(jd.bandwidth), atol=1e-5)
    np.testing.assert_allclose(
        td.logpdf(torch.as_tensor(x)).numpy(), np.asarray(jd.logpdf(jnp.asarray(x))),
        rtol=0, atol=1e-4,
    )
    np.testing.assert_allclose(td.mean().numpy(), np.asarray(jd.mean()), atol=1e-5)
    s = td.sample(torch.Generator().manual_seed(0), 500)
    assert s.shape == (500, tman.point_dim) and torch.isfinite(s).all()


def test_knn_kl_matches_jax():
    rng = np.random.default_rng(5)
    P = rng.normal(0.0, 1.0, (300, 2)).astype(np.float32)
    Q = rng.normal(0.5, 1.0, (250, 2)).astype(np.float32)
    for k in (1, 2):
        want = JMet.symmetric_kl_knn(JM.T2, jnp.asarray(P), jnp.asarray(Q), k=k)
        got = TMet.symmetric_kl_knn(TM.T2, torch.as_tensor(P), torch.as_tensor(Q), k=k)
        assert abs(got - want) < 1e-4
        assert abs(
            TMet.kl_divergence_knn(TM.T2, torch.as_tensor(P), torch.as_tensor(Q), k=k)
            - JMet.kl_divergence_knn(JM.T2, jnp.asarray(P), jnp.asarray(Q), k=k)
        ) < 1e-4


def test_gibbs_product_matches_jax_by_kl():
    rng = np.random.default_rng(1)
    a = rng.normal([0, 0], 0.6, (400, 2)).astype(np.float32)
    b = rng.normal([1, 0], 0.6, (400, 2)).astype(np.float32)
    want = JK.gibbs_product(
        jax.random.PRNGKey(7),
        [JK.ManifoldKernelDensity.from_points(JM.T2, jnp.asarray(x)) for x in (a, b)],
        n_out=600,
    )
    got = TK.gibbs_product(
        torch.Generator().manual_seed(7),
        [TK.ManifoldKernelDensity.from_points(TM.T2, torch.as_tensor(x)) for x in (a, b)],
        n_out=600,
    )
    assert got.shape == (600, 2) and got.dtype == torch.float32
    kl = TMet.symmetric_kl_knn(TM.T2, got, torch.as_tensor(np.array(want)), k=2)
    assert kl < 0.35, kl
    # the product contracts the two clouds onto their precision-weighted mean
    assert abs(float(got[:, 0].mean()) - 0.5) < 0.1


def test_pairwise_score_dispatch_refuses_an_unported_manifold():
    """A manifold no kernel covers (point_dim != dof) takes the generic
    score, not K2/K3; SE(2) keeps K2."""
    import functools

    from rome_tpu_torch.ops import pairwise_cuda as P

    assert TK.pairwise_logw(TM.SE2()) is P.se2_pairwise_logw
    fn = TK.pairwise_logw(TM.SO3_)
    assert isinstance(fn, functools.partial) and fn.func is TK.generic_pairwise_logw
    assert TK.pairwise_draw(TM.SO3_).func is TK.generic_gibbs_draw
