"""The port's measurement distributions against the JAX package's.

- ``mean()`` and ``cov()`` are exactly equal (both host float64 numpy).
- Sampling: the two packages draw from different generators, so their
  samples are held to each other by their moments. At n = 20,000 draws the
  standard error of a sample mean is sigma / 141, so the means of the two
  packages' samples agree within 0.05 sigma (about 5 standard errors) and
  their covariances within 5 % of the largest variance; Categorical and
  Mixture label frequencies within 0.02.
- Shapes, dtype, device, and that one seed gives one sample.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import rome_tpu.distributions as J  # noqa: E402
import rome_tpu_torch.distributions as P  # noqa: E402

NS = 20_000


def _cases(mod):
    return {
        "normal": mod.Normal(1.5, 0.3),
        "mvnormal_sigmas": mod.MvNormal([10.0, -2.0, 0.5], [0.1, 2.0, 0.05]),
        "mvnormal_cov": mod.MvNormal([1.0, 2.0], [[2.0, 0.6], [0.6, 0.5]]),
        "uniform": mod.Uniform(-3.0, 5.0),
        "categorical": mod.Categorical([0.2, 0.5, 0.3]),
        "mixture": mod.Mixture(
            [mod.Normal(-4.0, 0.5), mod.Normal(3.0, 1.0)], weights=[0.3, 0.7]
        ),
        "mixture_mv": mod.Mixture(
            [mod.MvNormal([0.0, 0.0], [1.0, 0.2]), mod.MvNormal([5.0, 1.0], [0.3, 0.3])]
        ),
    }


CASES = list(_cases(P))


@pytest.mark.parametrize("name", CASES)
def test_mean_and_cov_equal_jax(name):
    dj, dt = _cases(J)[name], _cases(P)[name]
    assert dt.dim == dj.dim
    np.testing.assert_array_equal(dt.mean(), dj.mean())
    np.testing.assert_array_equal(dt.cov(), dj.cov())
    mj, cj = J.dist_mean_cov(dj)
    mt, ct = P.dist_mean_cov(dt)
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_array_equal(ct, cj)


@pytest.mark.parametrize("name", CASES)
def test_sample_moments_match_jax(name):
    dj, dt = _cases(J)[name], _cases(P)[name]
    sj = np.asarray(dj.sample(jax.random.PRNGKey(7), NS), dtype=np.float64)
    st = dt.sample(torch.Generator().manual_seed(7), NS)
    assert st.shape == (NS, dt.dim) == sj.shape
    assert st.dtype == torch.float32 and st.device.type == "cpu"
    st = st.numpy().astype(np.float64)
    if name == "categorical":
        for k in range(3):
            assert abs(np.mean(st == k) - np.mean(sj == k)) < 0.02, k
        return
    if name == "mixture":
        for side in (st < -0.5, sj < -0.5):
            assert abs(np.mean(side) - 0.3) < 0.02
    sigma = np.sqrt(np.diag(np.atleast_2d(dt.cov())))
    np.testing.assert_allclose(st.mean(0), sj.mean(0), rtol=0, atol=0.05 * sigma.max())
    np.testing.assert_allclose(
        np.atleast_2d(np.cov(st.T)), np.atleast_2d(np.cov(sj.T)),
        rtol=0, atol=0.05 * sigma.max() ** 2,
    )
    # and both sit on the distribution's own moments
    np.testing.assert_allclose(st.mean(0), dt.mean(), rtol=0, atol=0.05 * sigma.max())


def test_uniform_support_and_seeding():
    d = P.Uniform(-3.0, 5.0)
    a = d.sample(torch.Generator().manual_seed(1), 1000)
    b = d.sample(torch.Generator().manual_seed(1), 1000)
    assert torch.equal(a, b)
    assert float(a.min()) >= -3.0 and float(a.max()) < 5.0
    c = P.Categorical([0.0, 1.0, 0.0]).sample(torch.Generator().manual_seed(2), 100)
    assert torch.equal(c, torch.ones(100, 1))
    m = P.MvNormal([1.0, 2.0], [0.1, 0.2]).sample(torch.Generator().manual_seed(3), 5,
                                                  dtype=torch.float64)
    assert m.dtype == torch.float64 and m.shape == (5, 2)
