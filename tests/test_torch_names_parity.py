"""The public names the port gained to match the JAX package, held to it:
``utils/math`` (spd_repair, sqrt_info_from_cov, cont2disc, skew2) at atol
1e-12 in float64 on seeded inputs; ``Manifold.dist`` on every manifold both
packages share, at 1e-10 in float64; the reference-style graph functions
``addVariable``/``addFactor``, ``FactorGraph.get_ppe_suggested`` and the
top-level factor-registry names."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import rome_tpu as R  # noqa: E402
import rome_tpu.manifolds.base as JMB  # noqa: E402
import rome_tpu.utils.math as JM  # noqa: E402
import rome_tpu_torch as T  # noqa: E402
import rome_tpu_torch.manifolds.base as TMB  # noqa: E402
import rome_tpu_torch.utils.math as TM  # noqa: E402

ATOL = 1e-12


def _spd(rng, *shape):
    A = rng.normal(size=shape + shape[-1:])
    return A @ np.swapaxes(A, -1, -2) + shape[-1] * np.eye(shape[-1])


def _t(a):
    return torch.as_tensor(a, dtype=torch.float64)


def test_math_functions_match_jax():
    rng = np.random.default_rng(0)
    M = rng.normal(size=(5, 4, 4))
    cov = _spd(rng, 5, 4)
    F, G, Qc = rng.normal(size=(3, 3)), rng.normal(size=(3, 2)), _spd(rng, 2)
    w = rng.normal(size=(7,))
    with jax.enable_x64():
        want = dict(
            repair=JM.spd_repair(jnp.asarray(M)), repair_eps=JM.spd_repair(jnp.asarray(M), 0.3),
            sqrt=JM.sqrt_info_from_cov(jnp.asarray(cov)),
            c2d=JM.cont2disc(jnp.asarray(F), jnp.asarray(G), jnp.asarray(Qc), 0.05),
            skew=JM.skew2(jnp.asarray(w)))
    got = dict(
        repair=TM.spd_repair(_t(M)), repair_eps=TM.spd_repair(_t(M), 0.3),
        sqrt=TM.sqrt_info_from_cov(_t(cov)),
        c2d=TM.cont2disc(_t(F), _t(G), _t(Qc), 0.05), skew=TM.skew2(_t(w)))
    for k in want:
        for a, b in zip(jax.tree_util.tree_leaves(want[k]), jax.tree_util.tree_leaves(
                tuple(got[k]) if isinstance(got[k], tuple) else got[k])):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=ATOL, err_msg=k)
    S = TM.sqrt_info_from_cov(_t(cov))
    np.testing.assert_allclose((S.transpose(-1, -2) @ S).numpy(), np.linalg.inv(cov), atol=1e-10)


def _manifolds():
    names = [n for n in dir(TMB) if n.endswith("_") and n[:-1].isupper() and hasattr(JMB, n)]
    return [n for n in names if hasattr(getattr(TMB, n), "dist")]


@pytest.mark.parametrize("name", _manifolds())
def test_manifold_dist_matches_jax(name):
    tm, jm = getattr(TMB, name), getattr(JMB, name)
    rng = np.random.default_rng(1)
    with jax.enable_x64():
        p = jm.boxplus(jm.identity(), jnp.asarray(rng.normal(0, 0.5, (6, jm.dof))))
        q = jm.boxplus(p, jnp.asarray(rng.normal(0, 0.5, (6, jm.dof))))
        want = np.asarray(jm.dist(p, q))
    got = tm.dist(_t(np.asarray(p)), _t(np.asarray(q))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


def test_graph_functions_and_registry_names():
    for mod in (R, T):
        fg = mod.FactorGraph()
        mod.addVariable(fg, "x0", mod.Pose2)
        mod.addVariable(fg, "x1", mod.Pose2)
        mod.addFactor(fg, ["x0"], mod.PriorPose2(mod.MvNormal([1, 2, 0.3], [0.1, 0.1, 0.05])))
        mod.addFactor(fg, ["x0", "x1"], mod.Pose2Pose2(mod.MvNormal([1, 0, 0], [0.1, 0.1, 0.05])))
        fg.init_all()
        assert fg.num_factors == 2
        np.testing.assert_allclose(fg.get_ppe_suggested("x1"), fg.get_coords("x1"))
    assert T.get_factor_type("Pose2Pose2").name == "Pose2Pose2"
    assert "Pose2Pose2" in T.list_factor_types()
    assert T.register_factor_type(T.get_factor_type("Pose2Pose2")) is T.get_factor_type(
        "Pose2Pose2")
    assert T.Factor.__module__ == "rome_tpu_torch.factors.base"
    assert T.FactorType.__module__ == "rome_tpu_torch.factors.base"
