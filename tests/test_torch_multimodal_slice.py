"""The port's nonparametric solve end to end against the JAX package, on
beehive-10 (11 Pose2, 7 Point2) at N = 50 particles, float32 beliefs on
both sides, both engines ``engine="batched", init="points"``.

The engines draw from different generators (``jax.random`` keys, a
``torch.Generator``), so they are compared by what they estimate:

- each engine's mean 2-D pose error of the belief means against the
  parametric optimum is below 0.5 m (tools/bench_multimodal.py:130's gate);
- the mean per-pose symmetric k-NN KL between the two engines' beliefs is
  below 1.0 (tools/bench_multimodal.py:93's cross-engine gate), from each
  engine's own init and from identical starting particles;
- frozen variables keep their beliefs bit-identical;
- a seeded CPU solve keeps its recorded belief means;
- unknown options raise ValueError/TypeError.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import rome_tpu_torch as T  # noqa: E402
from rome_tpu import solve_graph_parametric as jax_parametric  # noqa: E402
from rome_tpu.canonical.patterns import generate_graph_beehive as jax_beehive  # noqa: E402
from rome_tpu.solvers.multimodal import solve_graph_nonparametric as jax_nonparametric  # noqa: E402
from rome_tpu.solvers.multimodal.batched import BatchedNonparametricSolver as JaxSolver  # noqa: E402
from rome_tpu_torch.canonical import generate_graph_beehive as port_beehive  # noqa: E402
from rome_tpu_torch.graph.convert import beliefs_from_numpy  # noqa: E402
from rome_tpu_torch.manifolds.base import SE2_  # noqa: E402
from rome_tpu_torch.solvers.multimodal.batched import BatchedNonparametricSolver  # noqa: E402
from rome_tpu_torch.solvers.multimodal.metrics import symmetric_kl_knn  # noqa: E402

POSES, N, SWEEPS = 10, 50, 3
ERR_GATE_M, KL_GATE = 0.5, 1.0


def _beehive(mod_gen):
    return mod_gen(pose_count_target=POSES, graphinit=False)


def _pose_error(fg, truth):
    return float(np.mean([
        np.linalg.norm(np.asarray(fg.variables[l].beliefs["default"])[:, :2].mean(0) - truth[l][:2])
        for l in truth
    ]))


def _mean_kl(fa, fb, labels):
    return float(np.mean([
        symmetric_kl_knn(
            SE2_, torch.as_tensor(np.array(fa.variables[l].beliefs["default"])),
            torch.as_tensor(np.array(fb.variables[l].beliefs["default"])),
        )
        for l in labels
    ]))


@pytest.fixture(scope="module")
def solved():
    fp = _beehive(jax_beehive)
    fp.init_all()
    jax_parametric(fp, init=False)
    truth = {l: fp.get_coords(l, "parametric") for l in fp.ls(r"^x\d+$")}
    fj = _beehive(jax_beehive)
    jax_nonparametric(fj, sweeps=SWEEPS, N=N, engine="batched", init="points",
                      key=jax.random.PRNGKey(2024))
    ft = _beehive(port_beehive)
    T.solve_graph_nonparametric(ft, sweeps=SWEEPS, N=N, engine="batched", init="points",
                                seed=2024, device="cpu")
    return truth, fj, ft


def test_both_engines_pass_the_pose_gate(solved):
    truth, fj, ft = solved
    for fg in (fj, ft):
        for l in fg._var_order:
            bel = np.asarray(fg.variables[l].beliefs["default"])
            assert bel.shape == (N, fg.variables[l].vtype.point_dim)
            assert bel.dtype == np.float32 and np.isfinite(bel).all()
    assert _pose_error(fj, truth) < ERR_GATE_M
    assert _pose_error(ft, truth) < ERR_GATE_M
    # the belief means are surfaced as point estimates
    for l in truth:
        assert np.linalg.norm(ft.get_point(l, "default")[:2] - truth[l][:2]) < 2.0


def test_engines_agree_by_kl(solved):
    truth, fj, ft = solved
    assert _mean_kl(fj, ft, list(truth)) < KL_GATE


def test_engines_agree_by_kl_from_identical_particles(solved):
    """Both engines run SWEEPS sweeps from the same starting particles (the
    JAX package's points init)."""
    truth, _, _ = solved
    fj = _beehive(jax_beehive)
    sj = JaxSolver(fj, "default", N=N)
    sj.init_beliefs_from_points(jax.random.PRNGKey(5))
    start = {t: np.asarray(v) for t, v in sj.gather_beliefs().items()}
    beliefs = sj.gather_beliefs()
    for s in range(SWEEPS):
        beliefs = sj.sweep(beliefs, jax.random.PRNGKey(100 + s))
    sj.scatter_beliefs(beliefs)

    ft = _beehive(port_beehive)
    st = BatchedNonparametricSolver(ft, "default", N=N, device="cpu")
    gen = torch.Generator().manual_seed(5)
    bt = beliefs_from_numpy(start, device="cpu")
    for _ in range(SWEEPS):
        bt = st.sweep(bt, gen)
    st.scatter_beliefs(bt)
    assert _pose_error(ft, truth) < ERR_GATE_M
    assert _mean_kl(fj, ft, list(truth)) < KL_GATE


def test_frozen_variables_keep_their_beliefs():
    ft = _beehive(port_beehive)
    T.solve_graph_nonparametric(ft, sweeps=1, N=N, init="points", seed=3, device="cpu")
    frozen = ("x3", "l1")
    before = {l: np.array(ft.variables[l].beliefs["default"]) for l in ft._var_order}
    points = {l: ft.get_point(l, "default") for l in frozen}
    for l in frozen:
        ft.set_solvable(l, 0)
    T.solve_graph_nonparametric(ft, sweeps=1, N=N, init=False, seed=7, device="cpu")
    for l in frozen:
        np.testing.assert_array_equal(ft.variables[l].beliefs["default"], before[l])
        np.testing.assert_array_equal(ft.get_point(l, "default"), points[l])
    moved = [l for l in ft._var_order if l not in frozen
             and not np.array_equal(ft.variables[l].beliefs["default"], before[l])]
    assert len(moved) == len(ft._var_order) - len(frozen)


def test_seeded_cpu_solve_keeps_its_beliefs():
    """A seeded CPU solve of the batched engine keeps the belief means it
    had before the Gibbs label draw moved into the K2/K3 draw epilogue: the
    draw takes the uniforms ``categorical`` drew, from the same generator
    (a changed random stream moves these means by far more than 1e-5)."""
    ft = _beehive(port_beehive)
    T.solve_graph_nonparametric(ft, sweeps=1, N=N, init="points", seed=3, device="cpu")
    want = {
        "x0": (-0.004070677161216736, -0.016549290139228106, 2.090567693710327),
        "l0": (-9.999231424331665, 17.00493860244751),
        "x1": (-5.0549108505249025, 8.389872150421143, -0.25697638511657717),
        "l1": (-22.991270809173585, 8.361895747184754),
        "x2": (-14.708292083740234, 8.729582424163818, 2.1015099239349366),
        "l2": (-23.003725662231446, 24.848541593551637),
        "x3": (-20.00161193847656, 17.092149238586426, -0.006162967681884766),
        "l3": (-37.95355266571045, 16.315371294021606),
        "x4": (-29.81987979888916, 17.177132968902587, -2.1087033796310424),
        "l4": (-38.58431133270264, 0.7872952073812485),
        "x5": (-34.90328853607178, 8.654721298217773, -1.0364316272735596),
        "l5": (-26.72656669616699, -6.544493331909179),
        "x6": (-30.034590339660646, 0.21691193282604218, -0.005698728561401367),
        "l6": (-11.927199096679688, 2.1757591152191162),
        "x7": (-20.186201095581055, -0.036592465192079544, 1.0594116687774657),
        "x8": (-15.589160003662109, 8.519627771377564, 2.068341999053955),
        "x9": (-19.91798946380615, 17.206352291107176, 0.2512718391418457),
        "x10": (-30.118274765014647, 16.992714767456054, -2.0920704984664917),
    }
    assert list(ft._var_order) == list(want)
    for label, mean in want.items():
        got = np.asarray(ft.variables[label].beliefs["default"], dtype=np.float64).mean(0)
        np.testing.assert_allclose(got, mean, rtol=0, atol=1e-5, err_msg=label)


def test_option_errors():
    fg = _beehive(port_beehive)
    with pytest.raises(ValueError, match="engine"):
        T.solve_graph_nonparametric(fg, N=10, engine="fast", init="points", device="cpu")
    with pytest.raises(ValueError, match="init"):
        T.solve_graph_nonparametric(fg, N=10, init="random", device="cpu")
    with pytest.raises(ValueError, match="init"):
        T.solve_graph_nonparametric(fg, N=10, engine="loop", init="random", device="cpu")
    with pytest.raises(ValueError, match="engine"):
        T.solve_tree(fg, N=10, engine="fast", device="cpu")
    fg.params.treeinit = True
    with pytest.raises(ValueError, match="engine"):
        T.solve_graph_nonparametric(fg, N=10, engine="fast", device="cpu")
    br = T.Pose2Point2BearingRange(T.Normal(0, 0.1), T.Normal(20, 0.5))
    with pytest.raises(ValueError, match="multihypo length"):
        fg.add_factor(["x0", "l0", "l1"], br, multihypo=[1.0, 0.5])
    with pytest.raises(TypeError, match="candidate slot expects Point2"):
        fg.add_factor(["x0", "l0", "x1"], br, multihypo=[1.0, 0.5, 0.5])
    with pytest.raises(ValueError, match="expects 2 variables"):
        fg.add_factor(["x0", "l0", "l1"], br)
    n = fg.num_factors
    f = fg.add_factor(["x0", "l0", "l1"], br, multihypo=[1.0, 0.5, 0.5], graphinit=False)
    assert fg.num_factors == n + 1 and f.multihypo == [1.0, 0.5, 0.5]


def test_unported_options_raise():
    """A type with no default prior raises TypeError, as in the JAX package;
    a manifold wider than K3's 8 dofs takes the generic Gibbs score."""
    from rome_tpu_torch.canonical import generate_graph_zero_pose
    from rome_tpu_torch.manifolds.base import TranslationGroup
    from rome_tpu_torch.solvers.multimodal.kde import generic_pairwise_logw, pairwise_logw
    from rome_tpu_torch.variables import VariableType

    class Wide(TranslationGroup):
        pass

    assert pairwise_logw(Wide(9)).func is generic_pairwise_logw
    with pytest.raises(TypeError, match="no default prior"):
        generate_graph_zero_pose(var_type=VariableType("Point9", Wide(9)))
    fg = generate_graph_zero_pose(var_type=T.Point2, mu0=[1.0, 2.0])
    assert fg.factors[fg._fct_order[0]].ftype.name == "PriorPoint2"
