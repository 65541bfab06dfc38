"""The nonparametric engine held to the plain float64 reference
(``benchmark/nonparametric_reference.py``, the copy that judges the
``beehive100.np_resolve`` cell) at a small size on the CPU: the
generator's copy, one message's per-particle Gauss-Newton and the Gibbs
log-weights on identical inputs, and whole ``init="points"`` solves by the
benchmark judge's statistics; and the engine's spans and counters."""

import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import nonparametric_judge as NJ  # noqa: E402
from rome_tpu_torch import generate_graph_beehive, solve_graph_nonparametric  # noqa: E402
from rome_tpu_torch.manifolds.base import SE2_  # noqa: E402
from rome_tpu_torch.ops.pairwise import euclid_pairwise_logw_plain, se2_pairwise_logw_plain  # noqa: E402
from rome_tpu_torch.solvers.multimodal import convolve  # noqa: E402
from rome_tpu_torch.utils import profiling  # noqa: E402
from benchmark import nonparametric_reference as R  # noqa: E402

F64 = torch.float64
GATES = json.load(open(os.path.join(ROOT, "benchmark", "configs", "beehive100.json")))["gates"]


def _port_graph(poses, seed=0):
    return generate_graph_beehive(pose_count_target=poses, seed=seed, graphinit=False)


@pytest.mark.parametrize("poses,seed", [(10, 0), (100, 0), (30, 3)])
def test_generator_copy_builds_the_ports_graph(poses, seed):
    fg, g = _port_graph(poses, seed), R.beehive(poses, seed)
    assert [(v, fg.variables[v].vtype.name) for v in fg._var_order] == list(g.kinds.items())
    assert len(fg._fct_order) == len(g.factors)
    for label, f in zip(fg._fct_order, g.factors):
        mine = fg.factors[label]
        S = np.asarray(mine.params["sqrt_info"])
        assert (mine.ftype.name, tuple(mine.variables)) == (f.kind, f.labels)
        np.testing.assert_allclose(mine.params["z"], f.mean, rtol=0, atol=1e-15)
        # sqrt_info is the inverse Cholesky factor of cov + 1e-14 I
        np.testing.assert_allclose(np.linalg.inv(S.T @ S), f.cov, rtol=1e-10, atol=1e-13)
    init = R.closed_form_init(g)
    fg.init_all("default")
    for v in g.kinds:
        np.testing.assert_allclose(fg.variables[v].points["default"], init[v], atol=1e-9)


def _same_factor(fg, f):
    return next(fg.factors[label] for label in fg._fct_order
                if tuple(fg.factors[label].variables) == f.labels)


def _inputs(g, f, slot, N, seed):
    """Particles of the factor's variables around the closed-form init, a
    measurement sample per particle, and a start for the target."""
    gen = torch.Generator().manual_seed(seed)
    init = R.closed_form_init(g)
    pts = []
    for v in f.labels:
        man = R.MANIFOLDS[g.kinds[v]]
        p = torch.as_tensor(init[v], dtype=F64).expand(N, man.dof)
        pts.append(man.normalize(man.boxplus(p, 0.3 * torch.randn((N, man.dof), generator=gen,
                                                                   dtype=F64))))
    _S, L = R._whitener(f.cov)
    z = torch.as_tensor(f.mean) + torch.randn((N, len(f.mean)), generator=gen, dtype=F64) @ \
        torch.as_tensor(L).T
    man = R.MANIFOLDS[g.kinds[f.labels[slot]]]
    x0 = man.normalize(man.boxplus(pts[slot], torch.randn((N, man.dof), generator=gen,
                                                          dtype=F64)))
    return pts, z, x0


CASES = [("PriorPose2", 0), ("Pose2Pose2", 0), ("Pose2Pose2", 1),
         ("Pose2Point2BearingRange", 0), ("Pose2Point2BearingRange", 1)]


@pytest.mark.parametrize("kind,slot", CASES)
def test_particle_gauss_newton_matches_the_reference(kind, slot):
    """One message's per-particle solve on identical particles, samples and
    start, both in float64: 1e-8. Ten damped steps converge to the same
    point; the reference's Jacobians are central differences of step 1e-6
    (truncation ~1e-12, rounding ~1e-10 at 40 m coordinates), the port's
    forward-mode AD, and a rank-deficient target (a pose seen by one
    bearing-range) keeps the difference of its path, which stays ~1e-9."""
    g, fg = R.beehive(10), _port_graph(10)
    f = next(x for x in g.factors if x.kind == kind and (kind == "PriorPose2" or "x3" in x.labels))
    mine = _same_factor(fg, f)
    N = 64
    pts, z, x0 = _inputs(g, f, slot, N, seed=11 + slot)
    start = R.initializer(f.kind, slot, z, pts)
    man = R.MANIFOLDS[g.kinds[f.labels[slot]]]
    S = torch.as_tensor(R._whitener(f.cov)[0])
    want = R.gauss_newton(f.kind, slot, man, z, S, pts, x0 if start is None else start,
                          lambda a: a)
    params = {"sqrt_info": torch.as_tensor(mine.params["sqrt_info"]).expand(N, *S.shape)}
    mans = [fg.variables[v].manifold for v in f.labels]
    got = convolve.conv_particles(mine.ftype, slot, mans, params, z, x0, pts)
    got = mans[slot].normalize(got)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-8)


def test_particle_gauss_newton_in_float32_is_within_its_rounding():
    """The engine's float32 solve of the odometry message toward x5 against
    the float64 reference on the same inputs: 2e-4 m and rad (float32
    carries ~4e-6 m at 40 m; ten steps' Jacobians and solves in float32)."""
    g, fg = R.beehive(10), _port_graph(10)
    f = next(x for x in g.factors if x.kind == "Pose2Pose2" and x.labels[1] == "x5")
    mine = _same_factor(fg, f)
    pts, z, x0 = _inputs(g, f, 1, 64, seed=5)
    want = R.gauss_newton(f.kind, 1, R.SE2, z, torch.as_tensor(R._whitener(f.cov)[0]), pts,
                          R.initializer(f.kind, 1, z, pts), lambda a: a)
    f32 = torch.float32
    params = {"sqrt_info": torch.as_tensor(mine.params["sqrt_info"], dtype=f32).expand(64, 3, 3)}
    got = convolve.conv_particles(mine.ftype, 1, [SE2_, SE2_], params, z.to(f32), x0.to(f32),
                                  [p.to(f32) for p in pts])
    d = SE2_.local(want, SE2_.normalize(got).to(F64))
    assert float(d.abs().max()) < 2e-4


@pytest.mark.parametrize("kind", ["Pose2", "Point2"])
def test_gibbs_log_weights_match_the_reference(kind):
    """The Gibbs pairwise scores (the plain versions of K2 and K3) against
    the reference's on identical float64 inputs: 1e-9 relative (the same
    arithmetic in another order; angles wrapped by floor against
    remainder)."""
    gen = torch.Generator().manual_seed(3)
    man = R.MANIFOLDS[kind]
    V, N, Nj, d = 4, 20, 24, man.dof
    centre = torch.tensor([30.0, -12.0, 3.0][:d], dtype=F64)
    ref = man.normalize(centre + torch.randn((V, N, d), generator=gen, dtype=F64))
    pts = man.normalize(centre + torch.randn((V, Nj, d), generator=gen, dtype=F64))
    mu = 0.5 * torch.randn((V, N, d), generator=gen, dtype=F64)
    var = 0.1 + torch.rand((V, d), generator=gen, dtype=F64)
    want = R.log_weights(man, ref, mu, pts, var)
    if kind == "Pose2":
        got = se2_pairwise_logw_plain(ref, mu, pts, 1.0 / var)
    else:
        got = euclid_pairwise_logw_plain(ref, mu, pts, 1.0 / var, torch.zeros(d, dtype=F64))
    torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-9)


def _port_answers(fg, seeds, N):
    out = []
    for seed in seeds:
        for rec in fg.variables.values():
            for d in (rec.beliefs, rec.points, rec.initialized):
                d.pop("default", None)
        solve_graph_nonparametric(fg, sweeps=3, N=N, engine="batched", init="points", seed=seed,
                                  device="cpu")
        out.append({v: np.asarray(fg.variables[v].beliefs["default"], np.float64)
                    for v in fg._var_order})
    return out


@pytest.fixture(scope="module")
def small_solves():
    """Six engine solves and eleven reference solves of beehive-10 at N =
    32: eight pooled, three held out (the reference judged against itself)."""
    g, fg, N = R.beehive(10), _port_graph(10), 32
    ref = {v: b.numpy() for v, b in R.solve(g, list(range(100, 111)), N=N).items()}
    return g, N, _port_answers(fg, range(1, 7), N), ref


@pytest.mark.parametrize("group", [0, 1])
def test_whole_solve_matches_the_reference_by_the_judge(small_solves, group):
    """Three engine solves pooled against eight reference solves pooled, by
    the benchmark judge's statistics and the cell's limits; the reference's
    three held-out solves read alike (also under the limits)."""
    g, N, answers, ref = small_solves
    pooled = NJ.pool({v: b[:8] for v, b in ref.items()})
    readings = NJ.readings(answers[3 * group:3 * group + 3], pooled, g.kinds, N, GATES)
    assert all(v <= lim for v, lim in readings.values()), readings
    held = NJ.answer_readings([{v: b[8 + j] for v, b in ref.items()} for j in range(3)], pooled,
                              g.kinds, N)
    assert all(held[k] <= lim for k, (_v, lim) in readings.items()), held


def test_engine_spans_nest_under_the_solve_and_count_its_gn_calls(monkeypatch):
    calls, rows = [], []
    real = convolve._gn_solve_target

    def counted(*a, **k):
        x = real(*a, **k)
        calls.append(1)
        rows.append(x.shape[0])
        return x

    monkeypatch.setattr(convolve, "_gn_solve_target", counted)
    fg, N = _port_graph(6), 16
    solve_graph_nonparametric(fg, sweeps=2, N=N, engine="batched", init="points", seed=5,
                              device="cpu")
    root = profiling.roots()[-1]
    assert root.name == "np.solve" and root.parent is None
    assert [c.name for c in root.children] == ["np.lower", "np.init", "np.sweep", "np.sweep",
                                               "np.write_back"]
    for sweep in root.children[2:4]:
        assert [c.name for c in sweep.children] == ["np.messages", "np.products"]
        assert all(c.start >= sweep.start and c.end <= sweep.end for c in sweep.children)
    # messages of every (factor type, slot): PriorPose2's one, the other
    # two types' two slots, each sweep
    assert root.attrs["np.gn_solves"] == len(calls) == 2 * 5
    assert root.attrs["np.gn_rows"] == sum(rows) == 2 * N * (1 + 2 * len(fg.factors) - 2)
