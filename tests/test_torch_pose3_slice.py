"""The 3-D slice end to end against the JAX package.

- chip_smoke.py's sphere generator (g2o's create_sphere layout) at 6 laps
  of 8 poses, loaded and solved by both packages' ``solve_graph_parametric``
  in float64 with the smoke run's ndchol options (``big``, the CG polish
  run to 1e-10) and with the dense solver: poses within 1e-6, the same LM
  iteration count.
- The generic Gibbs score (``generic_pairwise_logw``) against the JAX
  package's vmapped form, on SO(3), SE(3), SE(2) x T(2) and SO(3) x T(3) x
  T(3), at 1e-10 in float64.
- Dispatch by manifold: every manifold K2/K3 covers (SE(2), T(n), SO(2),
  Polar, BearingRange2, DynPoint2, ...) gets its kernel and never the
  generic score; the others get the generic score. Polar and BearingRange2
  through K3's plain version equal ``rome_tpu.ops.pairwise
  .euclid_pairwise_logw`` (interpret mode) at 2e-5.

The Pose3 nullhypo fixture and the batched engine on the Pose3 hexagon and
the Polar chain are in tests/test_torch_se3_nonparametric.py.

``sphere_rehearsal()`` (not a test) runs the full 2,500-pose sphere through
both packages on the CPU and prints one JSON line per package:
``python -c 'import sys; sys.path[:0] = [".", "tests"]; import
test_torch_pose3_slice as t; t.sphere_rehearsal()'``.
"""

import json
import os
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import rome_tpu as R  # noqa: E402
import rome_tpu_torch as T  # noqa: E402
from rome_tpu.manifolds import base as JM  # noqa: E402
from rome_tpu.ops import pairwise as JP  # noqa: E402
from rome_tpu_torch.manifolds import base as TM  # noqa: E402
from rome_tpu_torch.ops import pairwise_cuda as K  # noqa: E402
from rome_tpu_torch.solvers.multimodal import kde as TK  # noqa: E402
from rome_tpu_torch.variables import get_variable_type  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
import chip_smoke as C  # noqa: E402

SMALL = dict(laps=6, per_lap=8)


def _jax_sphere_graph(path):
    fg = R.load_g2o(None, path)
    x0 = np.asarray(JM.SE3_.log(jnp.asarray(fg.get_point("x0"))))
    fg.add_factor(["x0"], R.PriorPose3(R.MvNormal(x0, C.SPHERE_PRIOR_SIGMAS)), graphinit=False)
    return fg


def _solve_sphere_both(path, opts):
    with jax.enable_x64():
        fg_j = _jax_sphere_graph(path)
        res_j = R.solve_graph_parametric(fg_j, init=False, options=R.GNOptions(**opts),
                                         dtype=jnp.float64)
    fg_t = C.build_sphere_graph(path)
    res_t = T.solve_graph_parametric(fg_t, init=False, options=T.GNOptions(**opts),
                                     dtype=torch.float64, device="cpu")
    return res_j, fg_j, res_t, fg_t


@pytest.mark.parametrize("which", ["ndchol", "dense"])
def test_sphere_solve_matches_jax(tmp_path, which):
    path = str(tmp_path / "sphere.g2o")
    truth = C.write_sphere_g2o(path, **SMALL)
    # the big options, with the CG polish run to 1e-10: at big's 5e-2 each
    # step keeps the rounding of the float32 factorization, which the two
    # packages' Cholesky implementations do not share
    opts = dict(C.BIG, polish_tol=1e-10, polish_iters=200) if which == "ndchol" else C.SPHERE_DENSE
    res_j, fg_j, res_t, fg_t = _solve_sphere_both(path, opts)
    sj, st = res_j["stats"], res_t["stats"]
    assert st.converged and sj.converged
    assert st.iterations == sj.iterations and st.reason == sj.reason
    assert abs(st.final_cost - sj.final_cost) <= 1e-9 * max(1.0, sj.final_cost)
    n = SMALL["laps"] * SMALL["per_lap"]
    for i in range(n):
        pj, pt = fg_j.get_point(f"x{i}"), fg_t.get_point(f"x{i}")
        np.testing.assert_allclose(pt[:3], pj[:3], rtol=0, atol=1e-6)
        rel = TM.SE3_.local(torch.tensor(pj), torch.tensor(pt))
        assert float(rel[3:].abs().max()) < 1e-6
    # the fixture is sound: the optimum sits near the generator's truth
    assert C.ate_se3(fg_t, truth) < 0.5


def test_sphere_ndchol_float32_graph_without_pose2(tmp_path):
    """The smoke run's configuration: a float32 graph with the big options
    takes the mixed-Jacobian path (float64 residuals, float32 Jacobians,
    the solver's NormalEqWorkspace) with no Pose2Pose2 batch; it lands on
    the dense float64 optimum under the smoke run's gates."""
    path = str(tmp_path / "sphere.g2o")
    C.write_sphere_g2o(path, **SMALL)
    fg_ref = C.build_sphere_graph(path)
    ref = T.solve_graph_parametric(fg_ref, init=False, options=T.GNOptions(**C.SPHERE_DENSE),
                                   dtype=torch.float64, device="cpu")
    fg = C.build_sphere_graph(path)
    res = T.solve_graph_parametric(fg, init=False, options=T.GNOptions(**C.BIG), device="cpu")
    st = res["stats"]
    assert st.converged and st.linear == "ndchol"
    assert st.final_cost <= 1.002 * ref["stats"].final_cost + 1e-3
    n = SMALL["laps"] * SMALL["per_lap"]
    ref_pts = np.stack([fg_ref.get_point(f"x{i}") for i in range(n)])
    assert C.ate_se3(fg, ref_pts) < 0.01


def test_sphere_generator_layout(tmp_path):
    path = str(tmp_path / "sphere.g2o")
    truth = C.write_sphere_g2o(path, **SMALL)
    lines = open(path).read().splitlines()
    n = SMALL["laps"] * SMALL["per_lap"]
    assert sum(ln.startswith("VERTEX_SE3:QUAT") for ln in lines) == n
    assert sum(ln.startswith("EDGE_SE3:QUAT") for ln in lines) == (n - 1) + (n - SMALL["per_lap"])
    assert len(C.sphere_edges()) == 4949
    np.testing.assert_allclose(np.linalg.norm(truth[:, :3], axis=1), C.SPHERE_RADIUS_M)
    np.testing.assert_allclose(np.linalg.norm(truth[:, 3:], axis=1), 1.0, atol=1e-12)
    # each pose's x-axis along the direction of travel, z out of the sphere
    Rm = T.manifolds.quat.qto_matrix(torch.as_tensor(truth[:, 3:])).numpy()
    step = truth[1:, :3] - truth[:-1, :3]
    assert np.all(np.sum(Rm[:-1, :, 0] * step, axis=1) > 0)
    up = truth[:, :3] / C.SPHERE_RADIUS_M
    np.testing.assert_allclose(np.sum(Rm[:, :, 2] * up, axis=1), 1.0, atol=1e-12)


def _jax_generic_logw(man, ref, mu, pts, var):
    """The JAX package's vmapped score (rome_tpu/solvers/multimodal/
    kde.py:257-262, batched.py:361-368)."""
    def coords_for(ref_i):
        return man.local(jnp.broadcast_to(ref_i, pts.shape), pts)

    C_ = jax.vmap(coords_for)(ref)
    return -0.5 * jnp.sum((C_ - mu[:, None, :]) ** 2 / var, axis=-1)


GENERIC = [("SO3", JM.SO3_, TM.SO3_), ("SE3", JM.SE3_, TM.SE3_),
           ("DynPose2", R.DynPose2.manifold, T.DynPose2.manifold),
           ("RotVelPos", R.RotVelPos.manifold, T.RotVelPos.manifold)]


def _points(tm, n, rng):
    xi = rng.normal(0, 1.0, (n, tm.dof))
    return tm.exp(torch.as_tensor(xi)).numpy()


@pytest.mark.parametrize("pair", GENERIC, ids=[g[0] for g in GENERIC])
def test_generic_score_matches_jax(pair):
    _, jm, tm = pair
    rng = np.random.default_rng(3)
    V, N, Nj = 3, 17, 23
    ref = np.stack([_points(tm, N, rng) for _ in range(V)])
    pts = np.stack([_points(tm, Nj, rng) for _ in range(V)])
    mu = rng.normal(0, 0.5, (V, N, tm.dof))
    var = rng.uniform(0.2, 2.0, (V, tm.dof))
    got = TK.generic_pairwise_logw(tm, *(torch.as_tensor(a) for a in (ref, mu, pts)),
                                   torch.as_tensor(1.0 / var))
    assert got.shape == (V, N, Nj) and got.dtype == torch.float64
    with jax.enable_x64():
        want = np.stack([np.asarray(_jax_generic_logw(jm, *(jnp.asarray(a[v]) for a in (
            ref, mu, pts, var)))) for v in range(V)])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-10)
    # the unbatched form and the draw
    one = TK.generic_pairwise_logw(tm, *(torch.as_tensor(a[0]) for a in (ref, mu, pts)),
                                   torch.as_tensor(1.0 / var[0]))
    np.testing.assert_array_equal(one.numpy(), got[0].numpy())
    u = torch.rand((V, N, Nj), generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    lab = TK.pairwise_draw(tm)(*(torch.as_tensor(a) for a in (ref, mu, pts)),
                               torch.as_tensor(1.0 / var), u)
    assert torch.equal(lab, TK.gumbel_argmax(got, u))


KERNEL_COVERED = ["Pose2", "Point2", "Point3", "DynPoint2", "Polar", "BearingRange2", "VelPos3",
                  "IMUBias"]
GENERIC_ONLY = ["Pose3", "Rotation3", "RotVelPos", "DynPose2"]


@pytest.mark.parametrize("vtype", KERNEL_COVERED + GENERIC_ONLY)
def test_dispatch_by_manifold(vtype):
    """A manifold K2/K3 covers never reaches the generic score, in the port
    as in the JAX package's static dispatch."""
    man = get_variable_type(vtype).manifold
    jfn = JP.pairwise_logw_for(R.get_variable_type(vtype).manifold)
    logw, draw = TK.pairwise_logw(man), TK.pairwise_draw(man)
    if vtype in KERNEL_COVERED:
        assert jfn is not None
        assert not hasattr(logw, "func") and not hasattr(draw, "func")
        assert (logw is K.se2_pairwise_logw) == (vtype == "Pose2")
    else:
        assert jfn is None
        assert logw.func is TK.generic_pairwise_logw and draw.func is TK.generic_gibbs_draw


@pytest.mark.parametrize("vtype,mask", [("Polar", [0.0, 1.0]), ("BearingRange2", [1.0, 0.0])])
def test_product_manifolds_take_k3_plain(vtype, mask):
    man = get_variable_type(vtype).manifold
    rng = np.random.default_rng(4)
    ref = rng.uniform(-np.pi, np.pi, (37, 2)).astype(np.float32)
    pts = rng.uniform(-np.pi, np.pi, (101, 2)).astype(np.float32)
    ref[:3, 1 if vtype == "Polar" else 0] = np.float32(np.pi) - np.float32(1e-6)
    mu = (rng.normal(size=(37, 2)) * 0.5).astype(np.float32)
    iv = rng.uniform(0.5, 4.0, 2).astype(np.float32)
    got = TK.pairwise_logw(man)(*(torch.as_tensor(a)[None] for a in (ref, mu, pts, iv)))[0]
    want = np.asarray(JP.euclid_pairwise_logw(ref, mu, pts, iv, np.asarray(mask, np.float32)))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    # and the generic score agrees (K3's dispatch is a fused form of it)
    gen = TK.generic_pairwise_logw(man, *(torch.as_tensor(a) for a in (ref, mu, pts, iv)))
    np.testing.assert_allclose(got.numpy(), gen.numpy(), rtol=2e-5, atol=2e-5)


def sphere_rehearsal(laps=C.SPHERE_LAPS, per_lap=C.SPHERE_PER_LAP, out=None):
    """The full sphere through both packages on the CPU: the port's ndchol
    (``big``) and dense float64 solves, and the JAX package's ndchol solve.
    Prints one JSON line per solve (iterations, cost, SE(3)-aligned ATE to
    the truth and to the port's dense optimum, seconds)."""
    import tempfile

    jax.config.update("jax_platforms", "cpu")
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sphere.g2o")
        truth = C.write_sphere_g2o(path, laps, per_lap)
        ref = None
        for pkg, linear in (("port", "dense"), ("port", "ndchol"), ("jax", "ndchol")):
            opts = C.SPHERE_DENSE if linear == "dense" else C.BIG
            t0 = time.time()
            if pkg == "port":
                fg = C.build_sphere_graph(path)
                res = T.solve_graph_parametric(
                    fg, init=False, options=T.GNOptions(**opts), device="cpu",
                    dtype=torch.float64 if linear == "dense" else None)
            else:
                fg = _jax_sphere_graph(path)
                with jax.enable_x64():
                    res = R.solve_graph_parametric(fg, init=False, options=R.GNOptions(**opts))
            st = res["stats"]
            row = dict(package=pkg, linear=linear, iterations=st.iterations,
                       converged=bool(st.converged), reason=st.reason,
                       final_cost=float(st.final_cost), truth_ate_m=C.ate_se3(fg, truth),
                       seconds=time.time() - t0)
            if ref is None:
                ref = np.stack([fg.get_point(f"x{i}") for i in range(laps * per_lap)])
            row["ate_to_port_dense_m"] = C.ate_se3(fg, ref)
            rows.append(row)
            print(json.dumps(row), flush=True)
    if out:
        with open(out, "w") as fh:
            json.dump(rows, fh, indent=1)
    return rows
