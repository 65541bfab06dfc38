"""K1's normal epilogue (the ndchol LM path's linearize of a Pose2Pose2 batch).

- The plain version (ops/fused_linearize.pose2pose2_normal_plain, what the
  wrapper computes on CPU tensors), reached through the solver's route
  (solvers/linearize.linearize_all_mixed_j, normal_eq_entry_values and
  gradient_from_lins with the epilogue's parts), equals the route the
  solver took before the epilogue existed bit for bit (rtol = atol = 0):
  the f64 residual, the f32 Jacobians, the whole entry vector (the
  Pose2Pose2 block after 1 or 2 PriorPose2 rows: offsets of 36 and 72 bytes)
  and the gradient, at n in {1, 100, 1024, 10000, 13085}.
- The plain version against the JAX package on the same lowered arrays (the
  6x6 grid and a 400-pose tools/gen_citygrid graph, at a perturbed point):
  r at atol 1e-10 and J at atol 2e-5 against
  rome_tpu.solvers.linearize.linearize_all_mixed_j, except J2's last column
  (the float32 residual at the poses' magnitude, which both packages round:
  up to 1e-4 apart at 200 m), held at 4 float32 ulp of the pose magnitude
  through |S| and w; the batch's block of
  normal_eq_entry_values(..., float32) at 1e-5 of the block's largest
  magnitude; Jᵀr against the JAX package's einsum("nij,ni->nj", J, r) of the
  JAX package's own J and r at 1e-9 of the largest magnitude plus the
  propagated float32 rounding of J (|J_port - J_jax| |r|, summed over i:
  the two packages' sinf/cosf differ in the last bits).
- One ndchol LM step, and a whole ndchol solve, through the epilogue's
  route equal the earlier route bit for bit on the CPU: trial values, cost0,
  cost1, gnorm, dnorm, pred and CG iterations.
- The plan's checks, its reuse across iterations, and its dispatch.
- On a card (marker ``cuda``): the kernel against the plain version, the
  f64 residual at 1e-12 relative, J at atol 2e-5 or 1e-5 relative, the entry
  values at 2e-5 or 1e-5 of the summed magnitudes of their products, Jᵀr at 1e-9 relative against the plain contraction of the
  kernel's own J and r; entry blocks at offsets of 36, 72 and 144 bytes and
  tail tiles of 1, 63 and 29 factors.
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import rome_tpu as R  # noqa: E402
from rome_tpu.graph.lower import lower as jax_lower  # noqa: E402
from rome_tpu.solvers import linearize as JL  # noqa: E402
from rome_tpu_torch.graph.convert import graph_arrays_from_numpy  # noqa: E402
from rome_tpu_torch.ops import linearize_cuda as K  # noqa: E402
from rome_tpu_torch.ops.fused_linearize import pose2pose2_normal_plain  # noqa: E402
from rome_tpu_torch.solvers import gauss_newton as GN  # noqa: E402
from rome_tpu_torch.solvers import linearize as TL  # noqa: E402
from rome_tpu_torch.solvers.gauss_newton import GNOptions, ParametricSolver  # noqa: E402
from test_torch_helpers import grid_graph, port_arrays  # noqa: E402
from tools.gen_citygrid import generate  # noqa: E402

F32, F64 = torch.float32, torch.float64
SIZES = [1, 100, 1024, 10000, 13085]


def earlier_linearize_all_mixed_j(ga64, ga32, values, rt, ws=None):
    """The ndchol path's linearize as it was before the normal epilogue:
    every batch's f64 residual by the generic route, its f32 Jacobians by
    batch_linearize on the float32-cast table; no parts."""
    v32 = {t: v.to(F32) for t, v in values.items()}
    out = []
    for i, b in enumerate(ga64.batches):
        p, vs, w = rt["params"][i], rt["vslots"][i], rt["weight"][i]
        r64 = TL.batch_residual(ga64, b, values, p, vs, w)
        p32 = {k: v.to(F32) for k, v in p.items()}
        _r32, Js32 = TL.batch_linearize(ga32, b, v32, p32, vs, w.to(F32))
        out.append((b, r64, Js32, vs))
    return out, None


def _f64(ga32):
    ga64 = copy.copy(ga32)
    ga64.dtype = F64
    return ga64


def random_graph(n, prior_rows, seed=0, count=None):
    """(ga32, ga64, float64 values): a PriorPose2 batch of ``prior_rows``
    rows, then a Pose2Pose2 batch of n random factors over ``count`` poses
    spread over a 1 km square (the city grid's scale)."""
    rng = np.random.default_rng(seed)
    count = count or max(2, n // 2)
    values = np.concatenate([rng.uniform(-500, 500, (count, 2)),
                             rng.uniform(-np.pi, np.pi, (count, 1))], axis=1)
    values[: min(count, 3), 2] = [np.pi, -np.pi, np.pi - 1e-12][: min(count, 3)]

    def gaussian(rows):
        return dict(z=rng.normal(0, [5, 5, 2], (rows, 3)),
                    sqrt_info=rng.normal(0, 1, (rows, 3, 3)) + 8 * np.eye(3))

    vslots = rng.integers(0, count, (n, 2))
    batches = [
        dict(ftype="PriorPose2", vslots=np.zeros((prior_rows, 1), np.int64),
             params=gaussian(prior_rows), weight=np.ones(prior_rows)),
        dict(ftype="Pose2Pose2", vslots=vslots, params=gaussian(n),
             weight=rng.uniform(0.5, 1.0, n)),
    ]
    ga32 = graph_arrays_from_numpy(["Pose2"], {"Pose2": count}, {"Pose2": values},
                                   {"Pose2": np.ones(count)}, batches, device="cpu")
    return ga32, _f64(ga32), {"Pose2": torch.as_tensor(values)}


def _both_routes(ga32, ga64, values):
    rt = TL.runtime_state(ga32)
    lins, parts = TL.linearize_all_mixed_j(ga64, ga32, values, rt)
    vals = TL.normal_eq_entry_values(ga64, lins, dtype=F32, parts=parts)
    g = TL.gradient_from_lins(ga64, lins, rt, parts=parts)
    old, _ = earlier_linearize_all_mixed_j(ga64, ga32, values, rt)
    return (lins, parts, vals, g), (old, TL.normal_eq_entry_values(ga64, old, dtype=F32),
                                    TL.gradient_from_lins(ga64, old, rt))


def _exact(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("prior_rows", [1, 2])
@pytest.mark.parametrize("n", SIZES)
def test_plain_normal_equals_the_earlier_route_bit_for_bit(n, prior_rows):
    ga32, ga64, values = random_graph(n, prior_rows, seed=n)
    (lins, parts, vals, g), (old, vals_old, g_old) = _both_routes(ga32, ga64, values)
    assert parts.offsets == (0, 9 * prior_rows) and list(parts.jtr) == [1]
    assert vals.data_ptr() == parts.vals.data_ptr()
    for (_b, r, Js, _v), (_b2, r_o, Js_o, _v2) in zip(lins, old):
        assert r.dtype == F64 and all(J.dtype == F32 for J in Js)
        _exact(r, r_o)
        for J, J_o in zip(Js, Js_o):
            _exact(J, J_o)
    _exact(vals, vals_old)
    r_o, Js_o = old[1][1], old[1][2]
    for k in range(2):
        _exact(parts.jtr[1][k], TL.einsum("nij,ni->nj", Js_o[k], r_o))
    _exact(g["Pose2"], g_old["Pose2"])


def test_plain_normal_function_is_the_plan_on_the_cpu():
    ga32, _ga64, values = random_graph(300, 1, seed=3)
    b, rt = ga32.batches[1], TL.runtime_state(ga32)
    args = (rt["vslots"][1], b.params["z"], b.params["sqrt_info"], rt["weight"][1])
    entries = torch.full((36 * b.n + 5,), -1.0)
    plan = K.Pose2Pose2Normal(*args, values["Pose2"].shape[0], entries[3: 3 + 36 * b.n])
    before = dict(K.LAUNCHES)
    r, (J1, J2), jtr = plan(values["Pose2"])
    assert K.LAUNCHES == before  # the plain path launches nothing
    want = pose2pose2_normal_plain(values["Pose2"], *args)
    for got, ref in ((r, want[0]), (J1, want[1][0]), (J2, want[1][1]), (jtr, want[3]),
                     (entries[3: 3 + 36 * b.n], want[2].reshape(-1))):
        _exact(got, ref)
    assert (entries[:3] == -1).all() and (entries[3 + 36 * b.n:] == -1).all()


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def _citygrid400(mod, tmp_path):
    poses, edges, _ = generate(400)
    path = tmp_path / f"citygrid400_{mod.__name__}.g2o"
    with open(path, "w") as fh:
        for i, p in enumerate(poses):
            fh.write(f"VERTEX_SE2 {i} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        for a, b, z, it, ir in edges:
            fh.write(f"EDGE_SE2 {a} {b} {z[0]:.6f} {z[1]:.6f} {z[2]:.6f} "
                     f"{it:.6f} 0 0 {it:.6f} 0 {ir:.6f}\n")
    fg = mod.load_g2o(None, str(path))
    fg.add_factor(["x0"], mod.PriorPose2(mod.MvNormal([0, 0, 0], [0.1, 0.1, 0.05])),
                  graphinit=False)
    fg.init_all()
    return fg


@pytest.fixture(scope="module", params=["grid6", "citygrid400"])
def jax_pair(request, tmp_path_factory):
    """(port float32 GraphArrays, float64 evaluation point, the index of the
    Pose2Pose2 batch, the JAX package's results for it: r, J, the entry
    vector, einsum J'r). On the grid the PriorPose2 batch comes first (the
    Pose2Pose2 block sits 36 bytes into the entry vector), on the loaded
    g2o graph last."""
    rng = np.random.default_rng(11)
    with jax.enable_x64():
        if request.param == "grid6":
            fg = grid_graph(R, 6, 6, seed=2)
        else:
            fg = _citygrid400(R, tmp_path_factory.mktemp("cg"))
        ga32 = jax_lower(fg)
        ga64 = copy.copy(ga32)
        ga64.dtype = jnp.float64
        v0 = np.asarray(ga32.values0["Pose2"], np.float64)
        v = v0 + rng.normal(0, [0.3, 0.3, 0.05], v0.shape)

        names = [b.ftype.name for b in ga32.batches]
        i = names.index("Pose2Pose2")

        def run(v, rt):
            lins = JL.linearize_all_mixed_j(ga64, ga32, {"Pose2": v}, rt)
            vals = JL.normal_eq_entry_values(ga64, lins, dtype=jnp.float32)
            _b, r, Js, _vs = lins[i]
            return r, Js, vals, [jnp.einsum("nij,ni->nj", J, r) for J in Js]

        want = jax.tree_util.tree_map(np.asarray, jax.jit(run)(jnp.asarray(v),
                                                               JL.runtime_state(ga32)))
    assert sorted(names) == ["Pose2Pose2", "PriorPose2"]
    return port_arrays(ga32), v, i, want


def test_plain_normal_matches_jax(jax_pair):
    tg32, v, i, (r_j, Js_j, vals_j, jtr_j) = jax_pair
    rt = TL.runtime_state(tg32)
    lins, parts = TL.linearize_all_mixed_j(_f64(tg32), tg32, {"Pose2": torch.as_tensor(v)}, rt)
    _b, r, Js, _vs = lins[i]
    n = r.shape[0]
    assert list(parts.jtr) == [i]
    np.testing.assert_allclose(r.numpy(), r_j, rtol=0, atol=1e-10)
    # J2's last column carries the float32 residual of the float32 poses,
    # which both packages round at the poses' magnitude (100s of metres on
    # the city grid): it is held at 4 ulp of that magnitude through S and w
    p_mag = np.abs(v[_vs.numpy()][..., :2]).max(axis=(1, 2))
    S, w = (t.numpy().astype(np.float64) for t in (rt["params"][i]["sqrt_info"], rt["weight"][i]))
    res_tol = 4 * np.spacing(p_mag.astype(np.float32)) * np.abs(S).sum(-1).T * w
    for k, (J, J_j) in enumerate(zip(Js, Js_j)):
        J = J.numpy()
        if k == 1:
            assert (np.abs(J[:, :, 2] - J_j[:, :, 2]) <= np.maximum(2e-5, res_tol.T)).all()
            J, J_j = J[:, :, :2], J_j[:, :, :2]
        np.testing.assert_allclose(J, J_j, rtol=0, atol=2e-5)
    o = parts.offsets[i]
    block, block_j = parts.vals[o: o + 36 * n].numpy(), vals_j[o: o + 36 * n]
    np.testing.assert_allclose(block, block_j, rtol=1e-5, atol=1e-5 * np.abs(block_j).max())
    for k in range(2):
        got = parts.jtr[i][k].numpy()
        # what the float32 rounding of J alone can move: sum_i |dJ_ij| |r_i|
        dj = np.abs(Js[k].numpy().astype(np.float64) - Js_j[k])
        spread = np.einsum("nij,ni->nj", dj, np.abs(r_j))
        tol = 1e-9 * np.abs(jtr_j[k]).max() + spread
        assert (np.abs(got - jtr_j[k]) <= tol).all()


# ---------------------------------------------------------------------------
# the LM step and solve through both routes
# ---------------------------------------------------------------------------

STEP_OPTS = dict(linear="ndchol", polish_tol=5e-2, nd_leaf=8, polish_iters=60,
                 chol_jitter=1e-7, lam0=1e-6)


def _step_graph(which, tmp_path):
    import rome_tpu_torch as T
    from rome_tpu_torch.graph.lower import lower

    fg = grid_graph(T, 6, 6, seed=5) if which == "grid6" else _citygrid400(T, tmp_path)
    return lower(fg, device="cpu")


@pytest.mark.parametrize("which", ["grid6", "citygrid400"])
def test_ndchol_step_equals_the_earlier_route(which, tmp_path, monkeypatch):
    """grid6 takes the f32 Hvp (edge scale 1), citygrid400 the f64 one."""
    ga = _step_graph(which, tmp_path)
    rng = np.random.default_rng(4)
    values = {"Pose2": ga.values0["Pose2"].to(F64)
              + torch.as_tensor(rng.normal(0, [0.2, 0.2, 0.02], (ga.counts["Pose2"], 3)))}
    solver = ParametricSolver(ga, GNOptions(**STEP_OPTS))
    assert solver._mixed_j
    lam = np.float32(1e-4)
    steps = [solver.step(values, lam, solver._rt0), solver.step(values, lam, solver._rt0)]
    monkeypatch.setattr(GN, "linearize_all_mixed_j", earlier_linearize_all_mixed_j)
    old = ParametricSolver(ga, GNOptions(**STEP_OPTS)).step(values, lam, solver._rt0)
    for new in steps:  # the second reuses the workspace's buffers
        trial, rest = new[0], new[1:]
        _exact(trial["Pose2"], old[0]["Pose2"])
        assert rest == old[1:]
        assert rest[-1] > 0  # CG iterations


def test_ndchol_solve_equals_the_earlier_route(monkeypatch):
    import rome_tpu_torch as T
    from rome_tpu_torch.graph.lower import lower

    ga = lower(grid_graph(T, 6, 6, seed=3), device="cpu")
    opts = dict(STEP_OPTS, max_iters=30, polish_tol=1e-8, ftol=1e-12, gtol=1e-10, nd_leaf=4)
    v_new, st_new = ParametricSolver(ga, GNOptions(**opts)).solve()
    monkeypatch.setattr(GN, "linearize_all_mixed_j", earlier_linearize_all_mixed_j)
    v_old, st_old = ParametricSolver(ga, GNOptions(**opts)).solve()
    _exact(v_new["Pose2"], v_old["Pose2"])
    assert st_new.history == st_old.history and st_new.iterations > 2
    assert (st_new.final_cost, st_new.reason) == (st_old.final_cost, st_old.reason)


# ---------------------------------------------------------------------------
# the plan: checks, reuse, dispatch
# ---------------------------------------------------------------------------

def _plan_args(n=20, seed=6):
    ga32, _ga64, values = random_graph(n, 1, seed=seed)
    rt = TL.runtime_state(ga32)
    b = ga32.batches[1]
    return [rt["vslots"][1], b.params["z"], b.params["sqrt_info"], rt["weight"][1],
            values["Pose2"].shape[0], torch.zeros(36 * n)], values["Pose2"]


@pytest.mark.parametrize("bad", ["vslots_int32", "z_f64", "S_shape", "w_noncontig",
                                 "entries_short", "slot_range", "meta_device"])
def test_normal_plan_rejects_bad_inputs(bad):
    args, _values = _plan_args()
    if bad == "vslots_int32":
        args[0] = args[0].to(torch.int32)
    elif bad == "z_f64":
        args[1] = args[1].to(F64)
    elif bad == "S_shape":
        args[2] = args[2][:, :2]
    elif bad == "w_noncontig":
        args[3] = torch.stack([args[3], args[3]], 1)[:, 0]
    elif bad == "entries_short":
        args[5] = args[5][1:]
    elif bad == "slot_range":
        args[4] = int(args[0].max())
    else:
        args = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises((TypeError, ValueError)):
        K.Pose2Pose2Normal(*args)


@pytest.mark.parametrize("bad", ["f32", "rows", "noncontig"])
def test_normal_plan_rejects_bad_tables(bad):
    args, values = _plan_args()
    plan = K.Pose2Pose2Normal(*args)
    values = {"f32": values.to(F32), "rows": values[1:],
              "noncontig": values.t().contiguous().t()}[bad]
    with pytest.raises(ValueError):
        plan(values)


def test_workspace_reuses_its_plan_and_buffers():
    ga32, ga64, values = random_graph(50, 1, seed=8)
    rt = TL.runtime_state(ga32)
    ws = TL.NormalEqWorkspace(ga64)
    lins1, parts1 = TL.linearize_all_mixed_j(ga64, ga32, values, rt, ws)
    plan = ws._plans[1]
    moved = {"Pose2": values["Pose2"] + 0.01}
    lins2, parts2 = TL.linearize_all_mixed_j(ga64, ga32, moved, rt, ws)
    assert ws._plans[1] is plan and parts2.vals is parts1.vals
    assert lins2[1][1].data_ptr() == lins1[1][1].data_ptr()
    fresh, _ = TL.linearize_all_mixed_j(ga64, ga32, moved, rt)
    _exact(lins2[1][1], fresh[1][1])
    # other inputs, another plan
    rt2 = TL.runtime_state(ga32)
    rt2["weight"] = tuple(w.clone() for w in rt2["weight"])
    TL.linearize_all_mixed_j(ga64, ga32, moved, rt2, ws)
    assert ws._plans[1] is not plan


def test_cuda_tensors_never_take_the_plain_normal_path(monkeypatch):
    """A CUDA-typed plan reaches the build step, whose failure propagates."""
    args, values = _plan_args()
    plan = K.Pose2Pose2Normal(*args)

    def no_build():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(K, "_lib", None)
    monkeypatch.setattr(K, "build", no_build)
    plan.device = torch.device("cuda", 0)
    monkeypatch.setattr(torch.Tensor, "device", property(lambda t: torch.device("cuda", 0)))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        plan(values)


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K1 kernel has no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("prior_rows", [1, 2, 4])
@pytest.mark.parametrize("n", [1, 63, 64, 1000, 13085])
def test_cuda_normal_matches_plain(cuda_device, n, prior_rows):
    ga32, ga64, values = random_graph(n, prior_rows, seed=n + prior_rows)
    rt = TL.runtime_state(ga32)
    want_lins, want_parts = TL.linearize_all_mixed_j(ga64, ga32, values, rt)
    dev = lambda t: t.to(cuda_device)  # noqa: E731
    ga32c = graph_arrays_from_numpy(
        ["Pose2"], dict(ga32.counts), {"Pose2": values["Pose2"].numpy()},
        {"Pose2": np.ones(ga32.counts["Pose2"])},
        [dict(ftype=b.ftype.name, vslots=b.vslots.numpy(),
              params={k: v.numpy() for k, v in b.params.items()}, weight=b.weight.numpy())
         for b in ga32.batches], device="cuda")
    rtc = TL.runtime_state(ga32c)
    before = K.LAUNCHES["normal"]
    lins, parts = TL.linearize_all_mixed_j(_f64(ga32c), ga32c, {"Pose2": dev(values["Pose2"])},
                                           rtc)
    torch.cuda.synchronize()
    assert K.LAUNCHES["normal"] == before + 1
    _b, r, Js, _v = lins[1]
    _b, r_w, Js_w, _v = want_lins[1]
    torch.testing.assert_close(r.cpu(), r_w, rtol=0, atol=1e-12 * (1 + float(r_w.abs().max())))
    for J, J_w in zip(Js, Js_w):
        torch.testing.assert_close(J.cpu(), J_w, rtol=1e-5, atol=2e-5)
    # an entry is a float32 sum of three products: held at 2e-5 or 1e-5 of
    # the summed magnitudes of its products
    o = parts.offsets[1]
    terms = torch.stack([TL.einsum("nij,nik->njk", Js_w[k].abs(), Js_w[m].abs())
                         for k in (0, 1) for m in (0, 1)]).reshape(-1)
    d = (parts.vals[o: o + 36 * n].cpu() - want_parts.vals[o: o + 36 * n]).abs()
    assert bool(((d <= 2e-5) | (d <= 1e-5 * terms)).all())
    # Jᵀr against the plain contraction of the kernel's own J and r (J differs
    # from the plain J in its last bits, which J's own check covers)
    for k in range(2):
        want = TL.einsum("nij,ni->nj", Js[k], r)
        torch.testing.assert_close(parts.jtr[1][k], want, rtol=1e-9,
                                   atol=1e-9 * float(want.abs().max()))
