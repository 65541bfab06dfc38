"""The fused schedule as one device program (rome_tpu_torch/utils/
device_loop.py, ``_LMProgram`` in rome_tpu_torch/solvers/gauss_newton.py),
against the JAX package's jitted fused loop, on the CPU (the program's eager
runner: the same bodies, each guard read on the host).

- ``solve_graph_parametric(..., schedule="fused", options=GNOptions(
  fused_chordal=True, linear="ndchol", ...))`` against the JAX package's
  same call: the same iterations and reason, poses at 1e-4
  (``_assert_same_solve``) and the final cost within 1e-9, the tolerance of
  test_speculative_ndchol_matches_jax_fused_schedule. The 6x6 grid takes
  the dense chordal branch, the 18x18 grid (324 poses) the sparse one
  (``init2d._SPARSE_THRESHOLD``); the port's chordal runs inside the
  program, never as ``chordal_init_pose2``.
- The LM decisions on the device against the JAX loop's ``where`` chains:
  a start far from the optimum (three rejected steps) gives the same
  iterations, reason and history: accept flags, damping and CG iterations
  equal, costs within 1e-5 relative, gradient and step norms within 1e-3
  relative plus 1e-4 of their column's largest value (far from the optimum
  the two packages' steps differ at the float32 factorization's and the
  CG's noise).
- The fused chordal start equals ``chordal_init_pose2``'s up to the latter's
  float32 output; frozen poses stay bit-identical.
- A cached solver serving another graph of the same structure copies that
  graph's data into the program's static inputs: its solve equals a fresh
  solver's bit for bit.
- The device loop's eager runner: guards, bounded loops, the one read.
- An ast guard (no imports): no host read (``float(``, ``int(``,
  ``bool(``, ``.item()``, ``.tolist()``) and no ``torch.tensor(<value>,
  device=...)`` in the functions the program captures.
- ``device="cuda"`` without CUDA still raises (utils/device.py).
- On the card (``cuda`` marker, skipped here): the captured program against
  its eager runner, bit for bit.
"""

import ast
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import rome_tpu as R  # noqa: E402
import rome_tpu_torch as T  # noqa: E402
from rome_tpu_torch.graph.lower import lower  # noqa: E402
from rome_tpu_torch.solvers import init2d  # noqa: E402
from rome_tpu_torch.solvers.gauss_newton import ParametricSolver  # noqa: E402
from rome_tpu_torch.solvers.linearize import runtime_state  # noqa: E402
from rome_tpu_torch.utils import device_loop  # noqa: E402
from test_torch_helpers import grid_graph  # noqa: E402
from test_torch_slice import NDCHOL_OPTS, _assert_same_solve  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "rome_tpu_torch")
FUSED = dict(NDCHOL_OPTS, linear="ndchol", fused_chordal=True)
HIST_KEYS = ("cost0", "cost1", "gnorm", "dnorm", "accepted", "lam", "cg")


def _perturbed(mod, side, scale, seed=9):
    """The grid with every pose moved by seeded noise of ``scale`` x (0.5 m,
    0.5 m, 0.4 rad)."""
    fg = grid_graph(mod, side, side, seed=3)
    noise = np.random.default_rng(seed).normal(0, [0.5, 0.5, 0.4], (side * side, 3)) * scale
    for k, lbl in enumerate(fg.ls()):
        fg.set_point(lbl, fg.get_point(lbl) + noise[k])
    return fg


def _solve_both(side, opts, chordal_init=True, scale=0.0):
    with jax.enable_x64():
        fg_j = _perturbed(R, side, scale)
        res_j = R.solve_graph_parametric(fg_j, init=False, options=R.GNOptions(**opts),
                                         chordal_init=chordal_init, schedule="fused")
    fg_t = _perturbed(T, side, scale)
    res_t = T.solve_graph_parametric(fg_t, init=False, options=T.GNOptions(**opts),
                                     chordal_init=chordal_init, schedule="fused", device="cpu")
    return res_j, fg_j, res_t, fg_t


def _history(stats):
    return np.array([[float(h[k]) for k in HIST_KEYS] for h in stats.history])


@pytest.mark.parametrize("side", [6, 18])
def test_fused_chordal_solve_matches_jax(side, monkeypatch):
    def separate(*_a, **_k):
        raise AssertionError("the fused schedule ran the chordal init as its own stage")

    monkeypatch.setattr(init2d, "chordal_init_pose2", separate)
    res_j, fg_j, res_t, fg_t = _solve_both(side, FUSED)
    _assert_same_solve(res_j, fg_j, res_t, fg_t)
    assert abs(res_t["stats"].final_cost - res_j["stats"].final_cost) <= 1e-9
    assert res_t["linear_solver"] == "ndchol"


def test_lm_decisions_match_the_jax_fused_history():
    opts = dict(FUSED, fused_chordal=False)
    res_j, fg_j, res_t, fg_t = _solve_both(6, opts, chordal_init=False, scale=4.0)
    sj, st = res_j["stats"], res_t["stats"]
    assert st.iterations == sj.iterations and st.reason == sj.reason
    hj, ht = _history(sj), _history(st)
    assert ht.shape == hj.shape == (st.iterations, 7)
    accepted = ht[:, 4]
    assert (accepted == 0).sum() >= 3, "the start should make the loop reject steps"
    # accept flags, damping (float32 in both) and CG iterations equal
    np.testing.assert_array_equal(ht[:, 4], hj[:, 4])
    np.testing.assert_array_equal(ht[:, 5].astype(np.float32), hj[:, 5].astype(np.float32))
    np.testing.assert_array_equal(ht[:, 6], hj[:, 6])
    # costs within 1e-5: far from the optimum the two packages' trial steps
    # differ at the float32 factorization's and Jacobians' noise (the JAX
    # history is float32 besides)
    np.testing.assert_allclose(ht[:, :2], hj[:, :2], rtol=1e-5, atol=0)
    for col in (2, 3):
        tol = 1e-3 * np.abs(hj[:, col]) + 1e-4 * np.abs(hj[:, col]).max()
        assert (np.abs(ht[:, col] - hj[:, col]) <= tol).all(), (col, ht[:, col], hj[:, col])
    # a rejected step keeps the carried cost
    for k in np.nonzero(accepted == 0)[0]:
        assert ht[k + 1, 0] == ht[k, 0]
    _assert_same_solve(res_j, fg_j, res_t, fg_t)


@pytest.mark.parametrize("frozen", [(), ("x7",)])
def test_fused_chordal_start_is_the_separate_chordal_init(frozen):
    fg = grid_graph(T, 6, 6, seed=3, frozen=frozen)
    ga = lower(fg, device="cpu")
    solver = ParametricSolver(ga, T.GNOptions(**FUSED))
    assert solver.fuses_chordal
    _values, stats = solver.solve(None, runtime_state(ga))
    assert stats.converged
    fused = solver.last_program.chordal_start
    assert fused.dtype == torch.float64
    separate = init2d.chordal_init_pose2(ga, ga.values0)["Pose2"]
    assert separate.dtype == torch.float32
    np.testing.assert_allclose(fused.numpy(), separate.double().numpy(), rtol=1e-6, atol=1e-6)
    for lbl in frozen:
        s = ga.var_labels["Pose2"].index(lbl)
        assert torch.equal(fused[s], ga.values0["Pose2"][s].double())


def test_cached_solver_copies_the_other_graphs_data_in():
    fg_a, fg_b = grid_graph(T, 6, 6, seed=3), grid_graph(T, 6, 6, seed=8)
    ga_a, ga_b = lower(fg_a, device="cpu"), lower(fg_b, device="cpu")
    solver = ParametricSolver(ga_a, T.GNOptions(**FUSED))
    solver.solve(None, runtime_state(ga_a))
    got, st = solver.solve(ga_b.values0, runtime_state(ga_b))
    want, sw = ParametricSolver(ga_b, T.GNOptions(**FUSED)).solve(None, runtime_state(ga_b))
    assert len(solver._programs) == 1, "one connectivity, one program"
    assert st.iterations == sw.iterations and st.final_cost == sw.final_cost
    assert torch.equal(got["Pose2"], want["Pose2"])
    assert _history(st).tolist() == _history(sw).tolist()


def test_device_loop_eager_runner():
    n = torch.zeros((), dtype=torch.int64)
    live = torch.ones((), dtype=torch.bool)
    ran = torch.zeros((), dtype=torch.int64)
    counts = {"k": 0}

    def start(run):
        n.zero_()
        live.fill_(True)

    def body():
        n.add_(1)
        device_loop.count(counts, "k")
        live.copy_(n < 7)

    def step(run):
        run.cond(n > 100, lambda: ran.add_(1))  # never taken
        run.loop(20, live, body)
        run.cond(n == 7, lambda: ran.add_(10))

    prog = device_loop.Program("cpu", [(start, 1), (step, 2)])
    prog.run()
    assert not prog.captured
    # the loop stops after 7 bodies; the second phase run finds live false
    assert int(n) == 7 and counts == {"k": 7} and int(ran) == 20
    host = prog.read([n, ran, torch.tensor([1.5, 2.5])])
    assert host.dtype == np.float64 and host.tolist() == [7.0, 20.0, 1.5, 2.5]
    assert counts == {"k": 7}, "an eager run's launches count on the host, once"


# the functions a device program captures: (module, qualified name)
CAPTURED = {
    "utils/device_loop.py": ["count"],
    "solvers/gauss_newton.py": [
        "_tdot", "_safe", "guarded_cg", "ParametricSolver._linearize", "ParametricSolver._sumsq",
        "ParametricSolver._boxplus_all", "ParametricSolver._cg_polish",
        "ParametricSolver._polish_result", "ParametricSolver._linear_solve",
        "ParametricSolver._solve_ndchol", "ParametricSolver._marquardt",
        "ParametricSolver._accepted_code", "ParametricSolver._rejected_code",
        "ParametricSolver._lm_update", "_LMState.reset", "_LMProgram._start",
        "_LMProgram._carry", "_LMProgram._iterate", "_LMProgram._step",
        "_nan_if_failed", "_dense_cholesky", "_cho_solve", "ParametricSolver._solve_dense32",
        "ParametricSolver._step_tensors", "_DenseProgram._start", "_DenseProgram._iterate",
        "_DenseProgram._step", "_DenseProgram._finish"],
    "solvers/init2d.py": [
        "_rdot", "_solve_spd_delta", "_ndchol_spd_delta", "_rot_terms",
        "_rot_rows", "_tr_terms", "_edge_info", "_tr_rows", "_rot_entries", "_tr_entries",
        "_chordal_body", "ChordalProgram._body"],
    "solvers/linearize.py": [
        "_whitened_residual_fn", "_gather_points", "_zero_deltas", "batch_residual",
        "batch_linearize", "linearize_all", "linearize_all_mixed_j", "NormalEqWorkspace.normal",
        "_free_of", "TangentScatter.sum", "tangent_scatter", "gradient_from_lins",
        "hvp_from_lins", "flatten_tangent", "unflatten_tangent", "free_vector", "_entry_blocks",
        "normal_eq_entry_values", "cost_at", "DenseScatter.terms", "DenseScatter.sum",
        "DenseScatter.restrict", "DenseScatter.extend", "dense_normal_eqs"],
    "solvers/sparse/ndchol.py": [
        "ndchol_assemble", "_chol_or_nan", "_tri_inv", "ndchol_factorize", "ndchol_solve"],
    "ops/segment_sum.py": ["SegmentPlan.add_", "FixedSegmentPlan.add_"],
    "ops/linearize_cuda.py": ["_launch", "pose2pose2_linearize", "Pose2Pose2Normal.__call__"],
    "ops/fused_linearize.py": ["pose2pose2_linearize_plain", "pose2pose2_normal_plain"],
    "solvers/multimodal/convolve.py": ["_gn_solve_target", "_conv", "_GNProgram._body"],
}
HOST_CASTS = {"float", "int", "bool"}
HOST_METHODS = {"item", "tolist"}


def host_reads(source, names):
    """(qualified function, line, what) of every host read in the functions
    ``names`` of ``source``: a float/int/bool call, .item(), .tolist(), or
    torch.tensor(...) with a device. Nested functions count as their
    enclosing function's. Raises if a name is not found."""
    tree = ast.parse(source)
    found, out = set(), []

    def scan(fn_node, qual):
        for node in ast.walk(fn_node):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Name) and f.id in HOST_CASTS:
                out.append((qual, node.lineno, f.id))
            elif isinstance(f, ast.Attribute) and f.attr in HOST_METHODS:
                out.append((qual, node.lineno, "." + f.attr))
            elif (isinstance(f, ast.Attribute) and f.attr == "tensor"
                  and isinstance(f.value, ast.Name) and f.value.id == "torch"
                  and any(k.arg == "device" for k in node.keywords)):
                out.append((qual, node.lineno, "torch.tensor(..., device=)"))

    def visit(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                visit(child, prefix + child.name + ".")
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = prefix + child.name
                if qual in names:
                    found.add(qual)
                    scan(child, qual)

    visit(tree, "")
    missing = set(names) - found
    if missing:
        raise LookupError(f"not found: {sorted(missing)}")
    return out


def test_no_host_read_in_the_captured_functions():
    bad = []
    for rel, names in CAPTURED.items():
        with open(os.path.join(ROOT, rel), encoding="utf-8") as fh:
            bad += [f"{rel}:{line} {qual}: {what}"
                    for qual, line, what in host_reads(fh.read(), names)]
    assert not bad, "host reads in captured functions:\n" + "\n".join(bad)


@pytest.mark.parametrize("snippet,hits", [
    ("def f(x):\n    return float(x)", 1),
    ("def f(x):\n    return int(x) + bool(x)", 2),
    ("def f(x):\n    return x.item()", 1),
    ("def f(x):\n    return x.sum().tolist()", 1),
    ("def f(x):\n    return torch.tensor(x, device='cuda')", 1),
    ("def f(x):\n    return torch.tensor([1.0])", 0),
    ("def f(x):\n    return torch.full((), 3.0, device=x.device)", 0),
    ("def f(x):\n    def g():\n        return float(x)\n    return g", 1),
    ("class C:\n    def f(self, x):\n        return x.item()", 1),
])
def test_the_host_read_scan_sees_every_form(snippet, hits):
    name = "C.f" if snippet.startswith("class") else "f"
    assert len(host_reads(snippet, [name])) == hits


def test_cuda_without_cuda_still_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    fg = grid_graph(T, 3, 3, seed=3)
    before = {lbl: fg.get_point(lbl).copy() for lbl in fg.ls()}
    with pytest.raises(RuntimeError, match='device="cpu"'):
        T.solve_graph_parametric(fg, init=False, options=T.GNOptions(**FUSED), device="cuda")
    assert all(np.array_equal(fg.get_point(lbl), p) for lbl, p in before.items())


@pytest.mark.cuda
def test_captured_program_matches_its_eager_runner_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the program is captured only on the card")
    ga = lower(grid_graph(T, 18, 18, seed=3), device="cuda")
    solver = ParametricSolver(ga, T.GNOptions(**FUSED))
    rt = runtime_state(ga)
    got, sg = solver.solve(None, rt)
    start = solver.last_program.chordal_start.clone()
    want, sw = solver.solve(None, rt, eager=True)
    assert solver.last_program.program.captured
    assert torch.equal(start, solver.last_program.chordal_start)
    assert sg.iterations == sw.iterations and sg.final_cost == sw.final_cost
    assert torch.equal(got["Pose2"], want["Pose2"])
