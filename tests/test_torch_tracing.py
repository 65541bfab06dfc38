"""The port's span-and-counter recorder (rome_tpu_torch/utils/profiling.py)
and the device programs' phase stamps (utils/device_loop.py), on the CPU,
where a program runs its eager runner and stamps on the host clock.

- A fused-schedule solve (ndchol, speculative, fused_chordal) records one
  root ``solve`` whose children are lower, cache, plan, run, write_back:
  in order, disjoint, inside it.
- Each LM iteration phase is stamped once an executed iteration; the
  phases' sum lies inside the program's span; the stamps come back in the
  program's one read.
- Recording changes no arithmetic: values and SolveStats bit-equal on/off.
- The structure cache's counters: misses, a clear, a hit.
- The ring keeps at most its capacity of roots; ``export_chrome`` writes a
  host track and a device track; ``summary`` totals spans and phases.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import rome_tpu_torch as T  # noqa: E402
from rome_tpu_torch.solvers import gauss_newton as GN  # noqa: E402
from rome_tpu_torch.utils import device_loop, profiling  # noqa: E402

FUSED = dict(max_iters=30, polish_tol=1e-8, polish_iters=40, lam0=1e-6, lam_down=0.1,
             lam_min=1e-12, chol_jitter=1e-7, ftol=1e-12, gtol=1e-10, nd_leaf=4,
             linear="ndchol", speculative=True, fused_chordal=True)
CHILDREN = ["solve.lower", "solve.cache", "solve.plan", "solve.run", "solve.write_back"]
ITERATION = ("lm.assemble", "lm.factorize", "lm.cg", "lm.linearize", "lm.update")


def grid_graph(mod, rows, cols, seed=0):
    """A 2D grid pose graph: odometry chain, cross links, an x0 prior."""
    rng = np.random.default_rng(seed)
    fg = mod.FactorGraph()
    for i in range(rows * cols):
        fg.add_variable(f"x{i}", mod.Pose2)
    fg.add_factor(["x0"], mod.PriorPose2(mod.MvNormal([0, 0, 0], [0.1, 0.1, 0.05])))
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            for j, d in ((i + 1, (1, 0)), (i + cols, (0, 1))):
                if (j == i + 1 and c + 1 < cols) or (j == i + cols and r + 1 < rows):
                    z = [d[0] + rng.normal(0, 0.02), d[1] + rng.normal(0, 0.02),
                         rng.normal(0, 0.01)]
                    fg.add_factor([f"x{i}", f"x{j}"],
                                  mod.Pose2Pose2(mod.MvNormal(z, [0.1, 0.1, 0.05])))
    fg.init_all()
    return fg


def _graph(side=6, scale=1.0):
    """The grid with every pose moved by seeded noise, so LM iterates."""
    fg = grid_graph(T, side, side, seed=3)
    noise = np.random.default_rng(9).normal(0, [0.5, 0.5, 0.4], (side * side, 3)) * scale
    for k, lbl in enumerate(fg.ls()):
        fg.set_point(lbl, fg.get_point(lbl) + noise[k])
    return fg


def _solve(fg=None):
    fg = _graph() if fg is None else fg
    res = T.solve_graph_parametric(fg, init=False, options=T.GNOptions(**FUSED),
                                   schedule="fused", device="cpu")
    return fg, res, profiling.roots()[-1]


@pytest.fixture(autouse=True)
def _recording():
    profiling.enable(True)
    yield
    profiling.enable(True)


def test_solve_records_one_root_with_its_children_in_order():
    before = len(profiling.roots())
    _fg, res, root = _solve()
    assert len(profiling.roots()) == before + 1
    assert root.name == "solve" and root.parent is None
    kids = root.children
    assert [c.name for c in kids] == CHILDREN
    assert root.start <= kids[0].start
    for a, b in zip(kids, kids[1:]):
        assert a.end <= b.start, (a.name, b.name)
    assert kids[-1].end <= root.end
    assert all(s.request == root.request for s in root.walk())
    assert res["stats"].iterations > 1


def test_iteration_phases_are_stamped_once_an_iteration():
    _fg, res, root = _solve()
    it = res["stats"].iterations
    calls, ns = root.attrs["calls"], root.attrs["device_ns"]
    for phase in ITERATION:
        assert calls[phase] == it, (phase, calls)
    assert calls["lm.chordal"] == calls["lm.start_linearize"] == 1
    assert all(v > 0 for v in ns.values())
    assert sum(ns.values()) <= root.attrs["program_device_ns"]
    run = next(c for c in root.children if c.name == "solve.run")
    assert root.attrs["program_device_ns"] <= run.end - run.start
    (name, begin, end, clock), = root.attrs["device_spans"]
    assert clock == "host" and run.start <= begin < end <= run.end
    assert name == "lm_ndchol_fused_chordal"


def test_one_read_a_solve_carries_the_stamps(monkeypatch):
    real, seen = device_loop.Program.read, []

    def read(self, tensors):
        before = dict(profiling.current().root.attrs.get("calls", {}))
        out = real(self, tensors)
        seen.append((before, dict(profiling.current().root.attrs["calls"])))
        return out

    monkeypatch.setattr(device_loop.Program, "read", read)
    _fg, res, _root = _solve()
    (before, after), = seen
    assert before == {} and after["lm.update"] == res["stats"].iterations


def test_recording_changes_no_arithmetic():
    profiling.enable(False)
    n = len(profiling.roots())
    fg_off = _graph()
    res_off = T.solve_graph_parametric(fg_off, init=False, options=T.GNOptions(**FUSED),
                                       schedule="fused", device="cpu")
    assert len(profiling.roots()) == n
    profiling.enable(True)
    fg_on, res_on, _root = _solve()
    a, b = res_off["stats"], res_on["stats"]
    assert (a.iterations, a.reason, a.converged) == (b.iterations, b.reason, b.converged)
    assert float(a.final_cost).hex() == float(b.final_cost).hex()
    assert a.history == b.history
    for lbl in fg_on.ls():
        assert np.array_equal(fg_on.get_point(lbl), fg_off.get_point(lbl)), lbl


def test_structure_cache_counts_misses_clears_and_hits(monkeypatch):
    monkeypatch.setattr(GN, "_SOLVER_CACHE", {})
    opts = T.GNOptions(linear="dense", max_iters=3)

    def solve(side):
        with profiling.annotate("case"):
            T.solve_graph_parametric(grid_graph(T, 2, side, seed=1), init=False,
                                     options=opts, chordal_init=False, device="cpu")
        return profiling.roots()[-1].attrs

    firsts = [solve(side) for side in range(2, 10)]
    assert [a.get("solver_cache.miss") for a in firsts] == [1] * 8
    assert not any("solver_cache.clear" in a or "solver_cache.hit" in a for a in firsts)
    ninth = solve(10)
    assert ninth.get("solver_cache.miss") == 1 and ninth.get("solver_cache.clear") == 1
    again = solve(10)
    assert again.get("solver_cache.hit") == 1 and "solver_cache.miss" not in again
    assert sum(1 for _ in profiling.spans("solver.build", [profiling.roots()[-2]])) == 1


def test_the_ring_keeps_its_capacity():
    for k in range(profiling.RING_ROOTS + 25):
        with profiling.annotate("tick", k=k):
            with profiling.annotate("tock"):
                profiling.count("ticks")
    roots = profiling.roots()
    assert len(roots) == profiling.RING_ROOTS
    assert roots[-1].attrs == {"k": profiling.RING_ROOTS + 24, "ticks": 1}
    assert roots[0].attrs["k"] == 25
    assert roots[-1].children[0].name == "tock"


def test_export_chrome_has_a_host_and_a_device_track(tmp_path):
    _solve()
    path = profiling.export_chrome(str(tmp_path / "spans.json"), profiling.roots()[-1:])
    events = json.load(open(path))["traceEvents"]
    host = {e["name"] for e in events if e.get("tid") == 1 and e["ph"] == "X"}
    device = [e for e in events if e.get("tid") == 2 and e["ph"] == "X"]
    assert {"solve", *CHILDREN} <= host
    assert [e["name"] for e in device] == ["lm_ndchol_fused_chordal"]
    run = next(e for e in events if e["name"] == "solve.run")
    assert run["ts"] <= device[0]["ts"] and device[0]["dur"] <= run["dur"]


def test_summary_totals_spans_and_phases():
    _fg, res, root = _solve()
    s = profiling.summary([root])
    assert s["spans"]["solve"]["count"] == 1
    assert s["device"]["lm.cg"]["calls"] == res["stats"].iterations
    assert s["program_device_ms"] == root.attrs["program_device_ns"] / 1e6
    assert s["spans"]["solve.run"]["total_ms"] >= s["program_device_ms"]


def test_disabled_recording_stamps_no_program():
    profiling.enable(False)
    n = torch.zeros((), dtype=torch.int64)

    def phase(run):
        with run.span("p"):
            n.add_(1)

    prog = device_loop.Program("cpu", [(phase, 3)])
    with profiling.annotate("off"):
        prog.run()
        assert prog.read([n]).tolist() == [3.0]
    profiling.enable(True)
    with profiling.annotate("on") as span:
        prog.run()
        assert prog.read([n]).tolist() == [6.0]
    assert span.attrs["calls"] == {"p": 3}
    assert device_loop.EAGER.span("p").__enter__() is None


def test_no_collection_inside_a_capture():
    import gc

    assert gc.isenabled()
    with device_loop._no_collection():
        assert not gc.isenabled()
    assert gc.isenabled()
    gc.disable()
    try:
        with device_loop._no_collection():
            pass
        assert not gc.isenabled()
    finally:
        gc.enable()


@pytest.mark.cuda
def test_captured_program_stamps_its_phases_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the stamps of a captured program run only on the card")
    from rome_tpu_torch.graph.lower import lower
    from rome_tpu_torch.solvers.linearize import runtime_state

    ga = lower(_graph(18), device="cuda")
    out = {}
    for on in (False, True):
        profiling.enable(on)
        solver = GN.ParametricSolver(ga, T.GNOptions(**FUSED))
        with profiling.annotate("case") as span:
            values, st = solver.solve(None, runtime_state(ga))
        assert solver.last_program.program.captured
        out[on] = (values["Pose2"].cpu(), st)
    profiling.enable(True)
    (v_off, s_off), (v_on, s_on) = out[False], out[True]
    assert torch.equal(v_off, v_on) and s_off.final_cost == s_on.final_cost
    assert s_off.iterations == s_on.iterations
    calls, ns = span.attrs["calls"], span.attrs["device_ns"]
    assert all(calls[p] == s_on.iterations for p in ITERATION), calls
    assert calls["lm.chordal"] == calls["lm.start_linearize"] == 1
    assert 0 < sum(ns.values()) <= span.attrs["program_device_ns"]
    assert profiling.spans("program.capture", [profiling.roots()[-1]])
    (_name, begin, end, clock), = span.attrs["device_spans"]
    assert clock == "cuda" and end - begin == span.attrs["program_device_ns"]
