"""The dense32 LM as one device program per step shape
(``solvers/gauss_newton._DenseProgram``), on the 6x6 grid of
tests/test_torch_parametric_solvers.py with a window of free poses, padded
to its shape buckets as a fixed-lag step is:

- run through the eager runner (its CPU form), the program equals
  ``solve_host`` bit for bit: values, history, final cost;
- one kept program serves another connectivity of its shape (the grid's
  reordered twin, the window moved by 10 poses) as a fresh solver's
  ``solve_host`` solves it;
- a fixed-length segment plan (``ops/segment_sum.FixedSegmentPlan``) sums
  bit-equal to the plan it holds, with and without repeated destinations,
  and after loading another plan;
- an unpadded graph, or one whose D x D buffers pass the kept programs'
  memory budget, has no program and counts no lookup: ``solve_host`` solves;
- on the card (``cuda`` marker, skipped here) the captured replay equals the
  program's eager run and ``solve_host``, a second connectivity of the
  shape replays the same capture, and an unpadded graph solves eagerly.

The file imports no jax: ``pytest --noconftest`` runs it on the card."""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import rome_tpu_torch as T  # noqa: E402
from rome_tpu_torch.graph.lower import lower  # noqa: E402
from rome_tpu_torch.ops.segment_sum import FixedSegmentPlan, SegmentPlan  # noqa: E402
from rome_tpu_torch.solvers import gauss_newton as GN  # noqa: E402
from rome_tpu_torch.solvers.gauss_newton import ParametricSolver  # noqa: E402
from rome_tpu_torch.solvers.linearize import runtime_state  # noqa: E402
from rome_tpu_torch.utils import profiling  # noqa: E402
from torch_graphs import grid_graph, reordered_graph  # noqa: E402

# tests/test_torch_slice.py's NDCHOL_OPTS, with dense32
OPTS = dict(max_iters=30, polish_tol=1e-8, polish_iters=40, lam0=1e-6, lam_down=0.1,
            lam_min=1e-12, chol_jitter=1e-7, ftol=1e-12, gtol=1e-10, linear="dense32")
# the free window: 12 poses (36 dims), then the same window 10 poses on
WINDOW, MOVED = range(12, 24), range(22, 34)


def _window_graph(window=WINDOW, seed=3, order=None, dtype=torch.float32, device="cpu",
                  pad=True):
    """The 6x6 grid with every pose outside ``window`` frozen (its variables
    created in ``order`` when given), lowered with padding."""
    frozen = [f"x{i}" for i in range(36) if i not in window]
    fg = grid_graph(T, 6, 6, seed=seed, frozen=frozen)
    if order is not None:
        fg = reordered_graph(T, fg, order)
        for lbl in frozen:
            fg.variables[lbl].solvable = 0
    return lower(fg, dtype=dtype, pad=pad, device=device)


def _bits(x):
    return x.view(torch.int64) if x.dtype == torch.float64 else x.view(torch.int32)


def _same(a, b):
    """Values and stats equal bit for bit."""
    (va, sa), (vb, sb) = a, b
    assert sa.history == sb.history and sa.iterations == sb.iterations
    assert sa.final_cost == sb.final_cost and sa.reason == sb.reason
    assert va.keys() == vb.keys()
    assert all(torch.equal(_bits(va[t]), _bits(vb[t])) for t in va)


@pytest.fixture(autouse=True)
def fresh_stores():
    GN._DENSE_PROGRAMS.clear()
    yield
    GN._DENSE_PROGRAMS.clear()


@pytest.mark.parametrize("dtype,extra,window", [
    (torch.float32, {}, WINDOW), (torch.float64, {}, WINDOW),
    (torch.float32, {"dtol": 0.0025, "dtol_auto": True}, WINDOW),
    (torch.float32, {}, range(36)),
])
def test_the_program_is_solve_host_bit_for_bit(dtype, extra, window):
    """With frozen and pad dims, and with every dim free (solve_host's plan
    over every dim, the program's over its free dims)."""
    ga = _window_graph(window, dtype=dtype, pad=len(window) < 36)
    solver = ParametricSolver(ga, T.GNOptions(**OPTS, **extra))
    rt = solver.plans(runtime_state(ga))
    assert rt["dense"].dim == 3 * len(window)
    assert (rt["dense"].free_idx is None) == (solver.ga.total_dof == 3 * len(window))
    program = GN._DenseProgram(solver, rt)
    got = program.solve(ga.values0, rt, solver._dtol)
    want = solver.solve_host(ga.values0, rt)
    _same(got, want)
    assert got[1].iterations > 1 and all(h["cg"] >= 1 for h in got[1].history)


def test_one_program_serves_every_connectivity_of_its_shape():
    opts = T.GNOptions(**OPTS)
    ga = _window_graph()
    solver = ParametricSolver(ga, opts)
    program = solver._dense_program(solver.plans(runtime_state(ga)))
    twins = [_window_graph(seed=8, order=list(range(35, -1, -1))), _window_graph(MOVED, seed=8)]
    for ga_b in twins:
        assert GN.structure_signature(ga_b) == GN.structure_signature(ga)
        assert ga_b.key != ga.key
        rt_b = solver.plans(runtime_state(ga_b))
        hits = profiling.COUNTERS["dense_program.hit"]
        assert solver._dense_program(rt_b) is program
        assert profiling.COUNTERS["dense_program.hit"] == hits + 1
        got = program.solve(ga_b.values0, rt_b, solver._dtol)
        fresh = ParametricSolver(ga_b, opts)
        _same(got, fresh.solve_host())
        assert got[1].converged
    # the first graph again: nothing of the others stayed in the buffers
    _same(program.solve(ga.values0, solver.plans(), solver._dtol), solver.solve_host())


@pytest.mark.parametrize("repeats", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_a_fixed_plan_sums_as_its_plan_bit_for_bit(repeats, dtype):
    rng = np.random.default_rng(5)
    rows, E = 40, 120 if repeats else 40
    dsts = [rng.integers(0, rows, E) if repeats else rng.permutation(rows) for _ in range(2)]
    plans = [SegmentPlan(d, keys=(rng.integers(0, 3, E),)) for d in dsts]
    assert (plans[0].offsets is not None) == repeats
    vals = torch.as_tensor(rng.normal(size=(E, 3)), dtype=dtype)
    vals[::7] = -0.0
    fixed = FixedSegmentPlan(plans[1], dump=rows)
    for plan in (plans[1], plans[0]):
        want = plan.add_(torch.zeros((rows, 3), dtype=dtype), vals)
        got = fixed.load(plan).add_(torch.zeros((rows + 1, 3), dtype=dtype), vals)
        assert torch.equal(_bits(got[:rows]), _bits(want))
        assert not got[rows].any()
    with pytest.raises(ValueError, match="entries"):
        fixed.load(SegmentPlan(np.arange(E + 1)))


@pytest.mark.parametrize("pad,budget,kept", [
    (True, 8 * 36 * 36, True), (True, 8 * 36 * 36 - 1, False), (False, 64 << 20, False),
])
def test_unpadded_or_over_the_budget_solve_host_solves(monkeypatch, pad, budget, kept):
    """The program only for a padded graph (its shape comes again) whose
    D x D buffers (H and L, 8 D^2 bytes at 36 free dims) fit the budget."""
    monkeypatch.setattr(GN, "_DENSE_PROGRAM_BYTES", budget)
    ga = _window_graph(pad=pad)
    solver = ParametricSolver(ga, T.GNOptions(**OPTS))
    lookups = sum(profiling.COUNTERS[f"dense_program.{c}"] for c in ("hit", "miss"))
    program = solver._dense_program(solver.plans())
    assert (program is not None) == kept and len(GN._DENSE_PROGRAMS) == int(kept)
    after = sum(profiling.COUNTERS[f"dense_program.{c}"] for c in ("hit", "miss"))
    assert after == lookups + int(kept)
    # on the CPU no solve takes the program
    GN._DENSE_PROGRAMS.clear()
    values, stats = solver.solve()
    _same((values, stats), solver.solve_host())
    assert solver.last_program is None and len(GN._DENSE_PROGRAMS) == 0


@pytest.mark.cuda
def test_the_replay_is_the_eager_program_and_a_second_connectivity_replays_it(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the program is captured only on the card")
    ga = _window_graph(device="cuda")
    solver = ParametricSolver(ga, T.GNOptions(**OPTS))
    rt = solver.plans(runtime_state(ga))
    got = solver.solve(None, rt)
    program = solver.last_program
    assert isinstance(program, GN._DenseProgram) and program.program.captured
    _same(got, solver.solve(None, rt, eager=True))
    _same(got, solver.solve_host(None, rt))
    captures = len(profiling.spans("program.capture"))
    hits = profiling.COUNTERS["dense_program.hit"]
    ga_b = _window_graph(MOVED, seed=8, device="cuda")
    rt_b = solver.plans(runtime_state(ga_b))
    got_b = solver.solve(ga_b.values0, rt_b)
    assert solver.last_program is program
    assert profiling.COUNTERS["dense_program.hit"] == hits + 1
    assert len(profiling.spans("program.capture")) == captures
    _same(got_b, ParametricSolver(ga_b, T.GNOptions(**OPTS)).solve_host())
    # unpadded, or over the budget: no program, solve_host on the card
    flat = _window_graph(pad=False, device="cuda")
    eager = ParametricSolver(flat, T.GNOptions(**OPTS))
    _same(eager.solve(), eager.solve_host())
    assert eager.last_program is None
    monkeypatch.setattr(GN, "_DENSE_PROGRAM_BYTES", 8 * 36 * 36 - 1)
    GN._DENSE_PROGRAMS.clear()
    _same(solver.solve(None, rt), solver.solve_host(None, rt))
    assert len(GN._DENSE_PROGRAMS) == 0
