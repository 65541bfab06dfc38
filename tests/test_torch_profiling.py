"""The port's utils/profiling: tests/test_services.py's profiling case on the
port, PhaseTimer's rows and report against the JAX package's on the same
phase sequence, and the trace file naming the annotated regions."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rome_tpu.utils import profiling as JP  # noqa: E402
from rome_tpu_torch.utils.profiling import PhaseTimer, annotate, trace  # noqa: E402


def _phases(pt):
    for name in ("linearize", "linearize", "solve"):
        with pt.phase(name):
            pass
    return pt


def test_phase_timer_rows_and_report_match_jax():
    got, want = _phases(PhaseTimer()).rows(), _phases(JP.PhaseTimer()).rows()
    assert [(r["phase"], r["calls"]) for r in got] == [(r["phase"], r["calls"]) for r in want]
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    pt = _phases(PhaseTimer())
    assert pt.rows()[0]["calls"] == 2
    assert "linearize," in pt.report() and len(pt.report().splitlines()) == 2


def test_trace_names_the_annotations(tmp_path):
    from rome_tpu_torch.solvers.sparse import ndchol as N

    logdir = str(tmp_path / "tr")
    with trace(logdir) as d:
        assert d == logdir
        with annotate("square"):
            x = torch.ones((8, 8))
            x @ x
        with annotate("linear_solve"):
            A = torch.eye(4, dtype=torch.float64)[None] * 2.0
            N._chol_or_nan(A)
    path = os.path.join(logdir, "trace.json")
    assert os.path.getsize(path) > 0
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert {"square", "linear_solve"} <= names


def test_phase_timer_on_the_host_clock_accumulates():
    pt = PhaseTimer(device="cpu")
    with pt.phase("work"):
        np.linalg.qr(np.ones((64, 64)))
    with pt.phase("work"):
        pass
    (row,) = pt.rows()
    assert row["calls"] == 2 and row["total_s"] >= 0.0


@pytest.mark.cuda
def test_phase_timer_times_the_card(cuda_device):
    pt = PhaseTimer(device=cuda_device)
    x = torch.ones((2048, 2048), device=cuda_device)
    with pt.phase("matmul"):
        for _ in range(10):
            x = x @ x / 2048
    (row,) = pt.rows()
    assert row["calls"] == 1 and row["total_s"] > 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"
