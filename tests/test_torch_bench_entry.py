"""The port's measuring entry points (bench_torch.py, tools/torch/) held to
the JAX scripts they port, on the CPU at small sizes.

- ``bench_torch.solve_dataset`` against bench.py's ``_solve_dataset`` (JAX
  under x64, as bench.py runs): the synthesized octagon
  (tests/test_g2o.py:17-29) with the ``small`` options in float64, final
  costs within 1e-6 relative (1e-9 absolute at its zero-residual optimum);
  a 200-pose city grid (tools/gen_citygrid.py) with ``big``, costs within
  1e-3 relative (ROADMAP.md's parametric tolerance). Both against a ground
  truth from tools/cpu_reference.py's float64 solver, with the same
  ``n_poses``, ``n_factors``, ``converged`` and ``matched_ate``.
- ``incremental_bench.run_incremental`` against the JAX script's (in a
  subprocess: importing it switches on x64, compile logging and a compile
  cache for its whole process) on the first 300 instructions of citygrid's
  time-ordered stream, fixed-lag on, in float64 (both packages' graphs set
  to it: in float32 the stop tests fire at noise, tests/test_torch_fixedlag.py),
  each pose started by ``add_instruction`` on both sides (the JAX script's
  ``parse_g2o_instruction`` wrapped by it): the same rows, reasons, frozen
  drift 0.0 in both, final costs within 1e-6 relative (plus the JAX rows'
  rounding to 6 decimals).
- ``bench_kernels``' rows on the plain versions: the JAX rows' fields, and
  bytes per evaluation equal to the tensors' own sizes.
- No fallback: each script exits non-zero with no result line when CUDA is
  hidden and ``--device cpu`` is not given.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
sys.path.insert(0, REPO)

import bench  # noqa: E402
import bench_torch as BT  # noqa: E402
from tools.cpu_reference import chordal_init, parse_g2o_se2, solve_lm  # noqa: E402
from tools.gen_citygrid import generate  # noqa: E402
from tools.torch import bench_kernels as BK  # noqa: E402
from tools.torch import incremental_bench as IB  # noqa: E402

SCRIPTS = ("bench_torch.py", "tools/torch/bench_multimodal.py",
           "tools/torch/incremental_bench.py", "tools/torch/bench_kernels.py")


def _octagon(tmp_path):
    """tests/test_g2o.py:17-29's 8-pose ring."""
    info = (100.0, 0.0, 0.0, 400.0, 0.0, 1000.0)
    lines = [f"EDGE_SE2 {i} {(i + 1) % 8} 1.0 0.0 0.7853981633974483 "
             + " ".join(str(v) for v in info) for i in range(8)]
    path = tmp_path / "octagon.g2o"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _grid(tmp_path, n=200):
    """A city grid of ``n`` poses written as tools/gen_citygrid.py writes it."""
    poses, edges, _ = generate(n)
    path = tmp_path / f"citygrid_{n}.g2o"
    with open(path, "w") as fh:
        for i, p in enumerate(poses):
            fh.write(f"VERTEX_SE2 {i} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        for a, b, z, it, ir in edges:
            fh.write(f"EDGE_SE2 {a} {b} {z[0]:.6f} {z[1]:.6f} {z[2]:.6f} "
                     f"{it:.6f} 0 0 {it:.6f} 0 {ir:.6f}\n")
    return str(path)


def _ground_truth(path):
    """tools/cpu_reference.py's float64 optimum of ``path`` as its main saves it."""
    edges, n = parse_g2o_se2(path)
    t0 = time.time()
    x, cost, iters, _conv = solve_lm(chordal_init(edges, n), edges, np.diag([10.0, 10.0, 20.0]))
    gt = path[:-4] + "_gt.npz"
    np.savez(gt, poses=x, final_cost=cost, solve_time_s=time.time() - t0, iters=iters)
    return gt


def _in_float64(monkeypatch, module, name):
    real = getattr(module, name)

    def build(*args):
        fg = real(*args)
        fg.params.dtype = "float64"
        return fg

    monkeypatch.setattr(module, name, build)


@pytest.mark.parametrize("case", ["octagon_small_f64", "grid200_big"])
def test_solve_dataset_matches_bench_py(case, tmp_path, monkeypatch):
    if case == "octagon_small_f64":
        path, opts, rtol, atol = _octagon(tmp_path), "small", 1e-6, 1e-9
        _in_float64(monkeypatch, bench, "_build_graph")
        _in_float64(monkeypatch, BT, "build_graph")
    else:
        path, opts, rtol, atol = _grid(tmp_path), "big", 1e-3, 0.0
    gt = _ground_truth(path)
    with jax.enable_x64():
        want = bench._solve_dataset(path, gt, bench._opts()[opts], warm=False)
    got = BT.solve_dataset(path, gt, BT.BIG if opts == "big" else BT.SMALL, device="cpu")
    for key in ("n_poses", "n_factors", "converged", "matched_ate"):
        assert got[key] == want[key], (key, got[key], want[key])
    assert want["matched_ate"]
    assert abs(got["final_cost"] - want["final_cost"]) <= atol + rtol * abs(want["final_cost"])
    # one cold and three warm runs, every run's LM iterations recorded and
    # equal (one answer per input)
    assert len(got["warm_runs_s"]) == 3 and min(got["warm_runs_s"]) == got["solve_time_s"]
    assert len(set(got["iterations_by_run"])) == 1
    assert set(want) - {"baseline_cpu_solve_s", "baseline_cpu_poses_per_sec"} <= set(got)


def test_reference_rows_are_absent_without_their_files(tmp_path):
    names = [name for name, *_ in BT.datasets()]
    assert names == ["manhattan3500", "mit", "octagon", "citygrid_10k"]
    ref = BT.reference_paths()
    assert ref == {"MANHATTAN": bench.MANHATTAN, "MIT": bench.MIT, "OCTAGON": bench.OCTAGON}


def _uniform_stream(instructions):
    """The stream's pose groups after x0's (a VERTEX line and the lines up
    to the next one), each led by copies of its VERTEX line up to the
    longest group's length L, truncated to a multiple of 10 groups: the JAX
    script's stride counts instructions, and 10 L of them then end at the
    same poses as the port's stride of 10 poses."""
    assert instructions[0] == ["VERTEX_SE2", "0", "0.000000", "0.000000", "0.000000"]
    groups = []
    for ins in instructions[1:]:
        if ins[0] == "VERTEX_SE2":
            groups.append([])
        groups[-1].append(ins)
    groups = groups[: len(groups) - (1 if instructions[-1][0] == "VERTEX_SE2" else 0)]
    groups = groups[: len(groups) // 10 * 10]
    L = max(len(g) for g in groups)
    return [ins for g in groups for ins in [g[0]] * (L - len(g)) + g], L


def test_run_incremental_matches_the_jax_script(tmp_path, monkeypatch):
    stream, L = _uniform_stream(IB.stream_instructions(200)[:300])
    assert L >= 2 and len(stream) % (10 * L) == 0
    path = tmp_path / "stream.json"
    path.write_text(json.dumps(stream))
    code = (f"import json, sys\nsys.path.insert(0, {REPO!r})\n"
            "import jax\njax.config.update('jax_platforms', 'cpu')\n"
            "import rome_tpu.io.g2o as G\n"
            "from tools.torch.incremental_bench import add_instruction\n"
            "parse = G.parse_g2o_instruction\n"
            "G.parse_g2o_instruction = lambda fg, ins, initialize=True: "
            "add_instruction(fg, ins, parse)\n"
            "import tools.incremental_bench as J\n"
            "mk = J._mk_fg\n"
            "def f64():\n    fg = mk()\n    fg.params.dtype = 'float64'\n    return fg\n"
            "J._mk_fg = f64\n"
            f"ins = json.load(open({str(path)!r}))\n"
            f"fg, rows, drift = J.run_incremental(ins, stride={10 * L}, fixedlag=True, "
            "verbose_rows=False)\n"
            "print(json.dumps(dict(rows=rows, drift=drift)))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", ROME_TPU_COMPILE_CACHE=str(tmp_path / "xla"))
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    want = json.loads(p.stdout.strip().splitlines()[-1])
    _in_float64(monkeypatch, IB, "_mk_fg")
    _fg, rows, drift = IB.run_incremental(stream, stride=10, fixedlag=True, device="cpu")
    assert len(rows) == len(want["rows"]) == len(stream) // (10 * L)
    assert drift == 0.0 and want["drift"] == 0.0
    for got, ref in zip(rows, want["rows"]):
        assert got["n_vars"] == ref["n_vars"]
        assert got["reason"] == ref["reason"], (got, ref)
        assert got["frozen_drift"] == 0.0 and ref["frozen_drift"] == 0.0
        # the JAX rows round final_cost to 6 decimals (tools/incremental_bench.py:104)
        assert abs(got["final_cost"] - ref["final_cost"]) <= 1e-6 * abs(ref["final_cost"]) + 5e-7, (
            got, ref)
    assert set(IB._summary(rows)) >= {"steps", "recycle_rate", "steady_step_latency_s",
                                      "unconverged_steps", "unconverged_reasons"}


def test_incremental_main_on_the_cpu(tmp_path):
    out = tmp_path / "ib.json"
    assert IB.main(["--device", "cpu", "--poses", "61", "--incremental", "41",
                    "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    fl = doc["fixedlag_full"]
    assert fl["steps"] == 6 and fl["max_frozen_drift"] == 0.0 and fl["bit_stable"]
    assert all(r["new_solvers"] in (0, 1) for r in doc["fixedlag_rows"])
    assert doc["fixedlag_rows"][0]["new_solvers"] == 1
    assert np.isfinite(fl["end_state_ate_vs_batch_gt_m"])
    assert doc["incremental"]["steps"] == 4 and doc["device"] == "cpu"


def test_write_stream_g2o_orders_each_pose_before_its_edges(tmp_path):
    path = str(tmp_path / "stream.g2o")
    n = IB.write_stream_g2o(path, 120)
    seen = set()
    with open(path) as fh:
        lines = [ln.split() for ln in fh]
    assert len(lines) == n
    for t in lines:
        if t[0] == "VERTEX_SE2":
            seen.add(int(t[1]))
        else:
            assert max(int(t[1]), int(t[2])) in seen and int(t[1]) in seen
    assert seen == set(range(120))


def test_solve_chunks_end_every_stride_poses():
    """A solve after x10, x20, ... and after the last pose: x0 is in the
    graph before the stream, so 120 poses give 12 solves."""
    chunks = IB.solve_chunks(IB.stream_instructions(120))
    newest = [max(int(t[1]) for t in c if t[0] == "VERTEX_SE2") for c in chunks]
    assert newest == list(range(10, 120, 10)) + [119]
    assert [t for c in chunks for t in c] == IB.stream_instructions(120)
    # every chunk ends with its newest pose's edges: none waits for a later chunk
    for c, k in zip(chunks, newest):
        assert all(max(int(t[1]), int(t[2])) <= k for t in c if t[0] == "EDGE_SE2")


def test_add_instruction_dead_reckons_each_pose():
    """A new pose starts at its predecessor's estimate composed with the
    odometry edge, not at its VERTEX value (citygrid's truth)."""
    fg = IB._mk_fg()
    fg.init_variable("x0", [1.0, 2.0, 0.5])        # an estimate away from the truth
    group = IB.stream_instructions(3)[1:3]          # VERTEX 1, EDGE 0 1
    assert group[0][0] == "VERTEX_SE2" and group[1][:3] == ["EDGE_SE2", "0", "1"]
    for ins in group:
        IB.add_instruction(fg, ins)
    odo = [float(v) for v in group[1][3:6]]
    want = IB.se2_compose(np.array([1.0, 2.0, 0.5]), odo)
    np.testing.assert_allclose(fg.get_coords("x1"), want, rtol=0, atol=1e-12)
    assert np.abs(fg.get_coords("x1")[:2] - [float(v) for v in group[0][2:4]]).max() > 0.5


@pytest.mark.parametrize("variant", ["lin", "normal", "plain"])
def test_kernel_rows_have_the_jax_fields(variant):
    n = 96
    row = BK.bench_variant(variant, n, device="cpu")
    # tools/bench_kernels.py's row fields; on the CPU the device numbers are
    # not measured
    for key in ("n", "us", "evals_per_sec", "gflops_est", "pct_of_hbm_roofline"):
        assert key in row
    assert row["us"] is None and row["host_us_per_call"] > 0
    # the tensors' own sizes: lin p, q, z (n, 3), S (n, 3, 3), w (n,) in,
    # r (n, 3), J1, J2 (n, 3, 3) out, float32; normal the float64 table of
    # n + 1 poses, int64 slots, float32 z, S, w in, float64 r and Jtr,
    # float32 J and 36 entry values a factor out
    if variant == "normal":
        want = 24 * (n + 1) + n * (16 + 12 + 36 + 4 + 24 + 72 + 48 + 144)
    else:
        want = 4 * n * (3 + 3 + 3 + 9 + 1 + 3 + 9 + 9)
    assert row["bytes"] == want and row["bytes_per_eval"] == want / n
    assert row["bound_by"] == "bytes" and row["bound_us"] > 0


def test_kernel_document_on_the_cpu():
    doc = BK.run("cpu", sizes=(32,), verbose=False)
    assert set(doc["variants"]) == {"lin", "normal", "plain"}
    assert doc["rows"] == doc["variants"]["lin"] and doc["device"] == "cpu"
    assert doc["roofline"]["measured_stream_bytes_per_s"] is None


@pytest.mark.parametrize("script", SCRIPTS)
def test_script_refuses_to_fall_back_to_the_cpu(script):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, os.path.join(REPO, script)], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=240)
    assert p.returncode != 0
    assert "no CUDA device" in p.stderr
    assert not p.stdout.strip(), p.stdout[-2000:]
