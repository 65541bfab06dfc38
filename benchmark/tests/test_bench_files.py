"""A cell, a configuration, a driver and a per-layer metric are added as new
files and new entries in BENCHMARK.json; no file that exists changes."""

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import control, harness, judge  # noqa: E402
from benchmark.manifest import Manifest  # noqa: E402


def _copy(dst):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst / "BENCHMARK.json")
    for sub in ("configs", "traffic", "metrics", "drivers", "controls"):
        shutil.copytree(os.path.join(ROOT, "benchmark", sub), dst / "benchmark" / sub)


def _snapshot(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def _small_config(root, doc):
    """A 300-pose citygrid configuration as a new file and entry."""
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs" / "citygrid10k.json").read_text())
    cfg["name"] = "citygrid_small"
    cfg["world"]["n_poses"] = 300
    (bench / "configs" / "citygrid_small.json").write_text(json.dumps(cfg))
    doc["configs"].append({"name": "citygrid_small", "source": "a test",
                           "file": "benchmark/configs/citygrid_small.json",
                           "reduced": ["n_poses"], "why": "a test"})


def _changed(before, after):
    return {k for k in set(before) | set(after) if before.get(k) != after.get(k)}


def test_cell_config_and_metric_added_as_files(tmp_path):
    _copy(tmp_path)
    before = _snapshot(tmp_path)
    bench = tmp_path / "benchmark"
    doc = json.loads((tmp_path / "BENCHMARK.json").read_text())
    _small_config(tmp_path, doc)
    (bench / "traffic" / "resolve_pair.json").write_text(json.dumps(
        {"driver": "resolve", "why": "two maps", "pool": 2, "bank": 0, "trace_requests": 1}))
    (bench / "metrics" / "requests.batch.py").write_text(
        "def read(run):\n    return len(run.requests) or None\n")
    cell = "citygrid_small.resolve_pair"
    doc["workloads"].append({"name": cell, "config": "citygrid_small",
                             "traffic": "resolve_pair", "chips": 1, "why": "a test"})
    for m in doc["end_to_end"]:
        if m["name"] == "poses_per_s":
            m["workloads"].append(cell)
    doc["per_layer"].append({"name": "requests.batch", "unit": "count", "better": "higher",
                             "source": "host_clock", "layer": "parametric API",
                             "moves": "poses_per_s", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))

    assert Manifest(str(tmp_path)).problems() == []
    result, _r = harness.run_cell(cell, 5, 1.0, False, device="cpu", root=str(tmp_path))
    assert result["correct"]
    assert {"poses_per_s", "setup_s"} <= set(result["metrics"])
    result, _r = harness.run_cell(cell, 5, 1.0, True, device="cpu", root=str(tmp_path))
    assert result["metrics"]["requests.batch"]["value"] >= 1
    added = {"benchmark/configs/citygrid_small.json", "benchmark/traffic/resolve_pair.json",
             "benchmark/metrics/requests.batch.py"}
    assert _changed(before, _snapshot(tmp_path)) == {"BENCHMARK.json"} | added


DRIVER = '''"""Driver single: one graph, its noise drawn from (seed, 0), re-solved
from its dead-reckoned values in every request."""

import numpy as np

from benchmark import entry, graphs as Gr, judge as J, world as W


class Driver(entry.Driver):
    def setup(self):
        self.world = w = W.structure(**self.config["world"])
        self.z = W.measurements(w, W.noise_seed(self.seed, 0))
        self.fg = Gr.build(w, self.z, w.n, W.dead_reckon(w, self.z), self.dtype)
        self.initial = Gr.points(self.fg, 0, w.n)
        self.answers = []
        self.request(timed=False)
        self.answers = []

    def request(self, timed=True):
        n = self.world.n
        for k, p in enumerate(self.initial):
            self.fg.variables[f"x{k}"].points["parametric"] = p
        rec = self.solve(self.fg, self.config["solver"], {"poses": n}, timed=timed)
        rec["k1_bytes"] = {"normal": 1}
        self.answers.append(np.stack(Gr.points(self.fg, 0, n)))
        return rec

    def judge(self, gates):
        notes = {}
        return J.batch_readings(self.world, self.z, self.world.n, self.answers, gates,
                                notes=notes), notes
'''

CONTROL = '''"""The control of driver single."""

from benchmark import judge as J, reference as R, world as W


def readings(config, traffic, seed, max_iters):
    w = W.structure(**config["world"])
    z = W.measurements(w, W.noise_seed(seed, 0))
    edges, _packed, _prior = J.batch_problem(w, z, w.n)
    x = R.solve_batch(edges, w.n, w.prior_sigmas, round_to=R.bf16, max_iters=max_iters)[0]
    return J.batch_readings(w, z, w.n, [x], config["gates"])
'''


def test_driver_added_as_files(tmp_path):
    """A driver and its control as two new files, a traffic file naming it,
    and a metric variant read by its quantity's reader (no file)."""
    _copy(tmp_path)
    before = _snapshot(tmp_path)
    bench = tmp_path / "benchmark"
    doc = json.loads((tmp_path / "BENCHMARK.json").read_text())
    _small_config(tmp_path, doc)
    (bench / "drivers" / "single.py").write_text(DRIVER)
    (bench / "controls" / "single.py").write_text(CONTROL)
    (bench / "traffic" / "single.json").write_text(json.dumps(
        {"driver": "single", "why": "one map", "trace_requests": 1}))
    cell = "citygrid_small.single"
    doc["workloads"].append({"name": cell, "config": "citygrid_small", "traffic": "single",
                             "chips": 1, "why": "a test"})
    for m in doc["end_to_end"]:
        if m["name"] == "poses_per_s":
            m["workloads"].append(cell)
    doc["per_layer"].append({"name": "lm_iters.single", "unit": "count", "better": "lower",
                             "source": "program_counter", "layer": "LM loops",
                             "moves": "poses_per_s", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))

    man = Manifest(str(tmp_path))
    assert man.problems() == []
    assert man.reader_file("lm_iters.single") == "lm_iters"
    result, _r = harness.run_cell(cell, 2**31 + 5, 1.0, True, device="cpu", root=str(tmp_path))
    assert result["correct"], result["checks"]
    assert result["metrics"]["lm_iters.single"]["value"] >= 1
    readings = control.control_readings(cell, 2**31 + 5, root=str(tmp_path))
    assert not judge.correct(readings)
    added = {f"benchmark/{d}/single.{e}" for d, e in
             (("drivers", "py"), ("controls", "py"), ("traffic", "json"))}
    added.add("benchmark/configs/citygrid_small.json")
    assert _changed(before, _snapshot(tmp_path)) == {"BENCHMARK.json"} | added


def test_command_fails_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's files
    the command exits non-zero and prints no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "citygrid10k.resolve", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
