"""The torch examples (examples/torch/): one beside every JAX example, each
imports without jax, and each runs on the CPU at a small size through its
``main`` (the g2o examples on a 60-pose stream of data/citygrid.g2o, which
chip_smoke.write_stream_g2o writes in time order)."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
JAX_EXAMPLES = os.path.join(REPO, "examples")
TORCH_EXAMPLES = os.path.join(JAX_EXAMPLES, "torch")
NAMES = sorted(f[:-3] for f in os.listdir(JAX_EXAMPLES) if f.endswith(".py"))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", os.path.join(TORCH_EXAMPLES, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    sys.path.insert(0, REPO)
    import chip_smoke

    path = str(tmp_path_factory.mktemp("g2o") / "citygrid_60.g2o")
    assert chip_smoke.write_stream_g2o(path, 60) > 60
    return path


def test_every_jax_example_has_a_torch_version():
    assert len(NAMES) == 7
    assert sorted(f[:-3] for f in os.listdir(TORCH_EXAMPLES) if f.endswith(".py")) == NAMES


def test_the_examples_import_without_jax():
    code = ("import sys, importlib.util\n"
            "sys.modules['jax'] = None\nsys.modules['rome_tpu'] = None\n"
            f"for n in {NAMES!r}:\n"
            f"    s = importlib.util.spec_from_file_location(n, {TORCH_EXAMPLES!r} + '/' + n + '.py')\n"
            "    s.loader.exec_module(importlib.util.module_from_spec(s))\n"
            "print('ok')\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=REPO), timeout=240)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "ok"


def test_hexagonal2d_slam():
    res, tree = _load("hexagonal2d_slam").main("cpu", N=30)
    assert res["stats"].converged and tree.num_cliques > 0


def test_tcp_interop():
    replies, pts = _load("tcp_interop").main("cpu")
    assert replies[-1] == "OK BATCHSOLVE converged=True" and pts.shape == (100, 3)


def test_live_slam():
    slam = _load("live_slam").main(12, "cpu")
    assert slam.solve_count >= 1 and not slam.errors


def test_manhattan_batch_and_mit_batch(stream, tmp_path):
    res = _load("manhattan_batch").main(stream, str(tmp_path), "cpu")
    assert res["stats"].converged
    xy = np.loadtxt(tmp_path / "trajectory.csv", delimiter=",")
    assert xy.shape == (60, 2)
    res = _load("mit_batch").main(stream, str(tmp_path), "cpu")
    assert res["stats"].converged and os.path.getsize(tmp_path / "mit_slam2d.png") > 0


def test_manhattan_fixedlag(stream):
    fg = _load("manhattan_fixedlag").main(stream, 120, 25, "cpu")
    assert any(fg.variables[l].solvable == 0 for l in fg.ls(r"^x\d+$"))


def test_manhattan_incremental(stream, tmp_path):
    fg = _load("manhattan_incremental").main(stream, 60, 10, str(tmp_path), "cpu")
    assert os.path.exists(tmp_path / "manhattan_incremental_final.json")
    assert fg.num_variables > 10
