"""The port stands alone: rome_tpu_torch imports neither jax nor rome_tpu,
and chip_smoke.py refuses to run (exit code != 0, no result line) on a
machine without a CUDA device or outside the repository — there is no CPU
fallback for the GPU smoke run."""

import os
import pkgutil
import shutil
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
PKG = os.path.join(REPO, "rome_tpu_torch")
MEASURING_SCRIPTS = [os.path.join(REPO, "bench_torch.py")] + sorted(
    os.path.join(REPO, "tools", "torch", f) for f in os.listdir(os.path.join(REPO, "tools", "torch"))
    if f.endswith(".py"))


def _run(code, cwd=REPO, timeout=240):
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-c", code], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=timeout,
    )


def _submodules():
    import rome_tpu_torch

    return sorted(
        m.name for m in pkgutil.walk_packages(rome_tpu_torch.__path__, "rome_tpu_torch.")
    )


def test_port_modules_mirror_the_slice():
    mods = set(_submodules())
    for m in [
        "utils.math", "manifolds.base", "distributions", "variables",
        "factors.base", "factors.pose2", "graph.graph", "io.g2o", "graph.lower",
        "graph.convert", "ops.fused_linearize", "ops.linearize_cuda",
        "solvers.linearize", "solvers.sparse.symbolic", "solvers.sparse.ndchol",
        "solvers.init2d", "solvers.gauss_newton", "solvers.parametric",
        "ops.nvcc_build", "ops.pairwise", "ops.pairwise_cuda",
        "factors.bearing_range", "canonical.generators", "canonical.patterns",
        "solvers.multimodal.kde", "solvers.multimodal.convolve",
        "solvers.multimodal.batched", "solvers.multimodal.solve",
        "solvers.multimodal.metrics", "solvers.multimodal.tree", "factors.point2",
        "manifolds.quat", "factors.point3", "factors.pose3", "factors.polar",
        "factors.dyn2d", "factors.sensors", "manifolds.sgal3", "canonical.inertial_sim",
        "factors.inertial", "factors.legacy_inertial", "factors.ode", "factors.fluxmix",
        "frontend.robot_utils", "frontend.odometry", "frontend.slam", "frontend.tracker",
        "frontend.navigation", "io.serialization", "io.blobstore", "services.scalar_fields",
        "parallel", "parallel.distributed", "parallel.sharding", "parallel.varpart",
        "parallel.multimodal", "graft_entry",
        "vision", "vision.camera", "services.analysis", "services.plotting", "interop",
        "interop.tcp_server", "utils.profiling", "ops.segment_sum",
    ]:
        assert "rome_tpu_torch." + m in mods, m
    for src in ("pose2pose2_linearize.cu", "pairwise_logw.cu"):
        assert os.path.exists(os.path.join(PKG, "csrc", src)), src


def test_port_exports_every_jax_factor_name():
    """Every name the JAX package's factor library exports, the port's
    exports too (the JAX side read from its source, not imported)."""
    import ast

    import rome_tpu_torch
    import rome_tpu_torch.factors as TF

    src = open(os.path.join(REPO, "rome_tpu", "factors", "__init__.py")).read()
    names = next(ast.literal_eval(n.value) for n in ast.parse(src).body
                 if isinstance(n, ast.Assign) and n.targets[0].id == "__all__")
    assert len(names) == 63
    missing = [n for n in names if n not in TF.__all__ or not hasattr(rome_tpu_torch, n)]
    assert not missing, missing


def test_every_submodule_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['rome_tpu'] = None\n"
        "import rome_tpu_torch\n"
        "for m in pkgutil.walk_packages(rome_tpu_torch.__path__, 'rome_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k, v in sys.modules.items() if v is not None and "
        "(k == 'jax' or k.startswith(('jax.', 'jaxlib', 'rome_tpu.')))]\n"
        "assert not bad, bad\n"
        "print('ok', len([k for k in sys.modules if k.startswith('rome_tpu_torch')]))\n"
    )
    p = _run(code)
    assert p.returncode == 0, p.stderr
    assert p.stdout.startswith("ok")


def test_port_sources_name_no_jax_import():
    """No import line of the package, chip_smoke.py or the measuring scripts
    (bench_torch.py, tools/torch/) names jax or the JAX package, and none
    imports by a name built at run time (importlib, __import__), which such a
    search cannot see."""
    paths = [os.path.join(REPO, "chip_smoke.py")] + MEASURING_SCRIPTS
    for root, _dirs, files in os.walk(PKG):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    offenders = []
    for path in paths:
        for ln in open(path):
            s = ln.strip()
            if s.startswith(("import jax", "from jax", "import rome_tpu.",
                             "from rome_tpu.", "from rome_tpu import")):
                offenders.append((path, s))
            if s == "import rome_tpu" or "importlib" in s or "__import__" in s:
                offenders.append((path, s))
    assert not offenders


def test_measuring_scripts_import_without_jax():
    """bench_torch.py and tools/torch/*.py, and chip_smoke.py which imports
    them, load with jax and the JAX package blocked."""
    assert len(MEASURING_SCRIPTS) == 4
    code = (
        "import sys, runpy\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['rome_tpu'] = None\n"
        f"sys.path.insert(0, {REPO!r})\n"
        f"for path in {MEASURING_SCRIPTS + [os.path.join(REPO, 'chip_smoke.py')]!r}:\n"
        "    runpy.run_path(path, run_name='not_main')\n"
        "bad = [k for k, v in sys.modules.items() if v is not None and "
        "(k == 'jax' or k.startswith(('jax.', 'jaxlib', 'rome_tpu.')))]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    p = _run(code)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "ok"


def test_chip_smoke_fails_without_cuda():
    p = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=240,
    )
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=240,
    )
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout


def test_cuda_tensor_never_takes_the_plain_path(monkeypatch):
    """The wrapper's dispatch: a CUDA tensor goes to the kernel library, and
    a build failure raises instead of falling back."""
    import torch

    from rome_tpu_torch.ops import linearize_cuda as K

    def no_build():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(K, "_lib", None)
    monkeypatch.setattr(K, "build", no_build)
    args = [torch.zeros(4, 3, device="meta")] * 3 + [
        torch.zeros(4, 3, 3, device="meta"), torch.zeros(4, device="meta")]
    with pytest.raises(ValueError, match="no path for device meta"):
        K.pose2pose2_linearize(*args)
    # a CUDA-typed tensor reaches the build step (and its failure propagates)
    monkeypatch.setattr(K, "_check", lambda *a: None)

    class FakeCuda:
        device = torch.device("cuda", 0)
        dtype = torch.float32
        shape = (4, 3)

    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.pose2pose2_linearize(*([FakeCuda()] * 5))


def test_profile_script_fails_without_cuda():
    p = subprocess.run(
        [sys.executable, os.path.join(REPO, "profile_torch.py"), "--solves", "1"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=240,
    )
    assert p.returncode != 0
    assert "no CUDA device" in p.stderr


def test_profile_busy_share_takes_the_union_of_kernel_intervals():
    sys.path.insert(0, REPO)
    import profile_torch

    class Kernel:
        def __init__(self, start, end):
            self.time_range = type("Range", (), {"start": start, "end": end})()

    spans = [Kernel(0, 10), Kernel(5, 12), Kernel(20, 30)]
    # summed 27 us, busy 22 us (0-12 and 20-30), span 30 us
    assert profile_torch.busy_share(spans) == (27, 22, 30)
