"""Build and load the port's hand-written CUDA kernel libraries.

Each library is one ``csrc/*.cu`` source with a plain C interface, compiled
by ``nvcc`` for ``sm_90a`` into ``build/rome_tpu_torch/`` beside the package
at first use and loaded with ``ctypes``. The file name carries a hash of the
source, the nvcc flags and ``nvcc --version``, so a changed source, flag or
compiler builds anew instead of loading a stale library.

Nothing here runs when a module is imported: a CPU-only machine without
``nvcc`` imports every kernel module, and only a CUDA tensor reaches a build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rome_tpu_torch"
# accurate sinf/cosf and IEEE division: no --use_fast_math
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# source name -> ptxas report of the build made in this process
BUILD_LOGS: dict = {}


def find_nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless it has already been built with these
    flags by this nvcc; returns the path of the shared library."""
    src = CSRC / source
    nvcc = find_nvcc()
    version = subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True, check=True
    ).stdout
    h = hashlib.sha256(src.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    h.update(version.encode())
    out = BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)], capture_output=True, text=True
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {src.name}:\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    BUILD_LOGS[source] = proc.stderr.strip()
    return out


def load(path: Path, functions: dict) -> ctypes.CDLL:
    """Load a built library; ``functions`` maps each exported C function to
    its ``argtypes``. Every function returns a cudaError_t."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in functions.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
