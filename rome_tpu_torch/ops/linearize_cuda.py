"""Pose2Pose2 linearize: wrapper of the hand-written CUDA kernel K1.

The kernel (``csrc/pose2pose2_linearize.cu``, sm_90a, float and double
instances) is the port of the JAX package's Pallas kernel
``rome_tpu/ops/linearize_pallas.py:_kernel``. It is compiled with ``nvcc`` at
first use (``ops/nvcc_build.py``), loaded with ``ctypes`` and launched on
PyTorch's current stream.

Dispatch is by the device of the tensors it is given: a CUDA tensor always
goes to the kernel (a missing ``nvcc``, a failed build or a refused launch
raises; there is no fallback), a CPU tensor takes the plain version
``ops/fused_linearize.pose2pose2_linearize_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from rome_tpu_torch.ops import nvcc_build
from rome_tpu_torch.ops.fused_linearize import pose2pose2_linearize_plain

SOURCE = "pose2pose2_linearize.cu"
_FUNCTIONS = {
    name: [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_void_p]
    for name in ("rome_pose2pose2_linearize_f32", "rome_pose2pose2_linearize_f64")
}

# Kernel launches made by this wrapper (reset by callers that count them).
LAUNCHES = 0

_lib = None


def build():
    """Compile the kernel library if needed; returns its path."""
    return nvcc_build.build(SOURCE)


def _library():
    global _lib
    if _lib is None:
        _lib = nvcc_build.load(build(), _FUNCTIONS)  # build raises if it cannot
    return _lib


def _check(p, q, z, S, w):
    ts = (p, q, z, S, w)
    if not all(isinstance(t, torch.Tensor) for t in ts):
        raise TypeError("pose2pose2_linearize takes tensors")
    dev, dt = p.device, p.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"pose2pose2_linearize takes float32 or float64, got {dt}")
    if any(t.device != dev for t in ts) or any(t.dtype != dt for t in ts):
        raise ValueError("pose2pose2_linearize inputs must share one device and dtype")
    n = p.shape[0]
    shapes = ((n, 3), (n, 3), (n, 3), (n, 3, 3), (n,))
    for name, t, shp in zip(("p", "q", "z", "S", "w"), ts, shapes):
        if tuple(t.shape) != shp:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shp}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if 9 * n >= 2**31:
        raise ValueError(f"batch of {n} factors exceeds the kernel's int32 indexing")


def pose2pose2_linearize(p, q, z, S, w):
    """Weighted whitened (r0 (n,3), (J1, J2) (n,3,3)) of a Pose2Pose2 batch.

    p, q, z: (n, 3) poses and measurements; S: (n, 3, 3) sqrt-information;
    w: (n,) weights. On CUDA tensors this launches the hand kernel; on CPU
    tensors it computes the plain version.
    """
    global LAUNCHES
    _check(p, q, z, S, w)
    if p.device.type == "cpu":
        return pose2pose2_linearize_plain(p, q, z, S, w)
    if p.device.type != "cuda":
        raise ValueError(f"pose2pose2_linearize has no path for device {p.device}")
    lib = _library()  # builds on first use; raises if it cannot
    n = p.shape[0]
    r = torch.empty((n, 3), dtype=p.dtype, device=p.device)
    J1 = torch.empty((n, 3, 3), dtype=p.dtype, device=p.device)
    J2 = torch.empty((n, 3, 3), dtype=p.dtype, device=p.device)
    if n == 0:
        return r, (J1, J2)
    fn = (
        lib.rome_pose2pose2_linearize_f32 if p.dtype == torch.float32
        else lib.rome_pose2pose2_linearize_f64
    )
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = fn(
            p.data_ptr(), q.data_ptr(), z.data_ptr(), S.data_ptr(), w.data_ptr(),
            r.data_ptr(), J1.data_ptr(), J2.data_ptr(), n, stream,
        )
    if err != 0:
        raise RuntimeError(f"Pose2Pose2 linearize kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return r, (J1, J2)


# factor-type name -> fused linearize (p, q, z, S, w) -> (r0, (J1, J2)),
# weight applied
FUSED_LINEARIZE = {
    "Pose2Pose2": pose2pose2_linearize,
    "MutablePose2Pose2Gaussian": pose2pose2_linearize,
}
