"""Pose2Pose2 linearize: wrappers of the hand-written CUDA kernel K1.

The kernel (``csrc/pose2pose2_linearize.cu``, sm_90a) is the port of the JAX
package's Pallas kernel ``rome_tpu/ops/linearize_pallas.py:_kernel``. One
kernel body, two epilogues:

- ``lin`` (:func:`pose2pose2_linearize`, float and double): the Pallas
  contract, weighted whitened (r0, J1, J2) from gathered (p, q, z, S, w). It
  serves ``batch_linearize`` (the dense solver, the non-mixed solves).
- ``normal`` (:class:`Pose2Pose2Normal`): the ndchol LM path's one launch per
  iteration for a Pose2Pose2 batch. From the float64 pose table and the
  batch's slots it gathers the poses itself and writes the float64 residual,
  the float32 Jacobians, the batch's float32 JᵀJ entry values (into the
  solver's entry vector) and its float64 Jᵀr contributions.

The library is compiled with ``nvcc`` at first use (``ops/nvcc_build.py``),
loaded with ``ctypes`` and launched on PyTorch's current stream, which during
a device program's capture (``utils/device_loop``) is the stream of the
graph node the launch becomes: the ndchol LM program replays the normal
epilogue once per LM iteration with no Python call.

Dispatch is by the device of the tensors given: a CUDA tensor always goes to
the kernel (a missing ``nvcc``, a failed build or a refused launch raises;
there is no fallback), a CPU tensor takes the plain version in
``ops/fused_linearize.py``.
"""

from __future__ import annotations

import ctypes

import torch

from rome_tpu_torch.ops import nvcc_build
from rome_tpu_torch.utils import device_loop
from rome_tpu_torch.ops.fused_linearize import (
    pose2pose2_linearize_plain,
    pose2pose2_normal_plain,
)

SOURCE = "pose2pose2_linearize.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
_FUNCTIONS = {
    "rome_pose2pose2_linearize_f32": [_P] * 8 + [_I, _P],
    "rome_pose2pose2_linearize_f64": [_P] * 8 + [_I, _P],
    "rome_pose2pose2_normal_f32": [_P] * 10 + [_I, _P],
}
# the kernel indexes factors with int32; keep every per-batch element count
# (36 entry values a factor) below 2**31 as well
_MAX_N = (2**31 - 1) // 36

# Kernel launches made by these wrappers, per epilogue, counted on the device
# inside a captured program (reset by callers that count them).
LAUNCHES = {"lin": 0, "normal": 0}

_lib = None


def build():
    """Compile the kernel library if needed; returns its path."""
    return nvcc_build.build(SOURCE)


def _library():
    global _lib
    if _lib is None:
        _lib = nvcc_build.load(build(), _FUNCTIONS)  # build raises if it cannot
    return _lib


def _launch(name, fn, device, *args):
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"Pose2Pose2 {name} kernel launch failed: cudaError {err}")
    # inside a captured device program the launch is a graph node: its
    # count is a device counter beside it, added to LAUNCHES at the
    # program's final read
    device_loop.count(LAUNCHES, name)


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
    if n > _MAX_N:
        raise ValueError(f"batch of {n} factors exceeds the kernel's int32 indexing")


def pose2pose2_linearize(p, q, z, S, w):
    """K1's lin epilogue: weighted whitened (r0 (n,3), (J1, J2) (n,3,3)) of a
    Pose2Pose2 batch.

    p, q, z: (n, 3) poses and measurements; S: (n, 3, 3) sqrt-information;
    w: (n,) weights. On CUDA tensors this launches the hand kernel; on CPU
    tensors it computes the plain version.
    """
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
    _launch("lin", fn, p.device, *(t.data_ptr() for t in (p, q, z, S, w, r, J1, J2)), n)
    return r, (J1, J2)


class Pose2Pose2Normal:
    """K1's normal epilogue bound to one Pose2Pose2 batch.

    Made once per batch and called once per LM iteration with the float64
    pose table ``values`` (count, 3). The batch's inputs are checked here,
    once: ``vslots`` (n, 2) int64 slots into the table, ``z`` (n, 3), ``S``
    (n, 3, 3) and ``w`` (n,) float32, and ``entries``, the (36 n,) float32
    slice of the solver's JᵀJ entry vector that receives the four
    (n, 3, 3) blocks J1ᵀJ1, J1ᵀJ2, J2ᵀJ1, J2ᵀJ2 (at any offset). The other
    outputs (r (n, 3) float64, J1, J2 (n, 3, 3) float32, Jᵀr (2, n, 3)
    float64) live in one allocation that every call overwrites.
    """

    def __init__(self, vslots, z, S, w, count, entries):
        ins = (vslots, z, S, w, entries)
        if not all(isinstance(t, torch.Tensor) for t in ins):
            raise TypeError("Pose2Pose2Normal takes tensors")
        dev = z.device
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"Pose2Pose2Normal has no path for device {dev}")
        if any(t.device != dev for t in ins):
            raise ValueError("Pose2Pose2Normal inputs must share one device")
        if vslots.dtype != torch.int64 or any(
                t.dtype != torch.float32 for t in (z, S, w, entries)):
            raise TypeError("Pose2Pose2Normal takes int64 vslots and float32 z, S, w, entries")
        n = vslots.shape[0]
        shapes = ((n, 2), (n, 3), (n, 3, 3), (n,), (36 * n,))
        for name, t, shp in zip(("vslots", "z", "S", "w", "entries"), ins, shapes):
            if tuple(t.shape) != shp:
                raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shp}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if n > _MAX_N:
            raise ValueError(f"batch of {n} factors exceeds the kernel's int32 indexing")
        if dev.type == "cuda" and vslots.data_ptr() % 16:
            raise ValueError("vslots must start on a 16-byte boundary (one load per row)")
        if n and not (0 <= int(vslots.min()) and int(vslots.max()) < count):
            raise ValueError(f"vslots out of range for a table of {count} poses")
        self.inputs = (vslots, z, S, w)
        self.count, self.n, self.device = count, n, dev
        self.entries = entries
        # one allocation: r, Jᵀr (float64) then J1, J2 (float32)
        buf = torch.empty(144 * n, dtype=torch.uint8, device=dev)
        self.r = buf[: 24 * n].view(torch.float64).view(n, 3)
        self.jtr = buf[24 * n: 72 * n].view(torch.float64).view(2, n, 3)
        self.J1 = buf[72 * n: 108 * n].view(torch.float32).view(n, 3, 3)
        self.J2 = buf[108 * n:].view(torch.float32).view(n, 3, 3)
        # the kernel's arguments after the table, fixed for the plan's life
        self._args = [t.data_ptr() for t in (vslots, z, S, w, self.r, self.J1, self.J2,
                                             entries, self.jtr)] + [n]

    def serves(self, vslots, z, S, w):
        """True when made for exactly these input tensors."""
        return all(a is b for a, b in zip(self.inputs, (vslots, z, S, w)))

    def __call__(self, values):
        """r (n, 3) float64, (J1, J2) (n, 3, 3) float32 and Jᵀr (2, n, 3)
        float64 at ``values``; the entry values land in ``entries``."""
        if not (isinstance(values, torch.Tensor) and values.dtype == torch.float64
                and tuple(values.shape) == (self.count, 3) and values.device == self.device
                and values.is_contiguous()):
            raise ValueError(
                f"values must be a contiguous float64 ({self.count}, 3) tensor on {self.device}")
        vslots, z, S, w = self.inputs
        if self.device.type == "cpu":
            r, (J1, J2), entries, jtr = pose2pose2_normal_plain(values, vslots, z, S, w)
            for dst, src in ((self.r, r), (self.J1, J1), (self.J2, J2), (self.jtr, jtr),
                             (self.entries, entries.reshape(-1))):
                dst.copy_(src)
        elif self.n:
            lib = _library()  # builds on first use; raises if it cannot
            _launch("normal", lib.rome_pose2pose2_normal_f32, self.device,
                    values.data_ptr(), *self._args)
        return self.r, (self.J1, self.J2), self.jtr


# factor-type name -> fused linearize (p, q, z, S, w) -> (r0, (J1, J2)),
# weight applied
FUSED_LINEARIZE = {
    "Pose2Pose2": pose2pose2_linearize,
    "MutablePose2Pose2Gaussian": pose2pose2_linearize,
}
# factor-type name -> the normal epilogue's plan, for the ndchol LM path
FUSED_NORMAL = {
    "Pose2Pose2": Pose2Pose2Normal,
    "MutablePose2Pose2Gaussian": Pose2Pose2Normal,
}
