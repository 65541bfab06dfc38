"""Gibbs pairwise scores and label draws: wrappers of the hand-written CUDA
kernels K2 and K3.

The kernels (``csrc/pairwise_logw.cu``, sm_90a, float32) are the ports of
the JAX package's Pallas kernels ``rome_tpu/ops/pairwise.py:_se2_kernel``
(K2) and ``:_euclid_kernel`` (K3). Each has two epilogues built from one
score code: ``*_pairwise_logw`` writes the (V, N, Nj) scores (the Pallas
contract), ``*_gibbs_draw`` takes uniforms u and writes only the (V, N)
Gumbel-max labels (what the solve paths launch). The library is compiled
with ``nvcc`` at first use (``ops/nvcc_build.py``), loaded with ``ctypes``
and launched on PyTorch's current stream; one launch serves all V variables
of a type.

Dispatch is by the device of the tensors given: a CUDA tensor always goes to
the kernel (a missing ``nvcc``, a failed build or a refused launch raises;
there is no fallback), a CPU tensor takes the plain version in
``ops/pairwise.py``. Both take float32 only.
"""

from __future__ import annotations

import ctypes

import torch

from rome_tpu_torch.ops import nvcc_build
from rome_tpu_torch.ops.pairwise import (
    MAX_DOF,
    euclid_gibbs_draw_plain,
    euclid_pairwise_logw_plain,
    se2_gibbs_draw_plain,
    se2_pairwise_logw_plain,
)

SOURCE = "pairwise_logw.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
_FUNCTIONS = {
    "rome_se2_pairwise_logw": [_P] * 5 + [_I] * 3 + [_P],
    "rome_se2_gibbs_draw": [_P] * 6 + [_I] * 3 + [_P],
    "rome_euclid_pairwise_logw": [_P] * 6 + [_I] * 4 + [_P],
    "rome_euclid_gibbs_draw": [_P] * 7 + [_I] * 4 + [_P],
}

# Kernel launches made by these wrappers, per epilogue (reset by callers
# that count them).
LAUNCHES = {"se2_pairwise_logw": 0, "euclid_pairwise_logw": 0,
            "se2_gibbs_draw": 0, "euclid_gibbs_draw": 0}

_lib = None


def build():
    """Compile the kernel library if needed; returns its path."""
    return nvcc_build.build(SOURCE)


def _library():
    global _lib
    if _lib is None:
        _lib = nvcc_build.load(build(), _FUNCTIONS)  # build raises if it cannot
    return _lib


def _batched(*ts):
    """Accept the unbatched JAX signature as V = 1."""
    if ts[0].dim() == 2:
        return tuple(t[None] for t in ts), True
    return ts, False


def _check(name, ref, mu, pts, inv_var, d_expect=None):
    ts = (ref, mu, pts, inv_var)
    if not all(isinstance(t, torch.Tensor) for t in ts):
        raise TypeError(f"{name} takes tensors")
    dev = ref.device
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"{name} takes float32 only, got {[t.dtype for t in ts]}")
    if any(t.device != dev for t in ts):
        raise ValueError(f"{name} inputs must share one device")
    if ref.dim() != 3:
        raise ValueError(f"{name}: ref must be (V, N, d) or (N, d), got {tuple(ref.shape)}")
    V, N, d = ref.shape
    Nj = pts.shape[1] if pts.dim() == 3 else -1
    shapes = ((V, N, d), (V, N, d), (V, Nj, d), (V, d))
    for nm, t, shp in zip(("ref", "mu", "pts", "inv_var"), ts, shapes):
        if tuple(t.shape) != shp:
            raise ValueError(f"{name}: {nm} has shape {tuple(t.shape)}, expected {shp}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous")
    if d_expect is not None and d != d_expect:
        raise ValueError(f"{name} takes dof {d_expect}, got {d}")
    if not 1 <= d <= MAX_DOF:
        raise ValueError(f"{name} takes 1 <= dof <= {MAX_DOF}, got {d}")
    if V >= 65536:
        raise ValueError(f"{name}: V={V} exceeds the kernel's grid")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} has no path for device {dev}")
    return V, N, Nj, d


def _check_circ(name, circ, d, dev):
    if not isinstance(circ, torch.Tensor) or circ.dtype != torch.float32 or \
            tuple(circ.shape) != (d,) or circ.device != dev or not circ.is_contiguous():
        raise ValueError(f"{name}: circ must be a contiguous float32 ({d},) tensor on {dev}")


def _check_u(name, u, V, N, Nj, dev):
    if not isinstance(u, torch.Tensor) or u.dtype != torch.float32 or \
            tuple(u.shape) != (V, N, Nj) or u.device != dev or not u.is_contiguous():
        raise ValueError(f"{name}: u must be a contiguous float32 {(V, N, Nj)} tensor on {dev}")
    if Nj == 0:
        raise ValueError(f"{name}: no candidate to draw from (Nj = 0)")


def _launch(name, fn, out, *args):
    if out.numel() == 0:
        return  # nothing to score: no launch
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def _ptrs(*ts):
    return [t.data_ptr() for t in ts]


def se2_pairwise_logw(ref, mu, pts, inv_var):
    """K2: SE(2) Gibbs log-weights (V, N, Nj) from ref, mu (V, N, 3),
    pts (V, Nj, 3), inv_var (V, 3); or (N, Nj) from the unbatched shapes."""
    (ref, mu, pts, inv_var), squeeze = _batched(ref, mu, pts, inv_var)
    V, N, Nj, _ = _check("se2_pairwise_logw", ref, mu, pts, inv_var, d_expect=3)
    if ref.device.type == "cpu":
        out = se2_pairwise_logw_plain(ref, mu, pts, inv_var)
    else:
        lib = _library()
        out = torch.empty((V, N, Nj), dtype=torch.float32, device=ref.device)
        _launch("se2_pairwise_logw", lib.rome_se2_pairwise_logw, out,
                *_ptrs(ref, mu, pts, inv_var, out), V, N, Nj)
    return out[0] if squeeze else out


def se2_gibbs_draw(ref, mu, pts, inv_var, u):
    """K2's draw epilogue: (V, N) int64 Gumbel-max labels of the SE(2) Gibbs
    scores given uniforms u (V, N, Nj); or (N,) from the unbatched shapes."""
    (ref, mu, pts, inv_var, u), squeeze = _batched(ref, mu, pts, inv_var, u)
    V, N, Nj, _ = _check("se2_gibbs_draw", ref, mu, pts, inv_var, d_expect=3)
    _check_u("se2_gibbs_draw", u, V, N, Nj, ref.device)
    if ref.device.type == "cpu":
        out = se2_gibbs_draw_plain(ref, mu, pts, inv_var, u)
    else:
        lib = _library()
        out = torch.empty((V, N), dtype=torch.int64, device=ref.device)
        _launch("se2_gibbs_draw", lib.rome_se2_gibbs_draw, out,
                *_ptrs(ref, mu, pts, inv_var, u, out), V, N, Nj)
    return out[0] if squeeze else out


def euclid_pairwise_logw(ref, mu, pts, inv_var, circ):
    """K3: per-dim linear/circular Gibbs log-weights; ``circ`` (d,) float32
    is 1 where the dim is an angle. Shapes as :func:`se2_pairwise_logw`."""
    (ref, mu, pts, inv_var), squeeze = _batched(ref, mu, pts, inv_var)
    V, N, Nj, d = _check("euclid_pairwise_logw", ref, mu, pts, inv_var)
    _check_circ("euclid_pairwise_logw", circ, d, ref.device)
    if ref.device.type == "cpu":
        out = euclid_pairwise_logw_plain(ref, mu, pts, inv_var, circ)
    else:
        lib = _library()
        out = torch.empty((V, N, Nj), dtype=torch.float32, device=ref.device)
        _launch("euclid_pairwise_logw", lib.rome_euclid_pairwise_logw, out,
                *_ptrs(ref, mu, pts, inv_var, circ, out), V, N, Nj, d)
    return out[0] if squeeze else out


def euclid_gibbs_draw(ref, mu, pts, inv_var, circ, u):
    """K3's draw epilogue: (V, N) int64 Gumbel-max labels of the per-dim
    scores given uniforms u. Shapes as :func:`se2_gibbs_draw`."""
    (ref, mu, pts, inv_var, u), squeeze = _batched(ref, mu, pts, inv_var, u)
    V, N, Nj, d = _check("euclid_gibbs_draw", ref, mu, pts, inv_var)
    _check_circ("euclid_gibbs_draw", circ, d, ref.device)
    _check_u("euclid_gibbs_draw", u, V, N, Nj, ref.device)
    if ref.device.type == "cpu":
        out = euclid_gibbs_draw_plain(ref, mu, pts, inv_var, circ, u)
    else:
        lib = _library()
        out = torch.empty((V, N), dtype=torch.int64, device=ref.device)
        _launch("euclid_gibbs_draw", lib.rome_euclid_gibbs_draw, out,
                *_ptrs(ref, mu, pts, inv_var, circ, u, out), V, N, Nj, d)
    return out[0] if squeeze else out
