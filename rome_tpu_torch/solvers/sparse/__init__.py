"""Nested-dissection multifrontal block-sparse Cholesky: a host-side symbolic
phase (numpy, copied from the JAX package) and a batched numeric phase in
PyTorch."""

from rome_tpu_torch.solvers.sparse.symbolic import SymbolicChol, symbolic_factor
from rome_tpu_torch.solvers.sparse.ndchol import (
    cached_symbolic,
    ndchol_assemble,
    ndchol_factorize,
    ndchol_logdet,
    ndchol_solve,
    ndchol_takahashi,
)

__all__ = [
    "SymbolicChol",
    "symbolic_factor",
    "cached_symbolic",
    "ndchol_assemble",
    "ndchol_factorize",
    "ndchol_logdet",
    "ndchol_solve",
    "ndchol_takahashi",
]
