"""Distributed nonparametric belief propagation (counterpart of
``rome_tpu/parallel/multimodal.py``).

The two stages of a Jacobi sweep (solvers/multimodal/batched.py) are sharded
over the ranks of a mesh:

- **messages**: embarrassingly parallel over factors — each rank solves the
  particle messages of its contiguous slice of every message stream and
  writes them into a local copy of the padded (V, K, N, pdim) product
  tensors; ONE ``all_reduce`` of the writes and their mask merges the
  disjoint writes (each (var, k) slot is written by exactly one rank).
- **products**: sharded over variables — each rank runs the masked Gibbs
  product (K2/K3's draw epilogue per label update) on its ceil(V / world)
  rows of each type, and ONE owner-writes ``all_reduce`` reassembles the new
  beliefs on every rank.

Per-factor fallback messages (multihypo data association, non-Gaussian
mixtures) are computed on the host before the sharded stages, from the
stream every rank shares, and enter as the pre-filled base of the product
tensors, as in the single-device engine.

Randomness: the product draws of variable i are row i of draws made for
every variable from the stream all ranks share, so the products do not
depend on the world size (the JAX package folds the global index into each
variable's key). Message draws come from a per-rank stream with shard-local
shapes, so a multi-rank solve equals a one-rank solve in distribution, not
bitwise — as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from rome_tpu_torch.parallel.distributed import Mesh, mesh_for
from rome_tpu_torch.solvers.multimodal.batched import (
    BatchedNonparametricSolver,
    _masked_gibbs,
    _source_messages,
)
from rome_tpu_torch.solvers.multimodal.convolve import approx_conv


def _block(n: int, mesh: Mesh):
    """This rank's rows of ``n``: the contiguous block [lo, hi) of
    ceil(n / world) rows (the last ranks may hold fewer, or none)."""
    per = -(-n // mesh.world)
    lo = min(mesh.rank * per, n)
    return lo, min(lo + per, n)


class ShardedNonparametricSolver(BatchedNonparametricSolver):
    """Distributed variant of :class:`BatchedNonparametricSolver` on this
    rank: the same routing and fallback machinery, the per-sweep compute
    factor- and variable-sharded over ``mesh``. Every rank builds it from
    the same graph and calls ``solve`` with the same seed."""

    def __init__(self, fg, mesh: Mesh = None, solve_key: str = "default", N=None,
                 gibbs_sweeps: int = 3, axis: str = "f", device="cuda"):
        mesh = mesh_for(mesh, axis, device)
        super().__init__(fg, solve_key=solve_key, N=N, gibbs_sweeps=gibbs_sweeps,
                         device=mesh.device)
        self.mesh = mesh
        self._rows = []
        for src in self.bp.sources:
            lo, hi = _block(self.ga.batches[src.b].n, mesh)
            self._rows.append(torch.arange(lo, hi, device=mesh.device))

    def sweep(self, beliefs, gen, var_masks=None, msg_masks=None):
        """One sharded Jacobi sweep; ``gen`` is the stream every rank shares
        (same seed, same draws on every rank)."""
        bp, ga, mesh, N = self.bp, self.ga, self.mesh, self.N
        dev, dt = ga.device, ga.dtype

        # base product tensors (identity-point padding) + the host-side
        # fallback splice, identical on every rank
        base_p, base_m = {}, {}
        for t in ga.type_names:
            if not bp.has_msg[t].any():
                continue
            ident = ga.manifolds[t].identity(dt, dev)
            pdim = beliefs[t].shape[-1]
            base_p[t] = ident.expand(ga.counts[t], bp.kmax[t], N, pdim).clone()
            base_m[t] = torch.zeros((ga.counts[t], bp.kmax[t]), dtype=dt, device=dev)
        if bp.fallback:
            self.scatter_beliefs(beliefs)  # the fallback reads the records
            for flbl, vlbl, t, vslot, k in bp.fallback:
                m = approx_conv(self.fg, flbl, vlbl, self.solve_key, gen=gen, N=N, device=dev)
                base_p[t][vslot, k] = m.to(dt)
                base_m[t][vslot, k] = 1.0

        # ---- factor-sharded messages, from this rank's stream ----
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen, device=gen.device))
        mgen = torch.Generator(device=dev)
        mgen.manual_seed(int(np.random.SeedSequence([seed, mesh.rank]).generate_state(
            1, np.uint64)[0] >> np.uint64(1)))
        wrote_p = {t: torch.zeros_like(v) for t, v in base_p.items()}
        wrote_m = {t: torch.zeros_like(v) for t, v in base_m.items()}
        for src, rows in zip(bp.sources, self._rows):
            if rows.numel() == 0:
                continue
            msgs = _source_messages(bp, ga, src, beliefs, self._params_all[src.b], mgen, rows)
            dv, dk = src.dest_var_t[rows], src.dest_k_t[rows]
            wrote_p[src.ttype][dv, dk] = msgs
            wrote_m[src.ttype][dv, dk] = 1.0
        # merge the disjoint writes: every (var, k) slot is written by exactly
        # one rank; everywhere else the base passes through untouched
        red = mesh.all_reduce_dict({**{("p", t): v for t, v in wrote_p.items()},
                                  **{("m", t): v for t, v in wrote_m.items()}})
        merged_p, merged_m = {}, {}
        for t in base_p:
            wrote = torch.clamp(red[("m", t)], max=1.0)
            merged_m[t] = torch.clamp(base_m[t] + wrote, max=1.0)
            if msg_masks is not None:
                merged_m[t] = merged_m[t] * self._tensor(msg_masks[t])
            merged_p[t] = base_p[t] * (1.0 - wrote)[..., None, None] + red[("p", t)]

        # ---- variable-sharded Gibbs products ----
        outs = {}
        for t in merged_p:
            lo, hi = _block(ga.counts[t], mesh)
            out = torch.zeros_like(beliefs[t])
            out[lo:hi] = _masked_gibbs(ga.manifolds[t], merged_p[t][lo:hi], merged_m[t][lo:hi],
                                       bp.gibbs_sweeps, gen, rows=(lo, ga.counts[t]))
            outs[t] = out
        outs = mesh.all_reduce_dict(outs) if outs else outs
        new_beliefs = dict(beliefs)
        for t, out in outs.items():
            vm = (self._tensor(var_masks[t]) if var_masks is not None
                  else torch.ones((ga.counts[t],), dtype=dt, device=dev))
            upd = merged_m[t].amax(dim=1) * bp.has_msg_t[t] * ga.free[t] * vm
            new_beliefs[t] = torch.where(upd[:, None, None] > 0, out, beliefs[t])
        return new_beliefs
