"""approxConv — the nonparametric factor convolution (counterpart of
``rome_tpu/solvers/multimodal/convolve.py``).

To propagate a belief through a factor toward a target variable, each
particle's sampled measurement is solved for ``residual = 0`` on the
target's few tangent dofs: a fixed-iteration damped Gauss-Newton, batched
over every particle (and, in the batched engine, every factor) at once.
Each message's initializer and iterations are one device program per key
(factor type, slot, particle count, dtype, device, the params' shapes),
captured as a CUDA graph at the key's first call and replayed, as the JAX
package jits ``_cached_conv`` once per key (``conv_particles``).

``approx_conv`` also carries the per-particle hypothesis machinery:
``nullhypo`` (a particle keeps its inflated prior sample with probability
eta) and ``multihypo`` (a per-particle categorical data association across
the candidate variables of the factor's last slot).

Random draws come from the caller's ``torch.Generator``; particles are
float32 on the caller's device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.func import jacfwd, vmap

from rome_tpu_torch.graph.graph import FactorGraph
from rome_tpu_torch.solvers.multimodal.kde import categorical, silverman_bandwidth
from rome_tpu_torch.utils.device import entry_device
from rome_tpu_torch.utils.device_loop import Program
from rome_tpu_torch.utils.math import matvec
from rome_tpu_torch.utils.profiling import count
from rome_tpu_torch.utils.store import Store

DTYPE = torch.float32


def sample_measurements(factor, gen, n: int, device="cuda", dtype=DTYPE) -> torch.Tensor:
    """getSample analogue: (n, zdim) measurement coordinate samples from the
    factor's belief(s), or its mean ``z`` when it has none."""
    entry_device(device)
    cols = [d.sample(gen, n, device, dtype) for d in factor.dists]
    if not cols:
        z = torch.as_tensor(factor.params["z"], dtype=dtype, device=device)
        return z.expand(n, z.shape[0])
    return torch.cat(cols, dim=-1)


def _gn_solve_target(ftype, slot, mans, z, params, other_pts, x0, iters=10, damping=1e-6):
    """Damped GN on the target variable only, batched over M particles.

    z (M, zdim) measurement samples; params: dict of (M, ...) per-particle
    factor parameters (``sqrt_info`` among them); other_pts: tuple of
    (M, point_dim) points for every slot (the target's entry is ignored);
    x0 (M, point_dim) start. Returns (M, point_dim). Reads nothing on the
    host: a message's program captures it (:class:`_GNProgram`).
    """
    man = mans[slot]

    def resid(d, x, z, params, others):
        pts = tuple(
            man.boxplus(x, d) if k == slot else others[k] for k in range(len(mans))
        )
        p = dict(params)
        p["z"] = z
        r = matvec(params["sqrt_info"], ftype.residual(p, *pts))
        return r, r

    jac = vmap(jacfwd(resid, has_aux=True))
    others = tuple(other_pts)
    zeros = torch.zeros((x0.shape[0], man.dof), dtype=x0.dtype, device=x0.device)
    eye = torch.eye(man.dof, dtype=x0.dtype, device=x0.device)
    x = x0
    for _ in range(iters):
        J, r = jac(zeros, x, z, params, others)          # (M, zdim, dof), (M, zdim)
        H = J.transpose(-1, -2) @ J
        # trace-scaled damping: underdetermined factors (range-only) give a
        # rank-deficient H whose tiny absolute damping cancels in f32
        mu = 1e-3 * torch.diagonal(H, dim1=-2, dim2=-1).sum(-1) / man.dof + damping
        H = H + mu[:, None, None] * eye
        g = (J.transpose(-1, -2) @ r[..., None])[..., 0]
        d = torch.linalg.solve_ex(H, g)[0]
        x = man.normalize(man.boxplus(x, -d))
    return x


def _conv(ftype, slot, mans, params, z, x0, pts):
    """One message's arithmetic: the target slot seeded from the factor's
    closed-form initializer (or ``x0``), then every particle solved. The
    body of :class:`_GNProgram` and its plain version alike."""
    init_fn = ftype.initializers.get(slot)
    x_init = init_fn({**params, "z": z}, list(pts)) if init_fn is not None else x0
    return _gn_solve_target(ftype, slot, mans, z, params, pts, x_init)


class _GNProgram:
    """:func:`_conv` of one (factor type, slot, particle count, dtype,
    device, params' shapes) as a device program (``utils/device_loop``):
    static inputs that each call copies in (z, each per-particle param, each
    slot's points, x0), the initializer and the Gauss-Newton iterations
    replayed from them, the solved points out. Captured at its first call on
    the card; run eagerly on the CPU."""

    def __init__(self, ftype, slot, mans, params, z, x0, pts):
        def buf(t):
            return torch.empty(t.shape, dtype=t.dtype, device=t.device)

        self.ftype, self.slot, self.mans = ftype, slot, list(mans)
        self.params = {k: buf(v) for k, v in params.items()}
        self.z, self.x0 = buf(z), buf(x0)
        self.pts = [buf(p) for p in pts]
        self.out = buf(x0)
        self.program = Program(z.device, [(self._body, 1)], name="np_gn")

    def _body(self, run):
        self.out.copy_(_conv(self.ftype, self.slot, self.mans, self.params, self.z, self.x0,
                             self.pts))

    def __call__(self, params, z, x0, pts, eager=False):
        """The solved (M, pdim) points of these inputs (a new tensor); with
        ``eager`` the program's plain version."""
        for k, b in self.params.items():
            b.copy_(params[k])
        for b, p in zip(self.pts, pts):
            b.copy_(p)
        self.z.copy_(z)
        self.x0.copy_(x0)
        self.program.run(eager=eager)
        return self.out.clone()


_PROGRAMS = Store("np.gn_program", 32)


def _program_key(ftype, slot, mans, params, z, x0, pts):
    def shape(t):
        return tuple(t.shape[1:]), t.dtype

    return (ftype, slot, tuple(m.name for m in mans), z.shape[0], z.dtype, str(z.device),
            tuple((k, *shape(v)) for k, v in sorted(params.items())), shape(z), shape(x0),
            tuple(shape(p) for p in pts))


def conv_particles(ftype, slot, mans, params, z, x0, pts):
    """One message: seed the target slot from the factor's closed-form
    initializer (or ``x0``) and solve every particle. ``params``: (M, ...)
    per particle; z (M, zdim); x0 (M, pdim); pts: (M, pdim) per slot.

    Runs the keyed :class:`_GNProgram` (at most 32 kept, cleared when full:
    ``_PROGRAMS``), as the JAX package jits ``_cached_conv`` once per key.
    Counts one ``np.gn_solves``, M ``np.gn_rows`` and a
    ``np.gn_program.hit`` or ``.miss`` (a new program, captured at this
    call on the card)."""
    count("np.gn_solves")
    count("np.gn_rows", z.shape[0])
    program = _PROGRAMS.get(_program_key(ftype, slot, mans, params, z, x0, pts),
                            lambda: _GNProgram(ftype, slot, mans, params, z, x0, pts))
    return program(params, z, x0, pts)


def record_particles(rec, solve_key, N, gen, device, dtype=DTYPE):
    """(N, point_dim) particles of a variable record on ``device``: its
    belief (resampled to N when it holds another count), else its point
    broadcast, else the manifold identity."""
    pts = rec.beliefs.get(solve_key)
    if pts is not None:
        pts = torch.as_tensor(np.asarray(pts), device=device).to(dtype)
        if pts.shape[0] != N:
            idx = torch.randint(0, pts.shape[0], (N,), generator=gen, device=device)
            pts = pts[idx]
        return pts
    p = rec.points.get(solve_key, rec.points.get("parametric"))
    p = (rec.manifold.identity(dtype, device) if p is None
         else torch.as_tensor(np.asarray(p), device=device).to(dtype))
    return p.expand(N, p.shape[0])


def approx_conv(
    fg: FactorGraph,
    factor_label: str,
    target_label: str,
    solve_key: str = "default",
    gen: Optional[torch.Generator] = None,
    N: Optional[int] = None,
    skip_hypo: bool = False,
    device="cuda",
    seed: int = 0,
) -> torch.Tensor:
    """approxConv(fg, :factor, :target): (N, point_dim) float32 particle
    samples on ``device`` of the target variable implied by the factor and
    the other variables' current beliefs. Draws come from ``gen`` (a
    ``torch.Generator`` on ``device``), else from one seeded by ``seed``.
    ``skip_hypo`` ignores the factor's multihypo association (graph init)."""
    entry_device(device)
    f = fg.factors[str(factor_label)]
    target_label = str(target_label)
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(int(seed))
    arity = f.ftype.arity
    # multihypo layout: variables beyond the factor arity are candidates for
    # the LAST residual slot
    var_idx = list(f.variables).index(target_label)
    N = N or fg.params.N

    recs = [fg.variables[v] for v in f.variables]
    mans = [fg.variables[v].manifold for v in f.variables[:arity]]
    tman = recs[var_idx].manifold

    pts = [record_particles(r, solve_key, N, gen, device) for r in recs]
    z = sample_measurements(f, gen, N, device)

    # target init: current belief + inflation noise (SolverParams.inflation;
    # gives underdetermined factors — ranges — their solution-ring spread)
    x0 = record_particles(recs[var_idx], solve_key, N, gen, device)
    infl = f.inflation if f.inflation is not None else fg.params.inflation
    bw = silverman_bandwidth(tman, x0)
    noise = torch.randn((N, tman.dof), generator=gen, dtype=DTYPE, device=device) \
        * (bw.clamp_min(1e-2) * infl)
    x0_infl = tman.normalize(tman.boxplus(x0, noise))

    # multihypo data association: variable indices >= arity-1 are mutually
    # exclusive candidates for the last residual slot, drawn per particle
    # with the fractional multihypo weights; nullhypo: a keep mask
    multihypo = None if skip_hypo else f.multihypo
    draw = None
    if multihypo is not None and len(recs) > arity:
        w = np.asarray(multihypo, dtype=np.float64)
        w = w[arity - 1:] / w[arity - 1:].sum()
        probs = torch.as_tensor(w, dtype=DTYPE, device=device)
        draw = categorical(torch.log(probs).expand(N, len(w)), gen)
    keep = None
    if f.nullhypo and f.nullhypo > 0.0:
        keep = torch.rand((N,), generator=gen, dtype=DTYPE, device=device) < float(f.nullhypo)
    return conv_with_draws(f, var_idx, mans, pts, z, x0_infl, draw, keep)


def conv_with_draws(f, var_idx, mans, pts, z, x0_infl, draw=None, keep=None):
    """The deterministic part of ``approx_conv`` given its draws: the
    measurement samples z (N, zdim), the inflated target start x0_infl
    (N, pdim), the per-particle candidate index ``draw`` (N,) of a multihypo
    association (None: no association) and the nullhypo ``keep`` mask (N,)
    (None: no nullhypo). ``pts``: (N, pdim) particles per factor variable."""
    arity = f.ftype.arity
    slot = min(var_idx, arity - 1)
    N, device = z.shape[0], z.device
    params = {
        k: torch.as_tensor(v, dtype=z.dtype, device=device).expand(N, *np.shape(v))
        for k, v in f.params.items()
    }

    def conv(slot_pts):
        return conv_particles(f.ftype, slot, mans, params, z, x0_infl, list(slot_pts))

    if draw is None:
        solved = conv(pts[:arity])
    elif var_idx < arity - 1:
        # target is a certain slot: per particle substitute the associated
        # candidate variable's particles into the last residual slot
        cand = torch.stack(pts[arity - 1:])                   # (K, N, pdim)
        chosen = cand[draw, torch.arange(N, device=device)]
        solved = conv(pts[: arity - 1] + [chosen])
    else:
        # target is a candidate: only its associated particles update; the
        # rest keep inflated prior samples
        solved = conv(pts[: arity - 1] + [pts[var_idx]])
        solved = torch.where((draw == var_idx - (arity - 1))[:, None], solved, x0_infl)

    # nullhypo: a particle ignores the factor with probability eta
    if keep is not None:
        solved = torch.where(keep[:, None], x0_infl, solved)
    return mans[slot].normalize(solved)


# reference-style alias
approxConv = approx_conv
