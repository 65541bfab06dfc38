"""Multi-process runtime initialization (counterpart of
``rome_tpu/parallel/distributed.py``).

The JAX package joins one process per host through ``jax.distributed`` and
runs its distributed solves over the global device mesh. Here each rank is
one process (SPMD) in a ``torch.distributed`` process group, and a
:class:`Mesh` is that rank's view of the group: the world size, its rank, its
device and the axis name. A ``psum`` of the JAX package is an ``all_reduce``
(sum) through :meth:`Mesh.all_reduce`.

Backends: NCCL when every rank has a card of its own; gloo with CUDA tensors
(``"cpu:gloo,cuda:gloo"``) when ranks share a card (NCCL refuses two ranks
on one GPU); gloo on the CPU. Without a process group a mesh has one rank and
its collectives are no-ops (the single-process case).
"""

from __future__ import annotations

import datetime
import logging
import os
import pickle
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from rome_tpu_torch.utils.device import entry_device

logger = logging.getLogger("rome_tpu_torch")


def _backend(device, world_size):
    if torch.device(device).type != "cuda":
        return "gloo"
    if world_size <= torch.cuda.device_count():
        return "nccl"
    return "cpu:gloo,cuda:gloo"


def _rank_device(device, rank):
    """The device of ``rank``: ``cuda`` without an index is the card
    ``rank % device_count``; anything else is taken as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def init_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device="cuda",
    timeout_s: float = 600.0,
) -> bool:
    """Initialize this process's rank of a ``torch.distributed`` group
    (idempotent).

    Arguments default from the standard env vars (``MASTER_ADDR`` /
    ``MASTER_PORT`` through ``env://``, ``WORLD_SIZE``, ``RANK``) so
    launchers can stay generic. ``device`` is where the ranks run ("cuda":
    rank r on card ``r % device_count``) and picks the backend. Every
    collective waits at most ``timeout_s``, so a dead rank fails the run
    instead of hanging it. Returns True when a process group is (or already
    was) initialized, False for the single-process case (one rank and no
    rendezvous given: nothing to do).
    """
    entry_device(device)
    if dist.is_initialized():
        return True
    if init_method is None and os.environ.get("MASTER_ADDR"):
        init_method = "env://"
    world_size = world_size or int(os.environ.get("WORLD_SIZE", "1"))
    rank = rank if rank is not None else int(os.environ.get("RANK", "0"))
    if init_method is None:
        if world_size > 1:
            raise ValueError(f"world size {world_size} needs an init_method or MASTER_ADDR")
        logger.info("single-process runtime (no torch.distributed init)")
        return False
    backend = _backend(device, world_size)
    dev = _rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend=backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    logger.info("torch.distributed initialized: rank %d/%d, %s, %s", rank, world_size,
                backend, dev)
    return True


@dataclass
class Mesh:
    """One rank's view of the 1-D mesh over every rank (the counterpart of
    the JAX package's 1-D ``Mesh``). ``collectives`` counts the all-reduces
    made through it."""

    axis: str
    world: int
    rank: int
    device: torch.device
    group: object = None
    collectives: int = 0

    @property
    def shape(self):
        return {self.axis: self.world}

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the ranks, in place; returns ``x``."""
        self.collectives += 1
        if self.group is not None:
            dist.all_reduce(x, group=self.group)
        return x

    def all_reduce_dict(self, parts: dict) -> dict:
        """Sum same-dtype tensors over the ranks with ONE all_reduce of their
        concatenation; returns a dict of the same keys and shapes."""
        flat = self.all_reduce(torch.cat([p.reshape(-1) for p in parts.values()]))
        out, o = {}, 0
        for k, p in parts.items():
            out[k] = flat[o: o + p.numel()].reshape(p.shape)
            o += p.numel()
        return out


def global_mesh(axis: str = "f", device="cuda") -> Mesh:
    """The 1-D mesh over every rank of the initialized process group (one
    rank without a group). This rank's device: ``device``, with "cuda"
    meaning card ``rank % device_count``."""
    entry_device(device)
    if dist.is_initialized():
        world, rank, group = dist.get_world_size(), dist.get_rank(), dist.group.WORLD
    else:
        world, rank, group = 1, 0, None
    return Mesh(axis=axis, world=world, rank=rank, device=_rank_device(device, rank),
                group=group)


def mesh_for(mesh: Optional[Mesh], axis: str, device) -> Mesh:
    """``mesh`` or, without one, the global mesh on ``device``; checks that
    ``device`` is available and that a given mesh runs on its kind."""
    entry_device(device)
    if mesh is None:
        return global_mesh(axis, device)
    if mesh.device.type != torch.device(device).type:
        raise ValueError(f"the mesh runs on {mesh.device}, asked for device={device!r}")
    return mesh


def solve_graph_distributed(fg, mesh: Optional[Mesh] = None, solve_key: str = "parametric",
                            device="cuda", **kw):
    """End-to-end distributed parametric solve of a FactorGraph on every rank
    of the mesh: lower, shard the factor batches over the ranks, run the LM
    loop, write the results back. The multi-process analogue of
    ``solve_graph_parametric``; every rank calls it with the same graph."""
    from rome_tpu_torch.graph.lower import lower, write_back
    from rome_tpu_torch.parallel.sharding import solve_distributed

    mesh = mesh_for(mesh, "f", device)
    ga = lower(fg, solve_key, device=mesh.device)
    values, stats = solve_distributed(ga, mesh, device=device, **kw)
    write_back(fg, ga, values, solve_key)
    return {"stats": stats, "mesh": tuple(mesh.shape.items())}


def _rank_main(rank, fn, world, init_method, device, timeout_s, outdir, args):
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)  # ranks share the host's cores
    # every rank runs on this host: rendezvous over the loopback interface
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    init_distributed(init_method, world, rank, device, timeout_s)
    try:
        out = fn(global_mesh(device=device), *args)
        with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(out, fh)
    except BaseException:
        # when, and what: a peer's collective fails only after this rank has
        # gone, so the earliest record names the rank that failed first
        with open(os.path.join(outdir, f"rank{rank}.err"), "w") as fh:
            fh.write(f"{time.time()!r}\n{traceback.format_exc()}")
        raise
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, args=(), device="cuda", timeout_s: float = 600.0):
    """Run ``fn(mesh, *args)`` in ``world`` new processes (spawned, never
    forked), one rank each of a fresh process group (a file rendezvous in a
    new temporary directory), and return the ranks' results in rank order.
    ``fn`` must be importable by name from a module the children can import;
    its result must pickle. An exception in any rank ends every rank and
    raises here, naming the rank that raised first and its traceback."""
    entry_device(device)
    tmp = tempfile.mkdtemp(prefix="rome_ranks_")
    try:
        try:
            torch.multiprocessing.start_processes(
                _rank_main, nprocs=world, join=True, start_method="spawn",
                args=(fn, world, f"file://{os.path.join(tmp, 'rendezvous')}", device,
                      timeout_s, tmp, tuple(args)),
            )
        except Exception as e:
            errs = []
            for r in range(world):
                path = os.path.join(tmp, f"rank{r}.err")
                if os.path.exists(path):
                    with open(path) as fh:
                        when, tb = fh.read().split("\n", 1)
                    errs.append((float(when), r, tb))
            if not errs:
                raise
            _when, r, tb = min(errs)
            raise RuntimeError(f"rank {r} of {world} raised first:\n{tb}") from e
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as fh:
                out.append(pickle.load(fh))  # written by the ranks above
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
