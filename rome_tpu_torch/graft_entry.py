"""Top-level entry points: a single-card LM step and the multi-rank dryrun
(counterpart of the JAX package's ``__graft_entry__.py``).

- ``entry()`` returns one LM step of the port's ``pcg`` solver over the
  circle fixture, with its arguments.
- ``dryrun_multichip(n)`` runs, inside an initialized process group of world
  ``n``, the full owner-computes (varpart) LM solve and the factor-sharded
  solve of a 1,024-pose chain, with the JAX package's assertions.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from rome_tpu_torch.utils.device import entry_device


def _build_fixture(n_poses: int = 6, device="cuda"):
    """The lowered circle graph, perturbed off its optimum by the JAX
    package's draws (default_rng(0), sigma 0.3) so a GN step has work."""
    from rome_tpu_torch.canonical.generators import generate_graph_circle
    from rome_tpu_torch.graph.lower import lower

    fg = generate_graph_circle(n_poses)
    fg.init_all()
    ga = lower(fg, device=device)
    rng = np.random.default_rng(0)
    ga.values0 = {
        t: ga.manifolds[t].normalize(
            v + torch.as_tensor(rng.normal(size=tuple(v.shape)) * 0.3, device=v.device).to(v.dtype))
        for t, v in ga.values0.items()
    }
    return ga


def entry(device="cuda"):
    """One LM iteration on the circle fixture (linearize -> block-Jacobi
    PCG -> retract -> cost): returns ``(step, (values, lam, rt))``;
    ``step(*args)`` runs it on ``device``."""
    from rome_tpu_torch.solvers.gauss_newton import GNOptions, ParametricSolver
    from rome_tpu_torch.solvers.linearize import runtime_state

    entry_device(device)
    ga = _build_fixture(6, device)
    solver = ParametricSolver(ga, GNOptions(linear="pcg", pcg_iters=50))
    return solver.step, (ga.values0, np.float32(1e-4), runtime_state(ga))


def _build_chain_fixture(n_poses: int, closures: str = "random", device="cuda"):
    """Odometry chain + sparse loop closures at M-dataset-like density, from
    the JAX package's draws (default_rng(7)): both packages build the same
    graph.

    closures="random": uniform (i, j) pairs — long-range links, the worst
    case for any variable partition (the separator grows with n).
    closures="local": |j - i| in [20, 60] — corridor-SLAM locality, where a
    contiguous partition cuts O(ranks) edges and the separator stays
    constant in n (the realistic distributed-SLAM regime)."""
    from rome_tpu_torch import FactorGraph, MvNormal, Pose2, Pose2Pose2, PriorPose2
    from rome_tpu_torch.graph.lower import lower
    from rome_tpu_torch.manifolds.base import SE2_

    entry_device(device)
    rng = np.random.default_rng(7)
    fg = FactorGraph()
    fg.params.graphinit = False
    fg.add_variable("x0", Pose2)
    fg.add_factor(["x0"], PriorPose2(MvNormal([0, 0, 0], [0.1, 0.1, 0.05])))
    cov = np.diag([0.01, 0.01, 0.005])
    pose = torch.zeros(3, dtype=torch.float64)
    poses = [pose]
    for i in range(1, n_poses):
        turn = rng.choice([0.0, np.pi / 2, -np.pi / 2], p=[0.8, 0.1, 0.1])
        z = np.array([1.0, 0.0, turn])
        fg.add_variable(f"x{i}", Pose2)
        fg.add_factor([f"x{i-1}", f"x{i}"], Pose2Pose2(MvNormal(z, cov)))
        pose = SE2_.compose(pose, SE2_.exp(torch.as_tensor(z)))
        poses.append(pose)
        fg.init_variable(f"x{i}", pose.numpy() + rng.normal(0, [0.3, 0.3, 0.05]))
    fg.init_variable("x0", [0.0, 0.0, 0.0])
    for _ in range(n_poses // 10):  # loop closures
        if closures == "local":
            i = int(rng.integers(0, max(1, n_poses - 61)))
            j = i + int(rng.integers(20, 61))
        else:
            i, j = sorted(rng.integers(0, n_poses, size=2))
        if j - i < 20 or j >= n_poses:
            continue
        z = SE2_.local(poses[i], poses[j]).numpy()
        fg.add_factor([f"x{i}", f"x{j}"], Pose2Pose2(MvNormal(z, cov)))
    return lower(fg, device=device)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """FULL distributed LM solve of a 1,024-pose chain over the ``n_devices``
    ranks of the initialized process group (one rank without a group):
    first the owner-computes variable partition (parallel/varpart.py), each
    rank owning a contiguous variable block and exchanging only separator
    values, then the factor-sharded replicated-variable path for
    comparison. Raises when a solve does not converge as the JAX package
    asserts. Returns both rows."""
    import torch.distributed as dist

    from rome_tpu_torch.parallel.distributed import global_mesh
    from rome_tpu_torch.parallel.sharding import make_sharded_gn_step
    from rome_tpu_torch.parallel.varpart import make_varpart_solver
    from rome_tpu_torch.solvers.linearize import cost_at

    entry_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) runs in a process group of world "
                         f"{n_devices}; this one has {world}")
    mesh = global_mesh("v", device)
    ga = _build_chain_fixture(1024, device=mesh.device)
    cost_start = float(cost_at(ga, ga.values0))
    say = print if mesh.rank == 0 else (lambda *_a: None)

    # --- primary: owner-computes varpart over every rank ---
    solve, _plan = make_varpart_solver(ga, mesh, axis="v", max_iters=60, device=device)
    t0 = time.time()
    _values, stats = solve(ga.values0, lam0=1e-4)
    dt = time.time() - t0
    say(f"dryrun_multichip varpart({n_devices}): cost {cost_start:.1f} -> "
        f"{stats['final_cost']:.6f} in {stats['iterations']} LM iters "
        f"({dt:.2f}s, reason={stats['reason']}, comms={stats['comms']})")
    if not stats["final_cost"] < cost_start * 1e-3:
        raise AssertionError("varpart solve must converge")
    if not stats["converged"]:
        raise AssertionError("expected a tolerance-hit exit")

    # --- secondary: factor-sharded replicated-variable path ---
    step, ga_p = make_sharded_gn_step(ga, mesh=global_mesh("f", device), pcg_iters=100,
                                      device=device)
    t0 = time.time()
    _v, it, code, fc = step.solve(ga_p.values0, 1e-4)
    dt2 = time.time() - t0
    say(f"dryrun_multichip factor-sharded({n_devices}): cost "
        f"{cost_start:.1f} -> {fc:.6f} in {it} LM iters ({dt2:.2f}s, reason={code})")
    if not fc < cost_start * 1e-3:
        raise AssertionError("distributed solve must converge")
    return dict(cost_start=cost_start,
                varpart=dict(stats, seconds=dt),
                factor_sharded=dict(iterations=it, code=code, final_cost=fc, seconds=dt2))
