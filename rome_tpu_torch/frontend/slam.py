"""Live SLAM front-end runtime (counterpart of ``rome_tpu/frontend/slam.py``;
reference: Slam.jl).

The reference runs an ``@async`` consumer loop with Channel-token
backpressure (Slam.jl:189-297). Here the solver manager is a daemon thread
draining a solvable queue, with the same stride-trigger/token/condition
semantics, and each solve cycle appends a timing row (wait / solvable /
init / disengage / solve) like the reference timinglog. The thread solves on
the device it is given (``device="cuda"``, the default, pinned in the thread
by ``torch.cuda.set_device``); an exception of a solve is logged, kept in
``SLAMWrapperLocal.errors`` for the producer, and ends the thread.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from rome_tpu_torch.graph.graph import FactorGraph, SolverParams


@dataclass
class ManageSolveSettings:
    """Slam.jl:43-59 — solve stride + channel-based flow control."""

    solve_stride: int = 10
    loop_solver: bool = True
    solvables: "queue.Queue" = field(default_factory=queue.Queue)
    solve_token: "queue.Queue" = field(default_factory=lambda: queue.Queue(maxsize=1))
    pose_stride: int = 10
    can_take_poses: "threading.Condition" = field(default_factory=threading.Condition)
    solve_in_progress: bool = False
    drt_current: Optional[str] = None


@dataclass
class SLAMWrapperLocal:
    """SLAMWrapper/SLAMWrapperLocal (Slam.jl:26-84): graph + counters +
    solve settings container."""

    dfg: FactorGraph = field(default_factory=FactorGraph)
    pose_count: int = 0
    frame_count: int = 0
    pose_stride: int = 10
    solve_settings: ManageSolveSettings = field(default_factory=ManageSolveSettings)
    solve_count: int = 0
    timing_log: list = field(default_factory=list)
    tree: object = None  # recycled Bayes tree across solves (solveTree!(fg, tree))
    errors: list = field(default_factory=list)  # exceptions that ended the manager
    # held by the manager over each cycle's graph work (engage, init,
    # disengage, solve); a producer that adds to the graph while the manager
    # runs takes it too, so a solve never lowers a graph mid-edit
    lock: "threading.RLock" = field(default_factory=threading.RLock)

    def get_solver_params(self) -> SolverParams:
        return self.dfg.params


def trigger_solve(slam: SLAMWrapperLocal) -> bool:
    """triggerSolve! (Slam.jl:95-123): non-blocking put of a solve token."""
    try:
        slam.solve_settings.solve_token.put_nowait(time.time())
        return True
    except queue.Full:
        return False


def check_solve_stride_trigger(slam: SLAMWrapperLocal) -> bool:
    """checkSolveStrideTrigger! (Slam.jl:95-123): fire a solve every
    ``solve_stride`` poses."""
    if slam.pose_count % slam.solve_settings.solve_stride == 0:
        return trigger_solve(slam)
    return False


def block_progress(slam: SLAMWrapperLocal, timeout: float = 30.0):
    """blockProgress (Slam.jl:141-151): wait while the solver is behind."""
    ss = slam.solve_settings
    with ss.can_take_poses:
        if ss.solve_in_progress and not ss.solve_token.empty():
            ss.can_take_poses.wait(timeout)


def block_solving_in_progress(slam: SLAMWrapperLocal, timeout: float = 30.0):
    ss = slam.solve_settings
    t0 = time.time()
    while ss.solve_in_progress and time.time() - t0 < timeout:
        time.sleep(0.01)


def stop_manage_solve_tree(slam: SLAMWrapperLocal):
    """stopManageSolveTree! — end the consumer loop."""
    slam.solve_settings.loop_solver = False
    try:
        slam.solve_settings.solvables.put_nowait(None)
    except queue.Full:
        pass


def manage_solve_tree(
    slam: SLAMWrapperLocal,
    dbg: bool = False,
    timing_log: Optional[list] = None,
    disengage_youngest: int = 10,
    poll_s: float = 0.02,
    solve_fn=None,
    device="cuda",
) -> threading.Thread:
    """manageSolveTree! (Slam.jl:189-297): start the asynchronous solver
    manager. Consumer loop: drain solvable queue -> set solvable=1 ->
    init_all -> (token?) disengage old poses -> solve -> notify producers.

    ``solve_fn(fg)`` defaults to the parametric batch solve on ``device``;
    pass the nonparametric solver for multimodal operation. The thread makes
    ``device`` its current CUDA device before its first solve.
    """
    import torch

    from rome_tpu_torch.frontend.robot_utils import set_solvable_old_poses
    from rome_tpu_torch.solvers.parametric import solve_graph_parametric
    from rome_tpu_torch.utils.device import entry_device

    entry_device(device)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    ss = slam.solve_settings
    log = timing_log if timing_log is not None else slam.timing_log
    solve_fn = solve_fn or (lambda fg: solve_graph_parametric(fg, device=device))

    def run():
        try:
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            loop()
        except Exception as e:  # kept for the producer, logged, and the manager ends
            slam.errors.append(e)
            logging.getLogger("rome_tpu_torch").exception("the solve manager stopped")
            with ss.can_take_poses:
                ss.can_take_poses.notify_all()

    def loop():
        while ss.loop_solver:
            t_wait0 = time.time()
            # drain solvables
            drained = []
            try:
                item = ss.solvables.get(timeout=poll_s)
                if item is None:
                    continue
                drained.extend(item if isinstance(item, (list, tuple)) else [item])
                while True:
                    try:
                        more = ss.solvables.get_nowait()
                        if more is None:
                            break
                        drained.extend(more if isinstance(more, (list, tuple)) else [more])
                    except queue.Empty:
                        break
            except queue.Empty:
                pass
            dt_wait = time.time() - t_wait0

            with slam.lock:
                t0 = time.time()
                for lbl in drained:
                    if lbl in slam.dfg.variables or lbl in slam.dfg.factors:
                        slam.dfg.set_solvable(lbl, 1)
                dt_solvable = time.time() - t0

                t0 = time.time()
                slam.dfg.init_all()
                dt_init = time.time() - t0

                # only run a full solve when a token is pending
                if ss.solve_token.empty():
                    continue

                t0 = time.time()
                set_solvable_old_poses(slam.dfg, youngest=disengage_youngest)
                dt_disengage = time.time() - t0

                ss.solve_in_progress = True
                t0 = time.time()
                try:
                    solve_fn(slam.dfg)
                finally:
                    ss.solve_in_progress = False
                dt_solve = time.time() - t0
                slam.solve_count += 1

            try:
                ss.solve_token.get_nowait()
            except queue.Empty:
                pass
            with ss.can_take_poses:
                ss.can_take_poses.notify_all()

            log.append(
                dict(
                    wall=time.time(), dt_wait=dt_wait, dt_solvable=dt_solvable,
                    dt_init=dt_init, dt_disengage=dt_disengage, dt_solve=dt_solve,
                    solve_count=slam.solve_count,
                )
            )

    th = threading.Thread(target=run, daemon=True, name="manageSolveTree")
    th.start()
    return th


def tree_solve_fn(slam: SLAMWrapperLocal, **solve_kw):
    """solve_fn for manage_solve_tree that runs the Bayes-tree nonparametric
    solve with tree recycling across cycles (Slam.jl:261 tree = solveTree!
    (dfg, tree))."""
    from rome_tpu_torch.solvers.multimodal.tree import solve_tree

    def fn(fg):
        slam.tree = solve_tree(fg, slam.tree, **solve_kw)
        return slam.tree

    return fn


# reference-style aliases
triggerSolve = trigger_solve
checkSolveStrideTrigger = check_solve_stride_trigger
blockProgress = block_progress
blockSolvingInProgress = block_solving_in_progress
stopManageSolveTree = stop_manage_solve_tree
manageSolveTree = manage_solve_tree
