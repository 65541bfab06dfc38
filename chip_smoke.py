#!/usr/bin/env python3
"""Smoke run of the PyTorch port (rome_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit), the torch / CUDA
   versions and the TF32 settings (both forced off: float32 products run in
   full float32).
2. Builds the hand-written CUDA kernel libraries with nvcc from the
   checkout's sources, one nvcc per source, all started together: K1
   (Pose2Pose2 linearize) and K2/K3 (Gibbs pairwise scores and label
   draws); prints the build seconds and the ptxas reports. Measures the
   card's stream copy rate (1 GiB, CUDA events).
3. K1 phase: both epilogues of K1 against their plain PyTorch versions on
   the card, on seeded random inputs at n in {1, 499, 1000, 8192, 10000,
   13085} and 1,048,576 (499: the mixture chain of phase 15). The lin epilogue (the Pallas contract) in float32 (atol
   2e-5, the JAX package's Pallas-kernel tolerance) and float64 (atol
   1e-10), also from inputs one element off a 16-byte boundary, and on the
   batch sizes of phases 16-17 (K1_PADDED) padded to their shape buckets
   with weight-0 rows, which must come out exactly 0. The normal
   epilogue (the ndchol LM path's launch: float64 pose table of n / 2 poses,
   int64 slots, float32 z, S, w) with its entry block at offsets of 0 and 9
   floats (36 B, the grid graphs' layout) in the entry vector: the float64
   residual at atol 1e-12, the float32 Jacobians within 2e-5 or 1e-5
   relative, the JtJ entry values within 2e-5 or 1e-5 of the summed
   magnitudes of their products, the float64 Jtr contributions at 1e-9 relative
   against the plain contraction of the kernel's own J and r, and the entry
   vector untouched outside the block. Both timed at n = 13,085 and
   1,048,576 per host call (CUDA events) and per launch on the device
   (torch.profiler), beside each epilogue's bound.
4. K2/K3 phase: both epilogues of both kernels against their plain
   versions at (V, N, Nj) = (1, 1, 1), (1, 37, 101), the beehive-100 shapes
   (101, 100, 100) and (74, 100, 100), the default engine's shapes
   (1, 100, 100) (one variable's product in a Gauss-Seidel pass or the loop
   engine), (22, 100, 100) and (14, 100, 100) (the honeycomb-21 Pose2 and
   Point2 sweeps), (10, 100, 100) and (6, 100, 100) (the Jacobi sweeps of
   phase 15's DynPoint2 and mixture chains), (1, 50, 50) (a tracker update,
   phase 18) and (101, 512, 512); K3 at dof
   1, 2, 3, 4 and 8 with mixed circular masks and angles at and near +-pi,
   and at dof 4 with DynPoint2's all-linear mask. The logw epilogue within
   rtol = atol = 2e-5 (tests/test_ops_pairwise.py:43); the draw epilogue,
   fed the same uniforms as the plain draw, gives equal labels on >= 99.9 %
   of each kernel's rows, and every row that differs is a near-tie (the
   plain score of the kernel's pick within 1e-4 * (1 + |max|) of the plain
   maximum). At the beehive shapes and at V = 1: device time per call
   (torch.profiler) of both epilogues, the plain versions, a Gibbs label
   update as it was (scores, then ``categorical``) and as it is (uniforms,
   then the draw), and for K3 the one-call library form of its linear case
   (``torch.cdist``); the draw per host call (CUDA events); the bounds.
5. bench_torch.py, the port of bench.py, in this process
   (``main_path``): its rows for bench.py's reference datasets
   (``absent`` where their files are missing, else matched), then the
   citygrid path: the batch SE(2) solve of data/citygrid.g2o (10,000 poses,
   13,085 odometry/loop-closure edges, x0 prior) through the port's public
   entry points on device "cuda" — g2o load, chordal init, Levenberg-
   Marquardt with the nested-dissection Cholesky (``linear="ndchol"``) and
   the benchmark's ``big`` options — once cold and three times warm, on the
   default schedule: the speculative-accept loop, with ``fused_chordal``
   the chordal stages inside it, as one device program captured by the
   cold run and replayed. Each run must converge,
   reach an SE(2)-aligned ATE <= 1.0 m against the f64 optimum in
   data/citygrid_gt.npz, and a cost <= 1.002 * optimum + 1e-3; each run
   must launch K1's normal epilogue once per LM iteration plus once at the
   start (counted on the device inside the program; the cold run adds its
   eager warm-up's launches), and its lin epilogue never; the four runs
   take one LM iteration count. Then the script's covariance row (Takahashi at the g2o values,
   within 1e-4 of ``splu`` on 32 poses), its K1 rows
   (tools/torch/bench_kernels.py: lin, normal and the plain version at n =
   1e4, 1e5 and 1e6, each no faster than its bound, each with its share of
   the stream rate) and its metric line, non-zero, against
   tools/cpu_reference.py timed on this host's CPU in the same run.
5b. Parametric solvers on the same graph, each sub-path counting K1 from 0
   (``parametric_solvers_path``): one ``schedule="host"`` ndchol solve
   (gates; normal >= 1 per LM iteration); ``linear="auto"`` must pick
   dense32 at this size, and dense32 with the ``big`` options solves cold
   and warm under the gates with lin >= 1 per LM iteration and no normal
   launch (the D x D Cholesky timed per iteration with CUDA events, the peak
   device memory printed); one mixed and one pcg solve (40 iterations),
   reported against the optimum, each finite and ending no higher than its
   start; then marginal covariances at the host solve's solution: Takahashi
   cold and warm, finite, within 1e-4 of an f64 scipy ``splu`` solve of the
   same scaled, ridged system on 32 sampled poses (bench.py:178-255) and
   within 1e-6 of that system's dense f64 inverse (``cholesky_inverse``) on
   every pose, relative to each block's largest entry; the dense method
   (1e-8 absolute ridge) within 1e-4 of ``splu`` on its own system, its gap
   to Takahashi (a different ridge) reported.
6-10 and 13 run tools/torch/bench_multimodal.py's six rows (each phase
   through its row function) and hold its roll-up: ``all_gates_pass``.
6. Beehive path: the nonparametric solve of the beehive-100 graph (101
   Pose2, 74 Point2, 202 factors; seed 0) through
   ``solve_graph_nonparametric(..., sweeps=3, N=100, engine="batched",
   init="points", device="cuda")``, once cold and twice warm, each on a
   fresh graph. Each run's mean 2-D pose error of the belief means against
   the port's own parametric optimum of the same graph must be below 0.5 m
   (tools/bench_multimodal.py:130's gate), and the draw epilogues of K2 and
   K3 must each launch 3 sweeps x 3 Gibbs sweeps x K = 3 = 27 times per
   solve, their logw epilogues never. The parametric optimum (the dense
   solver) must launch K1's lin epilogue and not its normal one; so must the
   optima of the honeycomb and Bayes-tree paths.
7. Honeycomb grow, the default engine: ``generate_graph_honeycomb`` grown
   7 -> 14 -> 21 poses (graphinit), after each step
   ``solve_graph_nonparametric(fg, sweeps=3, N=100, engine="batched",
   init=True, device="cuda")`` (tools/bench_multimodal.py:154-196). Prints
   each step's seconds and each Gauss-Seidel pass's; the mean landmark and
   mean pose errors of the final graph against the port's own parametric
   optimum must both be below 4.0 m, and the K2 and K3 draws must each
   launch in every step.
8. Bayes-tree grow: ``solve_tree(fg, old_tree=tree, N=100, device="cuda")``
   over the honeycomb grown 7 -> 14 (bench_multimodal.py:199-240). The regrow
   must recycle at least one clique, every recycled clique's frontal beliefs
   and points must be bit-identical across the re-solve, and the mean
   landmark error must be below 4.0 m.
9. Hexagonal cross-check (bench_multimodal.py:74-95): ``engine="batched"``
   twice (first, steady) and ``engine="loop"``, ``init=True``, N = 100.
   Each must pass the band
   check (>= 35 of 100 particles within +-3 m and +-0.3 rad per pose,
   tests/test_multimodal.py:117-136) and their mean symmetric k-NN KL over
   the poses must be below 1.0.
10. Multihypo range-bearing (bench_multimodal.py:243-295): ``approx_conv``
   toward x0 of the N = 400 multihypo=[1, .5, .5] graph must put balanced
   mass on both modes; then a batched ``init=True`` solve of the hexagonal
   graph plus one multihypo bearing-range factor, whose messages take the
   per-factor fallback, must leave every belief finite.
12. Sphere (``sphere_path``): a seeded g2o file with the layout of g2o's
   create_sphere example at sphere2500's size (50 laps of 50 Pose3 on a
   100 m sphere, 2,499 odometry and 2,450 closure EDGE_SE3:QUAT lines,
   sigma 0.05 m / 0.005 rad, VERTEX_SE3:QUAT values chained from the noisy
   odometry), loaded with ``load_g2o`` plus a PriorPose3 on x0, solved by
   ``solve_graph_parametric(..., device="cuda")``: LM with the dense
   Cholesky in float64 once (the reference optimum, whose SE(3)-aligned ATE
   to the generator's truth must be within 10 % of the median odometry
   edge), then ndchol with the ``big`` options once cold and twice warm,
   each converged, with a cost <= 1.002 * the optimum + 1e-3 and an
   SE(3)-aligned ATE to the optimum within the same bound. Prints LM
   iterations, seconds, poses/s and the peak device memory; K1 is not on
   this path (no Pose2Pose2 batch).
13. SE(3) and Polar nonparametric (``se3_nonparametric_path``): approx_conv
   of the Pose3 nullhypo fixture (tools/bench_multimodal.py:297-345, N =
   400; mass at the measurement in (0.25, 0.75), spread mass > 0.15); the
   batched ``init=True`` solve (N = 100) of a 6-pose Pose3 hexagon, its
   Gibbs products on the generic score (no K2/K3 launch), mean translation
   error of the belief means against the port's parametric optimum < 1 m;
   and of a Polar chain, its products on K3's draw, mean range and angle
   errors < 0.5. The K3 phase also checks the Polar masks [0, 1] and
   [1, 0] at dof 2.
14. imu_euroc_mh01 (``imu_path``): an inertial keyframe graph at EuRoC MAV
   MH_01_easy's length and rates (182 s, 200 Hz ADIS16448 noise densities,
   synthesized from seed 0 by ``inertial_sim``: body rate (0, 0, 0.1) rad/s,
   zero world acceleration, accelerometer bias (0.02, -0.01, 0.03), v0 =
   0.45 m/s): 1,821 RotVelPos keyframes at 10 Hz, 1,820 RotVelPosBias
   IMUDeltaFactors of 20 samples, 19 IMUBias windows of 10 s (PriorIMUBias),
   a tight PriorRotVelPos on x0 and 182 position fixes at 1 Hz (0.05 m,
   seed 1), 16,503 dof, dead-reckoned by graphinit. Solved through
   ``solve_graph_parametric(..., device="cuda")``: the dense LM in float64
   once (the reference optimum, position RMSE to the truth <= 0.1 m), then
   ndchol with the ``big`` options less the dtol stop (IMU_BIG) once cold
   and once warm, each converged, cost <= 1.002 * the optimum + 1e-3 and
   position RMSE to the optimum <= 0.01 m. Prints per solve the LM
   iterations, seconds, keyframes/s, peak device memory, the accelerometer
   bias estimates and the linearize's seconds per LM iteration (CUDA
   events), and the graph-build (preintegration) seconds; no K1/K2/K3
   launch.
15. factor_library_rest (``factor_library_rest_path``), each sub-path
   counting the kernels from 0: the first 30 s of the same stream without
   bias variables (the accelerometer bias taken as calibrated), solved by
   the dense LM in float64 through IMUDeltaFactor (RotVelPos), through
   InertialDynamic (RK4, weighted by the same preintegrated covariance)
   and through IMUDeltaFactor on Pose3 + VelPos3, each converged with a
   position RMSE to the truth <= 0.1 m, the ODE within 0.02 m per second
   of the preintegrated solution and the Pose3VelPos3 split within 0.01 m
   of it; InertialPose3 free fall chained to 100 states (within 1e-2 of
   the closed form); a DynPose2 chain of 200 (VelPose2VelPose2,
   within 0.75 of x_k = (10 k, 0, 0, 10, 0)); a DIDSON sonar graph (one
   Pose3, 50 Point3 through LinearRangeBearingElevation, within 1e-2 m);
   MultipleFeatures2D (tests/test_sensors.py's fixture, within 0.05); a
   500-pose MixtureFluxPose2Pose2 chain by ndchol with the ``big`` options
   (within 1e-3 of x_k = (k, 0, 0); K1's normal epilogue launched
   iterations + 1 times, lin never); then nonparametric (N = 100,
   ``init=True``) a DynPoint2 chain of 10 (products on K3's draw, mean
   position error against the parametric optimum < 0.5 m) and a 6-pose
   mixture chain (K2's draw; its mixture messages take the per-factor
   fallback; < 1.0 m).
16. fixedlag_citygrid_3500 (``fixedlag_path``), tools/torch/incremental_bench.py's
   ``run`` in this process: citygrid's poses 0-3,499 as its time-ordered
   g2o stream (each VERTEX_SE2 line, then every EDGE_SE2 whose larger
   endpoint it is, through ``add_instruction``: the odometry edge starts
   the pose at its predecessor's estimate composed with the edge's mean,
   as a front end sends it); every 10 poses and after the last,
   ``fifo_freeze`` with window 25 and tools/incremental_bench.py's solve
   (``max_iters=30``, no chordal init, ``pad=True``, default dtype, "cuda"):
   350 solves, ``auto`` picking dense, then dense32. Gates: every frozen
   pose keeps its float64 value bit for bit through every later solve (the
   script's ``frozen_drift`` 0.0 on every row, ``max_frozen_drift`` 0.0);
   on every 25th solve and the last, a save_dfg -> load_dfg copy solved in
   float64 (dense, 100 iterations, ftol 1e-12) on the card: the step's cost
   <= 1.002 x that cost + 1e-3 and every free pose within 0.1 m of it. K1
   padded lin launched. Per step: poses, frozen, LM iterations and reason,
   seconds (and lowering's), the linear solver, ``new_solvers`` (the
   solvers ``ParametricSolver.cached`` built in the step), K1 launches;
   then the steady-step median and p90, the max_iters count (reported).
   The script's incremental tier: the stream's first 301 poses, every
   pose free, the last step under citygrid's gates against the dense f64
   optimum. Then the stream's first FIXEDLAG_REPEAT_STEPS = 25 steps run
   again (every step the same LM iterations and poses, bit for bit) and the
   end state's distance to the batch optimum of the same prefix (ndchol,
   BIG; reported).
17. live_slam_checkpoint (``live_slam_path``): examples/live_slam.py's loop
   on the stream's poses 1-300: each odometry edge accumulated in ten ticks
   on a MutablePose2Pose2Gaussian tether, duplicated into a solvable-0
   factor, its ticks stored as a blob (FolderStore), its loop closures
   added, the labels queued, the stride trigger (10) fired, the producer
   blocked while the solver is behind; ``manage_solve_tree`` (disengage 25)
   solving on "cuda" in its thread, each exception recorded. Gates: no
   exception, one timing row per solve, frozen drift 0.0 across cycles, K1
   launched; after the stop one synchronous solve under phase 16's window
   gate; save_dfg to .tar.gz and load_dfg equal bit for bit (points, flags,
   params, blob entries and bytes); one more solve of each within 1e-6 m.
18. wheeled_tracker (``wheeled_tracker_path``): ``adv_odo_by_rules`` with
   its trackers on "cuda" over a seeded 60 s drive of Victoria Park's ute
   (40 Hz wheel speed and steering, 60 trees, laser at 5 Hz within 30 m
   ahead, sigma 0.1 m / 0.01 rad). Gates: dOdo equal to the plain numpy
   integration at 1e-12; after every scan, every tracker with >= 5 updates
   within 1.5 m of a tree in that sample's true body frame; K3's draw
   launched 6 times per
   update (TRACKER_DRAWS_PER_UPDATE), K2 and every logw never.
19. Every Gibbs label update of every nonparametric path goes through the
   draw epilogues where a kernel covers the manifold: each 2-D path
   launches both draws and no logw, and every path's draw counts equal the
   label updates its graphs' structure makes (PATH_DRAWS; the tracker's,
   which follow its data, are checked per update in phase 18).
   Prints the kernel table as one JSON line (K1 by its two epilogues with
   their launches per path, normal from the citygrid solves, lin from
   dense32, mixed, pcg, the covariances and the parametric optima, and
   K2/K3 by the draw epilogue the paths launch, with the logw
   epilogue nested; launches summed over every nonparametric path, each
   path counted from 0; each with its bound from the published HBM, fp32
   and fp64 peaks), the card line,
   and as the last line {"ok": true, "device": {...}}; writes
   chiprun_out/chip_smoke.json. The kernel table's K1 and K2/K3 rows also
   carry the distributed paths' launches, summed in ``launches_by_path``
   and per world and rank in ``launches_by_rank``. The measuring entry
   points (phases 5, 6-10, 13 and 16) record their own kernel inputs
   (``PathInputs`` in this process: K1 lin and normal, the K2/K3 draws),
   each kernel held to its plain version on them (``entry_point_inputs``):
   K1 lin f32 within 2e-5 + 1e-6 x the row scale, f64 within 1e-10 +
   1e-13 x it; normal's f64 residual, f32 Jacobians and entries by the
   same bounds; the draws' labels equal to the plain draw's on >= 99.9 % of
   the rows pooled.

20-22. The distributed solves (slice D, ``distributed_path``), each at
   world 1 (one rank, NCCL) and world 4 (four ranks on the one card, gloo
   with CUDA tensors), ranks started by ``parallel.distributed.spawn_ranks``
   (spawn, a file rendezvous); each rank sets every launch count to 0 just
   before each path and reads it just after; any rank's exception ends the
   script. First, once in this process (``distributed_inputs``): citygrid
   lowered with phase 5's chordal initialisation and the single-device
   ``linear="pcg"`` step from it, the corridor chain and its single-device
   ndchol optimum, the beehive optimum and a single-device batched solve.
   20. factor_sharded_citygrid_10k: ``solve_distributed`` (max_iters 40,
   pcg_iters 100) from the chordal point; then 100 all-reduces of the
   PCG's payload alone (30,000 float64; host clock ending in a sync) for
   the collectives' share of the solve. Gates: the same reason at both
   worlds, iterations at most 4 apart and final costs within 1.5x
   (tests/test_sharding.py:85-90); each world's first step within
   tests/test_sharding.py:62-66's bounds of the single-device pcg step
   (cost0 1e-3, cost1 2e-2 relative, poses 5e-3); K1 ``lin`` launched (and
   ``normal`` not) in every rank; every rank ends with the same poses.
   Reported: iteration drift, relative cost difference, largest pose
   difference, ATE against data/citygrid_gt.npz, all-reduces a solve.
   World 1 solves twice: the same iterations, final cost and poses, bit for
   bit (so does phase 21's).
   21. varpart_chain_10k: ``graft_entry._build_chain_fixture(10000,
   "local")`` in float64 through ``make_varpart_solver(max_iters=60)``.
   Gates: converged, final cost < 1e-3 of the start (dryrun_multichip's),
   the single-rank cost of the result <= 1.01 x the ndchol optimum + 1e-6
   (tests/test_varpart.py:91-100); K1 ``lin`` in every rank. Printed:
   ``comms_note()``, the iteration drift, peak device memory. Then
   ``graft_entry.dryrun_multichip(4)`` in the world-4 group, under its own
   assertions.
   22. sharded_beehive_100: beehive-100 (seed 0, N = 100, 3 sweeps,
   ``init="points"``, phase 6's seed) through ``ShardedNonparametricSolver``.
   Gates: phase 6's 0.5 m mean pose error against the parametric optimum;
   symmetric k-NN KL < 2.0 against the single-device batched solve on x0,
   x50, x100 and l0 (tests/test_multimodal_sharded.py:48-70); in every
   rank, K2 and K3 draw launches equal to what its variable rows make
   (3 sweeps x 3 Gibbs sweeps x K = 3) and no logw launch; every rank ends
   with the same beliefs.

4b. Fixed-order sums (``fixed_order_check``, after the kernel phases): on
   citygrid's own LM inputs on the card, the ndchol assembly, the diagonal
   of H and the gradient, each summed FIXED_ORDER_REPS times in the order
   the symbolic plan fixes (ops/segment_sum.SegmentPlan), must give the
   same bits every time; the atomic ``index_add_`` they replaced is run on
   the same values and its distinct results reported. So must, on
   citygrid's start, the chordal stage's sums (the float32 diagonal of its
   ND system; stage 1's gradient and matvec, stage 2's gradient and matvec
   in float64) and dense32's normal equations (H's entries and g in
   float32), each also within 1e-6 of the float64 sum of its terms
   relative to their summed magnitudes, its atomic twin reported beside
   it. Phase 14 then gates that its cold and warm ndchol runs take the
   same LM iterations to the same final cost, bit for bit.
5c. One answer per input (``citygrid_repeat_check``, right after phase 5):
   citygrid from the g2o CITYGRID_REPEATS = 4 more times, warm; over these
   and phase 5's four solves one LM iteration count, one final-cost bit
   pattern and one chordal start (SHA-256 of the program's float64 chordal
   start), all three printed.
5d. fused_program (``fused_program_path``): citygrid under ``big`` on phase
   5's cached solver and its own graph, ``ParametricSolver.solve`` in turns
   as the captured program and as its eager runner (captured, eager,
   captured, eager). Gates: every solve under bench.py's gates; the same
   chordal start, poses and final cost bit for bit and the same LM
   iterations; K1 normal launches = iterations + 1 in each; a warm captured
   solve makes exactly one synchronizing call (torch.cuda.set_sync_debug_
   mode), and torch.profiler sees iterations + 1 K1 normal kernels in it.
   Printed: seconds per solve, the capture (warm-up, capture, instantiate
   seconds, graph nodes), the program's device time by phase (CUDA events
   between its replays) and each mode's busy share, the host launch calls per solve
   under torch.profiler and the synchronizing calls (also of the cached
   solver serving another graph object, whose slots it reads to find the
   connectivity's plan).

23. vision_bundle_ladybug49 (``vision_bundle_path``): a bundle synthesized
   at the counts of BAL's Ladybug problem-49-7776-pre: 49 Pose3 cameras 4 m
   apart along a street, 7,776 Point3 landmarks on facades 4-30 m away,
   31,843 GenericProjection factors (every landmark seen twice or more,
   every depth > 0), 1 px noise, PriorPose3 on x0 and x1 (1e-3), started
   0.05 m / 0.01 rad and 0.3 m off: the dense LM in float64 once (the
   optimum; its reprojection RMSE within 0.8-1.2 px), then ndchol with the
   big options less the dtol stop cold and warm (converged, cost <= 1.002 *
   the optimum + 1e-3, landmark RMSE to it <= 1e-3 m); then
   ``solve_multiview_landmark`` (retry 100, iters 50) on 128 seeded
   landmarks started 2 m from the truth, each within 0.05 m of the
   optimum's. No K1-K3 launch. Prints solve seconds, LM iterations, peak
   memory, the generic linearize's ms per LM iteration, ndchol's largest
   front, ms per triangulation.
24. tcp_citygrid_10k (``tcp_path``): a TCPSLAMServer on 127.0.0.1 solving
   on the card and a client in this process: INIT, citygrid's 13,085
   EDGE_SE2 lines as ODOMETRY commands (covariance = inverse information),
   BATCHSOLVE, GETPARTICLES of x0, x5000, x9999, QUIT. Gates: every reply
   OK (or the particle rows); BATCHSOLVE's converged equal to a direct
   solve of the same graph on the card, its poses within 1e-3 m of it; each
   particle block N rows, its mean within 4 sigma / sqrt(N) of the pose; K1
   launched. Prints the ATE to data/citygrid_gt.npz, seconds per session
   phase, the linear solver picked.
25. periphery (``periphery_path``): ``utils.profiling.trace`` around one
   warm citygrid solve with ``annotate`` around the linearize and the linear
   solve (the trace names both and K1's kernel); phase 23's PhaseTimer
   rows; plot_slam2d of that solve and plot_kde of a beehive belief as PNGs
   in chiprun_out/periphery/ (non-empty); predict_body_br, mahalanobis_br
   and range_comp_all_poses on phase 6's beehive solve against its
   parametric optimum; every examples/torch/*.py as a subprocess on the
   card, all started together (exit 0; seconds each). The kernel table's K1
   rows gain the TCP path's launches and phase 23's zeros.

Exits non-zero, printing no result, when there is no CUDA device, when the
package is missing, or when any phase fails.
"""

from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# the port's measuring entry points (bench_torch.py, tools/torch/); the
# phases that solve their workloads go through their row functions
import bench_torch as BT
from bench_torch import BIG, ate_rmse, ate_values, build_graph, covariance_crosscheck
from tools.torch import bench_kernels as BK
from tools.torch import bench_multimodal as BM
from tools.torch import incremental_bench as IB
from tools.torch.bench_kernels import (
    K1_FLOPS, K1_VALUES, K1N_BYTES, K1N_FP32, K1N_FP64, POSE_BYTES, bound, card_line, cuda_ms,
    stream_bandwidth,
)
from tools.torch.incremental_bench import write_stream_g2o

HERE = os.path.dirname(os.path.abspath(__file__))
CITYGRID = os.path.join(HERE, "data", "citygrid.g2o")
CITYGRID_GT = os.path.join(HERE, "data", "citygrid_gt.npz")
ATE_GATE_M = BT.CITYGRID_ATE_GATE_M
# 499: the MixtureFluxPose2Pose2 chain's factors (phase 15)
K1_SIZES = (1, 499, 1000, 8192, 10000, 13085, 1 << 20)
K1_TIMED = (13085, 1 << 20)
K1_TIMED_N = K1_TIMED[0]
# the normal epilogue's entry block: at the start of the entry vector (the
# loaded g2o graphs) and after one PriorPose2 row's 9 entries (36 B)
K1_ENTRY_OFFSETS = (0, 9)
K1_SENTINEL = -7.0  # the entry vector outside the block must keep it
# the Pose2Pose2 batch sizes of phases 16-17 (the fixed-lag window's few dozen
# active factors; the incremental tier's last batch of 1,165 edges), each padded
# to its shape bucket with weight-0 copies of its last row, as lowering pads
K1_PADDED = (1, 5, 25, 29, 37, 61, 113, 1165)
PAIRWISE_TOL = dict(rtol=2e-5, atol=2e-5)
# the draw epilogue: labels equal to the plain draw's on >= LABEL_AGREE of the
# rows of each kernel, and every other row a near-tie within NEAR_TIE * (1 + |max|)
LABEL_AGREE, NEAR_TIE = 0.999, 1e-4
# (kernel, V, dof) timed at N = Nj = 100: the beehive-100 Pose2 and Point2
# products, and one variable's product (Gauss-Seidel passes, loop engine)
TIMED = (("K2", 101, 3), ("K3", 74, 2), ("K2", 1, 3), ("K3", 1, 2))
# (V, N, Nj): one pair, off every tile, the beehive-100 shapes, one variable's
# product (the Gauss-Seidel passes, the loop engine), the honeycomb-21 Pose2
# and Point2 sweeps, the Jacobi sweeps of phase 15's DynPoint2 chain (10) and
# mixture chain (6), a feature tracker's update (phase 18: two 50-particle
# T(2) beliefs), a large batch
PAIRWISE_SHAPES = ((1, 1, 1), (1, 37, 101), (101, 100, 100), (74, 100, 100), (1, 100, 100),
                   (22, 100, 100), (14, 100, 100), (10, 100, 100), (6, 100, 100),
                   (1, 50, 50), (101, 512, 512))
K3_DOFS = (1, 2, 3, 4, 8)  # 4: DynPoint2 (phase 15)
BEEHIVE_POSES, BEEHIVE_N, BEEHIVE_SWEEPS = 100, 100, 3
# the nonparametric gates: tools/torch/bench_multimodal.py's (beehive, and
# testBeehiveGrow.jl:44-46's landmark atol band for the grows)
BEEHIVE_GATE_M, GROW_GATE_M = BM.BEEHIVE_GATE_M, BM.GROW_GATE_M
GIBBS_SWEEPS = 3
NP_N = 100                    # particles of the default-engine phases
HONEYCOMB_STEPS = (7, 14, 21)
TREE_STEPS = (7, 14)
BAND_M, BAND_RAD, BAND_MIN = 3.0, 0.3, 35  # per 100 particles
MULTIHYPO_N = 400
# the Gibbs label updates (one draw launch each: K2, K3) each nonparametric
# path makes at these sizes; they depend on the graphs' structure alone
PATH_DRAWS = {"beehive_points": (81, 81), "honeycomb_grow_default": (1269, 279),
              # hexagonal: two batched solves (162, 36 each) and the loop's (135, 18)
              "bayes_tree_grow": (216, 144), "hexagonal_7pose": (459, 90),
              "multihypo_range_bearing": (27, 27),
              # the Pose3 hexagon's products take the generic score; the
              # Polar chain's take K3: three Gauss-Seidel passes of 3 x 3
              # Gibbs label updates on each of p0..p2 (K = 2; p3 has one
              # message) and three Jacobi sweeps of 3 x K_max = 6
              "se3_hexagon": (0, 0), "polar_chain": (0, 3 * 3 * 2 * 3 + 3 * 6),
              # the Pose3 nullhypo convolution: no Gibbs product
              "pose3_nullhypo": (0, 0),
              # phase 15: the DynPoint2 chain (T(4), K3): three Gauss-Seidel
              # passes of 3 Gibbs sweeps over its ten variables' messages
              # (K = 3 on x3 and x6, K = 2 elsewhere: 22) and three Jacobi
              # sweeps of 3 x K_max = 9; the mixture chain (K2): its factors
              # take the per-factor fallback, which leaves no Gauss-Seidel
              # routing, so three Jacobi sweeps of 3 x K_max = 6
              "dynpoint2_chain": (0, 3 * 3 * 22 + 3 * 9),
              "fluxmix_pose2_chain": (3 * 6, 0),
              # phase 23: a Pose3 x Point3 bundle, no Gibbs product at all
              "vision_bundle_ladybug49": (0, 0)}
# phase 12: the sphere graph (g2o's create_sphere layout, sphere2500's size)
SPHERE_LAPS, SPHERE_PER_LAP, SPHERE_RADIUS_M = 50, 50, 100.0
SPHERE_SIGMA_T, SPHERE_SIGMA_R = 0.05, 0.005
SPHERE_WARM = 2
# the x0 anchor: bench.py's 0.1 m / 0.05 rad leaves the rotation about x0 a
# soft mode (a 10 m swing of the far side of the sphere costs 0.5), along
# which ndchol's float32 factorization and 5e-2 polish crawl for all 40
# iterations, in the JAX package as in the port; 0.01 m / 0.001 rad does not
SPHERE_PRIOR_SIGMAS = [0.01] * 3 + [0.001] * 3
SPHERE_ATE_FRACTION = 0.1     # of the median odometry edge (bench.py:298-300)
# the reference optimum: LM with the dense Cholesky in float64
SPHERE_DENSE = dict(max_iters=60, linear="dense", lam0=1e-6, lam_down=0.1, lam_min=1e-12,
                    ftol=1e-10, gtol=1e-10)
NULLHYPO_N = 400
# the Polar K3 masks checked against the plain draw (Polar, BearingRange2)
POLAR_MASKS = ((0.0, 1.0), (1.0, 0.0))
# DynPoint2 (T(4)): every dim linear, as phase 15's chain gives K3
DYNPOINT2_MASK = (0.0,) * 4
# phase 14, imu_euroc_mh01: EuRoC MAV MH_01_easy's length and rates (Burri et
# al., IJRR 2016: 182 s, 80.6 m; ADIS16448 at 200 Hz; imu0/sensor.yaml noise
# densities), synthesized: body rate (0, 0, 0.1) rad/s, zero world
# acceleration (accel0 = gravity), accelerometer bias b_a, v0 = 0.45 m/s
IMU_DT, IMU_SAMPLES = 0.005, 20            # 200 Hz; keyframes at 10 Hz
IMU_KEYFRAMES = 1821                       # 182 s: 36,400 samples
IMU_SIGMA_A, IMU_SIGMA_W = 2.0e-3, 1.6968e-4
IMU_RATE, IMU_GRAVITY = (0.0, 0.0, 0.1), (0.0, 0.0, 9.81)
IMU_BIAS_A, IMU_V0 = (0.02, -0.01, 0.03), (0.45, 0.0, 0.0)
IMU_SEED, IMU_FIX_SEED = 0, 1
IMU_WINDOW = 100                           # keyframe gaps per IMUBias (10 s)
IMU_FIX_EVERY = 10                         # position fixes at 1 Hz
IMU_X0_SIGMAS = [1e-3] * 9                 # rad, m/s, m
IMU_FIX_SIGMAS = [1.0] * 3 + [1.0] * 3 + [0.05] * 3
# the bias priors: the accelerometer half at 0.1 m/s^2; the gyroscope half
# at imu0/sensor.yaml's gyroscope_random_walk over one 10 s window
# (1.9393e-5 * sqrt(10) rad/s; the synthesized gyroscope has no bias). With
# 0.1 rad/s there too, ndchol with IMU_BIG makes no headway from the dead
# reckoning at this length in the JAX package or the port (a fault of the
# reference, ROADMAP.md section 3; imu_prior_parity.py), so this path's
# gates do not cover that prior
IMU_BIAS_SIGMAS = [0.1] * 3 + [1.9393e-5 * 10 ** 0.5] * 3
# ndchol with the big options, the dtol stop off: dtol_auto reads its metric
# scale from arity-2 odometry batches, this graph has none (the IMU batch has
# arity 3), so the scale falls to 1.0 and the stop fires while LM is still
# lowering its damping, at 3,000 times the optimum's cost (both packages;
# ROADMAP.md section 3)
IMU_BIG = dict(BIG, dtol_auto=False, dtol=0.0)
IMU_TRUTH_GATE_M = 0.1                     # twice the fix sigma
IMU_OPT_GATE_M = 0.01
IMU_WARM = 1                               # warm ndchol solves after the cold one
# phase 15, factor_library_rest
REST_SECONDS = 30                          # the first 30 s of the same stream
ODE_ORDER = [6, 7, 8, 3, 4, 5, 0, 1, 2]    # IMU [rho, nu, theta] -> ODE [theta, v, p]
# the small graphs solve with the dense Cholesky in float64
REST_OPTS = dict(max_iters=100, linear="dense")
FREEFALL_STATES, FREEFALL_TOL = 100, 1e-2
DYNPOSE2_STATES = 200
DYN_NP_STATES = 10
SONAR_LANDMARKS = 50
FLUXMIX_POSES, FLUXMIX_NP_POSES = 500, 6
# phase 16, fixedlag_citygrid_3500: the reference's long-horizon fixed-lag
# mode (tools/incremental_bench.py:66-99, INCREMENTAL_r05.json "fixedlag_full")
# on citygrid's first 3,500 poses: solve every 10 poses, window 25
FIXEDLAG_POSES, FIXEDLAG_STRIDE, FIXEDLAG_WINDOW = 3500, 10, 25
FIXEDLAG_CHECK_EVERY = 25                  # solves between same-problem f64 checks
FIXEDLAG_REF = dict(max_iters=100, linear="dense", ftol=1e-12)
FIXEDLAG_WINDOW_GATE_M = 0.1               # 1 % of citygrid's 10 m edge
FIXEDLAG_REPEAT_STEPS = 25                 # steps run again: the same iterations and poses
FIXEDLAG_INCREMENTAL = 301                 # the incremental tier's poses (the script's: 600)
# phase 17, live_slam_checkpoint: examples/live_slam.py's loop on the stream
LIVE_POSES, LIVE_TICKS, LIVE_DISENGAGE = 301, 10, 25
LIVE_RESOLVE_GATE_M = 1e-6
# phase 18, wheeled_tracker: a seeded drive of Victoria Park's ute (the
# defaults of rome_tpu_torch/frontend/navigation.py: L = 2.80381, H = 0.828329)
WHEEL_SECONDS, WHEEL_HZ, LASER_EVERY = 60.0, 40, 8      # laser at 5 Hz
WHEEL_TREES, WHEEL_RANGE_M, WHEEL_SEED = 60, 30.0, 5
WHEEL_SIGMA_R, WHEEL_SIGMA_B = 0.1, 0.01
TRACKER_GATE_M, TRACKER_MIN_UPDATES = 1.5, 5
# a tracker's update is one Gibbs product of two densities: one K3 draw per
# density per Gibbs sweep (kde.gibbs_product's default of 3 sweeps)
TRACKER_DRAWS_PER_UPDATE = 3 * 2


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


class PhaseTimer:
    """CUDA-event spans around wrapped functions, summed per label. A call
    made while a device program is captured is not timed (its work runs at
    the program's replays, which make no Python call)."""

    def __init__(self, torch):
        self.torch = torch
        self.spans = defaultdict(list)
        self._restore = []

    def wrap(self, owner, name, label):
        fn = getattr(owner, name)
        torch, spans = self.torch, self.spans

        def timed(*args, **kwargs):
            if torch.cuda.is_current_stream_capturing():
                return fn(*args, **kwargs)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            spans[label].append((start, end))
            return out

        setattr(owner, name, timed)
        self._restore.append((owner, name, fn))

    def take(self):
        """Seconds per label since the last take (call after a sync); the
        seconds of each call stay in ``self.each``."""
        self.each = {k: [s.elapsed_time(e) / 1e3 for s, e in v] for k, v in self.spans.items()}
        out = {k: sum(v) for k, v in self.each.items()}
        calls = {k: len(v) for k, v in self.spans.items()}
        self.spans.clear()
        return out, calls

    def unwrap(self):
        for owner, name, fn in reversed(self._restore):
            setattr(owner, name, fn)
        self._restore.clear()


def k1_inputs(n, dtype, device, seed=0, offset=0):
    """Random Pose2Pose2 batch as tests/test_linearize_pallas.py makes it;
    with ``offset``, each tensor a view ``offset`` elements into its buffer."""
    import torch

    rng = np.random.default_rng(seed)
    p = rng.normal(0, 2, (n, 3))
    q = rng.normal(0, 2, (n, 3))
    z = rng.normal(0, 1, (n, 3))
    S = rng.normal(0, 1, (n, 3, 3)) + 5 * np.eye(3)
    w = rng.uniform(0.5, 1, (n,))
    out = []
    for a in (p, q, z, S, w):
        buf = torch.empty(offset + a.size, dtype=dtype, device=device)
        buf[offset:] = torch.as_tensor(a.reshape(-1), dtype=dtype, device=device)
        out.append(buf[offset:].view(a.shape))
    return out


def k1_normal_inputs(n, device, seed=0):
    """Seeded inputs of K1's normal epilogue at k1_inputs' scale: a float64
    table of max(2, n // 2) poses, (n, 2) int64 slots, float32 z, S, w."""
    import torch

    rng = np.random.default_rng(seed)
    count = max(2, n // 2)
    values = rng.normal(0, 2, (count, 3))
    vslots = rng.integers(0, count, (n, 2))
    z = rng.normal(0, 1, (n, 3))
    S = rng.normal(0, 1, (n, 3, 3)) + 5 * np.eye(3)
    w = rng.uniform(0.5, 1, (n,))
    return [torch.as_tensor(values, dtype=torch.float64, device=device),
            torch.as_tensor(vslots, dtype=torch.int64, device=device)] + [
        torch.as_tensor(a, dtype=torch.float32, device=device) for a in (z, S, w)]


def normal_plan(args, offset):
    """K1's normal plan for ``args`` with its entry block ``offset`` floats
    into an entry vector of sentinels; returns (plan, vector)."""
    import torch

    from rome_tpu_torch.ops import linearize_cuda as K

    values, vslots, z, S, w = args
    n = vslots.shape[0]
    vec = torch.full((offset + 36 * n + 7,), K1_SENTINEL, dtype=torch.float32,
                     device=values.device)
    return K.Pose2Pose2Normal(vslots, z, S, w, values.shape[0],
                              vec[offset: offset + 36 * n]), vec


def _f32_err(got, want, scale=None):
    """(largest |got - want|, every element finite and within 2e-5 or 1e-5
    relative to ``scale``: |want|, or for a sum of products the sum of their
    magnitudes, since a float32 sum that cancels keeps only that accuracy)."""
    import torch

    d = (got - want).abs()
    scale = want.abs() if scale is None else scale
    ok = bool(torch.isfinite(got).all()) and bool(((d <= 2e-5) | (d <= 1e-5 * scale)).all())
    return (float(d.max()) if d.numel() else 0.0), ok


def check_lin(card):
    """K1's lin epilogue against its plain version: worst error per dtype."""
    import torch

    from rome_tpu_torch.ops import linearize_cuda as K
    from rome_tpu_torch.ops.fused_linearize import pose2pose2_linearize_plain

    atol = {torch.float32: 2e-5, torch.float64: 1e-10}
    worst = {}
    cases = [(n, dt, 0) for dt in atol for n in K1_SIZES] + [
        (K1_TIMED_N, dt, 1) for dt in atol]
    for n, dt, offset in cases:
        args = k1_inputs(n, dt, "cuda", offset=offset)
        r, (J1, J2) = K.pose2pose2_linearize(*args)
        torch.cuda.synchronize()
        rp, (J1p, J2p) = pose2pose2_linearize_plain(*args)
        err = max(float((a - b).abs().max()) for a, b in ((r, rp), (J1, J1p), (J2, J2p)))
        finite = all(bool(torch.isfinite(a).all()) for a in (r, J1, J2))
        print(f"[{card}] K1 lin {str(dt)[6:]} n={n} offset={offset}: max_abs_err {err:.3e} "
              f"(atol {atol[dt]:g}) finite={finite}")
        check(finite and err <= atol[dt], f"K1 lin disagrees at n={n} {dt}: {err}")
        worst[dt] = max(worst.get(dt, 0.0), err)
    return worst


def check_lin_padded(card):
    """K1's lin epilogue on bucket-padded batches (graph/lower.py's
    ``pad=True``): equal to its plain version, and every padded row's
    residual and Jacobians exactly 0. Worst error per dtype."""
    import torch

    from rome_tpu_torch.graph.lower import bucket_size
    from rome_tpu_torch.ops import linearize_cuda as K
    from rome_tpu_torch.ops.fused_linearize import pose2pose2_linearize_plain

    atol = {torch.float32: 2e-5, torch.float64: 1e-10}
    worst = {}
    for dt in atol:
        for n in K1_PADDED:
            m = bucket_size(n)
            args = []
            for a in k1_inputs(n, dt, "cpu", seed=n):
                pad = a[-1:].expand(m - n, *a.shape[1:])
                args.append(torch.cat([a, pad]).to("cuda"))
            args[4][n:] = 0.0
            r, (J1, J2) = K.pose2pose2_linearize(*args)
            torch.cuda.synchronize()
            rp, (J1p, J2p) = pose2pose2_linearize_plain(*args)
            err = max(float((a - b).abs().max()) for a, b in ((r, rp), (J1, J1p), (J2, J2p)))
            zero = all(bool((t[n:] == 0).all()) for t in (r, J1, J2))
            finite = all(bool(torch.isfinite(t).all()) for t in (r, J1, J2))
            print(f"[{card}] K1 lin {str(dt)[6:]} n={n} padded to {m}: max_abs_err {err:.3e} "
                  f"(atol {atol[dt]:g}), padded rows zero={zero}, finite={finite}")
            check(finite and zero and err <= atol[dt],
                  f"K1 lin on a padded batch disagrees at n={n} -> {m} {dt}: {err}")
            worst[dt] = max(worst.get(dt, 0.0), err)
    return worst


def check_normal(card):
    """K1's normal epilogue against its plain version at every size and
    entry offset: worst errors per output."""
    import torch

    from rome_tpu_torch.ops.fused_linearize import pose2pose2_normal_plain
    from rome_tpu_torch.utils.math import einsum

    worst = dict(r=0.0, J=0.0, entries=0.0, jtr_rel=0.0, jtr_vs_plain=0.0)
    for n in K1_SIZES:
        for offset in K1_ENTRY_OFFSETS:
            args = k1_normal_inputs(n, "cuda", seed=n + offset)
            plan, vec = normal_plan(args, offset)
            r, Js, jtr = plan(args[0])
            torch.cuda.synchronize()
            rp, Jps, ep, jp = pose2pose2_normal_plain(*args)
            err_r = float((r - rp).abs().max())
            err_J, ok_J = max(_f32_err(J, Jp) for J, Jp in zip(Js, Jps))
            terms = torch.stack([einsum("nij,nik->njk", Jps[k].abs(), Jps[l].abs())
                                 for k in (0, 1) for l in (0, 1)])
            err_e, ok_e = _f32_err(vec[offset: offset + 36 * n], ep.reshape(-1),
                                   terms.reshape(-1))
            outside = torch.cat([vec[:offset], vec[offset + 36 * n:]])
            # Jtr against the plain contraction of the kernel's own J and r
            own = torch.stack([einsum("nij,ni->nj", J, r) for J in Js])
            rel = float((jtr - own).abs().max() / own.abs().max().clamp_min(1e-300))
            worst.update(r=max(worst["r"], err_r), J=max(worst["J"], err_J),
                         entries=max(worst["entries"], err_e),
                         jtr_rel=max(worst["jtr_rel"], rel),
                         jtr_vs_plain=max(worst["jtr_vs_plain"],
                                          float((jtr - jp).abs().max())))
            finite = all(bool(torch.isfinite(t).all()) for t in (r, jtr))
            print(f"[{card}] K1 normal n={n} entry offset={offset}: r {err_r:.3e} (atol 1e-12), "
                  f"J {err_J:.3e} (2e-5 or 1e-5 rel), entries {err_e:.3e} (2e-5 or 1e-5 of "
                  f"the products' magnitudes), Jtr {rel:.3e} rel "
                  f"(1e-9) finite={finite}")
            check(finite and err_r <= 1e-12 and ok_J and ok_e and rel <= 1e-9,
                  f"K1 normal disagrees at n={n}, offset {offset}")
            check(bool((outside == K1_SENTINEL).all()),
                  f"K1 normal wrote outside its entry block at n={n}, offset {offset}")
    return worst


def time_k1(card, bytes_per_s):
    """Both epilogues at K1_TIMED: device time per launch (torch.profiler)
    and per host call (CUDA events) beside the plain versions and bounds."""
    import torch

    from rome_tpu_torch.ops import linearize_cuda as K
    from rome_tpu_torch.ops.fused_linearize import (
        pose2pose2_linearize_plain,
        pose2pose2_normal_plain,
    )

    rows = {}
    for n in K1_TIMED:
        lin = k1_inputs(n, torch.float32, "cuda", seed=1)
        nargs = k1_normal_inputs(n, "cuda", seed=1)
        plan, _vec = normal_plan(nargs, K1_ENTRY_OFFSETS[1])
        fns = {"lin": lambda: K.pose2pose2_linearize(*lin),
               "lin_plain": lambda: pose2pose2_linearize_plain(*lin),
               "normal": lambda: plan(nargs[0]),
               "normal_plain": lambda: pose2pose2_normal_plain(*nargs)}
        dev = device_ms(list(fns.items()))
        calls = {k: cuda_ms(fns[k]) for k in ("lin", "normal")}
        count = nargs[0].shape[0]
        work = {"lin": (4 * K1_VALUES * n, K1_FLOPS * n, 0),
                "normal": (K1N_BYTES * n + POSE_BYTES * count, K1N_FP32 * n, K1N_FP64 * n)}
        for epi, (nbytes, f32, f64) in work.items():
            b_ms, b_by = bound(nbytes, f32, fp64_flops=f64)
            b_stream, _ = bound(nbytes, f32, bytes_per_s, fp64_flops=f64)
            row = dict(ms=dev[epi]["ms"], plain_ms=dev[f"{epi}_plain"]["ms"],
                       kernels_per_call=dev[epi]["kernels_per_call"],
                       plain_kernels_per_call=dev[f"{epi}_plain"]["kernels_per_call"],
                       timer=dev[epi]["timer"], plain_timer=dev[f"{epi}_plain"]["timer"],
                       call_ms=calls[epi], bound_ms=b_ms, bound_by=b_by,
                       bound_stream_ms=b_stream, bytes=nbytes,
                       share_of_bound=b_ms / dev[epi]["ms"],
                       share_of_stream_bound=b_stream / dev[epi]["ms"])
            rows[(epi, n)] = row
            print(f"[{card}] K1 {epi} n={n}: device {row['ms'] * 1e3:.3f} us "
                  f"({row['kernels_per_call']:g} kernels), plain {row['plain_ms'] * 1e3:.3f} us "
                  f"({row['plain_kernels_per_call']:g} kernels) ({row['timer']}, "
                  f"{row['plain_timer']}); "
                  f"{row['call_ms'] * 1e3:.2f} us per host call (CUDA events, 200 calls); bound "
                  f"{b_ms * 1e3:.3f} us ({b_by}, {nbytes} B), {row['share_of_bound']:.3f} of it; "
                  f"{b_stream * 1e3:.3f} us at the stream rate, "
                  f"{row['share_of_stream_bound']:.3f}")
    return rows


def kernel_phase(card, bytes_per_s):
    """K1: both epilogues checked against their plain versions, then timed."""
    lin_err = check_lin(card)
    for dt, err in check_lin_padded(card).items():
        lin_err[dt] = max(lin_err[dt], err)
    normal_err = check_normal(card)
    timed = time_k1(card, bytes_per_s)
    out = {epi: {f"n={n}": timed[(epi, n)] for n in K1_TIMED} for epi in ("lin", "normal")}
    out["lin"].update(max_abs_err=max(lin_err.values()),
                      max_abs_err_by_dtype={str(k)[6:]: v for k, v in lin_err.items()})
    out["normal"].update(max_abs_err=max(normal_err["J"], normal_err["entries"]),
                         errors=normal_err)
    return out


def _citygrid_runs(card, gt_file, device):
    """(an ``on_run`` hook for ``bench_torch.solve_dataset``, the run rows it
    fills): every solve, cold and warm, held to bench.py's gates (converged,
    SE(2)-aligned ATE <= 1.0 m, cost <= 1.002 * optimum + 1e-3) and its
    poses finite."""
    gt = np.load(gt_file)
    ref_cost = float(gt["final_cost"])
    runs = []
    since = [_captures()[0]]

    def on_run(label, fg, res):
        st = res["stats"]
        since[0], caps = _captures(since[0])
        pts = np.stack([fg.get_point(l) for l in fg.ls(r"^x\d+$")])
        ate, ate_raw = ate_rmse(fg, gt["poses"])
        row = dict(run=label, iterations=st.iterations, converged=st.converged,
                   reason=st.reason, final_cost=st.final_cost, ref_cost=ref_cost,
                   ate_rmse_m=ate, ate_raw_m=ate_raw, solve_time_s=res["solve_time_s"],
                   poses_per_s=pts.shape[0] / res["solve_time_s"],
                   cg_iters=[h["cg"] for h in st.history],
                   captures=[c["name"] for c in caps],
                   warmup_k1_normal=sum(c["warmup_launches"].get("normal", 0) for c in caps))
        runs.append(row)
        check(pts.shape == (len(gt["poses"]), 3) and np.isfinite(pts).all(),
              "poses missing or not finite")
        check(st.converged, f"{label} run did not converge ({st.reason})")
        check(ate <= ATE_GATE_M, f"{label} run ATE {ate} > {ATE_GATE_M}")
        check(st.final_cost <= ref_cost * 1.002 + 1e-3,
              f"{label} run cost {st.final_cost} > 1.002 * {ref_cost}")

    return on_run, runs


def _citygrid_launches(card, row, runs, device):
    """K1's launches per run, from the row's ``launches_by_run``: the
    speculative loop launches the normal epilogue once at the start and once
    per LM iteration at the trial point (counted on the device inside the
    captured program), plus, in the run that captured the program, its
    eager warm-up's; the lin epilogue never (a CPU rehearsal takes the plain
    path and launches nothing). One LM iteration count over the runs.
    Returns K1's launches summed over them."""
    for r, n in zip(runs, row["launches_by_run"]):
        r["k1_launches"] = {"lin": n["k1_lin"], "normal": n["k1_normal"]}
        print(f"[{card}] citygrid_10k {r['run']}: " + json.dumps(r))
        check(device != "cuda" or (n["k1_normal"] == r["iterations"] + 1 + r["warmup_k1_normal"]
                                   and n["k1_lin"] == 0),
              f"{r['run']} run: K1 launches {r['k1_launches']} for {r['iterations']} iterations "
              f"(warm-up {r['warmup_k1_normal']})")
    check(len(runs) == len(row["iterations_by_run"]) == 1 + BT.WARM_RUNS,
          f"citygrid: {len(runs)} runs")
    check(len(set(row["iterations_by_run"])) == 1,
          f"citygrid: LM iterations {row['iterations_by_run']} across its runs")
    return {epi: sum(r["k1_launches"][epi] for r in runs) for epi in ("lin", "normal")}


def main_path(card, device="cuda"):
    """Phase 5, bench_torch.py's ``run`` in this process (citygrid's solves
    through its ``solve_dataset``): its dataset rows
    (the reference files' rows ``absent`` where this tree lacks them, no row
    in error), the citygrid row's four solves each gated (``_citygrid_runs``)
    and ``matched_ate``, one LM iteration count over them; the covariance
    row within 1e-4 of ``splu``; the K1 rows (bench_kernels) at 1e4, 1e5 and
    1e6 for both epilogues and the plain version, each no faster than its
    bound and with its share of the stream rate; a non-zero metric against
    the CPU baseline measured in the same run. Every count is set to 0
    first: read at citygrid's last run, the counts are the dataset rows'
    ``launches_by_run`` summed, and K1's normal launches cover their LM
    iterations. Returns (citygrid run rows, K1 launches of those solves,
    {"detail", "metric"})."""
    _reset_launches()
    on_run, runs = _citygrid_runs(card, CITYGRID_GT, device)
    totals = []

    def hook(name, label, fg, res):
        if name == "citygrid_10k":
            on_run(label, fg, res)
            totals.append(_launches())

    detail, out = BT.run(device, card, on_run=hook)
    for name, *_ in BT.datasets():
        check("error" not in detail[name], f"bench_torch {name}: {detail[name]}")
        check("absent" in detail[name] or detail[name]["matched_ate"],
              f"bench_torch {name} not matched: {detail[name]}")
    row = detail["citygrid_10k"]
    launches = _citygrid_launches(card, row, runs, device)
    solved = [detail[name] for name, *_ in BT.datasets() if "launches_by_run" in detail[name]]
    by_run = [n for r in solved for n in r["launches_by_run"]]
    summed = {k: sum(n[k] for n in by_run) for k in totals[-1]}
    check(totals[-1] == summed,
          f"bench_torch datasets: launches {totals[-1]} from 0, their runs' {summed}")
    iterations = sum(sum(r["iterations_by_run"]) for r in solved)
    check(device != "cuda" or totals[-1]["k1_normal"] >= iterations,
          f"K1 normal launches {totals[-1]['k1_normal']} do not cover the {iterations} LM "
          f"iterations")
    cov, kern, base = (detail[k] for k in ("covariance_recovery", "kernel_speed_of_light",
                                           "cpu_baseline"))
    print(f"[{card}] bench_torch covariance_recovery: " + json.dumps(cov))
    check("error" not in cov and cov["finite"] and cov["accuracy_ok"],
          f"bench_torch covariances: {cov}")
    check("error" not in kern, f"bench_kernels: {kern}")
    for variant, rows in kern["variants"].items():
        check([r["n"] for r in rows] == list(BK.SIZES), f"bench_kernels {variant}: sizes")
        for r in rows if device == "cuda" else ():  # a CPU rehearsal times nothing
            print(f"[{card}] bench_kernels {variant} n={r['n']}: {r['us']:.3f} us device "
                  f"({r['input_copies']} input copies), {r['host_us_per_call']:.2f} us per host "
                  f"call; bound {r['bound_us']:.3f} us ({r['bound_by']}, {r['bytes']} B), "
                  f"{r['pct_of_hbm_roofline']:.1f} % of it, "
                  f"{r['pct_of_measured_stream']:.1f} % of the stream rate")
            check(math.isfinite(r["us"]) and r["us"] >= r["bound_us"]
                  and r["pct_of_measured_stream"] > 0,
                  f"bench_kernels {variant} n={r['n']}: {r['us']} us against its bound "
                  f"{r['bound_us']} us")
    print(f"[{card}] bench_torch cpu_baseline: " + json.dumps(base))
    print(f"[{card}] bench_torch metric: " + json.dumps(out))
    check(base["converged"], f"CPU baseline did not converge: {base}")
    check(out["metric"] == "citygrid_10k_parametric_poses_per_sec_at_matched_ate"
          or "absent" not in detail["manhattan3500"], f"bench_torch headline {out['metric']}")
    check(out["value"] > 0 and math.isfinite(out["vs_baseline"]) and out["vs_baseline"] > 0,
          f"bench_torch metric {out}")
    return runs, launches, dict(detail=detail, metric=out)


CITYGRID_REPEATS = 4          # warm solves of the repeat check after the citygrid path


class ChordalStarts:
    """The SHA-256 of every chordal start made in a ``with`` block, in
    order: the Pose2 values ``init2d.chordal_init_pose2`` returns (float32
    bytes on the host), or, where the solve runs the chordal stages inside
    its program (``fused_chordal``), the program's chordal start after the
    solve (float64 bytes)."""

    def __enter__(self):
        import hashlib

        from rome_tpu_torch.solvers import init2d
        from rome_tpu_torch.solvers.gauss_newton import ParametricSolver

        self.digests = digests = []
        self._real = real_init, real_solve = init2d.chordal_init_pose2, ParametricSolver.solve

        def digest(t):
            digests.append(hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest())

        def recorded(ga, values, **kw):
            out = real_init(ga, values, **kw)
            digest(out["Pose2"])
            return out

        def solve(solver, *args, **kw):
            out = real_solve(solver, *args, **kw)
            if solver.fuses_chordal:
                digest(solver.last_program.chordal_start)
            return out

        init2d.chordal_init_pose2 = recorded
        ParametricSolver.solve = solve
        return self

    def __exit__(self, *exc):
        from rome_tpu_torch.solvers import init2d
        from rome_tpu_torch.solvers.gauss_newton import ParametricSolver

        init2d.chordal_init_pose2, ParametricSolver.solve = self._real


def citygrid_repeat_check(card, runs, starts, device="cuda", g2o=CITYGRID, reps=CITYGRID_REPEATS):
    """One answer per input: citygrid from the g2o ``reps`` more times, warm,
    as ``main_path`` solves it (inside the same ``ChordalStarts`` block).
    Over these solves and ``main_path``'s ``runs``: one LM iteration count,
    one final-cost bit pattern and one chordal start."""
    from rome_tpu_torch import GNOptions, solve_graph_parametric

    rows = [dict(run=r["run"], iterations=r["iterations"], final_cost=r["final_cost"],
                 solve_time_s=r["solve_time_s"]) for r in runs]
    for _ in range(reps):
        fg = build_graph(g2o)
        res = solve_graph_parametric(fg, init=False, options=GNOptions(**BIG), chordal_init=True,
                                     device=device)
        st = res["stats"]
        rows.append(dict(run="repeat", iterations=st.iterations, final_cost=st.final_cost,
                         solve_time_s=res["solve_time_s"]))
    check(len(starts.digests) == len(rows),
          f"citygrid repeats: {len(starts.digests)} chordal starts for {len(rows)} solves")
    for r, d in zip(rows, starts.digests):
        r["chordal_start_sha256"] = d
    out = dict(solves=len(rows), rows=rows,
               iterations=sorted({r["iterations"] for r in rows}),
               final_cost_bits=sorted({float(r["final_cost"]).hex() for r in rows}),
               chordal_start_sha256=sorted({r["chordal_start_sha256"] for r in rows}))
    print(f"[{card}] citygrid repeats ({len(rows)} solves: main path's {len(runs)} and "
          f"{reps} warm): LM iterations {out['iterations']}, final cost bits "
          f"{out['final_cost_bits']}, chordal start sha256 {out['chordal_start_sha256']}")
    for key in ("iterations", "final_cost_bits", "chordal_start_sha256"):
        check(len(out[key]) == 1, f"citygrid repeats: {len(out[key])} distinct {key}: {out[key]}")
    return out


# phase 5d, fused_program: the LM program's solves in turns, captured and eager
FUSED_TURNS = ("captured", "eager", "captured", "eager")
# the CUDA runtime calls the host makes to launch work, as torch.profiler names them
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                     "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                     "cudaMemsetAsync")


def _profiled_solve(solver, rt, eager):
    """One warm ``solver.solve`` under torch.profiler: the host's launch
    calls by runtime call, the kernels the device ran (K1 normal's among
    them) and the profiled span. The profiler's kernel times are not used:
    on this card it lengthens every kernel (its kernel time exceeds the
    unprofiled solve)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("fused_program_solve"):
            solver.solve(None, rt, eager=eager)
            torch.cuda.synchronize()
    events = prof.events()
    span = next(e for e in events if e.name == "fused_program_solve").time_range
    launches = defaultdict(int)
    for e in events:
        if e.device_type.name == "CPU" and e.name in HOST_LAUNCH_CALLS:
            launches[e.name] += 1
    kernels = [e for e in events if e.device_type.name == "CUDA"]
    k1 = sum(1 for e in kernels if "pose2pose2_kernel" in e.name and "Normal" in e.name)
    return dict(host_launch_calls=dict(launches), host_launches=sum(launches.values()),
                device_kernels=len(kernels), k1_normal_kernels=k1,
                profiled_span_ms=(span.end - span.start) / 1e3,
                profiled_kernel_ms=sum(e.time_range.end - e.time_range.start
                                       for e in kernels) / 1e3)


def _sync_calls(solver, rt, eager):
    """The synchronizing calls (torch.cuda.set_sync_debug_mode's warnings)
    one warm ``solver.solve`` makes: (count, the innermost repo frames of
    each call's Python stack, at most 8)."""
    import traceback
    import warnings

    import torch

    sites = []

    def record(message, *_a, **_k):
        if "synchronizing" in str(message):
            frames = [f for f in traceback.extract_stack()[:-1] if HERE in f.filename]
            sites.append(" < ".join(f"{os.path.relpath(f.filename, HERE)}:{f.lineno}"
                                    for f in reversed(frames[-3:])))

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = record
            solver.solve(None, rt, eager=eager)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return len(sites), sites[:8]


def _captures(since=0):
    """(a mark for the next call, the device programs captured since the
    mark ``since``): each from its ``program.capture`` span in the
    profiling ring: name, warm-up, capture and instantiate seconds, graph
    nodes and warm-up launches."""
    from rome_tpu_torch.utils import profiling

    out = []
    for s in profiling.spans("program.capture"):
        if s.start >= since:
            secs = {c.name: c.seconds for c in s.children}
            out.append(dict(name=s.attrs["program"], warmup_s=secs.get("warmup"),
                            capture_s=secs.get("capture"),
                            instantiate_s=secs.get("instantiate"), nodes=s.attrs.get("nodes"),
                            warmup_launches=s.attrs.get("warmup_launches", {})))
    return time.perf_counter_ns(), out


def _program_device_ms(program, reps=3):
    """(device milliseconds of each stamped phase of a captured program,
    the program's whole device span in milliseconds), from its current
    static inputs: the phase stamps and the program's span that its read
    notes on the open span, in the run of ``reps`` whose span is least."""
    from rome_tpu_torch.utils.profiling import annotate

    runs = []
    for _ in range(reps):
        with annotate("chip_smoke.program") as span:
            program.run()
            program.read([])  # the run's stamps and launch counters, as a solve's read
        runs.append(({k: v / 1e6 for k, v in span.attrs["device_ns"].items()},
                     span.attrs["program_device_ns"] / 1e6))
    return min(runs, key=lambda r: r[1])


def fused_program_path(card, device="cuda", g2o=CITYGRID, gt_file=CITYGRID_GT, turns=FUSED_TURNS):
    """Phase 5d, fused_program: citygrid under ``big`` on the cached solver
    phase 5 used and its own graph (its LM program, chordal stages inside,
    captured by phase 5's cold solve), ``ParametricSolver.solve`` in turns
    as the captured program and as its eager runner (the plain version: the
    same bodies, each guard read on the host). Gates: every solve converged
    under bench.py's gates (ATE <= 1.0 m, cost <= 1.002 x optimum + 1e-3);
    the captured and the eager solves give the same chordal start, poses
    and final cost bit for bit and the same LM iterations; each solve's K1
    normal launches are its iterations + 1 (counted on the device inside
    the captured program); on the card a warm captured solve makes exactly
    one synchronizing call (``torch.cuda.set_sync_debug_mode``) and
    torch.profiler sees its K1 normal kernels, iterations + 1. Reported:
    seconds per solve, the program's capture (warm-up, capture and
    instantiate seconds, graph nodes: its ``program.capture`` span), the
    program's device time (its %globaltimer span, and its phases' stamps:
    the chordal stages, the first linearize, and the LM iterations' assembly,
    factorization, CG, linearize and update) and each
    mode's device busy share (that time over the mode's solve seconds), per mode
    the host launch calls and device kernels under torch.profiler and the
    synchronizing calls, and those of the cached solver serving another
    graph object of the same connectivity (its slots read to the host to
    find the connectivity's plan, as the JAX package's ``_sym_for_rt``)."""
    import torch

    from rome_tpu_torch import GNOptions
    from rome_tpu_torch.graph.lower import lower
    from rome_tpu_torch.solvers.gauss_newton import ParametricSolver
    from rome_tpu_torch.solvers.linearize import runtime_state

    gt = np.load(gt_file)
    ref_cost = float(gt["final_cost"])
    since = _captures()[0]
    ga = lower(build_graph(g2o), "parametric", dtype=torch.float32, device=device)
    solver = ParametricSolver.cached(ga, GNOptions(**BIG))
    check(solver.fuses_chordal, "citygrid under big: the solver does not fuse the chordal init")
    solver.solve()  # the solver's own graph: captured now unless phase 5 did
    rows, outs = [], {}
    for mode in turns:
        before = _launches()["k1_normal"]
        _sync(device)
        t0 = time.perf_counter()
        values, st = solver.solve(eager=mode == "eager")
        _sync(device)
        dt = time.perf_counter() - t0
        prog = solver.last_program
        pts = values["Pose2"].cpu().numpy()
        ate = ate_values(pts, gt["poses"])
        row = dict(mode=mode, seconds=dt, iterations=st.iterations, reason=st.reason,
                   final_cost=st.final_cost, ate_m=ate,
                   k1_normal=_launches()["k1_normal"] - before)
        rows.append(row)
        outs.setdefault(mode, (prog.chordal_start.clone(), values["Pose2"].clone(), st))
        check(np.isfinite(pts).all() and st.converged, f"fused_program {mode}: {row}")
        check(ate <= ATE_GATE_M, f"fused_program {mode}: ATE {ate} > {ATE_GATE_M}")
        check(st.final_cost <= ref_cost * 1.002 + 1e-3,
              f"fused_program {mode}: cost {st.final_cost} > 1.002 * {ref_cost}")
        check(device != "cuda" or row["k1_normal"] == st.iterations + 1,
              f"fused_program {mode}: K1 normal launches {row['k1_normal']} for "
              f"{st.iterations} iterations")
        print(f"[{card}] fused_program {mode}: " + json.dumps(row))
    (sc, vc, stc), (se, ve, ste) = outs["captured"], outs["eager"]
    same = dict(chordal_start=bool(torch.equal(sc, se)), poses=bool(torch.equal(vc, ve)),
                final_cost=float(stc.final_cost).hex() == float(ste.final_cost).hex(),
                iterations=stc.iterations == ste.iterations)
    print(f"[{card}] fused_program captured vs eager, bit for bit: {json.dumps(same)}; "
          f"LM iterations {stc.iterations}, final cost {float(stc.final_cost).hex()}")
    check(all(same.values()), f"fused_program: captured and eager differ: {same}")
    out = dict(rows=rows, same=same, iterations=stc.iterations,
               final_cost_hex=float(stc.final_cost).hex())
    if device != "cuda":
        return out
    prog = solver.last_program.program
    caps = [c for c in _captures(since)[1] if c["name"] == prog.name]
    out["capture"] = caps[0] if caps else None
    out["phase_device_ms"], out["device_ms"] = _program_device_ms(prog)
    secs = {m: min(r["seconds"] for r in rows if r["mode"] == m) for m in ("captured", "eager")}
    out["busy_share"] = {m: out["device_ms"] / 1e3 / secs[m] for m in secs}
    out["profile"] = {m: _profiled_solve(solver, None, m == "eager") for m in secs}
    syncs = {m: _sync_calls(solver, None, m == "eager") for m in secs}
    syncs["captured_other_graph"] = _sync_calls(solver, runtime_state(ga), False)
    out["sync_calls"] = {m: n for m, (n, _sites) in syncs.items()}
    out["sync_sites"] = {m: sites for m, (_n, sites) in syncs.items()}
    print(f"[{card}] fused_program capture: {json.dumps(out['capture'])}; the program's "
          f"device time {out['device_ms']:.3f} ms (%globaltimer stamps; by phase, summed "
          f"over its iterations: {json.dumps(out['phase_device_ms'])}), busy share "
          f"{json.dumps(out['busy_share'])} of the fastest solve of each mode")
    for m in secs:
        print(f"[{card}] fused_program {m} warm solve under torch.profiler: "
              f"{json.dumps(out['profile'][m])}")
    print(f"[{card}] fused_program synchronizing calls a warm solve: "
          f"{json.dumps(out['sync_calls'])}; where: {json.dumps(out['sync_sites'])}")
    check(out["sync_calls"]["captured"] == 1,
          f"fused_program: a warm captured solve made {out['sync_calls']['captured']} "
          f"synchronizing calls, not 1")
    recorded = out["profile"]["captured"]["k1_normal_kernels"]
    check(recorded == stc.iterations + 1,
          f"fused_program: the profiler saw {recorded} K1 normal kernels in a captured "
          f"solve of {stc.iterations} iterations")
    return out

class CholeskyTimer:
    """CUDA-event spans of the 2-D ``torch.linalg.cholesky_ex`` calls (the
    dense solvers' D x D factorizations; the sparse fronts are batched 3-D
    and pass through untimed) while in a ``with`` block."""

    def __init__(self, torch, device):
        self.torch, self.device, self.spans = torch, device, []

    def __enter__(self):
        linalg = self.torch.linalg
        self._real = real = linalg.cholesky_ex
        torch, spans = self.torch, self.spans

        def timed(A, *args, **kwargs):
            if A.dim() != 2 or self.device != "cuda":
                return real(A, *args, **kwargs)
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = real(A, *args, **kwargs)
            e.record()
            spans.append((s, e))
            return out

        linalg.cholesky_ex = timed
        return self

    def __exit__(self, *exc):
        self.torch.linalg.cholesky_ex = self._real

    def take(self):
        """Milliseconds of each timed call since the last take (after a sync)."""
        out = [s.elapsed_time(e) for s, e in self.spans]
        self.spans.clear()
        return out


def takahashi_system_inverse(ga):
    """Pose blocks of the dense f64 inverse of the system the Takahashi path
    factors (the Jacobi-scaled, 1e-8-ridged information matrix, un-scaled
    after), from the library's ``cholesky_inverse``: (n, 3, 3)."""
    import torch

    from rome_tpu_torch.solvers.linearize import (
        dense_normal_eqs, free_vector, linearize_all, tangent_offsets,
    )

    H, _g = dense_normal_eqs(ga, linearize_all(ga, ga.values0), dtype=torch.float64)
    f = free_vector(ga).to(torch.float64)
    d = f / torch.sqrt(torch.clamp(torch.diagonal(H) * f * f, min=1e-12))
    H.mul_(d[:, None]).mul_(d[None, :])
    H.diagonal().add_(f * 1e-8 + (1.0 - f))
    L, info = torch.linalg.cholesky_ex(H)
    check(int(info) == 0, "the Takahashi system is not positive definite")
    del H
    X = torch.cholesky_inverse(L)
    del L
    base, _nD = tangent_offsets(ga)
    idx = base["Pose2"] + torch.arange(ga.counts["Pose2"], device=X.device)[:, None] * 3 \
        + torch.arange(3, device=X.device)[None, :]
    dvar = d[idx]
    return X[idx[:, :, None], idx[:, None, :]] * dvar[:, :, None] * dvar[:, None, :]


def parametric_summary(card, params, param_launches, seconds):
    """One line over parametric_solvers_path's results."""
    d32, cov = params["dense32"], params["covariances"]
    d32_s = ", ".join(f"{r['solve_time_s']:.3f}" for r in d32)
    return (f"[{card}] parametric solvers: {seconds:.1f} s; host schedule "
            f"{params['citygrid_host']['iterations']} LM iterations; dense32 {d32_s} s, "
            f"{[r['iterations'] for r in d32]} iterations; mixed "
            f"{params['mixed']['cost_over_optimum']:.6f} and pcg "
            f"{params['pcg']['cost_over_optimum']:.6f} of the optimum; Takahashi "
            f"{cov['takahashi_warm_s']:.3f} s warm, splu {cov['splu_max_rel_err']:.2e}, its "
            f"system's dense inverse {cov['same_system_dense_max_rel_err']:.2e}; dense "
            f"{cov['dense_s']:.3f} s, splu {cov['dense_splu_max_rel_err']:.2e}; K1 launches "
            f"{param_launches}")


def _k1_counts():
    from rome_tpu_torch.ops import linearize_cuda as K

    return dict(K.LAUNCHES)


def parametric_solvers_path(card, device="cuda", g2o=CITYGRID, gt_file=CITYGRID_GT,
                            max_iters=40):
    """The rest of the parametric solver on the city grid, each sub-path
    with K1's counts set to 0 before it and read after it:

    - citygrid_host: one ``schedule="host"`` ndchol solve (BIG) under
      bench.py's gates, normal >= 1 per LM iteration, lin 0;
    - dense32: ``auto`` must pick dense32 at this size; BIG with
      ``linear="dense32"`` cold and warm under the gates, lin >= 1 per LM
      iteration, normal 0; seconds, iterations, the D x D Cholesky's
      CUDA-event time per iteration and the peak device memory;
    - mixed, pcg: one solve each (``max_iters``), reported and not gated on
      the optimum: finite, and a final cost no higher than the start's;
    - covariances at the host solve's solution: Takahashi cold and warm
      (finite), 32 sampled poses against an f64 ``splu`` solve within 1e-4
      relative, and the dense inverse against Takahashi within 1e-6 of each
      block's largest entry on every pose.

    Returns (result dict, K1 launches per sub-path)."""
    import torch

    from rome_tpu_torch import GNOptions, solve_graph_parametric
    from rome_tpu_torch.graph.lower import lower
    from rome_tpu_torch.solvers.gauss_newton import ParametricSolver, marginal_covariances

    gt = np.load(gt_file)
    ref_cost = float(gt["final_cost"])
    cuda = device == "cuda"
    chol = CholeskyTimer(torch, device)
    out, by_path = {}, {}

    def solve(label, opts, schedule="fused", gate=True):
        fg = build_graph(g2o)
        before = _k1_counts()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        with chol:
            res = solve_graph_parametric(fg, init=False, options=GNOptions(**opts),
                                         chordal_init=True, schedule=schedule, device=device)
            _sync(device)
        wall = time.time() - t0
        st = res["stats"]
        launches = {k: v - before[k] for k, v in _k1_counts().items()}
        pts = np.stack([fg.get_point(l) for l in fg.ls(r"^x\d+$")])
        ate, ate_raw = ate_rmse(fg, gt["poses"])
        chol_ms = chol.take()
        row = dict(run=label, linear=res["linear_solver"], schedule=schedule,
                   iterations=st.iterations, converged=st.converged, reason=st.reason,
                   start_cost=st.history[0]["cost0"] if st.history else None,
                   final_cost=st.final_cost, ref_cost=ref_cost,
                   cost_over_optimum=st.final_cost / ref_cost, ate_rmse_m=ate,
                   ate_raw_m=ate_raw, solve_time_s=res["solve_time_s"], wall_s=wall,
                   k1_launches=launches, cg_iters=[h["cg"] for h in st.history],
                   accepted=[h["accepted"] for h in st.history],
                   cholesky_ms=chol_ms,
                   peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30 if cuda else None)
        print(f"[{card}] parametric {label}: " + json.dumps(row))
        check(pts.shape == (len(gt["poses"]), 3) and np.isfinite(pts).all(),
              f"{label}: poses missing or not finite")
        if gate:
            check(st.converged, f"{label} run did not converge ({st.reason})")
            check(ate <= ATE_GATE_M, f"{label} run ATE {ate} > {ATE_GATE_M}")
            check(st.final_cost <= ref_cost * 1.002 + 1e-3,
                  f"{label} run cost {st.final_cost} > 1.002 * {ref_cost}")
        else:
            # the start cost is an f64 sum, the final one the graph dtype's
            # (f32 here): allow that accumulation's 1e-5 relative
            check(math.isfinite(st.final_cost)
                  and st.final_cost <= row["start_cost"] * (1 + 1e-5),
                  f"{label} run ended above its start cost")
        return fg, row

    # 1. the host-scheduled ndchol loop (the speculative one is main_path's)
    _reset_launches()
    fg_nd, row = solve("citygrid_host", BIG, schedule="host")
    by_path["citygrid_host"] = _k1_counts()
    check(not cuda or (row["k1_launches"]["normal"] >= row["iterations"]
                       and row["k1_launches"]["lin"] == 0),
          f"citygrid_host: K1 launches {row['k1_launches']}")
    out["citygrid_host"] = row

    # 2. dense32, as auto picks it at this size
    ga = lower(build_graph(g2o), device=device)
    auto = ParametricSolver(ga, GNOptions()).linear
    check(auto == "dense32", f"auto picked {auto} at {ga.total_dof} dof")
    del ga
    _reset_launches()
    rows = []
    for label in ("dense32_cold", "dense32_warm"):
        _fg, row = solve(label, dict(BIG, linear="dense32"))
        n = row["iterations"]
        check(not cuda or (row["k1_launches"]["lin"] >= n and row["k1_launches"]["normal"] == 0),
              f"{label}: K1 launches {row['k1_launches']} for {n} iterations")
        check(not cuda or len(row["cholesky_ms"]) == n,
              f"{label}: {len(row['cholesky_ms'])} dense Cholesky calls for {n} iterations")
        rows.append(row)
    by_path["dense32"] = _k1_counts()
    out["dense32"] = rows

    # 3. mixed and pcg, reported against the optimum
    for linear in ("mixed", "pcg"):
        _reset_launches()
        _fg, row = solve(linear, dict(BIG, linear=linear, max_iters=max_iters), gate=False)
        check(not cuda or (row["k1_launches"]["lin"] >= row["iterations"]
                           and row["k1_launches"]["normal"] == 0),
              f"{linear}: K1 launches {row['k1_launches']}")
        by_path[linear] = _k1_counts()
        out[linear] = row

    # 4. covariances at the ndchol solution
    _reset_launches()
    ga = lower(fg_nd, device=device)
    secs = []
    for _ in range(2):  # cold, warm
        _sync(device)
        t0 = time.time()
        covs = marginal_covariances(ga, ga.values0, method="takahashi")
        _sync(device)
        secs.append(time.time() - t0)
    check(all(bool(torch.isfinite(c).all()) for c in covs.values()),
          "Takahashi covariances not finite")
    tk = covs["Pose2"].double()
    scale = tk.abs().amax(dim=(1, 2)).clamp_min(1e-300)

    def rel(other):  # worst block deviation relative to the block's largest entry
        return float(((other.double() - tk).abs().amax(dim=(1, 2)) / scale).max())

    n_sampled, splu_tk = covariance_crosscheck(ga, covs, "takahashi")
    same = rel(takahashi_system_inverse(ga))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    dense = marginal_covariances(ga, ga.values0, method="dense")
    _sync(device)
    dense_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else None
    _n, splu_dense = covariance_crosscheck(ga, dense, "dense")
    n_poses = ga.counts["Pose2"]
    row = dict(poses=n_poses, takahashi_cold_s=secs[0], takahashi_warm_s=secs[1],
               takahashi_us_per_pose=1e6 * secs[1] / n_poses, sampled_poses=n_sampled,
               splu_max_rel_err=splu_tk, splu_rel_tol=1e-4,
               same_system_dense_max_rel_err=same, same_system_rel_tol=1e-6,
               dense_s=dense_s, dense_peak_memory_gib=peak,
               dense_splu_max_rel_err=splu_dense,
               dense_method_vs_takahashi_max_rel=rel(dense["Pose2"]),
               max_cov_entry=float(scale.max()), k1_launches=_k1_counts())
    print(f"[{card}] parametric covariances: " + json.dumps(row))
    check(splu_tk <= 1e-4, f"Takahashi covariances {splu_tk} from the f64 splu solve (tol 1e-4)")
    check(same <= 1e-6, f"Takahashi covariances {same} from the dense inverse of their "
          "system (tol 1e-6)")
    check(bool(torch.isfinite(dense["Pose2"]).all()) and splu_dense <= 1e-4,
          f"dense covariances {splu_dense} from the f64 splu solve of H + 1e-8 I (tol 1e-4)")
    by_path["covariances"] = _k1_counts()
    out["covariances"] = row
    return out, by_path


def pairwise_inputs(V, N, Nj, d, device, seed=0, circ=None):
    """Seeded Gibbs-score inputs (ref, mu, pts, inv_var) and a circular mask
    (mixed unless given); angles include values at and next to +-pi."""
    import torch

    rng = np.random.default_rng(seed)
    ref = rng.uniform(-np.pi, np.pi, (V, N, d))
    pts = rng.uniform(-np.pi, np.pi, (V, Nj, d))
    ref[..., :2] *= 3.0
    pts[..., :2] *= 3.0
    ref[:, :3, -1] = np.float32(np.pi) - np.float32(1e-6)
    pts[:, :4, -1] = -np.float32(np.pi)
    mu = rng.normal(size=(V, N, d)) * 0.5
    iv = rng.uniform(0.5, 4.0, (V, d))
    if circ is None:
        circ = (np.arange(d) % 2 == 0).astype(np.float32)
    arrs = [torch.as_tensor(a, dtype=torch.float32, device=device).contiguous()
            for a in (ref, mu, pts, iv)]
    return arrs, torch.as_tensor(np.asarray(circ, np.float32), device=device)


def gibbs_work(kernel, V, N, Nj, d, draw):
    """(bytes, flops) a Gibbs-score launch must move and compute: each input
    read once, each output written once; flops per (n, j) pair as the source
    counts them (an FMA is 2, floor, division and log 1 each)."""
    pairs = V * N * Nj
    read = 4 * (2 * V * N * d + V * Nj * d + V * d + (d if kernel == "K3" else 0))
    flops = pairs * (26 if kernel == "K2" else 10 * d + 1)
    if draw:  # + u read, labels written; fmax, two logs, two negations, add, compare
        return read + 4 * pairs + 8 * V * N, flops + 7 * pairs
    return read + 4 * pairs, flops


def device_ms(fns, reps=100, windows=4):
    """Device time per call (ms) of each labelled function: the device
    operations it launched under torch.profiler over ``reps`` calls, their
    mean duration times the operations a call launches (the profiler can
    miss a few of the first operations of a window).

    The profiler can also drop a whole window, so a function whose window
    holds no timed device operation is profiled again, up to ``windows``
    times. If every window is empty, its time per call comes from CUDA
    events over back-to-back calls instead (an upper bound that holds the
    host's launch cost, ``timer`` says so, and its operation count is 0)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for label, fn in fns:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        for _ in range(windows):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            ev = [e for e in prof.events() if e.device_type.name == "CUDA"]
            total_us = sum(e.time_range.end - e.time_range.start for e in ev)
            if ev and total_us > 0:
                break
        if not (ev and total_us > 0):
            print(f"torch.profiler recorded no device operation of {label} in {windows} "
                  f"windows; timing it with CUDA events", file=sys.stderr)
            out[label] = dict(ms=cuda_ms(fn, reps), kernels_per_call=0, recorded_share=0.0,
                              timer="cuda_events")
            continue
        per_call = math.ceil(len(ev) / reps - 1e-9)
        out[label] = dict(ms=total_us / len(ev) * per_call / 1e3, kernels_per_call=per_call,
                          recorded_share=len(ev) / (reps * per_call), timer="torch.profiler")
    return out


def draw_agreement(got, total):
    """Labels of the kernel's draw against the plain draw's scores ``total``
    (rows, Nj): (rows that differ, worst score gap at those rows). Every row
    that differs must be a near-tie: the plain score of the kernel's pick
    within NEAR_TIE * (1 + |max|) of the plain maximum."""
    import torch

    mx, want = total.max(dim=-1)
    differ = torch.nonzero(got != want).flatten()
    if len(differ) == 0:
        return 0, 0.0
    picked = total[differ, got[differ]]
    gap = mx[differ] - picked
    check(bool(((got >= 0) & (got < total.shape[-1])).all()), "draw labels out of range")
    check(bool((gap <= NEAR_TIE * (1.0 + mx[differ].abs())).all()),
          f"draw labels differ beyond a near-tie: gaps {gap.tolist()[:8]}")
    return len(differ), float(gap.max())


def pairwise_phase(card, bytes_per_s):
    """K2 and K3, both epilogues, against their plain versions; then their
    times at the main paths' shapes beside their bounds."""
    import torch

    from rome_tpu_torch.ops import pairwise_cuda as P
    from rome_tpu_torch.ops.pairwise import (
        euclid_gibbs_draw_plain,
        euclid_pairwise_logw_plain,
        se2_gibbs_draw_plain,
        se2_pairwise_logw_plain,
    )
    from rome_tpu_torch.solvers.multimodal.kde import categorical

    worst = {"K2": 0.0, "K3": 0.0}
    rows = {"K2": [0, 0, 0.0], "K3": [0, 0, 0.0]}  # rows, rows that differ, worst gap

    def compare(tag, got, want):
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = bool(torch.isfinite(got).all()) and bool(torch.allclose(got, want, **PAIRWISE_TOL))
        print(f"[{card}] {tag} logw: max_abs_err {err:.3e} max|logw| "
              f"{float(want.abs().max()):.3e} (rtol=atol=2e-5) ok={ok}")
        check(ok and got.shape == want.shape, f"{tag} logw disagrees with its plain version")
        worst[tag[:2]] = max(worst[tag[:2]], err)

    def compare_draw(tag, got, logw, u):
        torch.cuda.synchronize()
        V, N, Nj = u.shape
        check(got.shape == (V, N) and got.dtype == torch.int64, f"{tag} draw misshapen")
        total = (logw + (-torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny))))
                 ).reshape(V * N, Nj)
        differ, gap = draw_agreement(got.reshape(-1), total)
        r = rows[tag[:2]]
        r[0], r[1], r[2] = r[0] + V * N, r[1] + differ, max(r[2], gap)
        print(f"[{card}] {tag} draw: {V * N - differ} of {V * N} labels equal to the plain "
              f"draw, worst near-tie gap {gap:.3e}")

    for V, N, Nj in PAIRWISE_SHAPES:
        u = torch.rand((V, N, Nj), generator=torch.Generator(device="cuda").manual_seed(V + N),
                       device="cuda")
        arrs, _ = pairwise_inputs(V, N, Nj, 3, "cuda", seed=V + N)
        logw = se2_pairwise_logw_plain(*arrs)
        compare(f"K2 V={V} N={N} Nj={Nj}", P.se2_pairwise_logw(*arrs), logw)
        compare_draw(f"K2 V={V} N={N} Nj={Nj}", P.se2_gibbs_draw(*arrs, u), logw, u)
        k3_cases = ([(d, None) for d in K3_DOFS] + [(2, m) for m in POLAR_MASKS]
                    + [(4, DYNPOINT2_MASK)])
        for d, mask in k3_cases:
            arrs, circ = pairwise_inputs(V, N, Nj, d, "cuda", seed=V + N + d, circ=mask)
            tag = f"K3 dof={d}{'' if mask is None else f' mask={list(mask)}'} V={V} N={N} Nj={Nj}"
            logw = euclid_pairwise_logw_plain(*arrs, circ)
            compare(tag, P.euclid_pairwise_logw(*arrs, circ), logw)
            compare_draw(tag, P.euclid_gibbs_draw(*arrs, circ, u), logw, u)
    for k, (n_rows, differ, gap) in rows.items():
        agree = 1.0 - differ / n_rows
        print(f"[{card}] {k} draw: labels equal on {agree:.6f} of {n_rows} rows "
              f"(gate {LABEL_AGREE})")
        check(agree >= LABEL_AGREE, f"{k} draw labels equal on {agree} < {LABEL_AGREE} of rows")

    # times at the main paths' shapes: (V, 100, 100) with V the beehive-100
    # type counts, and V = 1 (the Gauss-Seidel passes, the loop engine)
    timed = {}
    for name, V, d in TIMED:
        N = Nj = BEEHIVE_N
        circ0 = None if name == "K2" else np.zeros(d, np.float32)  # Point2: linear dims
        arrs, circ = pairwise_inputs(V, N, Nj, d, "cuda", seed=5, circ=circ0)
        u = torch.rand((V, N, Nj), device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(9)
        if name == "K2":
            logw_k = lambda: P.se2_pairwise_logw(*arrs)  # noqa: E731
            draw_u = lambda uu: P.se2_gibbs_draw(*arrs, uu)  # noqa: E731
            logw_p = lambda: se2_pairwise_logw_plain(*arrs)  # noqa: E731
            draw_p = lambda: se2_gibbs_draw_plain(*arrs, u)  # noqa: E731
        else:
            logw_k = lambda: P.euclid_pairwise_logw(*arrs, circ)  # noqa: E731
            draw_u = lambda uu: P.euclid_gibbs_draw(*arrs, circ, uu)  # noqa: E731
            logw_p = lambda: euclid_pairwise_logw_plain(*arrs, circ)  # noqa: E731
            draw_p = lambda: euclid_gibbs_draw_plain(*arrs, circ, u)  # noqa: E731

        def draw_k():
            return draw_u(u)

        def update_before():  # the scores, then categorical()'s 8 kernels
            return categorical(logw_k(), gen)

        def update_now():  # the uniforms, then the draw epilogue
            return draw_u(torch.rand((V, N, Nj), generator=gen, device="cuda"))

        fns = [("logw", logw_k), ("draw", draw_k), ("plain_logw", logw_p),
               ("plain_draw", draw_p), ("update_before", update_before),
               ("update_now", update_now)]
        extra = {}
        if name == "K3":
            # the linear case (every Point2 belief) as one library call
            sq = arrs[3].sqrt()[:, None, :]
            a, b = (arrs[0] + arrs[1]) * sq, arrs[2] * sq

            def library():
                return torch.cdist(a, b, compute_mode="donot_use_mm_for_euclid_dist"
                                   ).square().mul(-0.5)

            extra["library_max_abs_err"] = float((library() - logw_p()).abs().max())
            fns.append(("library", library))
        dev = device_ms(fns)
        # host-call rate: CUDA events over back-to-back calls, in turns
        plain_a, ms_a, ms_b, plain_b = (cuda_ms(f) for f in (draw_p, draw_k, draw_k, draw_p))
        row = {k: v["ms"] for k, v in dev.items()}
        row.update(extra)
        row["kernels_per_call"] = {k: v["kernels_per_call"] for k, v in dev.items()}
        row["timer"] = {k: v["timer"] for k, v in dev.items()}
        row["draw_call_ms"], row["plain_draw_call_ms"] = [ms_a, ms_b], [plain_a, plain_b]
        for epi, draw in (("logw", False), ("draw", True)):
            nbytes, flops = gibbs_work(name, V, N, Nj, d, draw)
            row[f"{epi}_bound_ms"], row[f"{epi}_bound_by"] = bound(nbytes, flops)
            row[f"{epi}_bound_stream_ms"], _ = bound(nbytes, flops, bytes_per_s)
            row[f"{epi}_bytes"], row[f"{epi}_flops"] = nbytes, flops
        timed[(name, V)] = row
        print(f"[{card}] {name} V={V} N=Nj={N} dof={d} device ms per call: "
              + json.dumps({k: row[k] for k in dev})
              + f"; bounds logw {row['logw_bound_ms']:.6f} / draw {row['draw_bound_ms']:.6f} ms "
              f"({row['draw_bound_by']}); draw per host call {ms_a * 1e3:.2f}/{ms_b * 1e3:.2f} "
              f"us, plain {plain_a * 1e3:.2f}/{plain_b * 1e3:.2f} us (CUDA events, 200 calls)")
    return {k: dict(max_abs_err=worst[k], draw_rows=rows[k][0], draw_rows_differ=rows[k][1],
                    draw_max_gap=rows[k][2],
                    timed={f"V={V}": r for (n, V), r in timed.items() if n == k})
            for k in worst}


def beehive_graph(poses=BEEHIVE_POSES):
    from rome_tpu_torch import generate_graph_beehive

    return generate_graph_beehive(pose_count_target=poses, graphinit=False, seed=0)


def beehive_path(card, device="cuda", poses=BEEHIVE_POSES, N=BEEHIVE_N, keep=None):
    """Phase 6 through tools/torch/bench_multimodal's ``beehive_100pose``
    row: three nonparametric solves (cold, warm, warm) of fresh beehive
    graphs, each gated against the parametric optimum, each launching K2's
    and K3's draws 27 times and no logw; the optimum (the dense solver)
    launching K1's lin epilogue only. ``keep``: a list that gets the last
    solved graph and the optimum's graph (phase 25 reads them). Returns the
    row (its runs under ``runs``) and the path's launch counts."""
    _reset_launches()
    since = _LaunchesSince()
    per_solve = BEEHIVE_SWEEPS * GIBBS_SWEEPS * 3  # K = 3 messages per variable
    runs = []

    def on_solve(label, fg):
        n = since()  # the first also holds the optimum's K1 launches
        _check_beliefs(fg, N)
        runs.append(dict(run=label, launches={k: n[k] for k in PAIRWISE_KEYS}))

    row = BM.bench_beehive(device, poses, N, warm=2, on_solve=on_solve, keep=keep)
    pi = row["points_init"]
    for r, secs, err in zip(runs, pi["solve_s_by_run"], pi["err_by_run_m"]):
        r.update(solve_time_s=secs, mean_pose_err_m=err)
        print(f"[{card}] beehive_{poses} {r['run']}: " + json.dumps(r))
        check(err < BEEHIVE_GATE_M, f"{r['run']} run: mean pose error {err} >= {BEEHIVE_GATE_M} m")
        check(device != "cuda" or r["launches"] == dict(
            se2_pairwise_logw=0, euclid_pairwise_logw=0, se2_gibbs_draw=per_solve,
            euclid_gibbs_draw=per_solve),
              f"{r['run']} run: K2/K3 launches {r['launches']}, expected {per_solve} draws each")
    _check_truth_launches(device, row["truth_launches"], "the beehive optimum")
    check(pi["accuracy_ok"], f"beehive row: {pi}")
    row["runs"] = runs
    return row, _launches()


def _sync(device):
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


def _reset_launches():
    from rome_tpu_torch.ops import linearize_cuda as K
    from rome_tpu_torch.ops import pairwise_cuda as P

    for counts in (P.LAUNCHES, K.LAUNCHES):
        for k in counts:
            counts[k] = 0


# K2/K3's launches by epilogue, and K1's as k1_lin / k1_normal
_launches = BK.launches


def _restore_launches(saved):
    """Set every count back to ``saved`` (what ``_launches`` returned)."""
    from rome_tpu_torch.ops import linearize_cuda as K
    from rome_tpu_torch.ops import pairwise_cuda as P

    for k in P.LAUNCHES:
        P.LAUNCHES[k] = saved[k]
    for k in K.LAUNCHES:
        K.LAUNCHES[k] = saved[f"k1_{k}"]


def _check_truth_launches(device, launches, what):
    """A parametric optimum (the dense solver) goes through K1's lin
    epilogue, never its normal one (the ndchol path's): ``launches`` are
    its solve's (``_launches``' keys)."""
    check(device != "cuda" or (launches["k1_lin"] > 0 and launches["k1_normal"] == 0),
          f"{what}: K1 launches {launches}, expected lin > 0 and no normal")


PAIRWISE_KEYS = ("se2_pairwise_logw", "euclid_pairwise_logw", "se2_gibbs_draw",
                 "euclid_gibbs_draw")


class _LaunchesSince:
    """Each call: the launches (``_launches``' keys) made since the last."""

    def __init__(self):
        self.last = _launches()

    def __call__(self):
        now = _launches()
        out, self.last = {k: v - self.last[k] for k, v in now.items()}, now
        return out


def _parametric_truth(fg, device, pose2=True):
    """The port's parametric optimum of a copy of ``fg``: {label: coords}.
    ``pose2``: the graph has Pose2Pose2 factors, whose dense solve launches
    K1's lin epilogue (checked)."""
    from rome_tpu_torch import solve_graph_parametric

    fp = copy.deepcopy(fg)
    fp.init_all()
    before = _launches()
    solve_graph_parametric(fp, init=False, device=device)
    if pose2:
        _check_truth_launches(device, {k: v - before[k] for k, v in _launches().items()},
                              "a parametric optimum")
    return {l: fp.get_coords(l, "parametric") for l in fp._var_order}


def _mean_err(fg, truth, pattern):
    errs = [float(np.linalg.norm(np.asarray(fg.variables[l].beliefs["default"])[:, :2].mean(0)
                                 - truth[l][:2])) for l in fg.ls(pattern)]
    return float(np.mean(errs)), float(np.max(errs))


def _check_beliefs(fg, N):
    for l in fg._var_order:
        bel = np.asarray(fg.variables[l].beliefs["default"])
        check(bel.shape == (N, fg.variables[l].vtype.point_dim) and np.isfinite(bel).all(),
              f"belief of {l} missing, misshapen or not finite")


def _check_launched(device, launches, what):
    """Every Gibbs label update of a path goes through the draw epilogues:
    both draw kernels launched, the logw epilogues never."""
    check(device != "cuda" or (
        launches["se2_gibbs_draw"] > 0 and launches["euclid_gibbs_draw"] > 0
        and launches["se2_pairwise_logw"] == 0 and launches["euclid_pairwise_logw"] == 0),
          f"{what}: K2/K3 launches {launches}, expected both draws > 0 and no logw")


def honeycomb_path(card, device="cuda", steps=HONEYCOMB_STEPS, N=NP_N):
    """Phase 7 through bench_multimodal's ``honeycomb_grow_default`` row: the
    default engine over the honeycomb grow, each Gauss-Seidel pass timed
    with CUDA events (``PhaseTimer``), both draws launched (and no logw) in
    every step, the errors against the optimum under 4 m. Returns the row
    (its steps under ``steps``) and the path's launch counts."""
    import torch

    from rome_tpu_torch.solvers.multimodal.batched import BatchedNonparametricSolver

    timer = PhaseTimer(torch) if device == "cuda" else None
    seen = []
    _reset_launches()
    if timer:
        timer.wrap(BatchedNonparametricSolver, "gs_pass", "gs_pass")

    def on_step(target, fg):
        _sync(device)
        if timer:
            timer.take()
        seen.append((timer.each.get("gs_pass", []) if timer else [None] * 3, fg.num_variables,
                     fg.num_factors, fg))

    try:
        row = BM.bench_honeycomb_grow(device, steps, N, on_step=on_step)
    finally:
        if timer:
            timer.unwrap()
    rows = []
    for target, secs, (gs_seconds, n_vars, n_factors, _fg), n in zip(
            steps, row["solve_s"], seen, row["launches_by_step"]):
        rows.append(dict(poses=target, variables=n_vars, factors=n_factors,
                         solve_time_s=secs, gs_pass_s=gs_seconds, launches=n))
        print(f"[{card}] honeycomb_grow_default {target} poses: " + json.dumps(rows[-1]))
        check(len(gs_seconds) == 3, f"{len(gs_seconds)} Gauss-Seidel passes, expected 3")
        _check_launched(device, n, f"honeycomb step {target}")
    _check_beliefs(seen[-1][-1], N)
    _check_truth_launches(device, row["truth_launches"], "the honeycomb optimum")
    l_err, x_err = row["landmark_err_m"], row["pose_err_m"]
    print(f"[{card}] honeycomb_grow_default errors vs the parametric optimum: landmarks "
          f"{l_err['mean']:.4f} m (max {l_err['max']:.4f}), poses {x_err['mean']:.4f} m "
          f"(max {x_err['max']:.4f})")
    check(row["accuracy_ok"], f"honeycomb grow errors {l_err}, {x_err} not below {GROW_GATE_M} m")
    row["steps"] = rows
    return row, _launches()


def bayes_tree_path(card, device="cuda", steps=TREE_STEPS, N=NP_N):
    """Phase 8 through bench_multimodal's ``bayes_tree_grow`` row: solve_tree
    with clique recycling over the honeycomb grow; the regrow recycles at
    least one clique, every recycled clique's frontal beliefs and points
    keep their bits, the landmark error is under 4 m."""
    last = []
    _reset_launches()
    row = BM.bench_tree_grow(device, steps, N, on_step=lambda target, fg: last.append(fg))
    for r in row["steps"]:
        print(f"[{card}] bayes_tree_grow {r['poses']} poses: " + json.dumps(r))
        check(r["recycled_bit_identical"],
              f"a recycled clique's variable changed across the re-solve at {r['poses']} poses")
    check(row["steps"][-1]["recycled"] >= 1 and row["steps"][-1]["recycled_variables"] >= 1,
          "the regrow recycled no clique")
    _check_beliefs(last[-1], N)
    _check_truth_launches(device, row["truth_launches"], "the tree's optimum")
    print(f"[{card}] bayes_tree_grow landmark error vs the parametric optimum: "
          f"{row['landmark_err_mean_m']:.4f} m (max {row['landmark_err_max_m']:.4f})")
    check(row["accuracy_ok"], f"tree landmark error {row['landmark_err_mean_m']} not below "
          f"{GROW_GATE_M} m")
    launches = _launches()
    _check_launched(device, launches, "bayes_tree_grow")
    return row, launches


def _in_band(fg, N):
    """Per pose, the fewest particles within the x, y and heading bands."""
    from rome_tpu_torch.utils.math import sym_rem_np

    worst = []
    for l in fg.ls(r"^x\d+$"):
        sim, pts = fg.get_ppe(l), np.asarray(fg.variables[l].beliefs["default"])
        worst.append(int(min(np.sum(np.abs(pts[:, 0] - sim[0]) < BAND_M),
                             np.sum(np.abs(pts[:, 1] - sim[1]) < BAND_M),
                             np.sum(np.abs(sym_rem_np(pts[:, 2] - sim[2])) < BAND_RAD))))
    return worst


def hexagonal_path(card, device="cuda", N=NP_N):
    """Phase 9 through bench_multimodal's ``hexagonal_7pose`` row: the
    batched engine twice (first, steady) and the loop engine on the
    hexagonal graph, each in the band and launching both draws (no logw);
    their mean symmetric KL below 1.0."""
    _reset_launches()
    since, solves = _LaunchesSince(), []

    def on_solve(engine, fg):
        n = since()
        _check_beliefs(fg, N)
        band = _in_band(fg, N)
        solves.append(dict(engine=engine, min_in_band=band, launches=n))
        print(f"[{card}] hexagonal_7pose {engine}: " + json.dumps(solves[-1]))
        check(min(band) >= BAND_MIN * N // 100, f"{engine} engine misses the band: {band}")
        _check_launched(device, n, f"hexagonal {engine}")

    row = BM.bench_hexagonal(device, N, on_solve=on_solve)
    row["solves"] = solves
    kl = row["mean_sym_kl_vs_loop"]
    print(f"[{card}] hexagonal_7pose mean symmetric KL batched vs loop: {kl:.4f}; batched "
          f"{row['batched_first_s']:.2f} / {row['batched_steady_s']:.2f} s, loop "
          f"{row['loop_engine_s']:.2f} s")
    check(row["accuracy_ok"], f"loop and batched engines disagree: KL {kl}")
    return row, _launches()


def multihypo_path(card, device="cuda", N=MULTIHYPO_N, solve_N=NP_N):
    """Phase 10: bench_multimodal's ``multihypo_range_bearing`` row
    (approx_conv's mode masses), then a default solve through the
    fallback."""
    from rome_tpu_torch import (MvNormal, Normal, Point2, Pose2Point2BearingRange, PriorPoint2,
                                generate_graph_hexagonal, solve_graph_nonparametric)
    from rome_tpu_torch.solvers.multimodal.batched import BatchedNonparametricSolver

    _reset_launches()
    res = BM.bench_multihypo(device, N)
    check(res["finite"], "multihypo conv not finite")
    check(res["accuracy_ok"], f"multihypo mode masses unbalanced: {res['mode_mass']}")

    fh = generate_graph_hexagonal(N=solve_N)
    fh.add_variable("l2", Point2)
    fh.add_factor(["l2"], PriorPoint2(MvNormal([20.0, 4.0], [0.5, 0.5])))
    fh.add_factor(["x3", "l1", "l2"],
                  Pose2Point2BearingRange(Normal(np.pi, 0.05), Normal(20.0, 0.5)),
                  multihypo=[1.0, 0.5, 0.5])
    fallback = BatchedNonparametricSolver(fh, "default", N=solve_N, device=device).bp.fallback
    check(len(fallback) > 0, "the multihypo factor took no fallback message")
    _sync(device)
    t0 = time.time()
    solve_graph_nonparametric(fh, sweeps=3, N=solve_N, init=True, device=device)
    _sync(device)
    res.update(solve_time_s=time.time() - t0, fallback_messages=len(fallback))
    _check_beliefs(fh, solve_N)
    launches = _launches()
    res["path_launches"] = launches
    print(f"[{card}] multihypo_range_bearing: " + json.dumps(res))
    _check_launched(device, launches, "multihypo")
    return res, launches


# ---------------------------------------------------------------------------
# 3-D: the sphere pose graph (phase 12) and the SE(3) / polar nonparametric
# paths (phase 13)
# ---------------------------------------------------------------------------

def sphere_truth(laps=SPHERE_LAPS, per_lap=SPHERE_PER_LAP, radius=SPHERE_RADIUS_M):
    """(laps * per_lap, 7) true poses (t, w, x, y, z) with the layout of
    g2o's create_sphere example (the sphere2500 dataset): ``laps`` laps of
    ``per_lap`` poses on a sphere of ``radius`` metres, climbing from pole to
    pole (azimuth -pi + 2 pi n / per_lap, elevation -pi/2 + (i + 1) pi / N
    of pose i = lap * per_lap + n); each pose's x-axis along the direction
    of travel and its z-axis pointing out of the sphere."""
    import torch

    from rome_tpu_torch.manifolds import quat as Q

    n_poses = laps * per_lap
    pos = np.empty((n_poses, 3))
    for i in range(n_poses):
        az = -np.pi + 2 * np.pi * (i % per_lap) / per_lap
        el = -0.5 * np.pi + (i + 1) * np.pi / n_poses
        pos[i] = radius * np.array([np.cos(az) * np.cos(el), np.sin(az) * np.cos(el),
                                    -np.sin(el)])
    travel = np.empty_like(pos)
    travel[:-1] = pos[1:] - pos[:-1]
    travel[-1] = travel[-2]
    up = pos / np.linalg.norm(pos, axis=1, keepdims=True)
    x = travel - np.sum(travel * up, axis=1, keepdims=True) * up
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    y = np.cross(up, x)
    R = np.stack([x, y, up], axis=-1)  # columns: x (travel), y, z (out)
    q = Q.qfrom_matrix(torch.as_tensor(R, dtype=torch.float64)).numpy()
    return np.concatenate([pos, q], axis=1)


def sphere_edges(laps=SPHERE_LAPS, per_lap=SPHERE_PER_LAP):
    """Odometry (i - 1, i) for i >= 1, then closures (i - per_lap, i) for
    i >= per_lap: 2,499 + 2,450 = 4,949 edges at 50 x 50."""
    n = laps * per_lap
    return [(i - 1, i) for i in range(1, n)] + [(i - per_lap, i) for i in range(per_lap, n)]


def write_sphere_g2o(path, laps=SPHERE_LAPS, per_lap=SPHERE_PER_LAP, radius=SPHERE_RADIUS_M,
                     sigma_t=SPHERE_SIGMA_T, sigma_r=SPHERE_SIGMA_R, seed=0):
    """Write the sphere graph as g2o text (VERTEX_SE3:QUAT initial values
    chained from the noisy odometry, from the true first pose; then every
    EDGE_SE3:QUAT: the true relative pose with its translation perturbed by
    N(0, sigma_t^2) per axis and its rotation by exp of N(0, sigma_r^2) per
    axis, information diag(1/sigma_t^2 x 3, 1/sigma_r^2 x 3)). Returns the
    true poses."""
    import torch

    from rome_tpu_torch.manifolds import quat as Q
    from rome_tpu_torch.manifolds.base import SE3_

    rng = np.random.default_rng(seed)
    truth = sphere_truth(laps, per_lap, radius)
    edges = sphere_edges(laps, per_lap)
    a = torch.as_tensor(truth[[e[0] for e in edges]])
    b = torch.as_tensor(truth[[e[1] for e in edges]])
    rel = SE3_.compose(SE3_.inverse(a), b)
    t = rel[:, :3] + torch.as_tensor(rng.normal(0, sigma_t, (len(edges), 3)))
    q = Q.qmul(rel[:, 3:], Q.qexp(torch.as_tensor(rng.normal(0, sigma_r, (len(edges), 3)))))
    q = torch.where(q[:, :1] < 0, -q, q)
    meas = torch.cat([t, Q.qnormalize(q)], dim=1).numpy()
    init = [torch.as_tensor(truth[0])]
    for m in torch.as_tensor(meas[: laps * per_lap - 1]):
        init.append(SE3_.compose(init[-1], m))
    info = np.diag([sigma_t ** -2] * 3 + [sigma_r ** -2] * 3)
    info_s = " ".join(repr(float(info[i, j])) for i in range(6) for j in range(i, 6))

    def qline(v):  # t, then the file's quaternion order (qx, qy, qz, qw)
        return " ".join(repr(float(x)) for x in (*v[:3], v[4], v[5], v[6], v[3]))

    with open(path, "w") as fh:
        for i, v in enumerate(init):
            fh.write(f"VERTEX_SE3:QUAT {i} {qline(v.numpy())}\n")
        for (i, j), m in zip(edges, meas):
            fh.write(f"EDGE_SE3:QUAT {i} {j} {qline(m)} {info_s}\n")
    return truth


def build_sphere_graph(path):
    """load_g2o of the sphere file, with a PriorPose3 on x0 at its start
    value (bench.py:83-92 anchors x0 the same way), of SPHERE_PRIOR_SIGMAS."""
    import torch

    from rome_tpu_torch import MvNormal, PriorPose3, load_g2o
    from rome_tpu_torch.manifolds.base import SE3_

    fg = load_g2o(None, path)
    x0 = SE3_.log(torch.as_tensor(fg.get_point("x0"))).numpy()
    fg.add_factor(["x0"], PriorPose3(MvNormal(x0, SPHERE_PRIOR_SIGMAS)), graphinit=False)
    return fg


def ate_se3(fg, ref):
    """ATE RMSE of the 3-D positions after SE(3) alignment (Kabsch) to
    ``ref`` (n, >= 3) rows by pose index."""
    E = np.stack([fg.get_point(f"x{i}")[:3] for i in range(len(ref))])
    G = np.asarray(ref)[:, :3]
    Ec, Gc = E - E.mean(0), G - G.mean(0)
    U, _s, Vt = np.linalg.svd(Gc.T @ Ec)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    Ea = Ec @ (U @ D @ Vt).T + G.mean(0)
    return float(np.sqrt(np.mean(np.sum((Ea - G) ** 2, axis=1))))


def sphere_path(card, device="cuda", laps=SPHERE_LAPS, per_lap=SPHERE_PER_LAP,
                warm=SPHERE_WARM, seed=0):
    """Phase 12: the sphere graph through load_g2o and solve_graph_parametric
    on ``device``: ndchol with the ``big`` options once cold and ``warm``
    times warm, and the dense f64 solve as the reference optimum, under the
    gates. Returns (result, K1 launches)."""
    import tempfile

    import torch

    from rome_tpu_torch import GNOptions, solve_graph_parametric

    _reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sphere.g2o")
        t0 = time.time()
        truth = write_sphere_g2o(path, laps, per_lap, seed=seed)
        gen_s = time.time() - t0
        t0 = time.time()
        fg_ref = build_sphere_graph(path)
        load_s = time.time() - t0
        n = laps * per_lap
        edge_len = float(np.median([np.linalg.norm(fg_ref.factors[fl].params["z"][:3])
                                    for fl in fg_ref._fct_order[: n - 1]]))
        gate = SPHERE_ATE_FRACTION * edge_len
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        _sync(device)
        t0 = time.time()
        res = solve_graph_parametric(fg_ref, init=False, options=GNOptions(**SPHERE_DENSE),
                                     dtype=torch.float64, device=device)
        _sync(device)
        st = res["stats"]
        ref_pts = np.stack([fg_ref.get_point(f"x{i}") for i in range(n)])
        ref_truth_ate = ate_se3(fg_ref, truth)
        dense = dict(iterations=st.iterations, converged=st.converged, reason=st.reason,
                     final_cost=st.final_cost, wall_s=time.time() - t0,
                     solve_time_s=res["solve_time_s"], truth_ate_m=ref_truth_ate,
                     peak_device_gib=(torch.cuda.max_memory_allocated() / 2**30
                                      if device == "cuda" else None))
        print(f"[{card}] sphere_se3_2500 dense f64 reference: " + json.dumps(dense))
        check(st.converged and np.isfinite(ref_pts).all(), "the dense reference did not converge")
        check(ref_truth_ate <= gate,
              f"the dense optimum is {ref_truth_ate} m from the truth, gate {gate} m")
        runs = []
        for label in ["cold"] + ["warm"] * warm:
            fg = build_sphere_graph(path)
            if device == "cuda":
                torch.cuda.reset_peak_memory_stats()
            _sync(device)
            t0 = time.time()
            res = solve_graph_parametric(fg, init=False, options=GNOptions(**BIG),
                                         device=device)
            _sync(device)
            wall = time.time() - t0
            st = res["stats"]
            pts = np.stack([fg.get_point(f"x{i}") for i in range(n)])
            row = dict(run=label, iterations=st.iterations, converged=st.converged,
                       reason=st.reason, final_cost=st.final_cost, ref_cost=dense["final_cost"],
                       ate_to_optimum_m=ate_se3(fg, ref_pts), truth_ate_m=ate_se3(fg, truth),
                       solve_time_s=res["solve_time_s"], wall_s=wall,
                       poses_per_s=n / res["solve_time_s"],
                       peak_device_gib=(torch.cuda.max_memory_allocated() / 2**30
                                        if device == "cuda" else None))
            runs.append(row)
            print(f"[{card}] sphere_se3_2500 ndchol {label}: " + json.dumps(row))
            check(pts.shape == (n, 7) and np.isfinite(pts).all(), "poses missing or not finite")
            check(st.converged, f"{label} run did not converge ({st.reason})")
            check(st.final_cost <= dense["final_cost"] * 1.002 + 1e-3,
                  f"{label} run cost {st.final_cost} > 1.002 * {dense['final_cost']}")
            check(row["ate_to_optimum_m"] <= gate,
                  f"{label} run ATE to the optimum {row['ate_to_optimum_m']} > {gate} m")
    launches = _launches()
    # no Pose2Pose2 batch: K1 is not on this path
    check(device != "cuda" or (launches["k1_lin"] == 0 and launches["k1_normal"] == 0),
          f"the sphere path launched K1: {launches}")
    return dict(poses=n, edges=len(fg_ref.factors) - 1, median_edge_m=edge_len, ate_gate_m=gate,
                generate_s=gen_s, load_s=load_s, dense=dense, runs=runs), launches


# testPose3Pose3NH.jl:118's fixture and its masses (bench_multimodal.py:297-345)
nullhypo_pose3_graph, nullhypo_masses = BM.nullhypo_graph, BM.nullhypo_masses


def se3_hexagon_graph():
    """Six Pose3 on a 10 m hexagon: PriorPose3 on x0, five odometry edges
    of 10 m and a 60 degree yaw step, and the closure x5 -> x0; sigmas
    0.1 m and 0.01 rad."""
    from rome_tpu_torch import FactorGraph, MvNormal, Pose3, Pose3Pose3, PriorPose3

    fg = FactorGraph()
    fg.params.graphinit = False
    for i in range(6):
        fg.add_variable(f"x{i}", Pose3)
    fg.add_factor(["x0"], PriorPose3(MvNormal(np.zeros(6), [0.1] * 3 + [0.01] * 3)))
    z = MvNormal([10.0, 0, 0, 0, 0, np.pi / 3], [0.1] * 3 + [0.01] * 3)
    for i in range(6):
        fg.add_factor([f"x{i}", f"x{(i + 1) % 6}"], Pose3Pose3(z))
    return fg


def polar_chain_graph():
    """A Polar prior and three PolarPolar offsets (range m, angle rad)."""
    from rome_tpu_torch import FactorGraph, Normal, Polar, PolarPolar, PriorPolar

    fg = FactorGraph()
    fg.params.graphinit = False
    for i in range(4):
        fg.add_variable(f"p{i}", Polar)
    fg.add_factor(["p0"], PriorPolar(Normal(5.0, 0.1), Normal(0.3, 0.05)))
    for i in range(3):
        fg.add_factor([f"p{i}", f"p{i + 1}"], PolarPolar(Normal(1.0, 0.1), Normal(0.4, 0.05)))
    return fg


def se3_nonparametric_path(card, device="cuda", N=NP_N, nullhypo_N=NULLHYPO_N):
    """Phase 13: (a) approx_conv of the Pose3 nullhypo fixture (mass gates);
    (b) the batched default-engine solve of the Pose3 hexagon, whose Gibbs
    products take the generic score (no K2/K3 launch); (c) the same solve of
    the Polar chain, whose products take K3's draw. Returns (result,
    launches of (b) + (c))."""
    from rome_tpu_torch import solve_graph_nonparametric

    out = {"nullhypo": BM.bench_nullhypo(device, nullhypo_N)}
    print(f"[{card}] se3_nonparametric nullhypo: " + json.dumps(out["nullhypo"]))
    check(out["nullhypo"]["finite"], "nullhypo conv not finite")
    check(out["nullhypo"]["accuracy_ok"],
          f"nullhypo masses {out['nullhypo']['mass_at_measurement_by_call']} at the measurement, "
          f"{out['nullhypo']['mass_spread_by_call']} spread")

    launches = {}
    for name, build, cols, gate in (("se3_hexagon", se3_hexagon_graph, (slice(0, 3),), 1.0),
                                    ("polar_chain", polar_chain_graph,
                                     (slice(0, 1), slice(1, 2)), 0.5)):
        fg = build()
        truth = _parametric_truth(fg, device, pose2=False)
        _reset_launches()
        _sync(device)
        t0 = time.time()
        solve_graph_nonparametric(fg, sweeps=3, N=N, engine="batched", init=True, device=device)
        _sync(device)
        wall = time.time() - t0
        launches[name] = _launches()
        _check_beliefs(fg, N)
        errs = []
        for c in cols:
            e = [float(np.linalg.norm(np.asarray(fg.variables[l].points["default"])[c]
                                      - truth[l][c])) for l in fg._var_order]
            errs.append(float(np.mean(e)))
        out[name] = dict(solve_time_s=wall, mean_err=errs, launches=launches[name])
        print(f"[{card}] se3_nonparametric {name}: " + json.dumps(out[name]))
        check(max(errs) < gate, f"{name}: mean errors {errs} not below {gate}")
        check(device != "cuda" or (launches[name]["se2_pairwise_logw"] == 0
                                   and launches[name]["euclid_pairwise_logw"] == 0),
              f"{name}: a logw epilogue launched: {launches[name]}")
    return out, launches


# --- phase 14: imu_euroc_mh01 ---------------------------------------------------

def imu_stream_args(keyframes=IMU_KEYFRAMES, seed=IMU_SEED):
    """Keyword arguments of ``generate_field_inertial_measurement`` for the
    synthetic ADIS16448 stream of ``keyframes - 1`` keyframe gaps (20
    samples each at 200 Hz)."""
    return dict(dt=IMU_DT, N=(keyframes - 1) * IMU_SAMPLES, rate=IMU_RATE, accel0=IMU_GRAVITY,
                b_a=IMU_BIAS_A, sigma_a=IMU_SIGMA_A, sigma_w=IMU_SIGMA_W, seed=seed)


def imu_stream(keyframes=IMU_KEYFRAMES, seed=IMU_SEED):
    """The synthetic stream from the port's ``inertial_sim``."""
    from rome_tpu_torch.canonical import inertial_sim

    return inertial_sim.generate_field_inertial_measurement(**imu_stream_args(keyframes, seed))


def imu_truth(keyframes=IMU_KEYFRAMES):
    """(keyframes, 10) closed-form RotVelPos truth [q, v, p] at t_k = k / 10 s:
    R = Exp(rate t), v = v0, p = v0 t (the world acceleration is zero)."""
    t = np.arange(keyframes) * IMU_SAMPLES * IMU_DT
    phi = np.outer(t, IMU_RATE)
    th = np.linalg.norm(phi, axis=1, keepdims=True)
    axis = np.divide(phi, th, out=np.zeros_like(phi), where=th > 0)
    q = np.concatenate([np.cos(th / 2), np.sin(th / 2) * axis], axis=1)
    v = np.tile(IMU_V0, (keyframes, 1))
    return np.concatenate([q, v, np.outer(t, IMU_V0)], axis=1)


def _rvp_coords(row):
    """RotVelPos tangent coords [theta, v, p] of a truth row."""
    q = row[:4]
    s = np.linalg.norm(q[1:])
    theta = 2 * np.arctan2(s, q[0]) * (q[1:] / s if s > 0 else np.zeros(3))
    return np.concatenate([theta, row[4:7], row[7:10]])


def imu_graph(mod, keyframes=IMU_KEYFRAMES, window=IMU_WINDOW, fix_every=IMU_FIX_EVERY,
              kind="bias", stream=None):
    """The inertial keyframe graph of package ``mod`` (rome_tpu_torch, or the
    JAX package in the parity tests, which pass its own simulator's stream)
    over ``stream`` (default ``imu_stream``, the port's): ``keyframes``
    RotVelPos states at 10 Hz, a tight PriorRotVelPos on x0 at the truth, a
    PriorRotVelPos position fix on every ``fix_every``-th state (sigma 1
    rad, 1 m/s, 0.05 m; truth position plus seeded noise), and between
    consecutive keyframes, by ``kind``:

    - "bias": IMUDeltaFactor(signature="RotVelPosBias") with one IMUBias per
      ``window`` keyframe gaps (PriorIMUBias, zero mean, IMU_BIAS_SIGMAS);
    - "rvp": IMUDeltaFactor(signature="RotVelPos"), no bias variable: the
      accelerometer bias is taken as calibrated (the factor's ``a_b``);
    - "ode": InertialDynamic over the same samples less the accelerometer
      bias, weighted by the preintegrated covariance of those samples;
    - "p3vp": IMUDeltaFactor(signature="Pose3VelPos3") on Pose3 + VelPos3
      states (PriorPose3 + PriorVelPos3 in place of each PriorRotVelPos),
      started from the "rvp" graph's dead reckoning.

    Factors are added in time order, so graphinit dead-reckons every state
    from x0 (the "bias" and "rvp" initializer; the ODE's forward flow).
    Returns (graph, seconds spent building it)."""
    t0 = time.time()
    if stream is None:
        stream = imu_stream(keyframes)
    truth = imu_truth(keyframes)
    rng = np.random.default_rng(IMU_FIX_SEED)
    fixes = list(range(fix_every, keyframes, fix_every))
    fix_noise = rng.normal(0, IMU_FIX_SIGMAS[-1], (len(fixes), 3))
    fg = mod.FactorGraph()
    p3vp = kind == "p3vp"
    for k in range(keyframes):
        ts = k * IMU_SAMPLES * int(IMU_DT * 1e9)
        if p3vp:
            fg.add_variable(f"p{k}", mod.Pose3, timestamp_ns=ts)
            fg.add_variable(f"u{k}", mod.VelPos3, timestamp_ns=ts)
        else:
            fg.add_variable(f"x{k}", mod.RotVelPos, timestamp_ns=ts)

    def prior(k, z, sigmas):
        if not p3vp:
            fg.add_factor([f"x{k}"], mod.PriorRotVelPos(mod.MvNormal(z, sigmas)))
            return
        fg.add_factor([f"p{k}"], mod.PriorPose3(mod.MvNormal(
            np.concatenate([z[6:9], z[0:3]]), list(sigmas[6:9]) + list(sigmas[0:3]))))
        fg.add_factor([f"u{k}"], mod.PriorVelPos3(mod.MvNormal(z[3:9], sigmas[3:9])))

    prior(0, _rvp_coords(truth[0]), IMU_X0_SIGMAS)
    n_bias = -(-(keyframes - 1) // window)
    if kind == "bias":
        for w in range(n_bias):
            fg.add_variable(f"b{w}", mod.IMUBias)
            fg.add_factor([f"b{w}"], mod.PriorIMUBias(mod.MvNormal(np.zeros(6), IMU_BIAS_SIGMAS)))
    dts = np.full(IMU_SAMPLES, IMU_DT)
    for k in range(keyframes - 1):
        s = slice(k * IMU_SAMPLES, (k + 1) * IMU_SAMPLES)
        acc, gyr = stream.accels[s], stream.gyros[s]
        # without a bias variable the accelerometer bias is taken as
        # calibrated: the preintegration's bias point, the ODE's samples
        a_b = (0.0, 0.0, 0.0) if kind == "bias" else IMU_BIAS_A
        if kind == "ode":
            # weighted as the preintegrated factor over the same samples
            # (its [rho, nu, theta] covariance in the ODE residual's
            # [theta, v, p] order)
            S = mod.IMUDeltaFactor(acc, gyr, dts, stream.Sigma_y, a_b=a_b).dists[0].cov()
            S = S[np.ix_(ODE_ORDER, ODE_ORDER)]
            t_k = k * IMU_SAMPLES * IMU_DT
            fac = mod.InertialDynamic((t_k, t_k + IMU_SAMPLES * IMU_DT), IMU_DT, gyr,
                                      acc - np.asarray(a_b), mod.MvNormal(np.zeros(9), S))
            fg.add_factor([f"x{k}", f"x{k + 1}"], fac)
            continue
        sig = {"bias": "RotVelPosBias", "rvp": "RotVelPos", "p3vp": "Pose3VelPos3"}[kind]
        fac = mod.IMUDeltaFactor(acc, gyr, dts, stream.Sigma_y, a_b=a_b, signature=sig)
        if kind == "bias":
            fg.add_factor([f"x{k}", f"x{k + 1}", f"b{k // window}"], fac)
        elif kind == "rvp":
            fg.add_factor([f"x{k}", f"x{k + 1}"], fac)
        else:
            fg.add_factor([f"p{k}", f"u{k}", f"p{k + 1}", f"u{k + 1}"], fac)
    for k, noise in zip(fixes, fix_noise):
        z = _rvp_coords(truth[k])
        z[6:9] += noise
        prior(k, z, IMU_FIX_SIGMAS)
    if p3vp:
        dr, _ = imu_graph(mod, keyframes, window, fix_every, "rvp", stream)
        for k in range(keyframes):
            x = dr.get_point(f"x{k}")
            fg.set_point(f"p{k}", np.concatenate([x[7:10], x[:4]]))
            fg.set_point(f"u{k}", x[4:10])
    return fg, time.time() - t0


def imu_positions(fg, keyframes):
    """(keyframes, 3) solved positions of either variable split."""
    if "x0" in fg.variables:
        return np.stack([fg.get_point(f"x{k}")[7:10] for k in range(keyframes)])
    return np.stack([fg.get_point(f"p{k}")[:3] for k in range(keyframes)])


def _rmse(a, b):
    return float(np.sqrt(np.mean(np.sum((np.asarray(a) - np.asarray(b)) ** 2, axis=1))))


def _bias_estimates(fg):
    return np.stack([fg.get_point(l) for l in fg._var_order if l.startswith("b")])


class LinearizeTimer(PhaseTimer):
    """CUDA-event spans of the solver's linearize passes (the generic
    ``vmap(jacfwd)`` linearize of every batch, K1's normal epilogue where a
    Pose2Pose2 batch is served): ``linearize_all_mixed_j`` (ndchol) and
    ``linearize_all`` (the dense solver). The ndchol LM program's replays
    make no Python call: its solves time only the eager calls (a cold
    solve's warm-up), and ``per_call_ms`` is None where none was made."""

    def __init__(self, torch, device):
        super().__init__(torch)
        from rome_tpu_torch.solvers import gauss_newton as GN

        if device == "cuda":
            self.wrap(GN, "linearize_all_mixed_j", "linearize")
            self.wrap(GN, "linearize_all", "linearize")

    def per_iteration(self, device, iterations):
        if device != "cuda":
            return None
        _sync(device)
        secs, calls = self.take()
        n = calls.get("linearize", 0)
        return dict(linearize_s=secs.get("linearize", 0.0), calls=n, iterations=iterations,
                    per_call_ms=1e3 * secs.get("linearize", 0.0) / n if n else None)


def _solve_timed(fg, opts, device, dtype=None):
    """solve_graph_parametric on ``device``; (result, wall seconds, peak GiB)."""
    import torch

    from rome_tpu_torch import solve_graph_parametric

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _sync(device)
    t0 = time.time()
    res = solve_graph_parametric(fg, init=False, options=opts, dtype=dtype, device=device)
    _sync(device)
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else None
    return res, wall, peak


def imu_path(card, device="cuda", keyframes=IMU_KEYFRAMES, window=IMU_WINDOW, warm=IMU_WARM):
    """Phase 14, ``imu_euroc_mh01``: the inertial keyframe graph at EuRoC
    MH_01_easy's length and rates through solve_graph_parametric on
    ``device``: LM with the dense Cholesky in float64 once (the reference
    optimum, whose position RMSE to the truth must be <= IMU_TRUTH_GATE_M),
    then ndchol with the ``big`` options (the dtol stop off, IMU_BIG) once
    cold and ``warm`` times warm,
    each converged, with a cost <= 1.002 * the optimum + 1e-3 and a position
    RMSE to the optimum <= IMU_OPT_GATE_M. K1 is not on this path (no
    Pose2Pose2 batch). Returns (result, launches)."""
    import torch

    import rome_tpu_torch

    _reset_launches()
    fg0, build_s = imu_graph(rome_tpu_torch, keyframes, window)
    truth = imu_truth(keyframes)
    dof = sum(fg0.variables[l].vtype.dof for l in fg0._var_order)
    print(f"[{card}] imu_euroc_mh01: {keyframes} keyframes, {len(fg0.factors)} factors, "
          f"{dof} dof; graph build (preintegration, dead reckoning) {build_s:.2f} s; dead "
          f"reckoning's position RMSE {_rmse(imu_positions(fg0, keyframes), truth[:, 7:10]):.3f} m")
    timer = LinearizeTimer(torch, device)
    try:
        fg = copy.deepcopy(fg0)
        res, wall, peak = _solve_timed(fg, rome_tpu_torch.GNOptions(**SPHERE_DENSE), device,
                                       torch.float64)
        st = res["stats"]
        opt = imu_positions(fg, keyframes)
        dense = dict(iterations=st.iterations, converged=st.converged, reason=st.reason,
                     final_cost=st.final_cost, wall_s=wall, solve_time_s=res["solve_time_s"],
                     truth_rmse_m=_rmse(opt, truth[:, 7:10]), peak_device_gib=peak,
                     bias_a=_bias_estimates(fg)[:, :3].mean(0).tolist(),
                     linearize=timer.per_iteration(device, st.iterations))
        print(f"[{card}] imu_euroc_mh01 dense f64 reference: " + json.dumps(dense))
        check(st.converged and np.isfinite(opt).all(), "the dense reference did not converge")
        check(dense["truth_rmse_m"] <= IMU_TRUTH_GATE_M,
              f"the dense optimum is {dense['truth_rmse_m']} m from the truth, "
              f"gate {IMU_TRUTH_GATE_M} m")
        runs = []
        for label in ["cold"] + ["warm"] * warm:
            fg = copy.deepcopy(fg0)
            res, wall, peak = _solve_timed(fg, rome_tpu_torch.GNOptions(**IMU_BIG), device)
            st = res["stats"]
            pos = imu_positions(fg, keyframes)
            bias = _bias_estimates(fg)
            row = dict(run=label, iterations=st.iterations, converged=st.converged,
                       reason=st.reason, final_cost=st.final_cost, ref_cost=dense["final_cost"],
                       rmse_to_optimum_m=_rmse(pos, opt), truth_rmse_m=_rmse(pos, truth[:, 7:10]),
                       solve_time_s=res["solve_time_s"], wall_s=wall,
                       keyframes_per_s=keyframes / res["solve_time_s"], peak_device_gib=peak,
                       bias_a_mean=bias[:, :3].mean(0).tolist(),
                       bias_a_max_err=float(np.abs(bias[:, :3] - IMU_BIAS_A).max()),
                       linearize=timer.per_iteration(device, st.iterations))
            runs.append(row)
            print(f"[{card}] imu_euroc_mh01 ndchol {label}: " + json.dumps(row))
            check(np.isfinite(pos).all(), "positions not finite")
            check(st.converged, f"{label} run did not converge ({st.reason})")
            check(st.final_cost <= dense["final_cost"] * 1.002 + 1e-3,
                  f"{label} run cost {st.final_cost} > 1.002 * {dense['final_cost']}")
            check(row["rmse_to_optimum_m"] <= IMU_OPT_GATE_M,
                  f"{label} run RMSE to the optimum {row['rmse_to_optimum_m']} > "
                  f"{IMU_OPT_GATE_M} m")
        # the LM path sums in a fixed order: every run takes the same steps
        check(len({(r["iterations"], r["final_cost"]) for r in runs}) == 1,
              "the ndchol runs differ: " + json.dumps(
                  [(r["iterations"], repr(r["final_cost"])) for r in runs]))
    finally:
        timer.unwrap()
    launches = _launches()
    check(device != "cuda" or (launches["k1_lin"] == 0 and launches["k1_normal"] == 0),
          f"the imu path launched K1: {launches}")
    return dict(keyframes=keyframes, factors=len(fg0.factors), dof=dof, build_s=build_s,
                bias_a_truth=list(IMU_BIAS_A), dense=dense, runs=runs), launches


# --- phase 15: factor_library_rest -------------------------------------------------

def dynpoint2_chain_graph(mod, n=DYN_NP_STATES, fix_every=3):
    """A DynPoint2 chain of ``n`` states 1 s apart moving at 1 m/s along x:
    a DynPoint2VelocityPrior at the truth on x0 and on every ``fix_every``-th
    state (sigma 0.3) and constant-velocity DynPoint2DynPoint2 odometry
    (sigma 0.1); ``mod`` is either package."""
    fg = mod.FactorGraph()
    for k in range(n):
        fg.add_variable(f"x{k}", mod.DynPoint2, timestamp_ns=k * 1_000_000_000)
    for k in range(0, n, fix_every):
        fg.add_factor([f"x{k}"], mod.DynPoint2VelocityPrior(mod.MvNormal([k, 0, 1, 0], [0.3] * 4)))
    for k in range(n - 1):
        fg.add_factor([f"x{k}", f"x{k + 1}"],
                      mod.DynPoint2DynPoint2(mod.MvNormal([0, 0, 0, 0], [0.1] * 4)))
    return fg


def dynpose2_chain_graph(mod, n=DYNPOSE2_STATES):
    """tests/test_dyn2d.py:92-121's fixture chained to ``n`` DynPose2 states
    1 s apart: DynPose2VelocityPrior (velocity (10, 0)) on x0 and
    VelPose2VelPose2 odometry (10, 0, 0), so x_k = (10 k, 0, 0, 10, 0)."""
    fg = mod.FactorGraph()
    for k in range(n):
        fg.add_variable(f"x{k}", mod.DynPose2, timestamp_ns=k * 1_000_000_000)
    fg.add_factor(["x0"], mod.DynPose2VelocityPrior(
        mod.MvNormal(np.zeros(3), np.diag([0.01, 0.01, 0.001]) ** 2),
        mod.MvNormal([10.0, 0], np.diag([0.1, 0.1]) ** 2)))
    for k in range(n - 1):
        fg.add_factor([f"x{k}", f"x{k + 1}"], mod.VelPose2VelPose2(
            mod.MvNormal([10.0, 0, 0], np.diag([0.01, 0.01, 0.001]) ** 2),
            mod.MvNormal([0.0, 0], np.diag([0.1, 0.1]) ** 2)))
    return fg


def freefall_chain_graph(mod, n=FREEFALL_STATES, Dt=0.5):
    """tests/test_ext_factors.py:143-188's InertialPose3 free-fall fixture
    chained to ``n`` states: a PriorInertialPose3 on x0 and zero
    preintegrals over Dt, so x_k falls freely from rest."""
    fg = mod.FactorGraph()
    fg.params.graphinit = False
    for k in range(n):
        fg.add_variable(f"x{k}", mod.InertialPose3V)
    fg.add_factor(["x0"], mod.PriorInertialPose3(mod.MvNormal(np.zeros(15), np.eye(15) * 1e-4)))
    for k in range(n - 1):
        fg.add_factor([f"x{k}", f"x{k + 1}"], mod.InertialPose3(
            mod.MvNormal(np.zeros(15), np.eye(15) * 0.01),
            dict(rRp=np.eye(3), rPosp=np.zeros(3), rVelp=np.zeros(3), pBw=np.zeros(3),
                 pBa=np.zeros(3), dt=Dt)))
    return fg


def sonar_graph(mod, landmarks=SONAR_LANDMARKS, seed=3):
    """A DIDSON sonar graph: one Pose3 anchored at the origin and
    ``landmarks`` Point3 each sighted by a LinearRangeBearingElevation
    (range 2-10 m, sigma 0.05 m; bearing within +-0.4 rad, sigma 0.01;
    elevation the reference's uniform prior around 0), each landmark started
    0.5 m off. Returns (graph, the (range, bearing) truth)."""
    rng = np.random.default_rng(seed)
    fg = mod.FactorGraph()
    fg.params.graphinit = False
    fg.add_variable("x0", mod.Pose3)
    fg.add_factor(["x0"], mod.PriorPose3(mod.MvNormal(np.zeros(6), np.eye(6) * 1e-6)))
    rb = np.stack([rng.uniform(2, 10, landmarks), rng.uniform(-0.4, 0.4, landmarks)], axis=1)
    for i, (r, b) in enumerate(rb):
        fg.add_variable(f"l{i}", mod.Point3)
        fg.add_factor(["x0", f"l{i}"], mod.LinearRangeBearingElevation((r, 0.05), (b, 0.01)))
    fg.init_all()
    for i, (r, b) in enumerate(rb):
        fg.set_point(f"l{i}", [r * np.cos(b), r * np.sin(b), 0.0] + rng.normal(0, 0.5 / 3 ** 0.5, 3))
    return fg, rb


def multiple_features_graph(mod):
    """tests/test_sensors.py:49-84: two poses sight three known landmarks;
    returns (graph, the second pose's truth)."""
    lms = {"l1": [5.0, 5.0], "l2": [10.0, 0.0], "l3": [5.0, -5.0]}
    xj_true = np.array([2.0, 1.0, 0.3])

    def ang(pose, lm):
        d = np.asarray(lm) - pose[:2]
        return np.arctan2(d[1], d[0]) - pose[2]

    meas = [ang(np.zeros(3), lms[k]) for k in ("l1", "l2", "l3")] + [
        ang(xj_true, lms[k]) for k in ("l1", "l2", "l3")]
    fg = mod.FactorGraph()
    fg.params.graphinit = False
    fg.add_variable("xi", mod.Pose2)
    fg.add_variable("xj", mod.Pose2)
    for k, v in lms.items():
        fg.add_variable(k, mod.Point2)
        fg.add_factor([k], mod.PriorPoint2(mod.MvNormal(v, np.eye(2) * 1e-6)))
    fg.add_factor(["xi"], mod.PriorPose2(mod.MvNormal(np.zeros(3), np.eye(3) * 1e-6)))
    fg.add_factor(["xi", "xj", "l1", "l2", "l3"],
                  mod.MultipleFeatures2D(*[(m, 0.01) for m in meas]))
    fg.init_all()
    fg.set_point("xj", [1.0, 0.0, 0.0])
    return fg, xj_true


def fluxmix_chain_graph(mod, n):
    """A Pose2 chain of ``n`` poses with MixtureFluxPose2Pose2 odometry
    (tests/test_ext_factors.py:124-140's factor: the NN predicts (1, 0, 0),
    mixed 50/50 with MvNormal((1, 0, 0), 0.01 I)) and a PriorPose2 on x0."""
    nn = mod.build_pose2_odo_nn_01(b3=np.array([1.0, 0.0]))
    fg = mod.FactorGraph()
    for k in range(n):
        fg.add_variable(f"x{k}", mod.Pose2)
    fg.add_factor(["x0"], mod.PriorPose2(mod.MvNormal([0, 0, 0], np.eye(3) * 1e-4)))
    for k in range(n - 1):
        fg.add_factor([f"x{k}", f"x{k + 1}"], mod.MixtureFluxPose2Pose2(
            nn, np.zeros((25, 4)), [mod.MvNormal([1.0, 0, 0], np.eye(3) * 0.01)], (0.5, 0.5),
            DT=1.0))
    return fg


def _np_solve(fg, N, device):
    from rome_tpu_torch import solve_graph_nonparametric

    _sync(device)
    t0 = time.time()
    solve_graph_nonparametric(fg, sweeps=3, N=N, engine="batched", init=True, device=device)
    _sync(device)
    return time.time() - t0


def factor_library_rest_path(card, device="cuda", seconds=REST_SECONDS, N=NP_N,
                             freefall=FREEFALL_STATES, dynpose2=DYNPOSE2_STATES,
                             fluxmix=FLUXMIX_POSES):
    """Phase 15: the rest of the factor library on small graphs, each
    sub-path counting the kernels from 0 (``launches``); see the module
    docstring for the sub-paths and their gates. Returns (result,
    launches by sub-path)."""
    import torch

    import rome_tpu_torch as T
    from rome_tpu_torch.solvers.multimodal import batched as B

    out, launches = {}, {}
    keyframes = int(round(seconds / (IMU_SAMPLES * IMU_DT))) + 1
    truth = imu_truth(keyframes)[:, 7:10]
    stream = imu_stream(keyframes)
    timer = LinearizeTimer(torch, device)
    try:
        pos = {}
        for kind in ("rvp", "ode", "p3vp"):
            _reset_launches()
            fg, build_s = imu_graph(T, keyframes, fix_every=IMU_FIX_EVERY, kind=kind,
                                    stream=stream)
            res, wall, _peak = _solve_timed(fg, T.GNOptions(**REST_OPTS), device, torch.float64)
            st = res["stats"]
            pos[kind] = imu_positions(fg, keyframes)
            row = dict(keyframes=keyframes, build_s=build_s, iterations=st.iterations,
                       converged=st.converged, solve_time_s=res["solve_time_s"], wall_s=wall,
                       truth_rmse_m=_rmse(pos[kind], truth),
                       linearize=timer.per_iteration(device, st.iterations))
            if kind != "rvp":
                row["max_diff_to_imudelta_m"] = float(np.abs(pos[kind] - pos["rvp"]).max())
            name = {"rvp": "imudelta_30s", "ode": "inertial_dynamic_30s",
                    "p3vp": "pose3velpos3_30s"}[kind]
            out[name] = row
            launches[name] = _launches()
            print(f"[{card}] factor_library_rest {name}: " + json.dumps(row))
            check(st.converged and np.isfinite(pos[kind]).all(), f"{name} did not converge")
            check(row["truth_rmse_m"] <= IMU_TRUTH_GATE_M,
                  f"{name}: position RMSE to the truth {row['truth_rmse_m']} > {IMU_TRUTH_GATE_M}")
        # the ODE and preintegration agree (tests/test_ext_factors.py:68-73's
        # 0.02 m over 1 s, scaled to the length); Pose3VelPos3 is the same
        # residual on another variable split
        check(out["inertial_dynamic_30s"]["max_diff_to_imudelta_m"] <= 0.02 * seconds,
              f"ODE and IMUDelta positions differ by {out['inertial_dynamic_30s']}")
        check(out["pose3velpos3_30s"]["max_diff_to_imudelta_m"] <= IMU_OPT_GATE_M,
              f"Pose3VelPos3 and RotVelPos positions differ: {out['pose3velpos3_30s']}")

        def parametric(name, fg, opts, check_fn):
            _reset_launches()
            since = _captures()[0]
            res, wall, _peak = _solve_timed(fg, opts, device)
            st = res["stats"]
            warm = sum(c["warmup_launches"].get("normal", 0) for c in _captures(since)[1])
            row = dict(iterations=st.iterations, converged=st.converged,
                       solve_time_s=res["solve_time_s"], wall_s=wall, **check_fn(fg),
                       linearize=timer.per_iteration(device, st.iterations),
                       warmup_k1_normal=warm)
            out[name], launches[name] = row, _launches()
            print(f"[{card}] factor_library_rest {name}: " + json.dumps(row))
            check(st.converged, f"{name} did not converge ({st.reason})")
            return st

        def freefall_err(fg):
            t = 0.5 * np.arange(freefall)
            x = np.stack([fg.get_coords(f"x{k}") for k in range(freefall)])
            return dict(max_pos_err_m=float(np.abs(x[:, 2] + 0.5 * 9.81 * t ** 2).max()),
                        max_vel_err_mps=float(np.abs(x[:, 8] + 9.81 * t).max()))

        parametric("inertialpose3_freefall", freefall_chain_graph(T, freefall),
                   T.GNOptions(max_iters=200),
                   freefall_err)
        r = out["inertialpose3_freefall"]
        check(r["max_pos_err_m"] <= FREEFALL_TOL and r["max_vel_err_mps"] <= FREEFALL_TOL,
              f"free fall off by {r}")

        def dynpose2_err(fg):
            x = np.stack([fg.get_coords(f"x{k}") for k in range(dynpose2)])
            want = np.stack([[10.0 * k, 0, 0, 10, 0] for k in range(dynpose2)])
            return dict(max_err=float(np.abs(x - want).max()))

        fg = dynpose2_chain_graph(T, dynpose2)
        fg.init_all()
        parametric("dynpose2_chain", fg, T.GNOptions(max_iters=300), dynpose2_err)
        check(out["dynpose2_chain"]["max_err"] <= 0.75, f"DynPose2 chain {out['dynpose2_chain']}")

        fg, rb = sonar_graph(T)

        def sonar_err(fg):
            got = np.stack([fg.get_point(f"l{i}") for i in range(len(rb))])
            want = np.stack([rb[:, 0] * np.cos(rb[:, 1]), rb[:, 0] * np.sin(rb[:, 1]),
                             np.zeros(len(rb))], axis=1)
            return dict(max_err_m=float(np.abs(got - want).max()))

        parametric("sonar_lrbe_50", fg, T.GNOptions(max_iters=200), sonar_err)
        check(out["sonar_lrbe_50"]["max_err_m"] <= 1e-2, f"sonar {out['sonar_lrbe_50']}")

        fg, xj = multiple_features_graph(T)
        parametric("multiple_features_2d", fg, T.GNOptions(max_iters=300),
                   lambda fg: dict(max_err=float(np.abs(fg.get_coords("xj") - xj).max())))
        check(out["multiple_features_2d"]["max_err"] <= 0.05,
              f"MultipleFeatures2D {out['multiple_features_2d']}")

        def chain_err(fg):
            x = np.stack([fg.get_coords(f"x{k}") for k in range(fluxmix)])
            return dict(max_err=float(np.abs(x - np.outer(np.arange(fluxmix), [1.0, 0, 0])).max()))

        st = parametric("fluxmix_chain", fluxmix_chain_graph(T, fluxmix),
                        T.GNOptions(**BIG), chain_err)
        check(out["fluxmix_chain"]["max_err"] <= 1e-3, f"fluxmix chain {out['fluxmix_chain']}")
        l = launches["fluxmix_chain"]
        warm = out["fluxmix_chain"]["warmup_k1_normal"]
        check(device != "cuda" or (l["k1_normal"] == st.iterations + 1 + warm
                                   and l["k1_lin"] == 0),
              f"fluxmix chain: K1 launches {l}, expected normal = {st.iterations} + 1 + the "
              f"program's warm-up {warm}, no lin")
    finally:
        timer.unwrap()

    # nonparametric: the DynPoint2 chain (K3's draw at dof 4) and the
    # mixture chain (K2's draw; its mixture messages take the per-factor
    # fallback, counted through the batched engine's approx_conv)
    fallback = {"calls": 0}
    real_conv = B.approx_conv

    def counted_conv(*a, **kw):
        fallback["calls"] += 1
        return real_conv(*a, **kw)

    for name, build, pose2, cols, gate in (
            ("dynpoint2_chain", lambda: dynpoint2_chain_graph(T), False, slice(0, 2), 0.5),
            ("fluxmix_pose2_chain", lambda: fluxmix_chain_graph(T, FLUXMIX_NP_POSES), True,
             slice(0, 2), 1.0)):
        fg = build()
        truth_np = _parametric_truth(fg, device, pose2=pose2)
        _reset_launches()
        fallback["calls"] = 0
        B.approx_conv = counted_conv
        try:
            wall = _np_solve(fg, N, device)
        finally:
            B.approx_conv = real_conv
        launches[name] = _launches()
        _check_beliefs(fg, N)
        err = float(np.mean([np.linalg.norm(np.asarray(fg.variables[l].points["default"])[cols]
                                            - truth_np[l][cols]) for l in fg._var_order]))
        out[name] = dict(solve_time_s=wall, mean_err=err, fallback_convolutions=fallback["calls"],
                         launches=launches[name])
        print(f"[{card}] factor_library_rest {name}: " + json.dumps(out[name]))
        check(err < gate, f"{name}: mean error {err} not below {gate}")
        check(device != "cuda" or (launches[name]["se2_pairwise_logw"] == 0
                                   and launches[name]["euclid_pairwise_logw"] == 0),
              f"{name}: a logw epilogue launched: {launches[name]}")
    check(out["fluxmix_pose2_chain"]["fallback_convolutions"] > 0
          and out["dynpoint2_chain"]["fallback_convolutions"] == 0,
          "the mixture messages must take the per-factor fallback, the Gaussian ones not")
    return out, launches


# ------------------------- phases 16-18: the front end -------------------------

def se2_root(z, n):
    """The pose whose n-fold composition is z (the group exponential of
    log(z) / n)."""
    th = z[2] / n
    full = z[2]

    def V(t):  # SE(2)'s left Jacobian of the rotation angle t
        if abs(t) < 1e-9:
            return np.eye(2)
        return np.array([[math.sin(t), -(1 - math.cos(t))], [1 - math.cos(t), math.sin(t)]]) / t

    rho = np.linalg.solve(V(full), np.asarray(z[:2], dtype=np.float64))
    t = V(th) @ (rho / n)
    return np.array([t[0], t[1], th])


def edge_cov(tokens):
    """The covariance of an EDGE_SE2 line's information matrix."""
    i11, i12, i13, i22, i23, i33 = (float(v) for v in tokens[6:12])
    info = np.array([[i11, i12, i13], [i12, i22, i23], [i13, i23, i33]])
    return np.linalg.inv(info)


class HostTimer:
    """Host seconds of wrapped functions (perf_counter), summed per name."""

    def __init__(self, owner, names):
        self.owner, self.secs, self._orig = owner, defaultdict(float), {}
        for name in names:
            fn = self._orig[name] = getattr(owner, name)
            setattr(owner, name, self._timed(name, fn))

    def _timed(self, name, fn):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.secs[name] += time.perf_counter() - t0
        return timed

    def take(self):
        out = dict(self.secs)
        self.secs.clear()
        return out

    def unwrap(self):
        for name, fn in self._orig.items():
            setattr(self.owner, name, fn)


def window_check(fg, res, device, workdir, name):
    """The active-window gate: a copy of ``fg`` through save_dfg -> load_dfg
    (the same frozen set), solved in float64 with the dense solver
    (FIXEDLAG_REF) on ``device``. The step's cost must be <= 1.002 x that
    cost + 1e-3 and every free pose within FIXEDLAG_WINDOW_GATE_M of it.
    The reference solve's launches are set apart: the path's counts are the
    same after the check as before it, and the check's own are returned
    under ``launches``."""
    import torch

    from rome_tpu_torch import GNOptions, load_dfg, save_dfg, solve_graph_parametric

    path = save_dfg(fg, os.path.join(workdir, f"{name}.json"))
    ref_fg = load_dfg(path)
    saved = _launches()
    _reset_launches()
    try:
        ref = solve_graph_parametric(ref_fg, init=False, options=GNOptions(**FIXEDLAG_REF),
                                     chordal_init=False, dtype=torch.float64, device=device)
    finally:
        own = _launches()
        _restore_launches(saved)
    cost, ref_cost = float(res["stats"].final_cost), float(ref["stats"].final_cost)
    free = [l for l in fg.ls(r"^x\d+$") if fg.variables[l].solvable != 0]
    err = max(float(np.linalg.norm(fg.get_coords(l)[:2] - ref_fg.get_coords(l)[:2]))
              for l in free)
    out = dict(cost=cost, ref_cost=ref_cost, ref_iterations=int(ref["stats"].iterations),
               ref_reason=ref["stats"].reason, free=len(free), window_err_m=err,
               launches=own)
    check(cost <= 1.002 * ref_cost + 1e-3 and err <= FIXEDLAG_WINDOW_GATE_M,
          f"{name}: cost {cost} against the f64 {ref_cost}, free poses {err} m off")
    return out


def _coords(fg, n):
    return np.stack([fg.get_coords(f"x{i}") for i in range(n)])


def ib_step_line(card, tag, row):
    """One tools/torch/incremental_bench.py row as a line."""
    lower = f" (lower {row['lower_s']:.4f})" if "lower_s" in row else ""
    return (f"[{card}] {tag}: poses {row['n_vars']} frozen {row['frozen']}; LM "
            f"{row['iters']} {row['reason']} {row['solve_s']:.4f} s{lower}; {row['linear']}"
            f"{' built' if row['new_solvers'] else ' cached'}; K1 lin {row['k1_lin']}"
            f"{'' if row['frozen_drift'] == 0.0 else ' DRIFT ' + repr(row['frozen_drift'])}")


def fixedlag_path(card, device="cuda", poses=FIXEDLAG_POSES, incremental=FIXEDLAG_INCREMENTAL,
                  workdir=None):
    """Phase 16, ``fixedlag_citygrid_3500``, through tools/torch/incremental_bench.py's
    ``run``: citygrid's first ``poses`` poses as its time-ordered stream
    (each pose dead-reckoned from its predecessor's estimate, then its
    edges), a fixed-lag solve every 10 poses and after the last
    (``fifo_freeze``, window 25, then the JAX script's solve on ``device``
    in the default dtype), with the frozen-drift gate and every pose outside
    the window frozen on every step and the active-window gate
    (``window_check``) on every 25th solve and the last; the script's own
    gates (one solve per 10 poses, ``max_frozen_drift`` 0.0); then the
    incremental tier (the stream's first ``incremental`` poses, every pose
    free) under citygrid's gates
    against the dense float64 optimum; then the first FIXEDLAG_REPEAT_STEPS
    fixed-lag steps again (the same iterations and poses, bit for bit) and
    the end state against the batch optimum of the same prefix (ndchol,
    BIG), reported. K1 counted per tier from the rows."""
    import torch

    from rome_tpu_torch import GNOptions, solve_graph_parametric
    from rome_tpu_torch.io.g2o import parse_g2o_instruction
    from rome_tpu_torch.solvers import parametric as SP

    workdir = workdir or os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    out, launches, checks, fl_rows = {}, {}, [], []
    t_phase = time.time()
    host = HostTimer(SP, ("lower", "write_back"))

    def on_step(tier, row, fg, res):
        row.update({f"{k}_s": v for k, v in host.take().items()})
        print(ib_step_line(card, f"{tier} x{row['pose']}", row))
        if tier != "fixedlag":
            return
        fl_rows.append(row)
        if len(fl_rows) <= FIXEDLAG_REPEAT_STEPS:
            row["poses_sha256"] = _poses_sha256(fg, row["pose"] + 1)
        check(row["frozen_drift"] == 0.0,
              f"fixedlag x{row['pose']}: a frozen pose moved ({row['frozen_drift']})")
        check(row["frozen"] >= row["pose"] + 1 - FIXEDLAG_WINDOW,
              f"fixedlag x{row['pose']}: {row['frozen']} poses frozen outside the window")
        if len(fl_rows) % FIXEDLAG_CHECK_EVERY == 0 or row["pose"] == poses - 1:
            c = window_check(fg, res, device, workdir, f"fixedlag_{row['pose']}")
            c["pose"] = row["pose"]
            checks.append(c)
            print(f"[{card}] fixedlag x{row['pose']} window check: cost {c['cost']:.6f}, f64 "
                  f"{c['ref_cost']:.6f} ({c['ref_iterations']} it), {c['free']} free poses "
                  f"within {c['window_err_m']:.3e} m")
            host.take()

    _reset_launches()
    try:
        doc, fg, fg_inc = IB.run(device, card, poses=poses, stride=FIXEDLAG_STRIDE,
                                 qfl=FIXEDLAG_WINDOW, incremental=incremental, on_step=on_step,
                                 echo=lambda line: print(f"[{card}] incremental_bench {line}"))
    finally:
        host.unwrap()
    fl, inc = doc["fixedlag_full"], doc["incremental"]
    launches["fixedlag"] = dict(_launches(), k1_lin=fl["k1_lin"], k1_normal=fl["k1_normal"])
    launches["incremental"] = dict(_launches(), k1_lin=inc["k1_lin"], k1_normal=inc["k1_normal"])
    launches["fixedlag_checks"] = {k: sum(c["launches"][k] for c in checks)
                                   for k in launches["fixedlag"]}
    steps = -(-(poses - 1) // FIXEDLAG_STRIDE)
    check(fl["steps"] == len(fl_rows) == steps, f"fixedlag: {fl['steps']} solves, expected {steps}")
    check(fl["max_frozen_drift"] == 0.0 and fl["bit_stable"],
          f"fixedlag: frozen drift {fl['max_frozen_drift']}")
    check(device != "cuda" or fl["k1_lin"] > 0, f"fixedlag: K1 {fl['k1_lin']} lin launches")
    check(_launches()["k1_lin"] == fl["k1_lin"] + inc["k1_lin"],
          f"incremental_bench: K1 lin {_launches()['k1_lin']} launches, its rows' "
          f"{fl['k1_lin'] + inc['k1_lin']}")

    # the incremental tier's last step against the dense float64 optimum
    opt_fg = copy.deepcopy(fg_inc)
    opt = solve_graph_parametric(opt_fg, init=False, options=GNOptions(**FIXEDLAG_REF),
                                 chordal_init=False, dtype=torch.float64, device=device)
    n_inc = len(fg_inc.ls(r"^x\d+$"))
    cost, opt_cost = inc["rows"][-1]["final_cost"], float(opt["stats"].final_cost)
    ate, _raw = ate_rmse(fg_inc, _coords(opt_fg, n_inc))
    lat = inc["steady_step_latency_s"]
    print(f"[{card}] incremental_{incremental}: {inc['steps']} solves in "
          f"{inc['wall_s']:.1f} s, {n_inc} poses; steady median {lat['median']} s, p90 "
          f"{lat['p90']} s; last cost {cost:.6f} against the f64 optimum {opt_cost:.6f}, ATE "
          f"{ate:.4f} m; K1 lin {inc['k1_lin']}")
    check(cost <= 1.002 * opt_cost + 1e-3 and ate <= ATE_GATE_M,
          f"incremental: cost {cost} against {opt_cost}, ATE {ate} m")
    check(device != "cuda" or inc["k1_lin"] > 0, f"incremental: K1 {inc['k1_lin']} lin launches")

    # one answer per input: the first steps again, the same iterations and
    # poses bit for bit
    instructions = IB.stream_instructions(poses)
    first = fl_rows[:FIXEDLAG_REPEAT_STEPS]
    again = []
    IB.run_incremental(instructions[: first[-1]["step"]], FIXEDLAG_STRIDE, True,
                       FIXEDLAG_WINDOW, device,
                       on_step=lambda row, g, res: again.append(
                           (row["pose"], row["iters"], _poses_sha256(g, row["pose"] + 1))))
    same = sum(a == (r["pose"], r["iters"], r["poses_sha256"]) for a, r in zip(again, first))
    out["fixedlag_repeat"] = dict(steps=len(again), same_steps=same,
                                  iterations=[it for _k, it, _h in again])
    print(f"[{card}] fixedlag first {len(again)} steps again: {same} of {len(first)} with the "
          f"same LM iterations and poses bit for bit")
    check(len(again) == len(first) and same == len(first),
          f"fixedlag repeat: {same} of {len(first)} steps the same")

    # the end state against the batch optimum of the same prefix
    _reset_launches()
    batch = IB._mk_fg()
    for ins in instructions:
        parse_g2o_instruction(batch, ins, initialize=True)
    t0 = time.time()
    bres = solve_graph_parametric(batch, init=False, options=GNOptions(**BIG), chordal_init=True,
                                  device=device)
    _sync(device)
    batch_s = time.time() - t0
    launches["fixedlag_batch"] = _launches()
    check(device != "cuda" or launches["fixedlag_batch"]["k1_normal"] > 0,
          f"fixedlag batch optimum: K1 launches {launches['fixedlag_batch']}, expected normal")
    end_ate, end_raw = ate_rmse(fg, _coords(batch, poses))
    lat = fl["steady_step_latency_s"]
    out["incremental_bench"] = doc
    out["fixedlag"] = dict(checks=checks, end_state_ate_vs_batch_m=end_ate,
                           end_state_rmse_vs_batch_m=end_raw,
                           batch=dict(iterations=int(bres["stats"].iterations),
                                      reason=bres["stats"].reason, seconds=batch_s,
                                      final_cost=float(bres["stats"].final_cost)),
                           lower_s=sum(r.get("lower_s", 0.0) for r in fl_rows))
    out["incremental"] = dict(cost=cost, opt_cost=opt_cost, ate_m=ate)
    linear = {k: sum(r["linear"] == k for r in fl_rows) for k in ("dense", "dense32")}
    print(f"[{card}] fixedlag_citygrid_{poses}: {fl['steps']} solves in {fl['wall_s']:.1f} s "
          f"(lowering {out['fixedlag']['lower_s']:.3f} s); steady step median {lat['median']} s, "
          f"p90 {lat['p90']} s over {fl['steps_recycled_solver']} steps on a cached solver; "
          f"{sum(r['reason'] == 'max_iters' for r in fl_rows)} steps at max_iters; linear "
          f"{linear}; {len(checks)} window checks, worst "
          f"{max(c['window_err_m'] for c in checks):.3e} m; end state {end_ate:.4f} m aligned / "
          f"{end_raw:.4f} m raw from the batch optimum (ndchol {bres['stats'].iterations} it, "
          f"{batch_s:.2f} s), {fl['end_state_ate_vs_batch_gt_m']:.4f} m from the whole graph's "
          f"optimum; K1 lin {fl['k1_lin']}")
    out["seconds"] = time.time() - t_phase
    return out, launches


def _poses_sha256(fg, n):
    """SHA-256 of poses x0 .. x{n-1}'s float64 coordinates."""
    import hashlib

    return hashlib.sha256(_coords(fg, n).tobytes()).hexdigest()


def _same_bits(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return a.shape == b.shape and np.array_equal(a.view(np.uint64), b.view(np.uint64))


def graphs_equal(a, b):
    """Every variable's points, solvable and marginalized flags and blob
    entries, and every factor's type, variables, solvable flag and params,
    bit for bit; the first difference, or None."""
    if a._var_order != b._var_order or a._fct_order != b._fct_order:
        return "variable or factor order"
    for l in a._var_order:
        ra, rb = a.variables[l], b.variables[l]
        if (ra.solvable, ra.marginalized, ra.vtype.name) != (rb.solvable, rb.marginalized,
                                                             rb.vtype.name):
            return f"{l}: flags"
        if set(ra.points) != set(rb.points) or any(
                not _same_bits(ra.points[k], rb.points[k]) for k in ra.points):
            return f"{l}: points"
        ea, eb = getattr(ra, "data_entries", {}), getattr(rb, "data_entries", {})
        if {k: e.to_doc() for k, e in ea.items()} != {k: e.to_doc() for k, e in eb.items()}:
            return f"{l}: blob entries"
    for l in a._fct_order:
        fa, fb = a.factors[l], b.factors[l]
        if (fa.ftype.name, fa.variables, fa.solvable) != (fb.ftype.name, fb.variables,
                                                          fb.solvable):
            return f"{l}: type, variables or flag"
        if set(fa.params) != set(fb.params) or any(
                not _same_bits(fa.params[k], fb.params[k]) for k in fa.params):
            return f"{l}: params"
    return None


def live_slam_path(card, device="cuda", poses=LIVE_POSES, workdir=None):
    """Phase 17, ``live_slam_checkpoint``: examples/live_slam.py's loop on
    the citygrid stream's poses 1 .. poses - 1 through the port. A producer
    accumulates each odometry edge in LIVE_TICKS ticks on a
    MutablePose2Pose2Gaussian tether, duplicates it into a standard factor
    (solvable 0, the edge's covariance), stores the raw ticks as a blob
    (FolderStore), adds the pose's loop closures, queues the labels, fires
    the stride trigger (10) and blocks while the solver is behind; the
    manager (``manage_solve_tree``, disengage 25) solves on ``device`` with
    the fixed-lag step's solve, whose exceptions are recorded. Gates: no
    exception, one timing row per solve, frozen drift 0.0 across cycles; after
    the stop, one synchronous solve under ``window_check``; the graph through
    save_dfg (.tar.gz) -> load_dfg equal bit for bit, blobs included; one
    more solve of each within LIVE_RESOLVE_GATE_M of the other."""
    from rome_tpu_torch import load_dfg, save_dfg
    from rome_tpu_torch.factors.pose2 import MutablePose2Pose2Gaussian
    from rome_tpu_torch.frontend.odometry import (
        accumulate_discrete_local_frame,
        duplicate_to_standard_factor_variable,
        reset_factor,
    )
    from rome_tpu_torch.frontend.robot_utils import set_solvable_old_poses
    from rome_tpu_torch.frontend.slam import (
        SLAMWrapperLocal,
        block_progress,
        check_solve_stride_trigger,
        manage_solve_tree,
        stop_manage_solve_tree,
    )
    from rome_tpu_torch.io import parse_g2o_instruction
    from rome_tpu_torch.io.blobstore import FolderStore, add_blob_store, add_data, get_data

    workdir = workdir or os.path.join(HERE, "build", "chip_smoke")
    blobs = os.path.join(workdir, "live_blobs")
    if os.path.isdir(blobs):
        for f in os.listdir(blobs):
            os.remove(os.path.join(blobs, f))
    _reset_launches()
    t_phase = time.time()
    edges = defaultdict(list)  # the stream's EDGE_SE2 tokens by their larger endpoint
    for toks in IB.stream_instructions(poses):
        if toks[0] == "EDGE_SE2":
            edges[max(int(toks[1]), int(toks[2]))].append(toks)
    slam = SLAMWrapperLocal()
    slam.dfg = fg = IB._mk_fg()
    store = add_blob_store(fg, FolderStore("live_ticks", blobs))
    step = IB.StepSolver(device, window=LIVE_DISENGAGE)
    errors = []

    def solve_fn(g):
        try:
            drift = step.frozen.drift(g)
            check(drift == 0.0, f"live: a frozen pose moved between cycles ({drift})")
            row, _res = step(g)
            check(row["frozen_drift"] == 0.0, f"live: a frozen pose moved ({row['frozen_drift']})")
        except BaseException as e:
            errors.append(e)
            raise

    th = manage_solve_tree(slam, disengage_youngest=LIVE_DISENGAGE, solve_fn=solve_fn,
                           device=device)
    drt = MutablePose2Pose2Gaussian()
    reset_factor(drt)
    try:
        for k in range(1, poses):
            odo = next(t for t in edges[k] if (int(t[1]), int(t[2])) == (k - 1, k))
            mean = np.array([float(v) for v in odo[3:6]])
            cov = edge_cov(odo)
            tick = se2_root(mean, LIVE_TICKS)
            for _ in range(LIVE_TICKS):
                accumulate_discrete_local_frame(drt, tick, cov / LIVE_TICKS)
            with slam.lock:
                flbl = duplicate_to_standard_factor_variable(
                    drt, fg, f"x{k - 1}", f"x{k}", solvable=0, graphinit=False, cov=cov)
                add_data(fg, f"x{k}", "odo_ticks", np.tile(tick, (LIVE_TICKS, 1)).tobytes())
                for toks in edges[k]:
                    if toks is not odo:
                        parse_g2o_instruction(fg, toks)
            reset_factor(drt)
            slam.pose_count += 1
            slam.solve_settings.solvables.put([f"x{k}", flbl])
            check_solve_stride_trigger(slam)
            block_progress(slam)
            if slam.errors:
                break
    finally:
        stop_manage_solve_tree(slam)
        th.join(timeout=600)
    check(not th.is_alive(), "live: the solve manager did not stop")
    check(not errors and not slam.errors, f"live: the solve thread raised {errors or slam.errors}")
    check(slam.solve_count >= 1 and len(slam.timing_log) == slam.solve_count == len(step.rows),
          f"live: {slam.solve_count} solves, {len(slam.timing_log)} timing rows, "
          f"{len(step.rows)} recorded")
    loop_s = time.time() - t_phase
    for i, row in enumerate(step.rows):
        print(ib_step_line(card, f"live solve {i + 1}", row))
    launches = {"live_loop": _launches()}
    check(device != "cuda" or launches["live_loop"]["k1_lin"] > 0,
          f"live: K1 launches {launches['live_loop']}, expected lin > 0")

    # what the manager had not engaged yet, then one synchronous solve
    _reset_launches()
    while not slam.solve_settings.solvables.empty():
        item = slam.solve_settings.solvables.get_nowait()
        for lbl in item or ():
            fg.set_solvable(lbl, 1)
    fg.init_all()
    set_solvable_old_poses(fg, youngest=LIVE_DISENGAGE)
    sync_row, res = step(fg)
    check(sync_row["frozen_drift"] == 0.0, "live: the synchronous solve moved a frozen pose")
    wc = window_check(fg, res, device, workdir, "live_window")
    print(f"{ib_step_line(card, 'live synchronous solve', sync_row)}; window "
          f"cost {wc['cost']:.6f} against f64 {wc['ref_cost']:.6f}, within "
          f"{wc['window_err_m']:.3e} m")

    # checkpoint and resume
    t0 = time.time()
    path = save_dfg(fg, os.path.join(workdir, "live_checkpoint.tar.gz"))
    save_s = time.time() - t0
    t0 = time.time()
    fg2 = load_dfg(path)
    load_s = time.time() - t0
    diff = graphs_equal(fg, fg2)
    check(diff is None, f"live: the loaded checkpoint differs ({diff})")
    add_blob_store(fg2, store)
    for k in range(1, poses):
        _e1, a = get_data(fg, f"x{k}", "odo_ticks")
        _e2, b = get_data(fg2, f"x{k}", "odo_ticks")
        check(a == b, f"live: blob of x{k} differs after the reload")
    _row1, r1 = IB.StepSolver(device)(fg)
    _row2, r2 = IB.StepSolver(device)(fg2)
    resolve = float(np.abs(_coords(fg, poses)[:, :2] - _coords(fg2, poses)[:, :2]).max())
    launches["live_resolve"] = _launches()
    launches["live_window_check"] = wc["launches"]
    check(resolve <= LIVE_RESOLVE_GATE_M, f"live: the reloaded graph solves {resolve} m apart")
    size = os.path.getsize(path)
    print(f"[{card}] live_slam_checkpoint: {slam.solve_count} manager solves in {loop_s:.1f} s, "
          f"checkpoint {size} B (.tar.gz) saved in {save_s:.3f} s, loaded in {load_s:.3f} s, "
          f"bit-equal with blobs; re-solves {r1['stats'].iterations} / "
          f"{r2['stats'].iterations} it, {resolve:.3e} m apart; K1 {launches}")
    return dict(rows=step.rows, solves=slam.solve_count, timing_log=slam.timing_log,
                window=wc, checkpoint_bytes=size, save_s=save_s, load_s=load_s,
                resolve_m=resolve, seconds=time.time() - t_phase), launches


def _body_frame(xy, pose):
    """World points (n, 2) in the frame of ``pose`` (x, y, theta)."""
    d = xy - pose[:2]
    c, s = math.cos(pose[2]), math.sin(pose[2])
    return np.stack([c * d[:, 0] + s * d[:, 1], -s * d[:, 0] + c * d[:, 1]], axis=1)


def wheeled_drive(seconds=WHEEL_SECONDS, hz=WHEEL_HZ, trees=WHEEL_TREES, seed=WHEEL_SEED,
                  every=LASER_EVERY):
    """A seeded drive of the ute: (DRS (n, 3) rows [t, raw wheel speed, raw
    steering], {scan: LaserFeatures}, true poses after each sample, tree
    positions). The truth is the Ackermann model of the compensated stream
    itself (navigation.ute_odom_easy); the laser sees every tree within
    WHEEL_RANGE_M ahead (|bearing| < pi / 2) at 5 Hz with sigma 0.1 m and
    0.01 rad."""
    from rome_tpu_torch.frontend.navigation import LaserFeatures, compensate_raw_drs, ute_odom_easy

    rng = np.random.default_rng(seed)
    n = int(seconds * hz)
    t = (np.arange(n) + 1.0) / hz
    speed = np.full(n, 4.0 / 0.94)                         # 4 m/s after the wheel scale
    steer = 0.12 * np.sin(2 * np.pi * t / 25.0) + 0.03 * np.sin(2 * np.pi * t / 7.0)
    DRS = np.stack([t, speed, steer], axis=1)
    poses, x, T0 = [], np.zeros(3), 0.0
    for i in range(n):
        v, a = compensate_raw_drs(DRS[i])
        x = ute_odom_easy(x, v, a, DRS[i, 0] - T0)
        T0 = DRS[i, 0]
        poses.append(x)
    poses = np.asarray(poses)
    # trees beside the path, at least 6 m apart
    tree_xy = []
    for _ in range(1000 * trees):
        if len(tree_xy) == trees:
            break
        p = poses[rng.integers(0, n)]
        side = rng.choice([-1.0, 1.0]) * rng.uniform(5.0, 15.0)
        c = p[:2] + side * np.array([-math.sin(p[2]), math.cos(p[2])]) + rng.normal(0, 2.0, 2)
        if np.min(np.linalg.norm(poses[:, :2] - c, axis=1)) < 3.0:
            continue
        if all(np.linalg.norm(c - q) >= 6.0 for q in tree_xy):
            tree_xy.append(c)
    check(len(tree_xy) == trees, f"the drive has room for {len(tree_xy)} of {trees} trees")
    tree_xy = np.asarray(tree_xy)
    lsr = {}
    for j, i in enumerate(range(0, n, every)):
        body = _body_frame(tree_xy, poses[i])
        rng_m = np.linalg.norm(body, axis=1)
        brg = np.arctan2(body[:, 1], body[:, 0])
        seen = (rng_m <= WHEEL_RANGE_M) & (np.abs(brg) < np.pi / 2)
        z = np.stack([rng_m[seen] + rng.normal(0, WHEEL_SIGMA_R, seen.sum()),
                      brg[seen] + rng.normal(0, WHEEL_SIGMA_B, seen.sum())])
        lsr[j + 1] = LaserFeatures(float(DRS[i, 0]), z)
    return DRS, lsr, poses, tree_xy


def _hom(x):
    c, s = np.cos(x[2]), np.sin(x[2])
    return np.array([[c, -s, x[0]], [s, c, x[1]], [0, 0, 1.0]])


def numpy_dodo(DRS, distrule=20.0, timerule=30.0, yawrule=np.pi / 3, L=2.80381, H=0.828329):
    """The pose triggers of advOdoByRules (NavigationSystem.jl:126-166) in
    plain numpy, written here from the reference (WheeledRobotUtils.jl:86-103:
    the compensated stream, the Ackermann step as a homogeneous SE(2)
    product): {pose id: [x, y, theta, T, rule]} in the frame of the previous
    pose."""
    dodo = {1: np.array([0.0, 0.0, 0.0, 0.0, 0.0])}
    x, T0, Tprev, pid = np.zeros(3), 0.0, 0.0, 1
    for row in DRS:
        dt = row[0] - T0
        v_raw, a_raw = 0.94 * row[1], 1.0199 * row[2] + 0.00159
        v = v_raw / (1.0 - np.tan(a_raw) * H / L)
        M = _hom(x) @ _hom(dt * np.array([v, 0.0, v * np.tan(a_raw) / L]))
        x = np.array([M[0, 2], M[1, 2], np.arctan2(M[1, 0], M[0, 0])])
        rule = 0
        if np.linalg.norm(x[:2]) >= distrule:
            rule = 1
        elif abs((x[2] + np.pi) % (2 * np.pi) - np.pi) >= yawrule:
            rule = 2
        elif row[0] - Tprev > timerule:
            rule = 3
        if rule:
            pid += 1
            dodo[pid] = np.array([x[0], x[1], x[2], row[0], float(rule)])
            Tprev = row[0]
            x = np.zeros(3)
        T0 = row[0]
    return dodo


def wheeled_tracker_path(card, device="cuda", seconds=WHEEL_SECONDS, trees=WHEEL_TREES):
    """Phase 18, ``wheeled_tracker``: ``adv_odo_by_rules`` on a seeded drive
    (``wheeled_drive``) with its trackers on ``device``. Gates: dOdo equal
    to ``numpy_dodo`` at 1e-12; after each scan's updates, every tracker
    updated at least TRACKER_MIN_UPDATES times has a belief mean within
    TRACKER_GATE_M of the nearest true tree in that sample's body frame
    (``process_tree_trackers_updates`` wrapped from here); K3's draw
    launched TRACKER_DRAWS_PER_UPDATE times per update, K2 and every logw
    never."""
    from rome_tpu_torch.frontend import navigation as NAV
    from rome_tpu_torch.frontend import tracker as TR

    DRS, lsr, poses, trees = wheeled_drive(seconds=seconds, trees=trees)
    sample_of = {float(t): i for i, t in enumerate(DRS[:, 0])}
    systems, updates, errs = [], defaultdict(int), []
    make, update = NAV.make_in_situ_system, TR.FeatureTracker.update_feature
    process = NAV.process_tree_trackers_updates

    def make_kept(*a, **kw):  # keep the system the drive builds
        systems.append(make(*a, **kw))
        return systems[-1]

    def update_counted(self, feat, z, s=(0.5, 0.05)):
        updates[feat.id] += 1
        return update(self, feat, z, s)

    def process_checked(sys_, lsr_feats, Ts, b1Dxb, *a, **kw):
        """After each scan's updates: every tracker with enough updates
        against the trees in the true body frame of that sample."""
        scan = sys_.lstlaseridx
        process(sys_, lsr_feats, Ts, b1Dxb, *a, **kw)
        if sys_.lstlaseridx == scan:
            return
        body = _body_frame(trees, poses[sample_of[float(Ts)]])
        for fid, f in sys_.trackers.trackers.items():
            if updates[fid] >= TRACKER_MIN_UPDATES:
                m = f.bel.points.mean(dim=0).cpu().double().numpy()
                errs.append((sys_.lstlaseridx, fid, float(np.min(
                    np.linalg.norm(body - m, axis=1)))))

    NAV.make_in_situ_system, TR.FeatureTracker.update_feature = make_kept, update_counted
    NAV.process_tree_trackers_updates = process_checked
    _reset_launches()
    t0 = time.time()
    try:
        dodo, assoc = NAV.adv_odo_by_rules(DRS, lsr, device=device)
        _sync(device)
    finally:
        NAV.make_in_situ_system, TR.FeatureTracker.update_feature = make, update
        NAV.process_tree_trackers_updates = process
    secs = time.time() - t0
    launches = _launches()
    want = numpy_dodo(DRS)
    check(sorted(dodo) == sorted(want), f"tracker: pose ids {sorted(dodo)} != {sorted(want)}")
    dodo_err = max(float(np.abs(dodo[k] - want[k]).max()) for k in want)
    check(dodo_err <= 1e-12, f"tracker: dOdo {dodo_err} from the numpy integration")
    tr = systems[0].trackers
    n_updates = sum(updates.values())
    draws = (launches["se2_gibbs_draw"], launches["euclid_gibbs_draw"])
    e = np.array([x[2] for x in errs])
    out = dict(seconds=secs, samples=len(DRS), scans=len(lsr), poses=len(dodo),
               trackers_alive=len(tr.trackers), trackers_created=tr.featid,
               updates=n_updates, checks=len(errs), trackers_checked=len({x[1] for x in errs}),
               worst_err_m=float(e.max()) if len(e) else None,
               mean_err_m=float(e.mean()) if len(e) else None,
               dodo_err=dodo_err, launches=launches)
    print(f"[{card}] wheeled_tracker: {len(DRS)} samples, {len(lsr)} scans, {len(dodo)} poses, "
          f"{tr.featid} trackers made, {len(tr.trackers)} alive at the end, {n_updates} "
          f"updates, {secs:.1f} s; {len(errs)} checks after a scan of "
          f"{out['trackers_checked']} trackers with >= {TRACKER_MIN_UPDATES} updates: within "
          f"{out['worst_err_m']} m (mean {out['mean_err_m']}) of a tree; dOdo {dodo_err:.1e}; "
          f"launches {launches}")
    check(len(e) and e.max() <= TRACKER_GATE_M,
          f"tracker: belief means up to {out['worst_err_m']} m from the nearest tree")
    check(device != "cuda" or draws == (0, TRACKER_DRAWS_PER_UPDATE * n_updates),
          f"tracker: K2/K3 draws {draws}, expected (0, {TRACKER_DRAWS_PER_UPDATE} x {n_updates})")
    check(launches["se2_pairwise_logw"] == 0 and launches["euclid_pairwise_logw"] == 0
          and launches["k1_lin"] == 0 and launches["k1_normal"] == 0,
          f"tracker: unexpected launches {launches}")
    return out, launches


# --------------------------------------------------------------------------
# phases 20-22: the distributed solves (slice D), one process per rank
# --------------------------------------------------------------------------

DIST_WORLDS = (1, 4)                       # world 1 over NCCL, 4 over gloo on the one card
SHARDED_MAX_ITERS, SHARDED_PCG_ITERS, SHARDED_LAM0 = 40, 100, 1e-4
VARPART_POSES, VARPART_MAX_ITERS = 10000, 60
SHARDED_KL_GATE = 2.0                      # tests/test_multimodal_sharded.py:48-70
BEEHIVE_SEED = 2024                        # solve_graph_nonparametric's default seed
ALLREDUCE_REPS = 100


def distributed_inputs(card, device="cuda", g2o=CITYGRID, gt_file=CITYGRID_GT,
                       chain_poses=VARPART_POSES, bee_poses=BEEHIVE_POSES, N=BEEHIVE_N):
    """What every rank starts from and what the gates compare with, made once
    on ``device`` in this process: citygrid lowered with phase 5's chordal
    initialisation and the port's single-device ``linear="pcg"`` first step
    from it; the corridor chain and its single-device ndchol optimum; the
    beehive parametric optimum and a single-device batched solve. Launches
    made here are restored: they belong to no path."""
    import torch

    from rome_tpu_torch import GNOptions, solve_graph_nonparametric
    from rome_tpu_torch.graft_entry import _build_chain_fixture
    from rome_tpu_torch.graph.convert import graph_arrays_from_numpy, graph_arrays_to_numpy
    from rome_tpu_torch.graph.lower import lower
    from rome_tpu_torch.solvers.gauss_newton import ParametricSolver
    from rome_tpu_torch.solvers.init2d import chordal_init_pose2
    from rome_tpu_torch.solvers.linearize import cost_at, runtime_state

    saved = _launches()
    t0 = time.time()
    ga = lower(build_graph(g2o), device=device)
    chordal = chordal_init_pose2(ga, ga.values0)
    trial, c0, c1, *_ = ParametricSolver(
        ga, GNOptions(linear="pcg", pcg_iters=SHARDED_PCG_ITERS)).step(
            chordal, np.float32(SHARDED_LAM0), runtime_state(ga))
    city = dict(spec=graph_arrays_to_numpy(ga),
                values={t: v.cpu().numpy() for t, v in chordal.items()},
                first=dict(c0=c0, c1=c1, values={t: v.cpu().numpy() for t, v in trial.items()}),
                gt=np.load(gt_file)["poses"])
    t_city = time.time() - t0

    t0 = time.time()
    spec = graph_arrays_to_numpy(_build_chain_fixture(chain_poses, "local", device=device))
    gc = graph_arrays_from_numpy(**spec, dtype=torch.float64, device=device)
    cost_start = float(cost_at(gc, gc.values0))
    v_ref, st_ref = ParametricSolver(gc, GNOptions(linear="ndchol", max_iters=100,
                                                   lam0=1e-4)).solve()
    check(st_ref.converged, f"chain optimum did not converge ({st_ref.reason})")
    chain = dict(spec=spec, cost_start=cost_start, ref_cost=float(cost_at(gc, v_ref)),
                 ref_iterations=st_ref.iterations)
    t_chain = time.time() - t0

    t0 = time.time()
    truth = _parametric_truth(beehive_graph(bee_poses), device)
    fg = beehive_graph(bee_poses)
    solve_graph_nonparametric(fg, sweeps=BEEHIVE_SWEEPS, N=N, engine="batched", init="points",
                              seed=BEEHIVE_SEED, device=device)
    last = max(int(l[1:]) for l in fg.ls(r"^x\d+$"))
    kl_labels = ("x0", f"x{last // 2}", f"x{last}", "l0")   # x0, x50, x100, l0 at 100 poses
    bee = dict(poses=bee_poses, N=N, truth={l: truth[l] for l in fg.ls(r"^x\d+$")},
               single={l: np.asarray(fg.variables[l].beliefs["default"]) for l in kl_labels})
    _sync(device)
    _restore_launches(saved)
    print(f"[{card}] distributed inputs: citygrid + chordal + pcg step {t_city:.2f} s, "
          f"chain {chain_poses} + ndchol optimum {t_chain:.2f} s ({st_ref.iterations} LM "
          f"iterations, cost {cost_start:.1f} -> {chain['ref_cost']:.6g}), beehive optimum + "
          f"single-device solve {time.time() - t0:.2f} s")
    return dict(city=city, chain=chain, bee=bee)


class PathInputs:
    """The inputs each kernel wrapper is given on the paths of one process
    (a rank of the distributed paths, or the measuring entry points in the
    main process): the first calls at each layout (shapes, dtypes, storage
    offsets) of each path, copied with their whole storage, so that a row
    slice keeps its offset (``_masked_gibbs(rows=...)``'s uniforms, a
    rank's block of a batch). Installed in front of the wrappers (K1's lin
    function, its normal plan's call, the K2/K3 draws) before the paths
    build anything; it calls them unchanged, so the launch counts are
    theirs, and records only while ``path`` is set. ``check`` then holds
    each recorded call's kernel to its plain version on those inputs: the
    paths' own shapes and magnitudes, and the mesh padding (weight-0 rows:
    slots 0, z = 0, S = I) that no synthetic case has."""

    KERNELS = ("lin", "normal", "se2_gibbs_draw", "euclid_gibbs_draw")

    def __init__(self, limit=8):
        from rome_tpu_torch.ops import linearize_cuda as K
        from rome_tpu_torch.ops import pairwise_cuda as P

        self.path, self.calls, self.limit = None, {}, limit
        self.seen = defaultdict(int)  # calls per (path, kernel)
        self.kernels = {"lin": K.pose2pose2_linearize, "normal": K.Pose2Pose2Normal.__call__,
                        "se2_gibbs_draw": P.se2_gibbs_draw,
                        "euclid_gibbs_draw": P.euclid_gibbs_draw}
        lin = self._recording("lin")
        for ftype, fn in K.FUSED_LINEARIZE.items():
            if fn is K.pose2pose2_linearize:
                K.FUSED_LINEARIZE[ftype] = lin
        for name in ("se2_gibbs_draw", "euclid_gibbs_draw"):
            setattr(P, name, self._recording(name))
        normal, record = self.kernels["normal"], self._record

        def recording_normal(plan, values):
            record("normal", (values, *plan.inputs, plan.count))
            return normal(plan, values)

        K.Pose2Pose2Normal.__call__ = recording_normal

    @staticmethod
    def _copy(a):
        import torch

        if not isinstance(a, torch.Tensor):
            return a
        return torch.empty(0, dtype=a.dtype, device=a.device).set_(
            a.untyped_storage().clone(), a.storage_offset(), a.size(), a.stride())

    def _record(self, name, args):
        import torch

        if self.path is None:
            return
        self.seen[(self.path, name)] += 1
        key = (self.path, name) + tuple(
            (tuple(a.shape), str(a.dtype), a.storage_offset())
            if isinstance(a, torch.Tensor) else a for a in args)
        if key not in self.calls and sum(
                k[:2] == key[:2] for k in self.calls) < self.limit:
            self.calls[key] = [self._copy(a) for a in args]

    def _recording(self, name):
        fn = self.kernels[name]

        def recording(*args):
            self._record(name, args)
            return fn(*args)

        return recording

    @staticmethod
    def _row_scale(p, q, z, S, w):
        """Per row: |S| w (|p| + |q| + |z| + 1), the size of the row's terms."""
        return (S.abs().amax(dim=(1, 2)) * w.abs() * (
            p.abs().amax(1) + q.abs().amax(1) + z.abs().amax(1) + 1.0))

    def _check_normal(self, args):
        """K1's normal epilogue on a recorded call (a fresh plan on the same
        inputs) against its plain version: the float64 residual within
        1e-10 + 1e-13 of the row scale, the float32 Jacobians within 2e-5 +
        1e-6 of it (the lin epilogue's bounds), the JᵀJ entries within 1e-5
        of their products' summed magnitudes plus what those Jacobian bounds
        allow a product, the float64 Jᵀr within 1e-9 of the plain
        contraction of the kernel's own J and r. Returns the row fields."""
        import torch

        from rome_tpu_torch.ops import linearize_cuda as K
        from rome_tpu_torch.ops.fused_linearize import pose2pose2_normal_plain
        from rome_tpu_torch.utils.math import einsum

        values, vslots, z, S, w, count = args
        n = vslots.shape[0]
        entries = torch.empty(36 * n, dtype=torch.float32, device=values.device)
        plan = K.Pose2Pose2Normal(vslots, z, S, w, count, entries)
        r, Js, jtr = self.kernels["normal"](plan, values)
        _sync(values.device.type)
        rp, Jps, ep, _jp = pose2pose2_normal_plain(values, vslots, z, S, w)
        p, q = values[vslots[:, 0]], values[vslots[:, 1]]
        scale = self._row_scale(p, q, z.double(), S.double(), w.double())
        tol_J = (2e-5 + 1e-6 * scale).float()
        J_max = torch.stack([J.abs().amax(dim=(1, 2)) for J in Jps]).amax(0)
        terms = torch.stack([einsum("nij,nik->njk", Jps[k].abs(), Jps[l].abs())
                             for k in (0, 1) for l in (0, 1)])
        err = {}
        ok = True
        for key, got, want, tol in (
                ("r", r, rp, (1e-10 + 1e-13 * scale)[:, None]),
                ("J", torch.stack(Js), torch.stack(Jps), tol_J[None, :, None, None]),
                ("entries", entries.view(4, n, 3, 3), ep,
                 1e-5 * terms + 6 * (J_max * tol_J)[None, :, None, None])):
            d = (got - want).abs()
            err[key] = float(d.max()) if d.numel() else 0.0
            ok = ok and bool(torch.isfinite(got).all()) and bool((d <= tol).all())
        own = torch.stack([einsum("nij,ni->nj", J, r) for J in Js])
        err["jtr_rel"] = float((jtr - own).abs().max() / own.abs().max().clamp_min(1e-300)) \
            if n else 0.0
        ok = ok and bool(torch.isfinite(jtr).all()) and err["jtr_rel"] <= 1e-9
        return dict(errors=err, max_abs_err=max(err["J"], err["entries"]),
                    max_row_scale=float(scale.max()) if n else 0.0), ok

    def check(self, card):
        """Every recorded call: K1 lin within the float32 / float64 bound
        below of its plain version and its weight-0 rows exactly 0; a draw's
        labels equal to the plain draw's or near-ties (``draw_agreement``).
        One row per call."""
        import torch

        from rome_tpu_torch.ops.fused_linearize import pose2pose2_linearize_plain
        from rome_tpu_torch.ops.pairwise import (
            euclid_pairwise_logw_plain,
            se2_pairwise_logw_plain,
        )

        out = []
        for key, args in self.calls.items():
            path, name = key[:2]
            row = dict(path=path, kernel=name,
                       shapes=[list(k[0]) for k in key[2:] if isinstance(k, tuple)],
                       offsets=[k[2] for k in key[2:] if isinstance(k, tuple)])
            if name == "normal":
                fields, ok = self._check_normal(args)
                row.update(fields)
                print(f"[{card}] {path} K1 normal n={args[1].shape[0]} table {args[5]} poses: "
                      + json.dumps(fields))
                check(ok, f"{path}: K1 normal disagrees with its plain version on the path's "
                          f"inputs ({row})")
                out.append(row)
                continue
            got = self.kernels[name](*args)
            _sync(args[0].device.type)
            if name == "lin":
                p, q, z, S, w = args
                want = pose2pose2_linearize_plain(*args)
                # float32 keeps eps |pose| in a pose difference, times |S|
                # and w: 2e-5 absolute or 1e-6 of that row scale (float64:
                # 1e-10 or 1e-13)
                scale = self._row_scale(p, q, z, S, w)
                atol, rtol = (2e-5, 1e-6) if p.dtype == torch.float32 else (1e-10, 1e-13)
                pad = w == 0
                err, ok, zero = 0.0, True, True
                for a, b in ((got[0], want[0]), (got[1][0], want[1][0]),
                             (got[1][1], want[1][1])):
                    d = (a - b).abs().reshape(a.shape[0], -1).amax(1)
                    err = max(err, float(d.max()) if d.numel() else 0.0)
                    ok = ok and bool(torch.isfinite(a).all()) and bool(
                        (d <= atol + rtol * scale).all())
                    zero = zero and bool((a[pad] == 0).all())
                row.update(dtype=str(p.dtype)[6:], max_abs_err=err, weight0_rows=int(pad.sum()),
                           max_row_scale=float(scale.max()) if scale.numel() else 0.0)
                print(f"[{card}] {path} K1 lin {row['dtype']} n={p.shape[0]} (offsets "
                      f"{row['offsets']}): max_abs_err {err:.3e} ({atol:g} or {rtol:g} of the "
                      f"row scale, at most {row['max_row_scale']:.3g}); "
                      f"{row['weight0_rows']} weight-0 rows zero={zero}")
                check(ok and zero, f"{path}: K1 lin disagrees with its plain version on "
                                   f"the path's inputs at n={p.shape[0]} ({row})")
            else:
                *sc, u = args
                plain = se2_pairwise_logw_plain if name == "se2_gibbs_draw" \
                    else euclid_pairwise_logw_plain
                V, N, Nj = u.shape
                total = (plain(*sc) + (-torch.log(-torch.log(
                    u.clamp_min(torch.finfo(u.dtype).tiny))))).reshape(V * N, Nj)
                differ, gap = draw_agreement(got.reshape(-1), total)
                row.update(rows=V * N, rows_differ=differ, max_gap=gap)
                print(f"[{card}] {path} {name} V={V} N={N} Nj={Nj} (u at storage offset "
                      f"{u.storage_offset()}): {V * N - differ} of {V * N} labels equal to "
                      f"the plain draw, worst near-tie gap {gap:.3e}")
            out.append(row)
        return out


def _expected_draws(solver, mesh, sweeps):
    """K2 (Pose2) and K3 (Point2) draw launches of this rank's Gibbs
    products: per sweep, gibbs_sweeps x K for each type whose rows it holds
    (K > 1)."""
    from rome_tpu_torch.parallel.multimodal import _block

    out = {"se2_gibbs_draw": 0, "euclid_gibbs_draw": 0}
    bp, ga = solver.bp, solver.ga
    for t, key in (("Pose2", "se2_gibbs_draw"), ("Point2", "euclid_gibbs_draw")):
        lo, hi = _block(ga.counts[t], mesh)
        if bp.has_msg[t].any() and hi > lo and bp.kmax[t] > 1:
            out[key] += sweeps * bp.gibbs_sweeps * bp.kmax[t]
    return out


def distributed_rank(mesh, inputs, dryrun, t_spawn, card):
    """One rank of phases 20-22 (and of ``dryrun_multichip`` with
    ``dryrun``): each path driven with every launch count set to 0 just
    before it and read just after. Returns the rows the gates read."""
    import torch

    from rome_tpu_torch.graft_entry import dryrun_multichip
    from rome_tpu_torch.graph.convert import graph_arrays_from_numpy
    from rome_tpu_torch.parallel.distributed import global_mesh
    from rome_tpu_torch.parallel.multimodal import ShardedNonparametricSolver
    from rome_tpu_torch.parallel.sharding import make_sharded_gn_step, solve_distributed
    from rome_tpu_torch.parallel.varpart import make_varpart_solver

    from rome_tpu_torch.ops.linearize_cuda import FUSED_LINEARIZE

    torch.backends.cuda.matmul.allow_tf32 = False
    dev, kind = mesh.device, mesh.device.type
    out = dict(rank=mesh.rank, world=mesh.world, device=str(dev),
               entered_s=time.time() - t_spawn)   # process start-up and group init
    recorded = PathInputs()

    def host(values):
        return {t: v.cpu().numpy() for t, v in values.items()}

    def timed(path, fn):
        recorded.path = path
        _reset_launches()
        _sync(kind)
        if kind == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        res = fn()
        _sync(kind)
        row = dict(seconds=time.perf_counter() - t0, launches=_launches())
        recorded.path = None
        if kind == "cuda":
            row["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        return res, row

    # phase 20: factor-sharded LM on citygrid
    city = inputs["city"]
    ga = graph_arrays_from_numpy(**city["spec"], device=dev)
    values = {t: torch.as_tensor(v, device=dev) for t, v in city["values"].items()}
    step, ga_p = make_sharded_gn_step(ga, mesh, pcg_iters=SHARDED_PCG_ITERS, device=kind)
    v1, c0, c1, _gn, ok = step(values, SHARDED_LAM0)
    (vals, stats), row = timed("factor_sharded", lambda: solve_distributed(
        ga, mesh, max_iters=SHARDED_MAX_ITERS, pcg_iters=SHARDED_PCG_ITERS, lam0=SHARDED_LAM0,
        values=values, device=kind))
    # the collective alone at the PCG's payload (one float64 per dof, the
    # Hvp's all-reduce): does it or the shard-local work set the pace?
    buf = torch.zeros(sum(ga.counts[t] * ga.manifolds[t].dof for t in ga.type_names),
                      dtype=torch.float64, device=dev)
    mesh.all_reduce(buf)
    _sync(kind)
    t0 = time.perf_counter()
    for _ in range(ALLREDUCE_REPS):
        mesh.all_reduce(buf)
    _sync(kind)
    # this rank's block of the mesh-padded K1 batches: its weight-0 rows
    m = {b.ftype.name: b.n // mesh.world for b in ga_p.batches}
    pad_rows = sum(int((b.weight[mesh.rank * m[b.ftype.name]:
                                 (mesh.rank + 1) * m[b.ftype.name]] == 0).sum())
                   for b in ga_p.batches if b.ftype.name in FUSED_LINEARIZE)
    out["factor_sharded"] = dict(stats, **row, values=host(vals), k1_weight0_rows=pad_rows,
                                 allreduce_ms=(time.perf_counter() - t0) / ALLREDUCE_REPS * 1e3,
                                 first=dict(c0=c0, c1=c1, ok=ok, values=host(v1)))
    if mesh.world == 1:   # one answer per input: the same solve again
        v2, s2 = solve_distributed(ga, mesh, max_iters=SHARDED_MAX_ITERS,
                                   pcg_iters=SHARDED_PCG_ITERS, lam0=SHARDED_LAM0,
                                   values=values, device=kind)
        out["factor_sharded"]["repeat"] = dict(iterations=s2["iterations"],
                                               final_cost=s2["final_cost"], values=host(v2))

    # phase 21: owner-computes variable partition on the corridor chain
    gc = graph_arrays_from_numpy(**inputs["chain"]["spec"], dtype=torch.float64, device=dev)
    solve, plan = make_varpart_solver(gc, global_mesh("v", kind), max_iters=VARPART_MAX_ITERS,
                                      device=kind)
    (vals, stats), row = timed("varpart", lambda: solve(lam0=1e-4))
    out["varpart"] = dict(stats, **row, values=host(vals),
                          own_dof=plan.n_loc["Pose2"] * 3, sep_dof=plan.n_sep["Pose2"] * 3)
    if mesh.world == 1:
        v2, s2 = solve(lam0=1e-4)
        out["varpart"]["repeat"] = dict(iterations=s2["iterations"],
                                        final_cost=s2["final_cost"], values=host(v2))

    # phase 22: the sharded nonparametric sweep on beehive
    bee = inputs["bee"]
    fg = beehive_graph(bee["poses"])
    solver = ShardedNonparametricSolver(fg, mesh, N=bee["N"], device=kind)
    _r, row = timed("sharded_beehive", lambda: solver.solve(
        sweeps=BEEHIVE_SWEEPS, seed=BEEHIVE_SEED, init="points"))
    out["sharded_beehive"] = dict(
        **row, expected=_expected_draws(solver, mesh, BEEHIVE_SWEEPS),
        beliefs={l: np.asarray(fg.variables[l].beliefs["default"]) for l in fg._var_order})

    if dryrun:
        res, row = timed("dryrun", lambda: dryrun_multichip(mesh.world, device=kind))
        out["dryrun"] = dict(res, **row)
    # the kernels on the inputs the paths gave them (these launches come
    # after every path's counts were read)
    out["kernel_checks"] = recorded.check(f"{card} rank {mesh.rank}/{mesh.world}")
    out["left_s"] = time.time() - t_spawn
    return out


def _max_diff(a, b):
    """Largest coordinate difference of two {type: array} sets, Pose2 angles
    modulo 2 pi (a heading at +-pi may come out on either side)."""
    out = 0.0
    for t in a:
        d = np.asarray(a[t], np.float64) - np.asarray(b[t], np.float64)
        if t == "Pose2":
            d[..., 2] = (d[..., 2] + np.pi) % (2 * np.pi) - np.pi
        out = max(out, float(np.abs(d).max()))
    return out


def distributed_path(card, inputs, device="cuda", worlds=DIST_WORLDS, dryrun_world=4):
    """Phases 20-22 at each world size (ranks started with
    ``spawn_ranks``: spawn, a file rendezvous, NCCL for one rank on the
    card, gloo with CUDA tensors for several ranks on one card), then the
    gates. Any rank's exception ends the script. Returns the rows and the
    launches per path and rank."""
    import torch

    from rome_tpu_torch.parallel.distributed import spawn_ranks
    from rome_tpu_torch.solvers.multimodal.metrics import symmetric_kl_knn
    from rome_tpu_torch.manifolds.base import T2

    if device == "cuda":
        torch.cuda.empty_cache()  # this process's cache: the ranks need the room
    runs = {}
    for w in worlds:
        t0 = time.time()
        ranks = spawn_ranks(distributed_rank, w, args=(inputs, w == dryrun_world, t0, card),
                            device=device)
        runs[w] = ranks
        print(f"[{card}] distributed world={w}: {time.time() - t0:.1f} s "
              f"({'nccl' if device == 'cuda' and w <= torch.cuda.device_count() else 'gloo'}); "
              f"ranks entered after {max(r['entered_s'] for r in ranks):.1f} s and left "
              f"after {max(r['left_s'] for r in ranks):.1f} s")

    def rows(w, key):
        rr = [r[key] for r in runs[w]]
        for r in rr[1:]:  # every rank ends with the same values
            got = r.get("values", r.get("beliefs"))
            want = rr[0].get("values", rr[0].get("beliefs"))
            check(_max_diff(got, want) == 0.0, f"{key} world {w}: ranks disagree")
        return rr

    def lin_in_every_rank(rr, what):
        for r in rr:
            check(device != "cuda" or (r["launches"]["k1_lin"] > 0
                                       and r["launches"]["k1_normal"] == 0),
                  f"{what}: rank launches {r['launches']}, expected K1 lin > 0 and no normal")

    def summary(rr):
        return dict({k: v for k, v in rr[0].items()
                     if k not in ("values", "beliefs", "first", "launches", "seconds", "repeat")},
                    seconds=[r["seconds"] for r in rr], launches=[r["launches"] for r in rr])

    def same_again(rr, what):
        """World 1's second solve: the same iterations, final cost and
        values, bit for bit."""
        r, again = rr[0], rr[0]["repeat"]
        bits = [float(x["final_cost"]).hex() for x in (r, again)]
        same = (again["iterations"] == r["iterations"] and bits[0] == bits[1]
                and all(np.array_equal(again["values"][t], r["values"][t]) for t in r["values"]))
        row = dict(iterations=[r["iterations"], again["iterations"]], final_cost_bits=bits,
                   same=same)
        print(f"[{card}] {what} world=1 twice: " + json.dumps(row))
        check(same, f"{what} world 1: the second solve differs ({row})")
        return row

    city, chain, bee = inputs["city"], inputs["chain"], inputs["bee"]
    result, by_rank = {}, {}

    # ---- phase 20 ----
    fs = {w: rows(w, "factor_sharded") for w in worlds}
    for w, rr in fs.items():
        r = rr[0]
        first = r["first"]
        s = city["first"]
        check(abs(first["c0"] - s["c0"]) < 1e-3 * max(1.0, abs(s["c0"])),
              f"world {w}: first-step cost0 {first['c0']} vs single-device pcg {s['c0']}")
        check(abs(first["c1"] - s["c1"]) < 2e-2 * max(1.0, abs(s["c1"])),
              f"world {w}: first-step cost1 {first['c1']} vs single-device pcg {s['c1']}")
        d_first = _max_diff(first["values"], s["values"])
        check(d_first <= 5e-3, f"world {w}: first step {d_first} from the single-device pcg step")
        check(np.isfinite(r["values"]["Pose2"]).all(), f"world {w}: poses not finite")
        lin_in_every_rank(rr, f"factor_sharded_citygrid_10k world {w}")
        row = dict(summary(rr), first_step_max_pose_diff_m=d_first,
                   ate_m=ate_values(r["values"]["Pose2"], city["gt"]),
                   allreduce_share=r["collectives"] * r["allreduce_ms"] / 1e3 / r["seconds"])
        result[f"factor_sharded_citygrid_10k_w{w}"] = row
        print(f"[{card}] factor_sharded_citygrid_10k world={w}: " + json.dumps(row))
    if 1 in worlds:
        result["factor_sharded_citygrid_10k_w1_repeat"] = same_again(
            fs[1], "factor_sharded_citygrid_10k")
    a, b = (fs[w][0] for w in worlds)
    check(a["reason"] == b["reason"], f"reason codes differ: {a['reason']} vs {b['reason']}")
    check(abs(a["iterations"] - b["iterations"]) <= 4,
          f"iterations {a['iterations']} vs {b['iterations']}")
    lo_c, hi_c = sorted((a["final_cost"], b["final_cost"]))
    check(hi_c <= lo_c * 1.5 + 1e-12, f"costs {a['final_cost']} vs {b['final_cost']}")
    result["factor_sharded_citygrid_10k"] = dict(
        iteration_drift=b["iterations"] - a["iterations"],
        relative_cost_diff=(b["final_cost"] - a["final_cost"]) / a["final_cost"],
        max_pose_diff_m=_max_diff(a["values"], b["values"]))
    print(f"[{card}] factor_sharded_citygrid_10k: "
          + json.dumps(result["factor_sharded_citygrid_10k"]))

    # ---- phase 21 ----
    from rome_tpu_torch.graph.convert import graph_arrays_from_numpy
    from rome_tpu_torch.solvers.linearize import cost_at

    gc = graph_arrays_from_numpy(**chain["spec"], dtype=torch.float64, device=device)
    vp = {w: rows(w, "varpart") for w in worlds}
    for w, rr in vp.items():
        r = rr[0]
        c = float(cost_at(gc, {t: torch.as_tensor(v, device=device)
                               for t, v in r["values"].items()}))
        check(r["converged"], f"varpart world {w} did not converge ({r['reason']})")
        check(r["final_cost"] < chain["cost_start"] * 1e-3,
              f"varpart world {w}: cost {r['final_cost']} >= 1e-3 x {chain['cost_start']}")
        check(c <= chain["ref_cost"] * 1.01 + 1e-6,
              f"varpart world {w}: single-rank cost {c} > 1.01 x optimum {chain['ref_cost']}")
        lin_in_every_rank(rr, f"varpart_chain_10k world {w}")
        row = dict(summary(rr), single_rank_cost=c, optimum_cost=chain["ref_cost"],
                   cost_start=chain["cost_start"])
        result[f"varpart_chain_10k_w{w}"] = row
        print(f"[{card}] varpart_chain_10k world={w}: comms_note {json.dumps(r['comms'])}; "
              + json.dumps(row))
    if 1 in worlds:
        result["varpart_chain_10k_w1_repeat"] = same_again(vp[1], "varpart_chain_10k")
    a, b = (vp[w][0] for w in worlds)
    result["varpart_chain_10k"] = dict(iteration_drift=b["iterations"] - a["iterations"],
                                       max_pose_diff_m=_max_diff(a["values"], b["values"]))
    print(f"[{card}] varpart_chain_10k: " + json.dumps(result["varpart_chain_10k"]))

    # ---- phase 22 ----
    rng = np.random.default_rng(0)
    for w in worlds:
        rr = rows(w, "sharded_beehive")
        bel = rr[0]["beliefs"]
        errs = [float(np.linalg.norm(bel[l][:, :2].mean(0) - bee["truth"][l][:2]))
                for l in bee["truth"]]
        err = float(np.mean(errs))
        check(err < BEEHIVE_GATE_M, f"sharded beehive world {w}: mean pose error {err}")
        kl = {}
        for l in bee["single"]:
            p = torch.as_tensor(bee["single"][l][:, :2] + rng.normal(0, 1e-4, (bee["N"], 2)))
            q = torch.as_tensor(bel[l][:, :2] + rng.normal(0, 1e-4, (bee["N"], 2)))
            kl[l] = float(symmetric_kl_knn(T2, p, q))
            check(np.isfinite(kl[l]) and kl[l] < SHARDED_KL_GATE,
                  f"sharded beehive world {w}: KL {l} {kl[l]} >= {SHARDED_KL_GATE}")
        for rank, r in enumerate(rr):
            got = {k: r["launches"][k] for k in ("se2_gibbs_draw", "euclid_gibbs_draw")}
            check(device != "cuda" or (
                got == r["expected"] and min(got.values()) > 0
                and r["launches"]["se2_pairwise_logw"] == 0
                and r["launches"]["euclid_pairwise_logw"] == 0),
                  f"sharded beehive world {w} rank {rank}: launches {r['launches']}, "
                  f"expected {r['expected']} draws and no logw")
        row = dict(summary(rr), mean_pose_err_m=err, max_pose_err_m=max(errs), kl=kl)
        result[f"sharded_beehive_100_w{w}"] = row
        print(f"[{card}] sharded_beehive_100 world={w}: " + json.dumps(row))

    if dryrun_world in worlds:
        d = runs[dryrun_world][0]["dryrun"]
        result["dryrun_multichip"] = dict(
            {k: v for k, v in d.items() if k != "launches"},
            launches=[r["dryrun"]["launches"] for r in runs[dryrun_world]])
        print(f"[{card}] dryrun_multichip({dryrun_world}): "
              + json.dumps(result["dryrun_multichip"]))

    result["path_inputs"] = _check_path_inputs(card, runs, device)

    for path, key in (("factor_sharded_citygrid_10k", "factor_sharded"),
                      ("varpart_chain_10k", "varpart"), ("sharded_beehive_100", "sharded_beehive"),
                      (f"dryrun_multichip_{dryrun_world}", "dryrun")):
        by_rank[path] = {f"world{w}": [r[key]["launches"] for r in runs[w]]
                         for w in worlds if key in runs[w][0]}
    return result, by_rank


def _check_entry_inputs(card, inputs):
    """The main process's ``PathInputs`` over the measuring entry points:
    every recorded call's kernel held to its plain version (``check``), and
    per draw kernel the labels equal to the plain draw's on >= LABEL_AGREE
    of the rows pooled over the paths. Returns per kernel the calls seen and
    checked per path, the worst errors and the label agreement."""
    rows = inputs.check(card)
    out = {}
    for name in PathInputs.KERNELS:
        mine = [r for r in rows if r["kernel"] == name]
        o = out[name] = dict(
            calls={p: n for (p, k), n in inputs.seen.items() if k == name},
            checked={p: sum(r["path"] == p for r in mine) for p in {r["path"] for r in mine}},
            max_abs_err=max((r.get("max_abs_err", 0.0) for r in mine), default=0.0),
            shapes=sorted({f"{r['path']} {r['shapes'][0]}" for r in mine}))
        for p in o["calls"]:
            check(o["checked"].get(p, 0) > 0, f"{p}: {name} called but no call checked")
        n_rows = sum(r.get("rows", 0) for r in mine)
        if n_rows:
            o["label_agreement"] = 1.0 - sum(r["rows_differ"] for r in mine) / n_rows
            o["max_gap"] = max(r["max_gap"] for r in mine)
            check(o["label_agreement"] >= LABEL_AGREE,
                  f"{name} on the entry points' inputs: labels equal on "
                  f"{o['label_agreement']} < {LABEL_AGREE} of rows")
    print(f"[{card}] kernels on the measuring entry points' inputs: " + json.dumps(out))
    return out


def _check_path_inputs(card, runs, device):
    """The gates on the ranks' ``PathInputs`` checks: on the card, every
    kernel a path launched in a rank was checked on that path's inputs in
    that rank; the factor-sharded path's checks covered every mesh-padded
    K1 row of the rank's block; the draws' labels agree with the plain
    draw's on >= LABEL_AGREE of the rows of each kernel. Returns the worst
    errors per kernel."""
    keys = {"k1_lin": "lin", "se2_gibbs_draw": "se2_gibbs_draw",
            "euclid_gibbs_draw": "euclid_gibbs_draw"}
    out = {k: dict(calls=0, max_abs_err=0.0, rows=0, rows_differ=0, max_gap=0.0,
                   weight0_rows=0, shapes=set()) for k in PathInputs.KERNELS}
    for w, ranks in runs.items():
        for r in ranks:
            checks = r["kernel_checks"]
            for path in ("factor_sharded", "varpart", "sharded_beehive", "dryrun"):
                if path not in r:
                    continue
                for key, name in keys.items():
                    check(device != "cuda" or r[path]["launches"][key] == 0 or any(
                        c["path"] == path and c["kernel"] == name for c in checks),
                        f"world {w} rank {r['rank']}: {path} launched {name} but no call "
                        f"of it was checked")
            got = sum(c["weight0_rows"] for c in checks
                      if c["path"] == "factor_sharded" and c["kernel"] == "lin")
            check(got == r["factor_sharded"]["k1_weight0_rows"],
                  f"world {w} rank {r['rank']}: {got} weight-0 K1 rows checked, "
                  f"{r['factor_sharded']['k1_weight0_rows']} in its block")
            for c in checks:
                o = out[c["kernel"]]
                o["calls"] += 1
                o["shapes"].add(f"{c['path']} w{w} {c['shapes'][0]}")
                for k in ("rows", "rows_differ", "weight0_rows"):
                    o[k] += c.get(k, 0)
                o["max_abs_err"] = max(o["max_abs_err"], c.get("max_abs_err", 0.0))
                o["max_gap"] = max(o["max_gap"], c.get("max_gap", 0.0))
    for name, o in out.items():
        o["shapes"] = sorted(o["shapes"])
        if o["rows"]:
            o["label_agreement"] = 1.0 - o["rows_differ"] / o["rows"]
            check(o["label_agreement"] >= LABEL_AGREE,
                  f"{name} on the paths' inputs: labels equal on {o['label_agreement']} "
                  f"< {LABEL_AGREE} of rows")
    print(f"[{card}] kernels on the distributed paths' inputs: " + json.dumps(out))
    return out


# phase 23, vision_bundle_ladybug49: the counts of BAL's Ladybug problem
# problem-49-7776-pre (Agarwal, Snavely, Seitz and Szeliski, "Bundle
# Adjustment in the Large", ECCV 2010, grail.cs.washington.edu/projects/bal),
# synthesized (the data file is not in the repository): 49 Pose3 cameras 4 m
# apart along a street, looking at its left facades, 7,776 Point3 landmarks
# on facades 4-30 m away, 31,843 GenericProjection sightings, the default
# CameraCalibration (640 x 480, f = 510 px), pixel noise 1 px
BUNDLE_CAMERAS, BUNDLE_POINTS, BUNDLE_OBS = 49, 7776, 31843
BUNDLE_SPACING_M, BUNDLE_DEPTH_M, BUNDLE_HEIGHT_M = 4.0, (4.0, 30.0), (-1.5, 8.0)
BUNDLE_PIXEL_SIGMA, BUNDLE_PRIOR_SIGMA = 1.0, 1e-3   # px; the gauge priors on x0, x1
BUNDLE_CAM_NOISE, BUNDLE_POINT_NOISE_M = (0.05, 0.01), 0.3   # the start: (m, rad); m
BUNDLE_SEED = 49
# ndchol with the big options less the dtol stop: dtol_auto reads its metric
# scale from the arity-2 batch's z, here a pixel coordinate of about 320, so
# the stop would fire at once (the rule IMU_BIG works around; a fault of the
# reference, ROADMAP.md section 3)
BUNDLE_BIG = IMU_BIG
BUNDLE_LANDMARK_GATE_M = 1e-3
# sqrt(mean squared pixel distance) at the optimum: 2 sigma^2 (1 - D / 2M)
# = 1.12 px expected for 1 px noise per axis
BUNDLE_REPROJ_GATE_PX = (0.8, 1.2)
MULTIVIEW_SAMPLE, MULTIVIEW_RETRY, MULTIVIEW_ITERS = 128, 100, 50
MULTIVIEW_OFFSET_M, MULTIVIEW_GATE_M = 2.0, 0.05
# phase 24, tcp_citygrid_10k: the server's particles per GETPARTICLES block
TCP_N = 100
TCP_LABELS = ("x0", "x5000", "x9999")
TCP_POSE_GATE_M = 1e-3
# phase 25: the torch examples' subprocesses, started together
EXAMPLE_TIMEOUT_S = 300


# --- fixed-order sums (the LM path's scatters without atomics) ----------------

FIXED_ORDER_REPS = 8


def fixed_order_check(card, device="cuda", g2o=CITYGRID):
    """The fixed-order sums on the card, on citygrid's own LM inputs: the
    ndchol assembly (``sum_asm``), the diagonal of H and the gradient
    (``TangentScatter``) repeated FIXED_ORDER_REPS times give the same bits
    every time; the atomic ``index_add_`` they replaced, fed the same
    values, is reported (how many distinct results). Each fixed-order sum
    within 1e-9 relative of the float64 sum of its terms."""
    import torch

    from rome_tpu_torch.graph.lower import lower
    from rome_tpu_torch.solvers import gauss_newton as GN
    from rome_tpu_torch.solvers import linearize as L
    from rome_tpu_torch.solvers.sparse import ndchol_assemble

    fg = build_graph(g2o)
    ga = lower(fg, device=device)
    ga64 = copy.copy(ga)
    ga64.dtype = torch.float64
    rt = L.runtime_state(ga)
    values = {t: v.to(torch.float64) for t, v in ga.values0.items()}
    lins, parts = L.linearize_all_mixed_j(ga64, ga, values, rt)
    sym, nd = GN.ndchol_plan(ga, BIG["nd_leaf"])
    vals = L.normal_eq_entry_values(ga64, lins, dtype=torch.float32, parts=parts)
    fvec = L.free_vector(ga).to(torch.float32)
    scatter = L.TangentScatter.of(ga, rt["key"])
    rt_s = dict(rt, scatter=scatter)

    def diag():
        return nd["sum_diag"].add_(torch.zeros(sym.D, dtype=torch.float32, device=device), vals)

    def fronts():
        d = torch.rsqrt(torch.clamp(diag() * 1.001, min=1e-12)) * fvec
        return torch.cat([W.reshape(-1) for W in ndchol_assemble(sym, nd, vals, d, 1.0 - fvec)])

    def grad():
        g = L.gradient_from_lins(ga64, lins, rt_s, parts=parts)
        return torch.cat([g[t].reshape(-1) for t in ga.type_names])

    def atomic_diag():
        return torch.zeros(sym.D, dtype=torch.float32, device=device).index_add_(
            0, nd["diag_dst"], vals[nd["diag_src"]])

    out = {}
    for name, fn in (("diag", diag), ("fronts", fronts), ("gradient", grad),
                     ("atomic_index_add_diag", atomic_diag)):
        runs = [fn() for _ in range(FIXED_ORDER_REPS)]
        _sync(device)
        distinct = len({r.cpu().numpy().tobytes() for r in runs})
        out[name] = dict(distinct_results=distinct, n=int(runs[0].numel()))
        if not name.startswith("atomic"):
            check(distinct == 1, f"fixed-order {name}: {distinct} distinct results in "
                                 f"{FIXED_ORDER_REPS} runs")
    want = torch.zeros(sym.D, dtype=torch.float64, device=device).index_add_(
        0, nd["diag_dst"], vals[nd["diag_src"]].double())
    err = float(((diag().double() - want).abs() / want.abs().clamp(min=1e-30)).max())
    out["diag"]["max_rel_err_vs_f64"] = err
    check(err <= 1e-6, f"fixed-order diagonal {err} relative from the float64 sum")
    out["plans"] = dict(asm_max_run=nd["sum_asm"].max_run,
                        ea_pairs=len(sym.ea_pairs), fea_pairs=len(sym.fea_pairs),
                        tangent_max_run={t: p.max_run for t, p in scatter.plans.items()})
    print(f"[{card}] fixed-order sums on citygrid's LM inputs ({FIXED_ORDER_REPS} runs each): "
          + json.dumps(out))
    rest = {}
    for name, case in {**chordal_sum_cases(ga, device),
                       **dense_sum_cases(ga, ga64, values, rt, device)}.items():
        rest[name] = planned_sum_check(name, **case)
    print(f"[{card}] fixed-order sums of the chordal stage and dense32's normal equations on "
          f"citygrid ({FIXED_ORDER_REPS} runs each, the atomic sums they replaced beside them): "
          + json.dumps(rest))
    out.update(rest)
    return out


def _digest(t):
    """Two wrapping int64 sums of ``t``'s bit pattern (integer sums do not
    depend on their order, so equal tensors give equal digests); computed
    on ``t``'s device."""
    import torch

    b = t.contiguous().reshape(-1)
    b = b.view(torch.int64 if b.element_size() == 8 else torch.int32).to(torch.int64)
    w = torch.arange(b.numel(), device=b.device) % 1000003 + 1
    return int(b.sum()), int((b * w).sum())


def planned_sum_check(name, fixed, atomic, dst, terms, at):
    """``fixed()`` (a fixed-order sum) and ``atomic()`` (the atomic
    ``index_add_`` it replaced) each FIXED_ORDER_REPS times on the same
    inputs: their distinct results (digests of the result at ``at``, the
    flat destinations that hold a sum); ``fixed`` must give one, within
    1e-6 of the float64 sum of its ``terms`` (into flat destinations
    ``dst``) relative to the summed magnitudes of the terms there."""
    import torch

    out = {}
    for kind, fn in (("fixed", fixed), ("atomic", atomic)):
        digests = set()
        for _ in range(FIXED_ORDER_REPS):
            r = fn()
            digests.add(_digest(r.reshape(-1, *terms.shape[1:])[at]))
        out[f"{kind}_distinct_results"] = len(digests)
    check(out["fixed_distinct_results"] == 1,
          f"fixed-order {name}: {out['fixed_distinct_results']} distinct results in "
          f"{FIXED_ORDER_REPS} runs")
    uniq, inv = torch.unique(dst, return_inverse=True)
    check(torch.equal(uniq, at), f"fixed-order {name}: the destinations differ")
    shape = (uniq.numel(),) + tuple(terms.shape[1:])
    want = torch.zeros(shape, dtype=torch.float64, device=dst.device).index_add_(
        0, inv, terms.double())
    mag = torch.zeros(shape, dtype=torch.float64, device=dst.device).index_add_(
        0, inv, terms.double().abs())
    got = fixed().reshape(-1, *terms.shape[1:])[at].double()
    err = float(((got - want).abs() / mag.clamp(min=1e-300)).max())
    out.update(n_terms=int(dst.numel()), n_sums=int(uniq.numel()), dtype=str(terms.dtype),
               max_err_rel_to_terms=err)
    check(err <= 1e-6, f"fixed-order {name}: {err} of its terms' magnitude from the float64 sum")
    return out


def chordal_sum_cases(ga, device):
    """The chordal stage's sums on ``ga``'s Pose2 graph and start
    (``init2d``'s own pieces): the float32 diagonal of the ND system and,
    in float64, stage 1's gradient and matvec and stage 2's gradient and
    matvec (at the start's rotations, on a seeded vector), each with the
    ``index_add_`` it replaced."""
    import torch

    from rome_tpu_torch.solvers import init2d as I

    n = ga.counts["Pose2"]
    e32, p32 = I._pose2_edges(ga), I._pose2_priors(ga)
    _plan, arrs = I._chordal_plan(ga.key, device)
    f64 = torch.float64
    edges = [(i, j, z.to(f64), S.to(f64), w.to(f64)) for i, j, z, S, w in e32]
    priors = [(i, z.to(f64), S.to(f64), w.to(f64)) for i, z, S, w in p32]
    th0 = ga.values0["Pose2"][:, 2].to(f64)
    u0 = torch.stack([torch.cos(th0), torch.sin(th0)], -1)
    t0 = ga.values0["Pose2"][:, :2].to(f64)
    x = torch.as_tensor(np.random.default_rng(3).normal(size=(n, 2)), device=device)
    et1, pt1 = I._rot_terms(edges, priors)
    et2, pt2 = I._tr_terms(edges, priors, I.rot2(th0))
    slots = torch.cat([v for i, j, *_ in et1 for v in (i, j)] + [p[0] for p in pt1])
    rows = arrs["rows"]
    nd = arrs["nd"]
    vals32 = I._rot_entries(et1, pt1)
    cases = {"chordal_diag": dict(
        fixed=lambda: nd["sum_diag"].add_(torch.zeros(2 * n, dtype=torch.float32,
                                                      device=device), vals32),
        atomic=lambda: torch.zeros(2 * n, dtype=torch.float32, device=device).index_add_(
            0, nd["diag_dst"], vals32[nd["diag_src"]]),
        dst=nd["diag_dst"], terms=vals32[nd["diag_src"]], at=nd["sum_diag"].dst)}
    for name, parts_of in (("chordal_g_rot", lambda: I._rot_rows(et1, pt1, u0, grad=True)),
                           ("chordal_mv_rot", lambda: I._rot_rows(et1, pt1, x)),
                           ("chordal_g_tr", lambda: I._tr_rows(et2, pt2, t0, grad=True)),
                           ("chordal_mv_tr", lambda: I._tr_rows(et2, pt2, x))):
        cases[name] = dict(
            fixed=lambda p=parts_of: rows.add_(torch.zeros((n, 2), dtype=f64, device=device),
                                               torch.cat(p())),
            atomic=lambda p=parts_of: torch.zeros((n, 2), dtype=f64, device=device).index_add_(
                0, slots, torch.cat(p())),
            dst=slots, terms=torch.cat(parts_of()), at=rows.dst)
    return cases


def dense_sum_cases(ga, ga64, values, rt, device):
    """dense32's normal equations on citygrid's start (``dense_normal_eqs``
    in float32 over float64 linearizations, as ``_solve_dense32``): the
    sums of H's entries and of g, each with the atomic ``index_add_`` into
    the same flat destinations."""
    import torch

    from rome_tpu_torch.solvers import linearize as L

    lins = L.linearize_all(ga64, values, rt)
    plan = L.DenseScatter.of(ga, rt["vslots"])
    hv, gv = plan.terms(lins, torch.float32)
    base, D = L.tangent_offsets(ga)
    h_dst, g_dst = [], []
    for b, vs in zip(ga.batches, rt["vslots"]):
        offs = [base[t] + vs[:, k, None] * ga.manifolds[t].dof
                + torch.arange(ga.manifolds[t].dof, device=device)
                for k, t in enumerate(b.vtypes)]
        for ok in offs:
            g_dst.append(ok.reshape(-1))
            h_dst.extend((ok[:, :, None] * D + ol[:, None, :]).reshape(-1) for ol in offs)
    h_dst, g_dst = torch.cat(h_dst), torch.cat(g_dst)

    def zeros(k):
        return torch.zeros(k, dtype=torch.float32, device=device)

    return {"dense32_H": dict(fixed=lambda: plan.h.add_(zeros(D * D), hv),
                              atomic=lambda: zeros(D * D).index_add_(0, h_dst, hv),
                              dst=h_dst, terms=hv, at=plan.h.dst),
            "dense32_g": dict(fixed=lambda: plan.g.add_(zeros(D), gv),
                              atomic=lambda: zeros(D).index_add_(0, g_dst, gv),
                              dst=g_dst, terms=gv, at=plan.g.dst)}


# --- phase 23: vision_bundle_ladybug49 ------------------------------------------

def _rot(axis, a):
    c, s = np.cos(a), np.sin(a)
    R = np.zeros(np.shape(a) + (3, 3))
    i, j = [(1, 2), (2, 0), (0, 1)][axis]
    R[..., axis, axis] = 1.0
    R[..., i, i], R[..., i, j], R[..., j, i], R[..., j, j] = c, -s, s, c
    return R


def bundle_scene(cameras=BUNDLE_CAMERAS, points=BUNDLE_POINTS, obs=BUNDLE_OBS,
                 seed=BUNDLE_SEED):
    """A seeded street scene at BAL problem-49-7776-pre's counts: ``cameras``
    world-from-camera poses (t, q wxyz) BUNDLE_SPACING_M apart along x, each
    looking at the left façades (+y) with a little yaw and pitch,
    ``points`` façade points BUNDLE_DEPTH_M away, and exactly ``obs``
    sightings (every point seen by at least two cameras, in front of each,
    inside the 640 x 480 image), pixels with BUNDLE_PIXEL_SIGMA noise."""
    import torch

    from rome_tpu_torch.manifolds import quat as Q
    from rome_tpu_torch.vision import CameraCalibration

    rng = np.random.default_rng(seed)
    cal = CameraCalibration()
    K = cal.K
    # camera axes in the world: x right = +x, y down = -z, z forward = +y
    R0 = np.array([[1.0, 0, 0], [0, 0, 1], [0, -1, 0]])
    R = _rot(2, rng.uniform(-0.1, 0.1, cameras)) @ _rot(0, rng.uniform(-0.05, 0.05, cameras)) @ R0
    t = np.stack([np.arange(cameras) * BUNDLE_SPACING_M, rng.normal(0, 0.3, cameras),
                  rng.normal(0, 0.1, cameras)], axis=1)
    n = 4 * points
    P = np.stack([rng.uniform(-10.0, (cameras - 1) * BUNDLE_SPACING_M + 10.0, n),
                  rng.uniform(*BUNDLE_DEPTH_M, n), rng.uniform(*BUNDLE_HEIGHT_M, n)], axis=1)
    c = np.einsum("cji,cpj->cpi", R, P[None] - t[:, None])
    uvw = c @ K.T
    px = uvw[..., :2] / uvw[..., 2:3]
    vis = ((c[..., 2] > 0) & (px[..., 0] >= 0) & (px[..., 0] < cal.width)
           & (px[..., 1] >= 0) & (px[..., 1] < cal.height))
    good = np.nonzero(vis.sum(0) >= 2)[0]
    check(len(good) >= points, f"bundle scene: {len(good)} points seen twice, {points} needed")
    pick = np.sort(rng.permutation(good)[:points])
    vis, px, P = vis[:, pick], px[:, pick], P[pick]
    cam_i, pt_i = np.nonzero(vis.T)[::-1]           # sightings ordered by point
    check(len(cam_i) >= obs, f"bundle scene: {len(cam_i)} sightings, {obs} needed")
    # keep two random sightings of every point, then random others up to obs
    key = rng.random(len(cam_i))
    order = np.lexsort((key, pt_i))
    first = np.r_[0, np.nonzero(np.diff(pt_i[order]))[0] + 1]
    rank = np.arange(len(order)) - np.repeat(first, np.diff(np.r_[first, len(order)]))
    must, extra = order[rank < 2], order[rank >= 2]
    keep = np.sort(np.r_[must, rng.permutation(extra)[: obs - len(must)]])
    cam_i, pt_i = cam_i[keep], pt_i[keep]
    pix = px[cam_i, pt_i] + rng.normal(0, BUNDLE_PIXEL_SIGMA, (len(keep), 2))
    q = Q.qfrom_matrix(torch.as_tensor(R)).numpy()
    return dict(cams=np.concatenate([t, q], axis=1), points=P, cam=cam_i, pt=pt_i,
                pixels=pix, K=K)


def bundle_graph(mod, scene, seed=BUNDLE_SEED + 1):
    """The scene as a FactorGraph of ``mod`` (the port): Pose3 x0.., Point3
    l0.., a GenericProjection per sighting (sigma BUNDLE_PIXEL_SIGMA), a
    PriorPose3 on x0 and x1 at the truth (sigma BUNDLE_PRIOR_SIGMA); cameras
    started BUNDLE_CAM_NOISE (m, rad) and points BUNDLE_POINT_NOISE_M from
    the truth."""
    import torch

    from rome_tpu_torch.manifolds import quat as Q
    from rome_tpu_torch.manifolds.base import SE3_
    from rome_tpu_torch.vision import CameraCalibration, GenericProjection

    rng = np.random.default_rng(seed)
    cal = CameraCalibration()
    fg = mod.FactorGraph()
    fg.params.graphinit = False
    cams, P = scene["cams"], scene["points"]
    for k in range(len(cams)):
        fg.add_variable(f"x{k}", mod.Pose3)
    for j in range(len(P)):
        fg.add_variable(f"l{j}", mod.Point3)
    for k in (0, 1):
        z = SE3_.log(torch.as_tensor(cams[k])).numpy()
        fg.add_factor([f"x{k}"], mod.PriorPose3(mod.MvNormal(
            z, np.eye(6) * BUNDLE_PRIOR_SIGMA ** 2)))
    cov = np.eye(2) * BUNDLE_PIXEL_SIGMA ** 2
    for k, j, z in zip(scene["cam"], scene["pt"], scene["pixels"]):
        fg.add_factor([f"x{k}", f"l{j}"], GenericProjection(cal, mod.MvNormal(z, cov)))
    dq = Q.qexp(torch.as_tensor(rng.normal(0, BUNDLE_CAM_NOISE[1], (len(cams), 3))))
    q0 = Q.qmul(torch.as_tensor(cams[:, 3:]), dq).numpy()
    t0 = cams[:, :3] + rng.normal(0, BUNDLE_CAM_NOISE[0], (len(cams), 3))
    for k in range(len(cams)):
        fg.set_point(f"x{k}", np.r_[t0[k], q0[k]])
    P0 = P + rng.normal(0, BUNDLE_POINT_NOISE_M, P.shape)
    for j in range(len(P)):
        fg.set_point(f"l{j}", P0[j])
    return fg


def _bundle_points(fg, prefix, n):
    return np.stack([fg.get_point(f"{prefix}{i}") for i in range(n)])


def reprojection_rmse(scene, cams, points):
    """sqrt(mean over sightings of the squared pixel distance) between the
    measured pixels and the projection of ``points`` by ``cams``."""
    import torch

    from rome_tpu_torch.manifolds import quat as Q

    R = Q.qto_matrix(torch.as_tensor(cams[:, 3:])).numpy()
    c = np.einsum("nji,nj->ni", R[scene["cam"]], points[scene["pt"]] - cams[scene["cam"], :3])
    uvw = c @ scene["K"].T
    e = scene["pixels"] - uvw[:, :2] / uvw[:, 2:3]
    return float(np.sqrt(np.mean(np.sum(e * e, axis=1)))), float(c[:, 2].min())


def vision_bundle_path(card, device="cuda", cameras=BUNDLE_CAMERAS, points=BUNDLE_POINTS,
                       obs=BUNDLE_OBS, sample=MULTIVIEW_SAMPLE, timer=None):
    """Phase 23, ``vision_bundle_ladybug49``: the synthesized bundle
    (``bundle_scene``) solved through solve_graph_parametric on ``device``:
    LM with the dense Cholesky in float64 once (the reference optimum, its
    reprojection RMSE within BUNDLE_REPROJ_GATE_PX), then ndchol with
    BUNDLE_BIG cold and warm, each converged, cost <= 1.002 * the optimum +
    1e-3 and landmark RMSE to the optimum <= BUNDLE_LANDMARK_GATE_M; then
    ``solve_multiview_landmark`` (MULTIVIEW_RETRY restarts, MULTIVIEW_ITERS
    iterations) on ``sample`` seeded landmarks started MULTIVIEW_OFFSET_M
    from the truth, each within MULTIVIEW_GATE_M of the optimum's. K1-K3
    launch 0 times. ``timer``: a profiling.PhaseTimer for the steps.
    Returns (result, launches)."""
    import torch

    import rome_tpu_torch as T
    from rome_tpu_torch.graph.lower import lower
    from rome_tpu_torch.solvers import gauss_newton as GN
    from rome_tpu_torch.utils.profiling import PhaseTimer
    from rome_tpu_torch.vision import solve_multiview_landmark

    timer = timer if timer is not None else PhaseTimer(device=device)
    _reset_launches()
    with timer.phase("build"):
        scene = bundle_scene(cameras, points, obs)
        fg0 = bundle_graph(T, scene)
    dof = 6 * cameras + 3 * points
    rmse_truth = reprojection_rmse(scene, scene["cams"], scene["points"])[0]
    print(f"[{card}] vision_bundle_ladybug49: {cameras} cameras, {points} landmarks, "
          f"{len(scene['cam'])} GenericProjection factors, {dof} dof; reprojection RMSE "
          f"at the truth {rmse_truth:.4f} px")
    check(len(scene["cam"]) == obs and np.bincount(scene["pt"]).min() >= 2,
          "the scene's sightings miss their counts")
    lin = LinearizeTimer(torch, device)
    try:
        fg = copy.deepcopy(fg0)
        with timer.phase("dense_f64"):
            res, wall, peak = _solve_timed(fg, T.GNOptions(**SPHERE_DENSE), device,
                                           torch.float64)
        st = res["stats"]
        opt_c, opt_p = _bundle_points(fg, "x", cameras), _bundle_points(fg, "l", points)
        reproj, min_depth = reprojection_rmse(scene, opt_c, opt_p)
        dense = dict(iterations=st.iterations, converged=st.converged, reason=st.reason,
                     final_cost=st.final_cost, wall_s=wall, solve_time_s=res["solve_time_s"],
                     peak_device_gib=peak, reprojection_rmse_px=reproj, min_depth_m=min_depth,
                     landmark_rmse_to_truth_m=_rmse(opt_p, scene["points"]),
                     linearize=lin.per_iteration(device, st.iterations))
        print(f"[{card}] vision_bundle_ladybug49 dense f64 reference: " + json.dumps(dense))
        check(st.converged and np.isfinite(opt_p).all(), "the dense reference did not converge")
        lo, hi = BUNDLE_REPROJ_GATE_PX
        check(lo <= reproj <= hi, f"the optimum's reprojection RMSE {reproj} px is outside "
                                  f"{BUNDLE_REPROJ_GATE_PX}")
        check(min_depth > 0, f"the optimum puts a landmark behind a camera ({min_depth} m)")
        runs = []
        for label in ("cold", "warm"):
            f2 = copy.deepcopy(fg0)
            with timer.phase(f"ndchol_{label}"):
                res, wall, peak = _solve_timed(f2, T.GNOptions(**BUNDLE_BIG), device)
            st = res["stats"]
            pts = _bundle_points(f2, "l", points)
            row = dict(run=label, iterations=st.iterations, converged=st.converged,
                       reason=st.reason, final_cost=st.final_cost, ref_cost=dense["final_cost"],
                       landmark_rmse_to_optimum_m=_rmse(pts, opt_p),
                       camera_rmse_to_optimum_m=_rmse(_bundle_points(f2, "x", cameras)[:, :3],
                                                      opt_c[:, :3]),
                       solve_time_s=res["solve_time_s"], wall_s=wall, peak_device_gib=peak,
                       linear=res["linear_solver"],
                       linearize=lin.per_iteration(device, st.iterations))
            runs.append(row)
            print(f"[{card}] vision_bundle_ladybug49 ndchol {label}: " + json.dumps(row))
            check(np.isfinite(pts).all(), "landmarks not finite")
            check(st.converged, f"{label} run did not converge ({st.reason})")
            check(st.final_cost <= dense["final_cost"] * 1.002 + 1e-3,
                  f"{label} run cost {st.final_cost} > 1.002 * {dense['final_cost']}")
            check(row["landmark_rmse_to_optimum_m"] <= BUNDLE_LANDMARK_GATE_M,
                  f"{label} run landmark RMSE to the optimum "
                  f"{row['landmark_rmse_to_optimum_m']} > {BUNDLE_LANDMARK_GATE_M} m")
    finally:
        lin.unwrap()
    sym, _nd = GN.ndchol_plan(lower(fg0, device=device), BUNDLE_BIG["nd_leaf"])
    rng = np.random.default_rng(BUNDLE_SEED + 2)
    picks = np.sort(rng.choice(points, sample, replace=False))
    errs, ms = [], []
    with timer.phase("multiview"):
        for j in picks:
            d = rng.normal(size=3)
            fg.set_point(f"l{j}", scene["points"][j] + MULTIVIEW_OFFSET_M * d / np.linalg.norm(d))
            _sync(device)
            t0 = time.time()
            got = solve_multiview_landmark(fg, f"l{j}", retry=MULTIVIEW_RETRY,
                                           iters=MULTIVIEW_ITERS, seed=int(j), device=device)
            ms.append(1e3 * (time.time() - t0))
            errs.append(float(np.linalg.norm(got - opt_p[j])))
    multiview = dict(landmarks=int(sample), retry=MULTIVIEW_RETRY, iters=MULTIVIEW_ITERS,
                     max_err_to_optimum_m=max(errs), mean_err_to_optimum_m=float(np.mean(errs)),
                     ms_per_call_mean=float(np.mean(ms)), ms_per_call_median=float(np.median(ms)))
    print(f"[{card}] vision_bundle_ladybug49 multiview: " + json.dumps(multiview))
    check(max(errs) <= MULTIVIEW_GATE_M,
          f"a triangulated landmark is {max(errs)} m from the optimum's, gate {MULTIVIEW_GATE_M}")
    launches = _launches()
    check(device != "cuda" or all(v == 0 for v in launches.values()),
          f"the bundle path launched K1-K3: {launches}")
    return dict(cameras=cameras, landmarks=points, factors=len(scene["cam"]), dof=dof,
                reprojection_rmse_at_truth_px=rmse_truth, dense=dense, runs=runs,
                multiview=multiview, ndchol_max_front=int(sym.stats["max_front"]),
                ndchol_levels=int(sym.nlev), phases=timer.rows()), launches


# --- phase 24: tcp_citygrid_10k ----------------------------------------------------

def citygrid_commands(path=CITYGRID):
    """INIT, then every EDGE_SE2 line of ``path`` as an ODOMETRY command in
    file order, its covariance the inverse of the line's information."""
    cmds = ["INIT"]
    with open(path) as fh:
        for line in fh:
            t = line.split()
            if not t or t[0] != "EDGE_SE2":
                continue
            c = edge_cov(t)
            cmds.append("ODOMETRY {} {} {} {} {} ".format(*t[1:6]) + " ".join(
                repr(float(v)) for v in (c[0, 0], c[0, 1], c[0, 2], c[1, 1], c[1, 2], c[2, 2])))
    return cmds


def tcp_path(card, device="cuda", g2o=CITYGRID, gt_file=CITYGRID_GT, labels=TCP_LABELS,
             N=TCP_N):
    """Phase 24, ``tcp_citygrid_10k``: a TCPSLAMServer on 127.0.0.1 with its
    solves on ``device`` and a client in this process: INIT, citygrid's
    EDGE_SE2 lines as ODOMETRY commands, BATCHSOLVE, GETPARTICLES of
    ``labels``, QUIT. Gates: every reply OK or particle rows; BATCHSOLVE's
    converged equal to a direct solve_graph_parametric of the same graph (the
    same commands replayed into a session in this process), its poses within
    TCP_POSE_GATE_M of that solve; each GETPARTICLES block N rows, its mean
    within 4 sigma / sqrt(N) of the pose (sigma from the session's marginal
    covariance); K1 launched. Returns (result, launches)."""
    import torch

    from rome_tpu_torch import solve_graph_parametric
    from rome_tpu_torch.graph.lower import lower
    from rome_tpu_torch.interop import TCPSLAMClient, TCPSLAMServer
    from rome_tpu_torch.interop.tcp_server import _SLAMSession
    from rome_tpu_torch.solvers.gauss_newton import marginal_covariances

    cmds = citygrid_commands(g2o)
    _reset_launches()
    server = TCPSLAMServer(port=0, N=N, device=device)
    server.serve_background()
    secs, replies, blocks = {}, [], {}
    try:
        cl = TCPSLAMClient(port=server.server_address[1])
        t0 = time.time()
        replies = [cl.send_cmd(c) for c in cmds]
        secs["send"] = time.time() - t0
        t0 = time.time()
        replies.append(cl.send_cmd("BATCHSOLVE"))
        secs["solve"] = time.time() - t0
        t0 = time.time()
        for lbl in labels:
            reply = cl.send_cmd(f"GETPARTICLES {lbl}")
            blocks[lbl] = reply
        secs["covariances"] = time.time() - t0
        cl.close()
    finally:
        server.shutdown()
        server.server_close()
    launches = _launches()
    bad = [r for r in replies if not r.startswith("OK")]
    check(not bad, f"{len(bad)} replies not OK, the first: {bad[:1]}")
    (session,) = server.sessions
    solved = session.last_solve
    check(solved is not None, "the session ran no BATCHSOLVE")
    # the same graph, solved directly
    direct = _SLAMSession(N=N, device=device)
    for c in cmds:
        direct.handle(c)
    direct.fg.init_all()
    t0 = time.time()
    ref = solve_graph_parametric(direct.fg, init=False, device=device)
    _sync(device)
    secs["direct_solve"] = time.time() - t0
    n = len(session.fg.ls(r"^x\d+$"))
    got = np.stack([session.fg.get_coords(f"x{i}") for i in range(n)])
    want = np.stack([direct.fg.get_coords(f"x{i}") for i in range(n)])
    gap = float(np.abs(got[:, :2] - want[:, :2]).max())
    gt = np.load(gt_file)
    ate = ate_values(got, gt["poses"])
    check(replies[-1] == f"OK BATCHSOLVE converged={ref['stats'].converged}",
          f"BATCHSOLVE replied {replies[-1]!r}; the direct solve converged="
          f"{ref['stats'].converged}")
    check(gap <= TCP_POSE_GATE_M, f"the session's poses are {gap} m from the direct solve's")
    ga = lower(session.fg, device=device)
    covs = marginal_covariances(ga, ga.values0)["Pose2"]
    particles = {}
    for lbl, reply in blocks.items():
        rows = np.array([[float(v) for v in r.split(",")] for r in reply.rstrip(";").split(";")])
        rec = session.fg.variables[lbl]
        sigma = np.sqrt(np.diag(covs[rec.slot].double().cpu().numpy()))
        dev_ = np.abs(rows.mean(0) - session.fg.get_coords(lbl))
        particles[lbl] = dict(rows=len(rows), mean_offset=dev_.tolist(), sigma=sigma.tolist())
        check(rows.shape == (N, 3) and np.isfinite(rows).all(), f"{lbl}: particle rows {rows.shape}")
        check(np.all(dev_ <= 4 * sigma / np.sqrt(N)),
              f"{lbl}: particle mean {dev_} from the pose, more than 4 sigma / sqrt(N)")
    check(device != "cuda" or launches["k1_lin"] + launches["k1_normal"] > 0,
          f"the TCP path did not launch K1: {launches}")
    st = solved["stats"]
    out = dict(commands=len(cmds) + 2 + len(labels), poses=n, seconds=secs,
               iterations=st.iterations, converged=st.converged, reason=st.reason,
               final_cost=st.final_cost, direct_iterations=ref["stats"].iterations,
               direct_final_cost=ref["stats"].final_cost, linear=solved["linear_solver"],
               max_pose_gap_to_direct_m=gap, ate_rmse_m=ate, particles=particles,
               launches=launches)
    print(f"[{card}] tcp_citygrid_10k: " + json.dumps(out))
    return out, launches


# --- phase 25: periphery -------------------------------------------------------------

EXAMPLE_RUNS = {
    # each example's own sizes: the whole file for the batch examples, the
    # examples' default instruction caps (300) for the streams
    "hexagonal2d_slam": [],
    "live_slam": [],
    "tcp_interop": [],
    "manhattan_batch": ["{citygrid}", "{out}/manhattan_batch"],
    "mit_batch": ["{citygrid}", "{out}/mit_batch"],
    "manhattan_fixedlag": ["{stream}"],
    "manhattan_incremental": ["{stream}", "300", "10", "{out}/manhattan_incremental"],
}


def run_examples(card, out_dir, device="cuda", g2o=CITYGRID, poses=10000,
                 timeout=EXAMPLE_TIMEOUT_S):
    """Every examples/torch/*.py as a subprocess on ``device``, all started
    together (``g2o`` for the batch examples, its time-ordered stream of
    ``poses`` poses for the stream examples). Each must exit 0. Returns
    {name: seconds}."""
    os.makedirs(out_dir, exist_ok=True)
    stream = os.path.join(out_dir, "citygrid_stream.g2o")
    write_stream_g2o(stream, poses, src=g2o)
    env = dict(os.environ, PYTHONPATH=HERE)
    procs = {}
    for name, args in EXAMPLE_RUNS.items():
        argv = [a.format(citygrid=g2o, stream=stream, out=out_dir) for a in args]
        log = open(os.path.join(out_dir, f"{name}.log"), "w")
        procs[name] = (subprocess.Popen(
            [sys.executable, os.path.join(HERE, "examples", "torch", f"{name}.py"), *argv,
             "--device", device], cwd=HERE, env=env, stdout=log, stderr=subprocess.STDOUT),
            log, time.time())
    secs, failed, start = {}, [], time.time()
    while procs:
        for name, (p, log, t0) in list(procs.items()):
            rc = p.poll()
            if rc is None and time.time() - start > timeout:
                p.kill()
                rc = p.wait()
            if rc is not None:
                secs[name] = time.time() - t0
                log.close()
                del procs[name]
                if rc != 0:
                    failed.append((name, rc))
        time.sleep(0.05)
    print(f"[{card}] examples/torch: " + json.dumps({k: round(v, 2) for k, v in secs.items()}))
    for name, rc in failed:
        with open(os.path.join(out_dir, f"{name}.log")) as fh:
            print(f"--- {name} (exit {rc})\n" + fh.read()[-3000:])
    check(not failed, f"examples failed: {failed}")
    return secs


def periphery_path(card, bundle_phases, bee_keep, device="cuda", out_dir=None,
                   g2o=CITYGRID, gt_file=CITYGRID_GT, examples=True):
    """Phase 25, ``periphery``: a profiler trace of one warm citygrid solve
    (the captured LM program: the trace must name K1's kernel and the
    program's phase replays) and one solve of the program's eager runner
    with ``annotate`` around the linearize and the linear solve (the trace,
    in build/periphery_trace/, must name both: a replay makes no Python
    call to annotate); phase 23's
    PhaseTimer rows; the citygrid
    solve's plot_slam2d and one beehive belief's plot_kde as PNGs; the
    analysis helpers on phase 6's beehive solve against its parametric
    optimum; every torch example as a subprocess. Returns the result."""
    import torch

    from rome_tpu_torch import GNOptions, solve_graph_parametric
    from rome_tpu_torch.graph.lower import lower
    from rome_tpu_torch.services import analysis as A
    from rome_tpu_torch.services import plotting
    from rome_tpu_torch.solvers import gauss_newton as GN
    from rome_tpu_torch.solvers.linearize import runtime_state
    from rome_tpu_torch.utils.profiling import annotate, trace

    out_dir = out_dir or os.path.join(HERE, "chiprun_out", "periphery")
    os.makedirs(out_dir, exist_ok=True)
    fg = build_graph(g2o)
    # the eager runner's solve: another lowering of the same graph
    ga = lower(fg, "parametric", dtype=torch.float32, device=device)
    wrapped = [(GN, "linearize_all_mixed_j", "lm.linearize"),
               (GN.ParametricSolver, "_linear_solve", "lm.linear_solve")]
    saved = []
    for owner, name, label in wrapped:
        fn = getattr(owner, name)
        saved.append((owner, name, fn))

        def annotated(*a, _fn=fn, _label=label, **kw):
            with annotate(_label):
                return _fn(*a, **kw)

        setattr(owner, name, annotated)
    try:
        # the trace stays out of chiprun_out/ (tens of MB at this size)
        with trace(os.path.join(HERE, "build", "periphery_trace")) as logdir:
            res = solve_graph_parametric(fg, init=False, options=GNOptions(**BIG),
                                         chordal_init=True, device=device)
            GN.ParametricSolver.cached(ga, GNOptions(**BIG)).solve(None, runtime_state(ga),
                                                                 eager=True)
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)
    path = os.path.join(logdir, "trace.json")
    with open(path) as fh:
        names = {e.get("name", "") for e in json.load(fh)["traceEvents"]}
    k1_named = any("pose2pose2_kernel" in n for n in names)
    replays = sorted(n for n in names if n.startswith("lm_ndchol"))
    traced = dict(file=os.path.relpath(path, HERE), bytes=os.path.getsize(path),
                  events=len(names), annotations=sorted(n for n in names if n.startswith("lm.")),
                  program_replays=replays, k1_kernel_named=k1_named,
                  iterations=res["stats"].iterations)
    print(f"[{card}] periphery trace: " + json.dumps(traced))
    check({"lm.linearize", "lm.linear_solve"} <= names, "the trace lacks the annotations")
    check(device != "cuda" or any(n.endswith(".iterate") for n in replays),
          "the trace does not name the LM program's replays")
    check(device != "cuda" or k1_named, "the trace does not name K1's kernel")
    print(f"[{card}] periphery: PhaseTimer rows of phase 23: " + json.dumps(bundle_phases))
    gt = np.load(gt_file)
    pngs = {"citygrid_slam2d.png": lambda p: plotting.plot_slam2d(
        fg, path=p, title="citygrid_10k", gt=gt["poses"])}
    bee, bee_truth = bee_keep
    mid = f"x{len(bee.ls(r'^x[0-9]+$')) // 2}"
    pngs[f"beehive_{mid}_kde.png"] = lambda p: plotting.plot_kde(
        bee.variables[mid].beliefs["default"], path=p)
    try:
        import matplotlib  # noqa: F401 -- plotting's one dependency beyond torch
    except ImportError:
        # the machine with the card may lack it: the figures are then drawn
        # by the CPU tests only (tests/test_torch_plotting.py)
        sizes = "not drawn: matplotlib is not installed on this machine"
        print(f"[{card}] periphery: {sizes}")
    else:
        sizes = {}
        for name, draw in pngs.items():
            p = os.path.join(out_dir, name)
            draw(p)
            sizes[name] = os.path.getsize(p)
            check(sizes[name] > 0, f"{name} is empty")
    b_np = A.predict_body_br(bee, "x0", "l1")
    b_opt = A.predict_body_br(bee_truth, "x0", "l1", solve_key="parametric")
    errs = A.range_comp_all_poses(bee, bee_truth)
    analysis = dict(predict_body_br_belief=b_np, predict_body_br_optimum=b_opt,
                    mahalanobis_br=A.mahalanobis_br(b_np, b_opt, np.diag([0.05 ** 2, 0.5 ** 2])),
                    range_comp_all_poses_mean_m=float(errs.mean()),
                    range_comp_all_poses_max_m=float(errs.max()), poses=int(len(errs)))
    print(f"[{card}] periphery analysis on the beehive solve: " + json.dumps(analysis))
    check(len(errs) == len(bee_truth.ls(r"^x\d+$")) and np.isfinite(errs).all(),
          "range_comp_all_poses: poses missing or not finite")
    check(errs.mean() < BEEHIVE_GATE_M, f"beehive mean range error {errs.mean()} m")
    ex = run_examples(card, os.path.join(out_dir, "examples"), device, g2o,
                      len(gt["poses"])) if examples else {}
    return dict(trace=traced, phase23_rows=bundle_phases, pngs=sizes, analysis=analysis,
                examples_s=ex)


def kernel_table(k1, k23, k1_launches, np_launches, param_launches, np_by_path, dist_by_rank,
                 path_inputs, entry_inputs):
    """The kernels JSON line: K1 by its two epilogues (normal launched by the
    speculative citygrid path, the host-scheduled solve and the NN-mixture
    chain of phase 15, lin by the
    dense32, mixed, pcg and covariance paths, the parametric optima of the
    nonparametric paths and every rank of the distributed paths; each path
    counted from 0, ``launches_by_path``), and K2/K3 by their draw epilogues
    (what the paths launch, per path in ``launches_by_path``) with their
    logw epilogues nested. The distributed paths' launches are summed over
    their ranks and world sizes in ``launches_by_path`` and listed per world
    and rank in ``launches_by_rank``; ``path_inputs``: the checks of each
    kernel on the inputs those paths gave it (``PathInputs``), and
    ``entry_point_inputs`` the same on the measuring entry points' inputs
    (bench_torch, bench_multimodal, incremental_bench). Times and bounds at
    n = 13,085, with 1,048,576 nested."""
    def dist_sum(key):
        return {p: sum(r[key] for ranks in w.values() for r in ranks)
                for p, w in dist_by_rank.items() if w}

    def dist_ranks(key):
        return {p: {world: [r[key] for r in ranks] for world, ranks in w.items()}
                for p, w in dist_by_rank.items() if w}

    kernels = []
    for epi, name in (("lin", "pose2pose2_linearize"), ("normal", "pose2pose2_normal")):
        by_path = {"citygrid_10k": k1_launches[epi],
                   **{k: v[epi] for k, v in param_launches.items()},
                   "nonparametric_optima": np_launches[f"k1_{epi}"],
                   **{p: n for p, n in dist_sum(f"k1_{epi}").items()
                      if not p.startswith("sharded_beehive")}}
        t, big = k1[epi][f"n={K1_TIMED[0]}"], k1[epi][f"n={K1_TIMED[1]}"]
        kernels.append(dict(
            name=name, source="pose2pose2_linearize.cu",
            replaces="rome_tpu/ops/linearize_pallas.py:54",
            launches=sum(by_path.values()), launches_by_path=by_path,
            launches_by_rank={p: r for p, r in dist_ranks(f"k1_{epi}").items()
                              if not p.startswith("sharded_beehive")},
            **({"path_inputs": path_inputs["lin"]} if epi == "lin" else {}),
            entry_point_inputs=entry_inputs[epi],
            max_abs_err=k1[epi]["max_abs_err"], ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=None,
            shape=[K1_TIMED[0]],
            **{f"n={K1_TIMED[1]}": {k: big[k] for k in ("ms", "plain_ms", "bound_ms",
                                                         "bound_by", "share_of_bound")}}))
    for k, name, tpu, V in (("K2", "se2", "rome_tpu/ops/pairwise.py:75", 101),
                            ("K3", "euclid", "rome_tpu/ops/pairwise.py:126", 74)):
        t = k23[k]["timed"][f"V={V}"]
        # the draw epilogue is what the paths launch; its error is the worst
        # score gap of a label that differs from the plain draw's
        key = f"{name}_gibbs_draw"
        sharded = {p: n for p, n in dist_sum(key).items() if p.startswith("sharded_beehive")}
        kernels.append(dict(
            name=key, source="pairwise_logw.cu", replaces=tpu,
            launches=np_launches[key] + sum(sharded.values()),
            launches_by_path={**{p: l[key] for p, l in np_by_path.items()}, **sharded},
            launches_by_rank={p: r for p, r in dist_ranks(key).items() if p in sharded},
            path_inputs=path_inputs[key], entry_point_inputs=entry_inputs[key],
            max_abs_err=k23[k]["draw_max_gap"],
            ms=t["draw"], plain_ms=t["plain_draw"], bound_ms=t["draw_bound_ms"],
            bound_by=t["draw_bound_by"], library_ms=None, shape=[V, BEEHIVE_N, BEEHIVE_N],
            label_agreement=1.0 - k23[k]["draw_rows_differ"] / k23[k]["draw_rows"],
            logw=dict(launches=np_launches[f"{name}_pairwise_logw"],
                      max_abs_err=k23[k]["max_abs_err"], ms=t["logw"], plain_ms=t["plain_logw"],
                      bound_ms=t["logw_bound_ms"], bound_by=t["logw_bound_by"],
                      library_ms=t.get("library"))))
    return [dict(r, route="cuda", source=f"rome_tpu_torch/csrc/{r['source']}")
            for r in kernels]


def build_all(card):
    """One nvcc per kernel source, all started together."""
    from rome_tpu_torch.ops import linearize_cuda, nvcc_build, pairwise_cuda
    from rome_tpu_torch.utils import device_loop

    t0 = time.time()
    mods = (linearize_cuda, pairwise_cuda, device_loop)
    with ThreadPoolExecutor(max_workers=len(mods)) as pool:
        libs = list(pool.map(lambda m: m.build(), mods))
    build_s = time.time() - t0
    for lib in libs:
        print(f"[{card}] built {os.path.relpath(lib, HERE)}")
    print(f"[{card}] kernel build {build_s:.2f} s")
    for src, log in nvcc_build.BUILD_LOGS.items():
        print(f"--- ptxas {src}\n{log}")
    return build_s


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    t_start = time.time()
    build_s = build_all(card)
    bytes_per_s = stream_bandwidth(card)
    k1 = kernel_phase(card, bytes_per_s)
    k23 = pairwise_phase(card, bytes_per_s)
    fixed_order = fixed_order_check(card)
    # the measuring entry points' own kernel inputs, recorded per path
    entry = PathInputs()
    entry.path = "bench_torch"
    t0 = time.time()
    with ChordalStarts() as starts:
        runs, launches, bench = main_path(card)
        entry.path = None
        repeats = citygrid_repeat_check(card, runs, starts)
    warm = [r["solve_time_s"] for r in runs[1:]]
    print(f"[{card}] citygrid_10k (bench_torch, {time.time() - t0:.1f} s with its other rows): "
          f"cold {runs[0]['solve_time_s']:.3f} s, warm "
          f"{', '.join(f'{w:.3f}' for w in warm)} s, best {10000 / min(warm):.1f} poses/s, "
          f"{[r['iterations'] for r in runs]} LM iterations, K1 launches {launches}")
    t0 = time.time()
    fused = fused_program_path(card)
    print(f"[{card}] fused_program: {time.time() - t0:.1f} s")
    t0 = time.time()
    params, param_launches = parametric_solvers_path(card)
    print(parametric_summary(card, params, param_launches, time.time() - t0))
    bee_keep = []
    entry.path = "beehive_100pose"
    bee, bee_launches = beehive_path(card, keep=bee_keep)
    secs = ", ".join(f"{r['solve_time_s']:.3f}" for r in bee["runs"])
    errs = ", ".join(f"{r['mean_pose_err_m']:.4f}" for r in bee["runs"])
    print(f"[{card}] beehive_{BEEHIVE_POSES} N={BEEHIVE_N}: solves (cold, warm, warm) "
          f"{secs} s, mean pose error {errs} m, K2/K3 launches {bee_launches}")
    np_paths = {"beehive_points": (bee, bee_launches)}
    for name, path in (("honeycomb_grow_default", honeycomb_path),
                       ("bayes_tree_grow", bayes_tree_path),
                       ("hexagonal_7pose", hexagonal_path),
                       ("multihypo_range_bearing", multihypo_path)):
        t0 = time.time()
        entry.path = name
        np_paths[name] = path(card)
        print(f"[{card}] {name}: {time.time() - t0:.1f} s, launches {np_paths[name][1]}")
    entry.path = None
    t0 = time.time()
    sphere, sphere_launches = sphere_path(card)
    warm = [r["solve_time_s"] for r in sphere["runs"][1:]]
    print(f"[{card}] sphere_se3_2500: {time.time() - t0:.1f} s; ndchol cold "
          f"{sphere['runs'][0]['solve_time_s']:.3f} s, warm {', '.join(f'{w:.3f}' for w in warm)} s, "
          f"best {sphere['poses'] / min(warm):.1f} poses/s, "
          f"{[r['iterations'] for r in sphere['runs']]} LM iterations (dense f64 reference "
          f"{sphere['dense']['iterations']}); K1 launches {sphere_launches}")
    t0 = time.time()
    se3_np, se3_np_launches = se3_nonparametric_path(card)
    print(f"[{card}] se3_nonparametric: {time.time() - t0:.1f} s, launches {se3_np_launches}")
    for name, l in se3_np_launches.items():
        np_paths[name] = (se3_np[name], l)
    np_paths["pose3_nullhypo"] = (se3_np["nullhypo"], se3_np["nullhypo"]["launches"])
    # tools/torch/bench_multimodal.py's six rows and its roll-up
    multimodal = BM.summarize({"hexagonal_7pose": np_paths["hexagonal_7pose"][0],
                               "honeycomb_grow_default": np_paths["honeycomb_grow_default"][0],
                               "beehive_100pose": bee,
                               "bayes_tree_grow": np_paths["bayes_tree_grow"][0],
                               "multihypo_range_bearing": np_paths["multihypo_range_bearing"][0],
                               "pose3_nullhypo": se3_np["nullhypo"]}, card)
    print(f"[{card}] bench_multimodal gates: {json.dumps(multimodal['gates'])}, all_gates_pass "
          f"{multimodal['all_gates_pass']}")
    check(multimodal["all_gates_pass"], f"bench_multimodal gates {multimodal['gates']}")
    t0 = time.time()
    imu, imu_launches = imu_path(card)
    warm = [r["solve_time_s"] for r in imu["runs"][1:]]
    print(f"[{card}] imu_euroc_mh01: {time.time() - t0:.1f} s; graph build {imu['build_s']:.2f} s; "
          f"ndchol cold {imu['runs'][0]['solve_time_s']:.3f} s, warm "
          f"{', '.join(f'{w:.3f}' for w in warm)} s, best {imu['keyframes'] / min(warm):.1f} "
          f"keyframes/s, {[r['iterations'] for r in imu['runs']]} LM iterations (dense f64 "
          f"reference {imu['dense']['iterations']}); K1 launches {imu_launches}")
    t0 = time.time()
    rest, rest_launches = factor_library_rest_path(card)
    print(f"[{card}] factor_library_rest: {time.time() - t0:.1f} s, launches {rest_launches}")
    for name in ("dynpoint2_chain", "fluxmix_pose2_chain"):
        np_paths[name] = (rest[name], rest_launches[name])
    param_launches["fluxmix_chain_500"] = {
        epi: rest_launches["fluxmix_chain"][f"k1_{epi}"] for epi in ("lin", "normal")}
    t0 = time.time()
    entry.path = "incremental_bench"
    fixedlag, fixedlag_launches = fixedlag_path(card)
    entry.path = None
    print(f"[{card}] fixedlag_citygrid_{FIXEDLAG_POSES} (incremental_bench): "
          f"{time.time() - t0:.1f} s, launches {fixedlag_launches}")
    entry_inputs = _check_entry_inputs(card, entry)
    t0 = time.time()
    live, live_launches = live_slam_path(card)
    print(f"[{card}] live_slam_checkpoint: {time.time() - t0:.1f} s, launches {live_launches}")
    t0 = time.time()
    tracker, tracker_launches = wheeled_tracker_path(card)
    print(f"[{card}] wheeled_tracker: {time.time() - t0:.1f} s, launches {tracker_launches}")
    t0 = time.time()
    dist, dist_by_rank = distributed_path(card, distributed_inputs(card))
    print(f"[{card}] distributed phases 20-22: {time.time() - t0:.1f} s")
    t0 = time.time()
    bundle, bundle_launches = vision_bundle_path(card)
    print(f"[{card}] vision_bundle_ladybug49: {time.time() - t0:.1f} s, "
          f"launches {bundle_launches}")
    np_paths["vision_bundle_ladybug49"] = ({"phase": 23}, bundle_launches)
    param_launches["vision_bundle_ladybug49"] = {
        epi: bundle_launches[f"k1_{epi}"] for epi in ("lin", "normal")}
    t0 = time.time()
    tcp, tcp_launches = tcp_path(card)
    print(f"[{card}] tcp_citygrid_10k: {time.time() - t0:.1f} s, launches {tcp_launches}")
    param_launches["tcp_citygrid_10k"] = {
        epi: tcp_launches[f"k1_{epi}"] for epi in ("lin", "normal")}
    t0 = time.time()
    periphery = periphery_path(card, bundle["phases"], bee_keep)
    print(f"[{card}] periphery: {time.time() - t0:.1f} s")
    detail = bench["detail"]
    param_launches["bench_torch_covariance_recovery"] = {
        epi: detail["covariance_recovery"]["launches"][f"k1_{epi}"] for epi in ("lin", "normal")}
    param_launches["bench_kernels"] = {
        epi: detail["kernel_speed_of_light"]["launches"][f"k1_{epi}"] for epi in ("lin", "normal")}
    for name, key in (("fixedlag_citygrid_3500", "fixedlag"),
                      ("fixedlag_batch_optimum", "fixedlag_batch"),
                      (f"incremental_{FIXEDLAG_INCREMENTAL}", "incremental"),
                      ("fixedlag_window_checks", "fixedlag_checks")):
        param_launches[name] = {epi: fixedlag_launches[key][f"k1_{epi}"]
                                for epi in ("lin", "normal")}
    param_launches["live_slam_checkpoint"] = {
        epi: live_launches["live_loop"][f"k1_{epi}"] + live_launches["live_resolve"][f"k1_{epi}"]
        for epi in ("lin", "normal")}
    param_launches["live_window_check"] = {
        epi: live_launches["live_window_check"][f"k1_{epi}"] for epi in ("lin", "normal")}
    np_paths["wheeled_tracker"] = (tracker, tracker_launches)
    for name, (_r, l) in np_paths.items():
        if name == "wheeled_tracker":
            continue
        draws = (l["se2_gibbs_draw"], l["euclid_gibbs_draw"])
        check(draws == PATH_DRAWS[name],
              f"{name}: K2/K3 draw launches {draws}, expected {PATH_DRAWS[name]}")
    np_launches = {k: sum(l[k] for _r, l in np_paths.values()) for k in bee_launches}
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump({"card": card, "build_s": build_s, "stream_bytes_per_s": bytes_per_s,
                   "k1": k1, "k2_k3": k23, "runs": runs, "parametric_solvers": params,
                   "parametric_launches": param_launches,
                   "nonparametric": {k: {"result": r, "launches": l}
                                     for k, (r, l) in np_paths.items()},
                   "sphere_se3_2500": sphere, "se3_nonparametric": se3_np,
                   "imu_euroc_mh01": imu, "factor_library_rest": rest,
                   "fixedlag_citygrid_3500": fixedlag, "live_slam_checkpoint": live,
                   "wheeled_tracker": tracker, "distributed": dist,
                   "fixed_order": fixed_order, "citygrid_repeats": repeats,
                   "fused_program": fused,
                   "vision_bundle_ladybug49": bundle,
                   "tcp_citygrid_10k": tcp, "periphery": periphery,
                   "bench_torch": bench, "bench_multimodal": multimodal,
                   "entry_point_inputs": entry_inputs,
                   "distributed_launches_by_rank": dist_by_rank,
                   "seconds": time.time() - t_start}, fh, indent=1, default=float)

    print(json.dumps({"kernels": kernel_table(k1, k23, launches, np_launches, param_launches,
                                              {k: l for k, (_r, l) in np_paths.items()},
                                              dist_by_rank, dist["path_inputs"],
                                              entry_inputs)}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
