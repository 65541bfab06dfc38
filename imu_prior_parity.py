#!/usr/bin/env python3
"""Both packages' solves of chip_smoke.py's ``imu_euroc_mh01`` graph with a
chosen sigma on the gyroscope half of every PriorIMUBias, on the CPU.

    JAX_PLATFORMS=cpu python imu_prior_parity.py KEYFRAMES [SIGMA_W] [ITERS] [SOLVES]

SIGMA_W (default 0.1, the accelerometer half stays at 0.1) replaces
chip_smoke.IMU_BIAS_SIGMAS's gyroscope half; ITERS (default 100) is
max_iters; SOLVES is a comma-separated subset of ``pd`` (the port's dense LM
in float64), ``pn`` (the port's ndchol with chip_smoke.IMU_BIG), ``jn`` (the
JAX package's ndchol with the same options, under x64) and ``jd`` (the JAX
package's dense LM in float64); default all four. Each package builds its
graph from its own simulator's stream; the JAX graph's IMU factors carry the
port's preintegration (held to the JAX package's at 1e-10 by
tests/test_torch_inertial.py). Prints one JSON line per solve: LM
iterations, converged, reason, final cost, position RMSE to the truth and
to the port's dense optimum (when ``pd`` ran first), seconds.

The dense solves hold a (9 K + 57)^2 float64 matrix: keep KEYFRAMES small
on a shared CPU.
"""

import copy
import json
import sys
import time

import jax
import jax.numpy as jnp
import torch

import chip_smoke as C
import rome_tpu as R
import rome_tpu_torch as T
from rome_tpu.canonical import inertial_sim as JS
from rome_tpu.factors import inertial as JI


def _jax_imu_factor(*args, signature="RotVelPos", **kw):
    ft = T.IMUDeltaFactor(*args, signature=signature, **kw)
    ftype = {"RotVelPos": JI.IMU_DELTA_RVP, "RotVelPosBias": JI.IMU_DELTA_RVP_BIAS}[signature]
    d = ft.dists[0]
    return R.Factor(ftype=ftype, variables=(), params=dict(ft.params),
                    dists=(R.MvNormal(d.mean(), d.cov()),))


def main(keyframes, sigma_w=0.1, iters=100, solves=("pd", "pn", "jn", "jd")):
    C.IMU_BIAS_SIGMAS = [0.1] * 3 + [sigma_w] * 3
    fg_t, _ = C.imu_graph(T, keyframes)
    stream = JS.generate_field_inertial_measurement(**C.imu_stream_args(keyframes))
    with jax.enable_x64():
        R.IMUDeltaFactor = _jax_imu_factor
        fg_j, _ = C.imu_graph(R, keyframes, stream=stream)
    truth = C.imu_truth(keyframes)[:, 7:10]
    ndchol = dict(C.IMU_BIG, max_iters=iters)
    dense = dict(C.SPHERE_DENSE, max_iters=iters)
    ref = None
    for name in solves:
        t0 = time.time()
        opts = dense if name[1] == "d" else ndchol
        if name[0] == "p":
            fg = copy.deepcopy(fg_t)
            res = T.solve_graph_parametric(fg, init=False, options=T.GNOptions(**opts),
                                           dtype=torch.float64 if name == "pd" else None,
                                           device="cpu")
        else:
            with jax.enable_x64():
                fg = copy.deepcopy(fg_j)
                res = R.solve_graph_parametric(fg, init=False, options=R.GNOptions(**opts),
                                               dtype=jnp.float64 if name == "jd" else None)
        st, pos = res["stats"], C.imu_positions(fg, keyframes)
        if name == "pd":
            ref = pos
        print(name, json.dumps(dict(
            keyframes=keyframes, sigma_w=sigma_w, iterations=int(st.iterations),
            converged=bool(st.converged), reason=str(st.reason), final_cost=float(st.final_cost),
            truth_rmse_m=C._rmse(pos, truth), rmse_to_port_dense_m=None if ref is None else
            C._rmse(pos, ref), seconds=time.time() - t0)), flush=True)


if __name__ == "__main__":
    a = sys.argv[1:]
    main(int(a[0]), float(a[1]) if len(a) > 1 else 0.1, int(a[2]) if len(a) > 2 else 100,
         tuple(a[3].split(",")) if len(a) > 3 else ("pd", "pn", "jn", "jd"))
