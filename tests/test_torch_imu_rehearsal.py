"""A 61-keyframe, 3-window rehearsal of chip_smoke.py's ``imu_euroc_mh01``
(``chip_smoke.imu_graph``: the EuRoC-rate stream, RotVelPosBias IMU factors,
one IMUBias per 20 keyframe gaps, 1 Hz position fixes, dead-reckoned start)
in both packages on the CPU.

- The graphs: each package's stream from its own simulator; every
  factor's params within 1e-10 (the JAX graph's IMU factors carry the
  port's preintegration, ``_jax_imu_factor``, and a sample of the port's
  factors, the first and last of each bias window, are held at 1e-10 to the
  JAX package's own preintegration of the same samples); the dead-reckoned
  start within 1e-3 (the JAX package's initializer runs in float32).
- The port's dense LM in float64 and its ndchol with the smoke run's IMU
  options (``big`` with the dtol stop off), the CG polish run to 1e-10 as
  tests/test_torch_pose3_slice.py does, each within 1e-6 m of the JAX
  package's dense LM under x64 at every keyframe, under the smoke run's
  truth gate.
- The LM iterations: the port's and the JAX package's own ndchol with the
  same options take the same count, 10, and the dense LM 11, so the JAX
  package's float32 Jacobians through the cancelling SGal(3) coefficients
  cost it no iteration here; the ``big`` options as they are stop by dtol
  after 1 iteration in both packages, far above the optimum (dtol_auto's
  scale is 1.0 on this graph: it has no arity-2 batch).
"""

import copy
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import rome_tpu as R  # noqa: E402
import rome_tpu_torch as T  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
import chip_smoke as C  # noqa: E402

TOL = 1e-10
REHEARSAL = dict(keyframes=61, window=20)
def _rehearsal_positions(fg):
    return C.imu_positions(fg, REHEARSAL["keyframes"])


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


def _jax_imu_factor(*args, signature="RotVelPos", **kw):
    """The JAX package's IMUDeltaFactor with the port's preintegration (the
    two are held to each other at 1e-10 in tests/test_torch_inertial.py;
    the JAX package's own scan costs about 0.5 s a factor on the CPU)."""
    from rome_tpu.factors import inertial as JI

    ft = T.IMUDeltaFactor(*args, signature=signature, **kw)
    ftype = {"RotVelPos": JI.IMU_DELTA_RVP, "RotVelPosBias": JI.IMU_DELTA_RVP_BIAS,
             "Pose3VelPos3": JI.IMU_DELTA_P3VP}[signature]
    d = ft.dists[0]
    return R.Factor(ftype=ftype, variables=(), params=dict(ft.params),
                    dists=(R.MvNormal(d.mean(), d.cov()),))


def _jax_stream():
    from rome_tpu.canonical import inertial_sim

    return inertial_sim.generate_field_inertial_measurement(
        **C.imu_stream_args(REHEARSAL["keyframes"]))


@pytest.fixture(scope="module")
def graphs():
    fg_t, _ = C.imu_graph(T, **REHEARSAL)
    with jax.enable_x64(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(R, "IMUDeltaFactor", _jax_imu_factor)
        fg_j, _ = C.imu_graph(R, **REHEARSAL, stream=_jax_stream())
    return fg_t, fg_j


@pytest.fixture(scope="module")
def rehearsal(graphs):
    """Both packages' solves of the rehearsal graph: the dense LM in float64
    (chip_smoke.SPHERE_DENSE), ndchol with the smoke run's IMU options and
    the CG polish run to 1e-10 (as tests/test_torch_pose3_slice.py does),
    and ndchol with the ``big`` options as they are (the dtol stop on)."""
    polished = dict(C.IMU_BIG, polish_tol=1e-10, polish_iters=200)
    out = {}
    fg_t, fg_j = graphs
    for name, opts, dt in (("dense", C.SPHERE_DENSE, torch.float64), ("ndchol", polished, None),
                           ("big", C.BIG, None)):
        fg = copy.deepcopy(fg_t)
        res = T.solve_graph_parametric(fg, init=False, options=T.GNOptions(**opts), dtype=dt,
                                       device="cpu")
        out[("port", name)] = (res["stats"], _rehearsal_positions(fg), fg)
    with jax.enable_x64():
        for name, opts, dt in (("dense", C.SPHERE_DENSE, jnp.float64), ("ndchol", polished, None),
                               ("big", C.BIG, None)):
            fg = copy.deepcopy(fg_j)
            res = R.solve_graph_parametric(fg, init=False, options=R.GNOptions(**opts), dtype=dt)
            out[("jax", name)] = (res["stats"], _rehearsal_positions(fg), fg)
    return out


def test_rehearsal_graph_matches_jax(graphs):
    fg_t, fg_j = graphs
    assert fg_t._var_order == fg_j._var_order and fg_t._fct_order == fg_j._fct_order
    for fl in fg_j._fct_order:
        for k, v in fg_j.factors[fl].params.items():
            w = fg_t.factors[fl].params[k]
            if k == "sqrt_info":
                assert _rel(w, v) < TOL
            else:
                np.testing.assert_allclose(w, v, atol=TOL, rtol=0, err_msg=k)
    # dead reckoning: the JAX initializer runs in float32
    for label in fg_j._var_order:
        np.testing.assert_allclose(fg_t.get_point(label), fg_j.get_point(label), atol=1e-3)


def test_rehearsal_preintegration_matches_jax_scan(graphs):
    """The first and last IMU factor of each bias window: the port's params
    against the JAX package's own IMUDeltaFactor (its ``lax.scan``) over the
    same 20 samples of the JAX simulator's stream, at 1e-10."""
    fg_t, _ = graphs
    stream = _jax_stream()
    dts = np.full(C.IMU_SAMPLES, C.IMU_DT)
    window, n = REHEARSAL["window"], REHEARSAL["keyframes"] - 1
    sample = sorted({k for w in range(0, n, window) for k in (w, min(w + window, n) - 1)})
    imu = [fl for fl in fg_t._fct_order if len(fg_t.factors[fl].variables) == 3]
    assert len(imu) == n and len(sample) == 6
    with jax.enable_x64():
        for k in sample:
            s = slice(k * C.IMU_SAMPLES, (k + 1) * C.IMU_SAMPLES)
            ref = R.IMUDeltaFactor(stream.accels[s], stream.gyros[s], dts, stream.Sigma_y,
                                   signature="RotVelPosBias")
            got = fg_t.factors[imu[k]]
            assert got.variables == (f"x{k}", f"x{k + 1}", f"b{k // window}")
            for key, v in ref.params.items():
                w = got.params[key]
                if key == "sqrt_info":
                    assert _rel(w, v) < TOL
                else:
                    np.testing.assert_allclose(w, v, atol=TOL, rtol=0, err_msg=key)


@pytest.mark.parametrize("which", ["dense", "ndchol"])
def test_rehearsal_optimum_matches_jax(rehearsal, which):
    st, pos, fg = rehearsal[("port", which)]
    ref_st, ref, _ = rehearsal[("jax", "dense")]
    assert st.converged and ref_st.converged
    np.testing.assert_allclose(pos, ref, atol=1e-6, rtol=0)
    assert st.final_cost <= ref_st.final_cost * (1 + 1e-9) + 1e-9
    # the smoke run's gates at this size
    truth = C.imu_truth(REHEARSAL["keyframes"])[:, 7:10]
    assert C._rmse(pos, truth) <= C.IMU_TRUTH_GATE_M
    bias = C._bias_estimates(fg)
    assert bias.shape == (3, 6) and np.isfinite(bias).all()


def test_rehearsal_lm_iterations(rehearsal):
    """The iterations each package's ndchol takes, beside the dense LM's,
    and the dtol stop of the ``big`` options as they are: dtol_auto's scale
    is 1.0 on this graph (no arity-2 batch), and in both packages the stop
    fires in the first iterations, far above the optimum (the reason the
    smoke run's IMU path turns it off)."""
    its = {k: v[0].iterations for k, v in rehearsal.items()}
    print("LM iterations", its)
    opt = rehearsal[("jax", "dense")][0].final_cost
    for pkg in ("port", "jax"):
        st = rehearsal[(pkg, "big")][0]
        assert st.reason == "dtol" and st.iterations <= 3 and st.final_cost > 10 * opt
        assert rehearsal[(pkg, "ndchol")][0].converged
    assert its[("port", "ndchol")] == its[("jax", "ndchol")]
    assert its[("port", "dense")] == its[("jax", "dense")]
