"""The Sphere2500 cell's plain SE(3) reference (benchmark/se3_reference.py)
and world (benchmark/sphere_world.py) against the port, on the CPU:

- the reference's whitened Pose3Pose3 and PriorPose3 residuals equal the
  port's ``_pose3pose3_res`` and ``_prior_pose3_res`` whitened alike, on 64
  seeded pose pairs in float64: their raw residuals within 1e-12 of the
  residual's size, so the whitened ones within that times |S|;
- the port's ndchol ``big`` solve of a small sphere (4 laps x 50) from dead
  reckoning lies within the cell's ``cost_excess`` rule and its
  ``ate_to_opt_m`` limit of the reference's optimum; the program's eager
  runner stamps ``lm.trial_linearize`` once an executed iteration, inside
  ``lm.linearize``;
- the world's truth and edges equal chip_smoke.py's ``sphere_truth`` and
  ``sphere_edges`` (4,949 edges at 50 x 50), its measurements at noise
  seed 0 chip_smoke's ``write_sphere_g2o(seed=0)`` edges;
- the reference side imports no module of JAX, of the JAX package or of
  the port (a fresh interpreter).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402
import rome_tpu_torch as T  # noqa: E402
from benchmark import se3_judge as SJ  # noqa: E402
from benchmark import se3_reference as R  # noqa: E402
from benchmark import sphere_world as SW  # noqa: E402
from benchmark.drivers.resolve_se3 import load  # noqa: E402
from rome_tpu_torch.factors.pose3 import _pose3pose3_res, _prior_pose3_res  # noqa: E402
from rome_tpu_torch.utils import profiling  # noqa: E402

with open(os.path.join(ROOT, "benchmark", "configs", "sphere2500.json")) as _fh:
    CONFIG = json.load(_fh)
LAPS, PER_LAP = 4, 50


def _pairs(rng, n=64):
    """``n`` pose pairs (p, q) and measurements z at the sphere's scales:
    positions within 100 m, any rotation; q either anywhere or near p o
    exp(z) (a graph's edge)."""
    def poses(k):
        q = rng.normal(size=(k, 4))
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        return torch.as_tensor(np.concatenate([rng.uniform(-100, 100, (k, 3)), q], axis=1))

    p = poses(n)
    z = torch.as_tensor(np.concatenate([rng.normal(0, 10, (n, 3)), rng.normal(0, 0.5, (n, 3))],
                                       axis=1))
    near = R.retract(R.compose(p, R.exp(z)),
                     torch.as_tensor(rng.normal(0, [0.05] * 3 + [0.005] * 3, (n, 6))))
    far = poses(n)
    return p, z, torch.where(torch.as_tensor(rng.random(n) < 0.5)[:, None], near, far)


def test_residuals_equal_the_ports():
    rng = np.random.default_rng(23)
    p, z, q = _pairs(rng)
    S = R.sqrt_info([CONFIG["world"]["sigma_t"]] * 3 + [CONFIG["world"]["sigma_r"]] * 3)
    norm_S = float(torch.linalg.matrix_norm(S, ord=2))
    cases = [(R.between_residual(z, p, q), _pose3pose3_res({"z": z}, p, q)),
             (R.prior_residual(z, p), _prior_pose3_res({"z": z}, p))]
    for mine, port in cases:
        assert mine.dtype == port.dtype == torch.float64
        scale = 1.0 + float(port.abs().max())
        assert float((mine - port).abs().max()) <= 1e-12 * scale
        assert float((mine @ S.T - port @ S.T).abs().max()) <= 1e-12 * scale * norm_S


def test_world_is_chip_smokes_sphere(tmp_path):
    truth = SW.truth(LAPS, PER_LAP)
    assert np.allclose(truth, C.sphere_truth(LAPS, PER_LAP), rtol=0, atol=1e-14)
    assert SW.edges(LAPS, PER_LAP) == C.sphere_edges(LAPS, PER_LAP)
    assert len(SW.edges()) == 4949 and SW.edges() == C.sphere_edges()
    w = SW.structure(LAPS, PER_LAP)
    meas = SW.measurements(w, 0)
    path = str(tmp_path / "sphere.g2o")
    C.write_sphere_g2o(path, LAPS, PER_LAP, seed=0)
    fg = C.build_sphere_graph(path)
    for k, (a, b) in enumerate(zip(w.i, w.j)):
        f = fg.factors[fg._fct_order[k]]
        assert list(f.variables) == [f"x{a}", f"x{b}"]
        want = R.log(torch.as_tensor(meas[k]))
        assert np.allclose(f.params["z"], want.numpy(), rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def sphere(tmp_path_factory):
    """A small sphere's graph as the cell loads it, its reference problem,
    start and optimum."""
    w = SW.structure(LAPS, PER_LAP)
    meas = SW.measurements(w, [0, 0])
    start = SW.dead_reckon(w, meas)
    path = str(tmp_path_factory.mktemp("sphere") / "sphere.g2o")
    SW.write_g2o(path, w, meas, start)
    problem = SW.problem(w, meas, CONFIG["prior_sigmas"])
    return path, problem, start, SJ.optima([problem], [start])[0]


def test_port_solve_meets_the_cells_limits(sphere):
    path, problem, start, opt = sphere
    assert opt[3] and opt[1] < R.cost(problem, start)
    fg = load(path, CONFIG["dtype"], CONFIG["prior_sigmas"])
    profiling.enable(True)
    solver = CONFIG["solver"]
    res = T.solve_graph_parametric(fg, init=False, options=T.GNOptions(**solver["options"]),
                                   chordal_init=solver["chordal_init"],
                                   schedule=solver["schedule"], pad=solver["pad"],
                                   device="cpu")
    root = profiling.roots()[-1]
    answer = np.stack([fg.get_point(f"x{k}") for k in range(LAPS * PER_LAP)])
    readings = SJ.readings(problem, opt, [answer], CONFIG["gates"])
    assert all(v <= lim for v, lim in readings.values()), readings
    it = res["stats"].iterations
    calls, ns = root.attrs["calls"], root.attrs["device_ns"]
    assert it >= 1 and calls["lm.trial_linearize"] == calls["lm.linearize"] == it
    assert 0 < ns["lm.trial_linearize"] <= ns["lm.linearize"]
    assert "lm.chordal" not in calls


def test_reference_side_imports_nothing_of_jax_or_the_packages():
    code = ("import sys; sys.path.insert(0, '.'); "
            "import benchmark.se3_reference, benchmark.sphere_world, benchmark.se3_judge, "
            "benchmark.roofline_se3; "
            "print(sorted({m.partition('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, check=True)
    names = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not names & {"jax", "jaxlib", "flax", "rome_tpu", "rome_tpu_torch"}, names
