"""The port's TCP string-protocol server against the JAX package's:
tests/test_interop.py's session (examples/tcpstrings/SimpleExample.jl's
command sequence) and error replies over a real socket on the port's server
(``device="cpu"``), and the same command sequence through both packages'
sessions. GETPARTICLES of an unsolved graph gives the same rows in both
packages within 1e-6 relative (both sample with numpy's ``default_rng(0)``
from float32 marginal covariances of the same float64 points; the rows are
printed to 8 significant digits); after BATCHSOLVE within 1e-3 (the solves'
parity tolerance, ROADMAP north star). The first pose's marginal is its
prior's, diag(0.01, 0.01, 0.0025), with a repeated eigenvalue: numpy's SVD
sampler may take any basis of that eigenspace, so covariances equal to
float32 rounding give rows rotated within it; there the distance of every
row from the mean agrees instead (a rotation keeps it)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rome_tpu.interop import tcp_server as JTS  # noqa: E402
from rome_tpu_torch.interop import TCPSLAMClient, TCPSLAMServer  # noqa: E402
from rome_tpu_torch.interop import tcp_server as TTS  # noqa: E402

SESSION = ["INIT", "ODOMETRY 1 2 10.0 0.0 0.0 0.1 0 0 0.05 0 0.05",
           "ODOMETRY 2 3 10.0 0.0 0.0 0.1 0 0 0.05 0 0.05",
           "ODOMETRY 3 4 9.0 1.0 0.3 0.2 0.01 0 0.1 0 0.02",
           f"LANDMBR 3 4 {np.pi / 2} 10.0 0.01 0 0.5"]


@pytest.fixture
def server():
    srv = TCPSLAMServer(port=0, device="cpu")  # ephemeral port
    srv.serve_background()
    yield srv
    srv.shutdown()
    srv.server_close()


def test_simple_example_session(server):
    """tests/test_interop.py::test_simple_example_session on the port."""
    cl = TCPSLAMClient(port=server.server_address[1])
    assert cl.send_cmd("INIT").startswith("OK")
    assert cl.send_cmd("ODOMETRY 1 2 10.0 0.0 0.0 0.1 0 0 0.05 0 0.05").startswith("OK")
    assert cl.send_cmd("ODOMETRY 2 3 10.0 0.0 0.0 0.1 0 0 0.05 0 0.05").startswith("OK")
    Vb = cl.get_particles("x3")
    assert Vb.shape[1] == 3
    assert cl.send_cmd("BATCHSOLVE").startswith("OK")
    Va = cl.get_particles("x3")
    np.testing.assert_allclose(Va.mean(axis=0), [20, 0, 0], atol=1.0)
    assert cl.send_cmd(f"LANDMBR 3 4 {np.pi/2} 10.0 0.01 0 0.5").startswith("OK")
    assert cl.send_cmd("BATCHSOLVE").startswith("OK")
    l1 = cl.get_particles("l1")
    assert l1.shape[1] == 2
    np.testing.assert_allclose(l1.mean(axis=0), [20, 10], atol=1.5)
    cl.close()
    (session,) = server.sessions
    assert session.device == "cpu" and session.last_solve["stats"].converged


def test_error_replies(server):
    """tests/test_interop.py::test_error_replies on the port."""
    cl = TCPSLAMClient(port=server.server_address[1])
    assert cl.send_cmd("BOGUS").startswith("ERR unknown command")
    assert cl.send_cmd("GETPARTICLES nope").startswith("ERR unknown label")
    assert cl.send_cmd("ODOMETRY 1").startswith("ERR")  # malformed
    assert cl.send_cmd("").startswith("ERR")
    assert cl.send_cmd("INIT").startswith("OK")
    cl.close()


def _rows(reply):
    return np.array([[float(v) for v in r.split(",")] for r in reply.rstrip(";").split(";")])


def test_same_graph_same_particles_as_jax():
    js, ts = JTS._SLAMSession(N=50), TTS._SLAMSession(N=50, device="cpu")
    for cmd in SESSION:
        a, b = js.handle(cmd), ts.handle(cmd)
        assert a.startswith("OK") and b == a
    for lbl in ("x1", "x2", "x3", "x4", "l1"):
        a, b = _rows(js.handle(f"GETPARTICLES {lbl}")), _rows(ts.handle(f"GETPARTICLES {lbl}"))
        assert b.shape == a.shape == (50, 2 if lbl == "l1" else 3)
        if lbl == "x1":
            a, b = (np.linalg.norm(v - ts.fg.get_coords("x1"), axis=1) for v in (a, b))
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6, err_msg=lbl)
    assert ts.handle("BATCHSOLVE") == js.handle("BATCHSOLVE") == "OK BATCHSOLVE converged=True"
    for lbl in ("x3", "l1"):
        a, b = _rows(js.handle(f"GETPARTICLES {lbl}")), _rows(ts.handle(f"GETPARTICLES {lbl}"))
        np.testing.assert_allclose(b, a, atol=1e-3, err_msg=lbl)


def test_particles_of_a_belief_are_its_coordinates():
    ts = TTS._SLAMSession(N=4, device="cpu")
    ts.handle("INIT")
    pts = np.array([[1.0, 2.0, 0.5], [1.5, 2.5, -3.0], [0.0, 0.0, 0.0], [2.0, 1.0, 3.1]])
    ts.fg.variables["x1"].beliefs["default"] = pts
    np.testing.assert_allclose(_rows(ts.handle("GETPARTICLES x1")), pts, atol=1e-6)


def test_server_needs_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TCPSLAMServer(port=0)
