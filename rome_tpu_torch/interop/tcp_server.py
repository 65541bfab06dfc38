"""TCP string-protocol SLAM server and client (counterpart of
``rome_tpu/interop/tcp_server.py``): a line-based protocol with commands

  INIT
  ODOMETRY <frm> <to> <dx> <dy> <dth> <c11> <c12> <c13> <c22> <c23> <c33>
  LANDMBR  <frm> <lmid> <bearing> <range> <covb> <covbr> <covr>
  BATCHSOLVE
  GETPARTICLES <label>
  QUIT

Every command answers one line; GETPARTICLES answers semicolon-separated
comma rows ("x,y,th;x,y,th;...;"). Pose ids map to x<n> labels, landmark ids
map to l<k> in arrival order (the reference example's LANDMBR node 4 becomes
:l1). Errors are answered in-band ("ERR ...").

BATCHSOLVE runs ``solve_graph_parametric`` on the server's device (the card
unless the server is made with ``device="cpu"``); GETPARTICLES of a variable
without particles computes ``marginal_covariances`` there and samples the
rows on the host with ``numpy.random.default_rng(0)``, as the JAX package
does, so both packages answer the same rows for the same graph.
"""

from __future__ import annotations

import socket
import socketserver
import threading

import numpy as np

import torch

from rome_tpu_torch.distributions import MvNormal, Normal
from rome_tpu_torch.factors.bearing_range import Pose2Point2BearingRange
from rome_tpu_torch.factors.pose2 import Pose2Pose2, PriorPose2
from rome_tpu_torch.graph.graph import FactorGraph
from rome_tpu_torch.utils.device import entry_device
from rome_tpu_torch.variables import Point2, Pose2


class _SLAMSession:
    """One client's graph and the commands on it (``handle``)."""

    def __init__(self, N: int = 100, device="cuda"):
        self.N = N
        self.device = entry_device(device)
        self.last_solve = None
        self.reset()

    def reset(self):
        self.fg = FactorGraph()
        self.fg.params.N = self.N
        self.lm_map = {}  # client landmark id -> l<k> label
        self.solved = False

    def _ensure_pose(self, n: int):
        lbl = f"x{n}"
        if lbl not in self.fg.variables:
            self.fg.add_variable(lbl, Pose2)
            if self.fg.num_factors == 0:
                self.fg.add_factor(
                    [lbl], PriorPose2(MvNormal([0, 0, 0], [0.1, 0.1, 0.05]))
                )
        return lbl

    def handle(self, line: str) -> str:
        parts = line.strip().split()
        if not parts:
            return "ERR empty"
        cmd = parts[0].upper()
        try:
            if cmd == "INIT":
                self.reset()
                self._ensure_pose(1)
                return "OK INIT"
            if cmd == "ODOMETRY":
                frm, to = int(parts[1]), int(parts[2])
                dx = [float(parts[3]), float(parts[4]), float(parts[5])]
                c11, c12, c13, c22, c23, c33 = (float(v) for v in parts[6:12])
                cov = np.array(
                    [[c11, c12, c13], [c12, c22, c23], [c13, c23, c33]]
                )
                a = self._ensure_pose(frm)
                b = self._ensure_pose(to)
                self.fg.add_factor([a, b], Pose2Pose2(MvNormal(dx, cov)))
                return f"OK ODOMETRY {a} {b}"
            if cmd == "LANDMBR":
                frm, lmid = int(parts[1]), int(parts[2])
                bearing, rng = float(parts[3]), float(parts[4])
                covb, _covbr, covr = (float(v) for v in parts[5:8])
                a = self._ensure_pose(frm)
                if lmid not in self.lm_map:
                    lbl = f"l{len(self.lm_map) + 1}"
                    self.lm_map[lmid] = lbl
                    self.fg.add_variable(lbl, Point2, tags=("LANDMARK",))
                lbl = self.lm_map[lmid]
                self.fg.add_factor(
                    [a, lbl],
                    Pose2Point2BearingRange(
                        Normal(bearing, np.sqrt(covb)), Normal(rng, np.sqrt(covr))
                    ),
                )
                return f"OK LANDMBR {a} {lbl}"
            if cmd == "BATCHSOLVE":
                from rome_tpu_torch.solvers.parametric import solve_graph_parametric

                self.fg.init_all()
                res = solve_graph_parametric(self.fg, init=False, device=self.device)
                self.solved = True
                self.last_solve = res
                return f"OK BATCHSOLVE converged={res['stats'].converged}"
            if cmd == "GETPARTICLES":
                lbl = parts[1]
                return self._particles(lbl)
            if cmd == "QUIT":
                return ""
            return f"ERR unknown command {cmd}"
        except Exception as e:  # protocol errors answer in-band
            return f"ERR {type(e).__name__}: {e}"

    def _particles(self, lbl: str) -> str:
        rec = self.fg.variables.get(lbl)
        if rec is None:
            return f"ERR unknown label {lbl}"
        if "default" in rec.beliefs:
            pts = torch.as_tensor(np.asarray(rec.beliefs["default"], dtype=np.float64))
            coords = rec.manifold.log(pts).numpy()
        else:
            # sample N particles from the parametric marginal
            from rome_tpu_torch.graph.lower import lower
            from rome_tpu_torch.solvers.gauss_newton import marginal_covariances

            if not rec.initialized.get("parametric"):
                self.fg.init_all()
            ga = lower(self.fg, device=self.device)
            covs = marginal_covariances(ga, ga.values0)
            cov = covs[rec.vtype.name][rec.slot].double().cpu().numpy()
            mean = rec.manifold.log(torch.as_tensor(
                np.asarray(rec.points["parametric"], dtype=np.float64))).numpy()
            rng = np.random.default_rng(0)
            coords = rng.multivariate_normal(
                mean, 0.5 * (cov + cov.T) + 1e-9 * np.eye(len(mean)), size=self.N
            )
        rows = ";".join(",".join(f"{v:.8g}" for v in row) for row in coords)
        return rows + ";"


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        server = self.server
        session = _SLAMSession(N=server.slam_N, device=server.device)  # type: ignore[attr-defined]
        server.sessions.append(session)  # type: ignore[attr-defined]
        while True:
            line = self.rfile.readline()
            if not line:
                break
            text = line.decode(errors="replace").strip()
            if text.upper() == "QUIT":
                break
            reply = session.handle(text)
            self.wfile.write((reply + "\n").encode())


class TCPSLAMServer(socketserver.ThreadingTCPServer):
    """tcpStringSLAMServer analogue: one graph session per connection, its
    solves on ``device`` (the card unless the caller passes ``"cpu"``)."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, host: str = "127.0.0.1", port: int = 60001, N: int = 100,
                 device="cuda"):
        self.device = entry_device(device)
        super().__init__((host, port), _Handler)
        self.slam_N = N
        # every connection's session, in arrival order (its graph and its
        # last BATCHSOLVE result stay readable after the client leaves)
        self.sessions = []

    def serve_background(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t


class TCPSLAMClient:
    """Python twin of the reference's TCP client (JLSLAMInterf.py pattern)."""

    def __init__(self, addr: str = "127.0.0.1", port: int = 60001):
        self.sock = socket.create_connection((addr, port))
        self.rfile = self.sock.makefile("r")

    def send_cmd(self, cmd: str) -> str:
        self.sock.sendall((cmd + "\n").encode())
        if cmd.strip().upper() == "QUIT":
            self.sock.close()
            return ""
        return self.rfile.readline().strip()

    def get_particles(self, lbl: str) -> np.ndarray:
        res = self.send_cmd(f"GETPARTICLES {lbl}")
        rows = [r for r in res.rstrip(";").split(";") if r]
        return np.array([[float(v) for v in r.split(",")] for r in rows])

    def close(self):
        try:
            self.send_cmd("QUIT")
        except OSError:
            pass
