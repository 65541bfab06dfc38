"""TCP string-protocol interop on the PyTorch port: the torch version of
examples/tcp_interop.py, with the server and client classes the interop
package defines (TCPSLAMServer, TCPSLAMClient).

Starts the SLAM server on an ephemeral localhost port, its solves on
``--device`` (the card by default), and drives it with INIT / ODOMETRY /
LANDMBR / BATCHSOLVE / GETPARTICLES / QUIT over a socket.

    PYTHONPATH=. python examples/torch/tcp_interop.py [--device cuda|cpu]
"""

import argparse

import numpy as np

from rome_tpu_torch.interop import TCPSLAMClient, TCPSLAMServer


def main(device="cuda"):
    server = TCPSLAMServer(port=0, device=device)
    server.serve_background()
    try:
        cli = TCPSLAMClient(port=server.server_address[1])
        replies = [cli.send_cmd("INIT"),
                   cli.send_cmd("ODOMETRY 1 2 1.0 0.0 0.1 0.01 0 0 0.01 0 0.001"),
                   cli.send_cmd("ODOMETRY 2 3 1.0 0.0 0.1 0.01 0 0 0.01 0 0.001"),
                   cli.send_cmd("LANDMBR 2 7 0.2 4.0 0.05 0.0 0.3"),
                   cli.send_cmd("BATCHSOLVE")]
        for r in replies:
            print(r)
        pts = cli.get_particles("x1")
        print(f"GETPARTICLES x1 -> {pts.shape} mean={np.round(pts.mean(axis=0), 3)}")
        cli.close()
    finally:
        server.shutdown()
        server.server_close()
    if not all(r.startswith("OK") for r in replies):
        raise RuntimeError(f"the server refused a command: {replies}")
    return replies, pts


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
