"""interop subpackage of rome_tpu_torch: cross-language TCP string protocol."""

from rome_tpu_torch.interop.tcp_server import TCPSLAMClient, TCPSLAMServer

__all__ = ["TCPSLAMServer", "TCPSLAMClient"]
