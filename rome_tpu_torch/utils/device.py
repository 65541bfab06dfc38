"""The device of the port's entry points.

Every public entry point takes ``device="cuda"`` as its default and runs on
the card unless the caller asks for the CPU (``device="cpu"``, as the tests
do). Nothing probes for a device and nothing falls back: asked for CUDA on a
machine without it, an entry point raises before it does any work.
"""

from __future__ import annotations

import torch


def entry_device(device):
    """Check the device an entry point was given, and return it unchanged.
    A CUDA device on a machine without CUDA raises a RuntimeError that names
    the CPU alternative."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r}, but CUDA is not available: the port's entry points run "
            'on the card unless the caller passes device="cpu"'
        )
    return device
