"""Device selection for the port's entry points.

Every entry point takes `device=` and defaults to "cuda". A request for a
CUDA device on a host without one raises: nothing silently carries on
on the CPU. Tests and CPU callers ask for `device="cpu"` explicitly.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device = DEFAULT_DEVICE
                   ) -> torch.device:
    """-> torch.device, raising when a CUDA device is asked for and
    none is present."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available()"
                " is False; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev
