"""Where an entry point runs."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The torch device an entry point runs on; raises for CUDA without a
    card instead of carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA was asked for but no card is available; "
                               "pass device='cpu' to run the plain versions")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev
