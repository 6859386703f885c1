"""Where an entry point runs."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The torch device an entry point runs on, normalized as a tensor's
    `.device` reads: CUDA with its index (the current card when none is
    given), the CPU without one. Raises for CUDA without a card instead of
    carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA was asked for but no card is available; "
                               "pass device='cpu' to run the plain versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type == "cpu":
        dev = torch.device("cpu")
    else:
        raise ValueError(f"unsupported device {device!r}")
    return dev
