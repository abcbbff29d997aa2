"""Device resolution for the port's entry points.

Entry points take an explicit ``device`` and default to ``"cuda"``: the
port is built for one NVIDIA H100, and a run that silently fell back to the
CPU would report CPU numbers under a GPU's name. Tests pass ``"cpu"``."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when a CUDA device is asked
    for and none is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but no CUDA device is present; pass "
            "device='cpu' to run the plain PyTorch lanes")
    return dev
