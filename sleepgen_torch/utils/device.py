"""The port's device rule: entry points run on the GPU unless told not to."""
from __future__ import annotations

import torch


def resolve_device(device: torch.device | str = "cuda") -> torch.device:
    """``device`` as a torch.device; raises if it names CUDA and there is no
    CUDA device. ``device="cpu"`` runs the kernels' plain PyTorch versions."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: sleepgen_torch runs on the GPU by default; pass "
            "device='cpu' to run its plain PyTorch versions on the CPU")
    return dev
