"""Device resolution for the port's entry points.

The port runs on CUDA. The CPU is used only when a caller asks for it by
name (the tests do), never as a quiet fallback when CUDA is missing.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the current CUDA device; raises when there is none.
    An explicit ``"cpu"`` (or ``torch.device("cpu")``) is honoured; an
    explicit CUDA device is checked for availability too."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "raydp_tpu_torch runs on CUDA by default and no CUDA device "
                "is available; pass device='cpu' to run on the CPU explicitly"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
