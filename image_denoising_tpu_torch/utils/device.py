"""Device selection for the port's entry points."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``, refusing a CUDA device where there is none.

    Entry points default to ``"cuda"``; on a machine without a GPU they raise
    here rather than run on the CPU. Pass ``device="cpu"`` to run there.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return dev
