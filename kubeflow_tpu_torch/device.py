"""Device resolution for every entry point of the port.

The port runs on the card.  ``device=None`` means CUDA; a caller that
wants the CPU (the tests, or a dev box) says ``device="cpu"``.  With no
CUDA and no explicit CPU request, resolution raises: the port never
falls back to the CPU quietly.
"""

from __future__ import annotations

import torch


def resolve(device: str | torch.device | None = None) -> torch.device:
    """The torch device to build and run on (see module docstring)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' explicitly to run "
            "the port on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def dtype_of(name: str) -> torch.dtype:
    """Map a config dtype name ("bfloat16", "float32") to a torch dtype."""
    try:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None
