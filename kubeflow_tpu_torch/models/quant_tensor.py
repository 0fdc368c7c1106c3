"""The int8 weight a layer may hold in place of a matmul kernel.

``serving/quant.py`` makes a :class:`QTensor` (``quantize_params``);
the layers read one through ``models/layers.py::weight`` and
``parallel/sharding.py::shard_model`` splits one over tp.  It lives
here, beside the layers, so that neither the layers nor the sharding
rules depend on the serving package.
"""

from __future__ import annotations

import torch
from torch import nn


class QTensor(nn.Module):
    """int8 weights plus broadcastable float32 scales; ``dequantize``
    gives the bf16 weight the reference's ``QTensor`` stands for.

    It carries its kernel's ``logical_axes``, and once
    ``parallel/sharding.py`` splits it over tp, ``tp_split``: ``q`` is the
    kernel's block and ``scale`` the block of its broadcast shape (the
    size-1 contraction axis whole), so the layers act on a split
    ``QTensor`` as on a split parameter."""

    logical_axes = None
    fsdp_split = tp_split = ep_split = None

    def __init__(self, q: torch.Tensor, scale: torch.Tensor,
                 logical_axes: tuple | None = None):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)
        self.logical_axes = logical_axes

    def dequantize(self) -> torch.Tensor:
        """``q * bf16(scale)`` in bf16: one elementwise product, rounded as
        the reference's ``q.astype(bf16) * scale.astype(bf16)``."""
        return self.q * self.scale.to(torch.bfloat16)
