"""CIFAR-10 ConvNet: the HPO trial workload.

Counterpart of ``kubeflow_tpu/models/convnet.py`` (BASELINE.json
configs[3]): per channel count a 3x3 ``"SAME"`` convolution, ReLU and a 2x2
stride-2 max-pool, then a dense layer, ReLU, dropout (train mode only) and
the logits.  NHWC images; the dense layer's input width follows from
``IMAGE_SHAPE`` (flax infers it from the first batch).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.nn import functional as F

from kubeflow_tpu_torch.device import dtype_of, resolve
from kubeflow_tpu_torch.models import layers as kl

IMAGE_SHAPE = (32, 32, 3)   # CIFAR-10, H x W x C: sets the dense layer's width


@dataclasses.dataclass(frozen=True)
class ConvNetConfig:
    num_classes: int = 10
    channels: tuple[int, ...] = (32, 64, 128)
    dense_width: int = 256
    dropout: float = 0.0
    dtype: str = "float32"


class ConvNet(nn.Module):
    """``model(images [B, H, W, C], train=False)`` -> logits."""

    def __init__(self, config: ConvNetConfig = ConvNetConfig(), *,
                 device=None):
        super().__init__()
        self.config = cfg = config
        device = resolve(device)
        kw = dict(use_bias=True, dtype=dtype_of(cfg.dtype), device=device)
        h, w, c = IMAGE_SHAPE
        self.convs = [f"conv_{i}" for i in range(len(cfg.channels))]
        for name, ch in zip(self.convs, cfg.channels):
            self.add_module(name, kl.Conv(c, ch, (3, 3), padding="SAME",
                                          **kw))
            h, w, c = h // 2, w // 2, ch     # the VALID 2x2 stride-2 pool
        self.dense = kl.DenseGeneral(h * w * c, cfg.dense_width, **kw)
        self.logits = kl.DenseGeneral(cfg.dense_width, cfg.num_classes, **kw)

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "ConvNet":
        """Seeded flax init: lecun-normal kernels, zero biases."""
        kl.init_submodules(self, seed)
        return self

    def forward(self, x: torch.Tensor, *, train: bool = False):
        cfg = self.config
        x = x.to(dtype_of(cfg.dtype))
        for name in self.convs:
            x = kl.max_pool(F.relu(getattr(self, name)(x)), (2, 2), (2, 2))
        x = F.relu(self.dense(x.reshape(x.shape[0], -1)))
        if cfg.dropout > 0 and train:
            x = F.dropout(x, cfg.dropout)
        return self.logits(x)
