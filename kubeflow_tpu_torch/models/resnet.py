"""ResNet-50: the data-parallel training example.

Counterpart of ``kubeflow_tpu/models/resnet.py`` (BASELINE.json
configs[1]): NHWC images, convolutions in the compute dtype (bf16 by
default), BatchNorm statistics and outputs in float32 rounded back to the
compute dtype, bottleneck blocks whose last BatchNorm scale starts at
zero, a float32 mean over H and W rounded to the compute dtype, and a
float32 classifier.  Parameter names follow the flax tree
(``stage1_block0/conv2/kernel`` is ``stage1_block0.conv2.kernel``), and
the BatchNorm running averages (flax's ``batch_stats``) are the buffers
``*.mean`` and ``*.var``.  The cross-replica BatchNorm axis (``axis_name``)
waits for the multi-device slice.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.nn import functional as F

from kubeflow_tpu_torch.device import dtype_of, resolve
from kubeflow_tpu_torch.models import layers as kl


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: tuple[int, ...] = (3, 4, 6, 3)  # ResNet-50
    num_classes: int = 1000
    width: int = 64
    dtype: str = "bfloat16"
    axis_name: str | None = None  # cross-replica BN: not yet ported


def resnet50(**kw) -> ResNetConfig:
    return ResNetConfig(**kw)


def resnet18(**kw) -> ResNetConfig:
    return ResNetConfig(stage_sizes=(2, 2, 2, 2), **kw)


class BottleneckBlock(nn.Module):
    def __init__(self, in_features: int, filters: int,
                 strides: tuple[int, int], dtype: torch.dtype, *, device):
        super().__init__()
        self.dtype = dtype
        kw = dict(use_bias=False, dtype=dtype, device=device)
        out = 4 * filters
        self.conv1 = kl.Conv(in_features, filters, (1, 1), **kw)
        self.bn1 = kl.BatchNorm(filters, device=device)
        self.conv2 = kl.Conv(filters, filters, (3, 3), strides=strides, **kw)
        self.bn2 = kl.BatchNorm(filters, device=device)
        self.conv3 = kl.Conv(filters, out, (1, 1), **kw)
        self.bn3 = kl.BatchNorm(out, scale_init=0.0, device=device)
        # the reference projects the residual when its shape differs from
        # the block's output: more channels, or a stride
        self.project = in_features != out or tuple(strides) != (1, 1)
        if self.project:
            self.proj_conv = kl.Conv(in_features, out, (1, 1),
                                     strides=strides, **kw)
            self.proj_bn = kl.BatchNorm(out, device=device)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        dt = self.dtype
        y = F.relu(self.bn1(self.conv1(x), train).to(dt))
        y = F.relu(self.bn2(self.conv2(y), train).to(dt))
        y = self.bn3(self.conv3(y), train).to(dt)
        residual = x
        if self.project:
            residual = self.proj_bn(self.proj_conv(x), train).to(dt)
        return F.relu(residual + y)


class ResNet(nn.Module):
    """``model(images [B, H, W, 3], train=False)`` -> float32 logits."""

    def __init__(self, config: ResNetConfig = ResNetConfig(), *,
                 device=None):
        super().__init__()
        if config.axis_name is not None:
            raise NotImplementedError(
                "cross-replica BatchNorm (axis_name) waits for the "
                "multi-device slice")
        self.config = cfg = config
        device = resolve(device)
        dt = dtype_of(cfg.dtype)
        self.stem_conv = kl.Conv(3, cfg.width, (7, 7), strides=(2, 2),
                                 padding=((3, 3), (3, 3)), use_bias=False,
                                 dtype=dt, device=device)
        self.stem_bn = kl.BatchNorm(cfg.width, device=device)
        self.blocks = []
        n_in = cfg.width
        for stage, num_blocks in enumerate(cfg.stage_sizes):
            for block in range(num_blocks):
                strides = (2, 2) if stage > 0 and block == 0 else (1, 1)
                name = f"stage{stage}_block{block}"
                filters = cfg.width * 2 ** stage
                self.add_module(name, BottleneckBlock(
                    n_in, filters, strides, dt, device=device))
                self.blocks.append(name)
                n_in = 4 * filters
        self.classifier = kl.DenseGeneral(n_in, cfg.num_classes,
                                          use_bias=True, dtype=torch.float32,
                                          device=device)

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "ResNet":
        """Seeded flax init: lecun-normal kernels, zero biases, unit
        BatchNorm scales (zero for each block's ``bn3``), running mean 0
        and variance 1."""
        kl.init_submodules(self, seed)
        return self

    def forward(self, x: torch.Tensor, *, train: bool = False):
        dt = dtype_of(self.config.dtype)
        x = self.stem_bn(self.stem_conv(x.to(dt)), train)
        x = kl.max_pool(F.relu(x.to(dt)), (3, 3), (2, 2), "SAME")
        for name in self.blocks:
            x = getattr(self, name)(x, train)
        x = x.float().mean(dim=(1, 2)).to(dt)
        return self.classifier(x)
