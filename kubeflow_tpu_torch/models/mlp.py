"""MNIST MLP: the platform's smallest end-to-end training example.

Counterpart of ``kubeflow_tpu/models/mlp.py`` (BASELINE.json configs[0]):
images flattened, dense layers with biases and ReLU, float32 by default.
Parameter names follow the flax tree (``dense_0``, ``dense_1``,
``logits``; ``models/convert.py``).  ``softmax_cross_entropy`` and
``accuracy`` are the reference's, and every registry model's loss.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.nn import functional as F

from kubeflow_tpu_torch.device import dtype_of, resolve
from kubeflow_tpu_torch.models import layers as kl


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    input_dim: int = 784
    hidden_dims: tuple[int, ...] = (512, 256)
    num_classes: int = 10
    dtype: str = "float32"


class MLP(nn.Module):
    """``model(images [B, ...])`` -> logits [B, num_classes]."""

    def __init__(self, config: MLPConfig = MLPConfig(), *, device=None):
        super().__init__()
        self.config = cfg = config
        device = resolve(device)
        kw = dict(use_bias=True, dtype=dtype_of(cfg.dtype), device=device)
        dims = (cfg.input_dim,) + tuple(cfg.hidden_dims)
        self.hidden = [f"dense_{i}" for i in range(len(cfg.hidden_dims))]
        for name, n_in, n_out in zip(self.hidden, dims, dims[1:]):
            self.add_module(name, kl.DenseGeneral(n_in, n_out, **kw))
        self.logits = kl.DenseGeneral(dims[-1], cfg.num_classes, **kw)

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "MLP":
        """Seeded flax init: lecun-normal kernels, zero biases."""
        kl.init_submodules(self, seed)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).to(dtype_of(self.config.dtype))
        for name in self.hidden:
            x = F.relu(getattr(self, name)(x))
        return self.logits(x)


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` under a float32
    log-softmax over the last axis."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[..., None])[..., 0].mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels).float().mean()
