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
            self.add_module(name, kl.DenseGeneral(
                n_in, n_out, axis_names=("embed", "mlp"), **kw))
        self.logits = kl.DenseGeneral(dims[-1], cfg.num_classes,
                                      axis_names=("mlp", None), **kw)

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


def label_log_probs(logits: torch.Tensor, labels: torch.Tensor,
                    vocab=None) -> torch.Tensor:
    """``log_softmax(logits)`` at ``labels`` (float32), per position.

    ``vocab`` is the tensor-parallel split of the last axis when
    ``logits`` hold only this rank's slice of the vocabulary (the tied
    head's output, ``layers.Embed.vocab_split``): the max, the sum of
    exponentials and the label's logit are then reduced over the tp
    group (a vocabulary-parallel log-softmax), so every rank gets the
    whole vocabulary's value."""
    logits = logits.float()
    labels = labels.long()[..., None]
    if vocab is None:
        return F.log_softmax(logits, dim=-1).gather(-1, labels)[..., 0]
    from kubeflow_tpu_torch.parallel import distributed as pd

    top = logits.detach().amax(-1, keepdim=True)
    pd.all_reduce_max(top, vocab.group)
    shifted = logits - top
    total = pd.reduce_from_group(shifted.exp().sum(-1), vocab.group)
    n = logits.shape[-1]
    local = labels - vocab.index * n
    mine = (local >= 0) & (local < n)
    at = shifted.gather(-1, local.clamp(0, n - 1))
    at = pd.reduce_from_group(torch.where(mine, at, 0.0)[..., 0],
                              vocab.group)
    return at - total.log()


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          vocab=None) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` under a float32
    log-softmax over the last axis (``vocab``: see ``label_log_probs``)."""
    return -label_log_probs(logits, labels, vocab).mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels).float().mean()
