"""Building blocks with the reference's parameter names and layouts.

Counterparts of ``kubeflow_tpu/models/layers.py``.  Parameters keep the
flax names (``kernel``, ``embedding``, ``scale``) and layouts (a
DenseGeneral kernel is ``[in, *out]``), so a flax params tree maps onto a
``state_dict`` by path alone (``models/convert.py``).  Parameters are held
in ``param_dtype`` (float32 masters by default, as in flax) and cast to the
compute dtype at use; a serving model built with ``param_dtype`` equal to
the compute dtype holds exactly the cast the reference makes at every use,
so the cast is free.

Parameters are created frozen (``requires_grad=False``): a served model
never builds an autograd graph.  Training turns them on at build time
(``parallel/train_step.py::init_train_state`` calls
``requires_grad_(True)``).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from kubeflow_tpu_torch.ops.matmul import matmul_f32


def param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def lecun_normal_(p: torch.Tensor, gen: torch.Generator) -> None:
    """flax's ``lecun_normal``: truncated normal (2 sigma) with variance
    1 / fan_in, fan_in counted as flax counts it for ``[in, *out]``
    kernels (flax's ``in_axis=-2``: ``shape[-2]`` times the receptive
    field)."""
    shape = p.shape
    receptive = math.prod(shape) / shape[-2] / shape[-1]
    fan_in = shape[-2] * receptive
    # stddev of a unit normal truncated to [-2, 2]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    tmp = torch.empty(shape, dtype=torch.float32, device=p.device)
    nn.init.trunc_normal_(tmp, std=std, a=-2 * std, b=2 * std, generator=gen)
    p.copy_(tmp)


def embed_normal_(p: torch.Tensor, gen: torch.Generator) -> None:
    """flax's ``normal(stddev=0.02)``, the embedding tables' init."""
    tmp = torch.empty(p.shape, dtype=torch.float32, device=p.device)
    nn.init.normal_(tmp, std=0.02, generator=gen)
    p.copy_(tmp)


class DenseGeneral(nn.Module):
    """Dense layer over the trailing axis with arbitrary output shape;
    kernel ``[in, *features]``, output in the compute ``dtype``.  With
    ``use_bias`` (off by default, as every Llama projection is built), a
    bias ``[*features]`` held like the kernel is cast to the compute dtype
    and added after the product, as the reference's ``DenseGeneral``."""

    def __init__(self, in_features: int, features: int | Sequence[int], *,
                 use_bias: bool = False, dtype=torch.bfloat16,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.features = ((features,) if isinstance(features, int)
                         else tuple(features))
        self.dtype = dtype
        self.kernel = param((in_features,) + self.features, param_dtype,
                            device)
        self.bias = (param(self.features, param_dtype, device) if use_bias
                     else None)

    def init_weights(self, gen: torch.Generator) -> None:
        lecun_normal_(self.kernel, gen)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel.to(self.dtype).reshape(self.kernel.shape[0], -1)
        y = (x.to(self.dtype) @ w).reshape(x.shape[:-1] + self.features)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class Embed(nn.Module):
    """Token embedding with the tied logit projection ``attend``."""

    def __init__(self, num_embeddings: int, features: int, *,
                 dtype=torch.bfloat16, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.embedding = param((num_embeddings, features), param_dtype,
                               device)

    def init_weights(self, gen: torch.Generator) -> None:
        embed_normal_(self.embedding, gen)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding.to(self.dtype)[ids]

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """Project hidden states onto the vocabulary: products of
        compute-dtype values accumulated in float32, float32 logits."""
        common = torch.promote_types(x.dtype, self.dtype)
        table = self.embedding.to(self.dtype).to(common)
        x2 = x.to(common).reshape(-1, x.shape[-1])
        return matmul_f32(x2, table.T).reshape(*x.shape[:-1], -1)


class LayerNorm(nn.Module):
    """Layer normalization with float32 mean and variance, float32 scale
    and bias, cast back to the input dtype."""

    def __init__(self, features: int, epsilon: float = 1e-12, *,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.scale = param((features,), param_dtype, device)
        self.bias = param((features,), param_dtype, device)

    def init_weights(self, gen: torch.Generator) -> None:
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        orig = x.dtype
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.epsilon)
        return (y * self.scale.float() + self.bias.float()).to(orig)


class RMSNorm(nn.Module):
    """RMS normalization with float32 statistics, cast back to the input
    dtype."""

    def __init__(self, features: int, epsilon: float = 1e-6, *,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.scale = param((features,), param_dtype, device)

    def init_weights(self, gen: torch.Generator) -> None:
        nn.init.ones_(self.scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        orig = x.dtype
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + self.epsilon)
        return (y * self.scale.float()).to(orig)


def rotary_embedding(x: torch.Tensor, positions: torch.Tensor,
                     base: float = 10000.0) -> torch.Tensor:
    """RoPE over [B, S, H, D] given integer positions [B, S], computed in
    float32 and cast back to ``x.dtype``."""
    d = x.shape[-1]
    half = d // 2
    log_base = torch.full((), base, dtype=torch.float32,
                          device=x.device).log()
    freqs = torch.exp(-log_base
                      * torch.arange(0, half, dtype=torch.float32,
                                     device=x.device) / half)
    angles = positions[..., None].float() * freqs        # [B, S, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)
