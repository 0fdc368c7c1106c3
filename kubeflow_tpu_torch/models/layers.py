"""Building blocks with the reference's parameter names and layouts.

Counterparts of ``kubeflow_tpu/models/layers.py``.  Parameters keep the
flax names (``kernel``, ``embedding``, ``scale``) and layouts (a
DenseGeneral kernel is ``[in, *out]``), so a flax params tree maps onto a
``state_dict`` by path alone (``models/convert.py``).  Parameters are held
in ``param_dtype`` (float32 masters by default, as in flax) and cast to the
compute dtype at use; a serving model built with ``param_dtype`` equal to
the compute dtype holds exactly the cast the reference makes at every use,
so the cast is free.

The vision layers (``Conv``, ``max_pool``, ``BatchNorm``) take NHWC
tensors, as flax does, and hand PyTorch the NCHW view of them
(``permute(0, 3, 1, 2)``: channels-last strides, no copy).  Their padding
is flax's: ``"SAME"`` pads ``total // 2`` before and the rest after, so a
stride-2 window over an even size pads ``(0, 1)``, where PyTorch's
symmetric padding would take ``(1, 1)``.

Parameters are created frozen (``requires_grad=False``): a served model
never builds an autograd graph.  Training turns them on at build time
(``parallel/train_step.py::init_train_state`` calls
``requires_grad_(True)``).

A served model's matmul weights may be int8 (``serving/quant.py``
``quantize_params`` swaps such a parameter for a ``QTensor``); ``weight``
dequantizes one at use as the reference's ``QTensor`` does.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from torch.nn import functional as F

from kubeflow_tpu_torch.ops.matmul import matmul_f32
from kubeflow_tpu_torch.parallel.distributed import (
    data_parallel_group, sum_over_group)


def init_submodules(model: nn.Module, seed: int) -> torch.Generator:
    """Run every submodule's ``init_weights`` from one generator seeded
    with ``seed`` on the model's device; returns the generator."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    for m in model.modules():
        if m is not model and hasattr(m, "init_weights"):
            m.init_weights(gen)
    return gen


def weight(w, dtype: torch.dtype) -> torch.Tensor:
    """A weight in ``dtype``: a parameter is cast; an int8 ``QTensor``
    dequantizes to bf16 first (the reference's ``__jax_array__``, whatever
    the compute dtype), then is cast."""
    if isinstance(w, torch.Tensor):
        return w.to(dtype)
    return w.dequantize().to(dtype)


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
        w = weight(self.kernel, self.dtype)
        w = w.reshape(w.shape[0], -1)
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


# --- vision layers (NHWC) ----------------------------------------------------

Pads = tuple[tuple[int, int], tuple[int, int]]


def same_padding(size: int, window: int, stride: int) -> tuple[int, int]:
    """(before, after) of XLA's ``"SAME"`` padding along one axis: the
    output has ``ceil(size / stride)`` positions and the total padding is
    split with the smaller half before."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _pads(padding: str | Pads, hw: tuple[int, int], window, strides) -> Pads:
    if padding == "SAME":
        return tuple(same_padding(n, k, s)
                     for n, k, s in zip(hw, window, strides))
    if padding == "VALID":
        return (0, 0), (0, 0)
    return tuple(tuple(p) for p in padding)


def _nchw_padded(x: torch.Tensor, pads: Pads, value: float = 0.0):
    """NHWC ``x`` as an NCHW view, and the padding left for the op itself:
    symmetric padding is the op's (no copy), asymmetric is applied here
    with ``value``."""
    xc = x.permute(0, 3, 1, 2)
    (hl, hh), (wl, wh) = pads
    if hl == hh and wl == wh:
        return xc, (hl, wl)
    return F.pad(xc, (wl, wh, hl, hh), value=value), (0, 0)


class Conv(nn.Module):
    """flax ``nn.Conv`` over NHWC: kernel ``[kh, kw, in, out]``, optional
    bias ``[out]``, products in the compute ``dtype``; ``padding`` is
    ``"SAME"``, ``"VALID"`` or explicit ``((top, bottom), (left,
    right))``."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: tuple[int, int], *,
                 strides: tuple[int, int] = (1, 1),
                 padding: str | Pads = "SAME", use_bias: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.kernel_size, self.strides = tuple(kernel_size), tuple(strides)
        self.padding, self.dtype = padding, dtype
        self.kernel = param(self.kernel_size + (in_features, features),
                            torch.float32, device)
        self.bias = (param((features,), torch.float32, device) if use_bias
                     else None)

    def init_weights(self, gen: torch.Generator) -> None:
        lecun_normal_(self.kernel, gen)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = _pads(self.padding, x.shape[1:3], self.kernel_size,
                     self.strides)
        xc, pad = _nchw_padded(x.to(self.dtype), pads)
        weight = self.kernel.to(self.dtype).permute(3, 2, 0, 1)
        y = F.conv2d(xc, weight, stride=self.strides, padding=pad)
        y = y.permute(0, 2, 3, 1)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


def max_pool(x: torch.Tensor, window: tuple[int, int],
             strides: tuple[int, int], padding: str | Pads = "VALID"
             ) -> torch.Tensor:
    """flax ``nn.max_pool`` over NHWC; padded positions hold -inf, as in
    XLA's ``reduce_window``."""
    pads = _pads(padding, x.shape[1:3], window, strides)
    xc, pad = _nchw_padded(x, pads, value=float("-inf"))
    return F.max_pool2d(xc, window, strides, padding=pad).permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channel (last) axis with
    ``dtype=float32``: float32 statistics over every other axis, the
    biased variance ``mean(x^2) - mean(x)^2`` clipped at 0, output
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in float32.  With
    ``train`` the batch statistics are used; without, the running averages
    (buffers ``mean`` and ``var``, flax's ``batch_stats``).  Training never
    updates the running averages: the reference's training loss discards
    that update.

    Under a data-parallel train step (a group bound by
    ``parallel/distributed.data_parallel``) the train-mode statistics are
    the global batch's, as the reference's pjit computes them on the
    global array: the sums of x and x^2 and the row count are summed over
    the gang in one differentiable all-reduce, forward and backward."""

    # the train step runs even an empty micro-batch piece through a model
    # holding this layer, so that every rank issues its collectives
    reduces_over_group = True

    def __init__(self, features: int, epsilon: float = 1e-5, *,
                 scale_init: float = 1.0, device=None):
        super().__init__()
        self.epsilon, self.scale_init = epsilon, scale_init
        self.scale = param((features,), torch.float32, device)
        self.bias = param((features,), torch.float32, device)
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def init_weights(self, gen: torch.Generator) -> None:
        nn.init.constant_(self.scale, self.scale_init)
        nn.init.zeros_(self.bias)
        self.mean.zero_()
        self.var.fill_(1.0)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        xf = x.float()
        if train:
            dims = tuple(range(x.ndim - 1))
            group = data_parallel_group()
            if group is None:
                mean = xf.mean(dims)
                var = (xf.square().mean(dims) - mean.square()).clamp_min(0.0)
            else:
                c = x.shape[-1]
                count = xf.new_full((1,), float(xf.numel() // c))
                sums = sum_over_group(torch.cat(
                    [xf.sum(dims), xf.square().sum(dims), count]), group)
                mean = sums[:c] / sums[-1]
                var = (sums[c:2 * c] / sums[-1]
                       - mean.square()).clamp_min(0.0)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return (xf - mean) * mul + self.bias
