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
    all_gather_cat, copy_to_group, data_parallel_group, gather_cast,
    gather_from_group, reduce_from_group, sum_over_group)


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
    """A weight in ``dtype``: a parameter is cast; an fsdp-split one
    (``parallel/sharding.py``) is cast and gathered whole over its fsdp
    group; an int8 ``QTensor`` dequantizes to bf16 first (the reference's
    ``__jax_array__``, whatever the compute dtype), then is cast."""
    if not isinstance(w, torch.Tensor):
        return w.dequantize().to(dtype)
    split = getattr(w, "fsdp_split", None)
    if split is not None:
        return gather_cast(w, dtype, split.dim, split.group)
    return w.to(dtype)


def tp_split(w):
    """The tensor-parallel split of parameter or int8 ``QTensor`` ``w``
    (None: whole)."""
    return getattr(w, "tp_split", None)


def param(shape, dtype, device, names=None) -> nn.Parameter:
    """A frozen parameter carrying ``names``, the logical axis names of
    its reference counterpart's ``nn.Partitioned`` box (None: unboxed)."""
    p = nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                     requires_grad=False)
    p.logical_axes = names
    return p


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
    and added after the product, as the reference's ``DenseGeneral``.
    ``axis_names`` are the kernel's logical names (the bias takes the
    output dims'), None where the reference uses an unboxed ``nn.Dense``.

    Under tensor parallelism (``parallel/sharding.py``) a kernel split on
    an output dim is column-parallel: the input is replicated (gathered
    first if a column-parallel layer left it split) and the output holds
    this rank's features; a kernel split on its input dim is
    row-parallel: the partial product is summed over the tp group before
    the bias."""

    def __init__(self, in_features: int, features: int | Sequence[int], *,
                 use_bias: bool = False, dtype=torch.bfloat16,
                 param_dtype=torch.float32, device=None, axis_names=None):
        super().__init__()
        self.features = ((features,) if isinstance(features, int)
                         else tuple(features))
        self.dtype = dtype
        self.kernel = param((in_features,) + self.features, param_dtype,
                            device, axis_names)
        self.bias = (param(self.features, param_dtype, device,
                           axis_names and axis_names[1:])
                     if use_bias else None)

    def init_weights(self, gen: torch.Generator) -> None:
        lecun_normal_(self.kernel, gen)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = weight(self.kernel, self.dtype)
        tp = tp_split(self.kernel)
        if tp is not None and tp.dim > 0:
            if x.shape[-1] != w.shape[0]:
                x = gather_from_group(x, tp.group)
            x = copy_to_group(x, tp.group)
        y = (x.to(self.dtype) @ w.reshape(w.shape[0], -1)).reshape(
            x.shape[:-1] + w.shape[1:])
        if tp is not None and tp.dim == 0:
            y = reduce_from_group(y, tp.group)
        if self.bias is not None:
            y = y + weight(self.bias, self.dtype)
        return y


class Embed(nn.Module):
    """Token embedding with the tied logit projection ``attend``.  Under
    tensor parallelism the table's vocabulary rows are split: a lookup
    takes this rank's rows (zeros elsewhere) summed over the tp group,
    ``attend`` gives this rank's slice of the logits, and
    ``whole_vocab`` gathers such a slice whole."""

    def __init__(self, num_embeddings: int, features: int, *,
                 dtype=torch.bfloat16, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.embedding = param((num_embeddings, features), param_dtype,
                               device, ("vocab", "embed"))

    def init_weights(self, gen: torch.Generator) -> None:
        embed_normal_(self.embedding, gen)

    def vocab_split(self):
        """The tp split of the vocabulary (None: whole)."""
        return tp_split(self.embedding)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        table = weight(self.embedding, self.dtype)
        tp = self.vocab_split()
        if tp is None:
            return table[ids]
        rows = table.shape[0]
        local = ids - tp.index * rows
        mine = (local >= 0) & (local < rows)
        x = torch.where(mine[..., None], table[local.clamp(0, rows - 1)],
                        torch.zeros((), dtype=table.dtype,
                                    device=table.device))
        return reduce_from_group(x, tp.group)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """Project hidden states onto the vocabulary: products of
        compute-dtype values accumulated in float32, float32 logits."""
        common = torch.promote_types(x.dtype, self.dtype)
        table = weight(self.embedding, self.dtype).to(common)
        tp = self.vocab_split()
        if tp is not None:
            x = copy_to_group(x, tp.group)
        x2 = x.to(common).reshape(-1, x.shape[-1])
        return matmul_f32(x2, table.T).reshape(*x.shape[:-1], -1)

    def whole_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """``attend``'s logits over the whole vocabulary: this rank's
        slice all-gathered over tp in vocabulary order (as they are
        without a split).  Gather only the positions that are read."""
        tp = self.vocab_split()
        if tp is None:
            return logits
        return all_gather_cat(logits, logits.dim() - 1, tp.group)


class LayerNorm(nn.Module):
    """Layer normalization with float32 mean and variance, float32 scale
    and bias, cast back to the input dtype."""

    def __init__(self, features: int, epsilon: float = 1e-12, *,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.scale = param((features,), param_dtype, device, ("embed",))
        self.bias = param((features,), param_dtype, device, ("embed",))

    def init_weights(self, gen: torch.Generator) -> None:
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        orig = x.dtype
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.epsilon)
        return (y * weight(self.scale, torch.float32)
                + weight(self.bias, torch.float32)).to(orig)


class RMSNorm(nn.Module):
    """RMS normalization with float32 statistics, cast back to the input
    dtype."""

    def __init__(self, features: int, epsilon: float = 1e-6, *,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.scale = param((features,), param_dtype, device, ("embed",))

    def init_weights(self, gen: torch.Generator) -> None:
        nn.init.ones_(self.scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        orig = x.dtype
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + self.epsilon)
        return (y * weight(self.scale, torch.float32)).to(orig)


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
