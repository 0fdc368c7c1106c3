"""Weight-only int8 quantization and int8 KV pages for serving.

Counterpart of ``kubeflow_tpu/serving/quant.py``.  Post-training,
per-output-channel symmetric int8 on the matmul weights: ``w ~ q *
scale`` with ``q`` int8 and ``scale = max|w| / 127`` over the
contraction axis.  ``quantize_params`` swaps each chosen parameter of a
module for a :class:`QTensor` submodule holding two buffers, ``q`` (int8,
the weight's shape) and ``scale`` (float32, keepdim over the contraction
axis).  The layers that read such a weight (``models/layers.py``
``DenseGeneral``, ``models/moe.py``'s experts) dequantize it at use
exactly as the reference's ``QTensor.__jax_array__`` does: ``q`` times
the bf16 scale, in bf16 whatever the compute dtype is, then a cast to the
layer's dtype.  The product after it stays the layer's own ``x @ w``.

Only matmul weights are quantized (leaves named ``kernel``, ``w_in`` and
``w_out`` with at least two dimensions and ``min_size`` elements); the
embedding (gathered, and the tied LM head), norm gains, biases and the
MoE router (its decisions are precision-sensitive) keep their precision.
The module is quantized one weight at a time, on the device it lives on,
so the device never holds a second full-precision copy of the model.

KV pages: ``quantize_kv`` / ``dequantize_kv`` with one float32 scale per
(page, kv head) for each of k and v, and ``kv_page_nbytes_int8``.  The
engine quantizes the pages it commits and dequantizes the pages it seeds
from; int8 pages are lossy (not bit-identical streams), so streams with
them are held to the reference's int8 streams.  The port's functions take
a leading page axis, ``[n, page, Hkv, D]`` with scales ``[n, 1, Hkv, 1]``:
each page is one reduction, bitwise the reference's per-page call.
"""

from __future__ import annotations

import torch
from torch import nn

from kubeflow_tpu_torch.models.quant_tensor import QTensor

QUANT_LEAF_NAMES = ("kernel", "w_in", "w_out")
SKIP_PATH_PARTS = ("router",)


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """``where(amax > 0, amax, 1) / 127`` by true division on every
    device: PyTorch's CUDA division by a Python scalar multiplies by its
    reciprocal, which rounds otherwise than the reference's division (and
    the CPU's)."""
    return (torch.where(amax > 0, amax, torch.ones_like(amax))
            / torch.full_like(amax, 127.0))


def quantize_array(w: torch.Tensor,
                   axis: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-channel int8 over ``axis`` (the contraction axis):
    ``(q int8, scale float32 keepdim)``."""
    x = w.float()
    # max |w| as max(max w, -min w): the same value without a temporary
    # of w's size (the restore quantizes 7B weights one at a time on the
    # card, and its peak is one weight's float32 copy)
    amax = torch.maximum(x.amax(dim=axis, keepdim=True),
                         x.amin(dim=axis, keepdim=True).neg())
    scale = _scale(amax)
    x = x / scale if x is w else x.div_(scale)
    q = x.round_().clamp_(-127, 127).to(torch.int8)
    return q, scale


def wants_quant(name: str, p: torch.Tensor, min_size: int) -> bool:
    parts = name.split(".")
    if any(part in parts for part in SKIP_PATH_PARTS):
        return False
    return (parts[-1] in QUANT_LEAF_NAMES and p.ndim >= 2
            and p.numel() >= min_size)


@torch.no_grad()
def quantize_params(module: nn.Module, *, min_size: int = 1 << 12,
                    source: dict | None = None) -> list[str]:
    """Quantize every eligible matmul weight of ``module`` in place, one
    at a time; returns the quantized parameters' names.  ``source`` maps
    a parameter name to full-precision values to quantize instead of the
    parameter's own (a float32 state dict loaded into a bf16 model: the
    reference quantizes its float32 masters)."""
    names = [n for n, p in module.named_parameters()
             if wants_quant(n, p, min_size)]
    for name in names:
        quantize_param(module, name,
                       None if source is None else source.get(name),
                       min_size=min_size)
    return names


@torch.no_grad()
def quantize_param(module: nn.Module, name: str,
                   full: torch.Tensor | None = None, *,
                   min_size: int = 1 << 12) -> bool:
    """Swap parameter ``name`` for a ``QTensor`` made from ``full`` (its
    own values when None) if it is an eligible matmul weight; whether it
    was swapped.  The whole tensor is quantized: a split parameter is
    refused, since a row-parallel kernel's tp split cuts the contraction
    axis its scale is the max over (split the ``QTensor`` instead)."""
    prefix, _, leaf = name.rpartition(".")
    owner = module.get_submodule(prefix)
    p = owner._parameters.get(leaf)
    if p is None or not wants_quant(name, p, min_size):
        return False
    if any(getattr(p, f"{a}_split", None) is not None
           for a in ("fsdp", "tp", "ep")):
        raise ValueError(f"{name} is split: quantize the whole tensor, "
                         "then split the QTensor")
    full = p if full is None else full
    # DenseGeneral kernels contract on axis 0 (input features); the MoE
    # stacks [E, in, out] on the second-to-last axis
    axis = p.ndim - 2 if leaf in ("w_in", "w_out") else 0
    q, scale = quantize_array(full.to(p.device), axis)
    del owner._parameters[leaf]
    setattr(owner, leaf, QTensor(q, scale, getattr(p, "logical_axes", None)))
    return True


def quantized_bytes(module: nn.Module) -> int:
    """Bytes of the module's parameters and buffers (int8 weights at one
    byte, their float32 scales at four): the reference's
    ``quantized_bytes`` of the same tree."""
    return sum(t.numel() * t.element_size()
               for t in (*module.parameters(), *module.buffers()))


# -- KV-cache int8 (paged pool) -------------------------------------------------

def kv_page_nbytes_int8(cfg, page_size: int) -> int:
    """Device bytes one int8 page covers across every layer: the int8
    payload plus one float32 scale per kv head for each of k and v."""
    payload = page_size * cfg.num_kv_heads * cfg.head_dim
    scales = cfg.num_kv_heads * 4
    return 2 * cfg.num_layers * (payload + scales)


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(page, head) int8 over pages ``[n, page, Hkv, D]``:
    ``(q int8, scale float32 [n, 1, Hkv, 1])``, the amax over each page's
    positions and dims."""
    xf = x.float()
    scale = _scale(xf.abs().amax(dim=(1, 3), keepdim=True))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`: in float32, rounded once into
    ``dtype``."""
    return (q.float() * scale).to(dtype)
