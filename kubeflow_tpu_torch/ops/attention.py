"""Multi-head attention core over [B, S, H, D]: the dispatcher.

Counterpart of ``kubeflow_tpu/ops/attention.py``.  Unmasked calls with
``use_flash`` go to the flash kernel (``ops/flash_attention.py``: the
Hopper kernel on CUDA, its plain version on the CPU) at every sequence
length: the reference's ``FLASH_MIN_SEQ`` gate was measured on a TPU and
is not inherited.  Everything else runs ``plain_attention``, the
counterpart of ``_xla_attention``.  Ring attention waits for the
multi-device slice.
"""

from __future__ import annotations

import torch

from kubeflow_tpu_torch.ops.flash_attention import flash_attention
from kubeflow_tpu_torch.ops.matmul import matmul_f32


def plain_attention(q, k, v, *, causal: bool, mask=None) -> torch.Tensor:
    """Reference attention with ``_xla_attention``'s semantics.

    GQA runs GROUPED (query reshaped to [B, Sq, Hkv, G, D] against the
    original K/V, never a repeated copy); the causal mask is offset by
    ``sk - sq``; ``mask`` is boolean ``[B, 1|H, Sq|1, Sk]`` (True =
    attend); scores and softmax are in float32; the weights are
    rounded to ``q.dtype`` before the PV product."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    # 1/sqrt(d) rounded as the reference rounds it (in float32); a Python
    # float of that value multiplies without a device copy
    scale = float(torch.tensor(float(d)).sqrt().reciprocal())
    # per batch row, heads as the matmul batch: [Hkv, G*Sq, D] queries
    # against K/V read in place as [Hkv, D, Sk] / [Hkv, Sk, D] views (an
    # equal-heads call is the G = 1 case)
    qg = q.reshape(b, sq, hkv, g, d).permute(0, 2, 3, 1, 4).reshape(
        b, hkv, g * sq, d)
    logits = torch.stack([
        matmul_f32(qg[i], k[i].permute(1, 2, 0)) for i in range(b)
    ]).reshape(b, hkv, g, sq, sk)                     # [B, Hkv, G, Sq, Sk]
    logits = logits * scale
    if causal:
        visible = (torch.arange(sq, device=q.device)[:, None] + (sk - sq)
                   >= torch.arange(sk, device=q.device)[None, :])
        logits = logits.masked_fill(~visible, float("-inf"))
    if mask is not None:
        if mask.shape[1] == 1:   # head-broadcast: gains a group axis
            mask = mask[:, :, None]
        else:                    # per query head: fold H into (Hkv, G)
            mask = mask.reshape(mask.shape[0], hkv, g, *mask.shape[2:])
        logits = logits.masked_fill(~mask, float("-inf"))
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    common = torch.promote_types(weights.dtype, v.dtype)
    weights = weights.to(common).reshape(b, hkv, g * sq, sk)
    out = torch.stack([weights[i] @ v[i].to(common).permute(1, 0, 2)
                       for i in range(b)])            # [B, Hkv, G*Sq, D]
    return out.reshape(b, hkv, g, sq, d).permute(0, 3, 1, 2, 4).reshape(
        b, sq, hq, d)


def dot_product_attention(q, k, v, *, causal: bool = False, mask=None,
                          use_flash: bool = False) -> torch.Tensor:
    """Attention over [batch, seq, heads, head_dim] tensors.

    Args:
      q, k, v: [B, S, H, D]; K/V may have fewer heads (GQA).
      causal: causal masking, decode-aware when Sq < Sk.
      mask: optional boolean mask broadcastable to [B, H, Sq, Sk].
      use_flash: route an unmasked call through the flash kernel.
    """
    if use_flash and mask is None:
        return flash_attention(q, k, v, causal=causal)
    return plain_attention(q, k, v, causal=causal, mask=mask)
