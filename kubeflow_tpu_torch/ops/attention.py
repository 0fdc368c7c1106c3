"""Multi-head attention core over [B, S, H, D]: the dispatcher.

Counterpart of ``kubeflow_tpu/ops/attention.py``.  Unmasked calls with
``use_flash`` whose head_dim the kernel is built for (``HEAD_DIMS``) go to
the flash kernel (``ops/flash_attention.py``: the Hopper kernel on CUDA,
its plain version on the CPU) at every sequence length, as the
reference's ``_flash_or_xla`` takes its kernel only when ``supported()``
holds; the reference's ``FLASH_MIN_SEQ`` gate was measured on a TPU and
is not inherited.  Everything else (a mask, another head_dim such as
OpenLLaMA-3B's 100) runs ``plain_attention``, the counterpart of
``_xla_attention``.  While ``ring_context`` is active over a mesh whose
sp axis has more than one rank, unmasked self-attention (Sq = Sk) takes
ring attention over that axis first (``ops/ring_attention.py``: K1, K2
and K3 per K/V block), as the reference's dispatcher does.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from kubeflow_tpu_torch.ops.flash_attention import HEAD_DIMS, flash_attention
from kubeflow_tpu_torch.ops.matmul import matmul_f32


_ring_state = threading.local()


@contextlib.contextmanager
def ring_context(mesh, axis_name: str = "sp"):
    """While active, self-attention with no mask routes through ring
    attention over ``mesh``'s ``axis_name`` group, and the models place
    their chunk at ``sequence_offset``.  A remat'd block's recomputed
    forward may run on the autograd engine's thread, outside this
    context: the models hand ``torch.utils.checkpoint`` the
    ``recompute_context`` that re-enters it."""
    prev = getattr(_ring_state, "ring", None)
    _ring_state.ring = (mesh, axis_name)
    try:
        yield
    finally:
        _ring_state.ring = prev


def _active_ring():
    """``(mesh, axis_name)`` of the active ring, or None (none entered, or
    its axis has one rank)."""
    ring = getattr(_ring_state, "ring", None)
    if ring is None:
        return None
    mesh, axis = ring
    if mesh.shape.get(axis, 1) <= 1:
        return None
    return ring


def sequence_offset(s_local: int) -> int:
    """The global position of this rank's first token when the active
    ring splits the sequence into chunks of ``s_local`` (rank i holds
    ``[i s_local, (i + 1) s_local)``); 0 without a ring."""
    ring = _active_ring()
    if ring is None:
        return 0
    mesh, axis = ring
    return mesh.coordinate(axis) * s_local


def recompute_context():
    """``context_fn`` for ``torch.utils.checkpoint``: the first forward as
    it is, the recomputed one under the ring (or none) that the first
    forward ran under."""
    ring = getattr(_ring_state, "ring", None)
    again = (contextlib.nullcontext() if ring is None
             else ring_context(*ring))
    return contextlib.nullcontext(), again


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
      use_flash: route an unmasked call through the flash kernel when the
        kernel is built for its head_dim.
    """
    ring = _active_ring()
    if ring is not None and mask is None and q.shape[1] == k.shape[1]:
        from kubeflow_tpu_torch.ops.ring_attention import make_ring_attention

        mesh, axis = ring
        return make_ring_attention(mesh, causal=causal,
                                   axis_name=axis)(q, k, v)
    if use_flash and mask is None and q.shape[-1] in HEAD_DIMS:
        return flash_attention(q, k, v, causal=causal)
    return plain_attention(q, k, v, causal=causal, mask=mask)
