"""Ring attention: exact attention over sequence shards on the ``sp`` axis.

Counterpart of ``kubeflow_tpu/ops/ring_attention.py``.  Each rank of the
sp group holds one chunk of the sequence, ``[B, S / n, H, D]`` of Q, K
and V; the K/V blocks rotate around the ring (``distributed.ppermute``
to rank ``(i + 1) % n``) and every rank attends its queries to each
block in turn, so no rank holds the whole sequence or an ``[S, S]``
score matrix.

The reference accumulates an online softmax in XLA einsums
(``_block_attend``).  Here each block is one launch of the flash kernels
(``ops/flash_attention.py``; their plain versions on a CPU tensor):

- **forward**: K1 (``flash_attention_with_lse``) gives the block's
  ``(O_b, lse_b)``, merged into float32 accumulators by log-sum-exp.
  Relative to the local queries a block is the diagonal (step 0: causal
  at offset 0, K1's bottom-right rule with Sq = Sk), earlier (fully
  visible: non-causal) or, under ``causal``, later (fully masked: the
  reference weights it exactly 0, so nothing is launched);
- **backward**: delta = rowsum(dO * O) of the merged output, then per
  visible block one K2 (``flash_bwd_dq``, summed into a float32 dQ) and
  one K3 (``flash_bwd_dkv``, summed into float32 dK/dV accumulators that
  travel with the block), both against the merged lse, which makes each
  block's share exact.  K, V, dK and dV rotate after every block, so
  after n rotations each dK/dV is back with its owner.

On one card the ranks' exchanges, not the kernels, take the ring's time
(gloo stages every block through host memory: PERF.md's phase 19).

GQA: the Hkv heads rotate as they are (K1-K3 read a kv head for each of
its query heads, and K3 sums over the group), where the reference's
dispatcher rotates a repeated copy; the function is the same.

``ring_attention_reference`` is the plain version: the reference's
``_block_attend`` loop in float32 with its -1e30 masks, rotating through
the differentiable ``distributed.permute`` and differentiated by
autograd.  The tests and ``chip_smoke.py`` hold the ring against it;
nothing on the card's path calls it.
"""

from __future__ import annotations

import functools
import math

import torch

from kubeflow_tpu_torch.ops import flash_attention as fa
from kubeflow_tpu_torch.parallel import distributed as pd

_NEG_INF = -1e30


def _blocks(n: int, idx: int, causal: bool):
    """Per ring step, the block's causal flag, or None for a block that
    is fully masked (a later block under ``causal``)."""
    out = []
    for step in range(n):
        src = (idx - step) % n
        if not causal or src < idx:
            out.append(False)
        elif src == idx:
            out.append(True)
        else:
            out.append(None)
    return out


class RingAttentionFunction(torch.autograd.Function):
    """Forward K1 per visible block, merged; backward K2 and K3 per
    visible block against the merged lse (module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal):
        n, idx = pd.world_size(group), pd.rank_of(group)
        b, s, h, d = q.shape
        o = torch.zeros((b, s, h, d), dtype=torch.float32, device=q.device)
        lse = torch.full((b, h, s), float("-inf"), dtype=torch.float32,
                         device=q.device)
        kb, vb = k, v
        for step, block_causal in enumerate(_blocks(n, idx, causal)):
            if block_causal is not None:
                o_b, lse_b = fa.flash_attention_with_lse(
                    q, kb, vb, causal=block_causal)
                new = torch.logaddexp(lse, lse_b)
                # [B, H, S] weights of the two sums, as [B, S, H, 1]
                old_w = torch.exp(lse - new).transpose(1, 2)[..., None]
                new_w = torch.exp(lse_b - new).transpose(1, 2)[..., None]
                o = o * old_w + o_b.float() * new_w
                lse = new
            if step + 1 < n:
                kb, vb = pd.ppermute([kb, vb], group)
        o = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.group, ctx.causal = group, causal
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        group = ctx.group
        n, idx = pd.world_size(group), pd.rank_of(group)
        do = fa.cotangent_view(do, q.dtype)
        delta = fa.flash_bwd_delta(o, do)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kb, vb = k, v
        dkb = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dvb = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for step, block_causal in enumerate(_blocks(n, idx, ctx.causal)):
            if block_causal is not None:
                dq += fa.flash_bwd_dq(q, kb, vb, do, lse, delta,
                                      causal=block_causal)
                dk_b, dv_b = fa.flash_bwd_dkv(q, kb, vb, do, lse, delta,
                                              causal=block_causal)
                dkb += dk_b
                dvb += dv_b
            if step + 1 < n:
                kb, vb, dkb, dvb = pd.ppermute([kb, vb, dkb, dvb], group)
            else:   # the last block's gradients go home
                dkb, dvb = pd.ppermute([dkb, dvb], group)
        return (dq.to(q.dtype), dkb.to(k.dtype), dvb.to(v.dtype), None,
                None)


def ring_attention(q, k, v, *, group, causal: bool = False) -> torch.Tensor:
    """Per-shard ring attention over ``group`` (the sp ranks, in ring
    order).  q: this rank's ``[B, S_local, H, D]`` chunk, k and v its
    ``[B, S_local, Hkv, D]`` chunks (Hkv divides H); rank i holds
    positions ``[i S_local, (i + 1) S_local)``.  Returns this rank's
    output chunk in ``q.dtype``, differentiable in q, k and v."""
    fa._check(q, k, v)
    if q.shape[1] != k.shape[1]:
        raise ValueError(f"ring attention needs equal query and key "
                         f"chunks, got {q.shape[1]} and {k.shape[1]}")
    return RingAttentionFunction.apply(q, k, v, group, causal)


def _block_attend(q, k, v, q_off, k_off, causal, sm_scale, m, l, acc):
    """The reference's online-softmax step against one block: float32
    [B, S, H, D] inputs, accumulators [B, H, Sq, 1|D]."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * sm_scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        q_pos = q_off + torch.arange(sq, device=q.device)[:, None]
        k_pos = k_off + torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(~(q_pos >= k_pos), _NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1, keepdim=True)
    acc_new = acc * alpha + torch.einsum("bhqk,bkhd->bhqd", p, v)
    return m_new, l_new, acc_new


def ring_attention_reference(q, k, v, *, group,
                             causal: bool = False) -> torch.Tensor:
    """Plain PyTorch ring attention: the reference's ``ring_attention``
    (float32, K/V repeated up to the query heads as its dispatcher
    repeats them, the same rotations), differentiable by autograd."""
    n, idx = pd.world_size(group), pd.rank_of(group)
    b, s_local, h, d = q.shape
    if k.shape[2] != h:
        k = k.repeat_interleave(h // k.shape[2], dim=2)
        v = v.repeat_interleave(h // v.shape[2], dim=2)
    sm_scale = 1.0 / math.sqrt(d)
    qf = q.float()
    m = torch.full((b, h, s_local, 1), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, s_local, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, s_local, d), dtype=torch.float32,
                      device=q.device)
    kb, vb = k.float(), v.float()
    for step in range(n):
        k_off = ((idx - step) % n) * s_local
        m, l, acc = _block_attend(qf, kb, vb, idx * s_local, k_off, causal,
                                  sm_scale, m, l, acc)
        if step + 1 < n:
            kb, vb = pd.permute(kb, group), pd.permute(vb, group)
    out = (acc / l.clamp_min(1e-30)).to(q.dtype)
    return out.transpose(1, 2)


def make_ring_attention(mesh, *, causal: bool = False,
                        axis_name: str = "sp",
                        batch_axes=("dp", "fsdp"), head_axis="tp"):
    """The per-shard ring attention over ``mesh``'s ``axis_name`` group:
    ``fn(q, k, v)`` on this rank's chunks.  ``batch_axes`` and
    ``head_axis`` name the reference's shard_map layout; here every rank
    already holds its rows and heads, so they only document it."""
    if axis_name not in mesh.shape:
        raise ValueError(f"mesh {tuple(mesh.shape)} has no {axis_name!r} "
                         "axis")
    return functools.partial(ring_attention, group=mesh.group(axis_name),
                             causal=causal)
