"""Mixture-of-Experts FFN: top-2 routing over ``num_experts`` GELU FFNs.

Counterpart of ``kubeflow_tpu/models/moe.py``'s ``MoEBlock``:

  router:   float32 logits ``[B, S, E]`` -> softmax -> top-2 gates,
            renormalised by ``max(sum, 1e-9)``;
  experts:  ``w_in [E, d, f]``, tanh-GELU, ``w_out [E, f, d]``; weights
            rounded to the model dtype, products in float32;
  aux:      the Switch load-balance loss ``sum(frac_first * mean_prob) * E``.

Two modes, as in the reference.  **Dropless** (serving: a cache is
present) evaluates every expert on every token and combines the two chosen
outputs with their gates, so a request's logits never depend on bucket
padding or co-batched traffic.  **Capacity** (training) keeps each expert
to ``C = max(1, int(1.25 * 2 * T / E))`` (token, choice) slots, filled in
priority order (every first choice, tokens in b-major order, before every
second choice); assignments past ``C`` are dropped.  The reference writes
capacity routing as dense one-hot ``[B, S, 2, E, C]`` einsums; here it is
written with indices: the kept rows are gathered into an ``[E, C, D]``
buffer (unfilled slots read a zero row), the experts run as two batched
products, and each (token, choice) gathers its slot back and is weighted
by its gate.  Every buffer slot holds one non-zero term and every token
sums two, so the values are those of the one-hot einsums, without the
``[B, S, 2, E, C]`` tensors (1.34 GB of float32 per layer at T = 8192,
E = 8).  The backward of the gathers adds at most two terms into each
token's row, so it does not depend on the order of the additions.

**Under a data group** (a train step's ``distributed.data_parallel``:
the ranks over dp x fsdp, each holding a contiguous rank-major block of
the global batch's rows) capacity, positions and aux are the global
batch's, as the reference's pjit computes them on the assembled array.
One ``all_gather`` of each rank's ``[2, E]`` first- and second-choice
counts gives ``T`` (the global token count, so ``C`` is the global
capacity), each first choice's position (its local exclusive cumsum plus
the lower ranks' first choices of its expert) and each second choice's
(its local cumsum plus every rank's first choices of its expert plus the
lower ranks' second choices), and the dropped count of the whole batch.
The aux loss's two means are global: the first-choice fractions from the
gathered counts, the probability sums through a differentiable
all-reduce, both over ``T``.  A stand-in's rows (``rows_counted()``
False: a rank with no rows of a micro-batch runs one so that it issues
the group's collectives) count as no tokens.

**Under ep** (``parallel/sharding.shard_model`` split ``w_in``/``w_out``
over the ep group; ``param.ep_split``) the rows are the same on every ep
rank, as the reference lays them (``batch`` over dp x fsdp, replicated
over ep).  Rank r runs experts ``[r E/ep, (r + 1) E/ep)`` on their rows
of the ``[E, C, D]`` buffer and the ranks' outputs are all-gathered
(backward: each rank keeps its slice of the replicated cotangent); the
experts' input passes ``copy_to_group``, whose backward sums the
input-gradient contributions of every rank's experts.  With rows
replicated over ep, an all-gather of the outputs is exact and needs no
all-to-all; every gradient outside the expert weights is the same on
every ep rank.

The router's kernel and bias are float32 in every build (the serving
predictor holds everything else in the compute dtype): a rounded router
would move routing decisions.  The float32 products run with PyTorch's
default ``allow_tf32 = False``, i.e. in full float32 on the card.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.nn import functional as F

from kubeflow_tpu_torch.device import dtype_of
from kubeflow_tpu_torch.models import layers as kl
from kubeflow_tpu_torch.parallel import distributed as pd


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    hidden_size: int = 64
    ffn_size: int = 128
    num_experts: int = 4
    capacity_factor: float = 1.25
    dtype: str = "bfloat16"

    @property
    def torch_dtype(self) -> torch.dtype:
        return dtype_of(self.dtype)


def capacity(cfg: MoEConfig, tokens: int) -> int:
    """Slots per expert for ``tokens`` tokens: GShard's top-2 sizing, which
    counts both choices (``T / E`` would drop nearly every second
    choice under balanced routing)."""
    return max(1, int(cfg.capacity_factor * 2 * tokens / cfg.num_experts))


def route(probs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-2 of router probabilities ``[..., E]``: ``(gates [..., 2],
    experts [..., 2])``.  The first choice is the first maximal index
    (``top_k(., 1)``'s); the second is the first maximal index once the
    first is zeroed, so ties break as the reference breaks them."""
    e = probs.shape[-1]
    idx1 = probs.argmax(dim=-1)
    masked = probs - F.one_hot(idx1, e).to(probs.dtype) * probs
    idx2 = masked.argmax(dim=-1)
    gates = torch.stack([probs.gather(-1, idx1[..., None])[..., 0],
                         masked.gather(-1, idx2[..., None])[..., 0]], -1)
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return gates, torch.stack([idx1, idx2], dim=-1)


def capacity_slots(experts: torch.Tensor, num_experts: int, cap: int,
                   offsets: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Priority routing of ``experts [T, 2]`` into ``cap`` slots per expert.

    Returns ``(slot, keep)`` over the ``2T`` assignments in priority order
    (every first choice, then every second choice, tokens in order):
    ``slot = expert * cap + position`` for a kept assignment and
    ``num_experts * cap`` (one past the buffer) for a dropped one.
    ``offsets [2, E]`` (under a data group) is added to the position of a
    choice-c assignment to expert e: where the global priority order puts
    these tokens' choices among the other ranks'."""
    pri = experts.t().reshape(-1)                       # [2T]
    onehot = F.one_hot(pri, num_experts)                # [2T, E]
    pos = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(dim=-1)
    if offsets is not None:
        choice = torch.arange(2, device=pri.device).repeat_interleave(
            experts.shape[0])
        pos = pos + offsets[choice, pri]
    keep = pos < cap
    slot = torch.where(keep, pri * cap + pos,
                       torch.full_like(pos, num_experts * cap))
    return slot, keep


def global_routing(experts: torch.Tensor, num_experts: int, group,
                   counted: bool = True) -> dict:
    """This data rank's place in the global batch's routing (module
    docstring): ``tokens`` (global T), ``first`` (the global first-choice
    count per expert, ``[E]``), ``offsets [2, E]`` for
    ``capacity_slots``, and ``assigned`` (every (token, choice)
    assignment per expert, ``[E]``).  One ``all_gather`` of ``[2, E]``
    counts over ``group`` (a collective: every rank calls it, a stand-in
    with ``counted`` False giving zeros)."""
    counts = F.one_hot(experts.reshape(-1, 2).t(), num_experts).sum(dim=1)
    if not counted:
        counts = torch.zeros_like(counts)               # [2, E]
    table = pd.all_gather_cat(counts, 0, group).reshape(
        -1, 2, num_experts)                             # [ranks, 2, E]
    total = table.sum(dim=0)
    below = table[:pd.rank_of(group)].sum(dim=0)
    # a local cumsum places second choices after this rank's first ones;
    # globally they follow every rank's
    offsets = torch.stack([below[0], total[0] - counts[0] + below[1]])
    return {"tokens": int(total[0].sum()), "first": total[0],
            "offsets": offsets, "assigned": total.sum(dim=0)}


class MoEBlock(nn.Module):
    """Top-2 gated MoE FFN over ``[B, S, D]``; ``forward`` returns ``(y,
    aux)``.  ``dropless`` is the default mode; a call may override it
    (the Llama block passes ``dropless=cache is not None``).  After a
    capacity-mode call, ``dropped`` holds the number of (token, choice)
    assignments that overflowed (a device scalar; under a data group,
    the global batch's)."""

    # a capacity-mode forward gathers counts over the data group, so a
    # train step runs every micro-batch on every rank (a stand-in where a
    # rank has no rows of it)
    forward_collectives = True

    def __init__(self, config: MoEConfig, dropless: bool = False, *,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.config = config
        self.dropless = dropless
        d, f, e = config.hidden_size, config.ffn_size, config.num_experts
        # float32 in every build (module docstring)
        self.router = kl.DenseGeneral(d, e, use_bias=True,
                                      dtype=torch.float32,
                                      param_dtype=torch.float32,
                                      device=device,
                                      axis_names=("embed", "expert"))
        self.w_in = kl.param((e, d, f), param_dtype, device,
                             ("expert", "embed", "mlp"))
        self.w_out = kl.param((e, f, d), param_dtype, device,
                              ("expert", "mlp", "embed"))
        self.dropped: torch.Tensor | None = None

    def init_weights(self, gen: torch.Generator) -> None:
        # flax's lecun_normal over [E, d, f] counts fan-in as E * d
        kl.lecun_normal_(self.w_in, gen)
        kl.lecun_normal_(self.w_out, gen)

    def _experts(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The expert weights (this ep rank's, under ep) rounded to the
        model dtype (dequantized first when int8), in float32."""
        dt = self.config.torch_dtype
        return (kl.weight(self.w_in, dt).float(),
                kl.weight(self.w_out, dt).float())

    def forward(self, x: torch.Tensor, dropless: bool | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        dropless = self.dropless if dropless is None else dropless
        b, s, d = x.shape
        e = self.config.num_experts
        tokens = b * s
        probs = torch.softmax(self.router(x.float()), dim=-1)   # [B, S, E]
        gates, experts = route(probs)                            # [B, S, 2]
        group = None if dropless else pd.data_parallel_group()
        xf = x.float().reshape(tokens, d)
        gates = gates.reshape(tokens, 2)
        experts = experts.reshape(tokens, 2)
        # load-balance aux (Switch eq. 4): fraction of first choices per
        # expert times its mean router probability; only the second
        # factor carries a gradient
        if group is None:
            frac = F.one_hot(experts[:, 0], e).float().mean(dim=0)
            aux = (frac * probs.mean(dim=(0, 1))).sum() * e
        else:
            counted = pd.rows_counted()
            glob = global_routing(experts, e, group, counted)
            sums = probs.sum(dim=(0, 1)) * (1.0 if counted else 0.0)
            mean_probs = pd.sum_over_group(sums, group) / glob["tokens"]
            aux = (glob["first"].float() / glob["tokens"]
                   * mean_probs).sum() * e
        if dropless:
            w_in, w_out = self._experts()
            h = F.gelu(torch.matmul(xf[None], w_in), approximate="tanh")
            out = torch.bmm(h, w_out)                          # [E, T, D]
            rows = torch.arange(tokens, device=x.device)[:, None]
            sel = out[experts, rows]                           # [T, 2, D]
            y = (sel * gates[..., None]).sum(dim=1)
            return y.reshape(b, s, d).to(x.dtype), aux
        if group is None:
            cap = capacity(self.config, tokens)
            slot, keep = capacity_slots(experts, e, cap)
            self.dropped = (~keep).sum()
        else:
            cap = capacity(self.config, glob["tokens"])
            slot, keep = capacity_slots(experts, e, cap, glob["offsets"])
            self.dropped = (glob["assigned"] - cap).clamp_min(0).sum()
        # slot -> the token that fills it; unfilled slots read the zero row
        # at index ``tokens`` (dropped assignments all land on the spare
        # slot past the buffer, which is never read)
        order = torch.arange(tokens, device=x.device).repeat(2)
        fill = torch.full((e * cap + 1,), tokens, dtype=torch.long,
                          device=x.device)
        fill[slot] = order
        ep = getattr(self.w_in, "ep_split", None)
        if ep is None:
            first, local = 0, e
        else:
            # this rank's experts; their input gradient summed over ep
            local = e // ep.size
            first = ep.index * local
            xf = pd.copy_to_group(xf, ep.group)
        x_pad = torch.cat([xf, xf.new_zeros(1, d)])
        expert_in = x_pad[fill[first * cap:(first + local) * cap]].reshape(
            local, cap, d)
        w_in, w_out = self._experts()
        h = F.gelu(torch.bmm(expert_in, w_in), approximate="tanh")
        out = torch.bmm(h, w_out)                        # [local, C, D]
        if ep is not None:
            out = pd.gather_from_group(out, ep.group, dim=0)   # [E, C, D]
        out = out.reshape(e * cap, d)
        out = torch.cat([out, out.new_zeros(1, d)])            # + spare slot
        weights = gates.t().reshape(-1, 1)                     # priority order
        y = (out[slot] * weights).reshape(2, tokens, d).sum(dim=0)
        return y.reshape(b, s, d).to(x.dtype), aux
