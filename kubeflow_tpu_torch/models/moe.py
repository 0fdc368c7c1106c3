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
Under sp the step also binds its ``SequenceSplit``: each rank holds
chunk i of every one of its rows, so its tokens are not one contiguous
block of the priority order (the reference's order runs over the
assembled ``[B, S]`` array, b-major: a rank's chunk of row b sits between
the other sp ranks' chunks of that row).  The order of (token, choice)
assignments is therefore (data rank, row, chunk), first choices before
second ones.  Each rank counts its chunk's choices per row and expert,
``[rows, 2, E]``; an ``all_gather`` over the sp group gives its data
rank's rows' counts chunk by chunk, and (with a data group) one of the
data rank's ``[2, E]`` totals over the data group gives the lower data
ranks' and the global ones.  Exclusive prefix sums in that order give
each row's offsets ``[rows, 2, E]`` (a second choice also follows every
first choice of its expert), ``T`` is the global token count (so ``C``
is the global capacity) and the dropped count is the whole batch's.  The
aux loss's two means are global: the first-choice fractions from the
gathered counts, the probability sums through a differentiable
all-reduce over the data group (over data x sp under sp), both over
``T``.  A stand-in's rows (``rows_counted()`` False: a rank with no rows
of a micro-batch runs one so that it issues the group's collectives)
count as no tokens.

**Split over ep and tp** (``parallel/sharding.shard_model``: the
"expert" dim of ``w_in``/``w_out`` over ep, ``param.ep_split``; their
"mlp" dim over tp, ``w_in`` column- and ``w_out`` row-parallel,
``param.tp_split``).  The rows are the same on every rank of the
weights' ``model_group`` (the tp group, the ep group, or with both the
joint tp x ep group: ``parallel/mesh.py::JOINT_AXES``), as the reference
lays them (``batch`` over dp x fsdp, replicated over tp and ep), and so
are the router, the routing and the capacity buffer.  Each rank runs its
experts (``[r E/ep, (r + 1) E/ep)``, all E without ep) at its ``f / tp``
columns on their rows of the ``[E, C, D]`` buffer, which gives partial
expert outputs.  Each (token, choice) gathers its **ungated** output
from them, ``[2T, D]`` in priority order, zero where this rank holds no
part of its expert, and ONE ``reduce_from_group`` over ``model_group``
sums them; the gates weight the whole sums.  So the gates' gradient,
and through it the router's and the input's, is whole on every rank
(summing gated partials would leave each tp rank a partial share of
it).  Only the experts' input passes ``copy_to_group`` (its gradient is
a partial sum per rank); the router branch's is whole already.  Under ep
alone the sum is exact: each slot has one non-zero term across the
ranks, so it equals one process's gather bitwise.  Under tp the
contraction over f is split, so the sum rounds differently (about 1e-7
relative).

**Dropless under ep and tp** (the serving predictor's layouts,
``serving/sharded.py``'s rules, the same splits).  Rank r runs its
experts at its ``f / tp`` columns on every token, keeps each token's
gated output of a chosen expert it holds (zero for one it does not) and
the ``[T, D]`` float32 partials are summed in ONE all-reduce over
``model_group``: one collective per MoE layer per forward, over the
smallest tensor (the gated ``[T, D]``, not ``[E, T, D]``); the input
passes ``copy_to_group`` over the same group.  Under ep alone this is
exact (each token has at most two non-zero terms across the ranks), so
the sum is one process's ``g0 a + g1 b`` bitwise.  Serving never
differentiates, so the gated partials' partial gate gradient does not
arise there.  The router stays whole on every rank.

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
    ``offsets [rows, 2, E]`` (under a data group or a sequence split; the
    T tokens are ``rows`` rows of equal length) is added to the position
    of a choice-c assignment to expert e of a token of row b: where the
    global priority order puts that row's choices among the other
    ranks'."""
    pri = experts.t().reshape(-1)                       # [2T]
    onehot = F.one_hot(pri, num_experts)                # [2T, E]
    pos = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(dim=-1)
    if offsets is not None:
        tokens = experts.shape[0]
        choice = torch.arange(2, device=pri.device).repeat_interleave(tokens)
        row = (torch.arange(tokens, device=pri.device).repeat(2)
               // (tokens // offsets.shape[0]))
        pos = pos + offsets[row, choice, pri]
    keep = pos < cap
    slot = torch.where(keep, pri * cap + pos,
                       torch.full_like(pos, num_experts * cap))
    return slot, keep


def global_routing(experts: torch.Tensor, rows: int, num_experts: int,
                   group, sequence: pd.SequenceSplit | None = None,
                   counted: bool = True) -> dict:
    """This rank's place in the global batch's routing (module docstring)
    for ``experts [T, 2]`` of its ``rows`` rows (under ``sequence``, its
    chunks of them): ``tokens`` (global T), ``first`` (the global
    first-choice count per expert, ``[E]``), ``offsets [rows, 2, E]`` for
    ``capacity_slots``, and ``assigned`` (every (token, choice)
    assignment per expert, ``[E]``).  Under ``sequence`` one
    ``all_gather`` of ``[rows, 2, E]`` counts over its sp group, and with
    a data ``group`` one of ``[2, E]`` over that group (collectives: every
    rank calls them, a stand-in with ``counted`` False giving zeros)."""
    counts = F.one_hot(experts.reshape(rows, -1, 2), num_experts).sum(dim=1)
    if not counted:
        counts = torch.zeros_like(counts)               # [rows, 2, E]
    chunks = (counts[None] if sequence is None else
              pd.all_gather_cat(counts[None], 0, sequence.group))
    per_row = chunks.sum(dim=0)                         # every chunk of a row
    mine = per_row.sum(dim=0)                           # this data rank's
    if group is None:
        total, below = mine, torch.zeros_like(mine)
    else:
        table = pd.all_gather_cat(mine[None], 0, group)  # [data ranks, 2, E]
        total = table.sum(dim=0)
        below = table[:pd.rank_of(group)].sum(dim=0)
    # in (data rank, row, chunk) order, what precedes each of this rank's
    # row chunks, less what capacity_slots' local cumsum counts already:
    # this chunk's earlier rows, and for a second choice every local first
    # choice (globally it follows every first choice)
    index = 0 if sequence is None else sequence.index
    before = (below + torch.cumsum(per_row, dim=0) - per_row
              + chunks[:index].sum(dim=0))
    offsets = before - (torch.cumsum(counts, dim=0) - counts)
    offsets[:, 1] += total[0] - counts[:, 0].sum(dim=0)
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
        group = sequence = None
        if not dropless:
            group, sequence = pd.data_parallel_group(), pd.sequence_split()
        xf = x.float().reshape(tokens, d)
        gates = gates.reshape(tokens, 2)
        experts = experts.reshape(tokens, 2)
        # load-balance aux (Switch eq. 4): fraction of first choices per
        # expert times its mean router probability; only the second
        # factor carries a gradient
        glob = None
        if group is None and sequence is None:
            frac = F.one_hot(experts[:, 0], e).float().mean(dim=0)
            aux = (frac * probs.mean(dim=(0, 1))).sum() * e
        else:
            counted = pd.rows_counted()
            glob = global_routing(experts, b, e, group, sequence, counted)
            sums = probs.sum(dim=(0, 1)) * (1.0 if counted else 0.0)
            over = group if sequence is None else sequence.joint
            mean_probs = pd.sum_over_group(sums, over) / glob["tokens"]
            aux = (glob["first"].float() / glob["tokens"]
                   * mean_probs).sum() * e
        ep = getattr(self.w_in, "ep_split", None)
        if dropless:
            return self._dropless(xf, gates, experts, ep).reshape(
                b, s, d).to(x.dtype), aux
        if glob is None:
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
        model = getattr(self.w_in, "model_group", None)
        first, local = 0, e
        if ep is not None:                              # this rank's experts
            local = e // ep.size
            first = ep.index * local
        if model is not None:
            # every rank's experts read the same tokens: their input
            # gradient contributions sum over the group
            xf = pd.copy_to_group(xf, model)
        x_pad = torch.cat([xf, xf.new_zeros(1, d)])
        expert_in = x_pad[fill[first * cap:(first + local) * cap]].reshape(
            local, cap, d)
        w_in, w_out = self._experts()
        h = F.gelu(torch.bmm(expert_in, w_in), approximate="tanh")
        out = torch.bmm(h, w_out).reshape(local * cap, d)  # partial over tp
        out = torch.cat([out, out.new_zeros(1, d)])            # + spare slot
        # each (token, choice)'s slot in this rank's buffer; the spare for
        # a dropped one and for another rank's expert
        mine = slot - first * cap
        mine = torch.where((mine >= 0) & (mine < local * cap), mine,
                           torch.full_like(mine, local * cap))
        y = self._combine(out[mine], gates, model)
        return y.reshape(b, s, d).to(x.dtype), aux

    @staticmethod
    def _combine(chosen: torch.Tensor, gates: torch.Tensor,
                 group) -> torch.Tensor:
        """Each token's two chosen outputs weighted by its gates ``[T,
        2]``: ``[T, D]``.  ``chosen [2T, D]`` (priority order) is this
        rank's ungated share, summed over ``group`` first, so that every
        rank weights whole outputs (module docstring)."""
        if group is not None:
            chosen = pd.reduce_from_group(chosen, group)
        weights = gates.t().reshape(-1, 1)                     # priority order
        return (chosen * weights).reshape(2, -1, chosen.shape[1]).sum(dim=0)

    def _dropless(self, xf: torch.Tensor, gates: torch.Tensor,
                  experts: torch.Tensor, ep) -> torch.Tensor:
        """Every (local) expert on every token ``xf [T, D]``, each token's
        two chosen outputs weighted by ``gates [T, 2]``: ``[T, D]`` in
        float32.  Split over ep and/or tp (module docstring), this rank's
        gated partial is summed over ``model_group``."""
        tokens = xf.shape[0]
        group = getattr(self.w_in, "model_group", None)
        if group is not None:
            # every rank's experts read the same tokens: their input
            # gradient contributions sum over the group
            xf = pd.copy_to_group(xf, group)
        w_in, w_out = self._experts()
        h = F.gelu(torch.matmul(xf[None], w_in), approximate="tanh")
        out = torch.bmm(h, w_out)                      # [E or E/ep, T, D]
        rows = torch.arange(tokens, device=xf.device)[:, None]
        if ep is None:
            sel = out[experts, rows]                           # [T, 2, D]
        else:
            # the choices this rank's experts serve; zero elsewhere
            local = out.shape[0]
            idx = experts - ep.index * local
            mine = (idx >= 0) & (idx < local)
            sel = torch.where(mine[..., None],
                              out[idx.clamp(0, local - 1), rows],
                              out.new_zeros(()))
        y = (sel * gates[..., None]).sum(dim=1)
        if group is not None:
            y = pd.reduce_from_group(y, group)
        return y

