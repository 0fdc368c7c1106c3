"""Mixture-of-Experts FFN: top-2 routing over ``num_experts`` GELU FFNs.

Counterpart of ``kubeflow_tpu/models/moe.py``'s ``MoEBlock``, on one
device (the ``ep`` all-to-all waits for the multi-device slice):

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


def capacity_slots(experts: torch.Tensor, num_experts: int,
                   cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Priority routing of ``experts [T, 2]`` into ``cap`` slots per expert.

    Returns ``(slot, keep)`` over the ``2T`` assignments in priority order
    (every first choice, then every second choice, tokens in order):
    ``slot = expert * cap + position`` for a kept assignment and
    ``num_experts * cap`` (one past the buffer) for a dropped one."""
    pri = experts.t().reshape(-1)                       # [2T]
    onehot = F.one_hot(pri, num_experts)                # [2T, E]
    pos = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(dim=-1)
    keep = pos < cap
    slot = torch.where(keep, pri * cap + pos,
                       torch.full_like(pos, num_experts * cap))
    return slot, keep


class MoEBlock(nn.Module):
    """Top-2 gated MoE FFN over ``[B, S, D]``; ``forward`` returns ``(y,
    aux)``.  ``dropless`` is the default mode; a call may override it
    (the Llama block passes ``dropless=cache is not None``).  After a
    capacity-mode call, ``dropped`` holds the number of (token, choice)
    assignments that overflowed (a device scalar)."""

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
        """The expert weights rounded to the model dtype (dequantized
        first when int8), in float32."""
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
        # load-balance aux (Switch eq. 4): fraction of first choices per
        # expert times its mean router probability; only the second
        # factor carries a gradient
        frac = F.one_hot(experts[..., 0], e).float().mean(dim=(0, 1))
        aux = (frac * probs.mean(dim=(0, 1))).sum() * e
        w_in, w_out = self._experts()
        xf = x.float().reshape(tokens, d)
        gates = gates.reshape(tokens, 2)
        experts = experts.reshape(tokens, 2)
        if dropless:
            h = F.gelu(torch.matmul(xf[None], w_in), approximate="tanh")
            out = torch.bmm(h, w_out)                          # [E, T, D]
            rows = torch.arange(tokens, device=x.device)[:, None]
            sel = out[experts, rows]                           # [T, 2, D]
            y = (sel * gates[..., None]).sum(dim=1)
            return y.reshape(b, s, d).to(x.dtype), aux
        cap = capacity(self.config, tokens)
        slot, keep = capacity_slots(experts, e, cap)
        self.dropped = (~keep).sum()
        # slot -> the token that fills it; unfilled slots read the zero row
        # at index ``tokens`` (dropped assignments all land on the spare
        # slot past the buffer, which is never read)
        order = torch.arange(tokens, device=x.device).repeat(2)
        fill = torch.full((e * cap + 1,), tokens, dtype=torch.long,
                          device=x.device)
        fill[slot] = order
        x_pad = torch.cat([xf, xf.new_zeros(1, d)])
        expert_in = x_pad[fill[:-1]].reshape(e, cap, d)
        h = F.gelu(torch.bmm(expert_in, w_in), approximate="tanh")
        out = torch.bmm(h, w_out).reshape(e * cap, d)
        out = torch.cat([out, out.new_zeros(1, d)])            # + spare slot
        weights = gates.t().reshape(-1, 1)                     # priority order
        y = (out[slot] * weights).reshape(2, tokens, d).sum(dim=0)
        return y.reshape(b, s, d).to(x.dtype), aux
