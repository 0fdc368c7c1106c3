"""Optimizer construction from declarative config, with optax's semantics.

Counterpart of ``kubeflow_tpu/training/optim.py``.  ``make_optimizer``
returns an ``Optimizer`` that updates a list of parameters in place from
their gradients, as ``optax.apply_updates(params, tx.update(...))`` would:

- the schedule is evaluated at the update count BEFORE it is incremented,
  so the first update uses step 0 (optax's ``scale_by_schedule``);
- ``adam`` / ``adamw``: bias-corrected moments, ``eps`` 1e-8 outside the
  square root; adamw adds ``weight_decay * p`` to every parameter's update
  before the learning rate, whatever its gradient (``add_decayed_weights``);
- ``sgd``: optax's ``trace`` momentum (``t = g + momentum * t``);
- ``lamb``: adam moments (``eps`` 1e-6), decayed weights, then each
  tensor's update scaled by ``|p| / |u|`` (1 where either norm is 0).
  On a mesh, where a parameter is this rank's block, the norms are the
  whole tensor's: the train step hands ``update`` a ``whole_squares``
  that sums each block's squares over the gang, and the update is then
  computed twice (once for its norms, once to apply it);
- ``grad_clip_norm``: ``clip_by_global_norm`` before the optimizer (the
  gradients are scaled by ``max_norm / |g|`` where ``|g| >= max_norm``).

Updates run as PyTorch ``_foreach`` ops over chunks of the parameter list
and never read a value back to the host.  A chunk holds at most as many
elements as the largest parameter (``_chunks``), so the temporaries an
update makes (the clipped gradients, adam's denominator and update) are
each one such chunk, not a model-sized copy; each element goes through the
same operations in the same order as over the whole list, so the result
is the same bits.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np
import torch

NAMES = ("adamw", "adam", "sgd", "lamb")


def make_schedule(cfg: dict[str, Any]) -> Callable[[int], float]:
    """``step -> learning rate`` (constant, cosine or linear, optax's
    ``warmup_cosine_decay_schedule`` / joined ``linear_schedule``s)."""
    kind = cfg.get("schedule", "constant")
    lr = float(cfg.get("learning_rate", 1e-3))
    if kind == "constant":
        return lambda step: lr
    warmup = int(cfg.get("warmup_steps", 0))
    total = int(cfg.get("total_steps", 10000))

    def linear(init, end, steps):
        if steps <= 0:        # optax: a constant init_value
            return lambda c: init
        return lambda c: (init - end) * (1 - min(max(c, 0), steps) / steps
                                         ) + end

    if kind == "cosine":
        end_lr = float(cfg.get("end_lr", 0.0))
        alpha = 0.0 if lr == 0.0 else end_lr / lr
        decay = total - warmup
        if decay <= 0:
            raise ValueError("the cosine schedule requires total_steps > "
                             f"warmup_steps, got {total} <= {warmup}")
        warm = linear(0.0, lr, warmup)

        def cosine(step):
            if step < warmup:
                return warm(step)
            cos = 0.5 * (1 + math.cos(math.pi * min(step - warmup, decay)
                                      / decay))
            return lr * ((1 - alpha) * cos + alpha)
        return cosine
    if kind == "linear":
        up = linear(0.0, lr, warmup)
        down = linear(lr, 0.0, max(total - warmup, 1))
        return lambda step: up(step) if step < warmup else down(step - warmup)
    raise ValueError(f"unknown schedule {kind!r}")


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum |t|^2)`` over all tensors, float32, on their device."""
    return sum_of_squares(tensors, tensors[0].device).sqrt().float()


def sum_of_squares(tensors: list[torch.Tensor],
                   device: torch.device) -> torch.Tensor:
    """``sum |t|^2`` over all tensors (zero for none) as a scalar on
    ``device``: each tensor's norm squared and summed.  On the CPU the
    sum is float64: PyTorch's float32 CPU norm of a large tensor drifts
    by ~1e-5 relative (1.6e-5 for a 512 x 512 gradient), where the
    reference's reduction and the card's ``_foreach_norm`` stay near
    float32 rounding."""
    if device.type == "cpu":
        return torch.stack([torch.linalg.vector_norm(t, dtype=torch.float64)
                            for t in tensors]
                           or [torch.zeros((), dtype=torch.float64)]
                           ).square().sum()
    if not tensors:
        return torch.zeros((), device=device)
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.stack(norms).square().sum()


def _tensor_squares(tensors: list[torch.Tensor]) -> torch.Tensor:
    """``|t|^2`` of each tensor, ``[n]`` (float64 on the CPU, as
    ``sum_of_squares`` keeps its sums)."""
    if tensors[0].device.type == "cpu":
        return torch.stack([torch.linalg.vector_norm(t, dtype=torch.float64)
                            for t in tensors]).square()
    return torch.stack(torch._foreach_norm(tensors)).square()


def _chunks(n_elements: list[int]) -> list[range]:
    """Consecutive index ranges of the parameter list, each holding at most
    ``max(n_elements)`` elements (a tensor larger than that bound is a
    chunk of its own)."""
    bound = max(n_elements, default=0)
    chunks, start, total = [], 0, 0
    for i, n in enumerate(n_elements):
        if i > start and total + n > bound:
            chunks.append(range(start, i))
            start, total = i, 0
        total += n
    if start < len(n_elements):
        chunks.append(range(start, len(n_elements)))
    return chunks


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay ** count`` in float32, as optax computes it (for b2 =
    0.999 at count 1 that is 1.3e-5 off the exact 0.001)."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


class Optimizer:
    """One of ``NAMES`` over a fixed list of parameters (see the module
    docstring for the semantics).  ``state_dict`` / ``load_state_dict``
    carry the update count and every moment for checkpoints."""

    def __init__(self, name: str, schedule: Callable[[int], float], *,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, momentum: float = 0.9,
                 clip_norm: float | None = None):
        if name not in NAMES:
            raise ValueError(f"unknown optimizer {name!r}")
        self.name, self.schedule = name, schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.momentum = weight_decay, momentum
        self.clip_norm = clip_norm
        self.count = 0
        self.moments: dict[str, list[torch.Tensor]] = {}

    def init(self, params: list[torch.Tensor]) -> None:
        def zeros():
            return [torch.zeros_like(p) for p in params]

        self.count = 0
        self.moments = ({"trace": zeros()} if self.name == "sgd"
                        else {"mu": zeros(), "nu": zeros()})

    @torch.no_grad()
    def update(self, params: list[torch.Tensor], grads: list[torch.Tensor],
               grad_norm: torch.Tensor | None = None,
               whole_squares: Callable[[torch.Tensor], torch.Tensor]
               | None = None) -> None:
        """Apply one update in place.  ``grads`` are not modified;
        ``grad_norm`` (their global norm) is computed when not given.
        ``whole_squares`` (lamb on a mesh, where ``params`` are this rank's
        blocks; ``parallel/sharding.whole_squares``) maps each tensor's
        ``[|p|^2, |u|^2]`` over its block, ``[n, 2]``, to the whole
        tensor's; other optimizers ignore it."""
        scale = None
        if self.clip_norm:
            g_norm = global_norm(grads) if grad_norm is None else grad_norm
            scale = torch.where(g_norm < self.clip_norm,
                                torch.ones_like(g_norm),
                                self.clip_norm / g_norm)
        lr = self.schedule(self.count)
        self.count += 1
        bc1 = _bias_correction(self.b1, self.count)
        bc2 = _bias_correction(self.b2, self.count)
        chunks = _chunks([p.numel() for p in params])
        if self.name == "lamb" and whole_squares is not None:
            self._whole_lamb(params, grads, scale, chunks, lr, bc1, bc2,
                             whole_squares)
            return
        for idx in chunks:
            p = [params[i] for i in idx]
            g = [grads[i] for i in idx]
            if scale is not None:
                g = torch._foreach_mul(g, scale)
            if self.name == "sgd":
                self._sgd(p, g, [self.moments["trace"][i] for i in idx], lr)
            else:
                self._adam(p, g, [self.moments["mu"][i] for i in idx],
                           [self.moments["nu"][i] for i in idx], lr, bc1, bc2)

    def _sgd(self, params, grads, trace, lr: float) -> None:
        torch._foreach_mul_(trace, self.momentum)
        torch._foreach_add_(trace, grads)
        torch._foreach_add_(params, trace, alpha=-lr)

    def _moments(self, grads, mu, nu) -> None:
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - self.b2)

    def _direction(self, params, mu, nu, bc1: float, bc2: float) -> list:
        """adam's bias-corrected update from the moments, plus the decayed
        weights for adamw and lamb."""
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, denom)
        del denom
        if self.weight_decay and self.name in ("adamw", "lamb"):
            torch._foreach_add_(upd, params, alpha=self.weight_decay)
        return upd

    def _adam(self, params, grads, mu, nu, lr: float, bc1: float,
              bc2: float) -> None:
        """adam / adamw / lamb over one chunk (bias corrections given)."""
        self._moments(grads, mu, nu)
        upd = self._direction(params, mu, nu, bc1, bc2)
        if self.name == "lamb":
            p_norm = torch._foreach_norm(params)
            u_norm = torch._foreach_norm(upd)
            for u, pn, un in zip(upd, p_norm, u_norm):
                u.mul_(torch.where((pn == 0) | (un == 0),
                                   torch.ones_like(pn), pn / un))
        torch._foreach_add_(params, upd, alpha=-lr)

    def _whole_lamb(self, params, grads, scale, chunks, lr: float,
                    bc1: float, bc2: float, whole_squares) -> None:
        """lamb over blocks with the whole tensors' trust ratios: a first
        pass updates the moments and takes each chunk's ``|p|^2`` and
        ``|u|^2`` (its update dropped), ``whole_squares`` sums them over
        the blocks, a second pass computes the updates again from the
        moments (the same operations: the same bits) and applies them
        scaled."""
        mu, nu = self.moments["mu"], self.moments["nu"]
        squares = []
        for idx in chunks:
            p = [params[i] for i in idx]
            g = [grads[i] for i in idx]
            if scale is not None:
                g = torch._foreach_mul(g, scale)
            self._moments(g, [mu[i] for i in idx], [nu[i] for i in idx])
            upd = self._direction(p, [mu[i] for i in idx],
                                  [nu[i] for i in idx], bc1, bc2)
            squares.append(torch.stack([_tensor_squares(p),
                                        _tensor_squares(upd)], dim=1))
            del upd
        norms = whole_squares(torch.cat(squares)).sqrt()
        ratios = torch.where((norms[:, 0] == 0) | (norms[:, 1] == 0),
                             torch.ones_like(norms[:, 0]),
                             norms[:, 0] / norms[:, 1]).to(params[0].dtype)
        for idx in chunks:
            p = [params[i] for i in idx]
            upd = self._direction(p, [mu[i] for i in idx],
                                  [nu[i] for i in idx], bc1, bc2)
            for u, i in zip(upd, idx):
                u.mul_(ratios[i])
            torch._foreach_add_(p, upd, alpha=-lr)

    def state_dict(self) -> dict:
        return {"name": self.name, "count": self.count,
                "moments": self.moments}

    def load_state_dict(self, state: dict) -> None:
        if state["name"] != self.name:
            raise ValueError(f"checkpoint holds {state['name']} state, not "
                             f"{self.name}")
        self.count = int(state["count"])
        with torch.no_grad():
            for key, dst in self.moments.items():
                torch._foreach_copy_(dst, state["moments"][key])


def make_optimizer(cfg: dict[str, Any] | None = None) -> Optimizer:
    """cfg: {name: adamw|adam|sgd|lamb, learning_rate, weight_decay,
    schedule: constant|cosine|linear, warmup_steps, total_steps, end_lr,
    b1, b2, momentum, grad_clip_norm}."""
    cfg = dict(cfg or {})
    name = cfg.get("name", "adamw")
    if name not in NAMES:
        raise ValueError(f"unknown optimizer {name!r}")
    kw: dict[str, Any] = {}
    if name in ("adamw", "adam"):
        kw.update(b1=float(cfg.get("b1", 0.9)), b2=float(cfg.get("b2", 0.999)))
    if name in ("adamw", "lamb"):
        kw["weight_decay"] = float(cfg.get("weight_decay", 0.0))
    if name == "lamb":
        kw["eps"] = 1e-6
    if name == "sgd":
        kw["momentum"] = float(cfg.get("momentum", 0.9))
    clip = cfg.get("grad_clip_norm")
    return Optimizer(name, make_schedule(cfg),
                     clip_norm=float(clip) if clip else None, **kw)
