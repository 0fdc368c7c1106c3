"""Training-step construction, on one device or over a data-parallel gang.

Counterpart of ``kubeflow_tpu/parallel/train_step.py``.  The reference
jits forward, backward and update into one sharded function over its
mesh; here ``build_train_step`` returns an eager PyTorch function with
the same contract::

    state = init_train_state(model, make_optimizer({"name": "adamw"}))
    step = build_train_step(forward, state.tx, grad_accum=2)
    state, metrics = step(state, batch)   # {"loss", "grad_norm"}

``forward(model, batch)`` returns the scalar loss (the reference's
``forward(params, batch)``: here the parameters live in the module).  A
parameter the loss never reaches gets a zero gradient, as ``jax.grad``
gives, so the optimizer still decays it and ``grad_norm`` counts it.
The update is in place (the reference returns new arrays; PyTorch keeps
one copy of the weights and moments).

**Data parallelism.**  With ``group`` of W > 1 ranks (each holding its
rows of the global batch, as the Trainer's datasets give them) the step
computes what the reference's pjit computes on the assembled global
array, whose rows are rank-major (rank 0's rows, then rank 1's):

- the loss is the global-batch loss.  ``loss_weight(batch)`` is the
  denominator of the model's loss on a batch (rows or tokens for a mean,
  the mask weight for BERT's masked LM); each rank scales its loss by
  ``max(w_local, 1) / max(w_global, 1)``, ``w_global`` summed over the
  gang, so the sum over ranks is the loss over the global batch;
- gradients (and that loss) are summed over the gang in a few flat
  buckets before ``global_norm`` and the update, so every rank reports
  the same loss and grad_norm and takes the same step;
- under ``grad_accum`` A, micro-batch i is rows ``[i n/A, (i+1) n/A)`` of
  the rank-major global batch of n rows, as the reference's reshape of
  the assembled array takes it; each rank runs its piece of it.  A rank
  whose piece is empty skips it, unless the model reduces over the group
  in its forward (BatchNorm's global statistics): then it runs the empty
  piece so that every rank issues the same collectives;
- the group is bound (``distributed.data_parallel``) while forward and
  backward run, so BatchNorm takes global-batch statistics.

Mesh objects, fsdp, tp, sp and MoE under dp wait for the multi-device
slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch import nn

from kubeflow_tpu_torch.parallel import distributed as pd
from kubeflow_tpu_torch.training.optim import Optimizer, global_norm


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    tx: Optimizer


def check_single_device(mesh=None, *, world: int = 1, **axes: int) -> None:
    """Refuse, by name, a mesh object, fsdp / tp / sp above 1, and a
    ``dp`` other than the gang's ``world`` (or -1, "every rank")."""
    if mesh is not None and not isinstance(mesh, torch.device):
        raise NotImplementedError(
            f"mesh {mesh!r}: the port takes no mesh objects; meshes wait "
            "for the multi-device slice")
    for name, size in axes.items():
        if name == "dp":
            if size not in (-1, world):
                raise ValueError(
                    f"dp={size} but the process group has {world} "
                    f"rank{'s' if world > 1 else ''}: dp is the gang's "
                    "size (or -1)")
        elif size != 1:
            raise NotImplementedError(
                f"{name}={size}: the port trains data-parallel only; "
                f"{name} waits for the multi-device slice")


def init_train_state(model: nn.Module, tx: Optimizer) -> TrainState:
    """Turn the model's parameters trainable and initialise the
    optimizer's moments beside them (step 0)."""
    model.requires_grad_(True)
    tx.init(list(model.parameters()))
    return TrainState(step=0, model=model, tx=tx)


def _loss_and_grads(forward, model, params, batch):
    loss = forward(model, batch)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for g, p in zip(grads, params)]


def _accumulate(grads, new):
    if grads is None:
        return list(new)
    torch._foreach_add_(grads, new)
    return grads


def _rows(batch: dict) -> int:
    return next(iter(batch.values())).shape[0]


def _local_steps(forward, model, params, batch, grad_accum):
    """One process: the mean over ``grad_accum`` contiguous micro-batches
    of their losses and gradients."""
    if grad_accum == 1:
        return _loss_and_grads(forward, model, params, batch)
    n = _rows(batch)
    if n % grad_accum:
        raise ValueError(f"batch of {n} rows does not split into "
                         f"{grad_accum} micro-batches")
    rows = n // grad_accum
    loss, grads = None, None
    for i in range(grad_accum):
        micro = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
        m_loss, m_grads = _loss_and_grads(forward, model, params, micro)
        loss = m_loss if loss is None else loss + m_loss
        grads = _accumulate(grads, m_grads)
    torch._foreach_div_(grads, grad_accum)
    return loss / grad_accum, grads


def _pieces(n_local: int, rank: int, world: int, grad_accum: int):
    """This rank's local row range of each micro-batch of the rank-major
    global batch (possibly empty)."""
    total = n_local * world
    if total % grad_accum:
        raise ValueError(f"global batch of {total} rows does not split "
                         f"into {grad_accum} micro-batches")
    m, first = total // grad_accum, rank * n_local
    return [(min(max(i * m - first, 0), n_local),
             min(max((i + 1) * m - first, 0), n_local))
            for i in range(grad_accum)]


def _gang_steps(forward, loss_weight, model, params, batch, grad_accum,
                group):
    """W ranks: this rank's share of the global-batch loss and gradients,
    then both summed over the gang."""
    world, rank = pd.world_size(group), pd.rank_of(group)
    pieces = _pieces(_rows(batch), rank, world, grad_accum)
    micro = [{k: v[lo:hi] for k, v in batch.items()} for lo, hi in pieces]
    local_w = torch.stack([torch.as_tensor(loss_weight(b)).float()
                           .to(params[0].device) for b in micro])
    global_w = local_w.clone()
    pd.all_reduce_sum([global_w], group)
    scale = (local_w.clamp_min(1.0) / global_w.clamp_min(1.0)) / grad_accum
    reduces = any(getattr(m, "reduces_over_group", False)
                  for m in model.modules())
    loss = torch.zeros((), device=params[0].device)
    grads = None
    with pd.data_parallel(group):
        for i, (lo, hi) in enumerate(pieces):
            if hi == lo and not reduces:
                continue
            m_loss = forward(model, micro[i])
            if hi > lo:
                m_loss = m_loss * scale[i]
                out = torch.ones_like(m_loss)
                loss = loss + m_loss.detach().float()
            else:
                # the empty piece's loss is a mean over no rows (nan); a
                # zero cotangent runs its backward's collectives only
                out = torch.zeros_like(m_loss)
            g = torch.autograd.grad(m_loss, params, grad_outputs=out,
                                    allow_unused=True)
            grads = _accumulate(grads, [torch.zeros_like(p) if x is None
                                        else x for x, p in zip(g, params)])
    if grads is None:
        grads = [torch.zeros_like(p) for p in params]
    pd.all_reduce_sum(grads + [loss], group)
    return loss, grads


def build_train_step(
    forward: Callable[[nn.Module, Any], torch.Tensor],
    tx: Optimizer,
    mesh=None,
    *,
    grad_accum: int = 1,
    group=None,
    loss_weight: Callable[[dict], Any] | None = None,
) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """``step(state, batch) -> (state, {"loss", "grad_norm"})``.

    ``grad_accum`` > 1 splits the (global) batch's leading axis into that
    many contiguous micro-batches and takes the mean of their losses and
    gradients, as the reference's scan.  ``grad_norm`` is the global norm
    of those gradients before any clipping.  ``group`` (W > 1 ranks) and
    ``loss_weight`` make the step data-parallel (module docstring).  Both
    metrics are float32 device scalars: reading them syncs, so the caller
    chooses when."""
    check_single_device(mesh)
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if pd.world_size(group) == 1:
        group = None
    elif loss_weight is None:
        raise ValueError("a data-parallel step needs the model's "
                         "loss_weight (the denominator of its loss)")

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        model = state.model
        params = list(model.parameters())
        if group is None:
            loss, grads = _local_steps(forward, model, params, batch,
                                       grad_accum)
        else:
            if getattr(getattr(model, "config", None), "moe_experts", 0):
                # the Switch aux loss is a product of global means and the
                # capacity positions run over the global token set
                raise NotImplementedError(
                    "moe_experts under data parallelism waits for expert "
                    "parallelism (ep) in the multi-device slice")
            loss, grads = _gang_steps(forward, loss_weight, model, params,
                                      batch, grad_accum, group)
        grad_norm = global_norm(grads)
        tx.update(params, grads, grad_norm)
        return (TrainState(step=state.step + 1, model=model, tx=state.tx),
                {"loss": loss.float(), "grad_norm": grad_norm})

    return step


def build_eval_step(
    forward_metrics: Callable[[nn.Module, Any], dict],
    mesh=None,
) -> Callable[[nn.Module, Any], dict]:
    """``eval_step(model, batch) -> metrics``, without gradients."""
    check_single_device(mesh)

    @torch.no_grad()
    def eval_step(model, batch):
        return forward_metrics(model, batch)

    return eval_step
