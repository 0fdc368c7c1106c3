"""Training-step construction on one device.

Counterpart of ``kubeflow_tpu/parallel/train_step.py``.  The reference
jits forward, backward and update into one sharded function over its
mesh; here ``build_train_step`` returns an eager PyTorch function on one
device with the same contract::

    state = init_train_state(model, make_optimizer({"name": "adamw"}))
    step = build_train_step(forward, state.tx, grad_accum=2)
    state, metrics = step(state, batch)   # {"loss", "grad_norm"}

``forward(model, batch)`` returns the scalar loss (the reference's
``forward(params, batch)``: here the parameters live in the module).  A
parameter the loss never reaches gets a zero gradient, as ``jax.grad``
gives, so the optimizer still decays it and ``grad_norm`` counts it.
The update is in place (the reference returns new arrays; PyTorch keeps
one copy of the weights and moments).  Mesh arguments other than one
device wait for the multi-device slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch import nn

from kubeflow_tpu_torch.training.optim import Optimizer, global_norm


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    tx: Optimizer


def check_single_device(mesh=None, **axes: int) -> None:
    """Refuse, by name, anything but one device: a mesh object, or any
    of dp / fsdp / tp / sp above 1 (``dp=-1``, "all devices", is one)."""
    if mesh is not None and not isinstance(mesh, torch.device):
        raise NotImplementedError(
            f"mesh {mesh!r}: the port trains on one device; meshes wait "
            "for the multi-device slice")
    for name, size in axes.items():
        if size not in ((1, -1) if name == "dp" else (1,)):
            raise NotImplementedError(
                f"{name}={size}: the port trains on one device; {name} "
                "waits for the multi-device slice")


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


def build_train_step(
    forward: Callable[[nn.Module, Any], torch.Tensor],
    tx: Optimizer,
    mesh=None,
    *,
    grad_accum: int = 1,
) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """``step(state, batch) -> (state, {"loss", "grad_norm"})``.

    ``grad_accum`` > 1 splits the batch's leading axis into that many
    contiguous micro-batches, sums their losses and gradients and divides
    both by ``grad_accum``, as the reference's scan.  ``grad_norm`` is the
    global norm of those gradients before any clipping.  Both metrics are
    float32 device scalars: reading them syncs, so the caller chooses
    when."""
    check_single_device(mesh)
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        model = state.model
        params = list(model.parameters())
        if grad_accum > 1:
            n = next(iter(batch.values())).shape[0]
            if n % grad_accum:
                raise ValueError(f"batch of {n} rows does not split into "
                                 f"{grad_accum} micro-batches")
            rows = n // grad_accum
            loss, grads = None, None
            for i in range(grad_accum):
                micro = {k: v[i * rows:(i + 1) * rows]
                         for k, v in batch.items()}
                m_loss, m_grads = _loss_and_grads(forward, model, params,
                                                  micro)
                if grads is None:
                    loss, grads = m_loss, m_grads
                else:
                    loss = loss + m_loss
                    torch._foreach_add_(grads, m_grads)
            loss = loss / grad_accum
            torch._foreach_div_(grads, grad_accum)
        else:
            loss, grads = _loss_and_grads(forward, model, params, batch)
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
