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

**Data parallelism.**  With a mesh of W > 1 ranks, all on dp (each
holding its rows of the global batch, as the Trainer's datasets give
them) the step computes what the reference's pjit computes on the
assembled global array, whose rows are rank-major (rank 0's rows, then
rank 1's):

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
  in its forward: then it runs the empty piece (BatchNorm's global
  statistics, to which it adds nothing), or for a model whose
  forward gathers over the group (the MoE block's expert counts) a
  one-row stand-in bound as uncounted, with a zero cotangent, so that
  every rank issues the same collectives;
- the group is bound (``distributed.data_parallel``) while forward and
  backward run, so BatchNorm takes global-batch statistics and the MoE
  block routes with the global batch's capacity, positions and aux.

**A mesh** (``parallel/mesh.make_mesh``) with fsdp or tp above 1 takes a
model that ``parallel/sharding.shard_model`` has split over it (before
the optimizer's ``init``, so the moments are blocks too).  The batch's
rows are split over the data axes (dp, fsdp): the ranks of one tp group
hold the same rows, the loss weights and the loss are summed over the
data group only, and BatchNorm binds that group.  The backward's
reduce-scatters have summed each fsdp-split gradient over fsdp; what is
left is summed here (over dp for those, over dp and fsdp for the
others); tp-split gradients are whole per rank, and a tp-replicated
one is the same on every rank of its tp group.  ``grad_norm`` is the
norm of the whole gradient (``sharding.global_norm``), and the
optimizer updates each rank's blocks in place.  Every rank runs every
micro-batch, since its forward issues the mesh's collectives: a piece
with no rows here runs a one-row stand-in with a zero cotangent (the
empty piece itself for a model that reduces over the group).  A mesh
that is only dp takes the data-parallel path above, over its dp group.

**Sequence parallelism** (sp above 1) takes the mesh path too, whatever
the other axes.  Each sp rank cuts the batch tensors named by
``sequence_keys`` (the registry model's ``sequence_keys``: BERT's and
Llama's ``[B, S]`` tensors) to its chunk of the sequence, positions
``[i S / sp, (i + 1) S / sp)``; forward and backward run under
``ops/attention.ring_context``, so self-attention is ring attention over
the sp group and the models place their chunk at its global positions.
The loss weights and the loss are summed over the data axes and sp, and
so are the gradients (an fsdp-split one over dp and sp).  A model
without ``sequence_keys`` (mlp, convnet, resnet) runs whole on every sp
rank, as the reference's replicated layout does: nothing is cut, and
nothing is summed over sp.

**Expert parallelism** (ep above 1) takes the mesh path too.  The rows
are split over the data axes only, so the ranks of one ep group hold the
same rows; a MoE model split by ``shard_model`` holds ``E / ep`` experts
a rank, at ``f / tp`` columns under tp (``models/moe.py`` sums their
chosen outputs over the weights' tp / ep group).  An expert block's
gradient is summed over the data axes only (and sp), never over ep or
tp, and every other gradient, identical on the ep ranks, likewise;
``grad_norm`` counts each expert block once.  A MoE model trains on any
mesh without pp: its block routes by the data group and, where the
sequence is split, by the ``distributed.SequenceSplit`` the step binds
beside it (the global batch's capacity, positions and aux).

**lamb on a mesh**: its trust ratio ``|p| / |u|`` takes the norms of the
whole tensors.  Each rank's squares of its blocks (counted by the one
replica that ``sharding.global_norm`` counts) are summed over the gang
in one all-reduce of ``[n_params, 2]`` a step
(``sharding.whole_squares``), which the optimizer's update is handed.

pp above 1 is refused by name: the reference's step has no path for it
(``parallel/pipeline.py`` runs pp on its own).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable

import torch
from torch import nn

from kubeflow_tpu_torch.ops.attention import ring_context
from kubeflow_tpu_torch.parallel import distributed as pd
from kubeflow_tpu_torch.parallel import sharding as sh
from kubeflow_tpu_torch.parallel.mesh import DATA_AXES, Mesh, factor_axes
from kubeflow_tpu_torch.training.optim import Optimizer, global_norm


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    tx: Optimizer


# axes a train step refuses above 1, and why
_REFUSED = {"pp": "pipeline parallelism has no train-step path in the "
                  "reference either; parallel/pipeline.pipeline_forward "
                  "runs it"}


def check_mesh(mesh: Mesh | None = None, *, world: int = 1,
               **axes: int) -> tuple[int, ...]:
    """Check a mesh (or its axis sizes as keywords) against a gang of
    ``world`` ranks; returns the six axis sizes.  pp above 1 is refused
    by name, and the axes must multiply to the gang (``factor_axes``'s
    rule: one axis may be -1, inferred)."""
    if mesh is not None:
        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh {mesh!r} is not a parallel.mesh.Mesh")
        axes = mesh.shape
    for name, why in _REFUSED.items():
        if axes.get(name, 1) != 1:
            raise NotImplementedError(f"{name}={axes[name]}: {why}")
    try:
        return factor_axes(world, **axes)
    except ValueError as e:
        given = ", ".join(f"{k}={v}" for k, v in axes.items())
        raise ValueError(
            f"{given} on a process group of {world} "
            f"rank{'s' if world > 1 else ''}: {e}") from None


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
                group, rank: int, world: int, run_all: bool = False,
                weight_group=None, sequence=None):
    """This rank's share of the global-batch loss and of its gradients,
    as rank ``rank`` of the ``world`` data ranks of ``group`` (not yet
    summed over them).  ``run_all`` (or a model whose forward gathers
    over the group): every piece runs, an empty one as an uncounted
    one-row stand-in with a zero cotangent (module docstring).  The loss
    weights are summed over ``weight_group`` (default ``group``; under
    sequence parallelism the data axes and sp), and ``sequence`` (a
    ``distributed.SequenceSplit``) is bound beside ``group``."""
    pieces = _pieces(_rows(batch), rank, world, grad_accum)
    micro = [{k: v[lo:hi] for k, v in batch.items()} for lo, hi in pieces]
    local_w = torch.stack([torch.as_tensor(loss_weight(b)).float()
                           .to(params[0].device) for b in micro])
    global_w = local_w.clone()
    if weight_group is None:
        weight_group = group
    if weight_group is not None:
        pd.all_reduce_sum([global_w], weight_group)
    scale = (local_w.clamp_min(1.0) / global_w.clamp_min(1.0)) / grad_accum
    reduces = any(getattr(m, "reduces_over_group", False)
                  for m in model.modules())
    run_all = run_all or any(getattr(m, "forward_collectives", False)
                             for m in model.modules())
    loss = torch.zeros((), device=params[0].device)
    grads = None
    for i, (lo, hi) in enumerate(pieces):
        piece, counted = micro[i], True
        if hi == lo and not reduces:
            if not run_all:
                continue
            piece, counted = {k: v[:1] for k, v in batch.items()}, False
        with pd.data_parallel(group, counted, sequence):
            m_loss = forward(model, piece)
            if hi > lo:
                m_loss = m_loss * scale[i]
                out = torch.ones_like(m_loss)
                loss = loss + m_loss.detach().float()
            else:
                # the empty piece's loss is a mean over no rows (nan), a
                # stand-in's counts no row of this micro-batch: a zero
                # cotangent runs their backward's collectives only
                out = torch.zeros_like(m_loss)
            g = torch.autograd.grad(m_loss, params, grad_outputs=out,
                                    allow_unused=True)
        grads = _accumulate(grads, [torch.zeros_like(p) if x is None
                                    else x for x, p in zip(g, params)])
    if grads is None:
        grads = [torch.zeros_like(p) for p in params]
    return loss, grads


def _sequence_chunk(batch: dict, keys, mesh: Mesh) -> dict:
    """The batch with every tensor of ``keys`` cut to this sp rank's chunk
    of its sequence axis (axis 1)."""
    n, i = mesh.shape["sp"], mesh.coordinate("sp")
    out = dict(batch)
    for key in keys:
        s = batch[key].shape[1]
        if s % n:
            raise ValueError(f"{key}: sequence length {s} does not divide "
                             f"by sp={n}")
        out[key] = batch[key][:, i * (s // n):(i + 1) * (s // n)]
    return out


def _mesh_steps(forward, loss_weight, model, params, batch, grad_accum,
                mesh: Mesh, sequence_keys=()):
    """The step's loss and gradients on a mesh with fsdp, tp or sp above
    1, summed over the data axes and, where the sequence is split, sp
    (module docstring)."""
    data = mesh.group(*DATA_AXES)
    index, count = mesh.data_index()
    seq_split = mesh.shape["sp"] > 1 and bool(sequence_keys)
    over, sequence = data, None
    ring = contextlib.nullcontext()
    if seq_split:
        batch = _sequence_chunk(batch, sequence_keys, mesh)
        over = mesh.group(*DATA_AXES, "sp")
        sequence = pd.SequenceSplit(mesh.group("sp"), mesh.coordinate("sp"),
                                    over)
        ring = ring_context(mesh)
    with ring:
        loss, grads = _gang_steps(forward, loss_weight, model, params, batch,
                                  grad_accum, data, index, count,
                                  run_all=True, weight_group=over,
                                  sequence=sequence)
    due: dict[int, tuple] = {}
    for g, group in zip(grads, sh.grad_groups(params, mesh,
                                              seq_split=seq_split)):
        if group is not None:
            due.setdefault(id(group), (group, []))[1].append(g)
    if over is not None:
        due.setdefault(id(over), (over, []))[1].append(loss)
    for group, tensors in due.values():
        pd.all_reduce_sum(tensors, group)
    return loss, grads


def build_train_step(
    forward: Callable[[nn.Module, Any], torch.Tensor],
    tx: Optimizer,
    mesh: Mesh | None = None,
    *,
    grad_accum: int = 1,
    loss_weight: Callable[[dict], Any] | None = None,
    sequence_keys: tuple[str, ...] = (),
) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """``step(state, batch) -> (state, {"loss", "grad_norm"})``.

    ``grad_accum`` > 1 splits the (global) batch's leading axis into that
    many contiguous micro-batches and takes the mean of their losses and
    gradients, as the reference's scan.  ``grad_norm`` is the global norm
    of those gradients before any clipping.  A ``mesh`` over the joined
    gang decides the layout: one rank, data-parallel when only dp is
    above 1, on the mesh path with fsdp, tp, sp or ep above 1 (module
    docstring; ``sequence_keys`` names the batch tensors whose axis 1 sp
    splits); more than one rank needs ``loss_weight``.  Both metrics are
    float32 device scalars: reading them syncs, so the caller chooses
    when."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    group = sharded = None
    if mesh is not None:
        check_mesh(mesh, world=pd.world_size(pd.default_group()))
        if mesh.axis_size("fsdp", "tp", "sp", "ep") > 1:
            sharded = mesh
        else:
            group = mesh.group("dp")
    if (sharded is not None or group is not None) and loss_weight is None:
        raise ValueError("a data-parallel step needs the model's "
                         "loss_weight (the denominator of its loss)")

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        model = state.model
        params = list(model.parameters())
        whole = None
        if sharded is not None:
            loss, grads = _mesh_steps(forward, loss_weight, model, params,
                                      batch, grad_accum, sharded,
                                      sequence_keys)
            grad_norm = sh.global_norm(grads, params, sharded)
            whole = functools.partial(sh.whole_squares, params=params,
                                      mesh=sharded)
        else:
            if group is None:
                loss, grads = _local_steps(forward, model, params, batch,
                                           grad_accum)
            else:
                loss, grads = _gang_steps(
                    forward, loss_weight, model, params, batch, grad_accum,
                    group, pd.rank_of(group), pd.world_size(group))
                pd.all_reduce_sum(grads + [loss], group)
            grad_norm = global_norm(grads)
        tx.update(params, grads, grad_norm, whole_squares=whole)
        return (TrainState(step=state.step + 1, model=model, tx=state.tx),
                {"loss": loss.float(), "grad_norm": grad_norm})

    return step


def build_eval_step(
    forward_metrics: Callable[[nn.Module, Any], dict],
    mesh=None,
) -> Callable[[nn.Module, Any], dict]:
    """``eval_step(model, batch) -> metrics``, without gradients (a
    sharded model's forward issues its mesh's collectives)."""
    if mesh is not None:
        check_mesh(mesh, world=pd.world_size(pd.default_group()))

    @torch.no_grad()
    def eval_step(model, batch):
        return forward_metrics(model, batch)

    return eval_step
