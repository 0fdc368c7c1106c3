"""Parameter and activation sharding rules for the 6-axis mesh.

Counterpart of ``kubeflow_tpu/parallel/sharding.py``.  Models tag each
weight with *logical axis names* (the reference's ``nn.Partitioned``
boxes; here ``param.logical_axes``, set where ``models/layers.py``
creates the parameter, None where the reference boxes nothing, as for
conv kernels) and this module maps logical names -> mesh axes:

  logical axis     mesh axes        meaning
  ---------------  ---------------  ----------------------------------------
  "batch"          ("dp", "fsdp")   data parallel over dp and fsdp
  "seq"            "sp"             sequence/context parallelism
  "embed"          "fsdp"           d_model dim: sharded for ZeRO-3 weights
  "heads"          "tp"             attention heads: tensor parallel
  "kv"             None             per-head dim: replicated
  "mlp"            "tp"             FFN hidden dim: tensor parallel
  "vocab"          "tp"             embedding/LM-head vocab dim
  "stage"          "pp"             stacked pipeline layers
  "expert"         "ep"             MoE experts

``placements`` turns a parameter's spec into DTensor placements on the
mesh (``Shard(d)`` on the mesh dim a rule names, ``Replicate()``
elsewhere): the part the reference's ``logical_to_sharding`` plays.
``shard_model`` then replaces every parameter with the block of it those
placements give this rank, and records the split on it
(``param.fsdp_split``, ``param.tp_split``, ``param.ep_split``).  Where
the reference leaves the rest to GSPMD, the port's layers act on those
records:

- **fsdp** (ZeRO-3, the "embed" dim): a layer reads a parameter through
  ``layers.weight``, which all-gathers the block over the fsdp group in
  the compute dtype (``distributed.gather_cast``); its backward
  reduce-scatters the float32 gradient, summed.  Under remat the gather
  runs again in the recomputed forward, as FSDP's reshard after forward.
- **tp** (Megatron column/row parallelism on "heads", "mlp", "vocab"): a
  kernel whose output dims are tp-split computes this rank's heads or
  FFN columns from a replicated input (``copy_to_group``: identity, the
  gradient all-reduced); a kernel whose input dim is tp-split produces
  a partial sum that ``reduce_from_group`` all-reduces.  The embedding
  looks up this rank's vocabulary rows and all-reduces; the tied head
  gives vocab-split logits, which the losses reduce with a
  vocabulary-parallel cross entropy.  Attention runs K1/K2/K3 on plain
  tensors holding this rank's ``Hq / tp`` query and ``Hkv / tp`` KV
  heads.  An int8 ``QTensor`` (``models/quant_tensor.py``, quantized
  whole by ``serving/quant.py``) splits as its kernel: ``q`` by the
  kernel's spec, ``scale`` by ``scale_spec`` of it (its size-1
  contraction axis whole).
- **ep** (the stacked expert weights' leading "expert" dim): each ep
  rank holds ``E / ep`` experts of ``w_in``/``w_out`` and runs only
  those on the rows it shares with its ep group (``models/moe.py``;
  under tp at its ``f / tp`` columns of them, the "mlp" dim); with fsdp
  the "embed" dim is split too and gathered on read.  The
  router's "expert" dim is its output (the logits every rank routes
  its tokens by), so the router stays whole on every ep rank.

Every activation is this rank's rows (under sp, of its sequence chunk,
which ``parallel/train_step.py`` cuts and ring attention joins) with its
hidden dim whole, so the reference's
``constrain``/``replicate``/``shard_activation`` pins have nothing to
pin here: they return their input.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from kubeflow_tpu_torch.models.quant_tensor import QTensor
from kubeflow_tpu_torch.parallel import distributed as pd
from kubeflow_tpu_torch.parallel.mesh import DATA_AXES, MeshAxes
from kubeflow_tpu_torch.training.optim import sum_of_squares


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Mapping from logical axis names to mesh axis (or axes, or None)."""

    rules: tuple[tuple[str, Any], ...] = (
        ("batch", ("dp", "fsdp")),
        ("seq", "sp"),
        ("embed", "fsdp"),
        ("heads", "tp"),
        ("kv", None),
        ("mlp", "tp"),
        ("vocab", "tp"),
        ("stage", "pp"),
        ("expert", "ep"),
    )

    def mesh_axes(self, logical_name: str | None):
        if logical_name is None:
            return None
        for name, axes in self.rules:
            if name == logical_name:
                return axes
        return None

    def spec(self, logical_axes: tuple[str | None, ...]) -> tuple:
        """The PartitionSpec of the reference, as a tuple: per dim, the
        mesh axis (or axes, or None) it is split over."""
        return tuple(self.mesh_axes(a) for a in logical_axes)

    def replace(self, **kv: Any) -> "ShardingRules":
        rules = tuple((k, kv[k]) if k in kv else (k, v) for k, v in self.rules)
        extra = tuple((k, v) for k, v in kv.items()
                      if k not in dict(self.rules))
        return ShardingRules(rules + extra)


DEFAULT_RULES = ShardingRules()


def batch_spec(rules: ShardingRules = DEFAULT_RULES, *,
               seq_sharded: bool = False) -> tuple:
    """Spec for a [batch, seq, ...] input batch."""
    if seq_sharded:
        return (rules.mesh_axes("batch"), rules.mesh_axes("seq"))
    return (rules.mesh_axes("batch"),)


def logical_axes(p: torch.Tensor) -> tuple | None:
    """The logical names a parameter carries (None: the reference boxes
    nothing there, and it stays replicated)."""
    return getattr(p, "logical_axes", None)


def shard_params_specs(model: nn.Module,
                       rules: ShardingRules = DEFAULT_RULES) -> dict:
    """``{weight name: spec}`` of every parameter and int8 ``QTensor``
    (``named_weights``); a weight without logical names is replicated
    (``()``, the reference's ``P()``)."""
    return {name: (rules.spec(logical_axes(w)) if logical_axes(w) else ())
            for _, _, name, w in named_weights(model)}


def placements(spec: tuple) -> tuple:
    """DTensor placements of ``spec`` over the mesh dims (``MeshAxes``
    order): ``Shard(d)`` on every mesh dim that dim ``d``'s rule names,
    ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(MeshAxes)
    for d, axes in enumerate(spec):
        for axis in (axes,) if isinstance(axes, str) else (axes or ()):
            out[MeshAxes.index(axis)] = Shard(d)
    return tuple(out)


def constrain(x: torch.Tensor, spec: tuple) -> torch.Tensor:
    """The reference's layout pin; the port's layouts are explicit (module
    docstring), so ``x`` is returned as it is."""
    return x


def replicate(x: torch.Tensor) -> torch.Tensor:
    """Constrain to fully replicated: ``x`` as it is (see ``constrain``)."""
    return x


def shard_activation(x: torch.Tensor,
                     rules: ShardingRules = DEFAULT_RULES) -> torch.Tensor:
    """The canonical [batch, seq, hidden] layout: ``x`` as it is (see
    ``constrain``)."""
    return x


@dataclasses.dataclass(frozen=True)
class Split:
    """How a parameter's block sits in the full tensor along one mesh
    axis: dim ``dim`` cut into ``size`` equal blocks over ``group``, this
    rank holding block ``index``."""

    axis: str
    group: Any
    dim: int
    size: int
    index: int


_SHARDED_AXES = ("fsdp", "tp", "ep")


def _replicated_over(axis: str, dim: int, ndim: int) -> bool:
    """Whether ``axis`` leaves a weight of ``ndim`` dims whole although a
    rule names its dim ``dim``: ep splits only a stacked expert weight's
    leading dim (the router's "expert" dim is its logits; module
    docstring)."""
    return axis == "ep" and (dim != 0 or ndim < 2)


def scale_spec(spec: tuple, scale_shape: tuple) -> tuple:
    """The spec of an int8 ``QTensor``'s scale from its kernel's
    ``spec``: the scale broadcasts over the quantization axis (size 1),
    which stays whole whatever the kernel's spec says (the reference's
    ``serving/sharded.py::_scale_spec``)."""
    return tuple(None if scale_shape[i] == 1 else ax
                 for i, ax in enumerate(spec))


def named_weights(model: nn.Module):
    """``(module, leaf, name, weight)`` for every parameter and every int8
    ``QTensor`` (a matmul weight ``serving/quant.py`` swapped) of
    ``model``; a ``QTensor`` is named as the parameter it replaced."""
    for mod_name, module in model.named_modules():
        if isinstance(module, QTensor):
            continue
        for leaf, w in (*module.named_parameters(recurse=False),
                        *((n, m) for n, m in module.named_children()
                          if isinstance(m, QTensor))):
            yield module, leaf, f"{mod_name}.{leaf}".lstrip("."), w


def _cuts(full: str, axes: tuple, spec: tuple, shape: tuple, mesh,
          int8: bool = False) -> dict:
    """``{axis: (dim, size)}`` of the mesh axes that split a tensor of
    ``shape`` under ``spec``; refuses a dim that does not divide by its
    axis, naming weight ``full`` and its logical dim, and an ``int8``
    weight split over fsdp (a serving weight splits over tp and ep
    only)."""
    cuts = {}
    for axis, place in zip(MeshAxes, placements(spec)):
        size = mesh.shape[axis]
        if (size == 1 or not place.is_shard()
                or _replicated_over(axis, place.dim, len(shape))):
            continue
        if axis not in _SHARDED_AXES:
            raise NotImplementedError(
                f"{axis}={size} shards parameters only in a later "
                "slice of the port")
        if int8 and axis not in ("tp", "ep"):
            raise NotImplementedError(
                f"{full}: an int8 weight is split over tp and ep only, "
                f"not {axis}={size}")
        if shape[place.dim] % size:
            raise ValueError(
                f"{full}: its {axes[place.dim]!r} dim of "
                f"{shape[place.dim]} does not divide by {axis}={size}")
        cuts[axis] = (place.dim, size)
    return cuts


def _plan(model: nn.Module, mesh, rules: ShardingRules,
          names=None) -> list:
    """``(module, leaf, weight, cuts)`` for every weight (of ``names``, or
    all) that some axis splits (``_cuts``); a ``QTensor``'s cuts are a
    pair, its ``q``'s by the kernel's spec and its ``scale``'s by
    ``scale_spec`` of it."""
    plan = []
    for module, leaf, full, w in named_weights(model):
        axes = logical_axes(w)
        if not axes or (names is not None and full not in names):
            continue
        spec = rules.spec(axes)
        if isinstance(w, QTensor):
            cuts = (_cuts(full, axes, spec, tuple(w.q.shape), mesh, True),
                    _cuts(full, axes, scale_spec(spec, tuple(w.scale.shape)),
                          tuple(w.scale.shape), mesh, True))
            if cuts[0]:
                plan.append((module, leaf, w, cuts))
            continue
        cuts = _cuts(full, axes, spec, tuple(w.shape), mesh)
        if cuts:
            plan.append((module, leaf, w, cuts))
    return plan


def _block(t: torch.Tensor, cuts: dict, mesh) -> tuple[torch.Tensor, dict]:
    """This rank's block of ``t`` (a copy) under ``cuts``, and the
    ``Split`` of each axis."""
    block, splits = t.detach(), {}
    for axis, (d, size) in cuts.items():
        n, index = t.shape[d] // size, mesh.coordinate(axis)
        block = block.narrow(d, index * n, n)
        splits[axis] = Split(axis, mesh.group(axis), d, size, index)
    return block.clone(), splits


def shard_model(model: nn.Module, mesh,
                rules: ShardingRules = DEFAULT_RULES,
                names=None) -> nn.Module:
    """Replace every weight of ``model`` (of ``names``, or all) by this
    rank's block of it under ``rules`` on ``mesh`` (in place; returns the
    model).  A dim that does not divide by its axis is refused before
    anything is split, naming the weight and its logical dim: a Llama
    whose ``num_kv_heads`` does not divide by tp among them.  An int8
    ``QTensor`` is split as its kernel: ``q`` by the kernel's spec,
    ``scale`` by ``scale_spec`` of it, and the record (``q``'s) goes on
    the ``QTensor``."""
    for module, leaf, w, cuts in _plan(model, mesh, rules, names):
        if isinstance(w, QTensor):
            q, splits = _block(w.q, cuts[0], mesh)
            w.q, w.scale = q, _block(w.scale, cuts[1], mesh)[0]
            new = w
        else:
            block, splits = _block(w, cuts, mesh)
            new = nn.Parameter(block, requires_grad=w.requires_grad)
            new.logical_axes = w.logical_axes
            module._parameters[leaf] = new
        new.fsdp_split = splits.get("fsdp")
        new.tp_split = splits.get("tp")
        new.ep_split = splits.get("ep")
        # the group over the model axes that split it: a dropless MoE
        # layer sums its partial outputs over this one group
        model_axes = [a for a in ("tp", "ep") if a in splits]
        new.model_group = mesh.group(*model_axes) if model_axes else None
    return model


def _splits(p: torch.Tensor) -> list[Split]:
    return [s for s in (getattr(p, f"{axis}_split", None)
                        for axis in _SHARDED_AXES) if s is not None]


def is_sharded(model: nn.Module) -> bool:
    return any(_splits(p) for p in model.parameters())


def local_block(full: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """This rank's block of ``full`` for parameter ``p`` (the inverse of
    ``gather_to_host``)."""
    for s in _splits(p):
        n = full.shape[s.dim] // s.size
        full = full.narrow(s.dim, s.index * n, n)
    return full


def gather_to_host(t: torch.Tensor, p: torch.Tensor) -> torch.Tensor | None:
    """The full tensor of which ``t`` is this rank's block (split like
    parameter ``p``), on the host of the ranks at coordinate 0 on every
    axis ``p`` is split over (rank 0 among them), None on the others (a
    collective).  Each rank copies its block to the host, and each
    split's blocks are gathered to its group's first rank, so only those
    ranks receive: a save moves each tensor once, not to every rank, and
    no rank holds a whole tensor on its card."""
    import torch.distributed as dist

    x = t.detach().cpu().contiguous()
    for s in _splits(p):
        blocks = ([torch.empty_like(x) for _ in range(s.size)]
                  if s.index == 0 else None)
        dist.gather(x, blocks, group=s.group, group_dst=0)
        if s.index != 0:
            # every rank of this rank's groups on the later axes shares
            # this coordinate, so none of them gathers further
            return None
        x = torch.cat(blocks, s.dim)
    return x


def full_state_dict(model: nn.Module) -> dict[str, torch.Tensor | None]:
    """``model.state_dict()`` with every parameter gathered whole on the
    host (``gather_to_host``; a collective): on rank 0, the same keys and
    shapes as the unsharded model's; elsewhere None where the rank is no
    gather's root."""
    params = dict(model.named_parameters())
    return {k: gather_to_host(v, params.get(k, v))
            for k, v in model.state_dict().items()}


def load_full_state_dict(model: nn.Module, state: dict) -> None:
    """Load an unsharded state dict (on any device) into a sharded (or
    unsharded) model: each rank copies its block."""
    params = dict(model.named_parameters())
    model.load_state_dict({k: (local_block(v, params[k]) if k in params
                               else v) for k, v in state.items()})


def grad_groups(params: list[torch.Tensor], mesh, *,
                seq_split: bool = False) -> list:
    """Per parameter, the group its gradient is still to be summed over
    after the backward: the data axes it is not fsdp-split over (the
    gather's reduce-scatter summed the fsdp axis), and sp when
    ``seq_split`` (each sp rank's gradient is its sequence chunk's
    share; a MoE block's too, since it routes by the sequence split), or
    None.  Never tp or ep: their ranks hold the same rows, so a tp- or
    ep-split block's gradient is whole on the rank that holds it (a MoE
    block's experts included: ``models/moe.py`` sums their ungated
    outputs) and every other gradient is the same on every rank of the
    group."""
    sp = ("sp",) if seq_split else ()
    over_dp = mesh.group("dp", *sp)
    over_data = mesh.group(*DATA_AXES, *sp)
    return [over_dp if getattr(p, "fsdp_split", None) is not None
            else over_data for p in params]


def _counted(p: torch.Tensor, coords: dict) -> bool:
    """Whether this rank counts its block of ``p``: it is the one replica
    whose coordinate is 0 on every mesh axis ``p`` is not split over."""
    split = {s.axis for s in _splits(p)}
    return all(coords[a] == 0 for a in MeshAxes if a not in split)


def global_norm(grads: list[torch.Tensor], params: list[torch.Tensor],
                mesh) -> torch.Tensor:
    """The norm of the whole gradient from each rank's blocks: a block is
    counted by the one rank of its replicas whose coordinate is 0 on
    every mesh axis the parameter is not split over, the squares summed
    over the mesh.  On the CPU the sums are float64, as
    ``training/optim.py::global_norm`` keeps them."""
    coords = {a: mesh.coordinate(a) for a in MeshAxes}
    mine = [g for g, p in zip(grads, params) if _counted(p, coords)]
    total = [sum_of_squares(mine, grads[0].device)]
    if mesh.size > 1:
        pd.all_reduce_sum(total, pd.default_group())
    return total[0].sqrt().float()


def whole_squares(squares: torch.Tensor, params: list[torch.Tensor],
                  mesh) -> torch.Tensor:
    """Per parameter of ``params``, sums of squares ``[n, k]`` taken over
    this rank's block of it (lamb's ``|p|^2`` and ``|u|^2``) made the
    whole tensor's: each block counted on the rank ``global_norm``
    counts it on, summed over the mesh in one all-reduce."""
    coords = {a: mesh.coordinate(a) for a in MeshAxes}
    counted = torch.tensor([_counted(p, coords) for p in params],
                           dtype=squares.dtype, device=squares.device)
    out = squares * counted[:, None]
    if mesh.size > 1:
        pd.all_reduce_sum([out], pd.default_group())
    return out
