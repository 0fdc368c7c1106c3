"""Slice topologies and the 6-axis mesh over a gang's ranks.

Counterpart of ``kubeflow_tpu/parallel/mesh.py``.  The reference lays a
slice's chips out as a ``jax.sharding.Mesh`` with the axes
``('dp', 'fsdp', 'tp', 'sp', 'pp', 'ep')``; here the "devices" are the
ranks of the gang that ``parallel/distributed.initialize_from_env``
joined (one rank per card, or several ranks sharing one), laid out in
order (rank ``r`` sits at the row-major position ``r`` of the axis
sizes) and carried by ``torch.distributed.device_mesh.init_device_mesh``
with ``mesh_dim_names=MeshAxes``.  dp is outermost, so a multi-slice
gang's ranks are blocked slice by slice and only dp crosses slices.

``make_mesh`` returns a ``Mesh``: its rank layout, and the torch
``DeviceMesh`` whose groups carry each axis's collectives when the mesh
spans this process's gang.  One process with no group gets a mesh of
size 1 and no groups; a mesh over more ranks than this process's gang is
a layout only (shape and ranks, no groups), which a train step refuses.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any

import numpy as np

# Canonical mesh axis names, outermost first (the reference's order).
MeshAxes = ("dp", "fsdp", "tp", "sp", "pp", "ep")
# the axes a batch's rows are split over: every rank of one (dp, fsdp)
# coordinate holds the same rows
DATA_AXES = ("dp", "fsdp")
# the sets of axes a step sums over together, each with a group of its
# own: the data axes, and under sequence parallelism the data axes and
# sp (a replicated gradient, and a MoE layer's aux probabilities) or dp
# and sp (an fsdp-split one); tp and ep together hold the partial sums
# of a MoE layer (``models/moe.py``).  Each set in ``MeshAxes`` order
JOINT_AXES = (DATA_AXES, ("dp", "fsdp", "sp"), ("dp", "sp"), ("tp", "ep"))


@dataclasses.dataclass(frozen=True)
class SliceTopology:
    """A TPU slice type the platform can schedule (one gang unit)."""

    name: str           # accelerator type string, e.g. "v5e-32"
    chips: int          # total chips in the slice
    hosts: int          # number of TPU-VM hosts (gang size for the controller)
    chips_per_host: int
    hbm_gb_per_chip: int
    bf16_tflops_per_chip: float
    resource_name: str  # k8s-style extended resource (replaces nvidia.com/gpu)

    @property
    def chips_per_host_check(self) -> bool:
        return self.hosts * self.chips_per_host == self.chips


def _v5e(chips: int) -> SliceTopology:
    hosts = max(1, chips // 4)
    return SliceTopology(
        name=f"v5e-{chips}", chips=chips, hosts=hosts,
        chips_per_host=chips if chips < 4 else 4,
        hbm_gb_per_chip=16, bf16_tflops_per_chip=197.0,
        resource_name="cloud-tpu.google.com/v5e")


def _v4(chips: int) -> SliceTopology:
    return SliceTopology(
        name=f"v4-{chips * 2}", chips=chips, hosts=max(1, chips // 4),
        chips_per_host=min(chips, 4), hbm_gb_per_chip=32,
        bf16_tflops_per_chip=275.0,
        resource_name="cloud-tpu.google.com/v4")


TOPOLOGIES: dict[str, SliceTopology] = {}
for _c in (1, 4, 8, 16, 32, 64, 128, 256):
    _t = _v5e(_c)
    TOPOLOGIES[_t.name] = _t
for _c in (4, 8, 16, 32, 64):
    _t = _v4(_c)
    TOPOLOGIES[_t.name] = _t


def factor_axes(
    n_devices: int,
    dp: int = -1,
    fsdp: int = 1,
    tp: int = 1,
    sp: int = 1,
    pp: int = 1,
    ep: int = 1,
) -> tuple[int, ...]:
    """Resolve axis sizes; at most one axis may be -1 (inferred)."""
    sizes = [dp, fsdp, tp, sp, pp, ep]
    n_infer = sum(1 for s in sizes if s == -1)
    if n_infer > 1:
        raise ValueError("at most one mesh axis may be -1")
    if n_infer == 1:
        known = math.prod(s for s in sizes if s != -1)
        if n_devices % known != 0:
            raise ValueError(
                f"{n_devices} devices not divisible by fixed axes product {known}")
        sizes[sizes.index(-1)] = n_devices // known
    if math.prod(sizes) != n_devices:
        raise ValueError(
            f"mesh axes {dict(zip(MeshAxes, sizes))} do not multiply to "
            f"{n_devices} devices")
    return tuple(sizes)  # type: ignore[return-value]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """The 6-axis mesh: ``ranks`` (an int array shaped by the axis sizes,
    in ``MeshAxes`` order), this process's ``rank``, and the torch
    ``DeviceMesh`` when the mesh spans the joined gang (else None)."""

    ranks: np.ndarray
    rank: int = 0
    device_mesh: Any = None
    _groups: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(MeshAxes, self.ranks.shape))

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def axis_size(self, *axes: str) -> int:
        return math.prod(self.shape[a] for a in axes)

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        where = np.argwhere(self.ranks == self.rank)[0]
        return int(where[MeshAxes.index(axis)])

    def data_index(self) -> tuple[int, int]:
        """(index, count) of this rank's rows of a global batch: its
        position on the flattened data axes, of ``dp * fsdp``."""
        return (self.coordinate("dp") * self.shape["fsdp"]
                + self.coordinate("fsdp"), self.axis_size(*DATA_AXES))

    def group(self, *axes: str):
        """The process group over ``axes`` that holds this rank (None when
        they span one rank)."""
        key = tuple(a for a in MeshAxes if a in axes and self.shape[a] > 1)
        if not key:
            return None
        if self.device_mesh is None:
            raise RuntimeError(
                f"mesh {self.shape} spans no process group of this process")
        return self._groups[key]


def _world() -> tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _axis_groups(device_mesh, ranks: np.ndarray, rank: int) -> dict:
    """This rank's group for every axis (the DeviceMesh's) and for each
    set of ``JOINT_AXES`` that spans more than one of them (a subgroup per
    coordinate of the other axes: every rank creates every subgroup, as
    ``new_group`` requires)."""
    import torch.distributed as dist

    groups = {(a,): device_mesh.get_group(a) for a in MeshAxes
              if ranks.shape[MeshAxes.index(a)] > 1}
    for axes in JOINT_AXES:
        key = tuple(a for a in axes if ranks.shape[MeshAxes.index(a)] > 1)
        if len(key) < 2 or key in groups:
            continue
        # ranks of one coordinate of the other axes, over every one of key's
        dims = [MeshAxes.index(a) for a in key]
        rest = [i for i in range(len(MeshAxes)) if i not in dims]
        planes = ranks.transpose(rest + dims).reshape(
            -1, math.prod(ranks.shape[i] for i in dims))
        mine, _ = dist.new_subgroups_by_enumeration(
            [[int(r) for r in plane] for plane in planes])
        groups[key] = mine
    return groups


def make_mesh(
    n_devices: int | None = None,
    *,
    dp: int = -1,
    fsdp: int = 1,
    tp: int = 1,
    sp: int = 1,
    pp: int = 1,
    ep: int = 1,
    num_slices: int | None = None,
    device_type: str = "cuda",
) -> Mesh:
    """Build the standard 6-axis mesh over the gang's ranks (default: all
    of them; 1 without a process group).

    ``num_slices > 1`` (default: the ``JAXJOB_NUM_SLICES`` env injected by
    the JAXJob controller) requires dp to be a multiple of it: the ranks
    are blocked in order, so dp's leading blocks are the slices and only
    data-parallel reduction crosses them.  ``device_type`` is the
    DeviceMesh's ("cuda" or "cpu": where the ranks' tensors live)."""
    if num_slices is None:
        num_slices = int(os.environ.get("JAXJOB_NUM_SLICES", "1") or 1)
    world, rank = _world()
    if n_devices is None:
        n_devices = world
    shape = factor_axes(n_devices, dp=dp, fsdp=fsdp, tp=tp, sp=sp, pp=pp,
                        ep=ep)
    if num_slices > 1 and shape[0] % num_slices:
        raise ValueError(
            f"dp={shape[0]} must be a multiple of num_slices "
            f"({num_slices}): only the dp axis may cross DCN")
    ranks = np.arange(n_devices).reshape(shape)
    if n_devices == 1 or n_devices != world:
        return Mesh(ranks, rank=rank if n_devices == world else 0)
    from torch.distributed.device_mesh import init_device_mesh

    device_mesh = init_device_mesh(device_type, shape,
                                   mesh_dim_names=MeshAxes)
    return Mesh(ranks, rank=rank, device_mesh=device_mesh,
                _groups=_axis_groups(device_mesh, ranks, rank))


def best_mesh_for(topology: SliceTopology | str, *, model_parallel: int = 1,
                  seq_parallel: int = 1) -> tuple[int, ...]:
    """Heuristic axis assignment for a slice: tp/sp as requested, the rest fsdp
    within a slice, dp across slices (handled by the multi-slice layer)."""
    if isinstance(topology, str):
        topology = TOPOLOGIES[topology]
    chips = topology.chips
    if chips % (model_parallel * seq_parallel) != 0:
        raise ValueError("model_parallel*seq_parallel must divide slice size")
    fsdp = chips // (model_parallel * seq_parallel)
    return (1, fsdp, model_parallel, seq_parallel)
