"""Tensor-parallel sharding for the serving path.

Counterpart of ``kubeflow_tpu/serving/sharded.py``.  Megatron-style
tensor parallelism over the attention-head, FFN-hidden and vocabulary
dims: each rank holds 1/tp of every matmul weight and 1/tp of the KV
cache's heads, and the layers issue the two all-reduces a block needs
from the splits they carry (``parallel/sharding.py``).  One rank per card
means a tp predictor is always a gang here, so the reference's mesh over
a process's local devices is the gang's mesh (``parallel/mesh.py``).

The training rules are adapted to serving: batch, seq and embed stay
local (no fsdp: the weights are read-only, so gathering them on every
use would add latency for no memory beyond what tp saves).  An int8
``QTensor`` (``serving/quant.py``) splits like its kernel: ``q`` takes
the kernel's spec, ``scale`` the same spec with its broadcast (size-1)
axis whole (``_scale_spec``).  The tensor is quantized whole first: its
scale is a max over the whole contraction axis, which tp splits in the
row-parallel kernels.

"Placing" a weight keeps this rank's block of it and records the split
on it, as ``parallel/sharding.py::shard_model`` does; that function is
the one rule, and ``place_params`` / ``shard_params`` apply it under
``SERVING_RULES``.
"""

from __future__ import annotations

from torch import nn

from kubeflow_tpu_torch.parallel import distributed as pd
from kubeflow_tpu_torch.parallel.mesh import Mesh, make_mesh
from kubeflow_tpu_torch.parallel.sharding import (DEFAULT_RULES,
                                                  scale_spec, shard_model,
                                                  shard_params_specs)

# batch/seq/embed stay local in a serving mesh: only head/mlp/vocab dims
# split over tp (Megatron layout)
SERVING_RULES = DEFAULT_RULES.replace(batch=None, seq=None, embed=None)

# KV cache rows are [batch_slots, seq, kv_heads, head_dim]: heads over tp
CACHE_SPEC = (None, None, "tp", None)


def check_experts(cfg, ep: int) -> None:
    """The reference's refusal of an ep that does not split the model's
    experts: a dense model (ep would only replicate it) or an expert
    count ep does not divide."""
    experts = getattr(cfg, "moe_experts", 0)
    if ep > 1 and (not experts or experts % ep):
        raise ValueError(f"ep={ep} needs a MoE model whose moe_experts "
                         f"divides by it (got moe_experts={experts})")


def cache_block(shape: tuple, mesh: Mesh | None,
                spec: tuple = CACHE_SPEC) -> tuple:
    """The shape of this rank's block of a whole cache leaf of ``shape``
    under ``spec`` (default ``CACHE_SPEC``: KV heads over tp): each dim
    divided by the size of the mesh axis ``spec`` names there; a dim that
    does not divide is refused.  ``mesh`` None: ``shape``."""
    if mesh is None:
        return tuple(shape)
    out = []
    for n, axis in zip(shape, spec):
        size = mesh.shape[axis] if axis else 1
        if n % size:
            raise ValueError(f"a cache dim of {n} not divisible by "
                             f"{axis}={size}")
        out.append(n // size)
    return tuple(out)


def serving_mesh(tp: int, ep: int = 1, *, device_type: str = "cuda") -> Mesh:
    """A tp (x ep) mesh with dp = fsdp = sp = 1 over the gang's first
    ``tp * ep`` ranks (one rank per card); a gang with fewer ranks is
    refused with the reference's message."""
    n = tp * ep
    have = pd.world_size(pd.default_group())
    if have < n:
        raise ValueError(f"tp={tp} x ep={ep} needs {n} devices, have {have}")
    return make_mesh(n, dp=1, fsdp=1, tp=tp, sp=1, ep=ep,
                     device_type=device_type)


def param_specs(model: nn.Module) -> dict[str, tuple]:
    """Each weight's spec under ``SERVING_RULES`` by name (an int8
    ``QTensor`` under its kernel's name): the reference's spec tree."""
    return shard_params_specs(model, SERVING_RULES)


# a QTensor scale broadcasts over the quantization axis (size 1): that
# axis stays unsharded whatever the kernel spec says.  The reference's name
# for the rule ``shard_model`` (so ``place_params``) cuts a scale by
_scale_spec = scale_spec


def place_params(model: nn.Module, mesh: Mesh, names=None) -> nn.Module:
    """Keep this rank's block of every weight of ``model`` (of ``names``,
    or all) under ``SERVING_RULES`` on ``mesh``, recording the split on
    it; a ``QTensor``'s ``q`` by its kernel's spec and ``scale`` by
    ``_scale_spec`` (``shard_model``, the one rule).  In place; returns
    the model."""
    return shard_model(model, mesh, SERVING_RULES, names)


def shard_params(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Every weight of ``model`` placed on ``mesh`` (``place_params``)."""
    return place_params(model, mesh)


def shard_cache(cache: dict, mesh: Mesh, num_kv_heads: int) -> dict:
    """The KV cache with this rank's ``num_kv_heads / tp`` heads in each
    4-d leaf: a leaf of every head is cut to the rank's block (a copy), a
    leaf that holds the rank's heads is kept; index tensors pass.  Each
    rank holds the cache for exactly its own heads: the memory win that
    makes long contexts fit."""
    tp = mesh.shape["tp"]
    if num_kv_heads % tp != 0:
        raise ValueError(
            f"num_kv_heads={num_kv_heads} not divisible by tp={tp}")
    local = num_kv_heads // tp
    start = mesh.coordinate("tp") * local
    d = CACHE_SPEC.index("tp")

    def place(x):
        if getattr(x, "ndim", 0) != 4 or x.shape[d] == local:
            return x
        if x.shape[d] != num_kv_heads:
            raise ValueError(f"a cache leaf of {x.shape[d]} KV heads is "
                             f"neither {num_kv_heads} nor {local}")
        return x.narrow(d, start, local).clone()

    return {"layers": [{k: place(v) for k, v in layer.items()}
                       for layer in cache["layers"]]}
