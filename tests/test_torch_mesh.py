"""The port's mesh and sharding rules against the reference's.

Counterpart of ``tests/test_sharding_mesh.py``: ``factor_axes``'
inference and errors, the topology catalogue, multi-slice blocking and
its refusal, the ``JAXJOB_NUM_SLICES`` default and ``best_mesh_for``,
each held to the reference's function on the same arguments (the
reference lays out the conftest's 8 host devices; the port, ranks).
Then the rules: every logical name's spec and batch spec equal to the
reference's, the rules-to-placements table, and every registry model's
parameters carrying the reference's ``nn.Partitioned`` names leaf for
leaf (None where the reference boxes nothing).  No gang is needed: a
mesh over more ranks than this process's (none) is a layout, which is
what these tests read; ``shard_model`` refuses a KV-head count that
does not divide by tp before it splits anything.
"""

import re

import flax.linen as fnn
import jax
import pytest
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from kubeflow_tpu.models import registry as jreg
from kubeflow_tpu.parallel import mesh as jmesh
from kubeflow_tpu.parallel import sharding as jsh
from kubeflow_tpu_torch.models import registry as treg
from kubeflow_tpu_torch.parallel import mesh as tmesh
from kubeflow_tpu_torch.parallel import sharding as tsh

AXES = [dict(dp=-1, fsdp=2, tp=2, sp=1), dict(dp=2, fsdp=-1, tp=1),
        dict(dp=1, fsdp=2, tp=2, sp=2), dict(dp=8), dict(fsdp=8, dp=1),
        dict(dp=-1, pp=2, ep=2)]


@pytest.mark.parametrize("axes", AXES)
def test_factor_axes_matches_the_reference(axes):
    assert tmesh.factor_axes(8, **axes) == jmesh.factor_axes(8, **axes)


def test_factor_axes_inference():
    assert tmesh.factor_axes(8, dp=-1, fsdp=2, tp=2, sp=1) == (
        2, 2, 2, 1, 1, 1)
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.factor_axes(8, dp=-1, fsdp=3)
    with pytest.raises(ValueError, match="multiply"):
        tmesh.factor_axes(8, dp=3, fsdp=1, tp=1, sp=1)
    with pytest.raises(ValueError, match="at most one"):
        tmesh.factor_axes(8, dp=-1, fsdp=-1)


@pytest.mark.parametrize("bad", [dict(dp=-1, fsdp=3), dict(dp=3),
                                 dict(dp=-1, tp=-1)])
def test_factor_axes_errors_are_the_references(bad):
    with pytest.raises(ValueError) as want:
        jmesh.factor_axes(8, **bad)
    with pytest.raises(ValueError) as got:
        tmesh.factor_axes(8, **bad)
    assert str(got.value) == str(want.value)


def test_topology_catalogue():
    t = tmesh.TOPOLOGIES["v5e-32"]
    assert t.hosts == 8 and t.chips_per_host == 4
    assert t.resource_name == "cloud-tpu.google.com/v5e"
    assert list(tmesh.TOPOLOGIES) == list(jmesh.TOPOLOGIES)
    for name, ref in jmesh.TOPOLOGIES.items():
        port = tmesh.TOPOLOGIES[name]
        fields = ("name", "chips", "hosts", "chips_per_host",
                  "hbm_gb_per_chip", "bf16_tflops_per_chip", "resource_name",
                  "chips_per_host_check")
        assert ([getattr(port, f) for f in fields]
                == [getattr(ref, f) for f in fields]), name


@pytest.mark.parametrize("topology,mp,seq", [
    ("v5e-8", 1, 1), ("v5e-32", 2, 1), ("v4-16", 2, 2), ("v5e-256", 8, 4)])
def test_best_mesh_for_matches_the_reference(topology, mp, seq):
    assert (tmesh.best_mesh_for(topology, model_parallel=mp,
                                seq_parallel=seq)
            == jmesh.best_mesh_for(topology, model_parallel=mp,
                                   seq_parallel=seq))
    with pytest.raises(ValueError, match="must divide"):
        tmesh.best_mesh_for("v5e-8", model_parallel=3)


def test_multislice_mesh_dp_blocks_align_with_slices():
    # 8 ranks as 2 "slices": dp=4 -> leading dp blocks of size 2 per slice
    mesh = tmesh.make_mesh(8, dp=4, fsdp=2, tp=1, sp=1, num_slices=2)
    assert mesh.shape == {"dp": 4, "fsdp": 2, "tp": 1, "sp": 1, "pp": 1,
                          "ep": 1}
    flat = [int(r) for r in mesh.ranks.reshape(-1)]
    assert flat == sorted(flat)  # ordered blocking: slice 0 then slice 1
    ref = jmesh.make_mesh(8, dp=4, fsdp=2, tp=1, sp=1, num_slices=2)
    assert flat == [d.id for d in ref.devices.reshape(-1)]
    assert mesh.device_mesh is None      # a layout: no gang of 8 here


def test_multislice_mesh_rejects_dp_not_divisible():
    with pytest.raises(ValueError, match="multiple of num_slices"):
        tmesh.make_mesh(8, dp=2, fsdp=4, tp=1, sp=1, num_slices=4)


def test_num_slices_env_default(monkeypatch):
    monkeypatch.setenv("JAXJOB_NUM_SLICES", "2")
    mesh = tmesh.make_mesh(8, dp=2, fsdp=4, tp=1, sp=1)
    assert mesh.shape["dp"] == 2
    monkeypatch.setenv("JAXJOB_NUM_SLICES", "4")
    with pytest.raises(ValueError, match="multiple of num_slices"):
        tmesh.make_mesh(8, dp=2, fsdp=4, tp=1, sp=1)


def test_one_process_gets_a_mesh_of_size_one():
    mesh = tmesh.make_mesh()
    assert mesh.size == 1 and mesh.device_mesh is None
    assert mesh.shape == dict.fromkeys(tmesh.MeshAxes, 1)
    assert mesh.group("dp", "fsdp") is None and mesh.data_index() == (0, 1)
    with pytest.raises(ValueError, match="multiply"):
        tmesh.make_mesh(dp=1, fsdp=2)


def test_layout_coordinates_and_data_index():
    mesh = tmesh.make_mesh(8, dp=2, fsdp=2, tp=2)
    # rank 5 = (dp 1, fsdp 0, tp 1): the third of four data ranks
    layout = tmesh.Mesh(mesh.ranks, rank=5)
    assert [layout.coordinate(a) for a in ("dp", "fsdp", "tp")] == [1, 0, 1]
    assert layout.data_index() == (2, 4)
    with pytest.raises(RuntimeError, match="no process group"):
        layout.group("tp")


LOGICAL = [("embed", "heads", "kv"), ("heads", "embed"), ("embed", "mlp"),
           ("mlp", "embed"), ("vocab", "embed"), ("embed",), ("vocab",),
           (None, "embed"), ("embed", None), ("mlp", None),
           ("embed", "expert"), ("expert", "embed", "mlp"), ("batch", "seq"),
           ("stage", "embed")]


@pytest.mark.parametrize("names", LOGICAL, ids=str)
def test_rules_give_the_references_specs(names):
    assert tsh.DEFAULT_RULES.spec(names) == tuple(
        jsh.DEFAULT_RULES.spec(names))
    rules = ("embed", None)
    assert (tsh.DEFAULT_RULES.replace(embed=None).spec(rules)
            == tuple(jsh.DEFAULT_RULES.replace(embed=None).spec(rules)))


def test_batch_spec_is_the_references():
    assert tsh.batch_spec() == tuple(jsh.batch_spec())
    assert tsh.batch_spec(seq_sharded=True) == tuple(
        jsh.batch_spec(seq_sharded=True))


def test_rules_to_placements_table():
    R = Replicate()
    table = {  # logical names: placements over (dp, fsdp, tp, sp, pp, ep)
        ("embed", "heads", "kv"): (R, Shard(0), Shard(1), R, R, R),
        ("heads", "embed"): (R, Shard(1), Shard(0), R, R, R),
        ("vocab", "embed"): (R, Shard(1), Shard(0), R, R, R),
        ("embed",): (R, Shard(0), R, R, R, R),
        ("mlp", None): (R, R, Shard(0), R, R, R),
        ("batch", "seq"): (Shard(0), Shard(0), R, Shard(1), R, R),
        ("expert", "embed", "mlp"): (R, Shard(1), Shard(2), R, R, Shard(0)),
    }
    for names, want in table.items():
        assert tsh.placements(tsh.DEFAULT_RULES.spec(names)) == want, names
    assert tsh.placements(()) == (R,) * 6


def _reference_names(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, fnn.Partitioned):
            out[path] = tuple(val.names)
        elif hasattr(val, "items"):
            out.update(_reference_names(val, path))
        else:
            out[path] = None
    return out


MODELS = {  # registry model: config (tiny sizes)
    "mnist_mlp": ("mnist_mlp", {}),
    "cifar_convnet": ("cifar_convnet", {}),
    "resnet50": ("resnet50", {"stage_sizes": [1, 1, 1, 1], "width": 8,
                              "num_classes": 10}),
    "bert": ("bert", {"size": "tiny"}),
    "llama": ("llama", {"size": "tiny"}),
    "llama_moe": ("llama", {"size": "tiny", "moe_experts": 2}),
}


@pytest.mark.parametrize("case", list(MODELS))
def test_every_parameter_carries_the_references_logical_names(case):
    name, cfg = MODELS[case]
    entry = jreg.get(name)
    module = entry.make_model(**cfg)
    rng = jax.random.PRNGKey(0)
    boxed = jax.eval_shape(
        lambda r: module.init(r, *entry.make_inputs(2, r, module)), rng)
    want = {re.sub(r"^layer_(\d+)/", r"layers.\1/", path).replace("/", "."):
            names for path, names in _reference_names(boxed["params"]).items()}
    port = treg.get(name).make_model(device="cpu", **cfg)
    got = {k: tsh.logical_axes(p) for k, p in port.named_parameters()}
    assert got == want
    # and the specs the reference's shard_params_specs derives from them
    ref_specs = jax.tree_util.tree_map(
        tuple, jsh.shard_params_specs(boxed["params"]),
        is_leaf=lambda x: isinstance(x, P))
    want_specs = {
        re.sub(r"^layer_(\d+)/", r"layers.\1/", path).replace("/", "."): spec
        for path, spec in _flat_specs(ref_specs).items()}
    assert tsh.shard_params_specs(port) == want_specs


def _flat_specs(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, tuple):
            out[path] = val
        else:
            out.update(_flat_specs(val, path))
    return out


def test_kv_heads_that_do_not_divide_by_tp_are_refused_by_name():
    # Gemma-width MQA: one KV head cannot be split over tp = 2, as the
    # reference cannot shard it either; nothing is split
    from kubeflow_tpu_torch.models import llama

    model = llama.LlamaModel(llama.LlamaConfig(
        vocab_size=512, hidden_size=64, num_layers=1, num_heads=2,
        num_kv_heads=1, intermediate_size=128), device="cpu")
    before = dict(model.named_parameters())
    layout = tmesh.Mesh(tmesh.make_mesh(2, dp=1, tp=2).ranks, rank=0)
    with pytest.raises(ValueError, match=r"attention\.k\.kernel: its "
                       r"'heads' dim of 1 does not divide by tp=2"):
        tsh.shard_model(model, layout)
    assert dict(model.named_parameters()) == before


def test_pp_and_ep_shard_parameters_in_a_later_slice():
    """ep shards parameters now: each rank holds its half of the stacked
    experts, the router stays whole (its "expert" dim is the logits every
    rank routes by).  pp still shards them only in a later slice (the
    stacked "stage" layout is ``parallel/pipeline.py``'s)."""
    import torch

    from kubeflow_tpu_torch.models import layers as tl_layers

    model = treg.get("llama").make_model(device="cpu", size="tiny",
                                         moe_experts=2).init_weights(0)
    full = {k: v.clone() for k, v in model.state_dict().items()}
    # rank 1 of a two-rank ep layout, its group a stand-in (no
    # collective is reached)
    layout = tmesh.Mesh(tmesh.make_mesh(2, dp=1, ep=2).ranks, rank=1,
                        device_mesh=object(), _groups={("ep",): "ep"})
    tsh.shard_model(model, layout)
    for name, p in model.named_parameters():
        if name.endswith(("moe.w_in", "moe.w_out")):
            assert p.ep_split.index == 1 and p.shape[0] == 1
            assert torch.equal(p, full[name][1:])
            assert torch.equal(tsh.local_block(full[name], p), p)
        else:
            assert getattr(p, "ep_split", None) is None, name
            assert torch.equal(p, full[name])
    stacked = torch.nn.Module()
    stacked.w = tl_layers.param((2, 4), torch.float32, "cpu",
                                ("stage", "embed"))
    with pytest.raises(NotImplementedError, match="pp=2"):
        tsh.shard_model(stacked, tmesh.Mesh(
            tmesh.make_mesh(2, dp=1, pp=2).ranks))


def test_the_activation_pins_return_their_input():
    import torch

    x = torch.ones(2, 3, 4)
    assert tsh.shard_activation(x) is x and tsh.replicate(x) is x
    assert tsh.constrain(x, (("dp", "fsdp"),)) is x
