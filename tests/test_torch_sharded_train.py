"""Sharded training of the PyTorch port: fsdp and tp gangs on the CPU.

One gloo gang per mesh (``spawn_local_gang``): ``fsdp=2`` and ``tp=2``
(2 processes), ``fsdp=2, tp=2`` and ``dp=2, fsdp=2`` (4 processes; the
latter HSDP: blocks split over fsdp, replicated over dp).  Each runs every model
in turn, five steps, through ``build_train_step`` on the mesh, the model
split by ``shard_model``: the tiny Llama (4 query heads over 2 KV heads
of 16, 2 layers), ``bert_tiny`` (float32; random mask weights, so every
data rank's loss weight differs) and ``mnist_mlp``, all from the
reference's flax init (``models/convert.py``).  Each data rank reads its
``NpzDataset`` rows of every global batch of 16; the ranks of one tp
group read the same rows.

Each gang is held to one process at the same global batch (the
rank-major concatenation of the data ranks' rows): every step's loss and
grad_norm within 1e-5 relative, every rank's loss bitwise equal, and
every parameter gathered whole within 1e-5 of its max |p|.  The
optimizer is momentum sgd, linear in the gradients (``test_torch_dp.py``
says why not adam).  The 4-process Llama is also held to the reference's
``build_train_step`` on ``make_mesh(4, dp=1, fsdp=2, tp=2)`` (the
conftest's host devices) from the same weights and batches.

The 4-process gang also checks checkpoints across layouts: its Llama
checkpoint holds the gathered tensors (the keys and shapes of an
unsharded run's file) and restores bitwise into one process, and a
one-process checkpoint restores into it as each rank's blocks, bitwise.
The tp and 4-process gangs run the worker entrypoint (``python -m
kubeflow_tpu_torch.training``'s ``main``) with ``tp``/``fsdp`` in its
``JAXJOB_TRAINER_CONFIG``: its final loss within 1e-5 of one process's.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from kubeflow_tpu.models import registry as jreg
from kubeflow_tpu.parallel import make_mesh
from kubeflow_tpu.parallel import train_step as jts
from kubeflow_tpu.parallel.sharding import unbox_params
from kubeflow_tpu.training import optim as joptim
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models import registry as treg
from kubeflow_tpu_torch.parallel import distributed as pd
from kubeflow_tpu_torch.parallel import train_step as tts
from kubeflow_tpu_torch.training import data as tdata
from kubeflow_tpu_torch.training import optim as toptim
from kubeflow_tpu_torch.training.checkpoint import CheckpointManager
from kubeflow_tpu_torch.training.trainer import Trainer, TrainerConfig

STEPS, GB, SEQ = 5, 16, 16
OPT = {"name": "sgd", "learning_rate": 1e-2, "momentum": 0.9}
CASES = {  # case: (registry model, model config, grad_accum)
    "llama_tiny": ("llama", {"size": "tiny", "dtype": "float32"}, 1),
    "bert_tiny": ("bert", {"size": "tiny", "dtype": "float32"}, 1),
    "mnist_mlp": ("mnist_mlp", {}, 1),
    # 4 micro-batches of the rank-major global batch: under fsdp=2 each
    # data rank holds two of them and runs a stand-in for the other two
    "llama_accum4": ("llama", {"size": "tiny", "dtype": "float32"}, 4),
}
MESHES = {  # mesh: (dp, fsdp, tp)
    "fsdp2": (1, 2, 1), "tp2": (1, 1, 2), "fsdp2_tp2": (1, 2, 2),
    # HSDP: blocks split over fsdp, replicated over dp, rows over both
    "dp2_fsdp2": (2, 2, 1),
}
TRAINER = {"model": "llama", "model_config": {"size": "tiny",
                                              "dtype": "float32"},
           "optimizer": OPT, "global_batch": 8, "steps": 3, "log_every": 1}

WORKER = r"""
import contextlib, io, json, os, torch
from kubeflow_tpu_torch.models import registry
from kubeflow_tpu_torch.parallel import distributed as pd
from kubeflow_tpu_torch.parallel import sharding as sh
from kubeflow_tpu_torch.parallel import train_step as ts
from kubeflow_tpu_torch.parallel.mesh import make_mesh
from kubeflow_tpu_torch.training.checkpoint import CheckpointManager
from kubeflow_tpu_torch.training.data import NpzDataset, to_device
from kubeflow_tpu_torch.training.optim import make_optimizer

torch.set_num_threads(1)
rdv = pd.initialize_from_env(device="cpu")
spec = json.loads(os.environ["GANG_SPEC"])
world = pd.default_group()
mesh = make_mesh(dp=spec["dp"], fsdp=spec["fsdp"], tp=spec["tp"],
                 device_type="cpu")
index, count = mesh.data_index()
tag = spec["tag"]

def build(case):
    entry = registry.get(case["model"])
    model = entry.make_model(device="cpu", **case["config"])
    model.load_state_dict(torch.load(case["weights"], weights_only=True))
    sh.shard_model(model, mesh)
    return entry, ts.init_train_state(model, make_optimizer(spec["opt"]))

out = {"rdv": rdv, "trails": {}, "data": [index, count]}
for name, case in spec["cases"].items():
    entry, state = build(case)
    step = ts.build_train_step(entry.forward_loss, state.tx, mesh,
                               grad_accum=case["accum"],
                               loss_weight=entry.loss_weight)
    it = NpzDataset(case["data"], spec["global_batch"], seed=0,
                    process_index=index, process_count=count).iter_from(0)
    trail = []
    for _ in range(spec["steps"]):
        state, m = step(state, to_device(next(it), torch.device("cpu")))
        trail.append([m["loss"].item(), m["grad_norm"].item()])
    out["trails"][name] = trail
    full = sh.full_state_dict(state.model)
    if pd.rank_of(world) == 0:
        torch.save(full, os.path.join(spec["out"], f"{name}-{tag}.pt"))
    if name == "llama_tiny" and spec["ckpt"]:
        CheckpointManager(os.path.join(spec["out"], f"ckpt-{tag}"),
                          group=world).save(spec["steps"], state)
        # the other way round: a one-process checkpoint, this layout
        _, back = build(case)
        CheckpointManager(spec["ckpt"], group=world).restore(back)
        blob = torch.load(os.path.join(spec["ckpt"], "ckpt-1.pt"),
                          weights_only=True)
        params = dict(back.model.named_parameters())
        same = [torch.equal(p, sh.local_block(blob["model"][k], p))
                for k, p in params.items()]
        for key, moments in blob["optimizer"]["moments"].items():
            same += [torch.equal(m, sh.local_block(w, p)) for m, w, p in zip(
                back.tx.moments[key], moments, params.values())]
        out["restored_blocks_equal"] = all(same) and back.step == 1
        out["split"] = sum(p.tp_split is not None or p.fsdp_split is not None
                           for p in params.values())
if spec["trainer"]:
    from kubeflow_tpu_torch.training.__main__ import main

    os.environ["JAXJOB_TRAINER_CONFIG"] = json.dumps(spec["trainer"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(["--device", "cpu"])
    out["trainer"] = json.loads(buf.getvalue().strip().splitlines()[-1])
print(json.dumps(out))
"""


def numpy_rows(model: str, n: int) -> dict:
    rng = np.random.default_rng(12)
    if model == "mnist_mlp":
        return {"image": rng.standard_normal((n, 28, 28, 1)).astype(
                    np.float32),
                "label": rng.integers(0, 10, (n,)).astype(np.int32)}
    if model == "bert":
        return {"input_ids": rng.integers(0, 1024, (n, SEQ)).astype(np.int32),
                "labels": rng.integers(0, 1024, (n, SEQ)).astype(np.int32),
                "weights": (rng.random((n, SEQ)) < 0.3).astype(np.float32)}
    ids = rng.integers(0, 512, (n, SEQ + 1)).astype(np.int32)
    return {"input_ids": ids[:, :-1].copy(), "labels": ids[:, 1:].copy()}


def reference_init(name: str):
    model, cfg, _ = CASES[name]
    module = jreg.get(model).make_model(**cfg)
    example = (jnp.zeros((1, 28, 28, 1)) if model == "mnist_mlp"
               else jnp.zeros((1, SEQ), jnp.int32))
    variables = jax.jit(module.init)(jax.random.PRNGKey(0), example)
    return module, jax.tree.map(np.asarray, unbox_params(variables["params"]))


def port_model(name: str, state: dict):
    model, cfg, _ = CASES[name]
    m = treg.get(model).make_model(device="cpu", **cfg)
    m.load_state_dict(state)
    return m


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Per case: the reference's weights as the port's state dict (a
    file), the npz rows, the flax params; a one-process Llama checkpoint
    at step 1; the Trainer's npz file."""
    root = tmp_path_factory.mktemp("sharded")
    cases, params = {}, {}
    for name, (model, cfg, accum) in CASES.items():
        module, p = reference_init(name)
        config = treg.get(model).make_model(device="cpu", **cfg).config
        torch.save(convert.from_jax_params(p, config), root / f"{name}.pt")
        np.savez(root / f"{name}.npz", **numpy_rows(model, GB * STEPS))
        cases[name] = {"model": model, "config": cfg, "accum": accum,
                       "weights": str(root / f"{name}.pt"),
                       "data": str(root / f"{name}.npz")}
        params[name] = (module, p)
    # a one-process checkpoint after one step (moments non-zero)
    model = port_model("llama_tiny", torch.load(root / "llama_tiny.pt"))
    state = tts.init_train_state(model, toptim.make_optimizer(OPT))
    step = tts.build_train_step(treg.get("llama").forward_loss, state.tx)
    state, _ = step(state, rank_major_batches(cases, "llama_tiny", 1)[0])
    CheckpointManager(str(root / "ckpt-one")).save(1, state)
    np.savez(root / "trainer.npz", **numpy_rows("llama", 32))
    return {"root": root, "cases": cases, "params": params, "gangs": {}}


def gang(setup, mesh: str) -> list[dict]:
    if mesh not in setup["gangs"]:
        dp, fsdp, tp = MESHES[mesh]
        trainer = None
        if tp > 1:
            trainer = {**TRAINER, "fsdp": fsdp, "tp": tp,
                       "data_path": str(setup["root"] / "trainer.npz")}
        spec = {"cases": setup["cases"], "opt": OPT, "global_batch": GB,
                "steps": STEPS, "out": str(setup["root"]), "tag": mesh,
                "dp": dp, "fsdp": fsdp, "tp": tp, "trainer": trainer,
                "ckpt": (str(setup["root"] / "ckpt-one")
                         if mesh == "fsdp2_tp2" else None)}
        setup["gangs"][mesh] = pd.spawn_local_gang(
            WORKER, dp * fsdp * tp, timeout=240.0,
            extra_env={"GANG_SPEC": json.dumps(spec)})
    return setup["gangs"][mesh]


def rank_major_batches(cases, name: str, data_ranks: int) -> list[dict]:
    its = [tdata.NpzDataset(cases[name]["data"], GB, seed=0,
                            process_index=r,
                            process_count=data_ranks).iter_from(0)
           for r in range(data_ranks)]
    out = []
    for _ in range(STEPS):
        shards = [next(it) for it in its]
        out.append(tdata.to_device(
            {k: np.concatenate([s[k] for s in shards]) for k in shards[0]},
            torch.device("cpu")))
    return out


def one_process(setup, name: str, data_ranks: int):
    model = port_model(name, torch.load(setup["cases"][name]["weights"],
                                        weights_only=True))
    state = tts.init_train_state(model, toptim.make_optimizer(OPT))
    step = tts.build_train_step(treg.get(CASES[name][0]).forward_loss,
                                state.tx, grad_accum=CASES[name][2])
    trail = []
    for nb in rank_major_batches(setup["cases"], name, data_ranks):
        state, m = step(state, nb)
        trail.append((m["loss"].item(), m["grad_norm"].item()))
    return trail, model.state_dict()


def assert_trails_close(got, want, tol=1e-5):
    for (gl, gn), (wl, wn) in zip(got, want, strict=True):
        assert abs(gl - wl) <= tol * abs(wl), (got, want)
        assert abs(gn - wn) <= tol * abs(wn), (got, want)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_gang_trains_what_one_process_trains(setup, mesh, name):
    outs = gang(setup, mesh)
    dp, fsdp, tp = MESHES[mesh]
    trails = [o["trails"][name] for o in outs]
    for r, o in enumerate(outs):
        assert o["rdv"]["process_id"] == r and o["rdv"]["backend"] == "gloo"
        assert o["data"] == [r // tp, dp * fsdp]     # tp ranks share rows
        assert trails[r] == trails[0], "ranks disagree"     # bitwise
    want, final = one_process(setup, name, dp * fsdp)
    assert_trails_close(trails[0], want)
    got = torch.load(setup["root"] / f"{name}-{mesh}.pt", weights_only=True)
    assert got.keys() == final.keys()
    for key, p in final.items():
        err = (got[key] - p).abs().max() / p.abs().max().clamp_min(1e-6)
        assert err <= 1e-5, key


def reference_trail(setup, name: str) -> list[tuple[float, float]]:
    """The reference's ``build_train_step`` on a (dp 1, fsdp 2, tp 2)
    mesh, fed the 4-process gang's rank-major global batches."""
    module, params = setup["params"][name]
    entry = jreg.get(CASES[name][0])
    mesh = make_mesh(4, dp=1, fsdp=2, tp=2)
    tx = joptim.make_optimizer(OPT)
    state, shardings = jts.init_train_state(
        module, tx, jax.random.PRNGKey(0),
        (jnp.zeros((4, SEQ), jnp.int32),), mesh)
    jparams = jax.tree.map(jnp.asarray, params)
    state = state.replace(params=jparams, opt_state=tx.init(jparams))
    batches = rank_major_batches(setup["cases"], name, 2)
    bs = {k: NamedSharding(mesh, P(("dp", "fsdp"))) for k in batches[0]}
    step = jts.build_train_step(
        lambda p, b: entry.forward_loss(module, p, b), tx, mesh, shardings,
        bs, donate=False)
    trail = []
    with mesh:
        for nb in batches:
            state, m = step(state, jax.device_put(
                {k: jnp.asarray(v.numpy()) for k, v in nb.items()}, bs))
            trail.append((float(m["loss"]), float(m["grad_norm"])))
    return trail


def test_four_process_llama_matches_the_reference_sharded_step(setup):
    outs = gang(setup, "fsdp2_tp2")
    assert_trails_close(outs[0]["trails"]["llama_tiny"],
                        reference_trail(setup, "llama_tiny"))


def test_checkpoints_cross_layouts_bitwise(setup):
    outs = gang(setup, "fsdp2_tp2")
    root = setup["root"]
    # written by the 4-process gang: an unsharded run's file
    blob = torch.load(root / "ckpt-fsdp2_tp2" / f"ckpt-{STEPS}.pt",
                      weights_only=True)
    one = torch.load(root / "ckpt-one" / "ckpt-1.pt", weights_only=True)
    assert {k: v.shape for k, v in blob["model"].items()} == {
        k: v.shape for k, v in one["model"].items()}
    assert [m.shape for m in blob["optimizer"]["moments"]["trace"]] == [
        m.shape for m in one["optimizer"]["moments"]["trace"]]
    gathered = torch.load(root / "llama_tiny-fsdp2_tp2.pt",
                          weights_only=True)
    model = port_model("llama_tiny", torch.load(root / "llama_tiny.pt"))
    state = tts.init_train_state(model, toptim.make_optimizer(OPT))
    state = CheckpointManager(str(root / "ckpt-fsdp2_tp2")).restore(state)
    assert state.step == STEPS
    for key, p in model.state_dict().items():
        assert torch.equal(p, gathered[key]), key
    # and a one-process checkpoint restored as every rank's blocks
    assert all(o["restored_blocks_equal"] for o in outs)
    assert all(o["split"] > 0 for o in outs)


@pytest.mark.parametrize("mesh", ["tp2", "fsdp2_tp2"])
def test_worker_entrypoint_trains_a_sharded_mesh(setup, mesh):
    outs = gang(setup, mesh)
    cfg = {**TRAINER, "data_path": str(setup["root"] / "trainer.npz")}
    want = Trainer(TrainerConfig.from_dict(cfg), device="cpu").run()
    for o in outs:
        assert o["trainer"]["steps"] == TRAINER["steps"]
        assert o["trainer"]["final_loss"] == outs[0]["trainer"]["final_loss"]
        got = o["trainer"]["final_loss"]
        assert abs(got - want["final_loss"]) <= 1e-5 * abs(
            want["final_loss"])


def fake_world(monkeypatch, world: int):
    """This process as rank 0 of ``world`` (no collective is reached)."""
    monkeypatch.setattr(pd, "default_group", lambda: "group")
    monkeypatch.setattr(pd, "world_size", lambda g: 1 if g is None else world)
    monkeypatch.setattr(pd, "rank_of", lambda g: 0)


def test_an_elastic_membership_under_fsdp_or_tp_is_refused_by_name(
        monkeypatch):
    from kubeflow_tpu_torch.elastic import Membership
    from kubeflow_tpu_torch.elastic.runtime import ScriptedMembership

    fake_world(monkeypatch, 2)
    members = ScriptedMembership(0, {0: Membership(0, (0, 1))})
    for axis in ("fsdp", "tp"):
        cfg = TrainerConfig.from_dict({**TRAINER, axis: 2})
        with pytest.raises(NotImplementedError, match=f"{axis}=2.*resize"):
            Trainer(cfg, membership=members, device="cpu").run()


def test_moe_under_tensor_parallelism_is_refused_by_name(monkeypatch):
    from kubeflow_tpu_torch.parallel import mesh as tmesh

    fake_world(monkeypatch, 2)
    layout = tmesh.Mesh(tmesh.make_mesh(2, dp=1, tp=2).ranks)
    model = treg.get("llama").make_model(device="cpu", size="tiny",
                                         moe_experts=2)
    state = tts.init_train_state(model, toptim.make_optimizer(OPT))
    step = tts.build_train_step(treg.get("llama").forward_loss, state.tx,
                                layout, loss_weight=lambda b: 1)
    with pytest.raises(NotImplementedError, match="moe_experts"):
        step(state, {})
