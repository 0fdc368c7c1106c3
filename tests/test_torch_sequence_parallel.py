"""Sequence-parallel training of the PyTorch port (sp), on the CPU.

One 4-process gloo gang (``spawn_local_gang``) runs, each on a mesh of
its own:

- ``bert_tiny`` (float32, remat on, from the reference's flax init) at
  (tp 2, sp 2) on a batch of 4 x 64: the step's loss and gradients (each
  gathered whole) and grad_norm, held to the reference's plain
  ``value_and_grad`` of the same loss on the same weights and batch (the
  counterpart of ``test_ring_wired_into_sp_train_path``, there within
  1e-4 on the loss and 1e-3 of max |g|; here 1e-5 relative on the loss
  and grad_norm, 1e-5 of max |g| per gradient, 1e-5 absolute for the
  key biases, whose gradients are 0 analytically);
- the tiny Llama (4 query heads over 2 KV heads, causal, RoPE at the
  chunks' global positions, remat) for 3 adamw steps at (dp 2, sp 2),
  (fsdp 2, sp 2) and (tp 2, sp 2), global batch 8 x 16 from an
  ``.npz``: every step's loss
  and grad_norm within 1e-5 relative of one process at the same global
  batch, the ranks' trails bitwise equal;
- the Trainer at (dp 2, sp 2) on that ``.npz``: its final loss within
  1e-5 of one process's Trainer, with a spy on ``make_ring_attention``
  counting the dispatches (the counterpart of
  ``test_trainer_sp_config_uses_ring``).

Then, in one process: a sequence that does not divide by sp, MoE under
sp and an elastic membership under sp are refused by name.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeflow_tpu.models import bert as jbert
from kubeflow_tpu.parallel.sharding import unbox_params
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models import registry as treg
from kubeflow_tpu_torch.parallel import distributed as pd
from kubeflow_tpu_torch.parallel import mesh as tmesh
from kubeflow_tpu_torch.parallel import train_step as tts
from kubeflow_tpu_torch.training import data as tdata
from kubeflow_tpu_torch.training import optim as toptim
from kubeflow_tpu_torch.training.trainer import Trainer, TrainerConfig

BERT_B, BERT_S = 4, 64
GB, SEQ, STEPS = 8, 16, 3
OPT = {"name": "adamw", "learning_rate": 1e-3}
LLAMA = {"size": "tiny", "dtype": "float32"}
LAYOUTS = {"dp2_sp2": (2, 1, 1), "fsdp2_sp2": (1, 2, 1),
           "tp2_sp2": (1, 1, 2)}                   # layout: (dp, fsdp, tp)
TRAINER = {"model": "llama", "model_config": LLAMA, "optimizer": OPT,
           "global_batch": GB, "steps": STEPS, "log_every": 1}

WORKER = r"""
import contextlib, io, json, os
import numpy as np
import torch
from kubeflow_tpu_torch.models import registry
from kubeflow_tpu_torch.ops import ring_attention
from kubeflow_tpu_torch.parallel import distributed as pd
from kubeflow_tpu_torch.parallel import sharding as sh
from kubeflow_tpu_torch.parallel import train_step as ts
from kubeflow_tpu_torch.parallel.mesh import make_mesh
from kubeflow_tpu_torch.training.data import NpzDataset, to_device
from kubeflow_tpu_torch.training.optim import make_optimizer

torch.set_num_threads(1)
pd.initialize_from_env(device="cpu")
spec = json.loads(os.environ["SP_SPEC"])
rank = pd.rank_of(pd.default_group())
out = {"trails": {}}

# BERT at (tp 2, sp 2): the step's loss and gradients, gathered whole
mesh = make_mesh(dp=1, tp=2, sp=2, device_type="cpu")
bert = registry.get("bert")
model = bert.make_model(device="cpu", size="tiny", dtype="float32")
model.load_state_dict(torch.load(spec["bert_weights"], weights_only=True))
sh.shard_model(model, mesh)
model.requires_grad_(True)
params = list(model.parameters())
batch = {k: torch.tensor(v) for k, v in np.load(spec["bert_batch"]).items()}
loss, grads = ts._mesh_steps(bert.forward_loss, bert.loss_weight, model,
                             params, batch, 1, mesh, bert.sequence_keys)
norm = sh.global_norm(grads, params, mesh)
full = {name: sh.gather_to_host(g, p)
        for (name, p), g in zip(model.named_parameters(), grads)}
if rank == 0:
    torch.save(full, spec["bert_grads"])
out["bert"] = [loss.item(), norm.item()]

# the tiny Llama, 3 adamw steps per layout
llama = registry.get("llama")
for name, (dp, fsdp, tp) in spec["layouts"].items():
    mesh = make_mesh(dp=dp, fsdp=fsdp, tp=tp, sp=2, device_type="cpu")
    index, count = mesh.data_index()
    model = llama.make_model(device="cpu", **spec["llama"]).init_weights(0)
    sh.shard_model(model, mesh)
    state = ts.init_train_state(model, make_optimizer(spec["opt"]))
    step = ts.build_train_step(llama.forward_loss, state.tx, mesh,
                               loss_weight=llama.loss_weight,
                               sequence_keys=llama.sequence_keys)
    it = NpzDataset(spec["data"], spec["global_batch"], seed=0,
                    process_index=index, process_count=count).iter_from(0)
    trail = []
    for _ in range(spec["steps"]):
        state, m = step(state, to_device(next(it), torch.device("cpu")))
        trail.append([m["loss"].item(), m["grad_norm"].item()])
    out["trails"][name] = trail

# the Trainer at (dp 2, sp 2), the ring's dispatches counted
calls = []
made = ring_attention.make_ring_attention
ring_attention.make_ring_attention = lambda *a, **kw: (
    calls.append(kw.get("axis_name")), made(*a, **kw))[1]
from kubeflow_tpu_torch.training.__main__ import main

os.environ["JAXJOB_TRAINER_CONFIG"] = json.dumps(spec["trainer"])
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    main(["--device", "cpu"])
out["trainer"] = json.loads(buf.getvalue().strip().splitlines()[-1])
out["ring_calls"] = calls
print(json.dumps(out))
"""


def bert_reference():
    """(flax params as numpy, batch as numpy, loss, grads) of the
    reference's plain BERT-tiny at 4 x 64 (float32, no ring)."""
    cfg = jbert.bert_tiny(dtype="float32", remat=False)
    model = jbert.BertModel(cfg)
    rng = np.random.default_rng(5)
    batch = {
        "input_ids": rng.integers(0, 1024, (BERT_B, BERT_S)).astype(
            np.int32),
        "labels": rng.integers(0, 1024, (BERT_B, BERT_S)).astype(np.int32),
        "weights": (rng.random((BERT_B, BERT_S)) < 0.3).astype(np.float32)}
    ids = jnp.asarray(batch["input_ids"])
    params = unbox_params(
        jax.jit(model.init)(jax.random.PRNGKey(0), ids)["params"])

    def loss_fn(p):
        out = model.apply({"params": p}, ids)
        return jbert.mlm_loss(out, jnp.asarray(batch["labels"]),
                              jnp.asarray(batch["weights"]))

    loss, grads = jax.value_and_grad(loss_fn)(params)
    as_np = lambda t: jax.tree.map(np.asarray, t)   # noqa: E731
    return as_np(params), batch, float(loss), as_np(grads), float(
        optax.global_norm(grads))


def llama_rows(n: int) -> dict:
    rng = np.random.default_rng(9)
    ids = rng.integers(0, 512, (n, SEQ + 1)).astype(np.int32)
    return {"input_ids": ids[:, :-1].copy(), "labels": ids[:, 1:].copy()}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("sp")
    params, batch, loss, grads, norm = bert_reference()
    config = treg.get("bert").make_model(device="cpu", size="tiny",
                                         dtype="float32").config
    torch.save(convert.from_jax_params(params, config), root / "bert.pt")
    np.savez(root / "bert_batch.npz", **batch)
    np.savez(root / "llama.npz", **llama_rows(GB * STEPS))
    spec = {"bert_weights": str(root / "bert.pt"),
            "bert_batch": str(root / "bert_batch.npz"),
            "bert_grads": str(root / "bert_grads.pt"),
            "layouts": LAYOUTS, "llama": LLAMA, "opt": OPT,
            "data": str(root / "llama.npz"), "global_batch": GB,
            "steps": STEPS,
            "trainer": {**TRAINER, "dp": 2, "sp": 2,
                        "data_path": str(root / "llama.npz")}}
    outs = pd.spawn_local_gang(WORKER, 4, timeout=150.0,
                               extra_env={"SP_SPEC": json.dumps(spec)})
    return {"root": root, "outs": outs, "spec": spec,
            "bert": (loss, convert.from_jax_params(grads, config), norm)}


def test_bert_under_tp_and_sp_matches_the_reference_gradients(setup):
    loss, grads, norm = setup["bert"]
    for o in setup["outs"]:
        got_loss, got_norm = o["bert"]
        assert abs(got_loss - loss) <= 1e-5 * abs(loss)
        assert abs(got_norm - norm) <= 1e-5 * norm
    got = torch.load(setup["root"] / "bert_grads.pt", weights_only=True)
    assert got.keys() == grads.keys()
    for key, want in grads.items():
        # a key bias's gradient is 0 analytically (the softmax ignores a
        # shift shared by every key): rounding noise on both sides (~1e-10),
        # held absolutely; the pooler's and NSP head's are 0 on both
        scale = (1.0 if key.endswith("key.bias")
                 else want.abs().max().clamp_min(1e-12))
        err = (got[key] - want).abs().max() / scale
        assert err <= 1e-5, (key, float(err))


def one_process_trail(data: str) -> list:
    """Loss and grad_norm per step of one process on the global batches
    (each data rank's ``NpzDataset`` rows, rank-major, are its rows)."""
    entry = treg.get("llama")
    model = entry.make_model(device="cpu", **LLAMA).init_weights(0)
    state = tts.init_train_state(model, toptim.make_optimizer(OPT))
    step = tts.build_train_step(entry.forward_loss, state.tx)
    it = tdata.NpzDataset(data, GB, seed=0).iter_from(0)
    trail = []
    for _ in range(STEPS):
        state, m = step(state, tdata.to_device(next(it),
                                               torch.device("cpu")))
        trail.append((m["loss"].item(), m["grad_norm"].item()))
    return trail


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_llama_under_sp_trains_what_one_process_trains(setup, layout):
    trails = [o["trails"][layout] for o in setup["outs"]]
    assert all(t == trails[0] for t in trails), "ranks disagree"
    want = one_process_trail(setup["spec"]["data"])
    for (gl, gn), (wl, wn) in zip(trails[0], want, strict=True):
        assert abs(gl - wl) <= 1e-5 * abs(wl), (trails[0], want)
        assert abs(gn - wn) <= 1e-5 * abs(wn), (trails[0], want)


def test_trainer_under_sp_dispatches_the_ring(setup):
    want = Trainer(TrainerConfig.from_dict(
        {**TRAINER, "data_path": setup["spec"]["trainer"]["data_path"]}),
        device="cpu").run()
    for o in setup["outs"]:
        # 2 layers, each its forward and its remat'd recompute, per step
        assert o["ring_calls"] == ["sp"] * (2 * 2 * STEPS)
        got = o["trainer"]["final_loss"]
        assert o["trainer"]["steps"] == STEPS
        assert abs(got - want["final_loss"]) <= 1e-5 * abs(
            want["final_loss"])


def fake_world(monkeypatch, world: int):
    """This process as rank 0 of ``world`` (no collective is reached)."""
    monkeypatch.setattr(pd, "default_group", lambda: "group")
    monkeypatch.setattr(pd, "world_size", lambda g: 1 if g is None else world)
    monkeypatch.setattr(pd, "rank_of", lambda g: 0)


def sp_layout(sp: int):
    """A mesh of ``sp`` ranks on sp, this process rank 0, whose group is a
    stand-in."""
    return tmesh.Mesh(np.arange(sp).reshape(1, 1, 1, sp, 1, 1),
                      device_mesh=object(), _groups={("sp",): "sp"})


def test_a_sequence_that_does_not_divide_by_sp_is_refused(monkeypatch):
    fake_world(monkeypatch, 2)
    entry = treg.get("llama")
    model = entry.make_model(device="cpu", **LLAMA).init_weights(0)
    state = tts.init_train_state(model, toptim.make_optimizer(OPT))
    step = tts.build_train_step(entry.forward_loss, state.tx, sp_layout(2),
                                loss_weight=entry.loss_weight,
                                sequence_keys=entry.sequence_keys)
    batch = entry.make_batch(2, torch.Generator().manual_seed(0), model,
                             seq_len=7)
    with pytest.raises(ValueError, match="sequence length 7 does not "
                       "divide by sp=2"):
        step(state, batch)


def test_moe_under_sp_is_refused_by_name(monkeypatch):
    """No longer refused (``test_torch_moe_tp_sp.py`` trains it): the step
    binds its sequence split beside the data group, and the MoE block
    gathers its per-row expert counts over the sp group by it.  One
    process stands in for rank 0 (the ring's exchange returns its own
    chunk; the gather stops the step)."""

    class Gathered(Exception):
        pass

    seen = []

    def gather(x, dim, group):
        seen.append((group, pd.sequence_split(), tuple(x.shape)))
        raise Gathered

    fake_world(monkeypatch, 2)
    monkeypatch.setattr(pd, "all_reduce_sum", lambda tensors, group: None)
    monkeypatch.setattr(pd, "ppermute", lambda tensors, group, shift=1: [
        t.clone() for t in tensors])
    monkeypatch.setattr(pd, "all_gather_cat", gather)
    entry = treg.get("llama")
    model = entry.make_model(device="cpu", moe_experts=2, **LLAMA)
    state = tts.init_train_state(model, toptim.make_optimizer(OPT))
    step = tts.build_train_step(entry.forward_loss, state.tx, sp_layout(2),
                                loss_weight=entry.loss_weight,
                                sequence_keys=entry.sequence_keys)
    batch = entry.make_batch(2, torch.Generator().manual_seed(0), model,
                             seq_len=8)
    with pytest.raises(Gathered):
        step(state, batch)
    # [1, rows, 2, E]: this chunk's counts per row, over the sp group
    assert seen == [("sp", pd.SequenceSplit("sp", 0, "sp"), (1, 2, 2, 2))]


def test_an_elastic_membership_under_sp_is_refused_by_name(monkeypatch):
    from kubeflow_tpu_torch.elastic import Membership
    from kubeflow_tpu_torch.elastic.runtime import ScriptedMembership

    fake_world(monkeypatch, 2)
    members = ScriptedMembership(0, {0: Membership(0, (0, 1))})
    cfg = TrainerConfig.from_dict({**TRAINER, "sp": 2})
    with pytest.raises(NotImplementedError, match="sp=2.*resize"):
        Trainer(cfg, membership=members, device="cpu").run()
