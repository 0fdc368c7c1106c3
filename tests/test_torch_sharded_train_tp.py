"""Sharded training of the PyTorch port: the tp=2 and fsdp=2 x tp=2 gloo
gangs on the CPU, the 4-process Llama against the reference's sharded
step, checkpoints across layouts, and the worker entrypoint on a sharded
mesh.

``test_torch_sharded_train.py`` says what the gangs are held to; the
shared parts are in ``torch_sharded_gangs.py``.
"""

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from kubeflow_tpu.models import registry as jreg
from kubeflow_tpu.parallel import make_mesh
from kubeflow_tpu.parallel import train_step as jts
from kubeflow_tpu.training import optim as joptim
from kubeflow_tpu_torch.parallel import train_step as tts
from kubeflow_tpu_torch.training import optim as toptim
from kubeflow_tpu_torch.training.checkpoint import CheckpointManager
from kubeflow_tpu_torch.training.trainer import Trainer, TrainerConfig
from torch_sharded_gangs import (  # noqa: F401  (setup: a fixture)
    CASES, MESHES, OPT, SEQ, STEPS, TRAINER, assert_trails_close, gang,
    one_process, port_model, rank_major_batches, setup)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("mesh", ["tp2", "fsdp2_tp2"])
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
