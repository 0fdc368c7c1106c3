"""Sharded training of the PyTorch port: fsdp and tp gangs on the CPU.

One gloo gang per mesh (``spawn_local_gang``): ``fsdp=2`` and ``tp=2``
(2 processes), ``fsdp=2, tp=2`` and ``dp=2, fsdp=2`` (4 processes; the
latter HSDP: blocks split over fsdp, replicated over dp).  This file
runs the fsdp=2 and dp=2 x fsdp=2 gangs and the refusals,
``test_torch_sharded_train_tp.py`` the tp=2 and fsdp=2 x tp=2 gangs and
what only they drive; the shared parts are in ``torch_sharded_gangs.py``.  Each runs every model
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

import pytest
import torch

from kubeflow_tpu_torch.models import registry as treg
from kubeflow_tpu_torch.parallel import distributed as pd
from kubeflow_tpu_torch.parallel import train_step as tts
from kubeflow_tpu_torch.training import optim as toptim
from kubeflow_tpu_torch.training.trainer import Trainer, TrainerConfig
from torch_sharded_gangs import (  # noqa: F401  (setup: a fixture)
    CASES, MESHES, OPT, TRAINER, assert_trails_close, gang, one_process,
    setup)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("mesh", ["fsdp2", "dp2_fsdp2"])
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
