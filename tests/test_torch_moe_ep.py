"""MoE training of the PyTorch port under a data group and under ep: the
2-process gloo gang on the CPU.

The reference's ``MoEBlock`` computes capacity, positions and aux over
the batch its pjit sees, the global one, and places the experts over ep
(``w_in``/``w_out`` lead with "expert", rows over dp x fsdp only).  The
port's block gathers every data rank's expert counts and sums the aux
probabilities over the data group, and under ep runs its ``E / ep``
experts and gathers their outputs (``models/moe.py``).  One gang of 2
(``spawn_local_gang``) runs, in turn:

- the block (hidden 32, 4 experts, a skewed router, capacity factor
  0.75: first and second choices overflow) at dp=2 and at ep=2 on its
  rows of a seeded 4 x 8 global batch: y, aux, the input gradient and
  every parameter gradient of ``sum(y * r) + aux`` within 1e-5 of max
  |ref| of ``jax.grad`` of the reference's block on the global batch,
  the dropped counts equal, the replicated outputs bitwise equal across
  ranks.  The same block run per rank without the group (a per-rank
  capacity, positions and aux) misses the reference by far more: the
  check has teeth;
- the tiny MoE Llama (``llama_tiny`` widths, 4 experts on every second
  layer, float32) at ep=2, three momentum-sgd steps of
  ``build_train_step``: every step within 1e-5 of one process (ranks
  bitwise equal, every MoE layer's dropped count equal), the gathered
  weights within 1e-5, and its checkpoint (saved at ep=2, whole
  tensors) restored bitwise by one process;
- the worker entrypoint (the Trainer) on that model at dp=2: its final
  loss within 1e-5 of one process's on the global batches the gang
  assembles (rank-major).

``check_mesh`` admits ep, and ``check_mesh`` and the step admit MoE
under tp and sp too (``test_torch_moe_tp_sp.py`` trains it there).  The
4-process gang is ``test_torch_moe_ep_four.py``.
"""

import pytest
import torch

from kubeflow_tpu_torch.models import moe as tmoe
from kubeflow_tpu_torch.models import registry as treg
from kubeflow_tpu_torch.parallel import distributed as pd
from kubeflow_tpu_torch.parallel import mesh as tmesh
from kubeflow_tpu_torch.parallel import train_step as tts
from kubeflow_tpu_torch.training import optim as toptim
from kubeflow_tpu_torch.training.checkpoint import CheckpointManager
from torch_moe_ep_gangs import (  # noqa: F401  (setup: a fixture)
    MOE, OPT, STEPS, TOL, TRAINER, assert_trails_close, block_config,
    block_weights, check_block, gang, one_process, port_llama,
    rank_major_batches, reference_block_answer, rel, setup)

BLOCKS = {"dp2": {"dp": 2, "ep": 1}, "ep2": {"dp": 1, "ep": 2}}
LLAMA = {"ep2": {"dp": 1, "ep": 2, "accum": 1, "save": True}}


def two(setup) -> list[dict]:
    trainer = {**TRAINER, "dp": 2,
               "data_path": str(setup["root"] / "llama.npz")}
    return gang(setup, 2, BLOCKS, LLAMA, trainer)


@pytest.mark.parametrize("layout", list(BLOCKS))
def test_moe_block_matches_the_reference_on_the_global_batch(setup, layout):
    outs = two(setup)
    for r, o in enumerate(outs):
        assert o["rdv"]["process_id"] == r and o["rdv"]["backend"] == "gloo"
    if layout == "ep2":
        assert outs[0]["split"] == {"router.kernel": False,
                                    "router.bias": False, "w_in": True,
                                    "w_out": True}
    check_block(setup, layout, 2)


def test_a_per_rank_capacity_misses_the_reference(setup):
    """The block on each rank's half of the batch with nothing gathered
    (its own capacity, positions and aux) is not the reference's answer,
    so the gangs' 1e-5 above is not met by a local computation."""
    module, params, x, r = setup["block"]
    want = reference_block_answer(module, params, x, r)
    block = tmoe.MoEBlock(tmoe.MoEConfig(**block_config()), device="cpu")
    block.load_state_dict(block_weights(params))
    with torch.no_grad():
        halves = [block(torch.from_numpy(x[i:i + 2])) for i in (0, 2)]
    y = torch.cat([h[0] for h in halves])
    aux = sum(h[1] for h in halves) / 2
    assert rel(y, want["y"]) > 100 * TOL
    assert abs(aux.item() - want["aux"]) > 10 * TOL * abs(want["aux"])


def test_ep2_trains_what_one_process_trains(setup):
    outs = two(setup)
    trails = [o["trails"]["ep2"] for o in outs]
    assert trails[1] == trails[0], "ranks disagree"          # bitwise
    want, dropped, final = one_process(setup, 1)
    assert_trails_close(trails[0], want)
    assert all(o["dropped"]["ep2"] == dropped for o in outs)
    got = torch.load(setup["root"] / "llama-ep2.pt", weights_only=True)
    assert got.keys() == final.keys()
    for key, p in final.items():
        assert rel(got[key], p) <= TOL, key


def test_a_checkpoint_saved_at_ep2_restores_bitwise_into_one_process(setup):
    two(setup)
    root = setup["root"]
    blob = torch.load(root / "ckpt-ep2" / f"ckpt-{STEPS}.pt",
                      weights_only=True)
    one = torch.load(root / "ckpt-one" / "ckpt-1.pt", weights_only=True)
    # whole tensors: an unsharded run's keys and shapes
    assert {k: v.shape for k, v in blob["model"].items()} == {
        k: v.shape for k, v in one["model"].items()}
    gathered = torch.load(root / "llama-ep2.pt", weights_only=True)
    model = port_llama(torch.load(root / "llama.pt", weights_only=True))
    state = tts.init_train_state(model, toptim.make_optimizer(OPT))
    state = CheckpointManager(str(root / "ckpt-ep2")).restore(state)
    assert state.step == STEPS
    for key, p in model.state_dict().items():
        assert torch.equal(p, gathered[key]), key
    for key, moments in blob["optimizer"]["moments"].items():
        for m, w in zip(state.tx.moments[key], moments, strict=True):
            assert torch.equal(m, w)


def test_trainer_trains_moe_under_dp(setup):
    """The worker entrypoint at dp=2 against one process on the global
    batches the gang assembles (each rank's strided ``NpzDataset`` rows,
    rank-major, as the reference's ``make_array_from_process_local_data``
    lays them): capacity priority follows the rows' order, so the same
    rows in the file's order keep another set."""
    outs = two(setup)
    model = treg.get("llama").make_model(device="cpu", **MOE).init_weights(
        TRAINER.get("seed", 0))
    state = tts.init_train_state(model, toptim.make_optimizer(OPT))
    step = tts.build_train_step(treg.get("llama").forward_loss, state.tx)
    for batch in rank_major_batches(setup["root"], 2):
        state, m = step(state, batch)
    want = m["loss"].item()
    for o in outs:
        assert o["trainer"]["steps"] == STEPS
        assert o["trainer"]["final_loss"] == outs[0]["trainer"]["final_loss"]
        assert abs(o["trainer"]["final_loss"] - want) <= TOL * abs(want)


def test_check_mesh_admits_ep():
    assert tts.check_mesh(world=2, ep=2) == (1, 1, 1, 1, 1, 2)
    assert tts.check_mesh(world=4, dp=2, ep=2) == (2, 1, 1, 1, 1, 2)
    assert tts.check_mesh(world=4, fsdp=2, ep=2, dp=1) == (1, 2, 1, 1, 1, 2)


@pytest.mark.parametrize("axis", ["tp", "sp"])
def test_check_mesh_and_step_admit_moe_under_tp_and_sp(axis, monkeypatch):
    """No refusal is left on the way.  One process stands in for rank 0 of
    a layout-only mesh (no process groups; the gang-wide sums return
    their input): at tp=2 the whole model's step runs to its end (tp's
    own collectives come with ``shard_model``), at sp=2 it gets as far as
    the sp groups it binds."""
    assert tts.check_mesh(world=4, dp=1, ep=2, **{axis: 2}) == (
        (1, 1, 2, 1, 1, 2) if axis == "tp" else (1, 1, 1, 2, 1, 2))
    monkeypatch.setattr(pd, "world_size", lambda group: 4)
    monkeypatch.setattr(pd, "all_reduce_sum", lambda tensors, group: None)
    model = treg.get("llama").make_model(device="cpu", **MOE).init_weights(0)
    state = tts.init_train_state(model, toptim.make_optimizer(OPT))
    layout = tmesh.Mesh(tmesh.make_mesh(4, dp=1, ep=2, **{axis: 2}).ranks)
    step = tts.build_train_step(treg.get("llama").forward_loss, state.tx,
                                layout, loss_weight=lambda b: 1,
                                sequence_keys=("input_ids", "labels"))
    batch = treg.get("llama").make_batch(2, torch.Generator().manual_seed(0),
                                         model, seq_len=8)
    if axis == "sp":
        with pytest.raises(RuntimeError, match="spans no process group"):
            step(state, batch)
        return
    state, metrics = step(state, batch)
    assert state.step == 1
    assert all(torch.isfinite(v) for v in metrics.values())
