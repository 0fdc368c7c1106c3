"""Data-parallel training of the PyTorch port: gloo gangs on the CPU.

One gang per world size (2 processes here, 4 in
``test_torch_dp_four.py``; ``spawn_local_gang``; the shared parts in
``torch_dp_gangs.py``) runs every model in turn, five steps each,
through ``build_train_step`` with the gang's group: ``mnist_mlp``, ``cifar_convnet``, a tiny ResNet (one
block per stage, width 8, float32; its BatchNorms take global-batch
statistics) at ``grad_accum`` 1 and 2, ``bert_tiny`` (float32; the
masked-LM weights are random, so every rank's mask weight differs) and
the tiny dense Llama.  Every rank starts from the reference's flax init
(``models/convert.py``), ResNet's ``bn3`` scales drawn in [0.1, 0.3] as in
``test_torch_vision.py`` so every block carries gradient, and reads its
``NpzDataset`` rows of each global batch of 16.

Each gang is held to one process at the same global batch: the same
weights, and per step the rank-major concatenation of the ranks' rows
(the reference's assembled global array, which its ``grad_accum``
reshape cuts into micro-batches).  Compared: every step's loss and
grad_norm within 1e-5 relative (float32; the gang sums its rows in
another order), the ranks' losses and final weights bitwise equal, and
every final weight within 1e-5 of its max |p|.

The optimizer is sgd with momentum, which is linear in the gradients.
Under adam each element's step is divided by that element's gradient
magnitude, so an element whose gradient is rounding noise (a
near-cancelling sum) steps by +-lr with a sign set by the summation
order: at lr 1e-3 that moved the 4-rank ResNet at ``grad_accum`` 2 off
the one-process trail by 1.3e-5 in grad_norm by step 2 although the two
first-step gradients agree within 3e-6 of each tensor's max; with
momentum sgd every trail here agrees within 2e-7.  The optimizers
themselves are held to optax in ``test_torch_optim.py``.  The 2-process gang is
also held to the reference's ``build_train_step`` on a 2-device dp mesh
(the conftest's host devices) for BERT and the ResNet at ``grad_accum``
2, the two cases where the loss's global denominator and the rank-major
micro-batches matter.  Then: the rendezvous contract and MoE under dp
refused by name (``test_torch_dp_four.py``: a dead rank ending its
gang, and the worker entrypoint joining a gang from the env that
``build_worker_pod`` writes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from kubeflow_tpu.models import registry as jreg
from kubeflow_tpu.parallel import distributed as jdist
from kubeflow_tpu.parallel import make_mesh
from kubeflow_tpu.parallel import train_step as jts
from kubeflow_tpu.training import optim as joptim
from kubeflow_tpu_torch.models import registry as treg
from kubeflow_tpu_torch.parallel import distributed as pd
from kubeflow_tpu_torch.parallel import train_step as tts
from kubeflow_tpu_torch.training import optim as toptim
from torch_dp_gangs import (  # noqa: F401  (setup: a fixture)
    CASES, IMAGES, OPT, RESNET, SEQ, assert_trails_close, gang,
    one_process, rank_major_batches, setup)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("world", [2])
def test_gang_trains_what_one_process_trains(setup, world, name):
    outs = gang(setup, world)
    trails = [o["trails"][name] for o in outs]
    for r, o in enumerate(outs):
        assert o["rdv"]["process_id"] == r
        assert o["rdv"]["backend"] == "gloo"
        assert trails[r] == trails[0], "ranks disagree"     # bitwise
    want, final = one_process(setup, name, world)
    assert_trails_close(trails[0], want)
    states = [torch.load(setup["root"] / f"{name}-w{world}-r{r}.pt",
                         weights_only=True) for r in range(world)]
    for key, p in final.items():
        for s in states[1:]:
            assert torch.equal(s[key], states[0][key]), key
        err = (states[0][key] - p).abs().max() / p.abs().max().clamp_min(1e-6)
        assert err <= 1e-5, key


def reference_dp_trail(setup, name: str) -> list[tuple[float, float]]:
    """The reference's ``build_train_step`` on a 2-device dp mesh, fed the
    2-process gang's rank-major global batches."""
    module, params = setup["params"][name]
    model = CASES[name][0]
    entry = jreg.get(model)
    mesh = make_mesh(2, dp=2)
    tx = joptim.make_optimizer(OPT)
    example = (jnp.zeros((2, *IMAGES[model])) if model in IMAGES
               else jnp.zeros((2, SEQ), jnp.int32))
    state, shardings = jts.init_train_state(
        module, tx, jax.random.PRNGKey(0), (example,), mesh)
    jparams = jax.tree.map(jnp.asarray, params)
    state = state.replace(params=jparams, opt_state=tx.init(jparams))
    batches = rank_major_batches(setup, name, 2)
    bs = {k: NamedSharding(mesh, P(("dp", "fsdp"))) for k in batches[0]}
    step = jts.build_train_step(
        lambda p, b: entry.forward_loss(module, p, b), tx, mesh, shardings,
        bs, donate=False, grad_accum=CASES[name][2])
    trail = []
    with mesh:
        for nb in batches:
            state, m = step(state, jax.device_put(
                {k: jnp.asarray(v) for k, v in nb.items()}, bs))
            trail.append((float(m["loss"]), float(m["grad_norm"])))
    return trail


@pytest.mark.parametrize("name", ["bert_tiny", "resnet_accum2"])
def test_two_process_gang_matches_the_reference_dp_step(setup, name):
    outs = gang(setup, 2)
    assert_trails_close(outs[0]["trails"][name],
                        reference_dp_trail(setup, name))


@pytest.mark.parametrize("rank", [0, 1])
def test_micro_batch_pieces_are_the_rank_major_rows(rank):
    # 2 ranks of 4 rows, 4 micro-batches of 2: rank 0 holds micro-batches
    # 0 and 1, rank 1 holds 2 and 3
    pieces = tts._pieces(4, rank, 2, 4)
    want = ([(0, 2), (2, 4), (4, 4), (4, 4)] if rank == 0
            else [(0, 0), (0, 0), (0, 2), (2, 4)])
    assert pieces == want
    with pytest.raises(ValueError, match="micro-batches"):
        tts._pieces(3, rank, 2, 4)



def test_resnet_axis_name_names_the_dp_group():
    cfg = {**RESNET, "axis_name": "dp"}
    model = treg.get("resnet50").make_model(device="cpu", **cfg)
    assert model.config.axis_name == "dp"
    with pytest.raises(ValueError, match="axis_name 'batch'"):
        treg.get("resnet50").make_model(device="cpu",
                                        **{**RESNET, "axis_name": "batch"})

# -- the rendezvous contract ------------------------------------------------


def test_rendezvous_env_is_the_references():
    for args in (("h:1", 2, 0), ("10.0.0.1:8476", 4, 3)):
        assert pd.rendezvous_env(*args) == jdist.rendezvous_env(*args)


def test_empty_coordinator_with_gang_refused():
    with pytest.raises(RuntimeError, match="uncoordinated gang"):
        pd.initialize_from_env(
            {"JAXJOB_COORDINATOR": "", "JAXJOB_NUM_PROCESSES": "2",
             "JAXJOB_PROCESS_ID": "0"}, device="cpu")
    out = pd.initialize_from_env(
        {"JAXJOB_COORDINATOR": "", "JAXJOB_NUM_PROCESSES": "1"})
    assert out["initialized"] is False and out["num_processes"] == 1
    assert pd.initialize_from_env({})["initialized"] is False


def test_a_gang_without_cuda_needs_the_cpu_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pd.initialize_from_env({"JAXJOB_COORDINATOR": "127.0.0.1:1",
                                "JAXJOB_NUM_PROCESSES": "2"})


def test_backend_follows_the_devices(monkeypatch):
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert pd.backend_for(cpu, 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert pd.backend_for(cuda, 1) == "nccl"      # one rank per host
    assert pd.backend_for(cuda, 2) == "gloo"      # two ranks share a card
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert pd.backend_for(cuda, 4) == "nccl"
    assert pd.local_world("127.0.0.1:5", 4) == 4
    assert pd.local_world("w-0.job.ns.svc:8476", 4) == 1


def test_all_reduce_sum_buckets_by_size_dtype_and_device(monkeypatch):
    import torch.distributed as dist

    calls = []
    monkeypatch.setattr(dist, "all_reduce", lambda t, group=None: (
        calls.append((t.dtype, t.numel())), t.mul_(2)))
    ts = [torch.ones(3), torch.ones(2, 2), torch.ones(5, dtype=torch.float64),
          torch.ones(40)]
    monkeypatch.setattr(pd, "BUCKET_BYTES", 64)
    pd.all_reduce_sum(ts, group="g")
    # 12 + 16 bytes share a bucket; the float64 tensor starts one; the
    # 160-byte tensor is a bucket alone
    assert calls == [(torch.float32, 7), (torch.float64, 5),
                     (torch.float32, 40)]
    assert all(torch.equal(t, 2 * torch.ones_like(t)) for t in ts)


def dp_mesh(world: int):
    """A mesh of ``world`` ranks all on dp, this process rank 0, whose dp
    group is a stand-in (no collective is reached)."""
    from kubeflow_tpu_torch.parallel import mesh as tmesh

    return tmesh.Mesh(np.arange(world).reshape(world, 1, 1, 1, 1, 1),
                      device_mesh=object(), _groups={("dp",): "dp"})


def test_moe_under_dp_is_refused_by_name(monkeypatch):
    model = treg.get("llama").make_model(size="tiny", moe_experts=2,
                                         device="cpu").init_weights(0)
    state = tts.init_train_state(model, toptim.make_optimizer(OPT))
    monkeypatch.setattr(pd, "world_size", lambda group: 2)
    step = tts.build_train_step(treg.get("llama").forward_loss, state.tx,
                                dp_mesh(2), loss_weight=lambda b: 1)
    batch = treg.get("llama").make_batch(2, torch.Generator().manual_seed(0),
                                         model, seq_len=8)
    with pytest.raises(NotImplementedError, match="moe_experts"):
        step(state, batch)


def test_a_data_parallel_step_needs_a_loss_weight(monkeypatch):
    monkeypatch.setattr(pd, "world_size", lambda group: 2)
    with pytest.raises(ValueError, match="loss_weight"):
        tts.build_train_step(lambda m, b: None, None, dp_mesh(2))


def test_dp_must_be_the_gang_size():
    tts.check_mesh(world=2, dp=2)
    tts.check_mesh(world=2, dp=-1)
    with pytest.raises(ValueError, match="dp=2"):
        tts.check_mesh(dp=2)
    # fsdp and tp are admitted; the axes must multiply to the gang
    assert tts.check_mesh(world=4, fsdp=2, tp=2) == (1, 2, 2, 1, 1, 1)
    for axis in ("fsdp", "tp"):
        with pytest.raises(ValueError, match=f"{axis}=2.*do not multiply "
                           "to 2 devices"):
            tts.check_mesh(world=2, dp=2, **{axis: 2})
    # sp is admitted too (ring attention)
    assert tts.check_mesh(world=2, sp=2) == (1, 1, 1, 2, 1, 1)


@pytest.mark.parametrize("axis", ["pp", "ep"])
def test_pipeline_and_expert_axes_are_refused_by_name(axis):
    with pytest.raises(NotImplementedError, match=f"{axis}=2"):
        tts.check_mesh(world=2, **{axis: 2})
