"""Data-parallel training of the PyTorch port: gloo gangs on the CPU.

One gang per world size (2 and 4 processes, ``spawn_local_gang``) runs
every model in turn, five steps each, through ``build_train_step`` with
the gang's group: ``mnist_mlp``, ``cifar_convnet``, a tiny ResNet (one
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
micro-batches matter.  Then: the rendezvous contract, MoE under dp
refused by name, a dead rank ending its gang, and the worker entrypoint
joining a gang from the env that ``build_worker_pod`` writes.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from kubeflow_tpu.api import jaxjob as japi
from kubeflow_tpu.models import registry as jreg
from kubeflow_tpu.parallel import distributed as jdist
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

ROOT = Path(__file__).resolve().parent.parent
STEPS, GB, SEQ = 5, 16, 16
# sgd with momentum: linear in the gradients (see the module docstring)
OPT = {"name": "sgd", "learning_rate": 1e-2, "momentum": 0.9}
RESNET = {"stage_sizes": [1, 1, 1, 1], "width": 8, "num_classes": 10,
          "dtype": "float32"}
CASES = {  # case: (registry model, model config, grad_accum)
    "mnist_mlp": ("mnist_mlp", {}, 1),
    "cifar_convnet": ("cifar_convnet", {}, 1),
    "resnet_accum1": ("resnet50", RESNET, 1),
    "resnet_accum2": ("resnet50", RESNET, 2),
    "bert_tiny": ("bert", {"size": "tiny", "dtype": "float32"}, 1),
    "llama_tiny": ("llama", {"size": "tiny", "dtype": "float32"}, 1),
}
IMAGES = {"mnist_mlp": (28, 28, 1), "cifar_convnet": (32, 32, 3),
          "resnet50": (32, 32, 3)}

WORKER = r"""
import json, os, torch
from kubeflow_tpu_torch.models import registry
from kubeflow_tpu_torch.parallel import distributed as pd
from kubeflow_tpu_torch.parallel import train_step as ts
from kubeflow_tpu_torch.parallel.mesh import make_mesh
from kubeflow_tpu_torch.training.data import NpzDataset, to_device
from kubeflow_tpu_torch.training.optim import make_optimizer

torch.set_num_threads(1)
rdv = pd.initialize_from_env(device="cpu")
spec = json.loads(os.environ["GANG_SPEC"])
mesh = make_mesh(device_type="cpu")
rank, world = mesh.data_index()
trails = {}
for name, case in spec["cases"].items():
    entry = registry.get(case["model"])
    model = entry.make_model(device="cpu", **case["config"])
    model.load_state_dict(torch.load(case["weights"], weights_only=True))
    state = ts.init_train_state(model, make_optimizer(spec["opt"]))
    step = ts.build_train_step(entry.forward_loss, state.tx, mesh,
                               grad_accum=case["accum"],
                               loss_weight=entry.loss_weight)
    it = NpzDataset(case["data"], spec["global_batch"], seed=0,
                    process_index=rank, process_count=world).iter_from(0)
    trail = []
    for _ in range(spec["steps"]):
        state, m = step(state, to_device(next(it), torch.device("cpu")))
        trail.append([m["loss"].item(), m["grad_norm"].item()])
    trails[name] = trail
    torch.save(model.state_dict(),
               os.path.join(spec["out"], f"{name}-w{world}-r{rank}.pt"))
print(json.dumps({"rdv": rdv, "trails": trails}))
"""


def numpy_rows(name: str, n: int) -> dict:
    rng = np.random.default_rng(11)
    model = CASES[name][0]
    if model in IMAGES:
        return {"image": rng.standard_normal(
                    (n, *IMAGES[model])).astype(np.float32),
                "label": rng.integers(0, 10, (n,)).astype(np.int32)}
    if model == "bert":
        return {"input_ids": rng.integers(0, 1024, (n, SEQ)).astype(np.int32),
                "labels": rng.integers(0, 1024, (n, SEQ)).astype(np.int32),
                "weights": (rng.random((n, SEQ)) < 0.3).astype(np.float32)}
    ids = rng.integers(0, 512, (n, SEQ + 1)).astype(np.int32)
    return {"input_ids": ids[:, :-1].copy(), "labels": ids[:, 1:].copy()}


def reference_init(name: str):
    """(flax module, params, batch_stats or None) as numpy trees."""
    model, cfg, _ = CASES[name]
    module = jreg.get(model).make_model(**cfg)
    example = (jnp.zeros((1, *IMAGES[model])) if model in IMAGES
               else jnp.zeros((1, SEQ), jnp.int32))
    variables = jax.jit(module.init)(jax.random.PRNGKey(0), example)
    params = jax.tree.map(np.asarray, unbox_params(variables["params"]))
    stats = None
    if "batch_stats" in variables:
        rng = np.random.default_rng(1)
        params = {k: ({**v, "bn3": {**v["bn3"], "scale": rng.uniform(
                      0.1, 0.3, v["bn3"]["scale"].shape).astype(np.float32)}}
                      if isinstance(v, dict) and "bn3" in v else v)
                  for k, v in params.items()}
        stats = jax.tree.map(np.asarray, variables["batch_stats"])
    return module, params, stats


def port_model(name: str, state: dict):
    model, cfg, _ = CASES[name]
    m = treg.get(model).make_model(device="cpu", **cfg)
    m.load_state_dict(state)
    return m


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Per case: the reference's weights (as the port's state dict, in a
    file), the npz rows, and the flax params for the reference runs."""
    root = tmp_path_factory.mktemp("dp")
    cases, params = {}, {}
    for name, (model, cfg, accum) in CASES.items():
        if model not in params:     # the ResNet cases share one init
            module, p, stats = reference_init(name)
            config = treg.get(model).make_model(device="cpu", **cfg).config
            torch.save(convert.from_jax_params(p, config, batch_stats=stats),
                       root / f"{model}.pt")
            np.savez(root / f"{model}.npz", **numpy_rows(name, GB * STEPS))
            params[model] = (module, p)
        cases[name] = {"model": model, "config": cfg, "accum": accum,
                       "weights": str(root / f"{model}.pt"),
                       "data": str(root / f"{model}.npz")}
        params[name] = params[model]
    return {"root": root, "cases": cases, "params": params, "gangs": {}}


def gang(setup, world: int) -> dict:
    """The ``world``-process gang's trails (spawned once per world)."""
    if world not in setup["gangs"]:
        spec = {"cases": setup["cases"], "opt": OPT, "global_batch": GB,
                "steps": STEPS, "out": str(setup["root"])}
        outs = pd.spawn_local_gang(WORKER, world, timeout=240.0,
                                   extra_env={"GANG_SPEC": json.dumps(spec)})
        setup["gangs"][world] = outs
    return setup["gangs"][world]


def rank_major_batches(setup, name: str, world: int) -> list[dict]:
    """Each step's global batch as the gang holds it: rank 0's rows, then
    rank 1's, ..."""
    its = [tdata.NpzDataset(setup["cases"][name]["data"], GB, seed=0,
                            process_index=r, process_count=world).iter_from(0)
           for r in range(world)]
    out = []
    for _ in range(STEPS):
        shards = [next(it) for it in its]
        out.append({k: np.concatenate([s[k] for s in shards])
                    for k in shards[0]})
    return out


def one_process(setup, name: str, world: int):
    """(trail, final state) of one process at the same global batch."""
    case = setup["cases"][name]
    model = port_model(name, torch.load(case["weights"], weights_only=True))
    entry = treg.get(case["model"])
    state = tts.init_train_state(model, toptim.make_optimizer(OPT))
    step = tts.build_train_step(entry.forward_loss, state.tx,
                                grad_accum=case["accum"])
    trail = []
    for nb in rank_major_batches(setup, name, world):
        state, m = step(state, tdata.to_device(nb, torch.device("cpu")))
        trail.append((m["loss"].item(), m["grad_norm"].item()))
    return trail, model.state_dict()


def assert_trails_close(got, want, tol=1e-5):
    for (gl, gn), (wl, wn) in zip(got, want, strict=True):
        assert abs(gl - wl) <= tol * abs(wl), (got, want)
        assert abs(gn - wn) <= tol * abs(wn), (got, want)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("world", [2, 4])
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
    with pytest.raises(NotImplementedError, match="sp=2"):
        tts.check_mesh(world=2, sp=2)


@pytest.mark.parametrize("axis", ["pp", "ep"])
def test_pipeline_and_expert_axes_are_refused_by_name(axis):
    with pytest.raises(NotImplementedError, match=f"{axis}=2"):
        tts.check_mesh(world=2, **{axis: 2})


DYING = r"""
import json, os, sys, torch
from kubeflow_tpu_torch.parallel import distributed as pd
pd.initialize_from_env(device="cpu")
x = torch.ones(4)
pd.all_reduce_sum([x], pd.default_group())
if pd.rank_of(pd.default_group()) == 1:
    os._exit(17)           # a preempted rank: no cleanup
pd.all_reduce_sum([x], pd.default_group())
print(json.dumps({}))
"""


def test_a_dead_rank_ends_its_gang():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="exited 17"):
        pd.spawn_local_gang(DYING, 2, timeout=60.0)
    assert time.monotonic() - t0 < 30.0


def test_worker_entrypoint_joins_the_gang_build_worker_pod_describes(
        tmp_path):
    job = japi.new("gang2", "ml", topology="v5e-8",
                   trainer={"model": "mnist_mlp", "steps": 3,
                            "global_batch": 16, "log_every": 1,
                            "optimizer": {"name": "adam",
                                          "learning_rate": 1e-3}})
    port = pd.free_port()
    procs = []
    for index in range(2):
        pod = japi.build_worker_pod(job, index)
        env = {e["name"]: e["value"]
               for e in pod["spec"]["containers"][0]["env"]}
        assert env["JAXJOB_NUM_PROCESSES"] == "2"
        # the pod's DNS name resolves only in a cluster: both workers meet
        # at the coordinator rank 0 binds here
        env["JAXJOB_COORDINATOR"] = f"127.0.0.1:{port}"
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "kubeflow_tpu_torch.training",
             "--device", "cpu"], cwd=ROOT, env={**os.environ, **env},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
            results.append(json.loads(out.strip().splitlines()[-1]))
            assert '"backend": "gloo"' in err        # the rendezvous log
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [r["steps"] for r in results] == [3, 3]
    assert results[0]["final_loss"] == results[1]["final_loss"]
    assert np.isfinite(results[0]["final_loss"])
