"""The MoE gangs' shared parts: the block and Llama cases, the gang
worker, the reference's init as the port's weights, and the reference's
answers on the global batch.

``test_torch_moe_ep.py`` runs the 2-process gang (the block at dp=2 and
at ep=2, the tiny MoE Llama's checkpoint at ep=2, the Trainer at dp=2),
``test_torch_moe_ep_four.py`` the 4-process one (the block at dp=2 x
ep=2, three steps at dp=2 x ep=2 and fsdp=2 x ep=2 against the
reference's sharded step, a one-process checkpoint restored as fsdp x ep
blocks).  ``test_torch_moe_tp_sp.py`` and ``_four.py`` run MoE under tp
and sp and lamb on a mesh with the same worker (each file's docstring
says what).  Separate files, so that a run that hands each worker whole
files runs them side by side.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from kubeflow_tpu.models import moe as jmoe
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

TOL = 1e-5
# the block: hidden 32, FFN 64, 4 experts, a router skewed towards experts
# 0 and 1 and a capacity factor of 0.75, on a global batch of 4 x 8
# tokens: first and second choices both overflow, and some experts keep
# part of their second choices (which ones depends on every rank's
# first choices)
D, F, E = 32, 64, 4
BIAS, CAPACITY_FACTOR = [1.0, 0.6, 0.0, 0.0], 0.75
BLOCK_ROWS, BLOCK_SEQ = 4, 8
# the tiny MoE Llama: llama_tiny's widths (4 query heads over 2 KV heads
# of 16, 2 layers), 4 experts on every second layer (layer 0 MoE)
MOE = {"size": "tiny", "dtype": "float32", "moe_experts": 4, "moe_every": 2}
# the tiny dense Llama (lamb on fsdp and tp)
DENSE = {"size": "tiny", "dtype": "float32"}
# one lamb step compared update for update: lamb moves each tensor by lr
# times its own norm, so at lr 10 float32's rounding of w + update stays
# near 1e-7 of the update (at lr 1 up to 7.4e-7, at lr 1e-3 ~1e-4)
LAMB_ONE = {"name": "lamb", "learning_rate": 10.0, "weight_decay": 0.01}
STEPS, GB, SEQ = 3, 8, 16
# momentum sgd: linear in the gradients (``test_torch_dp.py`` says why
# not adam)
OPT = {"name": "sgd", "learning_rate": 1e-2, "momentum": 0.9}
LAMB = {"name": "lamb", "learning_rate": 1e-3, "weight_decay": 0.01}
TRAINER = {"model": "llama", "model_config": MOE, "optimizer": OPT,
           "global_batch": GB, "steps": STEPS, "log_every": 1}

WORKER = r"""
import contextlib, functools, io, json, os, torch
from kubeflow_tpu_torch.models import moe as tmoe
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
rank = pd.rank_of(world)
out = {"rdv": rdv, "blocks": {}, "trails": {}, "dropped": {}}


def layout(case):
    return make_mesh(dp=case.get("dp", 1), fsdp=case.get("fsdp", 1),
                     tp=case.get("tp", 1), sp=case.get("sp", 1),
                     ep=case.get("ep", 1), device_type="cpu")


class GatedPartials(tmoe.MoEBlock):
    # the tp teeth: the gated [T, D] partials summed over the weights'
    # group, as the dropless forward sums them
    @staticmethod
    def _combine(chosen, gates, group):
        y = (chosen * gates.t().reshape(-1, 1)).reshape(
            2, -1, chosen.shape[1]).sum(dim=0)
        return y if group is None else pd.reduce_from_group(y, group)


def whole(t, p):
    # a block of parameter p (or its gradient) gathered whole
    for axis in ("fsdp", "tp", "ep"):
        split = getattr(p, f"{axis}_split", None)
        if split is not None:
            t = pd.all_gather_cat(t, split.dim, split.group)
    return t


def chunks_whole(t, joint, count, sp):
    # every rank's [n, s, ...] chunk of the global batch, assembled
    if joint is None:
        return t
    n, s = t.shape[:2]
    got = pd.all_gather_cat(t[None], 0, joint)
    return got.reshape(count, sp, n, s, *t.shape[2:]).transpose(1, 2).reshape(
        count * n, sp * s, *t.shape[2:])


for tag, case in spec["blocks"].items():
    # one MoE block on this rank's rows (and sequence chunk) of the global
    # batch; the loss is sum(y * r) + aux over the global batch, its aux
    # term shared out over the data and sp ranks
    mesh = layout(case)
    data = mesh.group("dp", "fsdp")
    index, count = mesh.data_index()
    sp, chunk = mesh.shape["sp"], mesh.coordinate("sp")
    joint = mesh.group("dp", "fsdp", "sp")
    sequence = None
    if case.get("rank_major"):
        # the sp teeth: each rank's chunks taken as one contiguous block of
        # the priority order, rank-major
        data = joint
    elif sp > 1:
        sequence = pd.SequenceSplit(mesh.group("sp"), chunk, joint)
    blob = torch.load(spec["block"], weights_only=True)
    kind = GatedPartials if case.get("gated_partials") else tmoe.MoEBlock
    block = kind(tmoe.MoEConfig(**spec["block_config"]), device="cpu")
    block.load_state_dict(blob["weights"])
    sh.shard_model(block, mesh)
    block.requires_grad_(True)
    n, s = blob["x"].shape[0] // count, blob["x"].shape[1] // sp
    rows = (slice(index * n, (index + 1) * n), slice(chunk * s, (chunk + 1) * s))
    x = blob["x"][rows].clone().requires_grad_(True)
    params = list(block.parameters())
    with pd.data_parallel(data, True, sequence):
        y, aux = block(x)
        loss = (y * blob["r"][rows]).sum() + aux / (count * sp)
        grads = list(torch.autograd.grad(loss, [x] + params))
    if joint is not None:
        pd.all_reduce_sum(grads[1:], joint)
    y, dx = (chunks_whole(t, joint, count, sp) for t in (y.detach(), grads[0]))
    full = {}
    for (name, p), g in zip(block.named_parameters(), grads[1:]):
        full[name] = whole(g, p)
        out.setdefault("split", {})[name] = getattr(p, "ep_split",
                                                    None) is not None
    torch.save({"y": y, "aux": aux.detach(), "dx": dx, "grads": full,
                "dropped": block.dropped},
               os.path.join(spec["out"], f"block-{tag}-{rank}.pt"))

for tag, case in spec.get("lamb_blocks", {}).items():
    # two lamb updates with fixed gradients: each rank's blocks against its
    # blocks of the whole tensors' updates, with the whole tensors' trust
    # ratios and (the teeth) with its blocks' own.  In float64, so that
    # the rounding of w + update does not hide a difference in the update
    mesh = layout(case)
    entry = registry.get("llama")

    def fresh():
        m = entry.make_model(device="cpu", **spec["model_config"])
        m.load_state_dict(torch.load(spec["weights"], weights_only=True))
        return m.double()

    ref = list(fresh().parameters())
    gen = torch.Generator().manual_seed(7)
    fixed = [[torch.randn(p.shape, generator=gen, dtype=torch.float64) * 1e-2
              for p in ref] for _ in range(2)]
    before = [p.detach().clone() for p in ref]
    tx = make_optimizer(spec["lamb"])
    tx.init(ref)
    for g in fixed:
        tx.update(ref, g)
    want = [p.detach() - b for p, b in zip(ref, before)]
    errs = {}
    for mode in ("whole", "blocks"):
        model = sh.shard_model(fresh(), mesh)
        params = list(model.parameters())
        start = [p.detach().clone() for p in params]
        tx = make_optimizer(spec["lamb"])
        tx.init(params)
        squares = None
        if mode == "whole":
            squares = functools.partial(sh.whole_squares, params=params,
                                        mesh=mesh)
        for g in fixed:
            tx.update(params, [sh.local_block(t, p) for t, p in zip(g, params)],
                      whole_squares=squares)
        errs[mode] = max(
            ((p.detach() - b - sh.local_block(w, p)).abs().max()
             / w.abs().max()).item()
            for p, b, w in zip(params, start, want))
    out.setdefault("lamb_blocks", {})[tag] = errs

for tag, case in spec["llama"].items():
    mesh = layout(case)
    index, count = mesh.data_index()
    dense = case.get("dense", False)
    config = spec["dense_config" if dense else "model_config"]
    entry = registry.get("llama")
    model = entry.make_model(device="cpu", **config)
    model.load_state_dict(torch.load(spec["dense_weights" if dense
                                         else "weights"], weights_only=True))
    sh.shard_model(model, mesh)
    state = ts.init_train_state(model, make_optimizer(case.get("opt",
                                                               spec["opt"])))
    step = ts.build_train_step(
        entry.forward_loss, state.tx, mesh, grad_accum=case["accum"],
        loss_weight=entry.loss_weight,
        sequence_keys=entry.sequence_keys if case.get("sp", 1) > 1 else ())
    it = NpzDataset(spec["data"], spec["global_batch"], seed=0,
                    process_index=index, process_count=count).iter_from(0)
    trail, dropped = [], []
    for _ in range(case.get("steps", spec["steps"])):
        state, m = step(state, to_device(next(it), torch.device("cpu")))
        trail.append([m["loss"].item(), m["grad_norm"].item()])
        dropped.append([int(blk.moe.dropped) for blk in model.layers
                        if blk.use_moe])
    out["trails"][tag], out["dropped"][tag] = trail, dropped
    full = sh.full_state_dict(state.model)
    if rank == 0:
        torch.save(full, os.path.join(spec["out"], f"llama-{tag}.pt"))
    if case.get("save"):
        CheckpointManager(os.path.join(spec["out"], f"ckpt-{tag}"),
                          group=world).save(state.step, state)
    if case.get("restore"):
        # a one-process checkpoint restored as this layout's blocks
        back = ts.init_train_state(
            sh.shard_model(entry.make_model(device="cpu",
                                            **spec["model_config"]), mesh),
            make_optimizer(spec["opt"]))
        CheckpointManager(case["restore"], group=world).restore(back)
        blob = torch.load(os.path.join(case["restore"], "ckpt-1.pt"),
                          weights_only=True)
        named = dict(back.model.named_parameters())
        same = [torch.equal(p, sh.local_block(blob["model"][k], p))
                for k, p in named.items()]
        for key, moments in blob["optimizer"]["moments"].items():
            same += [torch.equal(m, sh.local_block(w, p)) for m, w, p in zip(
                back.tx.moments[key], moments, named.values())]
        out["restored_blocks_equal"] = all(same) and back.step == 1
        out["ep_split"] = sorted(k for k, p in named.items()
                                 if getattr(p, "ep_split", None) is not None)
if spec["trainer"]:
    from kubeflow_tpu_torch.training.__main__ import main

    os.environ["JAXJOB_TRAINER_CONFIG"] = json.dumps(spec["trainer"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(["--device", "cpu"])
    out["trainer"] = json.loads(buf.getvalue().strip().splitlines()[-1])
print(json.dumps(out))
"""


def block_config() -> dict:
    return {"hidden_size": D, "ffn_size": F, "num_experts": E,
            "capacity_factor": CAPACITY_FACTOR, "dtype": "float32"}


def reference_block():
    """The reference's block (capacity mode), its params (numpy, the
    router bias skewed), the global batch and the loss's cotangent."""
    module = jmoe.MoEBlock(jmoe.MoEConfig(**block_config()))
    params = jax.tree.map(np.asarray, unbox_params(module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, D)))["params"]))
    params["router"]["bias"] = np.asarray(BIAS, np.float32)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((BLOCK_ROWS, BLOCK_SEQ, D)).astype(np.float32)
    r = rng.standard_normal(x.shape).astype(np.float32)
    return module, params, x, r


def block_weights(params) -> dict:
    return {name: torch.tensor(np.array(a)) for name, a in (
        ("router.kernel", params["router"]["kernel"]),
        ("router.bias", params["router"]["bias"]),
        ("w_in", params["w_in"]), ("w_out", params["w_out"]))}


def reference_block_answer(module, params, x, r) -> dict:
    """y, aux and the gradients of ``sum(y * r) + aux`` on the global
    batch (``jax.grad``), keyed as the port's state dict."""

    def loss(p, xx):
        y, aux = module.apply({"params": p}, xx)
        return jnp.sum(y * r) + aux, (y, aux)

    (_, (y, aux)), (g, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    return {"y": np.asarray(y), "aux": float(aux), "dx": np.asarray(gx),
            "grads": {k: np.asarray(v) for k, v in (
                ("router.kernel", g["router"]["kernel"]),
                ("router.bias", g["router"]["bias"]),
                ("w_in", g["w_in"]), ("w_out", g["w_out"]))}}


def rel(a, b) -> float:
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def numpy_rows(n: int) -> dict:
    rng = np.random.default_rng(12)
    ids = rng.integers(0, 512, (n, SEQ + 1)).astype(np.int32)
    return {"input_ids": ids[:, :-1].copy(), "labels": ids[:, 1:].copy()}


def reference_llama():
    module = jreg.get("llama").make_model(**MOE)
    variables = jax.jit(module.init)(jax.random.PRNGKey(0),
                                     jnp.zeros((1, SEQ), jnp.int32))
    return module, jax.tree.map(np.asarray, unbox_params(variables["params"]))


def port_llama(state: dict):
    m = treg.get("llama").make_model(device="cpu", **MOE)
    m.load_state_dict(state)
    return m


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The block's weights and global batch (a file) with the reference's
    answer; the tiny MoE Llama's reference init as the port's state dict
    (a file), its npz rows, the flax module and params; a one-process
    checkpoint after one step (moments non-zero)."""
    root = tmp_path_factory.mktemp("moe_ep")
    module, params, x, r = reference_block()
    torch.save({"weights": block_weights(params), "x": torch.from_numpy(x),
                "r": torch.from_numpy(r)}, root / "block.pt")
    jmodule, jparams = reference_llama()
    config = treg.get("llama").make_model(device="cpu", **MOE).config
    torch.save(convert.from_jax_params(jparams, config), root / "llama.pt")
    np.savez(root / "llama.npz", **numpy_rows(GB * STEPS))
    model = port_llama(torch.load(root / "llama.pt"))
    state = tts.init_train_state(model, toptim.make_optimizer(OPT))
    step = tts.build_train_step(treg.get("llama").forward_loss, state.tx)
    state, _ = step(state, rank_major_batches(root, 1)[0])
    CheckpointManager(str(root / "ckpt-one")).save(1, state)
    return {"root": root, "block": (module, params, x, r),
            "llama": (jmodule, jparams), "gangs": {}}


def gang(setup, ranks: int, blocks: dict, llama: dict,
         trainer: dict | None = None, lamb_blocks: dict | None = None
         ) -> list[dict]:
    """The gang of ``ranks`` (spawned once per module): the block at each
    layout of ``blocks``, the Llama cases of ``llama`` (a case with
    ``dense`` runs the tiny dense Llama, whose weights ``dense_llama``
    wrote), the Trainer, the lamb updates of ``lamb_blocks``."""
    if ranks not in setup["gangs"]:
        root = setup["root"]
        spec = {"blocks": blocks, "llama": llama, "trainer": trainer,
                "lamb_blocks": lamb_blocks or {},
                "block": str(root / "block.pt"),
                "block_config": block_config(),
                "weights": str(root / "llama.pt"),
                "dense_weights": str(root / "dense.pt"),
                "data": str(root / "llama.npz"), "model_config": MOE,
                "dense_config": DENSE, "opt": OPT, "lamb": LAMB,
                "global_batch": GB, "steps": STEPS, "out": str(root)}
        setup["gangs"][ranks] = pd.spawn_local_gang(
            WORKER, ranks, timeout=240.0,
            extra_env={"GANG_SPEC": json.dumps(spec)})
    return setup["gangs"][ranks]


def block_errors(setup, tag: str, ranks: int) -> list[dict]:
    """Per rank, the gathered y, input gradient and every parameter
    gradient of layout ``tag`` against the reference's on the global
    batch (relative to max |ref|), aux's relative error, and its dropped
    count and outputs."""
    module, params, x, r = setup["block"]
    want = reference_block_answer(module, params, x, r)
    root = setup["root"]
    got = [torch.load(root / f"block-{tag}-{k}.pt", weights_only=True)
           for k in range(ranks)]
    return [{"y": rel(g["y"], want["y"]), "dx": rel(g["dx"], want["dx"]),
             "aux": abs(g["aux"].item() - want["aux"]) / abs(want["aux"]),
             **{name: rel(g["grads"][name], w)
                for name, w in want["grads"].items()},
             "got": g} for g in got]


def check_block(setup, tag: str, ranks: int) -> None:
    """Every rank's gathered y, aux, input gradient, parameter gradients
    and dropped count of layout ``tag`` against the reference's on the
    global batch (within TOL of max |ref|), the replicated ones bitwise
    equal across ranks."""
    errs = block_errors(setup, tag, ranks)
    first = errs[0]["got"]
    for k, e in enumerate(errs):
        g = e.pop("got")
        assert max(e.values()) <= TOL, (k, e)
        assert int(g["dropped"]) == int(first["dropped"]) > 0
        for key in ("y", "aux", "dx"):
            assert torch.equal(g[key], first[key]), (k, key)


def rank_major_batches(root, data_ranks: int) -> list[dict]:
    its = [tdata.NpzDataset(str(root / "llama.npz"), GB, seed=0,
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


def one_process(setup, data_ranks: int, accum: int = 1, opt=OPT,
                steps: int = STEPS):
    """The port in one process at the same global batches: its trail,
    the MoE layers' dropped counts per step, and its final state."""
    model = port_llama(torch.load(setup["root"] / "llama.pt",
                                  weights_only=True))
    state = tts.init_train_state(model, toptim.make_optimizer(opt))
    step = tts.build_train_step(treg.get("llama").forward_loss, state.tx,
                                grad_accum=accum)
    trail, dropped = [], []
    for nb in rank_major_batches(setup["root"], data_ranks)[:steps]:
        state, m = step(state, nb)
        trail.append((m["loss"].item(), m["grad_norm"].item()))
        dropped.append([int(b.moe.dropped) for b in model.layers
                        if b.use_moe])
    return trail, dropped, model.state_dict()


def reference_trail(setup, accum: int) -> list[tuple[float, float]]:
    """The reference's ``build_train_step`` on a (dp 2, ep 2) mesh (the
    conftest's host devices), fed the 2 data ranks' rank-major global
    batches."""
    module, params = setup["llama"]
    entry = jreg.get("llama")
    mesh = make_mesh(4, dp=2, ep=2)
    tx = joptim.make_optimizer(OPT)
    state, shardings = jts.init_train_state(
        module, tx, jax.random.PRNGKey(0),
        (jnp.zeros((4, SEQ), jnp.int32),), mesh)
    jparams = jax.tree.map(jnp.asarray, params)
    state = state.replace(params=jparams, opt_state=tx.init(jparams))
    batches = rank_major_batches(setup["root"], 2)
    bs = {k: NamedSharding(mesh, P(("dp", "fsdp"))) for k in batches[0]}
    step = jts.build_train_step(
        lambda p, b: entry.forward_loss(module, p, b), tx, mesh, shardings,
        bs, donate=False, grad_accum=accum)
    trail = []
    with mesh:
        for nb in batches:
            state, m = step(state, jax.device_put(
                {k: jnp.asarray(v.numpy()) for k, v in nb.items()}, bs))
            trail.append((float(m["loss"]), float(m["grad_norm"])))
    return trail


def dense_llama(setup):
    """The tiny dense Llama's reference init as the port's state dict (a
    file the gang reads), once per module; the flax module and params."""
    if "dense" not in setup:
        module = jreg.get("llama").make_model(**DENSE)
        variables = jax.jit(module.init)(jax.random.PRNGKey(1),
                                         jnp.zeros((1, SEQ), jnp.int32))
        params = jax.tree.map(np.asarray, unbox_params(variables["params"]))
        config = treg.get("llama").make_model(device="cpu", **DENSE).config
        torch.save(convert.from_jax_params(params, config),
                   setup["root"] / "dense.pt")
        setup["dense"] = (module, params)
    return setup["dense"]


def assert_trails_close(got, want, tol=TOL):
    for (gl, gn), (wl, wn) in zip(got, want, strict=True):
        assert abs(gl - wl) <= tol * abs(wl), (got, want)
        assert abs(gn - wn) <= tol * abs(wn), (got, want)
