"""The data-parallel gangs' shared parts: the cases, the gang worker, the
reference's init as the port's weights, and one process at the same
global batch.

``test_torch_dp.py`` runs the 2-process gang and ``test_torch_dp_four.py``
the 4-process one (``test_torch_dp.py``'s docstring says what both hold
them to).  Two files, so that a run that hands each worker whole files
runs the two gangs side by side.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import registry as jreg
from kubeflow_tpu.parallel.sharding import unbox_params
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
