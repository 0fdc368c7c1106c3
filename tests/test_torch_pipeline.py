"""Pipeline parallelism of the PyTorch port (pp, GPipe) against the
reference's, on the CPU.

One 4-process gloo gang (``spawn_local_gang``) runs ``pipeline_forward``
on the reference test's cases: (pp, M) in {(2, 4) on dp 2 x pp 2, (4, 2),
(4, 8)} through 8 stacked tanh layers of width 16 (``mlp_block``), each
rank on its ``stage_slice``; and the gradients of sum(out^2) at pp = 4,
M = 4 (width 8).  The reference runs ``pipeline_forward`` on the same
numpy weights over its (dp 8 / pp, pp) mesh of the conftest's 8 host
devices, and its ``sequential`` scan.  Held: every rank's output within
1e-5 of both, and every rank's stage gradients within 1e-5 of max |g| of
the reference pipeline's gradients of those layers.  The gang also runs
4 of the tiny Llama's blocks (GQA, causal, RoPE; K1-K3's plain versions)
over pp = 4, M = 2 against the same blocks in sequence on that rank:
output and stage gradients within 1e-5.

In one process: a batch that does not split into the microbatches is
refused with the reference's wording, as is a layer count that does
not split into the stages; ``stack_layer_params`` and ``stage_spec``
against the reference's.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.parallel import make_mesh as jmake_mesh
from kubeflow_tpu.parallel import pipeline as jpipe
from kubeflow_tpu_torch.parallel import distributed as pd
from kubeflow_tpu_torch.parallel import mesh as tmesh
from kubeflow_tpu_torch.parallel import pipeline as tpipe

LAYERS, BATCH = 8, 8
FORWARD = {  # case: (pp, num_microbatches), width 16
    "pp2_m4": (2, 4), "pp4_m2": (4, 2), "pp4_m8": (4, 8)}
GRAD = (4, 4)   # (pp, num_microbatches), width 8

WORKER = r"""
import dataclasses, json, os
import numpy as np
import torch
from torch.func import functional_call
from kubeflow_tpu_torch.models import llama
from kubeflow_tpu_torch.parallel import distributed as pd
from kubeflow_tpu_torch.parallel.mesh import make_mesh
from kubeflow_tpu_torch.parallel.pipeline import (
    pipeline_forward, stack_layer_params, stage_slice)

torch.set_num_threads(1)
pd.initialize_from_env(device="cpu")
spec = json.loads(os.environ["PIPE_SPEC"])
world = pd.world_size(pd.default_group())


def mlp_block(layer, h):
    return torch.tanh(h @ layer["w"] + layer["b"])


def load(name):
    data = np.load(os.path.join(spec["dir"], name + ".npz"))
    return ({"w": torch.tensor(data["w"]), "b": torch.tensor(data["b"])},
            torch.tensor(data["x"]))


out = {}
for name, (pp, m) in spec["forward"].items():
    mesh = make_mesh(dp=world // pp, pp=pp, device_type="cpu")
    stacked, x = load(name)
    y = pipeline_forward(mlp_block, stage_slice(stacked, mesh), x,
                         mesh=mesh, num_microbatches=m)
    out[name] = y.tolist()

pp, m = spec["grad"]
mesh = make_mesh(dp=world // pp, pp=pp, device_type="cpu")
stacked, x = load("grad")
mine = {k: v.clone().requires_grad_() for k, v in
        stage_slice(stacked, mesh).items()}
y = pipeline_forward(mlp_block, mine, x, mesh=mesh, num_microbatches=m)
(y ** 2).sum().backward()
out["grad"] = {k: v.grad.tolist() for k, v in mine.items()}

# 4 tiny Llama blocks over pp = 4, M = 2, against them in sequence
mesh = make_mesh(dp=1, pp=4, device_type="cpu")
cfg = dataclasses.replace(llama.llama_tiny(dtype="float32"), num_layers=4)
model = llama.LlamaModel(cfg, device="cpu").init_weights(0)
blocks = list(model.layers)
stacked = stack_layer_params([
    {k: v.detach() for k, v in b.named_parameters()} for b in blocks])
x = torch.tensor(np.random.default_rng(4).standard_normal((4, 16, 64)),
                 dtype=torch.float32)
positions = torch.arange(16)[None].expand(2, 16)


def llama_block(layer, h):
    return functional_call(blocks[0], layer, (h, positions))[0]


mine = {k: v.clone().requires_grad_() for k, v in
        stage_slice(stacked, mesh).items()}
y = pipeline_forward(llama_block, mine, x, mesh=mesh, num_microbatches=2)
(y ** 2).sum().backward()
full = {k: v.clone().requires_grad_() for k, v in stacked.items()}
h = x
for i in range(4):
    h = functional_call(blocks[0], {k: v[i] for k, v in full.items()},
                        (h, torch.arange(16)[None].expand(4, 16)))[0]
(h ** 2).sum().backward()
want = stage_slice({k: v.grad for k, v in full.items()}, mesh)
out["llama"] = {
    "out": float((y - h).abs().max() / h.abs().max()),
    "grad": max(float((mine[k].grad - want[k]).abs().max()
                      / want[k].abs().max()) for k in mine)}
print(json.dumps(out))
"""


def layers(width: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "w": (rng.standard_normal((LAYERS, width, width))
              / width ** 0.5).astype(np.float32),
        "b": (rng.standard_normal((LAYERS, width)) * 0.01).astype(
            np.float32),
        "x": rng.standard_normal((BATCH, width)).astype(np.float32)}


def mlp_block(layer_params, h):
    return jnp.tanh(h @ layer_params["w"] + layer_params["b"])


def sequential(stacked, x):
    def one(h, layer):
        return mlp_block(layer, h), None

    out, _ = jax.lax.scan(one, x, stacked)
    return out


def reference_forward(case: str, pp: int, m: int, data: dict):
    mesh = jmake_mesh(8, dp=8 // pp, fsdp=1, tp=1, sp=1, pp=pp)
    stacked = {"w": jnp.asarray(data["w"]), "b": jnp.asarray(data["b"])}
    with mesh:
        out = jpipe.pipeline_forward(mlp_block, stacked,
                                     jnp.asarray(data["x"]), mesh=mesh,
                                     num_microbatches=m)
    return np.asarray(out), np.asarray(sequential(stacked,
                                                  jnp.asarray(data["x"])))


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipe")
    for i, name in enumerate(FORWARD):
        np.savez(root / f"{name}.npz", **layers(16, i))
    np.savez(root / "grad.npz", **layers(8, 9))
    spec = {"forward": FORWARD, "grad": GRAD, "dir": str(root)}
    return pd.spawn_local_gang(WORKER, 4, timeout=120.0,
                               extra_env={"PIPE_SPEC": json.dumps(spec)})


@pytest.mark.parametrize("case", list(FORWARD))
def test_pipeline_matches_the_reference_and_sequential(gang, case):
    pp, m = FORWARD[case]
    pipe, seq = reference_forward(case, pp, m,
                                  layers(16, list(FORWARD).index(case)))
    np.testing.assert_allclose(pipe, seq, rtol=0, atol=1e-5)
    for out in gang:
        got = np.asarray(out[case])
        np.testing.assert_allclose(got, pipe, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got, seq, rtol=0, atol=1e-5)


@functools.cache
def reference_grads():
    pp, m = GRAD
    data = layers(8, 9)
    mesh = jmake_mesh(8, dp=8 // pp, fsdp=1, tp=1, sp=1, pp=pp)
    x = jnp.asarray(data["x"])

    def loss(params):
        with mesh:
            return jnp.sum(jpipe.pipeline_forward(
                mlp_block, params, x, mesh=mesh, num_microbatches=m) ** 2)

    stacked = {"w": jnp.asarray(data["w"]), "b": jnp.asarray(data["b"])}
    return jax.tree.map(np.asarray, jax.grad(loss)(stacked))


def test_stage_gradients_match_the_reference(gang):
    pp, _ = GRAD
    want = reference_grads()
    per = LAYERS // pp
    for rank, out in enumerate(gang):
        stage = rank % pp          # dp outermost: rank = dp * pp + stage
        for key, got in out["grad"].items():
            ref = want[key][stage * per:(stage + 1) * per]
            err = np.abs(np.asarray(got) - ref).max() / np.abs(
                want[key]).max()
            assert err <= 1e-5, (rank, key, err)


def test_llama_blocks_pipelined_match_them_in_sequence(gang):
    for out in gang:
        assert out["llama"]["out"] <= 1e-5, out["llama"]
        assert out["llama"]["grad"] <= 1e-5, out["llama"]


def test_bad_microbatching_and_stage_counts_are_refused():
    # a layout of 2 ranks on pp, more than this process's gang: no group
    # is reached before the refusals
    layout = tmesh.make_mesh(2, dp=1, pp=2, device_type="cpu")
    stacked = {"w": torch.zeros(2, 4, 4), "b": torch.zeros(2, 4)}
    with pytest.raises(ValueError, match="microbatches"):
        tpipe.pipeline_forward(lambda p, h: h, stacked, torch.zeros(6, 4),
                               mesh=layout, num_microbatches=4)
    with pytest.raises(ValueError, match="microbatches"):
        jpipe.pipeline_forward(
            mlp_block, {"w": jnp.zeros((2, 4, 4)), "b": jnp.zeros((2, 4))},
            jnp.zeros((6, 4)), mesh=jmake_mesh(8, dp=4, pp=2),
            num_microbatches=4)
    with pytest.raises(ValueError, match="3 layers do not split into "
                       "pp=2 stages"):
        tpipe.stage_slice({"w": torch.zeros(3, 4)}, layout)


def test_stacking_and_the_stage_spec_are_the_references():
    rng = np.random.default_rng(1)
    per_layer = [{"w": rng.standard_normal((3, 3)).astype(np.float32),
                  "n": {"b": rng.standard_normal(3).astype(np.float32)}}
                 for _ in range(4)]
    want = jpipe.stack_layer_params(
        [jax.tree.map(jnp.asarray, p) for p in per_layer])
    got = tpipe.stack_layer_params(
        [{"w": torch.tensor(p["w"]), "n": {"b": torch.tensor(p["n"]["b"])}}
         for p in per_layer])
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
    np.testing.assert_array_equal(got["n"]["b"].numpy(),
                                  np.asarray(want["n"]["b"]))
    assert tpipe.stage_spec() == tuple(jpipe.stage_spec())
