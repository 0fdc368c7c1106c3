"""Llama training in the PyTorch port against the JAX reference.

``llama_tiny(dtype="float32")`` (2 layers, hidden 64, 4 query heads over
2 KV heads, so GQA is exercised) with flax's init carried across by
``models/convert.py``, the same numpy batches on both sides:

- one step's loss and every parameter's gradient (``torch.autograd``
  against ``jax.grad`` of the reference's registry loss), through the
  plain attention route and through the flash Function (its plain K1, K2
  and K3 on the CPU; the reference runs its XLA attention there);
- five steps of ``build_train_step`` (adamw, weight decay on) against the
  reference's, ``grad_accum`` 1 and 2, ``use_flash`` off and on;
- per-block remat (``torch.utils.checkpoint``) on and off: the same
  gradients, and remat runs each block's forward twice;
- the Trainer builds float32 masters; the predictor keeps bf16 weights.

Tolerances, float32 (summation order only): loss within 1e-5 relative;
each gradient within 1e-5 of its max |ref|; loss and grad_norm of every
step within 1e-5 relative.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.models import registry as jreg
from kubeflow_tpu.parallel import make_mesh
from kubeflow_tpu.parallel import train_step as jts
from kubeflow_tpu.parallel.sharding import unbox_params
from kubeflow_tpu.training import optim as joptim
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.models import registry as treg
from kubeflow_tpu_torch.ops import attention as tattention
from kubeflow_tpu_torch.parallel import train_step as tts
from kubeflow_tpu_torch.training import optim as toptim
from kubeflow_tpu_torch.training.trainer import Trainer, TrainerConfig

B, S, STEPS, VOCAB = 4, 32, 5, 512
OPT = {"name": "adamw", "learning_rate": 3e-3, "weight_decay": 0.01,
       "schedule": "linear", "warmup_steps": 2, "total_steps": 10}


@pytest.fixture(autouse=True)
def flash_route_at_head_dim_16(monkeypatch):
    """The dispatcher takes the flash route only at the head dims the
    kernel is built for; the tiny models' head_dim is 16, so it joins them
    here and the ``use_flash`` cases run the flash Function's plain
    versions through the model."""
    monkeypatch.setattr(tattention, "HEAD_DIMS",
                        tattention.HEAD_DIMS + (16,))


def numpy_batch(seed=0):
    ids = np.random.default_rng(seed).integers(0, VOCAB, (B, S + 1)).astype(
        np.int32)
    return {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}


def torch_batch(nb):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).long()
            for k, v in nb.items()}


@pytest.fixture(scope="module")
def reference():
    module = jl.LlamaModel(jl.llama_tiny(dtype="float32"))
    params = module.init(jax.random.PRNGKey(0), jnp.zeros((B, S), jnp.int32))
    return module, unbox_params(params["params"])


def port_model(params, **cfg):
    config = tl.llama_tiny(dtype="float32", **cfg)
    model = tl.LlamaModel(config, device="cpu")
    model.load_state_dict(convert.from_jax_params(
        jax.tree.map(np.asarray, params), config))
    return model.requires_grad_(True)


def rel(a, b) -> float:
    b = np.asarray(b, dtype=np.float32)
    return float(np.abs(np.asarray(a, dtype=np.float32) - b).max()
                 / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("use_flash", [False, True])
def test_loss_and_every_gradient_match_reference(reference, use_flash):
    module, params = reference
    nb = numpy_batch()
    entry = jreg.get("llama")
    loss, grads = jax.value_and_grad(
        lambda p: entry.forward_loss(module, p, {
            k: jnp.asarray(v) for k, v in nb.items()}))(params)
    want = convert.from_jax_params(jax.tree.map(np.asarray, grads),
                                   tl.llama_tiny(dtype="float32"))
    model = port_model(params, use_flash=use_flash)
    got = treg.get("llama").forward_loss(model, torch_batch(nb))
    got.backward()
    assert abs(got.item() - float(loss)) <= 1e-5 * abs(float(loss))
    for name, p in model.named_parameters():
        assert rel(p.grad.numpy(), want[name]) <= 1e-5, name


@functools.lru_cache(maxsize=None)
def reference_run(grad_accum):
    module = jl.LlamaModel(jl.llama_tiny(dtype="float32"))
    mesh = make_mesh(1, dp=1)
    tx = joptim.make_optimizer(OPT)
    state, shardings = jts.init_train_state(
        module, tx, jax.random.PRNGKey(0), (jnp.zeros((B, S), jnp.int32),),
        mesh)
    params0 = jax.tree.map(np.asarray, state.params)
    entry = jreg.get("llama")

    def forward(params, batch):
        return entry.forward_loss(module, params, batch)

    bs = {k: NamedSharding(mesh, P(("dp", "fsdp"))) for k in numpy_batch()}
    step = jts.build_train_step(forward, tx, mesh, shardings, bs,
                                donate=False, grad_accum=grad_accum)
    trail = []
    with mesh:
        for i in range(STEPS):
            state, m = step(state, jax.device_put(
                {k: jnp.asarray(v) for k, v in numpy_batch(i).items()}, bs))
            trail.append((float(m["loss"]), float(m["grad_norm"])))
    return params0, tuple(trail)


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("grad_accum", [1, 2])
def test_five_steps_match_reference(grad_accum, use_flash):
    params0, want = reference_run(grad_accum)
    model = port_model(params0, use_flash=use_flash)
    state = tts.init_train_state(model, toptim.make_optimizer(OPT))
    step = tts.build_train_step(treg.get("llama").forward_loss, state.tx,
                                grad_accum=grad_accum)
    got = []
    for i in range(STEPS):
        state, m = step(state, torch_batch(numpy_batch(i)))
        got.append((m["loss"].item(), m["grad_norm"].item()))
    for (gl, gn), (wl, wn) in zip(got, want):
        assert abs(gl - wl) <= 1e-5 * abs(wl), (got, want)
        assert abs(gn - wn) <= 1e-5 * abs(wn), (got, want)


def test_remat_gives_the_same_gradients_and_reruns_each_block(reference):
    _, params = reference
    batch = torch_batch(numpy_batch(3))
    grads, calls = {}, {}
    for remat in (False, True):
        model = port_model(params, remat=remat, use_flash=True)
        calls[remat] = 0

        def count(*_):
            calls[remat] += 1

        for blk in model.layers:
            blk.register_forward_pre_hook(count)
        treg.get("llama").forward_loss(model, batch).backward()
        grads[remat] = {n: p.grad for n, p in model.named_parameters()}
    assert calls == {False: 2, True: 4}     # 2 layers; remat reruns each
    for name, g in grads[False].items():
        torch.testing.assert_close(grads[True][name], g, rtol=0, atol=0)


def test_remat_is_off_without_grad_and_with_a_cache(reference):
    _, params = reference
    model = port_model(params, use_flash=True)
    assert model.config.remat
    calls = []
    for blk in model.layers:
        blk.register_forward_pre_hook(lambda *_: calls.append(1))
    ids = torch.from_numpy(numpy_batch()["input_ids"]).long()
    with torch.no_grad():
        plain = model(ids)["logits"]
    cache = tl.init_cache(model.config, B, 64, device="cpu")
    cached = model(ids, cache=cache)["logits"]   # grad on, a cache: no remat
    cached.sum().backward()
    assert len(calls) == 4
    torch.testing.assert_close(cached.detach(), plain, rtol=1e-5, atol=1e-5)


def test_trainer_builds_float32_masters_and_serving_keeps_bf16(monkeypatch):
    built = []
    entry = treg.get("llama")

    def make_model(*args, **kw):
        built.append(entry.make_model(*args, **kw))
        return built[-1]

    monkeypatch.setitem(treg._REGISTRY, "llama",
                        dataclasses.replace(entry, make_model=make_model))
    out = Trainer(TrainerConfig(model="llama", model_config={"size": "tiny"},
                                global_batch=2, steps=2, log_every=1),
                  device="cpu").run()
    assert np.isfinite(out["final_loss"])
    (model,) = built
    assert model.config.dtype == "bfloat16"
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    batch = entry.make_batch(3, torch.Generator().manual_seed(0), model)
    assert batch["input_ids"].shape == batch["labels"].shape == (3, 128)
    assert torch.equal(batch["input_ids"][:, 1:], batch["labels"][:, :-1])

    from kubeflow_tpu_torch.serving.predictor import GenerativePredictor

    pred = GenerativePredictor("llama", size="tiny", device="cpu")
    try:
        assert {p.dtype for p in pred.module.parameters()} == {
            torch.bfloat16}
    finally:
        pred.stop(timeout=10)


def test_moe_configs_are_refused_by_the_loss_and_the_model():
    """MoE configurations are built and trained now: the registry's
    Llama loss is the cross-entropy plus ``0.01 * moe_aux``, and a dense
    model's loss carries no such term (``tests/test_torch_moe.py`` holds
    both against the reference)."""
    from kubeflow_tpu_torch.models.mlp import softmax_cross_entropy

    entry = treg.get("llama")
    batch = torch_batch(numpy_batch(1))
    for experts in (2, 0):
        model = entry.make_model(size="tiny", moe_experts=experts,
                                 dtype="float32", device="cpu")
        model.init_weights(0)
        with torch.no_grad():
            out = model(batch["input_ids"])
            loss = entry.forward_loss(model, batch)
        ce = softmax_cross_entropy(out["logits"], batch["labels"])
        if experts:
            assert out["moe_aux"] > 0
            assert torch.equal(loss, ce + 0.01 * out["moe_aux"])
        else:
            assert "moe_aux" not in out and torch.equal(loss, ce)
