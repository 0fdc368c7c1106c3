"""Llama of the PyTorch port against the JAX reference, at the tiny size.

The tiny config (2 layers, hidden 64, 4 heads over 2 KV heads, so GQA is
exercised) runs with ``use_flash=True``: prefill takes the flash route
(its plain version on the CPU).  Flax makes the weights; the port loads
them through ``from_jax_params``.  Logits tolerances, relative to max
|logit|: float32 1e-5 (summation order; split prefill is not bitwise
neutral on the reference either), bfloat16 3e-2 (bf16 activations through
2 layers, and the flash route keeps softmax weights in f32 where the
reference rounds them to bf16).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.parallel.sharding import unbox_params
from kubeflow_tpu_torch import device as tdevice
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models import llama as tl

TOL = {"float32": 1e-5, "bfloat16": 3e-2}


@pytest.fixture(scope="module")
def jax_params():
    cfg = jl.llama_tiny(use_flash=True)
    model = jl.LlamaModel(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 8), jnp.int32))
    return unbox_params(params["params"])


def pair(params, dtype):
    """(jitted reference apply, port model, reference cfg, port cfg)."""
    jcfg = jl.llama_tiny(use_flash=True, dtype=dtype)
    tcfg = tl.llama_tiny(use_flash=True, dtype=dtype)
    tm = tl.LlamaModel(tcfg, device="cpu")
    tm.load_state_dict(convert.from_jax_params(
        jax.tree.map(np.asarray, params), tcfg))
    jm = jl.LlamaModel(jcfg)
    japply = jax.jit(lambda p, ids, cache=None: jm.apply(
        {"params": p}, ids, cache=cache))
    return japply, tm, jcfg, tcfg


def rel_err(out: torch.Tensor, ref) -> float:
    ref = np.asarray(ref, dtype=np.float32)
    return float(np.max(np.abs(out.float().numpy() - ref))
                 / np.max(np.abs(ref)))


def ids_of(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(
        np.int32)


def test_from_jax_params_round_trip(jax_params):
    tree = jax.tree.map(np.asarray, jax_params)
    tcfg = tl.llama_tiny()
    state = convert.from_jax_params(tree, tcfg)
    model = tl.LlamaModel(tcfg, device="cpu")
    model.load_state_dict(state)
    sd = model.state_dict()
    assert set(sd) == set(state)
    assert np.array_equal(sd["layers.1.attention.k.kernel"].numpy(),
                          tree["layer_1"]["attention"]["k"]["kernel"])
    assert np.array_equal(sd["tok_embeddings.embedding"].numpy(),
                          tree["tok_embeddings"]["embedding"])
    # bfloat16 leaves are taken bit for bit
    bf = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                      jax_params)
    bstate = convert.from_jax_params(bf, tcfg)
    w = bstate["layers.0.gate.kernel"]
    assert w.dtype == torch.bfloat16
    assert np.array_equal(w.view(torch.uint16).numpy(),
                          bf["layer_0"]["gate"]["kernel"].view(np.uint16))


def test_from_jax_params_rejects_mismatch(jax_params):
    tree = jax.tree.map(np.asarray, jax_params)
    with pytest.raises(ValueError, match="shape"):
        convert.from_jax_params(
            tree, dataclasses.replace(tl.llama_tiny(), intermediate_size=96))
    del tree["final_norm"]
    with pytest.raises(ValueError, match="missing"):
        convert.from_jax_params(tree, tl.llama_tiny())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cacheless_logits(jax_params, dtype):
    japply, tm, _, _ = pair(jax_params, dtype)
    ids = ids_of((2, 20))
    ref = japply(jax_params, jnp.asarray(ids))["logits"]
    out = tm(torch.from_numpy(ids).long())["logits"]
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    assert rel_err(out, ref) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_prefill_then_decode(jax_params, dtype):
    """Scalar-index prefill in two chunks (the flash route over the cache
    slice), then three single-token decode steps."""
    japply, tm, jcfg, tcfg = pair(jax_params, dtype)
    ids = ids_of((1, 23), seed=1)
    jc = jl.init_cache(jcfg, 1, 64)
    tc = tl.init_cache(tcfg, 1, 64, device="cpu")
    steps = [ids[:, :16], ids[:, 16:20], ids[:, 20:21], ids[:, 21:22],
             ids[:, 22:23]]
    for chunk in steps:
        jo = japply(jax_params, jnp.asarray(chunk), cache=jc)
        to = tm(torch.from_numpy(chunk).long(), cache=tc)
        jc, tc = jo["cache"], to["cache"]
        assert rel_err(to["logits"], jo["logits"]) < TOL[dtype]
    assert tc["layers"][0]["index"] == 23


def test_per_sequence_ragged_prefill_and_decode(jax_params):
    """[B] index: a ragged multi-token write per row, then clamped
    single-token decode writes, against the masked reference path."""
    japply, tm, jcfg, tcfg = pair(jax_params, "float32")
    jc = jl.init_cache(jcfg, 2, 32, per_sequence=True)
    tc = tl.init_cache(tcfg, 2, 32, per_sequence=True, device="cpu")
    start = np.array([0, 5], np.int32)
    for layer in jc["layers"]:
        layer["index"] = jnp.asarray(start)
    for layer in tc["layers"]:
        layer["index"] = torch.from_numpy(start).long()
    for step, width in enumerate((6, 1, 1)):
        chunk = ids_of((2, width), seed=10 + step)
        jo = japply(jax_params, jnp.asarray(chunk), cache=jc)
        to = tm(torch.from_numpy(chunk).long(), cache=tc)
        jc, tc = jo["cache"], to["cache"]
        assert rel_err(to["logits"], jo["logits"]) < TOL["float32"]
    assert tc["layers"][0]["index"].tolist() == [8, 13]


def test_unported_branches_raise():
    with pytest.raises(NotImplementedError, match="MoE"):
        tl.LlamaModel(tl.llama_tiny(moe_experts=2), device="cpu")
    tm = tl.LlamaModel(tl.llama_tiny(), device="cpu").init_weights(0)
    cache = tl.init_cache(tm.config, 1, 16, device="cpu")
    cache["layers"] = [dict(l, pages=None) for l in cache["layers"]]
    with pytest.raises(NotImplementedError, match="paged"):
        tm(torch.zeros((1, 2), dtype=torch.long), cache=cache)


def test_device_defaults_to_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdevice.resolve(None)
    with pytest.raises(RuntimeError):
        tl.LlamaModel(tl.llama_tiny())
    assert tdevice.resolve("cpu") == torch.device("cpu")
