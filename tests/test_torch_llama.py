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
from kubeflow_tpu_torch.ops import attention as tattention

TOL = {"float32": 1e-5, "bfloat16": 3e-2}


@pytest.fixture(autouse=True)
def flash_route_at_head_dim_16(monkeypatch):
    """The dispatcher takes the flash route only at the head dims the
    kernel is built for; the tiny models' head_dim is 16, so it joins them
    here and the ``use_flash`` cases run the flash Function's plain
    versions through the model."""
    monkeypatch.setattr(tattention, "HEAD_DIMS",
                        tattention.HEAD_DIMS + (16,))


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
    """Every branch that once raised is ported now: an MoE model runs
    (with and without a cache) and a page-table cache runs and advances
    its index."""
    moe = tl.LlamaModel(tl.llama_tiny(moe_experts=2), device="cpu")
    moe.init_weights(0)
    ids = torch.zeros((1, 4), dtype=torch.long)
    with torch.no_grad():
        out = moe(ids)
        cached = moe(ids, cache=tl.init_cache(moe.config, 1, 16,
                                              device="cpu"))
    assert out["logits"].shape == cached["logits"].shape == (1, 4, 512)
    assert torch.isfinite(out["moe_aux"]) and out["moe_aux"] > 0
    tm = tl.LlamaModel(tl.llama_tiny(), device="cpu").init_weights(0)
    pool = tl.init_kv_pool(tm.config, 4, 8, device="cpu")
    cache = {"layers": [dict(pool_k=l["k"], pool_v=l["v"],
                             pages=torch.tensor([[1, 2]]),
                             index=torch.zeros(1, dtype=torch.long))
                        for l in pool["layers"]]}
    out = tm(torch.zeros((1, 2), dtype=torch.long), cache=cache)
    assert out["cache"]["layers"][0]["index"].tolist() == [2]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ragged_multi_token_write_is_one_scatter(dtype):
    """The per-row multi-token cache write (one index scatter) equals a
    loop of slice writes bitwise, including a row whose start is clamped
    to ``S - s`` as ``dynamic_update_slice`` clamps it."""
    cfg = tl.llama_tiny(dtype="float32" if dtype == torch.float32
                        else "bfloat16")
    model = tl.LlamaModel(cfg, device="cpu").init_weights(3)
    s, max_len = 5, 24
    index = torch.tensor([0, 7, 22])             # row 2 clamps to 19
    cache = tl.init_cache(cfg, 3, max_len, per_sequence=True, device="cpu")
    for layer in cache["layers"]:
        layer["k"].normal_(generator=torch.Generator().manual_seed(1))
        layer["v"].normal_(generator=torch.Generator().manual_seed(2))
        layer["index"] = index
    before = [(l["k"].clone(), l["v"].clone()) for l in cache["layers"]]
    ids = torch.from_numpy(ids_of((3, s), seed=4)).long()
    # each attention's new k/v, recomputed from its input by the same ops
    new_kv = []

    def capture(module, args, output):
        x, pos = args[0], args[1]
        k = tl.kl.rotary_embedding(module.k(x), pos, cfg.rope_base)
        new_kv.append((k, module.v(x)))

    hooks = [blk.attention.register_forward_hook(capture)
             for blk in model.layers]
    with torch.no_grad():
        model(ids, cache=cache)
    for h in hooks:
        h.remove()
    starts = index.clamp(0, max_len - s).tolist()
    assert starts == [0, 7, 19]
    for layer, (k0, v0), (k_new, v_new) in zip(cache["layers"], before,
                                               new_kv):
        # the per-row loop of slice writes that the scatter replaced
        for b, st in enumerate(starts):
            k0[b, st:st + s] = k_new[b].to(k0.dtype)
            v0[b, st:st + s] = v_new[b].to(v0.dtype)
        assert torch.equal(layer["k"], k0)
        assert torch.equal(layer["v"], v0)


def test_device_defaults_to_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdevice.resolve(None)
    with pytest.raises(RuntimeError):
        tl.LlamaModel(tl.llama_tiny())
    assert tdevice.resolve("cpu") == torch.device("cpu")
