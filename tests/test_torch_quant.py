"""int8 serving on the port against the JAX reference, at tiny sizes.

- ``quantize_array``, ``quantize_params`` (which leaves, ``q`` and
  ``scale``), ``quantized_bytes``, ``quantize_kv``, ``dequantize_kv`` and
  ``kv_page_nbytes_int8``: bitwise (or exactly) the reference's, on seeded
  numpy inputs, half steps and all-zero channels included.
- Quantized ``llama_tiny`` (float32 compute, so the bf16 rounding of the
  dequantized weights shows) and its MoE variant: logits within 1e-5 of
  the reference's ``model.apply`` on ``quantize_params(params)``
  (float32: summation order only); the quantized predictor's greedy
  streams equal the reference's quantized ``ContinuousBatcher``'s.
- int8 KV pages: the ports of the reference's ``test_quant.py`` cases
  (round-trip bound, perplexity within 2%, at least 1.9x the pages per
  budget, a warm hit with no leak, a disaggregated handoff), the engine's
  committed pages, int8 spill and fault, and warm streams against the
  reference engine's int8 streams.

The engine's committed int8 pages are held two ways.  Bitwise: each page
is the reference's ``quantize_kv`` of the port's own scratch rows, and
the tail page's positions past the prompt's bucket are what the
reference's scratch holds there (zeros), even right after a longer prompt
left its KV in the reused scratch.  Against the reference ENGINE's pages:
the two stacks' float32 KV agree to ~1e-6, not bitwise, so an int8 value
may sit one step away where the KV straddles a rounding boundary; the
test allows that (at most one step, on at most 1% of the values) and
holds the scales to 1e-5 relative.  A stale tail would move the tail
page's scale far past that.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.parallel.sharding import unbox_params
from kubeflow_tpu.serving import quant as jq
from kubeflow_tpu.serving.engine import ContinuousBatcher as JaxBatcher
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.serving import engine as teng
from kubeflow_tpu_torch.serving import predictor as tpred
from kubeflow_tpu_torch.serving import quant as tq
from kubeflow_tpu_torch.serving.disagg import DisaggCoordinator
from kubeflow_tpu_torch.serving.page_pool import PagePool

TOL = 1e-5
MOE_CFG = {"moe_experts": 4, "moe_every": 2}


# -- helpers --------------------------------------------------------------------

def bits(x) -> tuple:
    """(dtype name, shape, raw bytes) of a torch tensor or a JAX/numpy
    array: equal tuples mean bitwise-equal arrays."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        name = str(x.dtype).replace("torch.", "")
        raw = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x)
        return name, tuple(x.shape), raw.numpy().tobytes()
    a = np.asarray(x)
    return a.dtype.name, a.shape, np.ascontiguousarray(a).tobytes()


def to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def rel(a, b) -> float:
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def port_name(path: str) -> str:
    return re.sub(r"^layer_(\d+)/", r"layers.\1/", path).replace("/", ".")


def ref_qtensors(tree, prefix="") -> dict:
    """port name -> (q, scale) of the reference's QTensor leaves."""
    out = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, jq.QTensor):
            out[port_name(path)] = (val.q, val.scale)
        elif isinstance(val, dict):
            out.update(ref_qtensors(val, path))
    return out


def port_qtensors(model) -> dict:
    return {name: (m.q, m.scale) for name, m in model.named_modules()
            if isinstance(m, tq.QTensor)}


def reference(moe: bool = False):
    cfg = jl.llama_tiny(dtype="float32", **(MOE_CFG if moe else {}))
    module = jl.LlamaModel(cfg)
    params = unbox_params(jax.jit(module.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    return module, params


def port_model(params, moe: bool = False):
    cfg = tl.llama_tiny(dtype="float32", **(MOE_CFG if moe else {}))
    model = tl.LlamaModel(cfg, device="cpu")
    model.load_state_dict(convert.from_jax_params(
        jax.tree.map(np.asarray, params), cfg))
    return model.eval()


@pytest.fixture(scope="module")
def dense():
    return reference()


@pytest.fixture(scope="module")
def moe():
    return reference(moe=True)


# -- weights --------------------------------------------------------------------

def weight_cases():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(48, 20)).astype(np.float32) * np.linspace(
        0.01, 3.0, 20, dtype=np.float32)
    w[:, 0] = 0.0                                  # an all-zero channel
    # amax 127 makes the scale exactly 1: every other entry a half step
    w[:, 1] = 0.0
    w[0, 1] = 127.0
    w[1:9, 1] = [0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -126.5, 3.5]
    w3 = rng.normal(size=(3, 16, 24)).astype(np.float32)
    w3[1, :, 5] = 0.0
    return [(w, 0), (w, 1), (w3, 1), (w3, 0)]


@pytest.mark.parametrize("case", range(4))
def test_quantize_array_bitwise(case):
    w, axis = weight_cases()[case]
    ref = jq.quantize_array(jnp.asarray(w), axis=axis)
    q, scale = tq.quantize_array(torch.from_numpy(w), axis=axis)
    assert bits(q) == bits(ref.q)
    assert bits(scale) == bits(ref.scale)
    # the half steps round to even, as jnp.round does
    if case == 0:
        assert q[1:9, 1].tolist() == [0, 2, 2, 0, -2, 126, -126, 4]
        assert bool((q[:, 0] == 0).all())
        assert float(scale[0, 0]) == float(np.float32(1) / np.float32(127))


@pytest.mark.parametrize("which,min_size", [("dense", 1 << 12),
                                            ("dense", 1), ("moe", 1)])
def test_quantize_params_leaves_and_values(which, min_size, dense, moe):
    module, params = dense if which == "dense" else moe
    model = port_model(params, moe=which == "moe")
    names = tq.quantize_params(model, min_size=min_size)
    qparams = jq.quantize_params(params, min_size=min_size)
    want = ref_qtensors(qparams)
    got = port_qtensors(model)
    assert sorted(names) == sorted(got) == sorted(want)
    assert not any("router" in n for n in got)
    if which == "moe":
        assert {"layers.0.moe.w_in", "layers.0.moe.w_out"} <= set(got)
        assert model.layers[0].moe.router.kernel.dtype == torch.float32
    for name, (q, scale) in got.items():
        assert bits(q) == bits(want[name][0]), name
        assert bits(scale) == bits(want[name][1]), name
    assert tq.quantized_bytes(model) == jq.quantized_bytes(qparams)
    assert tq.quantized_bytes(model) < jq.quantized_bytes(params)


@pytest.mark.parametrize("which", ["dense", "moe"])
def test_quantized_logits_match_reference(which, dense, moe):
    module, params = dense if which == "dense" else moe
    model = port_model(params, moe=which == "moe")
    tq.quantize_params(model, min_size=1)
    qparams = jq.quantize_params(params, min_size=1)
    ids = np.random.default_rng(3).integers(0, 512, (2, 12)).astype(np.int32)
    jout = module.apply({"params": qparams}, jnp.asarray(ids))
    with torch.no_grad():
        out = model(torch.from_numpy(ids).long())
    assert rel(out["logits"], jout["logits"]) <= TOL
    # the float32 model sees bf16-rounded weights: not the unquantized ones
    plain = module.apply({"params": params}, jnp.asarray(ids))
    assert rel(out["logits"], plain["logits"]) > 10 * TOL
    # with a cache (the MoE blocks route dropless there)
    jcache = jl.init_cache(module.config, 2, 32)
    tcache = tl.init_cache(model.config, 2, 32, device="cpu")
    jout = module.apply({"params": qparams}, jnp.asarray(ids), cache=jcache)
    with torch.no_grad():
        out = model(torch.from_numpy(ids).long(), cache=tcache)
    assert rel(out["logits"], jout["logits"]) <= TOL


def test_dequantize_rounds_to_bf16_as_the_reference(dense):
    _, params = dense
    kernel = np.array(params["layer_0"]["attention"]["q"]["kernel"])
    ref = jq.quantize_array(jnp.asarray(kernel))
    q, scale = tq.quantize_array(torch.from_numpy(kernel))
    w = tq.QTensor(q, scale).dequantize()
    assert w.dtype == torch.bfloat16
    assert bits(w) == bits(jnp.asarray(ref))      # __jax_array__


def test_quantized_predictor_greedy_streams_match_reference(dense):
    module, params = dense
    qparams = jq.quantize_params(params)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, 512, n).tolist() for n in (5, 23, 40)]
    jb = JaxBatcher(module, qparams, module.config, max_batch=4, max_seq=96,
                    prefill_chunk=16)
    try:
        want = jb.generate_sync(prompts, max_new_tokens=10)
    finally:
        jb.shutdown()
    state = convert.from_jax_params(jax.tree.map(np.asarray, params),
                                    tl.llama_tiny(dtype="float32"))
    pred = tpred.GenerativePredictor(
        "llama", size="tiny", model_config={"dtype": "float32"}, state=state,
        quantize=True, max_batch=4, max_seq=96, prefill_chunk=16,
        device="cpu")
    try:
        assert pred.weight_bytes == jq.quantized_bytes(qparams)
        assert pred.generate(prompts, max_new_tokens=10)["ids"] == want
    finally:
        pred.stop(timeout=30)


def test_bf16_predictor_quantizes_from_the_state_values(dense):
    """A bf16 model loaded from a float32 state quantizes the state's
    values (the reference quantizes its float32 masters), not the
    bf16-rounded parameters."""
    _, params = dense
    state = convert.from_jax_params(jax.tree.map(np.asarray, params),
                                    tl.llama_tiny())
    pred = tpred.GenerativePredictor("llama", size="tiny", state=state,
                                     quantize=True, max_seq=64, device="cpu")
    try:
        want = ref_qtensors(jq.quantize_params(params))
        got = port_qtensors(pred.module)
        assert sorted(got) == sorted(want)
        for name, (q, scale) in got.items():
            assert bits(q) == bits(want[name][0]), name
            assert bits(scale) == bits(want[name][1]), name
    finally:
        pred.stop(timeout=30)


# -- KV pages -------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_quantize_and_dequantize_kv_bitwise(dtype):
    jdt = jnp.dtype(dtype)
    pages = [jax.random.normal(jax.random.PRNGKey(i), (16, 2, 16)) * (i + 0.5)
             for i in range(3)]
    pages[1] = pages[1].at[:, 1].set(0.0)         # an all-zero head
    pages = [p.astype(jdt) for p in pages]
    x = torch.stack([to_torch(p) for p in pages])
    q, scale = tq.quantize_kv(x)
    assert q.dtype == torch.int8 and scale.shape == (3, 1, 2, 1)
    tdt = tl.llama_tiny(dtype=dtype).torch_dtype
    deq = tq.dequantize_kv(q, scale, tdt)
    for i, p in enumerate(pages):
        rq, rs = jq.quantize_kv(p)
        assert bits(q[i]) == bits(rq) and bits(scale[i]) == bits(rs)
        assert bits(deq[i]) == bits(jq.dequantize_kv(rq, rs, jdt))


@pytest.mark.parametrize("size,page", [("tiny", 16), ("7b", 16), ("tiny", 2)])
def test_kv_page_nbytes_int8_matches_reference(size, page):
    jcfg = jl.llama_tiny() if size == "tiny" else jl.llama2_7b()
    tcfg = tl.llama_tiny() if size == "tiny" else tl.llama2_7b()
    assert tq.kv_page_nbytes_int8(tcfg, page) == jq.kv_page_nbytes_int8(
        jcfg, page)


def test_kv_quant_roundtrip_error_bounded():
    g = torch.Generator().manual_seed(3)
    x = torch.randn(1, 16, 2, 16, generator=g).bfloat16()
    q, scale = tq.quantize_kv(x)
    deq = tq.dequantize_kv(q, scale, torch.float32)
    # symmetric int8: at most half a step per head
    assert bool(((deq - x.float()).abs() <= scale / 2 + 1e-6).all())


def test_kv_quant_perplexity_neutral(dense):
    """Prompt KV through the int8 page grid must not move the model's
    continuation log-probs: within 2% of perplexity (the reference's
    bound)."""
    _, params = dense
    model = port_model(params)
    rng = np.random.RandomState(7)
    prompt = rng.randint(1, 512, size=48).tolist()
    head, tail = prompt[:32], prompt[32:]

    @torch.no_grad()
    def continuation_logprobs(quantize: bool):
        cache = tl.init_cache(model.config, 1, 64, device="cpu")
        model(torch.tensor([head]), cache=cache)
        for layer in cache["layers"]:
            for name in ("k", "v"):
                if quantize:
                    q, s = tq.quantize_kv(layer[name][:, :32])
                    layer[name][:, :32] = tq.dequantize_kv(
                        q, s, layer[name].dtype)
            layer["index"] = 32
        logits = model(torch.tensor([tail]), cache=cache)["logits"][0]
        logp = torch.log_softmax(logits.double(), -1)
        return logp[torch.arange(len(tail) - 1), torch.tensor(tail[1:])]

    ppl_ref = float(torch.exp(-continuation_logprobs(False).mean()))
    ppl_q = float(torch.exp(-continuation_logprobs(True).mean()))
    assert abs(ppl_q / ppl_ref - 1.0) < 0.02, (ppl_ref, ppl_q)


def tiny_port(dense):
    return port_model(dense[1])


def test_kv_quant_doubles_effective_page_capacity(dense):
    model = tiny_port(dense)
    budget = 1 << 19
    plain = teng.ContinuousBatcher(model, model.config, max_batch=2,
                                   max_seq=64, prefix_cache_bytes=budget)
    quant = teng.ContinuousBatcher(model, model.config, max_batch=2,
                                   max_seq=64, prefix_cache_bytes=budget,
                                   kv_quant=True)
    try:
        pp, qp = plain.stats()["kv_pool"], quant.stats()["kv_pool"]
        assert qp.get("quantized") is True and "quantized" not in pp
        assert qp["pages"] >= 1.9 * pp["pages"]
        assert qp["page_nbytes"] < pp["page_nbytes"]
        store = quant.pool.kv["layers"][0]
        assert sorted(store) == ["k", "ks", "v", "vs"]
        assert store["k"].dtype == torch.int8
        assert store["ks"].dtype == torch.float32
        assert tuple(store["ks"].shape[1:]) == (1, 2, 1)
    finally:
        plain.shutdown()
        quant.shutdown()


def test_kv_quant_warm_hit_serves_and_leaks_nothing(dense):
    model = tiny_port(dense)
    eng = teng.ContinuousBatcher(model, model.config, max_batch=2,
                                 max_seq=64, prefix_cache_bytes=1 << 19,
                                 kv_quant=True)
    try:
        prompt = list(range(2, 40))
        h0 = teng.PREFIX_HITS.get()
        cold = eng.generate_sync([prompt], max_new_tokens=8)
        warm = eng.generate_sync([prompt], max_new_tokens=8)
        assert len(warm[0]) == len(cold[0]) == len(prompt) + 8
        stats = eng.stats()
        assert stats["prefix_cache"]["pinned"] == 0
        assert stats["kv_pool"]["orphan_pages"] == 0
        assert teng.PREFIX_HITS.get() > h0
    finally:
        eng.shutdown()


def test_kv_quant_disagg_handoff_round_trips(dense):
    model = tiny_port(dense)
    co = DisaggCoordinator(model, model.config, max_batch=2, max_seq=64,
                           page_size=16, kv_quant=True)
    try:
        prompt = list(range(2, 40))
        out = co.generate_sync([prompt], max_new_tokens=8)
        assert len(out[0]) == len(prompt) + 8
        assert co.stats()["kv_pool"]["orphan_pages"] == 0
        assert co.decode[0].stats()["resumed"] == 1
    finally:
        co.shutdown()


# -- the engine's int8 commits against the reference engine's --------------------

LONG = [7] + list(range(100, 190))                 # 91 tokens
SHORT = [9, 3, 5, 8, 13, 21, 34, 55, 89, 144]      # 10: bucket 16, page 32


def node_pages(engine, prompt):
    node, matched = engine.prefix_cache.match(prompt)
    assert matched == len(prompt)
    return list(node.pages)


@pytest.mark.parametrize("page", [32, 16])
def test_engine_int8_pages_match_reference_engine(page, dense):
    """A long prompt, then a short one on the same engine: every committed
    int8 page is the reference's quantize_kv of the scratch rows it was
    cut from (bitwise), the short prompt's tail past its bucket is zeros
    as in the reference's fresh scratch, and the pages agree with the
    reference engine's (module docstring)."""
    module, params = dense
    model = tiny_port(dense)
    kw = dict(max_batch=2, max_seq=128, prefix_cache_bytes=1 << 20,
              page_size=page, kv_quant=True)
    eng = teng.ContinuousBatcher(model, model.config, **kw)
    jeng = JaxBatcher(module, params, module.config, **kw)
    try:
        for prompt in (LONG, SHORT):
            want = jeng.generate_sync([prompt], max_new_tokens=1)
            assert eng.generate_sync([prompt], max_new_tokens=1) == want
            scratch = eng._scratch()
            pages = node_pages(eng, prompt)
            jpages = node_pages(jeng, prompt)
            assert len(pages) == len(jpages) == -(-len(prompt) // page)
            for i, (pid, jpid) in enumerate(zip(pages, jpages)):
                tree, jtree = eng.pool.get(pid), jeng.pool.get(jpid)
                for li in range(model.config.num_layers):
                    for name in ("k", "v"):
                        rows = scratch[li][name][0, i * page:(i + 1) * page]
                        rq, rs = jq.quantize_kv(jnp.asarray(rows.numpy()))
                        got = tree["layers"][li]
                        assert bits(got[name]) == bits(rq)
                        assert bits(got[name + "s"]) == bits(rs)
                        ref = jtree["layers"][li]
                        dq = (got[name].int()
                              - to_torch(ref[name]).int()).abs()
                        assert int(dq.max()) <= 1
                        assert float((dq > 0).float().mean()) <= 0.01
                        assert rel(got[name + "s"], ref[name + "s"]) <= TOL
        # the short prompt's bucket ends at 16; the rest of its page holds
        # zeros, as the reference's zero scratch does
        if page == 32:
            for layer in eng._scratch():
                assert not bool(layer["k"][0, 16:32].any())
                assert not bool(layer["v"][0, 16:32].any())
    finally:
        eng.shutdown()
        jeng.shutdown()


SYS = [5, 8, 13, 21, 3, 9, 2, 17, 11, 4, 6, 12, 30, 31, 32, 33, 34, 35]


def test_warm_int8_streams_match_reference_engine(dense):
    """Cold, then warm (prefix hits seeded through the dequantize) int8
    streams, greedy, equal the reference engine's int8 streams for the
    same prompts in the same order."""
    module, params = dense
    model = tiny_port(dense)
    kw = dict(max_batch=2, max_seq=128, prefix_cache_bytes=1 << 20,
              page_size=8, kv_quant=True, prefill_chunk=16)
    prompts = [SYS + [7, 1], SYS + [19, 6, 2], SYS + [7, 1],
               SYS + list(range(40, 70))]
    eng = teng.ContinuousBatcher(model, model.config, **kw)
    jeng = JaxBatcher(module, params, module.config, **kw)
    try:
        for p in prompts:
            want = jeng.generate_sync([p], max_new_tokens=10)
            assert eng.generate_sync([p], max_new_tokens=10) == want
        st = eng.stats()
        assert st["prefix_cache"]["pinned"] == 0
        assert st["kv_pool"]["orphan_pages"] == 0
    finally:
        eng.shutdown()
        jeng.shutdown()


# -- tiers ----------------------------------------------------------------------

def test_pool_int8_page_spill_fault_bitwise():
    """int8 pages with their scales survive a spill and a fault without
    one bit moving (reference ``test_kv_tiers.py``)."""
    cfg = dataclasses.replace(tl.llama_tiny(), num_layers=1)
    ps = 2
    pool = PagePool(4, ps, host_pages=2,
                    kv=tl.init_kv_pool(cfg, 4, ps, device="cpu",
                                       quantized=True))
    (pid,) = pool.alloc(1)
    g = torch.Generator().manual_seed(3)
    k = torch.randn(1, ps, 2, 16, generator=g)
    v = torch.randn(1, ps, 2, 16, generator=g)
    qk, ks = tq.quantize_kv(k)
    qv, vs = tq.quantize_kv(v)
    tree = {"layers": [{"k": qk[0], "ks": ks[0], "v": qv[0], "vs": vs[0]}]}
    before = {n: bits(t) for n, t in tree["layers"][0].items()}
    pool.put(pid, tree)
    assert pool.spill([pid]) == [pid]
    assert {n: bits(t) for n, t in pool.get(pid)["layers"][0].items()} \
        == before
    assert pool.fault([pid]) == 1
    after = pool.get(pid)["layers"][0]
    assert {n: bits(t) for n, t in after.items()} == before
    assert after["k"].dtype == torch.int8 and after["ks"].dtype == \
        torch.float32
    pool.decref([pid])
    assert pool.stats()["in_use"] == 0


def test_int8_spill_fault_warm_stream_identical(dense):
    """int8 is lossy once, at the commit: a warm hit after a spill and a
    fault replays the warm stream exactly."""
    model = tiny_port(dense)
    prompt = [5, 8, 13, 21, 3, 9, 2, 17, 11, 4, 6, 12, 25, 31, 7, 19,
              23, 29, 37, 41, 43, 47, 53, 59]
    eng = teng.ContinuousBatcher(model, model.config, max_batch=2,
                                 max_seq=96, page_size=8,
                                 prefix_cache_bytes=1 << 19,
                                 host_kv_pages=16, kv_quant=True)
    try:
        eng.generate_sync([prompt], max_new_tokens=2)    # commit int8 pages
        warm = eng.generate_sync([prompt], max_new_tokens=8)[0]
        while eng.prefix_cache.spill_lru():
            pass
        assert eng.pool.stats()["host_pages"] > 0
        f0 = eng.pool.stats()["faults_total"]
        assert eng.generate_sync([prompt], max_new_tokens=8)[0] == warm
        assert eng.pool.stats()["faults_total"] > f0
        assert eng.stats()["kv_pool"]["orphan_pages"] == 0
    finally:
        eng.shutdown()


def test_predictor_cli_accepts_quantize_and_kv_quant():
    import argparse

    args = argparse.Namespace(
        size="tiny", max_batch=2, max_seq=64, prefill_chunk=16, max_queue=0,
        prefix_cache_mb=0.0, kv_page_size=16, host_kv_pages=0,
        speculative_tokens=0, draft_layers=0, kv_quant=False,
        role="colocated", staging_mb=64.0, checkpoint_dir=None)
    name, kw = tpred._parse_model_spec("llama:quantize=int8,kv_quant=1", args)
    assert name == "llama" and kw["quantize"] and kw["kv_quant"]
    _, kw = tpred._parse_model_spec("llama:quantize=true,role=decode", args)
    assert kw["quantize"] and kw["role"] == "decode" and not kw["kv_quant"]
    # tensor and expert parallelism wait for the multi-device slice; the
    # staging window and checkpoint options are served, and refused only
    # at values that cannot work
    for bad, why in (("llama:tp=2", "not yet supported"),
                     ("llama:ep=2", "not yet supported"),
                     ("llama:staging_mb=0", "must be > 0"),
                     ("llama:checkpoint_dir=/x", "streamable")):
        with pytest.raises(SystemExit, match=why):
            tpred._parse_model_spec(bad, args)
