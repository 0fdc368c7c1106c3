"""Prefix-cached serving on the port's engine: the radix prefix cache over
the refcounted page pool, through the engine's warm admission path.

Tiny Llama at float32 with ``use_flash``, weights made by flax from a
seed and carried over by ``from_jax_params``; prefill takes the flash
route (its plain version on the CPU), so a warm suffix runs it with the
causal offset ``sk - sq`` = the matched length.  A warm admission
(prefix hit: seed the scratch head from cached pages, prefill only the
suffix) must give the SAME tokens as a cold one, greedy and seeded,
alone or co-batched, through a chunked suffix, and through a spill to
the host arena and a fault back; and the same greedy streams as the JAX
``ContinuousBatcher`` with its prefix cache on, for the same prompts in
the same order.  Under pool pressure a prompt evicts older entries or is
not cached, and its stream is still the cold one.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.parallel.sharding import unbox_params
from kubeflow_tpu.serving.engine import ContinuousBatcher as JaxBatcher
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.ops import attention as tattention
from kubeflow_tpu_torch.serving import engine as teng
from kubeflow_tpu_torch.serving import predictor as tpred

MAX_SEQ = 128
CACHE_BYTES = 8 << 20
SYS = [5, 8, 13, 21, 3, 9, 2, 17, 11, 4, 6, 12, 30, 31, 32, 33, 34, 35]


@pytest.fixture(autouse=True)
def flash_route_at_head_dim_16(monkeypatch):
    """The dispatcher takes the flash route only at the head dims the
    kernel is built for; the tiny models' head_dim is 16, so it joins them
    here and the ``use_flash`` cases run the flash Function's plain
    versions through the model."""
    monkeypatch.setattr(tattention, "HEAD_DIMS",
                        tattention.HEAD_DIMS + (16,))


@pytest.fixture(scope="module")
def jax_side():
    cfg = jl.llama_tiny(dtype="float32")
    model = jl.LlamaModel(cfg)
    params = unbox_params(jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    return cfg, model, params


@pytest.fixture(scope="module")
def state(jax_side):
    _, _, params = jax_side
    return convert.from_jax_params(jax.tree.map(np.asarray, params),
                                   tl.llama_tiny(dtype="float32"))


def predictor(state, **kw):
    return tpred.GenerativePredictor(
        "llama", size="tiny",
        model_config={"dtype": "float32", "use_flash": True},
        state=state, max_batch=2, max_seq=MAX_SEQ, device="cpu", **kw)


@pytest.fixture(scope="module")
def cold(state):
    p = predictor(state)
    yield p
    p.stop(timeout=30)


@pytest.fixture(scope="module")
def warm(state):
    p = predictor(state, prefix_cache_mb=8)
    assert p.engine.prefix_cache is not None
    yield p
    p.stop(timeout=30)


def engine(cold, **kw):
    return teng.ContinuousBatcher(cold.module, cold.cfg, max_batch=2,
                                  max_seq=MAX_SEQ, **kw)


def idle_invariants(eng):
    assert eng.drained(timeout=30)
    st = eng.stats()
    assert st["prefix_cache"]["pinned"] == 0
    assert st["kv_pool"]["orphan_pages"] == 0


def test_warm_greedy_identical_to_cold(cold, warm):
    a, b = SYS + [7, 1], SYS + [19, 6, 2]
    ca = cold.generate([a], max_new_tokens=10)["ids"][0]
    cb = cold.generate([b], max_new_tokens=10)["ids"][0]
    h0, m0 = teng.PREFIX_HITS.get(), teng.PREFIX_MISSES.get()
    wa = warm.generate([a], max_new_tokens=10)["ids"][0]   # miss, populates
    wb = warm.generate([b], max_new_tokens=10)["ids"][0]   # partial hit
    wa2 = warm.generate([a], max_new_tokens=10)["ids"][0]  # full-prefix hit
    assert (wa, wb, wa2) == (ca, cb, ca)
    assert teng.PREFIX_MISSES.get() - m0 == 1
    assert teng.PREFIX_HITS.get() - h0 == 2
    idle_invariants(warm.engine)


def test_warm_sampled_identical_to_cold(cold, warm):
    prompt = SYS + [40, 41]
    kw = dict(max_new_tokens=12, temperature=1.3, seed=5, top_k=4,
              top_p=0.9)
    want = cold.engine.submit(prompt, **kw).result(60)
    warm.engine.submit(prompt, max_new_tokens=4).result(60)  # prime cache
    assert warm.engine.submit(prompt, **kw).result(60) == want
    # a partial hit: the shared prefix seeds, a new suffix prefills
    other = SYS + [44, 45, 46]
    assert (warm.engine.submit(other, **kw).result(60)
            == cold.engine.submit(other, **kw).result(60))


def test_ragged_cobatched_hits_identical_to_solo(cold, warm):
    a, b = SYS + [50, 51, 52], SYS + [53]
    solo = [cold.generate([p], max_new_tokens=8)["ids"][0] for p in (a, b)]
    warm.generate([SYS + [54]], max_new_tokens=2)            # prime prefix
    ra = warm.engine.submit(a, max_new_tokens=8)
    time.sleep(0.02)
    rb = warm.engine.submit(b, max_new_tokens=8)
    assert [ra.result(60), rb.result(60)] == solo


def test_full_prefix_hit_is_one_prefill_dispatch(warm):
    prompt = SYS + [60, 61, 62]
    warm.generate([prompt], max_new_tokens=2)                # populate
    d0, t0, h0 = (teng.PREFILL_DISPATCHES.get(), teng.PREFILL_TOKENS.get(),
                  teng.PREFIX_HITS.get())
    warm.generate([prompt], max_new_tokens=2)                # full hit
    assert teng.PREFILL_DISPATCHES.get() - d0 == 1
    assert teng.PREFIX_HITS.get() - h0 == 1
    # only the 1-token suffix ran through prefill compute
    assert teng.PREFILL_TOKENS.get() - t0 == 1


def test_warm_chunked_suffix_identical(cold):
    eng = engine(cold, prefill_chunk=16, prefix_cache_bytes=CACHE_BYTES)
    try:
        shared = list(range(3, 15))                       # 12 tokens
        long_a = shared + list(range(20, 45))             # 37 tokens
        want = cold.generate([long_a], max_new_tokens=6)["ids"][0]
        eng.generate_sync([shared + [99]], max_new_tokens=2)  # cache prefix
        assert eng.generate_sync([long_a], max_new_tokens=6)[0] == want
        # a 16-token page boundary inside the match, the suffix chunked
        # from an offset that is no multiple of the chunk
        long_b = list(range(3, 23)) + list(range(60, 100))
        want = cold.generate([long_b], max_new_tokens=6)["ids"][0]
        eng.generate_sync([list(range(3, 23)) + [7]], max_new_tokens=2)
        assert eng.generate_sync([long_b], max_new_tokens=6)[0] == want
        idle_invariants(eng)
    finally:
        eng.shutdown()


def test_prompt_near_max_seq_caches_only_whole_pages(cold):
    # max_seq 40 with 16-token pages: the third page would straddle
    # max_seq, so a 39-token prompt caches 2 pages and a hit on it seeds
    # at most 32 positions
    eng = teng.ContinuousBatcher(cold.module, cold.cfg, max_batch=1,
                                 max_seq=40, prefix_cache_bytes=CACHE_BYTES)
    ref = teng.ContinuousBatcher(cold.module, cold.cfg, max_batch=1,
                                 max_seq=40)
    try:
        prompt = list(range(1, 40))
        want = ref.generate_sync([prompt], max_new_tokens=1)
        assert eng.generate_sync([prompt], max_new_tokens=1) == want
        assert eng.stats()["prefix_cache"]["pages"] == 2
        assert eng.generate_sync([prompt], max_new_tokens=1) == want
        idle_invariants(eng)
    finally:
        eng.shutdown()
        ref.shutdown()


def test_pins_and_orphans_zero_after_cancel_storm_and_shutdown(cold):
    eng = engine(cold, prefix_cache_bytes=CACHE_BYTES)
    prompt = SYS + [41, 42]
    eng.submit(prompt, max_new_tokens=2).result(60)       # populate tree
    idle_invariants(eng)
    # a storm of prefix-hitting requests, every one abandoned mid-flight
    reqs = [eng.submit(prompt + [50 + i], max_new_tokens=100, eos_id=0)
            for i in range(6)]
    for r in reqs:
        r.cancel()
    for r in reqs:
        assert r._done.wait(60)
    idle_invariants(eng)
    # queued and mid-prefill requests at shutdown()
    held = [eng.submit(prompt + [70 + i], max_new_tokens=100, eos_id=0)
            for i in range(5)]
    eng.shutdown()
    for r in held:
        assert r._done.wait(60)
    assert eng.stats()["prefix_cache"]["pinned"] == 0
    assert eng.stats()["kv_pool"]["orphan_pages"] == 0

    # a cancel between the chunks of a warm chunked prefill releases the
    # pin it holds across dispatches
    eng2 = teng.ContinuousBatcher(cold.module, cold.cfg, max_batch=1,
                                  max_seq=MAX_SEQ, prefill_chunk=16,
                                  prefix_cache_bytes=CACHE_BYTES)
    try:
        shared = list(range(3, 19))                       # 16 tokens
        eng2.generate_sync([shared + [99]], max_new_tokens=2)
        long_req = eng2.submit(shared + list(range(30, 70)),
                               max_new_tokens=4)
        long_req.cancel()
        assert long_req._done.wait(60)
        idle_invariants(eng2)
    finally:
        eng2.shutdown()


@pytest.mark.parametrize("sampling", [
    {}, {"temperature": 0.9, "seed": 11, "top_k": 8}], ids=["greedy",
                                                          "seeded"])
def test_spill_fault_warm_streams_identical(cold, sampling):
    # a 3-page cache budget and an 8-page host arena: a second 3-page
    # prompt spills the first one's pages, and a hit on it faults them back
    page = tl.kv_page_nbytes(cold.cfg, 16)
    eng = engine(cold, prefix_cache_bytes=3 * page, host_kv_pages=8)
    try:
        p1, p2 = list(range(1, 41)), list(range(100, 140))
        kw = dict(max_new_tokens=8, **sampling)
        want = cold.engine.submit(p1, **kw).result(60)
        assert eng.submit(p1, **kw).result(60) == want            # miss
        assert eng.submit(p1, **kw).result(60) == want            # full hit
        (node, _) = eng.prefix_cache.match(p1)
        before = [eng.pool.get(p) for p in node.pages]
        before = [[(l["k"].clone(), l["v"].clone()) for l in t["layers"]]
                  for t in before]
        eng.submit(p2, **kw).result(60)
        st = eng.stats()
        assert st["kv_pool"]["spills_total"] == 3
        assert st["prefix_cache"]["host_pages"] == 3
        assert all(eng.pool.tier(p) == "host" for p in node.pages)
        assert eng.submit(p1, **kw).result(60) == want            # faulted
        st = eng.stats()
        assert st["kv_pool"]["faults_total"] == 3
        for p, layers in zip(node.pages, before):
            got = eng.pool.get(p)["layers"]
            assert eng.pool.tier(p) == "hbm"
            for (k, v), layer in zip(layers, got):
                assert k.equal(layer["k"]) and v.equal(layer["v"])
        idle_invariants(eng)
    finally:
        eng.shutdown()


def test_warm_greedy_streams_identical_to_jax_engine(jax_side, state):
    cfg, model, params = jax_side
    prompts = [SYS + [7, 1], SYS + [19, 6, 2], SYS + [7, 1],
               SYS + list(range(80, 110)), SYS[:10] + [3]]
    jb = JaxBatcher(model, params, cfg, max_batch=2, max_seq=MAX_SEQ,
                    prefill_chunk=16, prefix_cache_bytes=CACHE_BYTES)
    try:
        want = [jb.generate_sync([p], max_new_tokens=8)[0] for p in prompts]
        jstats = jb.stats()["prefix_cache"]
    finally:
        jb.shutdown()
    p = predictor(state, prefill_chunk=16, prefix_cache_mb=8)
    try:
        got = [p.generate([q], max_new_tokens=8)["ids"][0] for q in prompts]
        st = p.engine.stats()["prefix_cache"]
    finally:
        p.stop(timeout=30)
    assert got == want
    for key in ("pages", "nodes", "covered_tokens", "max_pages"):
        assert st[key] == jstats[key], key


def test_default_engine_holds_no_pool_rows(cold):
    eng = cold.engine
    assert eng.prefix_cache is None and eng.pool.kv is None
    st = eng.stats()
    assert "prefix_cache" not in st
    assert st["kv_pool"]["in_use"] == 0
    assert st["kv_pool"]["orphan_pages"] == 0
    # the reference's page budget: 1 + cache pages + max_batch x max_seq/16
    assert st["kv_pool"]["pages"] == 2 * MAX_SEQ // 16


def test_pool_pressure_evicts_then_skips_caching(cold):
    # a pool of 4 allocatable pages under an 8-page cache budget: a second
    # 3-page prompt evicts the first one's node to get its pages; a
    # 5-page prompt cannot be hosted even after evicting everything, so it
    # is not cached.  Every stream is the cold one: admission never blocks
    page = tl.kv_page_nbytes(cold.cfg, 16)
    eng = engine(cold, prefix_cache_bytes=8 * page, kv_pages=5)
    try:
        p1, p2, p3 = (list(range(1, 41)), list(range(100, 140)),
                      list(range(200, 270)))

        def same_as_cold(p):
            want = cold.generate([p], max_new_tokens=4)["ids"][0]
            assert eng.generate_sync([p], max_new_tokens=4)[0] == want

        same_as_cold(p1)
        same_as_cold(p2)
        assert eng.prefix_cache.match(p1) == (None, 0)
        assert eng.prefix_cache.match(p2)[1] == len(p2)
        same_as_cold(p3)
        assert eng.prefix_cache.match(p3) == (None, 0)
        assert eng.stats()["kv_pool"]["in_use"] == 0
        idle_invariants(eng)
    finally:
        eng.shutdown()
