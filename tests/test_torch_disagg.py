"""Disaggregated prefill/decode serving on the port, at tiny sizes.

Ports every case of the reference's ``tests/test_disagg.py`` except
``test_handoff_spans_show_the_hop``, which waits for the port's tracing
(ROADMAP queue A item 9): token identity (greedy, seeded, a ragged
co-batch with a prefix cache) of the ``DisaggCoordinator`` against the
port's colocated engine, and the greedy streams also against the
reference's coordinator; a request done at prefill; a cancel and deadline
storm with no orphan page; the prefill queue's shed; decode-crash
failover and its exclusion of cancelled requests; per-role stats and
drain; the cross-process ``:resume`` path (token identity, the colocated
fallback without a peer, 429 on pool exhaustion, 422 on malformed bodies
with nothing leaked, a dead peer degrading to a local resume); a full
decode worker still taking handoffs.

Added here: the page wire format against the reference's in both
directions (bf16 and int8 pages with their scales), a seeded
cross-process resume carried by the generator's state, and the HTTP
path of a prefill predictor forwarding to a decode predictor named by
``X-KF-Decode-Peer``.

Tiny Llama at float32, weights made by flax from a seed and carried over
by ``from_jax_params``.  Streams are compared exactly.
"""

import copy
import json
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.parallel.sharding import unbox_params
from kubeflow_tpu.serving import disagg as jdisagg
from kubeflow_tpu.serving import quant as jq
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.serving import disagg
from kubeflow_tpu_torch.serving import predictor as tpred
from kubeflow_tpu_torch.serving import quant as tq
from kubeflow_tpu_torch.serving.disagg import DisaggCoordinator
from kubeflow_tpu_torch.serving.engine import (ContinuousBatcher, Draining,
                                               QueueFull)

RAGGED = [[5, 8, 13], [2, 7, 9, 11]]


@pytest.fixture(scope="module")
def jax_side():
    cfg = jl.llama_tiny(dtype="float32")
    module = jl.LlamaModel(cfg)
    params = unbox_params(jax.jit(module.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    return module, params


@pytest.fixture(scope="module")
def state(jax_side):
    return convert.from_jax_params(jax.tree.map(np.asarray, jax_side[1]),
                                   tl.llama_tiny(dtype="float32"))


@pytest.fixture(scope="module")
def model(state):
    m = tl.LlamaModel(tl.llama_tiny(dtype="float32"), device="cpu")
    m.load_state_dict(state)
    return m.eval()


def colocated(model, **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_seq", 64)
    return ContinuousBatcher(model, model.config, **kw)


def coordinator(model, **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_seq", 64)
    kw.setdefault("page_size", 16)
    return DisaggCoordinator(model, model.config, **kw)


def predictor(state, **kw):
    return tpred.GenerativePredictor(
        "llama", size="tiny", model_config={"dtype": "float32"},
        state=state, max_batch=2, max_seq=64, device="cpu", **kw)


def reference_streams(model, batch, **kw):
    eng = colocated(model)
    try:
        return eng.generate_sync(batch, **kw)
    finally:
        eng.shutdown()


# -- token identity ---------------------------------------------------------------

def test_greedy_identical_to_colocated_and_to_the_reference(model, jax_side):
    ref = reference_streams(model, RAGGED, max_new_tokens=8)
    module, params = jax_side
    jco = jdisagg.DisaggCoordinator(module, params, module.config,
                                    max_batch=2, max_seq=64, page_size=16)
    try:
        jref = jco.generate_sync(RAGGED, max_new_tokens=8)
    finally:
        jco.shutdown()
    co = coordinator(model)
    try:
        assert co.generate_sync(RAGGED, max_new_tokens=8) == ref == jref
        assert co.prefill[0].stats()["handoffs"] == 2
        assert co.decode[0].stats()["resumed"] == 2
    finally:
        co.shutdown()


def test_seeded_sampling_identical(model):
    kw = dict(max_new_tokens=10, temperature=0.9, seed=7)
    ref = reference_streams(model, RAGGED, **kw)
    co = coordinator(model)
    try:
        assert co.generate_sync(RAGGED, **kw) == ref
    finally:
        co.shutdown()


def test_ragged_cobatch_with_prefix_cache(model):
    """A warm prefix hit on the prefill engine seeds from shared pages,
    hands off, and still matches the colocated output."""
    prompts = [list(range(2, 40)), list(range(2, 36)) + [99, 98]]
    eng = colocated(model, prefix_cache_bytes=1 << 20)
    ref = eng.generate_sync(prompts, max_new_tokens=6)
    assert eng.generate_sync(prompts, max_new_tokens=6) == ref
    eng.shutdown()
    co = coordinator(model, prefix_cache_bytes=1 << 20)
    try:
        assert co.generate_sync(prompts, max_new_tokens=6) == ref
        # second pass: prefix hits on the prefill engine
        assert co.generate_sync(prompts, max_new_tokens=6) == ref
        assert co.drained(timeout=30)
        assert co.stats()["kv_pool"]["orphan_pages"] == 0
        assert co.stats()["prefix_cache"]["pinned"] == 0
        assert co.prefill[0].stats()["handoffs"] >= 4
    finally:
        co.shutdown()


# -- handoff lifecycle ------------------------------------------------------------

def test_max_new_one_finishes_at_prefill(model):
    co = coordinator(model)
    try:
        out = co.submit([3, 1, 4], max_new_tokens=1).result(60)
        assert len(out) == 4
        assert co.prefill[0].stats()["handoffs"] == 0
        assert co.stats()["kv_pool"]["orphan_pages"] == 0
    finally:
        co.shutdown()


def test_cancel_deadline_storm_zero_orphans(model):
    co = coordinator(model, max_batch=2)
    try:
        reqs = []
        for i in range(12):
            r = co.submit([2 + i % 7, 5, 9, 4], max_new_tokens=30,
                          deadline_s=0.05 if i % 3 == 0 else None)
            if i % 3 == 1:
                r.cancel()
            reqs.append(r)
        for r in reqs:
            try:
                r.result(timeout=120)
            except Exception:
                pass
        assert co.drained(timeout=60)
        assert co.stats()["kv_pool"]["orphan_pages"] == 0
        assert all(r.outcome is not None for r in reqs)
    finally:
        co.shutdown()
    assert co.stats()["kv_pool"]["orphan_pages"] == 0


def test_prefill_queue_bound_sheds(model):
    co = coordinator(model, max_queue=1)
    try:
        shed, admitted = 0, []
        for i in range(60):
            try:
                admitted.append(co.submit([5 + i % 7, 8, 13] + [3] * 40,
                                          max_new_tokens=8))
            except QueueFull as e:
                assert e.retry_after > 0
                shed += 1
        assert shed > 0, "bounded prefill queue never shed"
        for r in admitted:
            r.result(timeout=300)
    finally:
        co.shutdown()


# -- failover ---------------------------------------------------------------------

def wait_active(engines, timeout=10.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        active = [e for e in engines if e.stats()["active"] > 0]
        if active:
            return active
        time.sleep(0.005)
    return []


def test_decode_crash_mid_stream_completes_cold(model):
    ref = reference_streams(model, [[5, 8, 13]], max_new_tokens=40, seed=3,
                            temperature=0.9)
    co = coordinator(model, decode_workers=2, prefix_cache_bytes=1 << 20)
    try:
        r = co.submit([5, 8, 13], max_new_tokens=40, seed=3, temperature=0.9)
        active = wait_active(co.decode)
        assert active, "stream never reached a decode worker"
        f0 = disagg.FAILOVERS.get()
        active[0].shutdown()
        assert r.result(timeout=120) == ref[0]
        assert r.outcome == "ok"
        assert disagg.FAILOVERS.get() == f0 + 1
        assert co.drained(timeout=60)
        stats = co.stats()
        assert stats["kv_pool"]["orphan_pages"] == 0
        assert stats["prefix_cache"]["pinned"] == 0
    finally:
        co.shutdown()


def test_cancelled_request_not_failed_over(model):
    co = coordinator(model, decode_workers=1)
    try:
        r = co.submit([5, 8, 13], max_new_tokens=40)
        wait_active(co.decode)
        f0 = disagg.FAILOVERS.get()
        r.cancel()
        co.decode[0].shutdown()
        with pytest.raises(ValueError):
            r.result(timeout=60)
        assert r.outcome in ("cancelled", "shutdown")
        assert disagg.FAILOVERS.get() == f0
    finally:
        co.shutdown()


# -- per-role stats and drain ------------------------------------------------------

def test_per_role_scaling_signals(model):
    co = coordinator(model)
    try:
        assert co.prefill[0].stats()["role"] == "prefill"
        assert co.decode[0].stats()["role"] == "decode"
        assert "handoffs" in co.prefill[0].stats()
        # a shared pool's orphan accounting is the coordinator's
        assert "orphan_pages" not in co.prefill[0].stats()["kv_pool"]
        assert "orphan_pages" in co.stats()["kv_pool"]
    finally:
        co.shutdown()


def test_drain_semantics_per_pool(model):
    co = coordinator(model)
    try:
        r = co.submit([5, 8, 13], max_new_tokens=12)
        co.drain()
        with pytest.raises(Draining):
            co.submit([2, 7], max_new_tokens=4)
        assert r.result(timeout=120)
        assert co.drained(timeout=60)
    finally:
        co.shutdown()


def test_full_decode_worker_still_takes_handoffs(model):
    """A healthy decode worker with no free slot queues handoffs; the
    overflow is not dumped onto the prefill engine's slots."""
    co = coordinator(model, max_batch=2, decode_workers=1)
    try:
        reqs = [co.submit([3 + i, 5, 9], max_new_tokens=24, seed=i)
                for i in range(5)]
        outs = [r.result(timeout=300) for r in reqs]
        assert all(len(o) == 3 + 24 for o in outs)
        assert co.prefill[0].stats()["handoffs"] == 5
        assert co.prefill[0].stats()["resumed"] == 0
        assert co.decode[0].stats()["resumed"] == 5
        assert co.stats()["kv_pool"]["orphan_pages"] == 0
    finally:
        co.shutdown()


# -- the cross-process wire -------------------------------------------------------

def test_serialized_resume_token_identical(state):
    ref = predictor(state)
    expect = ref.generate(RAGGED, max_new_tokens=6)["ids"]
    ref.stop(timeout=30)
    dec = predictor(state, role="decode")
    posts = []

    def post(addr, path, payload, timeout=300.0):
        posts.append((addr, path))
        return dec.resume(json.loads(json.dumps(payload)))

    pre = predictor(state, role="prefill", handoff_post=post)
    try:
        out = pre.generate(RAGGED, max_new_tokens=6,
                           decode_peer="decode-pod:1234")
        assert out["ids"] == expect
        assert len(posts) == 2 and all(":resume" in p for _, p in posts)
        assert pre.engine.stats()["kv_pool"]["orphan_pages"] == 0
        assert dec.engine.stats()["kv_pool"]["orphan_pages"] == 0
        assert dec.engine.stats()["resumed"] == 2
        assert pre.engine.stats()["resumed"] == 0
    finally:
        pre.stop(timeout=30)
        dec.stop(timeout=30)


def test_seeded_resume_across_processes_carries_the_generator(state):
    """A sampled stream handed across through the serialized body (the
    generator's state as base64, a fresh request on the decode side)
    equals the colocated stream."""
    kw = dict(max_new_tokens=12, temperature=1.1, seed=5, top_k=20)
    ref = predictor(state)
    expect = ref.generate(RAGGED, **kw)["ids"]
    ref.stop(timeout=30)
    dec = predictor(state, role="decode")
    bodies = []

    def post(addr, path, payload, timeout=300.0):
        body = json.loads(json.dumps(payload))
        bodies.append(body)
        return dec.resume(body)

    pre = predictor(state, role="prefill", handoff_post=post)
    try:
        assert pre.generate(RAGGED, decode_peer="d:1", **kw)["ids"] == expect
        assert all(b["gen_state"] and len(b["key_chain"]) == 2
                   for b in bodies)
        # without the generator state a sampled resume is refused
        bad = copy.deepcopy(bodies[0])
        bad["gen_state"] = None
        with pytest.raises(ValueError, match="gen_state"):
            disagg.resume_serialized(dec.engine, bad)
    finally:
        pre.stop(timeout=30)
        dec.stop(timeout=30)


def test_no_peer_falls_back_colocated(state):
    ref = predictor(state)
    expect = ref.generate([[5, 8, 13]], max_new_tokens=6)["ids"]
    ref.stop(timeout=30)
    pre = predictor(state, role="prefill")
    try:
        assert pre.generate([[5, 8, 13]], max_new_tokens=6)["ids"] == expect
        assert pre.engine.stats()["resumed"] == 1
        assert pre.engine.stats()["kv_pool"]["orphan_pages"] == 0
    finally:
        pre.stop(timeout=30)


def capture_body(model, prompt, max_new=6, **kw):
    """A serialized handoff of ``prompt`` from a coordinator's prefill
    engine (taken inside the callback, while its references live), and
    the stream the coordinator produced."""
    co = coordinator(model, **kw)
    bodies = []
    orig = co.prefill[0].handoff_fn

    def cap(req, st):
        bodies.append(json.loads(json.dumps(
            disagg.serialize_handoff(st, co.pool))))
        orig(req, st)

    co.prefill[0].handoff_fn = cap
    try:
        expect = co.submit(prompt, max_new_tokens=max_new).result(60)
    finally:
        co.shutdown()
    return bodies[0], expect


def test_resume_pool_exhaustion_is_shed(model):
    body, _ = capture_body(model, list(range(2, 50)), max_new=4)
    dec = ContinuousBatcher(model, model.config, max_batch=1, max_seq=64,
                            kv_pages=2, page_size=16, role="decode")
    try:
        with pytest.raises(QueueFull):
            disagg.resume_serialized(dec, body)
        assert dec.stats()["kv_pool"]["orphan_pages"] == 0
    finally:
        dec.shutdown()


def test_malformed_resume_rejected_without_leak_or_crash(model):
    body, expect = capture_body(model, list(range(2, 40)))
    dec = colocated(model, page_size=16, role="decode")
    try:
        free0 = dec.pool.free_count
        for mutate in (
            lambda b: b.update(key_chain=[1, 2, 3]),
            lambda b: b["pages"][0][0]["k"].update(shape=[1, 1, 1]),
            lambda b: b["pages"][0][0]["k"].update(data="!!notb64"),
            lambda b: b["pages"][0][0]["k"].update(dtype="bfloat16"),
            lambda b: b.update(pages=b["pages"][:1]),
            lambda b: b.update(generated=[]),
            lambda b: b.update(generated=[1, 2, 3]),
            lambda b: b.update(max_new_tokens=10_000),
            lambda b: b.update(gen_state="!!notb64"),
            lambda b: b.update(ids=[-1] + b["ids"][1:]),
        ):
            bad = copy.deepcopy(body)
            mutate(bad)
            with pytest.raises(ValueError):
                disagg.resume_serialized(dec, bad)
        assert dec.pool.free_count == free0            # nothing leaked
        # the engine still serves, and the good body resumes to the stream
        assert disagg.resume_serialized(dec, body) == expect
        out = dec.generate_sync([[5, 8, 13]], max_new_tokens=4)
        assert len(out[0]) == 7
        assert dec.stats()["kv_pool"]["orphan_pages"] == 0
    finally:
        dec.shutdown()


def test_dead_peer_degrades_to_local_resume(state):
    ref = predictor(state)
    expect = ref.generate(RAGGED, max_new_tokens=6)["ids"]
    ref.stop(timeout=30)

    def dead_peer(addr, path, payload, timeout=300.0):
        raise ConnectionRefusedError("decode pod is gone")

    pre = predictor(state, role="prefill", handoff_post=dead_peer)
    try:
        out = pre.generate(RAGGED, max_new_tokens=6, decode_peer="dead:1")
        assert out["ids"] == expect
        assert pre.engine.stats()["resumed"] == 2
        assert pre.engine.stats()["kv_pool"]["orphan_pages"] == 0
    finally:
        pre.stop(timeout=30)


def test_prefill_forwards_over_http_to_the_decode_peer(state):
    """The whole cross-process path over localhost HTTP: a prefill
    predictor's ``:generate`` with ``X-KF-Decode-Peer`` forwards each
    row to a decode predictor's ``:resume``; 422 for a malformed body."""
    import http.client

    from kubeflow_tpu_torch.serving.httpserve import serve

    ref = predictor(state)
    expect = ref.generate(RAGGED, max_new_tokens=6, temperature=0.7,
                          seed=3)["ids"]
    ref.stop(timeout=30)
    dec, pre = predictor(state, role="decode"), predictor(state,
                                                          role="prefill")
    servers = [serve(tpred.PredictorApp({"llama": p}), 0)
               for p in (dec, pre)]
    dport, pport = (s[0].server_port for s in servers)

    def call(port, verb, body, headers=()):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            conn.request("POST", f"/v1/models/llama:{verb}",
                         json.dumps(body), {"Content-Type":
                                            "application/json",
                                            **dict(headers)})
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())
        finally:
            conn.close()

    try:
        status, body = call(pport, "generate",
                            {"ids": RAGGED, "max_new_tokens": 6,
                             "temperature": 0.7, "seed": 3},
                            [("X-KF-Decode-Peer", f"127.0.0.1:{dport}")])
        assert status == 200 and body["ids"] == expect
        assert dec.engine.stats()["resumed"] == 2
        assert pre.engine.stats()["resumed"] == 0
        status, body = call(dport, "resume", {"ids": [1, 2],
                                              "generated": []})
        assert status == 422
    finally:
        for httpd, thread in servers:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=10)
        pre.stop(timeout=30)
        dec.stop(timeout=30)


# -- the page wire format against the reference's ----------------------------------

def engine_view(cfg, kv_quant: bool, page_size: int):
    """What ``parse_page_trees`` (either side's) reads of an engine."""
    return SimpleNamespace(cfg=cfg, kv_quant=kv_quant, page_size=page_size)


def port_page(cfg, ps, kv_quant, seed):
    g = torch.Generator().manual_seed(seed)
    layers = []
    for _ in range(cfg.num_layers):
        k = torch.randn(1, ps, cfg.num_kv_heads, cfg.head_dim, generator=g)
        v = torch.randn(1, ps, cfg.num_kv_heads, cfg.head_dim, generator=g)
        if kv_quant:
            kq, ks = tq.quantize_kv(k)
            vq, vs = tq.quantize_kv(v)
            layers.append({"k": kq[0], "ks": ks[0], "v": vq[0], "vs": vs[0]})
        else:
            layers.append({"k": k[0].to(cfg.torch_dtype),
                           "v": v[0].to(cfg.torch_dtype)})
    return {"layers": layers}


def jax_page(cfg, ps, kv_quant, seed):
    layers = []
    for li in range(cfg.num_layers):
        k1, k2 = jax.random.split(jax.random.PRNGKey(seed * 100 + li))
        shape = (ps, cfg.num_kv_heads, cfg.head_dim)
        k = jax.random.normal(k1, shape)
        v = jax.random.normal(k2, shape)
        if kv_quant:
            kq, ks = jq.quantize_kv(k)
            vq, vs = jq.quantize_kv(v)
            layers.append({"k": kq, "ks": ks, "v": vq, "vs": vs})
        else:
            layers.append({"k": k.astype(cfg.jnp_dtype),
                           "v": v.astype(cfg.jnp_dtype)})
    return {"layers": layers}


def raw(x) -> bytes:
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


@pytest.mark.parametrize("kv_quant", [False, True])
def test_port_pages_parse_in_the_reference(kv_quant):
    tcfg, jcfg, ps = tl.llama_tiny(), jl.llama_tiny(), 16
    pages = [port_page(tcfg, ps, kv_quant, s) for s in range(2)]
    wire = json.loads(json.dumps([disagg.encode_page(p) for p in pages]))
    parsed = jdisagg.parse_page_trees(wire,
                                      engine_view(jcfg, kv_quant, ps))
    for page, tree in zip(pages, parsed):
        for layer, jlayer in zip(page["layers"], tree["layers"]):
            assert set(layer) == set(jlayer)
            for name, t in layer.items():
                want = "bfloat16" if t.dtype == torch.bfloat16 else str(
                    t.numpy().dtype)
                assert np.asarray(jlayer[name]).dtype.name == want
                assert raw(t) == raw(jlayer[name]), name


@pytest.mark.parametrize("kv_quant", [False, True])
def test_reference_pages_parse_in_the_port(kv_quant):
    tcfg, jcfg, ps = tl.llama_tiny(), jl.llama_tiny(), 16
    pages = [jax_page(jcfg, ps, kv_quant, s) for s in range(2)]
    wire = json.loads(json.dumps([jdisagg.encode_page(p) for p in pages]))
    parsed = disagg.parse_page_trees(wire,
                                     engine_view(tcfg, kv_quant, ps))
    for page, tree in zip(pages, parsed):
        for jlayer, layer in zip(page["layers"], tree["layers"]):
            for name, arr in jlayer.items():
                t = layer[name]
                want = {"bfloat16": torch.bfloat16, "int8": torch.int8,
                        "float32": torch.float32}[np.asarray(arr).dtype.name]
                assert t.dtype == want
                assert raw(t) == raw(arr), name


def test_page_wire_refuses_a_mismatched_store():
    tcfg, ps = tl.llama_tiny(), 16
    wire = json.loads(json.dumps([disagg.encode_page(
        port_page(tcfg, ps, False, 0))]))
    with pytest.raises(ValueError, match="keys"):
        disagg.parse_page_trees(wire, engine_view(tcfg, True, ps))
    f32 = tl.llama_tiny(dtype="float32")
    with pytest.raises(ValueError, match="expected"):
        disagg.parse_page_trees(wire, engine_view(f32, False, ps))


def test_forward_releases_only_after_a_parsed_success(model):
    co = coordinator(model)
    states = []
    co.prefill[0].handoff_fn = lambda req, st: states.append((req, st))
    try:
        req = co.submit(list(range(2, 30)), max_new_tokens=4)
        for _ in range(500):
            if states:
                break
            time.sleep(0.01)
        _, st = states[0]
        in_use = co.pool.stats()["in_use"]
        with pytest.raises(KeyError):
            disagg.forward_handoff(st, co.pool, "p:1", "llama",
                                   post_fn=lambda *a, **k: {"no": "ids"})
        assert not st.released and co.pool.stats()["in_use"] == in_use
        full = disagg.forward_handoff(
            st, co.pool, "p:1", "llama",
            post_fn=lambda *a, **k: {"ids": st.ids + [1, 2, 3]})
        assert st.released and full == st.ids + [1, 2, 3]
        disagg.complete_forwarded(req, full)
        assert req.result(1) == full
        assert co.stats()["kv_pool"]["orphan_pages"] == 0
    finally:
        co.shutdown()


def test_roles_are_validated(model):
    with pytest.raises(ValueError, match="role"):
        ContinuousBatcher(model, model.config, role="router")
    with pytest.raises(ValueError, match="handoff_fn"):
        ContinuousBatcher(model, model.config, role="prefill")
    with pytest.raises(ValueError, match="divide"):
        ContinuousBatcher(model, model.config, role="prefill", max_seq=60,
                          page_size=16, handoff_fn=lambda r, s: None)
    with pytest.raises(ValueError, match="divide"):
        DisaggCoordinator(model, model.config, max_seq=60, page_size=16)
    # the default colocated engine still holds no page rows
    eng = ContinuousBatcher(model, model.config)
    assert eng.pool.kv is None
    eng.shutdown()

