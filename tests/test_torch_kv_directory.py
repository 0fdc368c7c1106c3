"""The cluster prefix directory on the port, at tiny sizes.

``prefix_hashes`` is held to the reference's byte for byte; the
directory's advertise, lookup (longest full page, ``exclude``), withdraw
and drop follow the reference's cases (``tests/test_kv_tiers.py``).  Two
port engines share one directory, each the other's fetch source through
``export_prefix``: a remote hit imports the owner's pages bitwise and
its stream equals a cold engine's, greedy and seeded-ragged; an export
ships full pages from the host tier without faulting; the directory
follows drain and restart.  Last, two predictors over localhost HTTP
fetch through the ``:pages`` verb.

Tiny Llama at float32, weights made by flax from a seed and carried over
by ``from_jax_params``; streams are compared exactly.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.parallel.sharding import unbox_params
from kubeflow_tpu.serving import kv_directory as jdir
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.serving import predictor as tpred
from kubeflow_tpu_torch.serving.engine import ContinuousBatcher
from kubeflow_tpu_torch.serving.kv_directory import (DIRECTORY_HITS,
                                                     DIRECTORY_MISSES,
                                                     REMOTE_FETCHES,
                                                     PrefixDirectory,
                                                     prefix_hashes)
from kubeflow_tpu_torch.utils.metrics import REGISTRY

PROMPT = [5, 8, 13, 21, 3, 9, 2, 17, 11, 4, 6, 12, 25, 31, 7, 19,
          23, 29, 37, 41, 43, 47, 53, 59]        # 3 full pages at ps 8


@pytest.fixture(scope="module")
def state():
    cfg = jl.llama_tiny(dtype="float32")
    module = jl.LlamaModel(cfg)
    params = unbox_params(jax.jit(module.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    return convert.from_jax_params(jax.tree.map(np.asarray, params),
                                   tl.llama_tiny(dtype="float32"))


@pytest.fixture(scope="module")
def model(state):
    m = tl.LlamaModel(tl.llama_tiny(dtype="float32"), device="cpu")
    m.load_state_dict(state)
    return m.eval()


@pytest.fixture
def cluster(model):
    """Engines ``a`` and ``b`` over one directory, each fetching from the
    other's ``export_prefix``, and a cold engine without a cache."""
    directory = PrefixDirectory(page_size=8)
    engines = {}

    def fetch(entry, ids):
        return json.loads(json.dumps(
            engines[entry["engine_id"]].export_prefix(ids)))

    for name in ("a", "b"):
        engines[name] = ContinuousBatcher(
            model, model.config, max_batch=2, max_seq=96, page_size=8,
            prefix_cache_bytes=1 << 20, host_kv_pages=16,
            directory=directory, engine_id=name,
            engine_addr=f"local:{name}", fetch_fn=fetch)
    cold = ContinuousBatcher(model, model.config, max_batch=2, max_seq=96,
                             page_size=8)
    yield engines, directory, cold
    for e in (*engines.values(), cold):
        e.shutdown()


# -- hashes and the directory ----------------------------------------------------

@pytest.mark.parametrize("page", [1, 2, 4, 8, 16])
def test_prefix_hashes_equal_the_reference(page):
    rng = np.random.default_rng(page)
    for n in (0, 3, 16, 47, 64):
        toks = rng.integers(0, 32000, n).tolist()
        assert prefix_hashes(toks, page) == jdir.prefix_hashes(toks, page)


def test_prefix_hashes_chain_and_alignment():
    toks = list(range(1, 20))
    hs = prefix_hashes(toks, 4)
    assert len(hs) == 4                           # full pages only
    assert prefix_hashes(toks + [99, 98, 97, 96], 4)[:4] == hs
    assert prefix_hashes(toks[4:], 4)[0] != hs[1]  # chained from 0
    assert prefix_hashes(toks, 2)[1] != hs[0]      # page size seeds it
    assert prefix_hashes(toks[:3], 4) == []


def test_directory_advertise_lookup_withdraw_drop():
    d = PrefixDirectory(page_size=4)
    toks = list(range(1, 13))                     # 3 full pages
    h0, m0 = DIRECTORY_HITS.get(), DIRECTORY_MISSES.get()
    assert d.advertise("a", "host:1", toks) == 3
    hit = d.lookup(toks + [50, 51])
    assert hit["engine_id"] == "a" and hit["matched"] == 12
    assert hit["addr"] == "host:1" and hit["tier"] == "hbm"
    assert d.lookup(toks[:6])["matched"] == 4     # the longest FULL page
    assert d.lookup(toks, exclude="a") is None    # never routes to self
    assert d.lookup([7, 7, 7, 7]) is None
    assert DIRECTORY_HITS.get() - h0 == 2
    assert DIRECTORY_MISSES.get() - m0 == 2

    # the latest advertiser wins the contested hashes
    assert d.advertise("b", "host:2", toks[:8]) == 2
    assert d.lookup(toks)["engine_id"] == "a"     # page 3 still a's
    assert d.lookup(toks[:8])["engine_id"] == "b"
    assert d.stats() == {"entries": 3, "engines": 2, "page_size": 4}

    assert d.withdraw("a", toks) == 1             # the one hash a owns
    assert d.lookup(toks)["engine_id"] == "b"     # falls back to b's 8
    assert d.drop_engine("b") == 2
    assert d.lookup(toks) is None
    assert d.stats()["entries"] == 0
    assert REGISTRY.expose().count("serving_kv_directory_entries 0.0") == 1
    with pytest.raises(ValueError):
        PrefixDirectory(page_size=0)


# -- two engines, one directory ---------------------------------------------------

def test_remote_prefix_hit_stream_identical_to_cold(cluster):
    engines, directory, cold = cluster
    want = cold.generate_sync([PROMPT], max_new_tokens=8)[0]
    assert engines["a"].generate_sync([PROMPT], max_new_tokens=8)[0] == want
    assert directory.lookup(PROMPT)["engine_id"] == "a"
    f0 = REMOTE_FETCHES.get()
    # b's tree is cold: the directory points it at a, the pages ship, and
    # the stream does not move one token
    assert engines["b"].generate_sync([PROMPT], max_new_tokens=8)[0] == want
    assert engines["b"].stats()["remote_fetches"] == 1
    assert REMOTE_FETCHES.get() == f0 + 1
    # the imported pages are the owner's, bitwise
    a, b = engines["a"], engines["b"]
    pa, _ = a.prefix_cache.match(PROMPT)
    pb, _ = b.prefix_cache.match(PROMPT)
    for x, y in zip(pa.pages, pb.pages):
        ta, tb = a.pool.get(x)["layers"], b.pool.get(y)["layers"]
        for la, lb in zip(ta, tb):
            for name in ("k", "v"):
                assert np.array_equal(la[name].numpy(), lb[name].numpy())
    for e in engines.values():
        st = e.stats()
        assert st["prefix_cache"]["pinned"] == 0
        assert st["kv_pool"]["orphan_pages"] == 0


def test_remote_hit_seeded_ragged_cobatch_identical(cluster):
    engines, directory, cold = cluster
    a = PROMPT + [60, 61, 62]
    b = PROMPT + [70]
    kw = dict(max_new_tokens=8, temperature=1.3, seed=11, top_k=4)
    want = cold.generate_sync([a, b], **kw)
    engines["a"].generate_sync([PROMPT], max_new_tokens=2)  # a owns it
    # b decodes both rows together, seeded, off fetched pages
    assert engines["b"].generate_sync([a, b], **kw) == want
    assert engines["b"].stats()["remote_fetches"] >= 1


def test_export_ships_full_pages_from_host_tier(cluster):
    engines, directory, cold = cluster
    eng = engines["a"]
    eng.generate_sync([PROMPT], max_new_tokens=2)
    node, _ = eng.prefix_cache.match(PROMPT)
    want = [eng.pool.get(p)["layers"][0]["k"].clone() for p in node.pages]
    # push the cached prefix down to the host arena: the export serves
    # from host bytes, with no fault on the owner's side
    while eng.prefix_cache.spill_lru():
        pass
    assert eng.pool.stats()["host_pages"] >= 3
    faults_before = eng.pool.stats()["faults_total"]
    out = eng.export_prefix(PROMPT)
    assert out["matched"] == 24                   # full pages only
    assert len(out["pages"]) == 3
    assert eng.pool.stats()["faults_total"] == faults_before
    assert eng.export_prefix([101, 102]) == {"matched": 0, "pages": []}
    assert eng.export_prefix(PROMPT[:7]) == {"matched": 0, "pages": []}
    assert eng.stats()["prefix_cache"]["pinned"] == 0
    from kubeflow_tpu_torch.serving.disagg import parse_page_trees

    trees = parse_page_trees(out["pages"], eng)
    for tree, k in zip(trees, want):
        assert np.array_equal(tree["layers"][0]["k"].numpy(), k.numpy())


def test_directory_follows_drain_and_restart(cluster):
    engines, directory, cold = cluster
    eng = engines["a"]
    eng.generate_sync([PROMPT], max_new_tokens=2)
    assert directory.lookup(PROMPT) is not None

    eng.drain()
    assert eng.drained(timeout=30)
    assert directory.lookup(PROMPT, exclude="b") is None  # a withdrew

    eng.restart()                                 # pages survived the drain
    hit = directory.lookup(PROMPT, exclude="b")
    assert hit is not None and hit["engine_id"] == "a"
    assert eng.generate_sync([PROMPT], max_new_tokens=8)[0] == \
        cold.generate_sync([PROMPT], max_new_tokens=8)[0]
    eng.shutdown()
    assert directory.lookup(PROMPT, exclude="b") is None
    eng.restart()
    assert directory.lookup(PROMPT, exclude="b")["engine_id"] == "a"


def test_eviction_withdraws_and_a_stale_entry_falls_back(model):
    """An evicted prefix leaves the directory; an entry whose owner no
    longer holds the pages costs a fetch that returns nothing, and the
    stream is the cold one."""
    directory = PrefixDirectory(page_size=8)
    owner = ContinuousBatcher(model, model.config, max_batch=2, max_seq=96,
                              page_size=8, prefix_cache_bytes=1 << 20,
                              directory=directory, engine_id="owner")
    calls = []

    def fetch(entry, ids):
        calls.append(len(ids))
        return {"matched": 0, "pages": []}        # the owner revalidated

    asker = ContinuousBatcher(model, model.config, max_batch=2, max_seq=96,
                              page_size=8, prefix_cache_bytes=1 << 20,
                              directory=directory, engine_id="asker",
                              fetch_fn=fetch)
    cold = ContinuousBatcher(model, model.config, max_batch=2, max_seq=96,
                             page_size=8)
    try:
        owner.generate_sync([PROMPT], max_new_tokens=2)
        assert directory.lookup(PROMPT)["engine_id"] == "owner"
        while owner.prefix_cache.evict_lru():
            pass
        assert directory.lookup(PROMPT, exclude="asker") is None
        directory.advertise("owner", "gone:1", PROMPT)    # a stale entry
        want = cold.generate_sync([PROMPT], max_new_tokens=6)
        assert asker.generate_sync([PROMPT], max_new_tokens=6) == want
        assert calls == [24] and asker.stats()["remote_fetches"] == 0
    finally:
        for e in (owner, asker, cold):
            e.shutdown()


def test_predictors_fetch_through_the_pages_verb(state):
    """Two predictors on localhost, one directory: the second's miss
    fetches the first's pages over HTTP (``:pages``)."""
    from kubeflow_tpu_torch.serving.httpserve import serve

    directory = PrefixDirectory(page_size=8)
    preds, servers = {}, {}
    for name in ("p0", "p1"):
        # bind first: the engine advertises its own address
        srv = serve(None, 0)
        port = srv[0].server_port
        preds[name] = tpred.GenerativePredictor(
            "llama", size="tiny", model_config={"dtype": "float32"},
            state=state, max_batch=2, max_seq=96, prefix_cache_mb=1,
            kv_page_size=8, directory=directory, engine_id=name,
            engine_addr=f"127.0.0.1:{port}", device="cpu")
        srv[0].set_app(tpred.PredictorApp({"llama": preds[name]}))
        servers[name] = srv
    cold = tpred.GenerativePredictor(
        "llama", size="tiny", model_config={"dtype": "float32"},
        state=state, max_batch=2, max_seq=96, device="cpu")
    try:
        want = cold.generate([PROMPT + [3]], max_new_tokens=6)["ids"]
        assert preds["p0"].generate([PROMPT], max_new_tokens=2)
        got = preds["p1"].generate([PROMPT + [3]], max_new_tokens=6)["ids"]
        assert got == want
        assert preds["p1"].engine.stats()["remote_fetches"] == 1
    finally:
        for httpd, thread in servers.values():
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=10)
        for p in (*preds.values(), cold):
            p.stop(timeout=30)
