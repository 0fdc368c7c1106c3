"""The port's ``PagePool`` and ``PrefixCache`` against the reference's.

Each scenario is one sequence of calls written once and driven on both
sides: the reference's pool stores a tree of jax arrays per page id, the
port's stores rows of ``init_kv_pool``'s per-layer tensors, and the pages
hold the same numpy-made values.  After every call the two sides must
agree on its result (page ids, refcounts, ``ValueError`` or not), on
``stats()`` (the fault wait's seconds aside: a host time; and the port's
``device_rows``), ``free_count``,
``host_count``, and each page's ``tier``.  Pages read back through
``get`` must hold the same bytes on both sides, and a spill-fault round
trip must not move a bit, in float32 and bfloat16.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from kubeflow_tpu.serving import page_pool as jpp
from kubeflow_tpu.serving import prefix_cache as jpc
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.serving import page_pool as tpp
from kubeflow_tpu_torch.serving import prefix_cache as tpc

PS = 2          # tokens per page in these tests
HKV, D = 2, 4   # page payload [PS, HKV, D] per layer and tensor
LAYERS = 2


def page_values(page: int, dtype: str) -> list[dict]:
    """The numpy k/v a page holds, per layer, made from its id."""
    rng = np.random.default_rng(page)
    out = []
    for _ in range(LAYERS):
        kv = {}
        for name in ("k", "v"):
            x = rng.standard_normal((PS, HKV, D)).astype(np.float32)
            kv[name] = (x.astype(ml_dtypes.bfloat16) if dtype == "bfloat16"
                        else x)
        out.append(kv)
    return out


def as_bytes(tree) -> list[bytes]:
    out = []
    for layer in tree["layers"]:
        for name in ("k", "v"):
            x = layer[name]
            if isinstance(x, torch.Tensor):
                x = x.contiguous()
                if x.dtype == torch.bfloat16:
                    x = x.view(torch.int16)
                out.append(x.numpy().tobytes())
            else:
                out.append(np.asarray(x).tobytes())
    return out


class Side:
    """One implementation's pool and cache constructors and page trees."""

    def __init__(self, name: str, dtype: str = "float32"):
        self.name, self.dtype = name, dtype

    def pool(self, num_pages, host_pages=0):
        if self.name == "reference":
            return jpp.PagePool(num_pages, PS, page_nbytes=64,
                                host_pages=host_pages)
        cfg = tl.LlamaConfig(num_layers=LAYERS, hidden_size=HKV * D,
                             num_heads=HKV, num_kv_heads=HKV, dtype=self.dtype)
        return tpp.PagePool(num_pages, PS, page_nbytes=64,
                            host_pages=host_pages,
                            kv=tl.init_kv_pool(cfg, num_pages, PS,
                                               device="cpu"))

    def cache(self, pool, max_pages):
        mod = jpc if self.name == "reference" else tpc
        return mod.PrefixCache(pool, max_pages)

    def tree(self, page):
        layers = page_values(page, self.dtype)
        if self.name == "reference":
            return {"layers": [{n: jnp.asarray(x) for n, x in l.items()}
                               for l in layers]}
        return {"layers": [{n: torch.from_numpy(
            x.view(np.int16)).view(torch.bfloat16)
            if x.dtype == ml_dtypes.bfloat16 else torch.from_numpy(x)
            for n, x in l.items()} for l in layers]}


class Log:
    """Calls made through ``do`` and what each returned, with the pool's
    observable state after it."""

    def __init__(self, pool):
        self.pool, self.rows = pool, []

    def do(self, obj, method, *args):
        try:
            out = getattr(obj, method)(*args)
        except ValueError:
            out = "ValueError"
        self.note(method, out)
        return out

    def note(self, what, value):
        st = dict(self.pool.stats())
        st["fault_wait_seconds"] = st["fault_wait_seconds"]["count"]
        # the port's row tensors (no counterpart in the reference's store)
        st.pop("device_rows", None)
        self.rows.append((what, value, st, self.pool.free_count,
                          self.pool.host_count,
                          [(p, self.pool.refcount(p), self.pool.tier(p))
                           for p in range(self.pool.num_pages
                                          + self.pool.host_pages)]))


# -- PagePool scenarios (tests/test_prefix_cache.py, test_kv_tiers.py) --------
def pool_refcount_guards(side):
    pool = side.pool(8)
    log = Log(pool)
    ids = log.do(pool, "alloc", 2)
    log.do(pool, "decref", [7])              # a free id
    log.do(pool, "incref", [0])              # the null page: no-op
    log.do(pool, "decref", [0])
    log.do(pool, "decref", ids)
    log.do(pool, "decref", ids)              # double free
    log.do(pool, "incref", ids)              # incref of a free page
    log.do(pool, "alloc", 99)                # over-ask fails whole
    log.do(pool, "alloc", 0)
    log.note("null refcount", pool.refcount(0))
    return log.rows


def pool_lifo_and_budget(side):
    pool = side.pool(5)
    log = Log(pool)
    a = log.do(pool, "alloc", 3)
    log.do(pool, "decref", [a[1]])
    log.do(pool, "alloc", 1)                 # the freed id comes back
    log.do(pool, "alloc", 2)                 # 1 slot left: refused
    b = log.do(pool, "alloc", 1)
    log.do(pool, "incref", b + a[:1])
    log.do(pool, "decref", a + b)
    log.do(pool, "alloc", 1)
    return log.rows


def pool_spill_fault_roundtrip(side):
    pool = side.pool(4, host_pages=4)
    log = Log(pool)
    ids = log.do(pool, "alloc", 2)
    for p in ids:
        pool.put(p, side.tree(p))
    log.note("put", None)
    log.note("bytes", [as_bytes(pool.get(p)) for p in ids])
    log.do(pool, "spill", ids)
    log.note("host bytes", [as_bytes(pool.get(p)) for p in ids])
    log.do(pool, "spill", ids)               # already host: skipped
    log.do(pool, "fault", ids)
    log.note("faulted bytes", [as_bytes(pool.get(p)) for p in ids])
    log.do(pool, "decref", ids)
    return log.rows


def pool_spill_caps_arena(side):
    pool = side.pool(4, host_pages=2)        # 3 device slots, 2 host
    log = Log(pool)
    ids = log.do(pool, "alloc", 3)
    for p in ids:
        pool.put(p, side.tree(p))
    log.do(pool, "alloc", 1)                 # device budget exhausted
    moved = log.do(pool, "spill", ids)       # the arena caps at 2
    extra = log.do(pool, "alloc", 2)         # spilling freed device slots
    for p in extra:
        pool.put(p, side.tree(10 + p))
    log.do(pool, "fault", moved)             # never refused, over budget
    log.note("bytes", [as_bytes(pool.get(p)) for p in ids + extra])
    log.do(pool, "decref", ids)
    log.do(pool, "alloc", 2)
    log.do(pool, "decref", extra)
    return log.rows


def pool_spill_skips_uncommitted_and_free(side):
    pool = side.pool(4, host_pages=4)
    log = Log(pool)
    ids = log.do(pool, "alloc", 2)
    log.do(pool, "spill", ids)               # nothing committed yet
    pool.put(ids[0], side.tree(1))
    log.do(pool, "decref", [ids[1]])
    log.do(pool, "spill", ids)               # the freed id is skipped
    log.do(pool, "decref", [ids[0]])         # frees the host slot
    again = log.do(pool, "alloc", 2)
    for p in again:
        pool.put(p, side.tree(20 + p))
    log.do(pool, "spill", again)
    log.note("bytes", [as_bytes(pool.get(p)) for p in again])
    log.do(pool, "fault", again[:1])
    log.do(pool, "decref", again)
    return log.rows


def pool_without_host_arena(side):
    pool = side.pool(4)
    log = Log(pool)
    ids = log.do(pool, "alloc", 2)
    pool.put(ids[0], side.tree(9))
    log.do(pool, "spill", ids)               # no arena: a no-op
    log.do(pool, "fault", ids)
    log.do(pool, "decref", ids)
    return log.rows


POOL_SCENARIOS = [pool_refcount_guards, pool_lifo_and_budget,
                  pool_spill_fault_roundtrip, pool_spill_caps_arena,
                  pool_spill_skips_uncommitted_and_free,
                  pool_without_host_arena]


@pytest.mark.parametrize("scenario", POOL_SCENARIOS,
                         ids=lambda f: f.__name__)
def test_page_pool_matches_reference(scenario):
    want = scenario(Side("reference"))
    got = scenario(Side("port"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w, (g[0], w[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spill_fault_round_trip_is_bitwise(dtype):
    side = Side("port", dtype)
    pool = side.pool(6, host_pages=3)
    ids = pool.alloc(4)
    for p in ids:
        pool.put(p, side.tree(p))
    want = {p: as_bytes(side.tree(p)) for p in ids}
    assert pool.spill(ids) == ids[:3]
    # a fresh page takes a freed row: the rows are reused, not the data
    (other,) = pool.alloc(1)
    pool.put(other, side.tree(50))
    assert pool.fault(ids) == 3
    for p in ids:
        assert pool.tier(p) == "hbm"
        assert as_bytes(pool.get(p)) == want[p]
    assert as_bytes(pool.get(other)) == as_bytes(side.tree(50))
    # the same bytes as the reference's pool holds for the same pages
    ref = Side("reference", dtype)
    assert [as_bytes(ref.tree(p)) for p in ids] == [want[p] for p in ids]


def test_gather_and_put_many_match_a_loop_over_pages():
    side = Side("port", "bfloat16")
    pool = side.pool(8)
    ids = pool.alloc(3)
    g = torch.Generator().manual_seed(0)
    src = [tuple(torch.randn(3 * PS, HKV, D, generator=g).bfloat16()
                 for _ in range(2)) for _ in range(LAYERS)]
    pool.put_many(ids, src)
    for i, p in enumerate(ids):
        for layer, (k, v) in zip(pool.get(p)["layers"], src):
            assert torch.equal(layer["k"], k[i * PS:(i + 1) * PS])
            assert torch.equal(layer["v"], v[i * PS:(i + 1) * PS])
    order = [ids[2], ids[0], ids[2]]
    out = [tuple(torch.empty(3 * PS, HKV, D, dtype=torch.bfloat16)
                 for _ in range(2)) for _ in range(LAYERS)]
    pool.gather(order, out)
    for (k, v), layer_src in zip(out, src):
        for i, p in enumerate(order):
            j = ids.index(p)
            assert torch.equal(k[i * PS:(i + 1) * PS],
                               layer_src[0][j * PS:(j + 1) * PS])
            assert torch.equal(v[i * PS:(i + 1) * PS],
                               layer_src[1][j * PS:(j + 1) * PS])


# -- PrefixCache scenarios ----------------------------------------------------
def insert(side, pool, pc, tokens, log):
    n = -(-len(tokens) // PS)
    ids = pool.alloc(n)
    for p in ids:
        pool.put(p, side.tree(p))
    log.note("insert", (pc.insert(tokens, ids), ids))
    pool.decref(ids)
    return ids


def matched(pc, tokens, log, pin=False):
    node, usable = pc.match(tokens, pin=pin)
    log.note("match", (usable, None if node is None
                       else (node.length, tuple(node.pages or ()))))
    return node


def cache_state(pc, log):
    log.note("cache", (pc.stats(), sorted(pc.cached_prefixes())))


def cache_edge_splits(side):
    pool = side.pool(64)
    pc = side.cache(pool, 1 << 20)
    log = Log(pool)
    insert(side, pool, pc, (1, 2, 3, 4), log)
    insert(side, pool, pc, (1, 2, 5, 6), log)     # splits (1, 2, 3, 4)
    for toks in [(1, 2, 3, 4), (1, 2, 3, 9, 9), (1, 2, 5, 6, 7, 8), (1, 2),
                 (9, 9)]:
        matched(pc, toks, log)
    cache_state(pc, log)
    return log.rows


def cache_covering_node_and_ancestor(side):
    pool = side.pool(64)
    pc = side.cache(pool, 1 << 20)
    log = Log(pool)
    insert(side, pool, pc, (7, 8), log)
    insert(side, pool, pc, (7, 8, 9, 10), log)
    node = matched(pc, (7, 8, 9, 10, 11), log)
    pc._drop(node)                                 # the ancestor serves 2
    matched(pc, (7, 8, 9, 10, 11), log)
    cache_state(pc, log)
    return log.rows


def cache_shares_by_reference(side):
    pool = side.pool(64)
    pc = side.cache(pool, 1 << 20)
    log = Log(pool)
    a = insert(side, pool, pc, (1, 2, 3, 4), log)
    new = pool.alloc(1)
    pool.put(new[0], side.tree(new[0]))
    log.note("insert", pc.insert((1, 2, 3, 4, 5, 6), list(a) + new))
    pool.decref(new)
    cache_state(pc, log)
    pc._drop(matched(pc, (1, 2, 3, 4), log))       # the short prefix goes
    cache_state(pc, log)
    pc._drop(matched(pc, (1, 2, 3, 4, 5, 6), log))
    cache_state(pc, log)
    return log.rows


def cache_lru_under_budget(side):
    pool = side.pool(64)
    pc = side.cache(pool, 4)                       # two 2-page prefixes
    log = Log(pool)
    insert(side, pool, pc, (1, 1, 1), log)
    insert(side, pool, pc, (2, 2, 2), log)
    matched(pc, (1, 1, 1), log)                    # (1,1,1) most recent
    insert(side, pool, pc, (3, 3, 3), log)         # evicts (2,2,2)
    for toks in [(2, 2, 2), (1, 1, 1), (3, 3, 3)]:
        matched(pc, toks, log)
    cache_state(pc, log)
    return log.rows


def cache_pinned_survives(side):
    pool = side.pool(64)
    pc = side.cache(pool, 2)                       # one prefix
    log = Log(pool)
    insert(side, pool, pc, (1, 1, 1), log)
    node = matched(pc, (1, 1, 1), log, pin=True)
    insert(side, pool, pc, (2, 2, 2), log)         # cannot evict the pin
    cache_state(pc, log)
    log.note("evict_lru", pc.evict_lru())
    log.note("pinned pages", node.pages)
    pc.release(node)
    pc.release(node)                               # a second release: no-op
    insert(side, pool, pc, (3, 3, 3), log)         # back to budget
    matched(pc, (1, 1, 1), log)
    cache_state(pc, log)
    return log.rows


def cache_oversize_and_duplicate(side):
    pool = side.pool(64)
    log = Log(pool)
    small = side.cache(pool, 1)
    insert(side, pool, small, (1, 2, 3), log)      # 2 pages > budget 1
    pc = side.cache(pool, 1 << 20)
    insert(side, pool, pc, (4, 5, 6), log)
    insert(side, pool, pc, (4, 5, 6), log)         # a refresh, not a copy
    log.note("empty insert", pc.insert((), []))
    cache_state(pc, log)
    cache_state(small, log)
    return log.rows


def cache_spill_lru_and_fault(side):
    pool = side.pool(10, host_pages=8)
    pc = side.cache(pool, 8)
    log = Log(pool)
    pa = insert(side, pool, pc, (1, 2, 3, 4), log)
    insert(side, pool, pc, (9, 8, 7, 6), log)
    matched(pc, (9, 8, 7, 6), log)                 # (1,2,3,4) is now LRU
    log.note("spill_lru", pc.spill_lru())
    cache_state(pc, log)
    node = matched(pc, (1, 2, 3, 4), log, pin=True)
    log.note("fault", pc.fault(node))
    pc.release(node)
    log.note("bytes", [as_bytes(pool.get(p)) for p in pa])
    cache_state(pc, log)
    return log.rows


def cache_pinned_and_seed_held_never_spill(side):
    pool = side.pool(10, host_pages=8)
    pc = side.cache(pool, 8)
    log = Log(pool)
    pa = insert(side, pool, pc, (1, 2, 3, 4), log)
    node = matched(pc, (1, 2, 3, 4), log, pin=True)
    log.note("spill_lru pinned", pc.spill_lru())
    log.note("evict_lru pinned", pc.evict_lru())
    pc.release(node)
    pool.incref(pa)                                # a seed still reads them
    log.note("spill_lru held", pc.spill_lru())
    pool.decref(pa)
    log.note("spill_lru", pc.spill_lru())
    cache_state(pc, log)
    return log.rows


def cache_spills_before_dropping(side):
    pool = side.pool(10, host_pages=2)
    pc = side.cache(pool, 2)                       # 2 device cache pages
    log = Log(pool)
    insert(side, pool, pc, (1, 2, 3, 4), log)
    insert(side, pool, pc, (5, 6, 7, 8), log)      # spills (1, 2, 3, 4)
    cache_state(pc, log)
    insert(side, pool, pc, (9, 10, 11, 12), log)   # arena full: drops
    cache_state(pc, log)
    for toks in [(1, 2, 3, 4), (5, 6, 7, 8), (9, 10, 11, 12)]:
        matched(pc, toks, log)
    return log.rows


CACHE_SCENARIOS = [cache_edge_splits, cache_covering_node_and_ancestor,
                   cache_shares_by_reference, cache_lru_under_budget,
                   cache_pinned_survives, cache_oversize_and_duplicate,
                   cache_spill_lru_and_fault,
                   cache_pinned_and_seed_held_never_spill,
                   cache_spills_before_dropping]


@pytest.mark.parametrize("scenario", CACHE_SCENARIOS,
                         ids=lambda f: f.__name__)
def test_prefix_cache_matches_reference(scenario):
    ev = (jpc.EVICTIONS_TOTAL.get(), tpc.EVICTIONS_TOTAL.get())
    want = scenario(Side("reference"))
    got = scenario(Side("port"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w, (g[0], w[0])
    assert (tpc.EVICTIONS_TOTAL.get() - ev[1]
            == jpc.EVICTIONS_TOTAL.get() - ev[0])
