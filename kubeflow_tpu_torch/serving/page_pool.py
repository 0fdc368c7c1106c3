"""Tiered KV page pool: refcounted ids over device rows and a host-RAM
spill arena.

Counterpart of ``kubeflow_tpu/serving/page_pool.py``.  Prompt KV is cut
into fixed-size PAGES (``page_size`` token positions, every layer) and
every holder (the prefix cache's radix tree, an admission's seed) holds
page IDS into one shared pool:

- a page is a refcounted unit: a page frees when its last holder drops
  it; pages are immutable once committed (decode state lives in the
  engine's resident view);
- the allocator is host bookkeeping: the null page 0, a LIFO free list,
  and ``num_pages`` as the device (HBM) budget that ``alloc`` enforces,
  handing out all of a request or nothing;
- the id space is ``num_pages + host_pages`` wide: ``spill`` moves a
  committed page's KV into a bounded host-RAM arena and frees its device
  slot while the id and its refcount stay; ``fault`` brings it back.
  Faults are never refused (a seed already holds references), so device
  residency may pass the budget for a while; the next ``alloc`` under
  pressure spills or evicts it back down;
- ``donate``/``reclaim`` move the budget for the weight-residency pool:
  an evicted model's bytes become page slots, and a warming model takes
  back only free ones.

The semantics (which ids ``alloc`` hands out, when it refuses, the
counters) are the reference's; the storage differs.  The reference keeps
one tree of per-layer arrays per page id.  Here the device store is
``init_kv_pool``'s layout, allocated once: per layer one
``[rows, page, Hkv, D]`` k tensor and one v tensor, ``rows`` = the budget
``num_pages``; a device-resident page id maps to a row (row 0 is the null
page's).  An int8 store (``init_kv_pool(..., quantized=True)``) holds two
more tensors per layer, the scales ``ks``/``vs`` ``[rows, 1, Hkv, 1]``;
every operation below runs over whichever tensors the layer's store
holds, by name.  Commits (``put``/``put_many``) and seeds (``gather``)
are one scatter or gather per layer and tensor over the page ids' rows.  A spill copies a
row of every layer into a preallocated host arena (pinned on CUDA) and
frees the row; a fault takes a free row, copies the data back and remaps
the id.  A fault with no free row (residency over the budget) grows the
row tensors.  A pool made without ``kv`` holds no storage and does the
bookkeeping alone (the engine without a prefix cache).

Ordering: every copy is issued on the caller's current stream, so a row
freed by a spill is rewritten only after the spill's copy has read it, and
a seed's gather reads a faulted row only after the fault's copy has
landed.  A spilled page's host tensors are read on the host only through
``get``, which waits for the spill's copy first.

Thread-safety: the engine's batcher thread is the only writer; ``stats()``
is read from other threads, so a lock keeps the bookkeeping consistent,
and device copies are issued outside it.
"""

from __future__ import annotations

import threading
import time

import torch

from kubeflow_tpu_torch.utils.metrics import REGISTRY

PAGES_CAPACITY = REGISTRY.gauge(
    "serving_kv_pages_capacity",
    "allocatable KV pages in the device pool (excludes the null page)")
PAGES_FREE = REGISTRY.gauge(
    "serving_kv_pages_free",
    "HBM page slots currently unoccupied")
HBM_PAGES = REGISTRY.gauge(
    "serving_kv_hbm_pages",
    "allocated KV pages resident in the device (HBM) tier")
HOST_PAGES = REGISTRY.gauge(
    "serving_kv_host_pages",
    "allocated KV pages spilled to the host-RAM arena")
SPILLS_TOTAL = REGISTRY.counter(
    "serving_kv_spills_total",
    "KV pages spilled from HBM to the host-RAM arena")
FAULTS_TOTAL = REGISTRY.counter(
    "serving_kv_faults_total",
    "KV pages faulted back from the host-RAM arena to HBM")
FAULT_WAIT = REGISTRY.histogram(
    "serving_kv_fault_wait_seconds",
    "host time a prefix-hit seed spent issuing the faults of spilled "
    "pages")

NULL_PAGE = 0


class PagePool:
    """Refcounted allocator over ``num_pages + host_pages`` page ids, with
    the device rows and host slots that hold each committed page's
    per-layer k/v.

    ``kv``: the device store, ``init_kv_pool(cfg, rows, page_size)`` with
    ``rows >= num_pages``; None for a pool without storage."""

    def __init__(self, num_pages: int, page_size: int, page_nbytes: int = 0,
                 host_pages: int = 0, *, kv: dict | None = None):
        if num_pages < 2:
            raise ValueError("pool needs >= 2 pages (one is the null page)")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        if host_pages < 0:
            raise ValueError("host_pages must be >= 0")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.page_nbytes = int(page_nbytes)  # all-layer bytes, for stats
        self.host_pages = int(host_pages)    # host-RAM arena budget
        self._ids = self.num_pages + self.host_pages
        self._lock = threading.Lock()
        # page 0 is the null page: permanently "allocated", never handed
        # out (the page-table convention of models/llama.py)
        self._refs = [0] * self._ids
        self._refs[NULL_PAGE] = 1
        self._free = list(range(self._ids - 1, NULL_PAGE, -1))
        self._row: dict[int, int] = {NULL_PAGE: 0}  # device-tier id -> row
        self._free_rows = list(range(self.num_pages - 1, 0, -1))
        self._nrows = self.num_pages
        self._committed: set[int] = set()     # device ids holding KV
        self._host: dict[int, int] = {}       # spilled id -> arena slot
        self._spill_done: dict[int, torch.cuda.Event] = {}
        self._free_slots = list(range(self.host_pages - 1, -1, -1))
        self._live = 0                        # allocated ids (either tier)
        self._spills = 0
        self._faults = 0
        self._fault_wait_count = 0
        self._fault_wait_sum = 0.0
        self.kv = kv
        self._arena = None
        if kv is not None:
            k0 = kv["layers"][0]["k"]
            if k0.shape[0] < self.num_pages or k0.shape[1] != page_size:
                raise ValueError(
                    f"kv store {tuple(k0.shape)} has fewer than "
                    f"{self.num_pages} rows of {page_size} positions")
            self._nrows = k0.shape[0]
            self._free_rows = list(range(self._nrows - 1, 0, -1))
            if self.host_pages:
                pin = k0.device.type == "cuda"
                self._arena = [
                    {name: torch.empty((self.host_pages,)
                                       + tuple(t.shape[1:]), dtype=t.dtype,
                                       pin_memory=pin)
                     for name, t in layer.items()}
                    for layer in kv["layers"]]
        PAGES_CAPACITY.set(float(self.num_pages - 1))
        PAGES_FREE.set(float(self.num_pages - 1))
        HBM_PAGES.set(0.0)
        HOST_PAGES.set(0.0)

    # -- tier accounting (caller holds the lock) -------------------------------
    def _hbm_used(self) -> int:
        return self._live - len(self._host)

    def _publish_locked(self) -> None:
        PAGES_FREE.set(float(self.num_pages - 1 - self._hbm_used()))
        HBM_PAGES.set(float(self._hbm_used()))
        HOST_PAGES.set(float(len(self._host)))

    def _take_row_locked(self) -> int:
        if self._free_rows:
            return self._free_rows.pop()
        self._nrows += 1                      # a fault past the budget
        return self._nrows - 1

    def _rows(self, pages) -> torch.Tensor:
        with self._lock:
            rows = [self._row[p] for p in pages]
        # no stream sync: the copy needs no wait for queued device work
        return torch.tensor(rows, dtype=torch.int64).to(
            self.kv["layers"][0]["k"].device, non_blocking=True)

    def _grow(self) -> None:
        """Extend the row tensors to ``_nrows`` (faults past the budget,
        donations), one layer and tensor at a time; new rows are written
        by a commit or a fault before anything reads them."""
        for layer in self.kv["layers"]:
            for name, t in list(layer.items()):
                if t.shape[0] < self._nrows:
                    grown = t.new_empty((self._nrows,) + tuple(t.shape[1:]))
                    grown[:t.shape[0]].copy_(t)
                    layer[name] = grown

    def _need_kv(self) -> None:
        if self.kv is None:
            raise ValueError("this page pool holds no device storage")

    # -- device store ----------------------------------------------------------
    @property
    def quantized(self) -> bool:
        """Whether the store holds int8 pages with their scales."""
        return self.kv is not None and "ks" in self.kv["layers"][0]

    def put(self, page: int, tree: dict) -> None:
        """Commit an allocated page's per-layer tensors (``{"layers":
        [{"k": [page, Hkv, D], "v": ...}]}``, plus ``ks``/``vs`` ``[1,
        Hkv, 1]`` for an int8 store) into its device row."""
        self.put_many([page], [{name: t[None] for name, t in l.items()}
                               for l in tree["layers"]])

    def put_many(self, pages: list[int], layers) -> None:
        """Commit allocated pages: ``layers`` holds per layer the tensors
        of the layer's store by name (or a (k, v) pair for a model-dtype
        store) covering the pages in order, each ``[n * rows_of_one,
        ...]`` or ``[n, ...]``; one scatter per layer and tensor."""
        self._need_kv()
        with self._lock:
            for p in pages:
                if self._refs[p] <= 0:
                    raise ValueError(f"put on free page {p}")
                if p in self._host:
                    raise ValueError(f"put on spilled page {p}")
        rows = self._rows(pages)
        n = len(pages)
        for dst, src in zip(self.kv["layers"], layers):
            src = _by_name(dst, src)
            for name, t in src.items():
                dst[name].index_copy_(
                    0, rows, t.reshape((n,) + tuple(dst[name].shape[1:])))
        with self._lock:
            self._committed.update(pages)

    def gather(self, pages: list[int], out) -> None:
        """Copy committed device pages into ``out``: per layer the
        store's tensors by name (or a (k, v) pair) as contiguous
        destinations, ``[n * page, Hkv, D]`` for k and v (the seed of a
        prefill scratch); one gather per layer and tensor."""
        self._need_kv()
        with self._lock:
            for p in pages:
                if p not in self._committed:
                    raise ValueError(f"page {p} holds no device KV")
        rows = self._rows(pages)
        n = len(pages)
        for src, dst_layer in zip(self.kv["layers"], out):
            for name, dst in _by_name(src, dst_layer).items():
                torch.index_select(
                    src[name], 0, rows,
                    out=dst.view((n,) + tuple(src[name].shape[1:])))

    def get(self, page: int) -> dict:
        """The page's per-layer tensors (``k``/``v``, and ``ks``/``vs`` in an
        int8 store) from whichever tier holds it: views of
        its device row, or of its host arena slot once the spill's copy
        has landed.  Views stay valid until the page frees or moves."""
        self._need_kv()
        with self._lock:
            if page in self._host:
                slot = self._host[page]
                done = self._spill_done.get(page)
                src, at = self._arena, slot
            elif page in self._committed:
                done, src, at = None, self.kv["layers"], self._row[page]
            else:
                raise KeyError(page)
        if done is not None:
            done.synchronize()
        return {"layers": [{name: t[at] for name, t in l.items()}
                           for l in src]}

    # -- allocation ------------------------------------------------------------
    def alloc(self, n: int) -> list[int] | None:
        """Take ``n`` pages (each born with refcount 1, device-resident);
        None when the free id list OR the HBM budget cannot cover the
        request (caller spills/evicts or waits; partial allocations are
        never handed out)."""
        if n <= 0:
            return []
        with self._lock:
            if len(self._free) < n:
                return None
            if self._hbm_used() + n > self.num_pages - 1:
                return None
            pages = [self._free.pop() for _ in range(n)]
            for p in pages:
                self._refs[p] = 1
                self._row[p] = self._take_row_locked()
            self._live += n
            self._publish_locked()
            return pages

    def incref(self, pages: list[int]) -> None:
        """Add a holder to already-allocated pages (prefix sharing)."""
        with self._lock:
            for p in pages:
                if p == NULL_PAGE:
                    continue
                if self._refs[p] <= 0:
                    raise ValueError(f"incref of free page {p}")
                self._refs[p] += 1

    def decref(self, pages: list[int]) -> None:
        """Drop a holder; a page returns to the free list at refcount 0,
        and its row or arena slot with it."""
        with self._lock:
            for p in pages:
                if p == NULL_PAGE:
                    continue
                if self._refs[p] <= 0:
                    raise ValueError(f"decref of free page {p}")
                self._refs[p] -= 1
                if self._refs[p] == 0:
                    self._free.append(p)
                    self._live -= 1
                    self._committed.discard(p)
                    if p in self._host:
                        self._free_slots.append(self._host.pop(p))
                        self._spill_done.pop(p, None)
                    else:
                        self._free_rows.append(self._row.pop(p))
            self._publish_locked()

    # -- tier movement ---------------------------------------------------------
    def spill(self, pages: list[int]) -> list[int]:
        """Move committed device pages to the host-RAM arena; returns the
        ids actually spilled.  A page is skipped when it is the null
        page, holds no committed KV, is already host-resident, or the
        arena is full.  The CALLER enforces the safety rule (only
        cache-cold, unpinned pages whose sole holders are radix nodes)."""
        with self._lock:
            moves = []
            room = self.host_pages - len(self._host)
            for p in dict.fromkeys(pages):
                if p == NULL_PAGE or p in self._host:
                    continue
                if self._refs[p] <= 0 or p not in self._committed:
                    continue
                if len(moves) >= room:
                    break
                moves.append((p, self._row[p], self._free_slots.pop()))
        if not moves:
            return []
        done = None
        for src, dst in zip(self.kv["layers"], self._arena):
            for name in src:
                for _, row, slot in moves:
                    dst[name][slot].copy_(src[name][row], non_blocking=True)
        device = self.kv["layers"][0]["k"].device
        if device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(device))
        with self._lock:
            for p, row, slot in moves:
                self._committed.discard(p)
                self._free_rows.append(self._row.pop(p))
                self._host[p] = slot
                if done is not None:
                    self._spill_done[p] = done
            self._spills += len(moves)
            SPILLS_TOTAL.inc(len(moves))
            self._publish_locked()
        return [p for p, _, _ in moves]

    def fault(self, pages: list[int]) -> int:
        """Fault spilled pages back to the device tier; returns how many
        moved.  Never refused: the caller (a prefix-hit seed) already
        holds references and must proceed; device residency may pass the
        budget, and a fault with no free row grows the row tensors."""
        t0 = time.perf_counter()
        with self._lock:
            moves = [(p, self._host[p], self._take_row_locked())
                     for p in dict.fromkeys(pages) if p in self._host]
        if not moves:
            return 0
        if self.kv["layers"][0]["k"].shape[0] < self._nrows:
            self._grow()
        for src, dst in zip(self._arena, self.kv["layers"]):
            for name in src:
                for _, slot, row in moves:
                    dst[name][row].copy_(src[name][slot], non_blocking=True)
        with self._lock:
            for p, slot, row in moves:
                del self._host[p]
                self._spill_done.pop(p, None)
                self._free_slots.append(slot)
                self._row[p] = row
                self._committed.add(p)
            wait = time.perf_counter() - t0
            self._faults += len(moves)
            self._fault_wait_count += 1
            self._fault_wait_sum += wait
            FAULTS_TOTAL.inc(len(moves))
            FAULT_WAIT.observe(wait)
            self._publish_locked()
        return len(moves)

    # -- budget donation (weight residency arbitration) ------------------------
    def donate(self, n: int) -> None:
        """Grow the HBM page budget by ``n`` slots: the weight-residency
        pool (``serving/model_pool.py``) evicted a cold model's weights
        and turns the freed bytes into KV page capacity.  New ids extend
        the id space and go to the front of the LIFO free list, so the
        donated slots hand out first.  A pool with storage first reuses
        the rows that back no page of the budget (those a reclaim left
        reserved, or a fault past the budget added) and grows every
        layer's row tensors only by the rest (``_grow``: one layer and
        tensor at a time, so the transient is one old tensor beside its
        grown copy, inside the bytes the eviction freed)."""
        add = int(n)
        if add <= 0:
            return
        grow = False
        with self._lock:
            new_ids = list(range(self._ids, self._ids + add))
            self._ids += add
            self._refs.extend([0] * add)
            self._free.extend(reversed(new_ids))
            self.num_pages += add
            if self.kv is not None:
                # rows the budget can occupy: the null page, every
                # device-tier page, and alloc's headroom
                need = max(self.num_pages, len(self._row))
                if need > self._nrows:
                    first = self._nrows
                    self._nrows = need
                    self._free_rows.extend(range(need - 1, first - 1, -1))
                    grow = True
            PAGES_CAPACITY.set(float(self.num_pages - 1))
            self._publish_locked()
        if grow:
            self._grow()

    def reclaim(self, n: int) -> int:
        """Take back up to ``n`` donated slots (a parked model is warming
        and wants its bytes).  Only FREE HBM headroom returns: a reclaim
        never evicts or spills live KV; returns the slots reclaimed.  The
        id space stays wide (ids are bookkeeping) and so do the device
        rows: only the budget ``alloc`` enforces shrinks, and the rows'
        bytes stay reserved (``stats()``'s ``device_rows``) for the next
        ``donate`` to reuse before it grows the tensors."""
        with self._lock:
            take = min(int(n), len(self._free),
                       self.num_pages - 1 - self._hbm_used())
            if take <= 0:
                return 0
            self.num_pages -= take
            PAGES_CAPACITY.set(float(self.num_pages - 1))
            self._publish_locked()
            return take

    def tier(self, page: int) -> str:
        """``"hbm"`` | ``"host"`` | ``"none"`` (allocated, not committed)."""
        with self._lock:
            if page in self._host:
                return "host"
            if page in self._committed:
                return "hbm"
            return "none"

    # -- introspection ---------------------------------------------------------
    @property
    def free_count(self) -> int:
        """Pages an ``alloc`` could still grant: free ids capped by HBM
        headroom."""
        with self._lock:
            return max(0, min(len(self._free),
                              self.num_pages - 1 - self._hbm_used()))

    @property
    def host_count(self) -> int:
        with self._lock:
            return len(self._host)

    def refcount(self, page: int) -> int:
        with self._lock:
            return self._refs[page]

    def stats(self) -> dict:
        with self._lock:
            hbm = self._hbm_used()
            return {
                "pages": self.num_pages - 1,
                "free": self.num_pages - 1 - hbm,
                # both tiers: orphan accounting (in_use minus cached) must
                # see spilled pages
                "in_use": self._live,
                "hbm_pages": hbm,
                "host_pages": len(self._host),
                "host_capacity": self.host_pages,
                "spills_total": self._spills,
                "faults_total": self._faults,
                "fault_wait_seconds": {"count": self._fault_wait_count,
                                       "sum": self._fault_wait_sum},
                "page_size": self.page_size,
                "page_nbytes": self.page_nbytes,
                # rows held on the card (the null page's included): a
                # reclaim shrinks "pages", never these
                "device_rows": self._nrows if self.kv is not None else 0,
            }


def _by_name(store: dict, tensors) -> dict:
    """A layer's tensors keyed like ``store``'s: a (k, v) pair names
    itself; a dict must hold exactly the store's keys."""
    if not isinstance(tensors, dict):
        tensors = dict(zip(("k", "v"), tensors))
    if set(tensors) != set(store):
        raise ValueError(f"page tensors {sorted(tensors)} != the store's "
                         f"{sorted(store)}")
    return tensors


def pages_for(tokens: int, page_size: int) -> int:
    """Pages needed to cover ``tokens`` positions."""
    return max(0, -(-int(tokens) // int(page_size)))
