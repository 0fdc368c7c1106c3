"""Cluster prefix directory: which engine holds KV for which prefix.

Counterpart of ``kubeflow_tpu/serving/kv_directory.py`` (Mooncake's
KVCache-centric idea, Qin et al. 2024, at the fleet level): a prefix
prefilled on engine A is capital the whole cluster owns.  The directory
maps CHAINED PAGE-ALIGNED PREFIX HASHES to the engine currently holding
the pages (and the tier they sit in), so an engine whose local radix tree
misses can fetch the pages peer-to-peer from the owner (the ``:pages``
verb, on the handoff's page wire format, ``serving/disagg.py``) instead
of prefilling them again, and a router can prefer the owner.

Hashing: ``h_i = sha256(h_{i-1} | tokens[i*ps:(i+1)*ps])``, one hash per
FULL page of prefix, the chain seeded with the page size.  Chaining makes
each entry cover the entire prefix from position 0, and page alignment
matches what a page pool can ship.  The hashes are the reference's, byte
for byte.

Consistency: the directory is an eventually-consistent HINT, not a
lease.  Owners advertise on insert and withdraw on evict, and a draining
or restarting engine drops every entry it owns (``drop_engine``); every
consumer revalidates (the owner re-matches its own radix tree when asked
to export, and a fetch that returns nothing falls back to a local
prefill), so a stale entry can cost a wasted fetch, never a wrong stream.

Thread-safety: lookups and advertisements come from different threads;
one lock guards every method.
"""

from __future__ import annotations

import hashlib
import threading
import time

from kubeflow_tpu_torch.utils.metrics import REGISTRY

DIRECTORY_ENTRIES = REGISTRY.gauge(
    "serving_kv_directory_entries",
    "page-aligned prefix hashes currently advertised in the directory")
DIRECTORY_HITS = REGISTRY.counter(
    "serving_kv_directory_hits_total",
    "directory lookups that found an advertised prefix")
DIRECTORY_MISSES = REGISTRY.counter(
    "serving_kv_directory_misses_total",
    "directory lookups with no advertised prefix")
REMOTE_FETCHES = REGISTRY.counter(
    "serving_kv_remote_fetches_total",
    "prefix page sets fetched peer-to-peer from a remote owner")
REMOTE_FETCH_WAIT = REGISTRY.histogram(
    "serving_kv_remote_fetch_wait_seconds",
    "wall time an admission waited for a remote prefix page fetch")


def prefix_hashes(tokens, page_size: int) -> list[str]:
    """Chained hashes of every FULL-page-aligned prefix of ``tokens``:
    ``out[i]`` names ``tokens[:(i+1)*page_size]``.  The chain seeds with
    the page size so pools of different granularity can never alias."""
    out: list[str] = []
    prev = b"kv-prefix-v1:%d" % int(page_size)
    for i in range(len(tokens) // int(page_size)):
        chunk = tokens[i * page_size:(i + 1) * page_size]
        payload = ",".join(str(int(t)) for t in chunk).encode()
        prev = hashlib.sha256(prev + b"|" + payload).digest()
        out.append(prev.hex())
    return out


class PrefixDirectory:
    """Hash -> owning engine map for cluster-wide prefix reuse.

    Hosted wherever the fleet converges (a router, a disagg
    coordinator, a test harness) and shared by reference with
    every engine.  One entry per (hash); when two engines advertise the
    same prefix the LATEST advertisement wins — freshness beats
    plurality, since the loser still serves its own local hits."""

    def __init__(self, page_size: int = 16):
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.page_size = int(page_size)
        self._lock = threading.Lock()
        # hash -> {engine_id, addr, length, tier, advertised_at}
        self._entries: dict[str, dict] = {}
        self._by_engine: dict[str, set[str]] = {}

    # -- ownership -------------------------------------------------------------
    def advertise(self, engine_id: str, addr: str, tokens, *,
                  tier: str = "hbm") -> int:
        """Register every full-page prefix of ``tokens`` as resident on
        ``engine_id`` (reachable at ``addr``); returns entries written.
        Idempotent; re-advertising refreshes tier and timestamp."""
        hashes = prefix_hashes(tokens, self.page_size)
        if not hashes:
            return 0
        now = time.monotonic()
        with self._lock:
            owned = self._by_engine.setdefault(engine_id, set())
            for i, h in enumerate(hashes):
                prev = self._entries.get(h)
                if prev is not None and prev["engine_id"] != engine_id:
                    self._by_engine.get(prev["engine_id"], set()).discard(h)
                self._entries[h] = {
                    "engine_id": engine_id, "addr": addr,
                    "length": (i + 1) * self.page_size,
                    "tier": tier, "advertised_at": now,
                }
                owned.add(h)
            DIRECTORY_ENTRIES.set(float(len(self._entries)))
        return len(hashes)

    def withdraw(self, engine_id: str, tokens) -> int:
        """Drop ``engine_id``'s entries for every full-page prefix of
        ``tokens`` (eviction path).  Deliberately coarse: a shorter
        prefix the engine still caches just misses the directory until
        some admission re-inserts and re-advertises it — a stale MISS
        costs one local prefill, never correctness."""
        dropped = 0
        with self._lock:
            owned = self._by_engine.get(engine_id)
            if not owned:
                return 0
            for h in prefix_hashes(tokens, self.page_size):
                entry = self._entries.get(h)
                if entry is not None and entry["engine_id"] == engine_id:
                    del self._entries[h]
                    owned.discard(h)
                    dropped += 1
            DIRECTORY_ENTRIES.set(float(len(self._entries)))
        return dropped

    def drop_engine(self, engine_id: str) -> int:
        """Invalidate EVERYTHING an engine advertised — called when the
        owner drains, restarts, or dies: its pages are (or may be) gone,
        and routing traffic at a corpse wastes the affinity."""
        with self._lock:
            owned = self._by_engine.pop(engine_id, set())
            for h in owned:
                entry = self._entries.get(h)
                if entry is not None and entry["engine_id"] == engine_id:
                    del self._entries[h]
            DIRECTORY_ENTRIES.set(float(len(self._entries)))
            return len(owned)

    # -- lookup ----------------------------------------------------------------
    def lookup(self, tokens, *, exclude: str | None = None) -> dict | None:
        """Longest advertised prefix of ``tokens``: returns the entry
        dict plus ``matched`` (token count covered), or None.  With
        ``exclude`` set, entries owned by that engine are skipped — a
        requester asking "who ELSE holds this" must not route to
        itself."""
        hashes = prefix_hashes(tokens, self.page_size)
        with self._lock:
            for i in range(len(hashes) - 1, -1, -1):
                entry = self._entries.get(hashes[i])
                if entry is None:
                    continue
                if exclude is not None and entry["engine_id"] == exclude:
                    continue
                DIRECTORY_HITS.inc()
                return dict(entry, matched=(i + 1) * self.page_size)
        DIRECTORY_MISSES.inc()
        return None

    # -- introspection ---------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "engines": sum(1 for s in self._by_engine.values() if s),
                "page_size": self.page_size,
            }
