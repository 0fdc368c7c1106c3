"""Host-managed radix tree over token prefixes, backed by shared KV pages.

Counterpart of ``kubeflow_tpu/serving/prefix_cache.py`` (RadixAttention-
style prefix reuse, SGLang, over the vLLM-style paged pool of
``serving/page_pool.py``):

- the TREE lives on the host (pure Python): a longest-prefix match costs
  no device work;
- a node's pages cover the FULL prefix from the root (positions
  ``[0, length)``, the tail page partially valid).  Insertion does not
  copy: the node increfs the pages the admission committed or shared;
- eviction is LRU under an explicit PAGE budget and drops node
  REFERENCES: a page still held by a longer cached prefix survives until
  its last holder releases it;
- a node PINNED by an in-flight admission (``match(pin=True)`` ..
  ``release()``) is never evicted or spilled;
- under pressure the sweep SPILLS before it drops: the coldest node's
  pages move to the pool's host-RAM arena and keep their ids and
  refcounts, and a later hit faults them back (``fault()``) before the
  seed.  Only pages whose sole holders are radix nodes are spill-safe: a
  pool refcount above the node-holder count means an in-flight
  admission still reads the device rows.  The page budget bounds
  DEVICE-resident cached pages; the pool bounds the host arena.

The engine (serving/engine.py) owns the seed and commit copies; this
module decides WHAT to share and WHEN to drop references.  ``fault``
issues its copies outside the tree's lock (the node is pinned, so its
pages cannot go meanwhile); a spill inside the budget sweep issues its
copies under it, without waiting for them.
"""

from __future__ import annotations

import threading
import time

from kubeflow_tpu_torch.serving.page_pool import PagePool, pages_for
from kubeflow_tpu_torch.utils.logging import get_logger
from kubeflow_tpu_torch.utils.metrics import REGISTRY

log = get_logger("serving.prefix_cache")

EVICTIONS_TOTAL = REGISTRY.counter(
    "serving_prefix_cache_evictions_total",
    "prefix-cache nodes evicted under the page budget")
CACHED_PAGES = REGISTRY.gauge(
    "serving_prefix_cache_pages",
    "distinct KV pages referenced by cached prefixes")
CACHED_BYTES = REGISTRY.gauge(
    "serving_prefix_cache_bytes",
    "device bytes covered by cached prefix pages")
CACHED_NODES = REGISTRY.gauge(
    "serving_prefix_cache_nodes",
    "radix-tree nodes currently holding cached pages")
SPILLED_PAGES = REGISTRY.gauge(
    "serving_prefix_cache_spilled_pages",
    "cached prefix pages currently resident in the host-RAM tier")


class _Node:
    __slots__ = ("edge", "length", "parent", "children", "pages",
                 "refs", "last_used", "tier")

    def __init__(self, edge: tuple, parent: "_Node | None"):
        self.edge = edge                      # tokens on the edge from parent
        self.parent = parent
        self.length = (parent.length if parent else 0) + len(edge)
        self.children: dict[int, _Node] = {}  # first edge token -> child
        self.pages: list[int] | None = None   # page ids covering [0, length)
        self.refs = 0                         # in-flight admissions pinning us
        self.last_used = 0.0
        self.tier = "hbm"                     # "host" once any page spilled


class PrefixCache:
    """Radix tree of token prefixes; nodes hold refcounted page ids from
    the shared pool, LRU-evicted under ``max_pages`` distinct pages.
    Thread-safe (the batcher thread mutates, scrapers read stats)."""

    def __init__(self, pool: PagePool, max_pages: int):
        if max_pages <= 0:
            raise ValueError("prefix cache needs a positive page budget")
        self.pool = pool
        self.page_size = pool.page_size
        self.max_pages = int(max_pages)
        self.root = _Node((), None)
        self._noded: set[_Node] = set()     # nodes currently holding pages
        self._page_holders: dict[int, int] = {}  # page id -> #nodes holding
        self._spilled: set[int] = set()     # cached pages in the host tier
        self._pins = 0                      # outstanding match(pin=True) holds
        self._lock = threading.Lock()
        # eviction hook (engine -> cluster prefix directory withdrawal):
        # called with the dropped node's full token prefix AFTER its pages
        # are released — the directory must stop routing remote hits to a
        # prefix this engine can no longer serve
        self.on_evict = None

    # -- matching --------------------------------------------------------------
    def match(self, tokens, *, pin: bool = False):
        """Longest-prefix match: returns ``(node, usable)`` where the
        node's pages hold valid KV for ``tokens[:usable]``, or
        ``(None, 0)``. With ``pin=True`` the node is refcounted before
        the lock drops — callers MUST ``release()`` it."""
        with self._lock:
            node, matched = self._walk(tuple(tokens))
            if matched == 0:
                return None, 0
            # the stop node (or any descendant: their paths extend ours)
            # covers the whole match; an ancestor covers a shorter prefix
            holder = self._find_pages_at_or_below(node)
            usable = matched
            if holder is None:
                holder = node.parent if node is not self.root else None
                while holder is not None and holder.pages is None:
                    holder = holder.parent
                if holder is None:
                    return None, 0
                usable = min(matched, holder.length)
            if usable <= 0:
                return None, 0
            holder.last_used = time.monotonic()
            if pin:
                holder.refs += 1
                self._pins += 1
            return holder, usable

    def _walk(self, tokens: tuple):
        """Descend as far as tokens agree; returns (stop_node, matched)."""
        node, depth = self.root, 0
        while depth < len(tokens):
            child = node.children.get(tokens[depth])
            if child is None:
                return node, depth
            edge = child.edge
            m = 0
            limit = min(len(edge), len(tokens) - depth)
            while m < limit and edge[m] == tokens[depth + m]:
                m += 1
            depth += m
            if m < len(edge):           # diverged (or prompt ended) mid-edge
                return child, depth
            node = child
        return node, depth

    def _find_pages_at_or_below(self, node: _Node):
        stack = [node]
        while stack:
            n = stack.pop()
            if n.pages is not None:
                return n
            stack.extend(n.children.values())
        return None

    def release(self, node: _Node) -> None:
        with self._lock:
            if node.refs > 0:
                node.refs -= 1
                self._pins -= 1

    # -- insertion / eviction --------------------------------------------------
    def insert(self, tokens, pages: list[int]) -> bool:
        """Attach ``pages`` (covering ``tokens``, tail page partial) at
        the node for ``tokens``, splitting edges as needed.  The pages
        are INCREF'd, not copied — the caller (an admitting slot) keeps
        its own references.  Evicts LRU unpinned nodes until the distinct
        -page budget holds.  Returns False when the prefix alone exceeds
        the budget (not stored)."""
        tokens = tuple(tokens)
        if not tokens:
            return False
        need = pages_for(len(tokens), self.page_size)
        if need > len(pages):
            raise ValueError(
                f"{need} pages required to cover {len(tokens)} tokens, "
                f"got {len(pages)}")
        pages = list(pages[:need])
        if need > self.max_pages:
            return False
        with self._lock:
            node, matched = self._walk(tokens)
            if matched < node.length:       # diverged mid-edge: split it
                node = self._split(node, matched)
            if matched < len(tokens):       # new leaf for the remainder
                leaf = _Node(tokens[matched:], node)
                node.children[tokens[matched]] = leaf
                node = leaf
            if node.pages is not None:      # already cached: refresh LRU
                node.last_used = time.monotonic()
                return True
            self.pool.incref(pages)
            node.pages = pages
            node.last_used = time.monotonic()
            self._noded.add(node)
            for p in pages:
                self._page_holders[p] = self._page_holders.get(p, 0) + 1
            self._evict_to_budget(keep=node)
            self._publish()
            return True

    def _split(self, node: _Node, at_length: int) -> _Node:
        """Split ``node``'s edge so a node boundary lands at path length
        ``at_length``; the new middle node holds no pages."""
        cut = at_length - node.parent.length
        mid = _Node(node.edge[:cut], node.parent)
        node.parent.children[node.edge[0]] = mid
        node.edge = node.edge[cut:]
        node.parent = mid
        mid.children[node.edge[0]] = node
        return mid

    def _evict_to_budget(self, keep: _Node | None = None) -> None:
        # the budget bounds HBM-RESIDENT cached pages: spilling a cold
        # node's pages to the host arena satisfies it without losing the
        # prefix, so the sweep spills first and drops only when nothing
        # more can move (arena full, or every candidate page is shared
        # with an in-flight consumer)
        while len(self._page_holders) - len(self._spilled) > self.max_pages:
            victims = sorted(
                (n for n in self._noded if n.refs == 0 and n is not keep),
                key=lambda n: n.last_used)
            if not victims:
                return  # everything live is pinned; budget temporarily over
            if any(self._spill_node_locked(v) for v in victims):
                continue
            self._drop(victims[0])
            EVICTIONS_TOTAL.inc()

    def _pinned_pages_locked(self) -> set[int]:
        """Pages under any PINNED node: excluded from spill exactly as
        from eviction — the pinning admission is about to read their
        device arrays into a seed dispatch."""
        pinned: set[int] = set()
        for n in self._noded:
            if n.refs > 0 and n.pages:
                pinned.update(n.pages)
        return pinned

    def _spill_node_locked(self, node: _Node) -> int:
        """Spill ``node``'s spill-safe pages to the host arena; returns
        how many pages moved.  Safe means: not already spilled, not under
        a pinned node, and the pool refcount equals the node-holder count
        (any excess reference is an in-flight admission or handoff that
        still reads the device arrays)."""
        if node.pages is None:
            return 0
        pinned = self._pinned_pages_locked()
        safe = [p for p in node.pages
                if p not in self._spilled and p not in pinned
                and self.pool.refcount(p) == self._page_holders.get(p, 0)]
        if not safe:
            return 0
        moved = self.pool.spill(safe)
        if moved:
            self._spilled.update(moved)
            node.tier = "host"
        return len(moved)

    def _drop(self, node: _Node) -> None:
        pages, node.pages = node.pages, None
        for p in pages:
            left = self._page_holders.get(p, 0) - 1
            if left <= 0:
                self._page_holders.pop(p, None)
                self._spilled.discard(p)
            else:
                self._page_holders[p] = left
        self.pool.decref(pages)
        self._noded.discard(node)
        if self.on_evict is not None:
            try:
                self.on_evict(self._node_tokens(node))
            except Exception as exc:
                # a failed directory withdrawal must not block LRU —
                # the directory is a hint, a stale entry only costs a
                # wasted remote fetch
                log.warning("on_evict callback failed", error=repr(exc))
        # prune pageless leaves so the tree doesn't accumulate dead paths
        while (node is not self.root and node.pages is None
               and not node.children and node.refs == 0):
            parent = node.parent
            del parent.children[node.edge[0]]
            node = parent

    @staticmethod
    def _node_tokens(node: _Node) -> tuple:
        """The full token prefix a node covers (root-to-node edge concat)."""
        parts = []
        while node is not None and node.edge:
            parts.append(node.edge)
            node = node.parent
        out: list = []
        for edge in reversed(parts):
            out.extend(edge)
        return tuple(out)

    def evict_lru(self) -> bool:
        """Free HBM held by the least-recently-used unpinned node
        (pool-pressure path: the engine calls this when slot admission
        cannot allocate).  Spill-before-drop: moving the coldest safe
        pages to the host arena frees the same HBM slots WITHOUT losing
        the prefix; references drop only when nothing can move.  Returns
        False when nothing is evictable."""
        with self._lock:
            victims = sorted((n for n in self._noded if n.refs == 0),
                             key=lambda n: n.last_used)
            if not victims:
                return False
            for victim in victims:
                if self._spill_node_locked(victim):
                    self._publish()
                    return True
            self._drop(victims[0])
            EVICTIONS_TOTAL.inc()
            self._publish()
            return True

    def spill_lru(self) -> int:
        """Explicitly spill the coldest spill-safe node's pages to the
        host arena (no references dropped); returns pages moved — 0 when
        the arena is full or nothing is safe to move."""
        with self._lock:
            for victim in sorted((n for n in self._noded if n.refs == 0),
                                 key=lambda n: n.last_used):
                moved = self._spill_node_locked(victim)
                if moved:
                    self._publish()
                    return moved
            return 0

    def fault(self, node: _Node) -> int:
        """Fault a matched node's spilled pages back to the device tier
        before the engine seeds from them; returns pages moved.  The
        caller holds the node pinned, so the pages cannot be dropped
        concurrently."""
        with self._lock:
            pages = list(node.pages or ())
            if not pages:
                return 0
        moved = self.pool.fault(pages)
        with self._lock:
            if moved:
                for p in pages:
                    self._spilled.discard(p)
                self._publish()
            node.tier = "hbm"
            return moved

    def cached_prefixes(self) -> list[tuple]:
        """Full token prefixes currently holding pages — what a restarted
        engine re-advertises to the cluster directory (drain dropped its
        entries, but the tree and pool survived)."""
        with self._lock:
            return [self._node_tokens(n) for n in self._noded]

    # -- introspection ---------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            # "pinned" must be zero whenever no admission is mid-prefill:
            # a nonzero steady-state value is a leaked refcount that makes
            # its pages unevictable forever (the overload loadtest asserts
            # this invariant after every storm)
            return {"pages": len(self._page_holders),
                    "max_pages": self.max_pages,
                    "bytes": len(self._page_holders) * self.pool.page_nbytes,
                    "max_bytes": self.max_pages * self.pool.page_nbytes,
                    # per-tier residency of the cached pages: the budget
                    # bounds the HBM side, the pool's arena the host side
                    "hbm_pages": (len(self._page_holders)
                                  - len(self._spilled)),
                    "host_pages": len(self._spilled),
                    "host_nodes": sum(1 for n in self._noded
                                      if n.tier == "host"),
                    "nodes": len(self._noded), "pinned": self._pins,
                    # token positions the tree could serve vs the page
                    # positions actually held: > 1.0 means page sharing
                    # is deduplicating overlapping prefixes
                    "covered_tokens": sum(n.length for n in self._noded)}

    def _publish(self) -> None:
        CACHED_PAGES.set(float(len(self._page_holders)))
        CACHED_BYTES.set(float(len(self._page_holders)
                               * self.pool.page_nbytes))
        CACHED_NODES.set(float(len(self._noded)))
        SPILLED_PAGES.set(float(len(self._spilled)))
