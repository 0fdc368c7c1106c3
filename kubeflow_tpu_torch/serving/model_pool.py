"""Weight residency for many-model serving: one device budget, N models;
and the streamed checkpoint format every predictor loads from.

Counterpart of ``kubeflow_tpu/serving/model_pool.py``.  ``ModelPool`` is
the reference's, line for line: per-model residency through four states

    parked    registered, weights not on the card (the engine, its page
              pool, prefix cache and drafter stay: see
              predictor.GenerativePredictor.park)
    loading   one leader is loading weights; concurrent acquirers
              COALESCE behind its load instead of loading again
    resident  weights on the card; ``refs`` counts in-flight requests and
              PINS the entry against eviction
    draining  refuses new acquires; weights free once refs hit zero

Under budget pressure the least-recently-released idle (refs == 0)
resident model evicts first.  Weights and KV pages are ONE currency: when
an engine's page allocator runs dry it calls :meth:`ModelPool.relieve`,
which evicts a cold model and DONATES the freed bytes to that engine's
``PagePool`` as page slots; a later load takes free donated slots back
(``PagePool.reclaim``, never live KV).  The clock is injected; nothing
here reads wall time itself.

Streamed checkpoints (``save_streamable``/``stream_restore``) are the
reference's format byte for byte: one ``t{idx:05d}.npy`` per tensor plus
``weights_manifest.json`` whose records hold ``key``, ``file``,
``shape``, ``dtype``, ``stored`` and ``nbytes``; bfloat16 is stored as
``uint16``.  Keys are the flax tree's ``keystr`` paths
(``['layer_3']['attention']['q']['kernel']``), in ``tree_flatten``
order (dict keys sorted at every level), which the port's parameter
names map onto by path alone (``layers.3.attention.q.kernel``; the
converter's mapping, ``models/convert.py``).  A restore goes by key,
never by file order.  Only numpy and the standard library touch the
files.

A restore memory-maps each file and copies it through ONE host staging
window of ``staging_bytes`` (pinned for a CUDA target, allocated once per
``StagingRing`` and reused): each piece goes into the ring, a
``non_blocking`` copy on a side stream takes it to the card, and an
event behind it tells the host when those ring bytes may be written
again.  A tensor larger than the window goes through in window-sized
pieces, so ``max_staged_bytes`` never exceeds ``staging_bytes`` (the
reference lets one oversized tensor exceed its window).  The caller's
stream waits on the side stream before a restored tensor is handed on,
and the restore returns once its last copy has landed.  A float32
record restores into a lower-precision target by a cast on the card,
piece by piece (the reference's predictor restores float32 trees; the
port's serving modules hold the compute dtype).
"""

from __future__ import annotations

import collections
import json
import os
import re
import threading
from contextlib import nullcontext
from dataclasses import dataclass, field
from time import monotonic as _monotonic
from typing import Callable

import numpy as np
import torch

from kubeflow_tpu_torch.utils.logging import get_logger
from kubeflow_tpu_torch.utils.metrics import REGISTRY

FLEET_MODELS = REGISTRY.gauge(
    "serving_fleet_models",
    "models registered with the weight-residency pool")
FLEET_RESIDENT = REGISTRY.gauge(
    "serving_fleet_resident_models",
    "models whose weights are currently device-resident")
FLEET_WEIGHT_BYTES = REGISTRY.gauge(
    "serving_fleet_weight_bytes",
    "bytes of device HBM held by resident model weights")
FLEET_BUDGET_BYTES = REGISTRY.gauge(
    "serving_fleet_budget_bytes",
    "configured HBM byte budget for model weights")
FLEET_DONATED_PAGES = REGISTRY.gauge(
    "serving_fleet_donated_pages",
    "KV page slots donated out of the weight budget under page-pool "
    "pressure (weights and pages are one currency)")
FLEET_EVICTIONS = REGISTRY.counter(
    "serving_fleet_evictions_total",
    "idle model weights evicted from device residency (LRU or pressure)")
FLEET_LOAD_SECONDS = REGISTRY.histogram(
    "serving_fleet_load_seconds",
    "wall time one model load (parked -> resident) took, staging "
    "included",
    buckets=(0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
             10.0, 30.0, 60.0))
COLDSTART_LOADS = REGISTRY.counter(
    "serving_coldstart_loads_total",
    "cold-start model loads actually performed (the coalescing "
    "denominator)")
COLDSTART_COALESCED = REGISTRY.counter(
    "serving_coldstart_coalesced_total",
    "cold-start requests that coalesced behind an in-flight load "
    "instead of loading again")
# per-model request latency: the cross-model interference signal.  Model
# names are operator-configured InferenceService models, a bounded set.
MODEL_REQUEST_SECONDS = REGISTRY.histogram(
    "serving_fleet_request_seconds",
    "end-to-end predictor request latency per model (the cross-model "
    "interference signal)",
    labels=("model",),
    buckets=(0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
             10.0, 30.0))

PARKED = "parked"
LOADING = "loading"
RESIDENT = "resident"
DRAINING = "draining"

log = get_logger("model_pool")


class ModelDraining(RuntimeError):
    """Acquire refused: the model is draining out of this process."""


@dataclass
class _Entry:
    name: str
    # loader() -> (payload, nbytes): builds/refreshes device weights and
    # returns an opaque payload (typically the predictor) plus the exact
    # byte count those weights occupy
    loader: Callable[[], tuple]
    # evictor() -> freed bytes: drops the device weights while keeping
    # whatever warm state the owner retains (compiled engine, tokenizer)
    evictor: Callable[[], int] | None = None
    state: str = PARKED
    nbytes: int = 0          # resident bytes (0 while parked)
    hint: int = 0            # expected bytes, for pre-load budget math
    refs: int = 0
    last_used: float = 0.0
    payload: object = None
    loads: int = 0
    evictions: int = 0
    coalesced: int = 0
    last_load_seconds: float = 0.0
    error: str | None = None
    ready: threading.Event = field(default_factory=threading.Event)


class ModelPool:
    """Per-process weight residency manager: LRU under ``budget_bytes``
    with refcount pins, coalesced cold-start loads, and page-pool
    donation under KV pressure."""

    def __init__(self, budget_bytes: int, *, clock=_monotonic,
                 on_change: Callable[[frozenset], None] | None = None):
        if budget_bytes <= 0:
            raise ValueError("budget_bytes must be > 0")
        self.budget_bytes = int(budget_bytes)
        self._clock = clock
        # on_change(resident_names): residency advertisement hook (a
        # router can send hot models to their resident replicas)
        self._on_change = on_change
        self._lock = threading.Lock()
        self._entries: dict[str, _Entry] = {}
        # page-pool donations: pool id -> (pool, donated slot count);
        # donated slots count against the weight budget until reclaimed
        self._donations: dict[int, list] = {}
        FLEET_BUDGET_BYTES.set(float(self.budget_bytes))

    # -- registration ----------------------------------------------------------
    def register(self, name: str, loader: Callable[[], tuple], *,
                 evictor: Callable[[], int] | None = None,
                 nbytes_hint: int = 0) -> None:
        """Register a model (parked).  ``loader`` runs OUTSIDE the pool
        lock on the coalescing leader's thread; ``nbytes_hint`` lets the
        pre-load budget pass evict enough idle models up front."""
        with self._lock:
            if name in self._entries:
                raise ValueError(f"model {name!r} already registered")
            self._entries[name] = _Entry(name=name, loader=loader,
                                         evictor=evictor,
                                         hint=int(nbytes_hint))
            FLEET_MODELS.set(float(len(self._entries)))

    def unregister(self, name: str) -> None:
        with self._lock:
            e = self._entries.get(name)
            if e is None:
                return
            if e.refs > 0 or e.state == LOADING:
                raise ValueError(f"model {name!r} is busy ({e.state}, "
                                 f"refs={e.refs})")
            del self._entries[name]
            FLEET_MODELS.set(float(len(self._entries)))
            self._publish_locked()
        self._notify()

    def has(self, name: str) -> bool:
        with self._lock:
            return name in self._entries

    # -- the data path ---------------------------------------------------------
    def acquire(self, name: str, timeout: float = 120.0):
        """Pin ``name`` resident and return its payload.

        Resident: bump the pin and return immediately.  Parked: become
        the LOAD LEADER — free budget (LRU eviction of idle models, then
        reclaiming donated page slots), run the loader, publish.
        Loading: coalesce — wait on the leader's outcome and retry
        (counted in ``serving_coldstart_coalesced_total``); a failed
        leader parks the entry again, so exactly one waiter inherits
        leadership per retry round."""
        deadline = self._clock() + timeout
        while True:
            with self._lock:
                e = self._entries[name]
                if e.state == DRAINING:
                    raise ModelDraining(f"model {name!r} is draining")
                if e.state == RESIDENT:
                    e.refs += 1
                    e.last_used = self._clock()
                    return e.payload
                if e.state == LOADING:
                    waiter = e.ready
                    e.coalesced += 1
                else:  # PARKED -> this thread leads the load
                    e.state = LOADING
                    e.error = None
                    e.ready = threading.Event()
                    waiter = None
            if waiter is None:
                return self._load(e)
            COLDSTART_COALESCED.inc()
            remaining = deadline - self._clock()
            if remaining <= 0 or not waiter.wait(remaining):
                raise TimeoutError(
                    f"model {name!r} load did not finish in {timeout:.0f}s")
            with self._lock:
                if e.error is not None and e.state == PARKED:
                    # leader failed; surface its error to every waiter
                    # of THIS round (the next acquire retries fresh)
                    raise RuntimeError(
                        f"model {name!r} load failed: {e.error}")
            # else: re-check state at the top (resident, or a drain
            # raced in)

    def _load(self, e: _Entry):
        """Leader path: budget, loader, publish.  Lock is NOT held
        across the loader — followers park on ``e.ready`` meanwhile."""
        try:
            self._make_room(max(e.hint, e.nbytes))
            t0 = self._clock()
            payload, nbytes = e.loader()
            dt = max(0.0, self._clock() - t0)
        except BaseException as err:
            with self._lock:
                e.state = PARKED
                e.error = str(err) or err.__class__.__name__
                e.payload = None
                e.ready.set()
            raise
        with self._lock:
            e.payload = payload
            e.nbytes = int(nbytes)
            e.state = RESIDENT
            e.refs = 1
            e.last_used = self._clock()
            e.loads += 1
            e.last_load_seconds = dt
            self._publish_locked()
            e.ready.set()
        COLDSTART_LOADS.inc()
        FLEET_LOAD_SECONDS.observe(dt)
        # the loader may have overshot the hint; trim AFTER publishing
        # so the freshly-loaded (pinned) model is never its own victim
        self._make_room(0)
        self._notify()
        return payload

    def release(self, name: str) -> None:
        """Drop one pin.  LRU recency is the RELEASE time — a model that
        just finished serving is the hottest thing in the pool."""
        evict_now = False
        with self._lock:
            e = self._entries[name]
            if e.refs <= 0:
                raise ValueError(f"release of unpinned model {name!r}")
            e.refs -= 1
            e.last_used = self._clock()
            evict_now = e.refs == 0 and e.state == DRAINING
        if evict_now:
            self._evict(name, draining=True)

    # -- eviction / budget -----------------------------------------------------
    def evict(self, name: str) -> int:
        """Evict ``name`` to parked if idle; returns bytes freed (0 when
        pinned, loading, or already parked)."""
        return self._evict(name)

    def _evict(self, name: str, draining: bool = False) -> int:
        with self._lock:
            e = self._entries.get(name)
            if e is None or e.refs > 0 or e.payload is None \
                    or e.state not in (RESIDENT, DRAINING):
                return 0
            evictor, freed = e.evictor, e.nbytes
            # flip state under the lock so a racing acquire reloads
            # rather than pinning a payload whose weights are mid-drop
            e.state = DRAINING if draining else PARKED
            e.payload = None
            e.nbytes = 0
            e.evictions += 1
            self._publish_locked()
        if evictor is not None:
            try:
                freed = int(evictor()) or freed
            except Exception as err:
                log.warning("evictor failed; bytes already unaccounted",
                            model=name, error=str(err))
        FLEET_EVICTIONS.inc()
        self._notify()
        return freed

    def evict_lru(self) -> int:
        """Evict the least-recently-used IDLE resident model; returns
        bytes freed (0 when every resident model is pinned)."""
        with self._lock:
            idle = [e for e in self._entries.values()
                    if e.state == RESIDENT and e.refs == 0
                    and e.payload is not None]
            if not idle:
                return 0
            victim = min(idle, key=lambda e: e.last_used).name
        return self._evict(victim)

    def _make_room(self, need: int) -> None:
        """Free budget for ``need`` more bytes: LRU-evict idle models,
        then take donated page slots back from their pools.  A fully
        pinned pool may overshoot — availability beats the budget (the
        in-flight requests holding the pins cannot be dropped), and the
        overshoot logs loudly."""
        while self.weight_bytes() + self.donated_bytes() + need \
                > self.budget_bytes:
            if self.evict_lru() > 0:
                continue
            if self._reclaim_donations() > 0:
                continue
            if need > 0:
                log.warning("weight budget overshoot: every resident "
                            "model is pinned",
                            budget=self.budget_bytes,
                            resident=self.weight_bytes(), need=need)
            return

    # -- weights-and-pages-one-currency ----------------------------------------
    def relieve(self, page_pool=None) -> bool:
        """KV pressure hook (the engine's page-alloc failure path): evict
        ONE idle model and donate the freed bytes to ``page_pool`` as
        page capacity.  True when capacity was donated — the caller
        retries its alloc before spilling or evicting hot KV."""
        if page_pool is None:
            return False
        page_nbytes = int(getattr(page_pool, "page_nbytes", 0) or 0)
        if page_nbytes <= 0 or not hasattr(page_pool, "donate"):
            return False
        freed = self.evict_lru()
        if freed <= 0:
            return False
        pages = freed // page_nbytes
        if pages <= 0:
            # too small to mint a page: the bytes simply return to the
            # weight budget (the eviction still happened — harmless)
            return False
        page_pool.donate(pages)
        with self._lock:
            rec = self._donations.setdefault(id(page_pool),
                                             [page_pool, page_nbytes, 0])
            rec[2] += pages
            donated = sum(r[2] for r in self._donations.values())
        FLEET_DONATED_PAGES.set(float(donated))
        log.info("weight eviction donated KV pages", pages=pages,
                 freed_bytes=freed)
        return True

    def _reclaim_donations(self) -> int:
        """Pull donated page slots back (free HBM slots only — a
        reclaim never evicts KV); returns bytes recovered."""
        recovered = 0
        with self._lock:
            records = list(self._donations.values())
        for rec in records:
            pool, page_nbytes, outstanding = rec
            if outstanding <= 0:
                continue
            got = pool.reclaim(outstanding)
            if got > 0:
                with self._lock:
                    rec[2] -= got
                    donated = sum(r[2] for r in self._donations.values())
                FLEET_DONATED_PAGES.set(float(donated))
                recovered += got * page_nbytes
        return recovered

    # -- lifecycle -------------------------------------------------------------
    def drain(self, name: str) -> None:
        """Refuse new acquires for ``name``; weights free once the last
        pin releases (or immediately when already idle)."""
        with self._lock:
            e = self._entries[name]
            if e.state == LOADING:
                raise ValueError(f"model {name!r} is mid-load")
            was_idle = e.refs == 0 and e.payload is not None
            e.state = DRAINING
            self._publish_locked()
        if was_idle:
            self._evict(name, draining=True)
        self._notify()

    # -- introspection ---------------------------------------------------------
    def weight_bytes(self) -> int:
        with self._lock:
            return sum(e.nbytes for e in self._entries.values())

    def donated_bytes(self) -> int:
        with self._lock:
            return sum(r[1] * r[2] for r in self._donations.values())

    def resident_names(self) -> frozenset:
        with self._lock:
            return frozenset(e.name for e in self._entries.values()
                             if e.state == RESIDENT)

    def state_of(self, name: str) -> str:
        with self._lock:
            return self._entries[name].state

    def stats(self) -> dict:
        with self._lock:
            models = {
                e.name: {
                    "state": e.state,
                    "nbytes": e.nbytes,
                    "refs": e.refs,
                    "loads": e.loads,
                    "evictions": e.evictions,
                    "coalesced": e.coalesced,
                    "last_load_seconds": e.last_load_seconds,
                }
                for e in self._entries.values()
            }
            donated = sum(r[2] for r in self._donations.values())
            donated_b = sum(r[1] * r[2] for r in self._donations.values())
            return {
                "budget_bytes": self.budget_bytes,
                "weight_bytes": sum(e.nbytes
                                    for e in self._entries.values()),
                "donated_pages": donated,
                "donated_bytes": donated_b,
                "resident": sum(1 for e in self._entries.values()
                                if e.state == RESIDENT),
                "parked": sum(1 for e in self._entries.values()
                              if e.state == PARKED),
                "loads_total": sum(e.loads
                                   for e in self._entries.values()),
                "evictions_total": sum(e.evictions
                                       for e in self._entries.values()),
                "coalesced_total": sum(e.coalesced
                                       for e in self._entries.values()),
                "models": models,
            }

    # -- internals -------------------------------------------------------------
    def _publish_locked(self) -> None:
        FLEET_RESIDENT.set(float(sum(1 for e in self._entries.values()
                                     if e.state == RESIDENT)))
        FLEET_WEIGHT_BYTES.set(float(sum(e.nbytes
                                         for e in self._entries.values())))

    def _notify(self) -> None:
        if self._on_change is None:
            return
        try:
            self._on_change(self.resident_names())
        except Exception as err:
            log.warning("residency on_change hook failed", error=str(err))


# -- streamed checkpoint layout ------------------------------------------------

MANIFEST = "weights_manifest.json"

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}
_KEY_PART = re.compile(r"\['([^'\]]*)'\]")


def _key_parts(name: str) -> list[str]:
    """A port parameter name as flax path parts (``layers.3.q.kernel`` ->
    ``['layer_3', 'q', 'kernel']``)."""
    parts = name.split(".")
    if len(parts) > 1 and parts[0] == "layers" and parts[1].isdigit():
        parts = [f"layer_{parts[1]}"] + parts[2:]
    return parts


def flax_key(name: str) -> str:
    """The reference's ``keystr`` of a port parameter name."""
    return "".join(f"['{p}']" for p in _key_parts(name))


def port_name(key: str) -> str:
    """The port parameter name of a manifest ``key``; ValueError when the
    key is not a path of dict keys."""
    parts = _KEY_PART.findall(key)
    if not parts or "".join(f"['{p}']" for p in parts) != key:
        raise ValueError(f"checkpoint key {key!r} is not a params path")
    return re.sub(r"^layer_(\d+)(\.|$)", r"layers.\1\2", ".".join(parts))


def save_streamable(module: torch.nn.Module, directory: str) -> int:
    """Write ``module``'s parameters as a streamable tensor-per-file
    checkpoint, in the dtype the module holds; returns total bytes
    written.  Keys and order are the reference's, so its
    ``stream_restore`` reads a checkpoint of a float32 module.  A module
    holding int8 weights is refused: save the full-precision one."""
    from kubeflow_tpu_torch.serving.quant import QTensor

    if any(isinstance(m, QTensor) for m in module.modules()):
        raise ValueError("save_streamable takes a full-precision module; "
                         "this one holds int8 weights")
    os.makedirs(directory, exist_ok=True)
    named = sorted(module.named_parameters(),
                   key=lambda item: _key_parts(item[0]))
    tensors = []
    total = 0
    for idx, (name, p) in enumerate(named):
        host = p.detach().cpu()
        dtype = _DTYPE_NAMES.get(host.dtype)
        if dtype is None:
            raise ValueError(f"{name}: dtype {host.dtype} has no checkpoint "
                             "form")
        if host.dtype == torch.bfloat16:
            store, stored = host.view(torch.uint16).numpy(), "uint16"
        else:
            store, stored = host.numpy(), dtype
        fname = f"t{idx:05d}.npy"
        np.save(os.path.join(directory, fname), store, allow_pickle=False)
        nbytes = host.numel() * host.element_size()
        tensors.append({"key": flax_key(name), "file": fname,
                        "shape": list(host.shape), "dtype": dtype,
                        "stored": stored, "nbytes": int(nbytes)})
        total += int(nbytes)
    with open(os.path.join(directory, MANIFEST), "w") as f:
        json.dump({"tensors": tensors, "total_bytes": total}, f)
    return total


def is_streamable(directory: str) -> bool:
    return os.path.isfile(os.path.join(directory, MANIFEST))


def read_manifest(directory: str) -> dict:
    """The checkpoint's manifest; ValueError naming the format when the
    directory holds none (an orbax checkpoint, which the port cannot
    read)."""
    if not is_streamable(directory):
        raise ValueError(
            f"{directory} holds no streamable checkpoint ({MANIFEST}); "
            "the port reads only that format, not orbax")
    with open(os.path.join(directory, MANIFEST)) as f:
        return json.load(f)


class StagingRing:
    """The host staging window of a restore: ``nbytes`` of host memory,
    pinned when the target is a CUDA device (``cudaHostAlloc`` costs
    milliseconds, so an owner allocates one ring and reuses it)."""

    def __init__(self, nbytes: int, device):
        self.nbytes = int(nbytes)
        self.device = torch.device(device)
        self.buf = torch.empty(self.nbytes, dtype=torch.uint8,
                               pin_memory=self.device.type == "cuda")
        self.host = self.buf.numpy()


def stream_restore(directory: str, like: dict, *,
                   staging_bytes: int = 64 << 20, device=None,
                   clock=_monotonic, ring: StagingRing | None = None,
                   sink: Callable | None = None,
                   full_precision=frozenset()):
    """Restore a ``save_streamable`` checkpoint tensor by tensor.

    ``like`` maps each port parameter name to a tensor (any device, meta
    included) whose shape and dtype the restored one takes.  A record's
    dtype must be the target's or float32 (cast on the device after the
    copy); names in ``full_precision`` land in the record's own float32
    instead (a caller that quantizes them from those values).  Each
    tensor is handed to ``sink(name, tensor)`` as soon as its copies are
    issued (the caller's stream already waits on them), so a caller can
    install and quantize it before the next one lands; without a sink
    the tensors are returned.  ``ring`` is the staging window (made here
    from ``staging_bytes`` when None).

    Returns ``(tensors, report)``: ``{name: tensor}`` (empty with a
    sink) and ``tensors``, ``bytes``, ``max_staged_bytes`` (the high-water
    mark of bytes in flight through the window) and ``seconds``."""
    manifest = read_manifest(directory)
    records = manifest["tensors"]
    if len(records) != len(like):
        raise ValueError(
            f"manifest has {len(records)} tensors, restore target has "
            f"{len(like)} leaves")
    dev = torch.device(device) if device is not None else None
    if ring is None:
        ring = StagingRing(staging_bytes,
                           dev if dev is not None else "cpu")
    cap = ring.nbytes
    t0 = clock()
    cuda = dev is not None and dev.type == "cuda"
    main = torch.cuda.current_stream(dev) if cuda else None
    side = torch.cuda.Stream(dev) if cuda else None
    inflight: collections.deque = collections.deque()  # (off, n, event)
    head = staged = max_staged = total = 0
    out: dict = {}
    seen: set = set()

    def fit(n: int) -> int | None:
        if not inflight:
            return 0
        tail = inflight[0][0]
        if head > tail:
            if head + n <= cap:
                return head
            return 0 if n <= tail else None
        return head if head < tail and head + n <= tail else None

    for rec in records:
        key = rec["key"]
        name = port_name(key)
        if name not in like:
            raise ValueError(f"checkpoint key {key} has no leaf {name!r} in "
                             "the restore target")
        if name in seen:
            raise ValueError(f"checkpoint key {key} appears twice")
        seen.add(name)
        target = like[name]
        want = _DTYPE_NAMES.get(target.dtype, str(target.dtype))
        if tuple(rec["shape"]) != tuple(target.shape) \
                or rec["dtype"] not in (want, "float32"):
            raise ValueError(
                f"tensor {key}: checkpoint is "
                f"{rec['dtype']}{rec['shape']}, target wants "
                f"{want}{list(target.shape)}")
        stored = _DTYPES[rec["dtype"]]
        land = (stored if name in full_precision else target.dtype)
        where = dev if dev is not None else target.device
        dest = torch.empty(tuple(rec["shape"]), dtype=land, device=where)
        flat = dest.view(-1)
        host = np.load(os.path.join(directory, rec["file"]), mmap_mode="r",
                       allow_pickle=False)
        raw = host.reshape(-1).view(np.uint8)
        nbytes = int(rec["nbytes"])
        if raw.size != nbytes:
            raise ValueError(f"tensor {key}: file holds {raw.size} bytes, "
                             f"manifest says {nbytes}")
        item = torch.empty((), dtype=stored).element_size()
        piece = cap // item * item
        if piece <= 0:
            raise ValueError(f"staging window of {cap} bytes holds no "
                             f"{rec['dtype']} element")
        if cuda:
            # the side stream writes blocks the caller's stream may have
            # freed with reads still queued
            side.wait_stream(main)
        for a in range(0, nbytes, piece):
            n = min(piece, nbytes - a)
            off = fit(n)
            while off is None:
                _, done_n, ev = inflight.popleft()
                if ev is not None:
                    ev.synchronize()
                staged -= done_n
                off = fit(n)
            head = off + n
            ring.host[off:off + n] = raw[a:a + n]
            src = ring.buf[off:off + n]
            with torch.cuda.stream(side) if cuda else nullcontext():
                if land == stored:
                    flat.view(torch.uint8)[a:a + n].copy_(
                        src, non_blocking=cuda)
                else:
                    tmp = torch.empty(n, dtype=torch.uint8, device=where)
                    tmp.copy_(src, non_blocking=cuda)
                    flat[a // item:(a + n) // item].copy_(tmp.view(stored))
                ev = None
                if cuda:
                    ev = torch.cuda.Event()
                    ev.record(side)
            inflight.append((off, n, ev))
            staged += n
            max_staged = max(max_staged, staged)
        if cuda:
            main.wait_stream(side)
        total += nbytes
        if sink is not None:
            sink(name, dest)
        else:
            out[name] = dest
        del dest, flat, host, raw
    while inflight:
        _, _, ev = inflight.popleft()
        if ev is not None:
            ev.synchronize()
    report = {"tensors": len(records), "bytes": total,
              "max_staged_bytes": max_staged,
              "seconds": max(0.0, clock() - t0)}
    return out, report


# -- process-wide handle -------------------------------------------------------
_pool: ModelPool | None = None
_pool_lock = threading.Lock()


def get_model_pool() -> ModelPool | None:
    """The process's residency pool, or None when this predictor serves
    without a weight budget."""
    return _pool


def set_model_pool(pool: ModelPool | None) -> ModelPool | None:
    global _pool
    with _pool_lock:
        _pool = pool
    return pool


__all__ = [
    "DRAINING",
    "LOADING",
    "MANIFEST",
    "PARKED",
    "RESIDENT",
    "ModelDraining",
    "ModelPool",
    "StagingRing",
    "flax_key",
    "get_model_pool",
    "is_streamable",
    "port_name",
    "read_manifest",
    "save_streamable",
    "set_model_pool",
    "stream_restore",
]
