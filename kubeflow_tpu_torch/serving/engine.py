"""Continuous batching for generative serving (Orca-style iteration-level
scheduling), on one CUDA card.

Counterpart of ``kubeflow_tpu/serving/engine.py``'s ``ContinuousBatcher``.
What it keeps:

- ``max_batch`` slots over one RESIDENT KV view ``[max_batch, max_seq]``
  per layer, held in the model dtype and updated in place; each slot sits
  at its own position (per-row index);
- admission runs the prompt through a batch-1 prefill scratch in
  ``prefill_chunk`` chunks, each padded to a ``PREFILL_BUCKETS`` size, and
  samples the first token at the last real position; the scratch is then
  seated into the slot's view row.  Padded positions hold garbage that no
  real query reads (causality in prefill, and decode overwrites a position
  before any query attends to it), so the scratch is reused unzeroed;
- with ``prefix_cache_bytes`` > 0, the radix prefix cache over a
  refcounted page pool (``serving/prefix_cache.py``,
  ``serving/page_pool.py``): admission matches the prompt's longest
  cached prefix, seeds the scratch head from its pages (one gather per
  layer), prefills only the suffix (the flash kernel with causal offset
  ``sk - sq`` = the matched length), and commits the prompt's new full
  pages (one scatter per layer) into the tree.  Decode never reads pages:
  it stays on the resident view, as in the reference.  Without a prefix
  cache the pool is bookkeeping only and holds no device rows;
- decode runs in chunks of ``DECODE_CHUNKS`` steps between host syncs,
  sized as the reference sizes them (overshoot of up to 25% beats a second
  sync; overshoot tokens are dropped and the index restored from host
  truth);
- eos, deadlines, cancellation, bounded admission (``max_queue``), drain
  and shutdown;
- multi-tenant admission (``qos/``): every request carries a tenant
  (``submit(tenant=)``, clamped against ``tenant_shares``; ``anonymous``
  otherwise) and a virtual finish tag minted in the one enqueue tail;
  admission takes the smallest tag, arrival order breaking ties, so
  without shares (one flow, monotone tags) it is exactly FIFO.  A bounded
  queue sheds per tenant at its ``fair_quota``; the accountant meters
  outcomes, admission waits, decode tokens and slice-seconds per tenant,
  and two histograms by tenant time the admission wait and TTFT;
- tracing (``trace/``): the spans ride on the request
  (``engine.request``, ``engine.admission_wait``, one ``engine.prefill``
  per chunk, ``engine.prefill_handoff`` on the prefill role (on a
  gang, on every rank, from the commit to the seed or the release),
  ``engine.decode`` from seating), under the caller's ``trace_ctx`` or a
  head-sampled root; every failing exit closes them.  Spans time the
  host: a chunk's span closes once its kernels are issued, so it
  measures dispatch, and no span synchronizes the card;
- weight-residency pressure: when a commit or a fetched prefix cannot get
  pages, ``pressure_fn()`` (a ``ModelPool.relieve``) runs BEFORE any
  prefix-cache eviction, and the alloc retries on True: an idle model's
  weights are colder than any cached prefix;
- sampling with one ``torch.Generator`` per request, seeded from its seed:
  a request's draws depend only on its own seed and step, never on
  co-batched traffic;
- with ``speculative_tokens`` > 0, speculative decoding (Leviathan et al.,
  ICML 2023): a drafter (n-gram prompt lookup by default, or ``draft_fn``,
  e.g. ``serving/draft_model.py``) proposes up to that many tokens per
  row, and ONE forward of ``[last, draft..., 0-pad]`` per row over the
  resident view verifies them.  Position j's logits are those sequential
  decode computes once drafts 0..j-1 are accepted, and position j of a
  row samples with its generator after j draws, so each row keeps its
  longest agreeing prefix plus the model's own next token and the stream
  is the one decode without speculation gives.  A cost model
  (``SPEC_COST_BASE``, ``SPEC_COST_SLOPE``, the drafter's
  ``cost_per_token``) runs a round only when its expected tokens beat the
  decode chunk it displaces;
- with ``kv_quant``, int8 pages (``serving/quant.py``): the commit
  quantizes the pages it cuts from the scratch, one float32 scale per
  (page, kv head), and a seed dequantizes the pages it gathers.  The
  reference's cold prefill starts every prompt from a zero scratch; this
  engine reuses one, so before an int8 commit the tail page's positions
  that no chunk of this prompt wrote are made what the reference holds
  there (zeros, or its warm seed's padding of the last seeded page):
  they enter the per-head amax, and with it every real position's int8
  value;
- disaggregation (``serving/disagg.py``): ``role="prefill"`` admits a
  prompt without a slot, prefills it, commits EVERY prompt page (the
  tail's included) with one handoff reference per page, and passes a
  ``HandoffState`` to ``handoff_fn``; ``submit_handoff`` (any role) seeds
  a slot's scratch from those pages, releases the references, and decodes
  on.  The request carries its ``torch.Generator`` across the handoff (in
  process; across processes its state rides the body), so a handed-off
  stream is the colocated one.  ``failover_fn`` is offered every request
  that dies with the engine; ``adopt`` takes one over.  An injected
  ``pool`` (and ``prefix_cache``) is shared with sibling engines, which
  issue their copies on the same CUDA stream (the thread default).  On a
  gang, a prefill engine's tp group gathers the handoff pages' heads to
  the leader inside the step, every rank holds its state, and the leader
  releases or resumes it on every rank with a step-record command
  (``release_held``, ``resume_held``); a decode engine takes a
  ``:resume`` handoff through the next step record, whose page broadcast
  every rank places in the same page ids at its own heads;
- a serving gang (``mesh`` over tp and/or ep ranks, the predictor's
  ``tp=``/``ep=``): every rank runs a batcher over its shard, the view,
  scratch and page pool at its ``Hkv / tp`` heads (``sharded.CACHE_SPEC``;
  the page count is the whole model's, as the reference's GSPMD pool
  counts it).  Rank 0 alone takes requests; at the top of each step it
  broadcasts a step record (``serving/lockstep.py``: the requests it
  enqueued, its cancel and deadline verdicts, the stop flag, a digest of
  its previous step's tokens) and every other rank replays it in
  ``follow()``, so all of them admit, prefill, decode and sample alike
  over logits gathered across the vocabulary.  Death is judged at step
  boundaries only (no collective per prefill chunk); an idle leader
  still sends a record every ``HEARTBEAT_S``; a follower whose tokens
  differ raises, and a dead follower fails the leader's next collective
  into the crash path.  Each gang model's records go on its own group
  (its mesh's tp x ep group), so several gang models' engines run side
  by side.  Weight residency and handoffs ride the records: ``command``
  queues a ``park``, ``warm``, ``reclaim n``, ``release #seq`` or
  ``resume #seq`` that every rank applies at the next step boundary (the
  predictor's park and warm, the page pool's reclaim, a held handoff's
  pages dropped or seeded into a slot), and an alloc that meets page
  pressure takes the leader's
  verdict (``pressure_fn``, a ``ModelPool.relieve`` over
  ``pressure_pages``) in one small broadcast at that point of the step:
  the sibling park it waited for and the pages it donated, which every
  follower donates too once its own sibling has parked;
- cluster prefix reuse (``serving/kv_directory.py``): with a
  ``directory``, every cached prompt is advertised and every eviction
  withdrawn; with a ``fetch_fn`` too, a prompt whose longest advertised
  prefix (on another engine) covers more full pages than the local match
  fetches those pages (the ``:pages`` wire format) into the local tree
  first, and ``export_prefix`` ships this engine's full pages to a peer
  from whichever tier holds them.
"""

from __future__ import annotations

import itertools
import math
import threading
import time
from dataclasses import dataclass, field

import torch

from kubeflow_tpu_torch import trace
from kubeflow_tpu_torch.models.llama import init_kv_pool, kv_page_nbytes
from kubeflow_tpu_torch.parallel import distributed as pd
from kubeflow_tpu_torch.qos.accounting import get_accountant
from kubeflow_tpu_torch.qos.tenants import ANONYMOUS, clamp_tenant
from kubeflow_tpu_torch.qos.wfq import WeightedFairQueue, fair_quota
from kubeflow_tpu_torch.serving import lockstep, sharded
from kubeflow_tpu_torch.serving.page_pool import PagePool, pages_for
from kubeflow_tpu_torch.serving.prefix_cache import PrefixCache
from kubeflow_tpu_torch.serving.quant import (dequantize_kv,
                                              kv_page_nbytes_int8,
                                              quantize_kv)
from kubeflow_tpu_torch.serving.speculative import (MIN_DRAFT,
                                                    SpeculationState,
                                                    ngram_draft)
from kubeflow_tpu_torch.trace import NULL_SPAN
from kubeflow_tpu_torch.utils.logging import get_logger
from kubeflow_tpu_torch.utils.metrics import REGISTRY

TOKENS_TOTAL = REGISTRY.counter("serving_tokens_generated_total",
                                "tokens generated")
REQS_TOTAL = REGISTRY.counter("serving_requests_total",
                              "generation requests", labels=("outcome",))
QUEUE_DEPTH = REGISTRY.gauge("serving_queue_depth",
                             "requests waiting for a slot")
ACTIVE_SLOTS = REGISTRY.gauge("serving_active_requests",
                              "requests currently decoding")
TTFT_HIST = REGISTRY.histogram(
    "serving_time_to_first_token_seconds", "time to first token",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5, 5.0, 10.0, 30.0))
TOKS_PER_SEC = REGISTRY.gauge("serving_tokens_per_sec",
                              "decode throughput, last window")
DECODE_TOKENS = REGISTRY.counter(
    "serving_decode_tokens_total",
    "tokens produced by decode dispatches (excludes prefill first tokens)")
DECODE_SECONDS = REGISTRY.counter(
    "serving_decode_seconds_total", "wall seconds spent in decode chunks")
PREFILL_DISPATCHES = REGISTRY.counter(
    "serving_prefill_dispatches_total", "prefill forward dispatches")
PREFILL_TOKENS = REGISTRY.counter(
    "serving_prefill_tokens_total",
    "real prompt tokens run through prefill compute")
PREFIX_HITS = REGISTRY.counter(
    "serving_prefix_cache_hits_total",
    "admissions that reused a cached prompt prefix")
PREFIX_MISSES = REGISTRY.counter(
    "serving_prefix_cache_misses_total",
    "admissions with no reusable cached prefix")
SPEC_PROPOSED = REGISTRY.counter(
    "serving_spec_tokens_proposed_total",
    "draft tokens proposed to speculative verification")
SPEC_ACCEPTED = REGISTRY.counter(
    "serving_spec_tokens_accepted_total",
    "draft tokens accepted by speculative verification")
SPEC_ROUNDS = REGISTRY.counter(
    "serving_spec_rounds_total",
    "speculative verify dispatches")
ADMISSION_WAIT = REGISTRY.histogram(
    "serving_admission_wait_seconds",
    "queue wait from submit() to slot admission",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5, 5.0, 10.0, 30.0))
# tenant-labelled siblings of the two QoS-relevant histograms, observed
# beside the unlabelled ones; tenants are clamped to the share map, so
# the label set stays bounded
TENANT_ADMISSION_WAIT = REGISTRY.histogram(
    "serving_tenant_admission_wait_seconds",
    "queue wait from submit() to slot admission, by tenant",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5, 5.0, 10.0, 30.0),
    labels=("tenant",))
TENANT_TTFT = REGISTRY.histogram(
    "serving_tenant_time_to_first_token_seconds",
    "time to first token, by tenant (per-tenant SLO source)",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5, 5.0, 10.0, 30.0),
    labels=("tenant",))
HANDOFFS = REGISTRY.counter(
    "serving_prefill_handoffs_total",
    "prefilled requests handed off to a decode worker (disaggregation)")
HANDOFF_WAIT = REGISTRY.histogram(
    "serving_handoff_wait_seconds",
    "prefill-commit to decode-seed latency of a disaggregated handoff",
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
             0.5, 1.0, 2.5, 5.0))

PREFILL_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048)
DECODE_CHUNKS = (8, 16, 32, 64, 128)
# the reference's warm seed pads its page list to one of these counts by
# repeating the last page (the rest of its scratch is zeros); an int8
# commit reproduces what that padding leaves in the tail page
SEED_BUCKETS = (1, 2, 4, 8, 16, 32, 64)

# verify-round cost model, in decode-step units: a round costs about BASE
# steps of fixed overhead plus SLOPE steps per verified token (the
# reference's calibration, deliberately pessimistic so the policy errs
# toward plain decode)
SPEC_COST_BASE = 1.8
SPEC_COST_SLOPE = 0.15

# the longest an idle engine waits for work between scheduling steps; a
# gang's leader sends a step record at least this often
HEARTBEAT_S = 5.0


# gang parks are numbered by the leader (their tickets ride the records);
# every rank notes the tickets it has applied, so that a follower's
# pressured engine can wait for its sibling's park before it donates the
# bytes that park freed.  ``_last_park.ticket`` is the last gang park the
# current thread asked for (-1: none), read by a leader's page-pressure
# verdict, whose evictor runs on its own thread
_TICKETS = itertools.count()
_PARKS = threading.Condition()
_PARKED_TICKETS: set[int] = set()
_last_park = threading.local()


class _Command:
    """A residency command the leader queued for the next step record,
    and its outcome once every rank has applied it."""

    def __init__(self, kind: str, arg: int):
        self.kind, self.arg = kind, arg
        self.done = threading.Event()
        self.result: int | None = None
        self.error: str | None = None

    def finish(self, result: int | None = None,
               error: str | None = None) -> None:
        self.result, self.error = result, error
        self.done.set()


class GangPages:
    """The page pool a ``ModelPool`` sees for a gang engine
    (``engine.pressure_pages``): ``donate`` grows the leader's pool inside
    its page-pressure verdict, which carries the count to every follower
    at the same point of the step; ``reclaim`` is a ``reclaim n`` command
    that every rank applies at the next step boundary, and returns the
    slots every rank took (the pools are in lockstep, so the free-slots
    rule picks the same count on each)."""

    def __init__(self, engine: "ContinuousBatcher"):
        self._engine = engine
        self.donated = 0          # pages donated through this view

    @property
    def page_nbytes(self) -> int:
        return self._engine.pool.page_nbytes

    def donate(self, n: int) -> None:
        if not self._engine._relieving:
            raise RuntimeError("a gang engine's page budget grows only "
                               "inside its page-pressure verdict")
        self._engine.pool.donate(n)
        self.donated += int(n)

    def reclaim(self, n: int) -> int:
        return self._engine.command("reclaim", int(n))


class QueueFull(RuntimeError):
    """Bounded admission shed; ``retry_after`` is the wait estimate the
    predictor returns as ``Retry-After``."""

    def __init__(self, msg: str, retry_after: float = 1.0):
        super().__init__(msg)
        self.retry_after = max(0.1, retry_after)


class Draining(RuntimeError):
    """The engine is draining: in-flight requests finish, new ones are
    rejected."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before generation completed."""


class RequestCancelled(ValueError):
    """The request was cancelled (caller, sibling row, or shutdown)."""


@dataclass
class GenRequest:
    ids: list[int]
    max_new_tokens: int
    temperature: float
    eos_id: int | None = None
    seed: int = 0
    top_k: int = 0        # 0 = disabled
    top_p: float = 0.0    # 0 or >= 1 = disabled
    deadline: float | None = None   # absolute perf_counter() deadline
    # the tenant this request bills to (clamped to the share map)
    tenant: str = ANONYMOUS
    submitted_at: float = field(default_factory=time.perf_counter)
    admitted_at: float | None = None
    first_token_at: float | None = None
    generated: list[int] = field(default_factory=list)
    error: str | None = None
    outcome: str | None = None
    _done: threading.Event = field(default_factory=threading.Event)
    _cancel_requested: bool = False
    # WFQ admission: the virtual finish tag minted at enqueue, and an
    # arrival sequence for deterministic cross-tenant tie-breaks
    _vft: float = 0.0
    _seq: int = 0
    _engine: object | None = field(default=None, repr=False)
    _gen: torch.Generator | None = field(default=None, repr=False)
    _spec: SpeculationState | None = field(default=None, repr=False)
    # disaggregation: a pending HandoffState rides the request across the
    # prefill -> decode boundary (page references and sampling state),
    # cleared (its references dropped) at the decode seed or at death
    _handoff: object | None = field(default=None, repr=False)
    _failovers: int = 0
    # tracing: the spans ride on the request from the submitting thread
    # into the batcher thread; NULL_SPAN when the trace is unsampled
    span: object = field(default=NULL_SPAN, repr=False)       # request
    wait_span: object = field(default=NULL_SPAN, repr=False)  # admission
    decode_span: object = field(default=NULL_SPAN, repr=False)
    handoff_span: object = field(default=NULL_SPAN, repr=False)

    def expired(self, now: float | None = None) -> bool:
        return (self.deadline is not None
                and (time.perf_counter() if now is None else now)
                >= self.deadline)

    def cancel(self) -> None:
        """Ask the engine to evict this request (queued or mid-decode)."""
        self._cancel_requested = True
        eng = self._engine
        if eng is not None and not self._done.is_set():
            with eng._work:
                eng._work.notify_all()

    def result(self, timeout: float = 300.0) -> list[int]:
        if not self._done.wait(timeout):
            self.cancel()
            raise TimeoutError("generation did not complete in time")
        if self.error:
            if self.outcome == "deadline_exceeded":
                raise DeadlineExceeded(self.error)
            if self.outcome in ("cancelled", "shutdown"):
                raise RequestCancelled(self.error)
            raise ValueError(self.error)
        return self.ids + self.generated


class ContinuousBatcher:
    """Shares one resident decode view across concurrent requests."""

    def __init__(self, model, cfg, *, max_batch: int = 4,
                 max_seq: int = 512, prefill_chunk: int = 512,
                 max_queue: int = 0, prefix_cache_bytes: int = 0,
                 page_size: int = 16, kv_pages: int = 0,
                 host_kv_pages: int = 0, speculative_tokens: int = 0,
                 draft_fn=None, role: str = "colocated", handoff_fn=None,
                 failover_fn=None, pool: PagePool | None = None,
                 prefix_cache: PrefixCache | None = None,
                 kv_quant: bool = False, directory=None,
                 engine_id: str | None = None, engine_addr: str = "",
                 fetch_fn=None, tenant_shares: dict | None = None,
                 pressure_fn=None, mesh=None):
        if role not in ("colocated", "prefill", "decode"):
            raise ValueError(f"unknown engine role {role!r}")
        if role == "prefill" and handoff_fn is None:
            raise ValueError("a prefill-role engine needs a handoff_fn "
                             "(who receives the finished prompt KV?)")
        self.role = role
        self.handoff_fn = handoff_fn
        self.failover_fn = failover_fn
        self.model = model
        self.cfg = cfg
        self.device = model.device
        # a tp / ep serving mesh over the gang: the view, scratch and pool
        # hold this rank's KV heads, and with more than one rank the
        # batchers run in lockstep, rank 0 leading (``_next_record``)
        self.mesh = mesh
        self.tp = 1 if mesh is None else mesh.shape["tp"]
        self._gang = mesh is not None and mesh.size > 1
        self.rank = pd.rank_of(pd.default_group()) if self._gang else 0
        # this model's records and pressure verdicts: its own group, so
        # that two gang models' engines never share one
        self._group = mesh.group("tp", "ep") if self._gang else None
        # logits over the whole vocabulary (a tp rank's head gives its
        # slice): sampling and its generators read the same values on
        # every rank
        emb = getattr(model, "tok_embeddings", None)
        self._whole_vocab = getattr(emb, "whole_vocab", lambda x: x)
        self.max_batch = max_batch
        self.max_seq = min(max_seq, cfg.max_seq_len)
        self.prefill_chunk = max(1, min(prefill_chunk, self.max_seq))
        self.max_queue = max_queue
        self.log = get_logger("serving.batcher")
        # speculative decoding: max draft tokens per verify round (0 =
        # plain chunked decode); the drafter defaults to n-gram lookup
        self.spec_max = max(0, int(speculative_tokens))
        self.draft_fn = ngram_draft if draft_fn is None else draft_fn
        # a model drafter pays real forwards (cost_per_token decode-step
        # units per drafted token), so the arbiter prices it BEFORE
        # drafting; an n-gram draft is free and priced after
        self.draft_cost = max(0.0, float(getattr(self.draft_fn,
                                                 "cost_per_token", 0.0)))
        self._spec_buckets = tuple(
            b for b in (1, 2, 4, 8, 16, 32) if b < self.spec_max
        ) + ((self.spec_max,) if self.spec_max else ())
        self._spec_declines = 0
        # clamped like prefill_chunk: a page longer than max_seq could
        # never be committed
        self.page_size = max(1, min(int(page_size), self.max_seq))
        if role == "prefill" and self.max_seq % self.page_size:
            # a handoff commits EVERY prompt page, the tail's included; a
            # page straddling max_seq would hold positions the scratch
            # does not have
            raise ValueError(
                f"prefill role needs page_size ({self.page_size}) to "
                f"divide max_seq ({self.max_seq})")
        self.pages_per_seq = pages_for(self.max_seq, self.page_size)
        self.kv_quant = bool(kv_quant)
        self.page_nbytes = (kv_page_nbytes_int8(cfg, self.page_size)
                            if self.kv_quant
                            else kv_page_nbytes(cfg, self.page_size))
        cache_pages = 0
        if prefix_cache_bytes > 0:
            cache_pages = max(1, int(prefix_cache_bytes) // self.page_nbytes)
        # an injected pool (or cache) is shared with sibling engines: this
        # engine cannot tell an orphan from a sibling's cache entry or an
        # in-flight handoff, so the pool's owner does the leak accounting
        self._pool_shared = pool is not None or prefix_cache is not None
        if pool is None:
            if kv_pages <= 0:
                # the cache's allowance plus every slot's in-flight prompt
                # pages (an upper bound: they become cache entries)
                kv_pages = 1 + cache_pages + max_batch * self.pages_per_seq
            # device rows for a prefix cache or a disaggregated role (the
            # handoff's pages); otherwise nothing ever commits a page, and
            # the default engine's memory stays as it was
            kv = (init_kv_pool(cfg, kv_pages, self.page_size,
                               device=self.device, quantized=self.kv_quant,
                               tp=self.tp)
                  if cache_pages or role != "colocated" else None)
            pool = PagePool(kv_pages, self.page_size, self.page_nbytes,
                            host_pages=max(0, int(host_kv_pages)), kv=kv)
        elif pool.page_size != self.page_size:
            raise ValueError(
                f"shared pool page_size {pool.page_size} != engine "
                f"page_size {self.page_size}")
        elif pool.kv is not None and pool.quantized != self.kv_quant:
            raise ValueError(f"shared pool quantized={pool.quantized} != "
                             f"engine kv_quant={self.kv_quant}")
        self.pool = pool
        if prefix_cache is not None:
            self.prefix_cache = prefix_cache
        else:
            self.prefix_cache = (PrefixCache(self.pool, cache_pages)
                                 if cache_pages else None)
        # cluster prefix reuse: advertise on insert, withdraw on evict,
        # fetch a peer's pages on a local miss the directory covers
        self.directory = directory
        self.engine_id = engine_id or f"engine-{id(self):x}"
        self.engine_addr = engine_addr
        self.fetch_fn = fetch_fn
        self._remote_fetches = 0
        # pressure_fn() -> bool: the weight-residency arbiter
        # (serving/model_pool.py), called when the pool cannot cover an
        # alloc, BEFORE any prefix-cache eviction; True means a cold
        # model's weights became page slots and the alloc retries
        self.pressure_fn = pressure_fn
        # what pressure_fn's relieve donates to: the pool itself, or in a
        # gang the view whose donations every rank mirrors
        self.pressure_pages = GangPages(self) if self._gang else self.pool
        self._relieving = False
        if self.directory is not None and self.prefix_cache is not None:
            self.prefix_cache.on_evict = self._withdraw_prefix
        shape = sharded.cache_block(
            (max_batch, self.max_seq, cfg.num_kv_heads, cfg.head_dim), mesh)
        dt = cfg.torch_dtype
        self.view = [{"k": torch.zeros(shape, dtype=dt, device=self.device),
                      "v": torch.zeros(shape, dtype=dt, device=self.device)}
                     for _ in range(cfg.num_layers)]
        if mesh is not None:
            # one rule places every serving cache: KV heads over tp
            from kubeflow_tpu_torch.serving.multihost import constrain_cache

            constrain_cache({"layers": self.view}, mesh, batch=max_batch,
                            num_kv_heads=cfg.num_kv_heads)
            if self.pool.kv is not None:
                constrain_cache(self.pool.kv, mesh,
                                batch=self.pool.kv["layers"][0]["k"].shape[0],
                                num_kv_heads=cfg.num_kv_heads)
        self._scratch_kv = None   # batch-1 prefill scratch, made at first use
        self.slots: list[GenRequest | None] = [None] * max_batch
        self.queue: list[GenRequest] = []
        # {tenant: WFQ weight}; None folds every request into one
        # anonymous flow, whose monotone tags make admission FIFO
        self.tenant_shares = dict(tenant_shares) if tenant_shares else None
        self._wfq = WeightedFairQueue(shares=self.tenant_shares)
        self._arrival = 0
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._auto_seed = 0
        self._stop = False
        self._closed = False
        self._draining = False
        self._service_ewma = 0.0
        self._thread: threading.Thread | None = None
        # this engine's own tallies (the registry sums every engine)
        self._timing = {"ttft_sum": 0.0, "ttft_count": 0,
                        "decode_tokens": 0, "decode_seconds": 0.0,
                        "prefill_chunks": 0}
        self._spec_tally = {"proposed": 0, "accepted": 0, "rounds": 0}
        # requests mid-prefill on a prefill-role engine: no slot, out of
        # the queue, but load (drained() and the per-role stats count them)
        self._prefilling = 0
        self._handoffs = 0    # handoffs made (prefill role)
        self._resumed = 0     # handoffs seeded into a slot here
        # lockstep: the leader's requests wait here for the next record;
        # each step's (seq, token) emissions and their digest; the
        # records' broadcasts (calls, seconds)
        self._pending: list[GenRequest] = []
        # the leader's ``:resume`` requests between leaving ``_pending``
        # and their enqueue or shed in ``_take_handoffs``: a crash there
        # fails them with the rest
        self._resuming: list[GenRequest] = []
        self._emitted: list[int] = []
        self._digest = lockstep.digest([])
        self.record_tally: dict = {}
        self._crash: str | None = None
        # residency: ``residency_fn(kind)`` is the predictor's park or warm
        # of this rank's weights; the leader's queued commands wait here
        # for the next record, then in ``_in_flight`` until applied
        self.residency_fn = None
        self._commands: list[_Command] = []
        self._in_flight: list[_Command] = []
        # a prefill gang's handoffs that every rank holds (its pages, its
        # request) until the leader's ``release`` or ``resume`` command,
        # by the request's arrival number
        self._held: dict[int, object] = {}
        if self._gang and self.rank == 0:
            # the leader's loop runs from the start: its records (one per
            # wake when idle) are what the followers wait in
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="serving-batcher")
            self._thread.start()

    # -- public ----------------------------------------------------------------
    def submit(self, ids: list[int], max_new_tokens: int = 32,
               temperature: float = 0.0, eos_id: int | None = None,
               seed: int | None = None, top_k: int = 0, top_p: float = 0.0,
               deadline_s: float | None = None, trace_ctx=None,
               tenant: str | None = None) -> GenRequest:
        if self._gang and self.rank != 0:
            raise RuntimeError(f"rank {self.rank} of a serving gang takes "
                               "no requests: rank 0 leads, the others "
                               "follow()")
        if len(ids) + max_new_tokens > self.max_seq:
            raise ValueError(
                f"prompt+new ({len(ids) + max_new_tokens}) > max_seq "
                f"{self.max_seq}")
        if not ids:
            raise ValueError("empty prompt")
        if any(not 0 <= t < self.cfg.vocab_size for t in ids):
            raise ValueError(f"token id outside [0, {self.cfg.vocab_size})")
        if top_k < 0:
            raise ValueError("top_k must be >= 0")
        if not 0.0 <= top_p <= 1.0:
            raise ValueError("top_p must be in [0, 1]")
        if top_p >= 1.0:
            top_p = 0.0  # the full distribution: "disabled"
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError("deadline_s must be > 0")
        req = GenRequest(list(ids), max_new_tokens, temperature, eos_id,
                         top_k=top_k, top_p=top_p,
                         tenant=clamp_tenant(tenant, self.tenant_shares))
        if self.spec_max:
            req._spec = SpeculationState(self.spec_max)
        # spans before the critical section: a rejection below still
        # records its outcome on the request span before it closes
        self._start_trace(req, trace_ctx)
        try:
            self._enqueue(req, seed, deadline_s)
        except BaseException as e:
            req.span.set_attribute(
                "outcome", "shed" if isinstance(e, QueueFull)
                else "draining" if isinstance(e, Draining) else "error")
            req.wait_span.end()
            req.span.end()
            raise
        return req

    def command(self, kind: str, arg: int = 0) -> int:
        """Run a command (``lockstep.COMMANDS``) on every rank of this gang
        at the next step boundary and return the leader's result: a park
        or warm's bytes, a reclaim's slots, a resumed handoff's new
        arrival number.  Rank 0 only;
        the caller waits (the engine is woken at once).  A park of an
        engine with live requests raises, and so does a command that
        failed on the leader or outlived the engine."""
        if not self._gang or self.rank != 0:
            raise RuntimeError("residency commands are queued by rank 0 of "
                               "a serving gang")
        if threading.current_thread() is self._thread:
            raise RuntimeError("the engine's own thread cannot wait for "
                               "its next step boundary")
        if kind == "park":
            arg = next(_TICKETS)
        cmd = _Command(kind, int(arg))
        with self._work:
            if self._crash is not None:
                raise RuntimeError(f"serving engine crashed: {self._crash}")
            if self._closed:
                raise RuntimeError("serving engine is shut down")
            self._commands.append(cmd)
            self._work.notify_all()
        cmd.done.wait()
        if cmd.error is not None:
            raise RuntimeError(cmd.error)
        if kind == "park":
            _last_park.ticket = arg
        return cmd.result

    def _fail_commands(self, msg: str) -> None:
        """Every queued and in-flight command fails with ``msg`` (the
        engine stopped or crashed)."""
        with self._work:
            failed = self._commands + self._in_flight
            self._commands, self._in_flight = [], []
        for cmd in failed:
            cmd.finish(error=msg)

    def _apply_command(self, kind: str, arg: int) -> int:
        """One command on this rank."""
        if kind == "reclaim":
            return self.pool.reclaim(arg)
        if kind in ("release", "resume"):
            with self._work:
                state = self._held.pop(arg, None)
            if state is None:
                raise RuntimeError(f"{kind}: this rank holds no handoff "
                                   f"#{arg}")
            req = state.request
            if kind == "release":
                from kubeflow_tpu_torch.serving.disagg import release_handoff

                release_handoff(self.pool, state)
                req._handoff = None
                req.handoff_span.end()
                return 0
            req._handoff = state
            with self._work:
                self._enqueue_locked(req)
            return req._seq
        if self.residency_fn is None:
            raise RuntimeError(f"{kind}: no weights are bound to this "
                               "engine (residency_fn)")
        out = int(self.residency_fn(kind))
        if kind == "park":
            with _PARKS:
                _PARKED_TICKETS.add(arg)
                _PARKS.notify_all()
        return out

    def refuse_in_gang(self, what: str, item: str) -> None:
        """Raise for ``what``, which a lockstep gang does not port yet
        (ROADMAP queue A ``item``)."""
        if self._gang:
            raise NotImplementedError(
                f"{what} under a tp / ep serving gang is not ported yet "
                f"(ROADMAP queue A item {item})")

    def release_held(self, state) -> None:
        """Drop a captured handoff's page references: on a gang, on every
        rank at the next step boundary (rank 0's ``release`` command; a
        state already resumed or released is left alone); in one process,
        here."""
        if not self._gang:
            from kubeflow_tpu_torch.serving.disagg import release_handoff

            release_handoff(self.pool, state)
            return
        key = state.request._seq
        with self._work:
            held = key in self._held
        if held:
            self.command("release", key)

    def resume_held(self, state) -> GenRequest:
        """Resume a captured handoff on this engine (the colocated
        fallback): on a gang every rank seeds a slot from the pages it
        holds, at the next step boundary (rank 0's ``resume`` command)."""
        if not self._gang:
            return self.submit_handoff(state)
        key = state.request._seq
        with self._work:
            held = key in self._held
        if not held:
            raise RuntimeError("this gang holds no such handoff")
        self.command("resume", key)
        return state.request

    def _start_trace(self, req: GenRequest, trace_ctx) -> None:
        tracer = trace.get_tracer()
        if trace_ctx is not None:
            req.span = tracer.start_span("engine.request", trace_ctx)
        else:
            # a direct caller: the engine roots its own trace under head
            # sampling
            req.span = tracer.start_root("engine.request")
        req.span.set_attribute("prompt_tokens", len(req.ids))
        req.span.set_attribute("max_new_tokens", req.max_new_tokens)
        req.span.set_attribute("tenant", req.tenant)
        req.wait_span = tracer.start_span("engine.admission_wait", req.span)
        req.wait_span.set_attribute("tenant", req.tenant)

    def _enqueue(self, req: GenRequest, seed: int | None,
                 deadline_s: float | None) -> None:
        with self._work:
            if self._crash is not None:
                raise RuntimeError(f"serving engine crashed: {self._crash}")
            if self._closed:
                raise RuntimeError("serving engine is shut down")
            if self._draining:
                raise Draining("serving engine is draining (finishing "
                               "in-flight requests, accepting no new ones)")
            est_wait = self._estimated_wait_locked(req.tenant)
            if self.max_queue:
                # the bounded queue is divided by tenant share: a storming
                # tenant sheds at its own fair share while the others'
                # stay open; one flow's quota is the whole queue
                quota = fair_quota(self.max_queue, req.tenant,
                                   self.tenant_shares)
                queued = self.queue + self._pending
                waiting = (len(queued) if not self.tenant_shares
                           else sum(1 for r in queued
                                    if r.tenant == req.tenant))
                if waiting >= quota:
                    REQS_TOTAL.labels("shed").inc()
                    get_accountant().record_outcome(req.tenant, "shed")
                    raise QueueFull(
                        f"admission queue full ({quota} waiting)"
                        if not self.tenant_shares else
                        f"admission queue full for tenant {req.tenant} "
                        f"({waiting}/{quota} fair-share slots)",
                        retry_after=est_wait)
            if deadline_s is not None and est_wait >= deadline_s > 0:
                # the deadline cannot survive the queue: shed now rather
                # than prefill a request the deadline sweep will evict
                REQS_TOTAL.labels("shed").inc()
                get_accountant().record_outcome(req.tenant, "shed")
                raise QueueFull(
                    f"estimated queue wait {est_wait:.2f}s exceeds the "
                    f"request deadline {deadline_s:.2f}s",
                    retry_after=est_wait)
            if seed is None:
                self._auto_seed += 1
                seed = self._auto_seed
            req.seed = seed
            if deadline_s is not None:
                req.deadline = req.submitted_at + deadline_s
            if self._gang:
                # enqueued by the next record, on every rank alike
                self._pending.append(req)
                self._work.notify_all()
            else:
                self._enqueue_locked(req)

    def _enqueue_locked(self, req: GenRequest) -> None:
        """The one enqueue tail (lock held) of submit, handoff resume and
        failover adoption: ownership, the WFQ tag, queue append, batcher
        (re)spawn."""
        req._engine = self
        self._arrival += 1
        req._seq = self._arrival
        req._vft = self._wfq.tag(req.tenant)
        self.queue.append(req)
        QUEUE_DEPTH.set(len(self.queue))
        if not self._gang and (self._thread is None
                               or not self._thread.is_alive()):
            self._stop = False
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="serving-batcher")
            self._thread.start()
        self._work.notify_all()

    def submit_handoff(self, state, trace_ctx=None) -> GenRequest:
        """Resume a prefilled request from its handoff pages (the decode
        half of disaggregation).  In process the state carries the
        original request, its generator included; a cross-process resume
        (``request=None``) mints a request here, with a generator on this
        engine's device restored from ``state.gen_state`` (seeded from the
        request's seed when the body carried none: a greedy stream).  The
        state's page references are released at the seed or at the
        request's death.  Draining rejects only NEW work (a cross-process
        resume); an in-process handoff continues an admitted request.

        On a gang's leader a cross-process state carries its pages in
        ``state.whole`` (``disagg.deserialize_handoff``): the request
        waits for the next step record, whose page broadcast every rank
        places in its own pool (``_take_handoffs``); a held state
        (``request`` set) resumes through ``resume_held``."""
        if self._gang:
            if self.rank != 0:
                raise RuntimeError(f"rank {self.rank} of a serving gang "
                                   "takes no requests")
            if state.request is not None:
                return self.resume_held(state)
        req = state.request
        preadmitted = req is not None
        if req is None:
            req = GenRequest(list(state.ids), state.max_new_tokens,
                             state.temperature, state.eos_id,
                             seed=state.seed, top_k=state.top_k,
                             top_p=state.top_p)
            req.generated = list(state.generated)
            req.deadline = state.deadline
            req._gen = torch.Generator(device=self.device)
            if state.gen_state is not None:
                req._gen.set_state(state.gen_state)
            else:
                req._gen.manual_seed(state.seed)
            state.request = req
            self._start_trace(req, trace_ctx)
            req.wait_span.end()
        if self.spec_max and req._spec is None:
            req._spec = SpeculationState(self.spec_max)
        req._handoff = state
        with self._work:
            if self._closed:
                raise RuntimeError("serving engine is shut down")
            if self._draining and not preadmitted:
                raise Draining("serving engine is draining (finishing "
                               "in-flight requests, accepting no new ones)")
            if self._gang:
                if self._crash is not None:
                    raise RuntimeError(
                        f"serving engine crashed: {self._crash}")
                # enqueued by the next record, on every rank alike
                self._pending.append(req)
                self._work.notify_all()
            else:
                self._enqueue_locked(req)
        return req

    def adopt(self, req: GenRequest) -> bool:
        """Take over a live request from a dying sibling engine (the
        coordinator's decode failover) for a cold re-run; False when this
        engine cannot accept work.  A gang refuses it by name."""
        self.refuse_in_gang("adopting a failed-over request", "7c-ii-c")
        with self._work:
            if self._closed or self._draining:
                return False
            self._enqueue_locked(req)
        return True

    def generate_sync(self, batch: list[list[int]], max_new_tokens: int = 32,
                      temperature: float = 0.0, eos_id: int | None = None,
                      seed: int | None = None, top_k: int = 0,
                      top_p: float = 0.0,
                      deadline_s: float | None = None, trace_ctx=None,
                      tenant: str | None = None) -> list[list[int]]:
        """Submit a (possibly ragged) batch and wait for all rows;
        all-or-nothing: a failed row cancels its siblings."""
        reqs: list[GenRequest] = []
        try:
            for i, ids in enumerate(batch):
                reqs.append(self.submit(
                    ids, max_new_tokens, temperature, eos_id,
                    seed=None if seed is None else seed + i,
                    top_k=top_k, top_p=top_p, deadline_s=deadline_s,
                    trace_ctx=trace_ctx, tenant=tenant))
            return [r.result() for r in reqs]
        except BaseException:
            for r in reqs:
                r.cancel()
            raise

    def stats(self) -> dict:
        """Load snapshot: requests decoding, queued, slot capacity, plus
        this engine's TTFT and decode tallies."""
        with self._work:
            live_tokens = sum(len(s.ids) + len(s.generated)
                              for s in self.slots if s is not None)
            # a prefill-role engine's mid-prefill requests hold no slot
            # but are load (its per-role signal)
            out = {"active": (sum(1 for s in self.slots if s is not None)
                              + self._prefilling),
                   "queued": len(self.queue) + len(self._pending),
                   "max_batch": self.max_batch,
                   "timing": dict(self._timing)}
            if self.role != "colocated":
                out["role"] = self.role
                out["handoffs"] = self._handoffs
                out["resumed"] = self._resumed
            if self.max_queue:
                out["max_queue"] = self.max_queue
            if self._draining:
                out["draining"] = True
            if self.spec_max:
                tally = dict(self._spec_tally)
                out["speculative"] = {
                    "max_tokens": self.spec_max, **tally,
                    "accept_rate": (tally["accepted"] / tally["proposed"]
                                    if tally["proposed"] else 0.0)}
        pool = self.pool.stats()
        pool["live_tokens"] = live_tokens
        if self.kv_quant:
            pool["quantized"] = True
        cache = (self.prefix_cache.stats() if self.prefix_cache is not None
                 else None)
        if not self._pool_shared:
            # pages held by nobody but an in-flight admission: 0 whenever
            # the engine is idle (every committed page is cache-owned or
            # freed).  A shared pool's owner counts these instead.
            pool["orphan_pages"] = pool["in_use"] - (cache["pages"] if cache
                                                     else 0)
        out["kv_pool"] = pool
        if cache is not None:
            out["prefix_cache"] = cache
        if self.directory is not None:
            out["remote_fetches"] = self._remote_fetches
            out["directory"] = self.directory.stats()
        return out

    def _estimated_wait_locked(self, tenant: str | None = None) -> float:
        """Seconds until a new arrival would reach a slot: waiters ahead
        over slot capacity, times the observed service time (0 until the
        first request completes).  With tenant shares, the waiters and
        the capacity are the tenant's own (its queued requests over its
        share of the batch): under WFQ another tenant's backlog does not
        delay it beyond its share."""
        if self._service_ewma <= 0.0:
            return 0.0
        if not self.tenant_shares or tenant is None:
            waves = len(self.queue) / max(self.max_batch, 1)
            return waves * self._service_ewma
        weight = max(1e-9, float(self.tenant_shares.get(tenant, 1.0)))
        total = sum(max(1e-9, float(w))
                    for w in self.tenant_shares.values())
        if tenant not in self.tenant_shares:
            total += weight
        capacity = max(1e-9, max(self.max_batch, 1) * weight / total)
        waiting = sum(1 for r in self.queue if r.tenant == tenant)
        return (waiting / capacity) * self._service_ewma

    def drain(self) -> None:
        """Stop admitting; queued and in-flight requests run to the end.
        A draining engine stops being a fetch target at once."""
        with self._work:
            self._draining = True
            self._work.notify_all()
        if self.directory is not None:
            self.directory.drop_engine(self.engine_id)

    def drained(self, timeout: float = 60.0) -> bool:
        """Block until no request is queued, prefilling or decoding (or
        timeout)."""
        deadline = time.monotonic() + timeout
        with self._work:
            while (self.queue or self._pending or self._prefilling
                   or any(s is not None for s in self.slots)):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._work.wait(remaining)
        return True

    def shutdown(self) -> None:
        """Terminal: pending and in-flight requests fail; later submits
        raise.  In a gang the leader's next record carries the stop, and
        each follower's ``follow`` returns on it (a follower's own
        shutdown only closes it)."""
        with self._work:
            self._closed = True
            self._stop = True
            self._draining = False
            self._work.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
        if self.directory is not None:
            self.directory.drop_engine(self.engine_id)

    def restart(self) -> None:
        """Reopen a shut-down (or draining) engine; the batcher respawns
        on the next submit.  The pool and prefix cache survive, so the
        warm prefixes are advertised again."""
        self.refuse_in_gang("restart after shutdown", "7c-ii-c")
        with self._work:
            self._closed = False
            self._draining = False
        if self.directory is not None and self.prefix_cache is not None:
            for toks in self.prefix_cache.cached_prefixes():
                self._advertise_prefix(list(toks))

    # -- the scheduling loop ---------------------------------------------------
    _DEAD_MSG = {
        "shutdown": "serving engine shut down",
        "cancelled": "request cancelled",
        "deadline_exceeded": "request deadline exceeded",
    }

    def _dead_outcome(self, req: GenRequest,
                      now: float | None = None) -> str | None:
        if self._gang:
            # a gang takes the leader's verdicts at step boundaries only
            # (``_next_record``): a check between prefill chunks would be
            # one rank's clock, and would cost a collective per chunk
            return None
        return self._verdict(req, now)

    def _verdict(self, req: GenRequest,
                 now: float | None = None) -> str | None:
        if self._stop:
            return "shutdown"
        if req._cancel_requested:
            return "cancelled"
        if req.expired(now):
            return "deadline_exceeded"
        return None

    def _fail(self, req: GenRequest, outcome: str, msg: str) -> None:
        req.error = msg
        req.outcome = outcome
        REQS_TOTAL.labels(outcome).inc()
        get_accountant().record_outcome(req.tenant, outcome)
        # a pending handoff's page references die with the request
        self._release_handoff(req)
        # whatever span is still open closes with the outcome (end() is
        # idempotent)
        req.wait_span.end()
        req.handoff_span.end()
        req.decode_span.end()
        req.span.set_attribute("outcome", outcome)
        req.span.end()
        req._done.set()
        with self._work:
            self._work.notify_all()

    def _sweep_dead(self) -> None:
        """Evict cancelled and expired requests: queued ones before their
        prefill, seated ones between decode chunks."""
        now = time.perf_counter()
        dead: list[tuple[GenRequest, str]] = []
        with self._work:
            live = []
            for req in self.queue:
                outcome = self._dead_outcome(req, now)
                if outcome is None:
                    live.append(req)
                else:
                    dead.append((req, outcome))
            self.queue[:] = live
            QUEUE_DEPTH.set(len(self.queue))
            for i, req in enumerate(self.slots):
                if req is not None:
                    outcome = self._dead_outcome(req, now)
                    if outcome is not None:
                        self.slots[i] = None
                        dead.append((req, outcome))
            ACTIVE_SLOTS.set(sum(1 for s in self.slots if s))
        for req, outcome in dead:
            self._fail(req, outcome, self._DEAD_MSG[outcome])

    def _die_with_engine(self, dying: list[GenRequest], outcome: str,
                         msg: str) -> None:
        """The engine goes away (shutdown or crash) with live requests:
        each is first offered to ``failover_fn`` (True transfers it to a
        surviving engine); the rest fail.  Runs outside the lock: the
        failover takes a sibling engine's lock."""
        for req in dying:
            if (self.failover_fn is not None
                    and not req._cancel_requested and not req.expired()):
                try:
                    if self.failover_fn(req):
                        continue
                except Exception:
                    self.log.error("failover_fn raised", exc_info=True)
            self._fail(req, outcome, msg)

    def _loop(self) -> None:
        try:
            with torch.no_grad():
                while self._step():
                    pass
        except Exception as e:
            self.log.error("batcher loop crashed", exc_info=True)
            with self._work:
                dying = (list(self.queue) + self._pending + self._resuming
                         + [s for s in self.slots if s])
                self.queue.clear()
                self._pending, self._resuming = [], []
                self.slots = [None] * self.max_batch
                self._thread = None
                if self._gang:
                    # a broken gang stays broken: later submits raise
                    self._crash = f"{type(e).__name__}: {e}"
            self._fail_commands(f"serving engine crashed: {e}")
            self._die_with_engine(dying, "error", "serving engine crashed")

    def follow(self) -> None:
        """A follower's loop (a gang rank other than 0): receive each of
        the leader's step records, replay it and run the same step, until
        the record that stops the gang.  Raises when the gang breaks or
        this rank's tokens differ from the leader's."""
        if not self._gang or self.rank == 0:
            raise RuntimeError("follow() is for the ranks of a serving "
                               "gang other than rank 0")
        with torch.no_grad():
            while self._step():
                pass

    def _step(self) -> bool:
        """One scheduling iteration; False when the engine stopped."""
        if self._gang:
            if not self._apply_record(self._next_record()):
                return False
            self._emitted = []
            self._step_body()
            self._digest = lockstep.digest(self._emitted)
            return True
        with self._work:
            while not self._stop and not self.queue and not any(self.slots):
                self._work.wait(timeout=HEARTBEAT_S)
            if self._stop:
                dying = list(self.queue) + [s for s in self.slots if s]
                self.queue.clear()
                self.slots = [None] * self.max_batch
        if self._stop:
            self._die_with_engine(dying, "shutdown",
                                  "serving engine shut down")
            return False
        self._sweep_dead()
        self._step_body()
        return True

    def _step_body(self) -> None:
        """Admission, then one decode chunk or speculative round."""
        self._admit()
        with self._work:
            queue_empty = not self.queue
        if any(self.slots):
            if not (self.spec_max and self._spec_step()):
                self._decode_chunk(queue_empty)

    # -- lockstep (serving/lockstep.py) ----------------------------------------
    def _next_record(self) -> lockstep.StepRecord:
        """This step's record on every rank.  The leader waits for work
        (at most ``HEARTBEAT_S``: an idle leader still sends a record per
        wake, so no follower's broadcast reaches the group's timeout),
        enqueues its pending requests, takes the verdicts of its clock and
        cancel flags, and broadcasts; a follower receives, enqueues the
        same requests in the same order and checks the leader's digest of
        the previous step against its own."""
        if self.rank != 0:
            rec = lockstep.exchange(None, self.record_tally, self._group)
            if rec.digest != self._digest:
                raise RuntimeError(
                    f"serving gang diverged: rank {self.rank}'s tokens of "
                    "the last step differ from rank 0's (digest "
                    f"{self._digest:#x} against {rec.digest:#x})")
            with self._work:
                for n in rec.new:
                    req = GenRequest(
                        list(n.ids), n.max_new_tokens, n.temperature,
                        n.eos_id, seed=n.seed, top_k=n.top_k, top_p=n.top_p,
                        tenant=n.tenant,
                        # the leader's clock decides; this only marks it
                        deadline=math.inf if n.has_deadline else None)
                    if self.spec_max:
                        req._spec = SpeculationState(self.spec_max)
                    self._enqueue_locked(req)
                    if req._seq != n.seq:
                        raise RuntimeError(
                            f"serving gang diverged: rank {self.rank} "
                            f"enqueued #{req._seq} as the leader's "
                            f"#{n.seq}")
            self._take_handoffs(rec.handoffs, None)
            return rec
        with self._work:
            if not (self._stop or self.queue or self._pending
                    or self._commands or any(self.slots)):
                self._work.wait(timeout=HEARTBEAT_S)
            rec = lockstep.StepRecord(stop=self._stop, digest=self._digest)
            if not rec.stop:
                busy = bool(self.queue or self._pending or any(self.slots))
                for cmd in self._commands:
                    if cmd.kind == "park" and busy:
                        # the weights of a live request stay
                        cmd.finish(error="cannot park a serving engine "
                                   "with live requests")
                        continue
                    rec.commands.append((cmd.kind, cmd.arg))
                    self._in_flight.append(cmd)
                self._commands = []
            resumes = self._resuming = []
            for req in self._pending:
                if req._handoff is not None:
                    # a ``:resume`` handoff goes after the new requests;
                    # a stop fails it here
                    if rec.stop:
                        self._enqueue_locked(req)
                    else:
                        resumes.append(req)
                    continue
                self._enqueue_locked(req)
                rec.new.append(lockstep.NewRequest(
                    req._seq, req.ids, req.max_new_tokens, req.temperature,
                    req.eos_id, req.seed, req.top_k, req.top_p,
                    req.deadline is not None, req.tenant))
            self._pending = []
            for req in resumes:
                st = req._handoff
                rec.handoffs.append(lockstep.Handoff(
                    st.ids, st.max_new_tokens, st.temperature, st.eos_id,
                    st.seed, st.top_k, st.top_p, req.deadline is not None,
                    st.generated[0], len(st.whole[0]["k"]),
                    b"" if st.gen_state is None
                    else st.gen_state.numpy().tobytes()))
            if not rec.stop:
                now = time.perf_counter()
                for req in self.queue + [r for r in self.slots if r]:
                    outcome = self._verdict(req, now)
                    if outcome is not None:
                        rec.dead.append((req._seq, outcome))
        rec = lockstep.exchange(rec, self.record_tally, self._group)
        self._take_handoffs(rec.handoffs, list(resumes))
        return rec

    # -- a decode gang's handoffs ----------------------------------------------
    def _wire_layout(self, n: int) -> list[list[tuple]]:
        """Per layer, ``(name, shape, dtype, padded bytes)`` of a handoff's
        ``n`` pages at every KV head, in the page broadcast's order."""
        cfg = self.cfg
        kv = ((n, self.page_size, cfg.num_kv_heads, cfg.head_dim),
              torch.int8 if self.kv_quant else cfg.torch_dtype)
        scale = ((n, 1, cfg.num_kv_heads, 1), torch.float32)
        names = ("k", "ks", "v", "vs") if self.kv_quant else ("k", "v")
        out = []
        for _ in range(cfg.num_layers):
            layer = []
            for name in names:
                shape, dt = scale if name in ("ks", "vs") else kv
                nbytes = math.prod(shape) * dt.itemsize
                layer.append((name, shape, dt, nbytes + (-nbytes) % 8))
            out.append(layer)
        return out

    def _take_handoffs(self, entries: list, reqs: list | None) -> None:
        """The record's ``:resume`` handoffs on this rank, in order: each
        one's pages in one broadcast on the model's group (the leader's
        ``state.whole``, every KV head), this rank's heads put into pages
        it allocates here (every rank's pool hands out the same ids), and
        the request enqueued; a pool that cannot host them sheds it, on
        every rank alike.  ``reqs``: the leader's requests (None on a
        follower, which mints them from the record); each stays in
        ``_resuming`` until it is enqueued or shed, so a broadcast that
        raises leaves it to the crash path."""
        for i, h in enumerate(entries):
            layout = self._wire_layout(h.n_pages)
            nbytes = sum(b for layer in layout for *_, b in layer)
            req = None if reqs is None else reqs[i]
            buf = None
            if req is not None:
                parts = []
                for layer, want in zip(req._handoff.whole, layout):
                    for name, _, dt, b in want:
                        raw = layer[name].to(dt).contiguous().reshape(
                            -1).view(torch.uint8)
                        parts += [raw, raw.new_zeros(b - raw.numel())]
                buf = torch.cat(parts).to(self.device)
            t0 = time.perf_counter()
            got = lockstep.exchange_pages(buf, nbytes, self.device,
                                          self.record_tally, self._group)
            if req is None:
                req = self._follower_handoff(h)
            state = req._handoff
            state.whole = None
            state.timing["broadcast_s"] = time.perf_counter() - t0
            state.timing["broadcast_bytes"] = nbytes
            hk = self.cfg.num_kv_heads // self.tp
            first = (self.mesh.coordinate("tp") if self.tp > 1 else 0) * hk
            mine, at = [], 0
            for want in layout:
                tensors = {}
                for name, shape, dt, b in want:
                    size = math.prod(shape) * dt.itemsize
                    tensors[name] = got[at:at + size].view(dt).reshape(
                        shape).narrow(2, first, hk)
                    at += b
                mine.append(tensors)
            pids = self.pool.alloc(h.n_pages)
            while pids is None:
                if (self.prefix_cache is None
                        or not self.prefix_cache.evict_lru()):
                    break
                pids = self.pool.alloc(h.n_pages)
            if pids is None:
                if reqs is not None:
                    with self._work:
                        self._resuming.remove(req)
                self._fail(req, "shed", f"decode worker kv pool cannot host "
                           f"{h.n_pages} handoff pages")
                continue
            self.pool.put_many(pids, mine)
            state.pages = pids
            with self._work:
                if reqs is not None:
                    self._resuming.remove(req)
                self._enqueue_locked(req)

    def _follower_handoff(self, h) -> GenRequest:
        """A follower's request and state for the leader's ``:resume``
        handoff ``h``: its generator restored from the same state."""
        from kubeflow_tpu_torch.serving.disagg import HandoffState, seed_words

        req = GenRequest(list(h.ids), h.max_new_tokens, h.temperature,
                         h.eos_id, seed=h.seed, top_k=h.top_k, top_p=h.top_p,
                         # the leader's clock decides; this only marks it
                         deadline=math.inf if h.has_deadline else None)
        req.generated = [h.first_token]
        req._gen = torch.Generator(device=self.device)
        if h.gen_state:
            req._gen.set_state(torch.frombuffer(bytearray(h.gen_state),
                                                dtype=torch.uint8))
        else:
            req._gen.manual_seed(h.seed)
        if self.spec_max:
            req._spec = SpeculationState(self.spec_max)
        req._handoff = HandoffState(
            ids=list(h.ids), generated=[h.first_token],
            max_new_tokens=h.max_new_tokens, temperature=h.temperature,
            eos_id=h.eos_id, seed=h.seed, top_k=h.top_k, top_p=h.top_p,
            pages=[], key_chain=seed_words(h.seed), deadline=req.deadline,
            committed_at=time.perf_counter(), request=req)
        return req

    def _apply_record(self, rec: lockstep.StepRecord) -> bool:
        """The record's stop (every live request dies with the engine:
        False), or its verdicts (each named request fails as the leader
        found it) and then its residency commands, in order: the step
        boundary, before admission.  A command that raises breaks the
        gang (the leader's crash path, a follower's ``follow``)."""
        with self._work:
            if rec.stop:
                dying = list(self.queue) + [s for s in self.slots if s]
                self.queue.clear()
                self.slots = [None] * self.max_batch
            else:
                verdicts = dict(rec.dead)
                dying = [r for r in self.queue if r._seq in verdicts]
                self.queue[:] = [r for r in self.queue
                                 if r._seq not in verdicts]
                QUEUE_DEPTH.set(len(self.queue))
                for i, r in enumerate(self.slots):
                    if r is not None and r._seq in verdicts:
                        self.slots[i] = None
                        dying.append(r)
                ACTIVE_SLOTS.set(sum(1 for r in self.slots if r))
        if rec.stop:
            self._fail_commands("serving engine shut down")
            self._die_with_engine(dying, "shutdown",
                                  "serving engine shut down")
            return False
        for r in dying:
            outcome = verdicts[r._seq]
            self._fail(r, outcome, self._DEAD_MSG[outcome])
        for kind, arg in rec.commands:
            result = self._apply_command(kind, arg)
            if self.rank == 0:
                with self._work:
                    cmd = self._in_flight.pop(0)
                cmd.finish(result)
        return True

    def _relieve(self) -> bool:
        """Page pressure: whether ``pressure_fn`` (the residency pool's
        relieve) made room, so the alloc retries.  In a gang every rank
        meets the pressure at the same point of the same step (the pools
        are in lockstep): the leader runs ``pressure_fn``, whose evictor
        is a sibling's gang-wide park, and broadcasts its verdict (made
        room, the sibling park's ticket or -1, the pages donated) on
        this model's group; a follower waits until its own sibling has
        applied that park, then donates the same pages.  The wait cannot
        cycle: only the sibling's engine thread applies its park, and the
        sibling is idle (the pool evicts unpinned models only, and the
        model meeting pressure is pinned by its request's lease), so that
        thread waits on nothing but its own group's records; the pool runs
        the evictor outside its lock.  There is no broadcast in a step
        that meets no pressure."""
        if not self._gang:
            return self.pressure_fn is not None and bool(self.pressure_fn())
        verdict = [0, -1, 0]
        if self.rank == 0 and self.pressure_fn is not None:
            pages = self.pressure_pages
            _last_park.ticket, before = -1, pages.donated
            self._relieving = True
            try:
                ok = bool(self.pressure_fn())
            finally:
                self._relieving = False
            verdict = [int(ok), _last_park.ticket, pages.donated - before]
        t0 = time.perf_counter()
        ok, ticket, donated = pd.broadcast_one_to_all(
            torch.tensor(verdict, dtype=torch.int64), self._group).tolist()
        tally = self.record_tally
        tally["pressure_calls"] = tally.get("pressure_calls", 0) + 1
        tally["pressure_seconds"] = tally.get("pressure_seconds", 0.0) + (
            time.perf_counter() - t0)
        if self.rank != 0:
            if ticket >= 0:
                with _PARKS:
                    if not _PARKS.wait_for(lambda: ticket in _PARKED_TICKETS,
                                           timeout=pd.GROUP_TIMEOUT_S):
                        raise RuntimeError(
                            f"serving gang: the sibling park #{ticket} the "
                            "leader's page pressure waited for never came")
            if donated > 0:
                self.pool.donate(donated)
        return bool(ok)

    def _emit(self, req: GenRequest, tok: int) -> None:
        """Append a generated token (and, in a gang, note it for the
        step's digest)."""
        req.generated.append(tok)
        if self._gang:
            self._emitted += (req._seq, tok)

    def _admit(self) -> None:
        """WFQ admission (the smallest virtual finish tag, arrival order
        breaking ties: FIFO with one flow), at most ``max_batch`` per call
        so requests done at admission cannot starve in-flight decode.  A handoff seed and a
        colocated prefill need a free slot; a prefill-role engine's own
        admissions take none (they prefill, commit and hand off)."""
        for _ in range(self.max_batch):
            with self._work:
                if not self.queue:
                    QUEUE_DEPTH.set(0)
                    return
                head = min(self.queue, key=lambda r: (r._vft, r._seq))
                needs_slot = not (self.role == "prefill"
                                  and head._handoff is None)
                free = next((i for i, s in enumerate(self.slots)
                             if s is None), None)
                if needs_slot and free is None:
                    QUEUE_DEPTH.set(len(self.queue))
                    return
                self.queue.remove(head)
                req = head
                self._wfq.advance(req._vft)
                QUEUE_DEPTH.set(len(self.queue))
                if not needs_slot:
                    self._prefilling += 1
            try:
                if req._handoff is not None:
                    self._admit_handoff(free, req)
                elif not needs_slot:
                    self._admit_prefill(req)
                else:
                    self._admit_colocated(free, req)
            finally:
                if not needs_slot:
                    with self._work:
                        self._prefilling -= 1
                        self._work.notify_all()

    def _start_admission(self, req: GenRequest) -> None:
        req.admitted_at = time.perf_counter()
        wait = req.admitted_at - req.submitted_at
        ADMISSION_WAIT.observe(wait)
        TENANT_ADMISSION_WAIT.labels(req.tenant).observe(wait)
        get_accountant().record_admission_wait(req.tenant, wait)
        req.wait_span.end()
        req._gen = torch.Generator(device=self.device).manual_seed(req.seed)

    def _first_token(self, req: GenRequest, tok: int) -> None:
        req.first_token_at = time.perf_counter()
        ttft = req.first_token_at - req.submitted_at
        TTFT_HIST.observe(ttft)
        TENANT_TTFT.labels(req.tenant).observe(ttft)
        self._emit(req, tok)
        TOKENS_TOTAL.inc()
        with self._work:
            t = self._timing
            t["ttft_sum"] += ttft
            t["ttft_count"] += 1

    def _admit_colocated(self, free: int, req: GenRequest) -> None:
        """Prefill the prompt and seat it in slot ``free``."""
        outcome = self._dead_outcome(req)
        if outcome is not None:
            self._fail(req, outcome, self._DEAD_MSG[outcome])
            return
        self._start_admission(req)
        tok, _ = self._run_prefill(req)
        outcome = self._dead_outcome(req)
        if tok is None or outcome is not None:
            outcome = outcome or "cancelled"
            self._fail(req, outcome, self._DEAD_MSG[outcome])
            return
        self._first_token(req, tok)
        self._seat(free, req)

    def _admit_prefill(self, req: GenRequest) -> None:
        """Prefill-role admission: run the prompt, commit its KV to pool
        pages and hand the request off.  A request complete at its first
        token finishes here; one whose pages the pool cannot host decodes
        in a local slot (availability over purity), or sheds when no slot
        is free either."""
        outcome = self._dead_outcome(req)
        if outcome is not None:
            self._fail(req, outcome, self._DEAD_MSG[outcome])
            return
        self._start_admission(req)
        tok, pages = self._run_prefill(req, want_pages=True)
        if tok is None:
            outcome = self._dead_outcome(req) or "cancelled"
            self._fail(req, outcome, self._DEAD_MSG[outcome])
            return
        self._first_token(req, tok)
        outcome = self._dead_outcome(req)
        hit_eos = req.eos_id is not None and tok == req.eos_id
        if outcome is not None or len(req.generated) >= req.max_new_tokens \
                or hit_eos:
            if pages is not None:
                self.pool.decref(pages)
            if outcome is not None:
                self._fail(req, outcome, self._DEAD_MSG[outcome])
            else:
                self._complete_ok(req)
            return
        if pages is None:
            with self._work:
                free = next((i for i, s in enumerate(self.slots)
                             if s is None), None)
            if free is None:
                self._fail(req, "shed", "kv page pool exhausted and no "
                           "local slot for colocated fallback")
                return
            self._seat(free, req)
            return
        from kubeflow_tpu_torch.serving.disagg import HandoffState, seed_words

        state = HandoffState(
            ids=list(req.ids), generated=list(req.generated),
            max_new_tokens=req.max_new_tokens, temperature=req.temperature,
            eos_id=req.eos_id, seed=req.seed, top_k=req.top_k,
            top_p=req.top_p, pages=pages, key_chain=seed_words(req.seed),
            deadline=req.deadline, committed_at=time.perf_counter(),
            request=req)
        req._handoff = state
        req.handoff_span = trace.get_tracer().start_span(
            "engine.prefill_handoff", req.span, pages=len(pages))
        HANDOFFS.inc()
        with self._work:
            self._handoffs += 1
        if self._gang:
            # the wire carries every KV head: gathered here, inside the
            # step, where every rank of the tp group takes part (a
            # follower in ``follow()`` would never join a later one)
            state.whole = self._gather_pages(pages, state.timing)
            with self._work:
                self._held[req._seq] = state
            if self.rank != 0:
                return
        try:
            self.handoff_fn(req, state)
        except Exception as e:
            self.log.warning("prefill handoff failed", error=str(e))
            self._fail(req, "error", f"prefill handoff failed: {e}")

    def _gather_pages(self, pages: list[int], timing: dict) -> list | None:
        """Every KV head of ``pages`` (per layer ``{name: [n, page, Hkv,
        ...]}``, int8 pages with their per-(page, head) scales, which
        gather exactly): this rank's rows, concatenated over the tp group
        in head order (the KV heads are whole on each ep rank).  Rank 0
        keeps them in host memory, where the body is built, so no card
        holds a second copy of the pages while the peer decodes; the
        others drop theirs and return None.  One ``all_gather`` per
        tensor: gloo gathers only host tensors to one rank."""
        t0 = time.perf_counter()
        n = len(pages)
        bufs = [{name: torch.empty((n,) + tuple(t.shape[1:]), dtype=t.dtype,
                                   device=t.device)
                 for name, t in layer.items()}
                for layer in self.pool.kv["layers"]]
        self.pool.gather(pages, bufs)
        group = self.mesh.group("tp")
        whole, nbytes = [], 0
        for layer in bufs:
            got = {}
            for name, t in layer.items():
                if group is not None:
                    t = pd.all_gather_cat(t, 2, group)
                nbytes += t.numel() * t.element_size()
                if self.rank == 0:
                    got[name] = t.cpu()
            whole.append(got)
        dt = time.perf_counter() - t0
        timing["gather_s"], timing["gather_bytes"] = dt, nbytes
        tally = self.record_tally
        tally["gather_calls"] = tally.get("gather_calls", 0) + 1
        tally["gather_bytes"] = tally.get("gather_bytes", 0) + nbytes
        tally["gather_seconds"] = tally.get("gather_seconds", 0.0) + dt
        return whole if self.rank == 0 else None

    def _admit_handoff(self, free: int, req: GenRequest) -> None:
        """Decode-side admission: seed the scratch from the handoff's pages
        (dequantized when int8), drop their references, and seat the
        request; its generator continues where the prefill left it."""
        state = req._handoff
        outcome = self._dead_outcome(req)
        if outcome is not None:
            self._fail(req, outcome, self._DEAD_MSG[outcome])
            return
        if req.admitted_at is None:
            req.admitted_at = time.perf_counter()
        self._seed_scratch(state.pages, self._scratch())
        if state.committed_at is not None:
            HANDOFF_WAIT.observe(time.perf_counter() - state.committed_at)
        self._release_handoff(req)
        req.handoff_span.end()
        with self._work:
            self._resumed += 1
        self._seat(free, req)

    def _complete_ok(self, req: GenRequest) -> None:
        """Terminal success without a decode slot (a prefill-role request
        done at its first token)."""
        with self._work:
            dur = time.perf_counter() - (req.admitted_at or req.submitted_at)
            self._service_ewma = (dur if self._service_ewma <= 0.0
                                  else 0.8 * self._service_ewma + 0.2 * dur)
            self._work.notify_all()
        req.outcome = "ok"
        REQS_TOTAL.labels("ok").inc()
        get_accountant().record_outcome(req.tenant, "ok")
        req.span.set_attribute("outcome", "ok")
        req.span.end()
        req._done.set()

    def _release_handoff(self, req: GenRequest) -> None:
        """Drop a pending handoff's page references exactly once and
        detach it (idempotent; the guard lives in
        ``disagg.release_handoff``)."""
        state, req._handoff = req._handoff, None
        if state is not None:
            from kubeflow_tpu_torch.serving.disagg import release_handoff

            release_handoff(self.pool, state)

    def _scratch(self) -> list[dict]:
        if self._scratch_kv is None:
            shape = sharded.cache_block((1, self.max_seq,
                                         self.cfg.num_kv_heads,
                                         self.cfg.head_dim), self.mesh)
            dt = self.cfg.torch_dtype
            self._scratch_kv = [
                {"k": torch.zeros(shape, dtype=dt, device=self.device),
                 "v": torch.zeros(shape, dtype=dt, device=self.device)}
                for _ in range(self.cfg.num_layers)]
        return self._scratch_kv

    def _seed_scratch(self, pages: list[int], scratch: list[dict]) -> None:
        """Copy committed pages into the scratch head, in order (one
        gather per layer and tensor); int8 pages are gathered with their
        scales and dequantized into the model dtype.  Positions past
        ``max_seq`` are dropped."""
        n = len(pages)
        span = n * self.page_size
        if not self.kv_quant and span <= self.max_seq:
            self.pool.gather(pages, [(l["k"][0, :span], l["v"][0, :span])
                                     for l in scratch])
            return
        store = self.pool.kv["layers"]
        bufs = [{name: torch.empty((n,) + tuple(t.shape[1:]), dtype=t.dtype,
                                   device=t.device)
                 for name, t in layer.items()} for layer in store]
        self.pool.gather(pages, bufs)
        keep = min(span, self.max_seq)
        dt = self.cfg.torch_dtype
        for l, b in zip(scratch, bufs):
            for name in ("k", "v"):
                x = b[name]
                if self.kv_quant:
                    x = dequantize_kv(x, b[name + "s"], dt)
                l[name][0, :keep] = x.reshape((span,) + x.shape[2:])[:keep]

    def _fill_tail(self, scratch: list[dict], written: int, end: int,
                   seed: tuple | None) -> None:
        """Make scratch positions ``[written, end)`` (the tail page's past
        everything this prompt wrote) what the reference's scratch holds
        there: its warm seed's padding, ``seed = (last seeded page, seed
        span)``, repeats that page below the span, and zeros follow."""
        if written >= end:
            return
        ps = self.page_size
        page, span = seed if seed is not None else (None, 0)
        rep_end = min(end, span) if page is not None else written
        rows = (torch.arange(written, rep_end, device=self.device) % ps
                if rep_end > written else None)
        tree = self.pool.get(page)["layers"] if rows is not None else None
        dt = self.cfg.torch_dtype
        for li, l in enumerate(scratch):
            for name in ("k", "v"):
                t = l[name][0]
                if rows is not None:
                    src = tree[li][name]
                    if self.kv_quant:
                        src = dequantize_kv(src, tree[li][name + "s"], dt)
                    t[written:rep_end] = src[rows]
                t[max(written, rep_end):end].zero_()

    def _run_prefill(self, req: GenRequest, want_pages: bool = False
                     ) -> tuple[int | None, list[int] | None]:
        """Prefill the prompt into the batch-1 scratch in chunks and sample
        the first token at the last real position: ``(token, pages)``,
        ``(None, None)`` when the request died between chunks (the pin is
        still released).

        With a prefix cache, a longest-prefix HIT seeds the scratch head
        from the cached pages and prefills only the suffix; the prompt's
        new pages are then committed and inserted into the radix tree
        inside the pin window.  The per-position KV and the last
        position's logits do not depend on how the prompt is split, so
        warm and cold streams are the same.  ``want_pages`` (prefill
        role) commits EVERY prompt page and returns their ids with one
        handoff reference each (None when the pool cannot host them)."""
        prompt_len = len(req.ids)
        ps = self.page_size
        scratch = self._scratch()
        node, usable = None, 0
        if self.prefix_cache is not None:
            if self.directory is not None and self.fetch_fn is not None:
                # a peer holding more of this prompt: pull its pages in
                # first, so the pinned match below sees a local hit
                self._maybe_fetch_remote(req)
            node, matched = self.prefix_cache.match(req.ids, pin=True)
            # always leave >= 1 suffix token: the first token's logits
            # come from the suffix prefill (pages hold KV, not logits)
            usable = min(matched, prompt_len - 1)
            if node is not None and usable <= 0:
                self.prefix_cache.release(node)
                node, usable = None, 0
            (PREFIX_HITS if node is not None else PREFIX_MISSES).inc()
            req.span.set_attribute("prefix_cache",
                                   "hit" if node is not None else "miss")
            req.span.set_attribute("prefix_matched_tokens", usable)
        tracer = trace.get_tracer()
        try:
            written, seed = 0, None
            if node is not None:
                # spilled pages fault back before the gather reads them
                # (same stream); the tail page's positions past ``usable``
                # and the scratch beyond the seed hold garbage that the
                # suffix prefill overwrites before any query reads it.
                # Cached pages lie inside max_seq, so the seed fits.
                n_seed = pages_for(usable, ps)
                self.prefix_cache.fault(node)
                self._seed_scratch(node.pages[:n_seed], scratch)
                written = n_seed * ps
                bucket = next((b for b in SEED_BUCKETS if b >= n_seed),
                              self.pages_per_seq)
                seed = (node.pages[n_seed - 1], min(bucket * ps,
                                                    self.max_seq))
            pos = usable
            while True:
                if self._dead_outcome(req) is not None:
                    return None, None
                take = min(prompt_len - pos, self.prefill_chunk)
                # pad to a bucket, never past max_seq
                room = self.max_seq - pos
                cb = next((b for b in PREFILL_BUCKETS if take <= b <= room),
                          take)
                chunk = req.ids[pos:pos + take] + [0] * (cb - take)
                ids = torch.tensor([chunk], dtype=torch.int64,
                                   device=self.device)
                cache = {"layers": [dict(l, index=pos) for l in scratch]}
                # the span closes once the chunk's kernels are issued: it
                # times their dispatch (no synchronize)
                with tracer.start_span("engine.prefill", req.span,
                                       tokens=take, start_pos=pos,
                                       bucket=cb):
                    out = self.model(ids, cache=cache)
                PREFILL_DISPATCHES.inc()
                PREFILL_TOKENS.inc(take)
                with self._work:
                    self._timing["prefill_chunks"] += 1
                written = max(written, pos + cb)
                pos += take
                if pos >= prompt_len:
                    break
            logits = self._whole_vocab(out["logits"][0, take - 1][None])
            tok = int(sample_rows(logits, [req], [req._gen])[0])
            fully_cached = node is not None and usable >= prompt_len - 1
            commit = want_pages or (self.prefix_cache is not None
                                    and not fully_cached)
            if commit and self.kv_quant:
                end = min(pages_for(prompt_len, ps), self.max_seq // ps) * ps
                self._fill_tail(scratch, written, end, seed)
            pages = None
            if want_pages:
                pages = self._commit_and_insert(req.ids, usable, node,
                                                scratch, for_handoff=True)
            elif commit:
                # cache the whole prompt: shared pages by reference, only
                # the pages past the match are committed
                self._commit_and_insert(req.ids, usable, node, scratch)
            return tok, pages
        finally:
            if node is not None:
                self.prefix_cache.release(node)

    def _commit_and_insert(self, ids: list[int], usable: int, node,
                           scratch: list[dict],
                           for_handoff: bool = False) -> list[int] | None:
        """Commit the prompt's new pages (past the shared prefix) from the
        prefill scratch into the pool (quantized when int8) and insert the
        prompt into the radix tree.  Pool pressure evicts LRU cache
        entries; if the pool still cannot host the pages the prompt is not
        cached: admission never blocks on cache capacity.

        ``for_handoff`` commits EVERY page the prompt touches and returns
        all their ids with ONE handoff reference each (fresh pages keep
        their alloc reference, shared ones gain one); None when the pool
        cannot host them."""
        ps = self.page_size
        if for_handoff:
            needed = pages_for(len(ids), ps)
        else:
            # only pages that lie FULLY inside the scratch: a page
            # straddling max_seq would hold positions the scratch does not
            # have.  The uncovered prompt tail is not cached.
            needed = min(pages_for(len(ids), ps), self.max_seq // ps)
            ids = ids[:needed * ps]
        shared = usable // ps if node is not None else 0
        n_new = needed - shared
        if n_new <= 0 or not ids:
            return None
        fresh = self.pool.alloc(n_new)
        while fresh is None:
            # residency arbitration first: an idle model's weights are
            # colder than anything in the prefix cache
            if self._relieve():
                fresh = self.pool.alloc(n_new)
                continue
            if self.prefix_cache is None or not self.prefix_cache.evict_lru():
                return None
            fresh = self.pool.alloc(n_new)
        first, end = shared * ps, needed * ps
        layers = []
        for l in scratch:
            k, v = l["k"][0, first:end], l["v"][0, first:end]
            if self.kv_quant:
                shape = (n_new, ps) + tuple(k.shape[1:])
                kq, kscale = quantize_kv(k.reshape(shape))
                vq, vscale = quantize_kv(v.reshape(shape))
                layers.append({"k": kq, "ks": kscale, "v": vq, "vs": vscale})
            else:
                layers.append((k, v))
        self.pool.put_many(fresh, layers)
        shared_ids = list(node.pages[:shared]) if shared else []
        if self.prefix_cache is not None:
            if self.prefix_cache.insert(ids, shared_ids + fresh):
                self._advertise_prefix(ids)
        if for_handoff:
            if shared_ids:
                self.pool.incref(shared_ids)
            return shared_ids + fresh
        # the tree holds its own references now; drop the alloc's
        self.pool.decref(fresh)
        return None

    # -- cluster prefix reuse --------------------------------------------------
    def _advertise_prefix(self, ids) -> None:
        """Register every full-page prefix of ``ids`` in the directory
        (advisory: a failure costs a routing hint, never this request)."""
        if self.directory is None:
            return
        try:
            self.directory.advertise(self.engine_id, self.engine_addr, ids)
        except Exception:
            self.log.warning("prefix advertise failed", exc_info=True)

    def _withdraw_prefix(self, tokens) -> None:
        """The prefix cache's eviction callback: the dropped node's pages
        are gone, so are its directory entries."""
        if self.directory is None:
            return
        try:
            self.directory.withdraw(self.engine_id, tokens)
        except Exception:
            self.log.warning("prefix withdraw failed", exc_info=True)

    def _maybe_fetch_remote(self, req: GenRequest) -> None:
        """Pull a peer's prefix pages into the LOCAL radix tree when the
        directory knows an owner covering strictly more full pages of
        this prompt than the local match.  On success the caller's pinned
        match sees a warm hit; a stale entry or a failed fetch degrades to
        a local prefill, never a wrong stream."""
        from kubeflow_tpu_torch.serving.disagg import (parse_page_trees,
                                                       put_trees)
        from kubeflow_tpu_torch.serving.kv_directory import (
            REMOTE_FETCH_WAIT, REMOTE_FETCHES)

        _, local = self.prefix_cache.match(req.ids)  # unpinned peek
        hit = self.directory.lookup(req.ids, exclude=self.engine_id)
        if hit is None:
            return
        if hit["matched"] // self.page_size <= local // self.page_size:
            return
        t0 = time.perf_counter()
        try:
            payload = self.fetch_fn(hit, list(req.ids[:hit["matched"]]))
        except Exception as e:
            self.log.warning("remote prefix fetch failed",
                             owner=hit["engine_id"], error=str(e))
            return
        if not isinstance(payload, dict) or not payload.get("pages"):
            return
        try:
            trees = parse_page_trees(payload["pages"], self)
        except ValueError as e:
            self.log.warning("remote prefix pages rejected", error=str(e))
            return
        # the owner revalidated against its own tree: it may cover fewer
        # tokens than advertised, and only whole shipped pages count
        m = min(int(payload.get("matched", 0)), hit["matched"],
                len(trees) * self.page_size)
        n = m // self.page_size
        if n <= 0:
            return
        trees = trees[:n]
        pids = self.pool.alloc(n)
        while pids is None:
            if self._relieve():
                pids = self.pool.alloc(n)
                continue
            if not self.prefix_cache.evict_lru():
                return   # the pool cannot host the import: prefill locally
            pids = self.pool.alloc(n)
        put_trees(self.pool, pids, trees)
        inserted = self.prefix_cache.insert(
            list(req.ids[:n * self.page_size]), pids)
        # the tree holds its own references now (or refused the insert)
        self.pool.decref(pids)
        if inserted:
            wait = time.perf_counter() - t0
            REMOTE_FETCHES.inc()
            REMOTE_FETCH_WAIT.observe(wait)
            with self._work:
                self._remote_fetches += 1

    def export_prefix(self, ids: list[int]) -> dict:
        """Serve a peer's prefix-page fetch (the ``:pages`` verb): the FULL
        pages covering the longest local match, in the handoff wire
        format, from whichever tier holds them (a spilled page ships from
        host RAM without a fault).  ``matched`` 0 when the tree cannot
        cover one full page."""
        from kubeflow_tpu_torch.serving.disagg import encode_page

        empty = {"matched": 0, "pages": []}
        if self.prefix_cache is None or not ids:
            return empty
        node, usable = self.prefix_cache.match(list(ids), pin=True)
        if node is None:
            return empty
        try:
            n = usable // self.page_size
            if n <= 0:
                return empty
            pages = [encode_page(self.pool.get(p)) for p in node.pages[:n]]
            return {"matched": n * self.page_size, "pages": pages}
        finally:
            self.prefix_cache.release(node)

    def _seat(self, free: int, req: GenRequest) -> None:
        """Install the prefilled scratch as slot ``free``'s view row and
        make the request decodable."""
        n = len(req.ids)
        for vl, sl in zip(self.view, self._scratch()):
            vl["k"][free, :n].copy_(sl["k"][0, :n])
            vl["v"][free, :n].copy_(sl["v"][0, :n])
        # the decode span opens at seating and closes at the terminal
        # outcome (_finish_if_done / _fail)
        req.decode_span = trace.get_tracer().start_span("engine.decode",
                                                        req.span)
        with self._work:
            self.slots[free] = req
            ACTIVE_SLOTS.set(sum(1 for s in self.slots if s))
        self._finish_if_done(free)

    def _chunk_len(self, queue_empty: bool) -> int:
        remaining = [s.max_new_tokens - len(s.generated)
                     for s in self.slots if s]
        # any slot that can free mid-chunk keeps chunks small while
        # someone waits (the sweep only runs between chunks)
        # (a gang reads no cancel flag here: on the leader it may flip
        # mid-step, and every rank must size the chunk alike)
        reclaim = any(s.eos_id is not None or s.deadline is not None
                      or (s._cancel_requested and not self._gang)
                      for s in self.slots if s)
        if not queue_empty and reclaim:
            return DECODE_CHUNKS[0]
        # one slightly-too-long chunk beats two syncs: overshoot rows are
        # dropped and the index restored from host truth
        mn = min(remaining)
        over = next((c for c in DECODE_CHUNKS if c >= mn), None)
        if over is not None and over <= mn * 1.25:
            return over
        return next((c for c in reversed(DECODE_CHUNKS) if c <= mn),
                    DECODE_CHUNKS[0])

    def _decode_chunk(self, queue_empty: bool) -> None:
        chunk = self._chunk_len(queue_empty)
        if self.spec_max:
            # speculation re-probes at dispatch boundaries: a slot whose
            # drafts have been landing (or a lone stream) gets the tight
            # cadence, every other a moderate cap (the 0.65 bar sits above
            # note_skip's optimistic reset of 0.6)
            hot = any(s is not None and s._spec.accept_ewma > 0.65
                      for s in self.slots)
            solo = sum(1 for s in self.slots if s) == 1
            chunk = min(chunk, 32 if hot or solo else 64)
        reqs = list(self.slots)
        gens = [r._gen if r is not None else None for r in reqs]
        # host truth: next write slot = prompt + generated - 1 (the last
        # generated token is the next input; its KV is not cached yet)
        index = torch.tensor(
            [len(r.ids) + len(r.generated) - 1 if r else 0 for r in reqs],
            dtype=torch.int64, device=self.device)
        tok = torch.tensor([r.generated[-1] if r else 0 for r in reqs],
                           dtype=torch.int64, device=self.device)
        t0 = time.perf_counter()
        toks = []
        for _ in range(chunk):
            cache = {"layers": [dict(l, index=index) for l in self.view]}
            out = self.model(tok[:, None], cache=cache)
            tok = sample_rows(self._whole_vocab(out["logits"][:, 0]), reqs,
                              gens)
            toks.append(tok)
            index = index + 1
        host = torch.stack(toks).tolist()        # [chunk, B]: the sync
        dt = time.perf_counter() - t0
        taken = 0
        acct = get_accountant()
        n_active = sum(1 for r in reqs if r is not None)
        for i, req in enumerate(reqs):
            if req is None:
                continue
            if req._spec is not None:
                # the drafter sat out a whole chunk: let it re-probe soon,
                # weighted by how much of the stream went by
                req._spec.note_skip(weight=chunk // 32)
            want = req.max_new_tokens - len(req.generated)
            row_taken = 0
            for step in range(min(chunk, want)):
                t = host[step][i]
                self._emit(req, t)
                row_taken += 1
                if req.eos_id is not None and t == req.eos_id:
                    break
            taken += row_taken
            # the tenant bills its tokens and an equal split of the
            # dispatch's wall time (every occupied slot rode it)
            acct.record_decode_tokens(req.tenant, row_taken)
            acct.record_slice_seconds(req.tenant, dt / max(1, n_active))
        # counters before completion events: a woken caller sees them
        TOKENS_TOTAL.inc(taken)
        DECODE_TOKENS.inc(taken)
        DECODE_SECONDS.inc(dt)
        if dt > 0:
            TOKS_PER_SEC.set(taken / dt)
        with self._work:
            self._timing["decode_tokens"] += taken
            self._timing["decode_seconds"] += dt
        for i in range(self.max_batch):
            self._finish_if_done(i)

    def _spec_step(self) -> bool:
        """One speculative round, if the cost model approves: draft each
        active row, verify every draft in ONE batched forward, keep each
        row's accepted prefix plus the model's own next token.  Returns
        False (having run nothing on the card) when the expected tokens
        do not beat the decode chunk; the caller then runs the chunk."""
        active = [(i, s) for i, s in enumerate(self.slots) if s]
        if not active:
            return False
        allowed = self.max_seq - 1 - max(
            len(s.ids) + len(s.generated) - 1 for _, s in active)
        # planned lengths bound what drafting returns; a costed drafter
        # must clear the bar before any draft compute is spent
        plans: dict[int, int] = {}
        for i, s in active:
            want = s.max_new_tokens - len(s.generated)
            plans[i] = max(0, min(s._spec.next_len, want - 1, allowed))
        if self.draft_cost > 0.0:
            planned = max(plans.values(), default=0)
            if planned <= 0:
                return False
            gamma_plan = min(next(b for b in self._spec_buckets
                                  if b >= planned), allowed)
            expected = sum(1.0 + s._spec.accept_ewma
                           * min(plans[i], gamma_plan) for i, s in active)
            cost = (len(active) * (SPEC_COST_BASE
                                   + SPEC_COST_SLOPE * gamma_plan)
                    + self.draft_cost * sum(plans.values()))
            if expected < cost:
                # the gate learns accept rates only by drafting: every 4th
                # declined round runs anyway at the MIN_DRAFT probe width
                # (the decode chunk a decline falls back to records the
                # skip)
                self._spec_declines += 1
                if self._spec_declines % 4 != 0:
                    return False
                plans = {i: min(p, MIN_DRAFT) for i, p in plans.items()}
        drafts: dict[int, list[int]] = {}
        for i, s in active:
            limit = plans[i]
            d = self.draft_fn(s.ids + s.generated, limit) if limit > 0 else []
            drafts[i] = list(d[:limit])
        desired = max(len(d) for d in drafts.values())
        if desired <= 0:
            return False
        gamma = min(next(b for b in self._spec_buckets if b >= desired),
                    allowed)
        expected = sum(1.0 + s._spec.accept_ewma * len(drafts[i])
                       for i, s in active)
        if expected < len(active) * (SPEC_COST_BASE
                                     + SPEC_COST_SLOPE * gamma):
            return False
        reqs = list(self.slots)
        toks = []
        for i, req in enumerate(reqs):
            d = drafts.get(i, [])[:gamma]
            toks.append([req.generated[-1] if req else 0] + d
                        + [0] * (gamma - len(d)))
        t0 = time.perf_counter()
        choices, states = self._verify(reqs, toks)
        dt = time.perf_counter() - t0
        SPEC_ROUNDS.inc()
        taken_total, proposed, accepted_total = 0, 0, 0
        acct = get_accountant()
        for i, req in active:
            draft = drafts[i][:gamma]
            col = [choices[j][i] for j in range(gamma + 1)]
            accepted = 0
            while accepted < len(draft) and draft[accepted] == col[accepted]:
                accepted += 1
            want = req.max_new_tokens - len(req.generated)
            taken = 0
            for tok in col[:accepted + 1][:want]:
                self._emit(req, tok)
                taken += 1
                if req.eos_id is not None and tok == req.eos_id:
                    break
            taken_total += taken
            acct.record_decode_tokens(req.tenant, taken)
            acct.record_slice_seconds(req.tenant, dt / max(1, len(active)))
            if draft:
                proposed += len(draft)
                accepted_total += accepted
            req._spec.observe(len(draft), accepted)
            if taken < len(states[i]):
                # the generator's state after the draws of the tokens
                # actually kept (the rest were drawn for rejected
                # positions)
                req._gen.set_state(states[i][taken])
        # counters before completion events: a woken caller sees them
        SPEC_PROPOSED.inc(proposed)
        SPEC_ACCEPTED.inc(accepted_total)
        TOKENS_TOTAL.inc(taken_total)
        DECODE_TOKENS.inc(taken_total)
        DECODE_SECONDS.inc(dt)
        if dt > 0:
            TOKS_PER_SEC.set(taken_total / dt)
        with self._work:
            self._timing["decode_tokens"] += taken_total
            self._timing["decode_seconds"] += dt
            tally = self._spec_tally
            tally["proposed"] += proposed
            tally["accepted"] += accepted_total
            tally["rounds"] += 1
        for i, _ in active:
            self._finish_if_done(i)
        return True

    def _verify(self, reqs: list, toks: list[list[int]]):
        """ONE forward of ``s = len(toks[0])`` tokens per row (``[last,
        draft..., 0-pad]``) at each row's host-truth index over the
        resident view, then each position's choice as sequential decode
        would make it.  Returns ``(choices [s][B], states)``: ``states[b]``
        holds row b's generator state before each of its draws (empty for
        a greedy row).  Rejected positions leave garbage KV behind; the
        next dispatch's index comes from host truth, so each such position
        is rewritten before any query attends to it."""
        index = torch.tensor(
            [len(r.ids) + len(r.generated) - 1 if r else 0 for r in reqs],
            dtype=torch.int64, device=self.device)
        ids = torch.tensor(toks, dtype=torch.int64, device=self.device)
        cache = {"layers": [dict(l, index=index) for l in self.view]}
        logits = self._whole_vocab(
            self.model(ids, cache=cache)["logits"])             # [B, s, V]
        gens = [r._gen if r is not None else None for r in reqs]
        states: list[list] = [[] for _ in reqs]
        choices = []
        for j in range(ids.shape[1]):
            for i, r in enumerate(reqs):
                if r is not None and r.temperature > 0.0:
                    states[i].append(r._gen.get_state())
            choices.append(sample_rows(logits[:, j], reqs, gens))
        return torch.stack(choices).tolist(), states   # the sync

    def _finish_if_done(self, slot: int) -> None:
        req = self.slots[slot]
        if req is None:
            return
        hit_eos = req.eos_id is not None and req.generated[-1] == req.eos_id
        if len(req.generated) < req.max_new_tokens and not hit_eos:
            return
        with self._work:
            self.slots[slot] = None
            ACTIVE_SLOTS.set(sum(1 for s in self.slots if s))
            dur = time.perf_counter() - (req.admitted_at or req.submitted_at)
            self._service_ewma = (dur if self._service_ewma <= 0.0
                                  else 0.8 * self._service_ewma + 0.2 * dur)
            self._work.notify_all()
        req.outcome = "ok"
        REQS_TOTAL.labels("ok").inc()
        get_accountant().record_outcome(req.tenant, "ok")
        req.decode_span.set_attribute("tokens", len(req.generated))
        req.decode_span.end()
        req.span.set_attribute("outcome", "ok")
        req.span.end()
        req._done.set()


def filter_logits(logits: torch.Tensor, top_ks: torch.Tensor,
                  top_ps: torch.Tensor) -> torch.Tensor:
    """Per-row top-k then top-p (nucleus) masking over [B, V] logits
    (``top_ks`` int, 0 = off; ``top_ps`` float, 0 or >= 1 = off).  Top-1
    always survives either filter."""
    v = logits.shape[-1]
    sorted_lg = torch.sort(logits, dim=-1, descending=True).values
    k_idx = top_ks.clamp(1, v) - 1
    kth = torch.gather(sorted_lg, -1, k_idx[:, None])
    keep_k = torch.where((top_ks > 0)[:, None], logits >= kth,
                         torch.ones_like(logits, dtype=torch.bool))
    # nucleus over the top-k-filtered, renormalized distribution
    k_masked = logits.masked_fill(~keep_k, float("-inf"))
    sorted_km = torch.sort(k_masked, dim=-1, descending=True).values
    probs = torch.softmax(sorted_km, dim=-1)
    cum_excl = torch.cumsum(probs, dim=-1) - probs
    kept_sorted = cum_excl < top_ps[:, None]
    last_kept = (kept_sorted.sum(dim=-1) - 1).clamp_min(0)
    pth = torch.gather(sorted_km, -1, last_kept[:, None])
    p_on = ((top_ps > 0.0) & (top_ps < 1.0))[:, None]
    keep_p = torch.where(p_on, k_masked >= pth,
                         torch.ones_like(logits, dtype=torch.bool))
    return logits.masked_fill(~(keep_k & keep_p), float("-inf"))


def sample_rows(logits: torch.Tensor, reqs: list, gens: list) -> torch.Tensor:
    """Next token per row of [B, V] logits: greedy where the row's request
    has temperature 0 (or there is none), else a Gumbel-max draw from the
    temperature-scaled (then top-k / top-p filtered) distribution using
    that request's own generator."""
    logits = logits.float()
    out = logits.argmax(dim=-1)
    for i, req in enumerate(reqs):
        if req is None or req.temperature <= 0.0:
            continue
        scaled = logits[i:i + 1] / max(req.temperature, 1e-6)
        if req.top_k or req.top_p:
            scaled = filter_logits(
                scaled,
                torch.tensor([req.top_k], device=logits.device),
                torch.tensor([req.top_p], dtype=torch.float32,
                             device=logits.device))
        u = torch.rand(scaled.shape[-1], generator=gens[i],
                       device=logits.device)
        out[i] = (scaled[0] - torch.log(-torch.log(u))).argmax()
    return out
