"""Continuous batching for generative serving (Orca-style iteration-level
scheduling), on one CUDA card.

Counterpart of ``kubeflow_tpu/serving/engine.py``'s ``ContinuousBatcher``,
trimmed to the colocated path with no prefix cache, pages, speculation,
disaggregation, KV quantization, tenant fair queueing or tracing (ROADMAP
queue A lists them).  What it keeps:

- ``max_batch`` slots over one RESIDENT KV view ``[max_batch, max_seq]``
  per layer, held in the model dtype and updated in place; each slot sits
  at its own position (per-row index);
- admission runs the prompt through a batch-1 prefill scratch in
  ``prefill_chunk`` chunks, each padded to a ``PREFILL_BUCKETS`` size, and
  samples the first token at the last real position; the scratch is then
  seated into the slot's view row.  Padded positions hold garbage that no
  real query reads (causality in prefill, and decode overwrites a position
  before any query attends to it), so the scratch is reused unzeroed;
- decode runs in chunks of ``DECODE_CHUNKS`` steps between host syncs,
  sized as the reference sizes them (overshoot of up to 25% beats a second
  sync; overshoot tokens are dropped and the index restored from host
  truth);
- eos, deadlines, cancellation, bounded admission (``max_queue``), drain
  and shutdown;
- sampling with one ``torch.Generator`` per request, seeded from its seed:
  a request's draws depend only on its own seed and step, never on
  co-batched traffic.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import torch

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
ADMISSION_WAIT = REGISTRY.histogram(
    "serving_admission_wait_seconds",
    "queue wait from submit() to slot admission",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5, 5.0, 10.0, 30.0))

PREFILL_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048)
DECODE_CHUNKS = (8, 16, 32, 64, 128)


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
    submitted_at: float = field(default_factory=time.perf_counter)
    admitted_at: float | None = None
    first_token_at: float | None = None
    generated: list[int] = field(default_factory=list)
    error: str | None = None
    outcome: str | None = None
    _done: threading.Event = field(default_factory=threading.Event)
    _cancel_requested: bool = False
    _engine: object | None = field(default=None, repr=False)
    _gen: torch.Generator | None = field(default=None, repr=False)

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
                 max_queue: int = 0):
        self.model = model
        self.cfg = cfg
        self.device = model.device
        self.max_batch = max_batch
        self.max_seq = min(max_seq, cfg.max_seq_len)
        self.prefill_chunk = max(1, min(prefill_chunk, self.max_seq))
        self.max_queue = max_queue
        self.log = get_logger("serving.batcher")
        shape = (max_batch, self.max_seq, cfg.num_kv_heads, cfg.head_dim)
        dt = cfg.torch_dtype
        self.view = [{"k": torch.zeros(shape, dtype=dt, device=self.device),
                      "v": torch.zeros(shape, dtype=dt, device=self.device)}
                     for _ in range(cfg.num_layers)]
        self._scratch_kv = None   # batch-1 prefill scratch, made at first use
        self.slots: list[GenRequest | None] = [None] * max_batch
        self.queue: list[GenRequest] = []
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

    # -- public ----------------------------------------------------------------
    def submit(self, ids: list[int], max_new_tokens: int = 32,
               temperature: float = 0.0, eos_id: int | None = None,
               seed: int | None = None, top_k: int = 0, top_p: float = 0.0,
               deadline_s: float | None = None) -> GenRequest:
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
                         top_k=top_k, top_p=top_p)
        with self._work:
            if self._closed:
                raise RuntimeError("serving engine is shut down")
            if self._draining:
                raise Draining("serving engine is draining (finishing "
                               "in-flight requests, accepting no new ones)")
            if self.max_queue and len(self.queue) >= self.max_queue:
                REQS_TOTAL.labels("shed").inc()
                raise QueueFull(
                    f"admission queue full ({self.max_queue} waiting)",
                    retry_after=self._estimated_wait_locked())
            if seed is None:
                self._auto_seed += 1
                seed = self._auto_seed
            req.seed = seed
            if deadline_s is not None:
                req.deadline = req.submitted_at + deadline_s
            req._engine = self
            self.queue.append(req)
            QUEUE_DEPTH.set(len(self.queue))
            if self._thread is None or not self._thread.is_alive():
                self._stop = False
                self._thread = threading.Thread(
                    target=self._loop, daemon=True, name="serving-batcher")
                self._thread.start()
            self._work.notify_all()
        return req

    def generate_sync(self, batch: list[list[int]], max_new_tokens: int = 32,
                      temperature: float = 0.0, eos_id: int | None = None,
                      seed: int | None = None, top_k: int = 0,
                      top_p: float = 0.0,
                      deadline_s: float | None = None) -> list[list[int]]:
        """Submit a (possibly ragged) batch and wait for all rows;
        all-or-nothing: a failed row cancels its siblings."""
        reqs: list[GenRequest] = []
        try:
            for i, ids in enumerate(batch):
                reqs.append(self.submit(
                    ids, max_new_tokens, temperature, eos_id,
                    seed=None if seed is None else seed + i,
                    top_k=top_k, top_p=top_p, deadline_s=deadline_s))
            return [r.result() for r in reqs]
        except BaseException:
            for r in reqs:
                r.cancel()
            raise

    def stats(self) -> dict:
        """Load snapshot: requests decoding, queued, slot capacity, plus
        this engine's TTFT and decode tallies."""
        with self._work:
            out = {"active": sum(1 for s in self.slots if s is not None),
                   "queued": len(self.queue),
                   "max_batch": self.max_batch,
                   "timing": dict(self._timing)}
            if self.max_queue:
                out["max_queue"] = self.max_queue
            if self._draining:
                out["draining"] = True
        return out

    def _estimated_wait_locked(self) -> float:
        """Seconds until a new arrival would reach a slot: waiters ahead
        over slot capacity, times the observed service time (0 until the
        first request completes)."""
        if self._service_ewma <= 0.0:
            return 0.0
        return len(self.queue) / max(self.max_batch, 1) * self._service_ewma

    def drain(self) -> None:
        """Stop admitting; queued and in-flight requests run to the end."""
        with self._work:
            self._draining = True
            self._work.notify_all()

    def drained(self, timeout: float = 60.0) -> bool:
        """Block until no request is queued or decoding (or timeout)."""
        deadline = time.monotonic() + timeout
        with self._work:
            while self.queue or any(s is not None for s in self.slots):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._work.wait(remaining)
        return True

    def shutdown(self) -> None:
        """Terminal: pending and in-flight requests fail; later submits
        raise."""
        with self._work:
            self._closed = True
            self._stop = True
            self._draining = False
            self._work.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)

    # -- the scheduling loop ---------------------------------------------------
    _DEAD_MSG = {
        "shutdown": "serving engine shut down",
        "cancelled": "request cancelled",
        "deadline_exceeded": "request deadline exceeded",
    }

    def _dead_outcome(self, req: GenRequest,
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

    def _loop(self) -> None:
        try:
            with torch.no_grad():
                while self._step():
                    pass
        except Exception:
            self.log.error("batcher loop crashed", exc_info=True)
            with self._work:
                dying = list(self.queue) + [s for s in self.slots if s]
                self.queue.clear()
                self.slots = [None] * self.max_batch
                self._thread = None
            for req in dying:
                self._fail(req, "error", "serving engine crashed")

    def _step(self) -> bool:
        """One scheduling iteration; False when the engine stopped."""
        with self._work:
            while not self._stop and not self.queue and not any(self.slots):
                self._work.wait(timeout=5.0)
            if self._stop:
                dying = list(self.queue) + [s for s in self.slots if s]
                self.queue.clear()
                self.slots = [None] * self.max_batch
        if self._stop:
            for req in dying:
                self._fail(req, "shutdown", "serving engine shut down")
            return False
        self._sweep_dead()
        self._admit()
        with self._work:
            queue_empty = not self.queue
        if any(self.slots):
            self._decode_chunk(queue_empty)
        return True

    def _admit(self) -> None:
        """FIFO admission into free slots, at most ``max_batch`` per call
        so requests done at admission cannot starve in-flight decode."""
        for _ in range(self.max_batch):
            with self._work:
                free = next((i for i, s in enumerate(self.slots)
                             if s is None), None)
                if not self.queue or free is None:
                    QUEUE_DEPTH.set(len(self.queue))
                    return
                req = self.queue.pop(0)
                QUEUE_DEPTH.set(len(self.queue))
            self._admit_one(free, req)

    def _admit_one(self, free: int, req: GenRequest) -> None:
        outcome = self._dead_outcome(req)
        if outcome is not None:
            self._fail(req, outcome, self._DEAD_MSG[outcome])
            return
        req.admitted_at = time.perf_counter()
        ADMISSION_WAIT.observe(req.admitted_at - req.submitted_at)
        req._gen = torch.Generator(device=self.device).manual_seed(req.seed)
        tok = self._run_prefill(req)
        outcome = self._dead_outcome(req)
        if tok is None or outcome is not None:
            outcome = outcome or "cancelled"
            self._fail(req, outcome, self._DEAD_MSG[outcome])
            return
        req.first_token_at = time.perf_counter()
        ttft = req.first_token_at - req.submitted_at
        TTFT_HIST.observe(ttft)
        req.generated.append(tok)
        TOKENS_TOTAL.inc()
        with self._work:
            t = self._timing
            t["ttft_sum"] += ttft
            t["ttft_count"] += 1
        self._seat(free, req)

    def _scratch(self) -> list[dict]:
        if self._scratch_kv is None:
            shape = (1, self.max_seq, self.cfg.num_kv_heads,
                     self.cfg.head_dim)
            dt = self.cfg.torch_dtype
            self._scratch_kv = [
                {"k": torch.zeros(shape, dtype=dt, device=self.device),
                 "v": torch.zeros(shape, dtype=dt, device=self.device)}
                for _ in range(self.cfg.num_layers)]
        return self._scratch_kv

    def _run_prefill(self, req: GenRequest) -> int | None:
        """Prefill the prompt into the batch-1 scratch in chunks and sample
        the first token at the last real position; None when the request
        died between chunks."""
        prompt_len = len(req.ids)
        scratch = self._scratch()
        pos = 0
        while True:
            if self._dead_outcome(req) is not None:
                return None
            take = min(prompt_len - pos, self.prefill_chunk)
            # pad to a bucket, never past max_seq
            room = self.max_seq - pos
            cb = next((b for b in PREFILL_BUCKETS if take <= b <= room),
                      take)
            chunk = req.ids[pos:pos + take] + [0] * (cb - take)
            ids = torch.tensor([chunk], dtype=torch.int64,
                               device=self.device)
            cache = {"layers": [dict(l, index=pos) for l in scratch]}
            out = self.model(ids, cache=cache)
            PREFILL_DISPATCHES.inc()
            PREFILL_TOKENS.inc(take)
            with self._work:
                self._timing["prefill_chunks"] += 1
            pos += take
            if pos >= prompt_len:
                logits = out["logits"][0, take - 1][None]
                return int(sample_rows(logits, [req], [req._gen])[0])

    def _seat(self, free: int, req: GenRequest) -> None:
        """Install the prefilled scratch as slot ``free``'s view row and
        make the request decodable."""
        n = len(req.ids)
        for vl, sl in zip(self.view, self._scratch()):
            vl["k"][free, :n].copy_(sl["k"][0, :n])
            vl["v"][free, :n].copy_(sl["v"][0, :n])
        with self._work:
            self.slots[free] = req
            ACTIVE_SLOTS.set(sum(1 for s in self.slots if s))
        self._finish_if_done(free)

    def _chunk_len(self, queue_empty: bool) -> int:
        remaining = [s.max_new_tokens - len(s.generated)
                     for s in self.slots if s]
        # any slot that can free mid-chunk keeps chunks small while
        # someone waits (the sweep only runs between chunks)
        reclaim = any(s.eos_id is not None or s.deadline is not None
                      or s._cancel_requested for s in self.slots if s)
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
            tok = sample_rows(out["logits"][:, 0], reqs, gens)
            toks.append(tok)
            index = index + 1
        host = torch.stack(toks).tolist()        # [chunk, B]: the sync
        dt = time.perf_counter() - t0
        taken = 0
        for i, req in enumerate(reqs):
            if req is None:
                continue
            want = req.max_new_tokens - len(req.generated)
            for step in range(min(chunk, want)):
                t = host[step][i]
                req.generated.append(t)
                taken += 1
                if req.eos_id is not None and t == req.eos_id:
                    break
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
