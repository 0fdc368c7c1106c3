"""Clock-injected tracer + lock-guarded ring-buffer collector + exporters.

The port's copy of ``kubeflow_tpu/trace/tracer.py``, whole.

Head-based sampling: the decision is made ONCE, where a trace is rooted —
``sample_rate`` of new roots are recorded, a force header (or an inbound
``traceparent`` whose sampled flag is set) overrides the rate, and every
child/continuation inherits the decision.  Unsampled work costs one RNG
draw at the root (none at rate 0) and nothing anywhere else
(``NULL_SPAN``).

The collector is a bounded ring: under span pressure the OLDEST finished
spans fall out and ``trace_spans_dropped_total`` counts the loss — an
observability subsystem must never become the memory leak it exists to
find.  Export surfaces: in-memory query and Chrome trace-event JSON
loadable in Perfetto / ``chrome://tracing``.
"""

from __future__ import annotations

import collections
import json
import random
import threading
import time
from typing import Callable, Iterable

from kubeflow_tpu_torch.trace.span import (
    NULL_SPAN,
    Span,
    SpanContext,
    new_span_id,
    new_trace_id,
    parse_traceparent,
)
from kubeflow_tpu_torch.utils.metrics import REGISTRY

SPANS_TOTAL = REGISTRY.counter(
    "trace_spans_total", "spans recorded by the trace collector")
SPANS_DROPPED = REGISTRY.counter(
    "trace_spans_dropped_total",
    "finished spans evicted from the collector ring buffer")


class Collector:
    """Lock-guarded ring buffer of FINISHED spans with query helpers."""

    def __init__(self, capacity: int = 4096):
        self.capacity = max(1, capacity)
        self._spans: collections.deque[Span] = collections.deque()
        self._lock = threading.Lock()

    def add(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) >= self.capacity:
                self._spans.popleft()
                SPANS_DROPPED.inc()
            self._spans.append(span)
        SPANS_TOTAL.inc()

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    # -- queries (snapshots: safe to iterate without the lock) ---------------
    def spans(self, trace_id: str | None = None) -> list[Span]:
        with self._lock:
            snap = list(self._spans)
        if trace_id is None:
            return snap
        return [s for s in snap if s.trace_id == trace_id]

    def roots(self, limit: int | None = None) -> list[Span]:
        """Finished root spans, most recent last."""
        out = [s for s in self.spans() if s.parent_id is None]
        return out[-limit:] if limit else out

    def trace(self, trace_id: str) -> list[Span]:
        """Every finished span of one trace, parents before children where
        the tree allows (sorted by start time)."""
        return sorted(self.spans(trace_id), key=lambda s: s.start)

    def breakdown(self, trace_id: str) -> dict:
        """Critical-path decomposition of one trace: the root's duration
        split across its DIRECT children (sorted longest first) plus the
        unattributed remainder (`self_s`) — "where did the time go" for
        one slow request."""
        spans = self.trace(trace_id)
        root = next((s for s in spans if s.parent_id is None), None)
        if root is None or root.duration is None:
            return {"trace_id": trace_id, "spans": len(spans)}
        children = sorted(
            (s for s in spans if s.parent_id == root.span_id),
            key=lambda s: -(s.duration or 0.0))
        attributed = sum(c.duration or 0.0 for c in children)
        return {
            "trace_id": trace_id,
            "root": root.name,
            "duration_s": root.duration,
            "spans": len(spans),
            "children": [{"name": c.name,
                          "duration_s": c.duration,
                          "attributes": dict(c.attributes)}
                         for c in children],
            "self_s": max(0.0, root.duration - attributed),
        }


class Tracer:
    """Mints spans; owns the sampling decision and the injected clock.

    ``clock`` must be monotonic within a process (durations are clock
    deltas); the default is the monotonic clock.  Thread-safe: span
    creation touches no shared mutable state beyond the RNG (guarded) and
    the collector (internally locked).
    """

    def __init__(self, sample_rate: float = 0.0, *,
                 collector: Collector | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 seed: int | None = None):
        self.sample_rate = max(0.0, min(1.0, sample_rate))
        self.collector = collector or Collector()
        self._clock = clock
        self._rng = random.Random(seed)
        self._rng_lock = threading.Lock()
        # per-thread stack of ambient spans (see scope()): strictly
        # bounded by its with-block, never handed across threads
        self._local = threading.local()

    def now(self) -> float:
        return self._clock()

    # -- roots ---------------------------------------------------------------
    def _decide(self, force: bool) -> bool:
        if force:
            return True
        if self.sample_rate <= 0.0:
            return False
        if self.sample_rate >= 1.0:
            return True
        with self._rng_lock:
            return self._rng.random() < self.sample_rate

    def start_root(self, name: str, *, traceparent: str | None = None,
                   force: bool = False, start: float | None = None,
                   **attributes):
        """Root or remote-continuation span.  A well-formed ``traceparent``
        continues the inbound trace (inheriting its sampled flag — the
        head decision was upstream); a malformed or absent one starts a
        fresh root under head sampling.  Unsampled -> ``NULL_SPAN``."""
        ctx = parse_traceparent(traceparent)
        if ctx is not None:
            if not (ctx.sampled or force):
                return NULL_SPAN
            span = Span(name=name, trace_id=ctx.trace_id,
                        span_id=new_span_id(), parent_id=ctx.span_id,
                        start=start if start is not None else self.now(),
                        _tracer=self)
        else:
            if not self._decide(force):
                return NULL_SPAN
            span = Span(name=name, trace_id=new_trace_id(),
                        span_id=new_span_id(), parent_id=None,
                        start=start if start is not None else self.now(),
                        _tracer=self)
        span.attributes.update(attributes)
        return span

    def start_span(self, name: str, parent, *, start: float | None = None,
                   **attributes):
        """Child span under an explicit parent (a Span, a SpanContext, or
        None/NULL_SPAN -> not recorded).  Explicit on purpose: handing the
        parent over is how context crosses worker pools — there is no
        ambient fallback here to leak through."""
        ctx = parent.context if hasattr(parent, "context") else parent
        if ctx is None or not isinstance(ctx, SpanContext) or not ctx.sampled:
            return NULL_SPAN
        span = Span(name=name, trace_id=ctx.trace_id,
                    span_id=new_span_id(), parent_id=ctx.span_id,
                    start=start if start is not None else self.now(),
                    _tracer=self)
        span.attributes.update(attributes)
        return span

    def _finish(self, span: Span) -> None:
        self.collector.add(span)

    # -- scoped ambient span (same-thread only) ------------------------------
    def scope(self, span):
        """Bind ``span`` as this THREAD's current span for the duration of
        the with-block (store instrumentation reads it to parent
        ``store.write`` spans without threading a ctx through every
        controller signature).  The binding is strictly lexical — pushed
        on entry, popped in finally — so it can never leak across worker
        pool iterations, and it is never visible to other threads."""
        return _Scope(self._local, span)

    def current(self):
        """The innermost scope()-bound span of THIS thread, or None."""
        stack = getattr(self._local, "stack", None)
        return stack[-1] if stack else None


class _Scope:
    def __init__(self, local, span):
        self._locals = local
        self._span = span

    def __enter__(self):
        stack = getattr(self._locals, "stack", None)
        if stack is None:
            stack = self._locals.stack = []
        stack.append(self._span)
        return self._span

    def __exit__(self, exc_type, exc, tb):
        self._locals.stack.pop()


# -- exporters -----------------------------------------------------------------

def chrome_trace(spans: Iterable[Span]) -> dict:
    """Chrome trace-event JSON (the ``traceEvents`` array form) — load the
    dumped file in Perfetto or ``chrome://tracing``.  One complete ("X")
    event per span; traces are laid out one per track (tid = trace id
    hash) so concurrent requests render as parallel rows."""
    events = []
    for s in spans:
        if s.duration is None:
            continue
        events.append({
            "ph": "X",
            "name": s.name,
            "cat": s.name.split(".", 1)[0],
            "ts": round(s.start * 1e6, 3),
            "dur": round(s.duration * 1e6, 3),
            "pid": 1,
            "tid": int(s.trace_id[:8], 16),
            "args": {**s.attributes,
                     "trace_id": s.trace_id,
                     "span_id": s.span_id,
                     "parent_id": s.parent_id or ""},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def dump_chrome_trace(spans: Iterable[Span], path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(chrome_trace(spans), f)
