"""Span model + W3C ``traceparent`` codec (Dapper-style, stdlib only).

The port's copy of ``kubeflow_tpu/trace/span.py``, whole.

A span is one timed operation in a request's causal tree: 128-bit trace
id shared by the whole tree, 64-bit span id, a parent link, a
``component.operation`` name, attributes, and point-in-time events.  The
wire format between processes (and across the gateway -> predictor HTTP
hop) is the W3C Trace Context ``traceparent`` header::

    00-{trace_id:32 hex}-{span_id:16 hex}-{flags:2 hex}

Decoding is TOTAL: a malformed header yields ``None`` and the caller
starts a fresh root — a broken client header must never raise into the
request path.

Clock discipline: spans never read the wall clock themselves; the
:class:`~kubeflow_tpu_torch.trace.tracer.Tracer` that mints them injects every
timestamp, so tests drive a fake clock and production pays one
``monotonic()`` per edge.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

# W3C trace-context flags: bit 0 = sampled
FLAG_SAMPLED = 0x01
TRACEPARENT_HEADER = "traceparent"
# head-sampling override: a caller setting this header forces the trace
# to be recorded regardless of the tracer's sample rate (debugging one
# slow request without turning sampling on for the fleet)
FORCE_HEADER = "x-kf-trace-force"
# request correlation id (the gateway forwards it alongside traceparent)
REQUEST_ID_HEADER = "x-request-id"


def new_trace_id() -> str:
    return os.urandom(16).hex()


def new_span_id() -> str:
    return os.urandom(8).hex()


@dataclass(frozen=True)
class SpanContext:
    """The propagatable identity of a span: what crosses thread and
    process boundaries.  ``sampled`` carries the HEAD decision — children
    and remote continuations inherit it instead of re-rolling the dice
    (one trace is recorded everywhere or nowhere)."""

    trace_id: str
    span_id: str
    sampled: bool = True

    def to_traceparent(self) -> str:
        return (f"00-{self.trace_id}-{self.span_id}-"
                f"{FLAG_SAMPLED if self.sampled else 0:02x}")


# the head decision must propagate even when it is "no": a downstream
# hop that receives NOTHING would re-roll the dice and record an orphan
# partial trace (engine-only trees at fractional sample rates).  When a
# hop decides not to sample and has no upstream ids to preserve, it
# forwards this context — valid W3C shape, sampled flag clear — so every
# later hop inherits the negative decision instead of re-deciding.
UNSAMPLED_CONTEXT = SpanContext("f" * 32, "f" * 16, False)


def parse_traceparent(header: str | None) -> SpanContext | None:
    """Decode a ``traceparent`` header; ``None`` on ANY malformation
    (wrong field count, bad version, short/long/non-hex ids, all-zero
    ids) so the caller falls back to a new root instead of raising."""
    if not header or not isinstance(header, str):
        return None
    parts = header.strip().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, flags = parts
    if len(version) != 2 or not _is_hex(version) or version == "ff":
        return None
    if len(trace_id) != 32 or not _is_hex(trace_id):
        return None
    if len(span_id) != 16 or not _is_hex(span_id):
        return None
    if len(flags) != 2 or not _is_hex(flags):
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return SpanContext(trace_id=trace_id.lower(), span_id=span_id.lower(),
                       sampled=bool(int(flags, 16) & FLAG_SAMPLED))


def _is_hex(s: str) -> bool:
    try:
        int(s, 16)
        return True
    except ValueError:
        return False


@dataclass
class Span:
    """A recorded operation.  Mutation is single-owner by convention: the
    code that holds the span object writes it; handoff between threads is
    explicit (the object travels on a request/side-table, never through a
    thread-local that outlives its scope)."""

    name: str                       # component.operation
    trace_id: str
    span_id: str
    parent_id: str | None
    start: float                    # tracer-clock seconds
    _tracer: object = field(default=None, repr=False)
    duration: float | None = None   # None while open
    attributes: dict = field(default_factory=dict)
    events: list = field(default_factory=list)   # (t, name, attrs)
    sampled: bool = True

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id, self.sampled)

    def set_attribute(self, key: str, value) -> None:
        self.attributes[key] = value

    def add_event(self, name: str, **attrs) -> None:
        self.events.append((self._now(), name, attrs))

    def _now(self) -> float:
        tracer = self._tracer
        return tracer.now() if tracer is not None else self.start

    def end(self, *, at: float | None = None) -> None:
        """Close the span and hand it to the collector.  Idempotent: a
        second end() is a no-op, so an error-path close racing the
        owner's close cannot double-count the span."""
        if self.duration is not None:
            return
        end_at = at if at is not None else self._now()
        self.duration = max(0.0, end_at - self.start)
        tracer = self._tracer
        if tracer is not None:
            tracer._finish(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc is not None:
            self.add_event("exception", type=getattr(
                exc_type, "__name__", str(exc_type)), message=str(exc))
            self.set_attribute("error", True)
        self.end()

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start": self.start,
            "duration": self.duration,
            "attributes": dict(self.attributes),
            "events": [{"t": t, "name": n, "attrs": a}
                       for t, n, a in self.events],
        }


class _NullSpan:
    """The unsampled span: one shared instance, every operation a no-op.
    ``context`` is None — callers that propagate headers forward the
    ORIGINAL inbound traceparent (or nothing) instead of minting ids for
    a trace nobody records."""

    sampled = False
    context = None
    name = ""
    trace_id = ""
    span_id = ""
    parent_id = None
    duration = 0.0
    attributes: dict = {}
    events: list = []

    def set_attribute(self, key: str, value) -> None:
        pass

    def add_event(self, name: str, **attrs) -> None:
        pass

    def end(self, *, at: float | None = None) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass

    def __bool__(self) -> bool:
        # `if span:` reads as "is this trace recorded" at call sites
        return False


NULL_SPAN = _NullSpan()
