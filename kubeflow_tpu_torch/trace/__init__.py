"""Per-request tracing for the serving path.

Counterpart of ``kubeflow_tpu/trace/``, less what only the control plane
uses (the thread-bound ``current_span`` that store writes parent to).
Dapper-style causality for one request: predictor HTTP -> engine
admission wait -> per-chunk prefill -> (prefill handoff) -> decode, one
trace id across the chain (W3C ``traceparent`` over the HTTP hop,
explicit span handoff on the request object into the batcher thread).

Process wiring: one default :class:`Tracer` per process, configured from
``KF_TRACE_SAMPLE`` (head sample rate, default 0 = off) and
``KF_TRACE_CAPACITY`` (collector ring size).  ``set_tracer`` swaps it; a
trace forced by the ``x-kf-trace-force`` header records regardless of
the rate.

Spans time the host: CUDA work is asynchronous, so a span that closes
after the host has issued a chunk's kernels (``engine.prefill``) measures
their dispatch, not their device time.  No span synchronizes the card.
"""

from __future__ import annotations

import os
import threading

from kubeflow_tpu_torch.trace.span import (  # noqa: F401
    FORCE_HEADER,
    NULL_SPAN,
    REQUEST_ID_HEADER,
    TRACEPARENT_HEADER,
    UNSAMPLED_CONTEXT,
    Span,
    SpanContext,
    new_span_id,
    new_trace_id,
    parse_traceparent,
)
from kubeflow_tpu_torch.trace.tracer import (  # noqa: F401
    Collector,
    Tracer,
    chrome_trace,
    dump_chrome_trace,
)

_tracer: Tracer | None = None
_tracer_lock = threading.Lock()


def get_tracer() -> Tracer:
    """The process tracer (created lazily from env on first use)."""
    global _tracer
    if _tracer is None:
        with _tracer_lock:
            if _tracer is None:
                try:
                    rate = float(os.environ.get("KF_TRACE_SAMPLE", "0"))
                except ValueError:
                    rate = 0.0
                try:
                    cap = int(os.environ.get("KF_TRACE_CAPACITY", "4096"))
                except ValueError:
                    cap = 4096
                _tracer = Tracer(rate, collector=Collector(cap))
    return _tracer


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the process tracer (tests; deployments that turn sampling
    on)."""
    global _tracer
    with _tracer_lock:
        _tracer = tracer
    return tracer


# -- WSGI helpers --------------------------------------------------------------

_REQUEST_ID_ENVIRON = "HTTP_" + REQUEST_ID_HEADER.upper().replace("-", "_")


def request_id(environ: dict) -> str:
    """The request's correlation id: the client's ``X-Request-Id`` when
    sent, a fresh one otherwise."""
    import uuid

    return environ.get(_REQUEST_ID_ENVIRON) or uuid.uuid4().hex


def propagation_context(span, environ: dict):
    """The SpanContext handed downstream for ``span``:

    - a recorded span hands on its own context (children parent to it);
    - an unsampled request preserves the CLIENT's ids with the sampled
      flag cleared (W3C participating-but-not-recording behavior), or
      hands on :data:`UNSAMPLED_CONTEXT` when the client sent nothing
      parseable — either way the negative head decision propagates, so
      no later hop re-rolls the dice and records an orphan subtree."""
    if span:
        return span.context
    inbound = parse_traceparent(environ_traceparent(environ))
    if inbound is not None:
        return SpanContext(inbound.trace_id, inbound.span_id, False)
    return UNSAMPLED_CONTEXT


def environ_traceparent(environ: dict) -> str | None:
    return environ.get("HTTP_TRACEPARENT")


def environ_force(environ: dict) -> bool:
    return environ.get("HTTP_X_KF_TRACE_FORCE") not in (None, "", "0")


def start_server_span(name: str, environ: dict, **attributes):
    """Root/continuation span for an inbound WSGI request: continues a
    well-formed ``traceparent``, falls back to a fresh head-sampled root
    on a malformed or absent one, honors the force header."""
    return get_tracer().start_root(
        name, traceparent=environ_traceparent(environ),
        force=environ_force(environ), **attributes)
