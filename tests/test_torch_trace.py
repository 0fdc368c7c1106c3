"""Request tracing of the port against the reference's ``trace``.

The unit cases of ``tests/test_trace.py`` (the ``traceparent`` codec and
its malformed headers, head sampling, span mechanics, the thread-bound
scope, the ring buffer, the Chrome trace export) run on the port's copy.
One ``:generate`` request with a client ``traceparent`` goes through the
reference's ``PredictorApp`` and the port's on the same float32 weights:
the two span trees (names, parent links, attribute keys) must be equal.
A closed engine and a shed close their spans with the outcome, and an
unsampled predictor hands the engine the negative decision.
"""

import io
import json
import random
import threading
from collections import Counter

import jax
import numpy as np
import pytest

from kubeflow_tpu import trace as jtrace
from kubeflow_tpu_torch import trace
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.serving import engine as teng
from kubeflow_tpu_torch.serving import predictor as tpred
from kubeflow_tpu_torch.trace import (NULL_SPAN, Collector, SpanContext,
                                      Tracer, chrome_trace, new_span_id,
                                      new_trace_id, parse_traceparent)
from kubeflow_tpu_torch.utils.metrics import REGISTRY


@pytest.fixture()
def tracer():
    t = trace.set_tracer(Tracer(1.0, collector=Collector(4096)))
    yield t
    trace.set_tracer(Tracer(0.0))


def test_traceparent_roundtrip_property():
    rng = random.Random(0xC0FFEE)
    for _ in range(200):
        ctx = SpanContext(trace_id=f"{rng.getrandbits(128):032x}",
                          span_id=f"{rng.getrandbits(64):016x}",
                          sampled=bool(rng.getrandbits(1)))
        if ctx.trace_id == "0" * 32 or ctx.span_id == "0" * 16:
            continue
        assert parse_traceparent(ctx.to_traceparent()) == ctx
        assert jtrace.parse_traceparent(ctx.to_traceparent()).trace_id \
            == ctx.trace_id


MALFORMED = [
    None, "", "garbage", "00-abc",
    "00-" + "a" * 32 + "-" + "b" * 16,
    "00-" + "a" * 32 + "-" + "b" * 16 + "-01-extra",
    "ff-" + "a" * 32 + "-" + "b" * 16 + "-01",
    "0-" + "a" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "a" * 31 + "-" + "b" * 16 + "-01",
    "00-" + "a" * 33 + "-" + "b" * 16 + "-01",
    "00-" + "z" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "b" * 15 + "-01",
    "00-" + "a" * 32 + "-" + "g" * 16 + "-01",
    "00-" + "0" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "0" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "b" * 16 + "-0x",
    "00-" + "a" * 32 + "-" + "b" * 16 + "-001",
]


@pytest.mark.parametrize("header", MALFORMED)
def test_malformed_traceparent_parses_to_none(header):
    assert parse_traceparent(header) is None
    assert jtrace.parse_traceparent(header) is None


@pytest.mark.parametrize("header", MALFORMED)
def test_malformed_traceparent_falls_back_to_fresh_root(tracer, header):
    span = tracer.start_root("gateway.request", traceparent=header)
    assert span.parent_id is None and len(span.trace_id) == 32
    span.end()
    assert tracer.collector.spans(span.trace_id)


def test_wellformed_traceparent_continues_the_trace(tracer):
    ctx = SpanContext(new_trace_id(), new_span_id(), True)
    span = tracer.start_root("predictor.request",
                             traceparent=ctx.to_traceparent())
    assert span.trace_id == ctx.trace_id and span.parent_id == ctx.span_id
    span.end()


def test_rate_zero_roots_are_null_and_free():
    t = Tracer(0.0, collector=Collector(16))
    span = t.start_root("engine.request")
    assert span is NULL_SPAN and not span
    span.set_attribute("x", 1)
    span.add_event("y")
    span.end()
    assert t.collector.spans() == []


def test_force_overrides_rate_zero():
    t = Tracer(0.0, collector=Collector(16))
    span = t.start_root("engine.request", force=True)
    assert span is not NULL_SPAN
    span.end()
    assert len(t.collector.spans()) == 1


def test_sampling_is_parent_based_on_continuation():
    unsampled = SpanContext(new_trace_id(), new_span_id(), False)
    assert Tracer(1.0).start_root(
        "predictor.request",
        traceparent=unsampled.to_traceparent()) is NULL_SPAN
    sampled = SpanContext(new_trace_id(), new_span_id(), True)
    t = Tracer(0.0, collector=Collector(16))
    span = t.start_root("predictor.request",
                        traceparent=sampled.to_traceparent())
    assert span.trace_id == sampled.trace_id
    span.end()


def test_children_inherit_the_decision(tracer):
    root = tracer.start_root("gateway.request")
    child = tracer.start_span("gateway.route_match", root)
    assert child.trace_id == root.trace_id
    assert child.parent_id == root.span_id
    child.end()
    root.end()
    assert tracer.start_span("x.y", NULL_SPAN) is NULL_SPAN
    assert tracer.start_span("x.y", None) is NULL_SPAN


def test_end_is_idempotent_and_durations_never_negative(tracer):
    span = tracer.start_root("a.b")
    span.end(at=span.start - 5.0)
    assert span.duration == 0.0
    span.end()
    assert span.duration == 0.0
    assert len(tracer.collector.spans(span.trace_id)) == 1


def test_context_manager_records_exception_event(tracer):
    with pytest.raises(ValueError):
        with tracer.start_root("a.b") as span:
            raise ValueError("boom")
    (done,) = tracer.collector.spans(span.trace_id)
    assert done.attributes.get("error") is True
    assert any(n == "exception" for _, n, _ in done.events)


def test_scope_binding_is_thread_local_and_strictly_scoped(tracer):
    root = tracer.start_root("engine.request")
    seen_other: list = []
    with tracer.scope(root):
        assert tracer.current() is root
        th = threading.Thread(
            target=lambda: seen_other.append(tracer.current()))
        th.start()
        th.join(timeout=10)
    assert tracer.current() is None
    assert seen_other == [None]
    root.end()


def test_ring_buffer_drops_oldest_and_counts():
    dropped = REGISTRY.get_metric("trace_spans_dropped_total")
    before = dropped.get()
    t = Tracer(1.0, collector=Collector(4))
    spans = [t.start_root("a.b") for _ in range(6)]
    for s in spans:
        s.end()
    held = t.collector.spans()
    assert [s.span_id for s in held] == [s.span_id for s in spans[2:]]
    assert dropped.get() == before + 2


def test_chrome_trace_export_loads_as_json(tracer, tmp_path):
    root = tracer.start_root("gateway.request")
    with tracer.start_span("gateway.backend_pick", root, backend="b:1"):
        pass
    root.end()
    path = tmp_path / "trace.json"
    trace.dump_chrome_trace(tracer.collector.spans(root.trace_id), str(path))
    events = json.loads(path.read_text())["traceEvents"]
    assert len(events) == 2
    for ev in events:
        assert ev["ph"] == "X" and ev["ts"] >= 0 and ev["dur"] >= 0
        assert ev["args"]["trace_id"] == root.trace_id
    assert {ev["cat"] for ev in events} == {"gateway"}
    assert chrome_trace([])["traceEvents"] == []
    assert tracer.collector.breakdown(root.trace_id)["children"][0][
        "name"] == "gateway.backend_pick"


# -- the serving path, side by side ----------------------------------------------

def call_wsgi(app, path, body=None, headers=None):
    raw = json.dumps(body).encode() if body is not None else b""
    environ = {"REQUEST_METHOD": "POST" if body is not None else "GET",
               "PATH_INFO": path, "wsgi.input": io.BytesIO(raw),
               "CONTENT_LENGTH": str(len(raw))}
    for name, value in (headers or {}).items():
        environ["HTTP_" + name.upper().replace("-", "_")] = value
    got = {}
    out = b"".join(app(environ, lambda s, h: got.update(status=s)))
    return int(got["status"].split()[0]), json.loads(out)


def span_tree(spans) -> Counter:
    """(name, parent's name or "client", attribute keys) of every span."""
    by_id = {s.span_id: s for s in spans}
    return Counter(
        (s.name, by_id[s.parent_id].name if s.parent_id in by_id
         else "client", tuple(sorted(s.attributes))) for s in spans)


@pytest.fixture(scope="module")
def both_predictors():
    from kubeflow_tpu.serving.predictor import (GenerativePredictor,
                                                PredictorApp)

    ref = GenerativePredictor("llama", size="tiny",
                              model_config={"dtype": "float32"},
                              max_batch=2, max_seq=64)
    port = tpred.GenerativePredictor(
        "llama", size="tiny", model_config={"dtype": "float32"},
        state=convert.from_jax_params(jax.tree.map(np.asarray, ref.params),
                                      tl.llama_tiny(dtype="float32")),
        max_batch=2, max_seq=64, device="cpu")
    yield PredictorApp({"llama": ref}), tpred.PredictorApp({"llama": port})
    ref.engine.shutdown()
    port.stop(timeout=10)


def test_span_tree_equals_the_reference(both_predictors):
    ref_app, port_app = both_predictors
    trees, outs = [], []
    for app, mod in ((ref_app, jtrace), (port_app, trace)):
        t = mod.set_tracer(mod.Tracer(0.0, collector=mod.Collector(4096)))
        try:
            ctx = mod.SpanContext(mod.new_trace_id(), mod.new_span_id(),
                                  True)
            status, body = call_wsgi(
                app, "/v1/models/llama:generate",
                {"ids": [[5, 8, 13]], "max_new_tokens": 4},
                {"Traceparent": ctx.to_traceparent()})
            assert status == 200, body
            spans = t.collector.spans(ctx.trace_id)
            assert all(s.duration is not None for s in spans)
            assert {s.parent_id for s in spans
                    if s.name == "predictor.request"} == {ctx.span_id}
            trees.append(span_tree(spans))
            outs.append(body["ids"])
        finally:
            mod.set_tracer(mod.Tracer(0.0))
    assert outs[0] == outs[1]
    assert trees[1] == trees[0]
    names = {name for name, _, _ in trees[1]}
    assert names == {"predictor.request", "engine.request",
                     "engine.admission_wait", "engine.prefill",
                     "engine.decode"}


def test_unsampled_request_records_nothing_but_serves(both_predictors):
    _, port_app = both_predictors
    t = trace.set_tracer(Tracer(0.0, collector=Collector(64)))
    try:
        status, body = call_wsgi(port_app, "/v1/models/llama:generate",
                                 {"ids": [[3, 4]], "max_new_tokens": 2})
        assert status == 200 and len(body["ids"][0]) == 4
        assert t.collector.spans() == []
    finally:
        trace.set_tracer(Tracer(0.0))


def test_predictor_hands_engine_the_negative_decision():
    captured = {}

    class FakePred:
        def generate(self, ids, **kw):
            captured.update(kw)
            return {"ids": ids}

    app = tpred.PredictorApp({"m": FakePred()})
    t = trace.set_tracer(Tracer(1.0, collector=Collector(64)))
    try:
        ctx = SpanContext(new_trace_id(), new_span_id(), False)
        status, _ = call_wsgi(app, "/v1/models/m:generate", {"ids": [[1]]},
                              {"Traceparent": ctx.to_traceparent(),
                               "Kubeflow-Userid": "team-a"})
        assert status == 200
        got = captured["trace_ctx"]
        assert got is not None and got.sampled is False
        assert got.trace_id == ctx.trace_id
        assert captured["tenant"] == "team-a"
        assert t.collector.spans() == []
    finally:
        trace.set_tracer(Tracer(0.0))


@pytest.fixture()
def tiny_engine_parts():
    module = tl.LlamaModel(tl.llama_tiny(dtype="float32"),
                           device="cpu").init_weights(0)
    return module, module.config


def test_closed_engine_submit_closes_spans_with_error_outcome(
        tracer, tiny_engine_parts):
    module, cfg = tiny_engine_parts
    eng = teng.ContinuousBatcher(module, cfg, max_batch=1, max_seq=64)
    eng.shutdown()
    with pytest.raises(RuntimeError):
        eng.submit([1, 2], max_new_tokens=2)
    reqs = [s for s in tracer.collector.spans()
            if s.name == "engine.request"]
    assert reqs and reqs[-1].attributes["outcome"] == "error"
    assert reqs[-1].duration is not None
    waits = [s for s in tracer.collector.spans(reqs[-1].trace_id)
             if s.name == "engine.admission_wait"]
    assert waits and waits[0].duration is not None


def test_engine_records_shed_outcome_on_span(tracer, tiny_engine_parts):
    module, cfg = tiny_engine_parts
    eng = teng.ContinuousBatcher(module, cfg, max_batch=1, max_seq=64,
                                 max_queue=1)
    try:
        gate = threading.Event()
        admit = eng._admit
        eng._admit = lambda: (gate.wait(30), admit())
        held = eng.submit([1, 2], max_new_tokens=2)
        with pytest.raises(teng.QueueFull):
            eng.submit([1, 2], max_new_tokens=2)
        gate.set()
        held.result(timeout=60)
        outcomes = Counter(s.attributes.get("outcome")
                           for s in tracer.collector.spans()
                           if s.name == "engine.request")
        assert outcomes == {"shed": 1, "ok": 1}
    finally:
        eng.shutdown()


def test_cancelled_request_closes_every_span(tracer, tiny_engine_parts):
    module, cfg = tiny_engine_parts
    eng = teng.ContinuousBatcher(module, cfg, max_batch=1, max_seq=64)
    try:
        gate = threading.Event()
        admit = eng._admit
        eng._admit = lambda: (gate.wait(30), admit())
        req = eng.submit([1, 2, 3], max_new_tokens=8)
        req.cancel()
        gate.set()
        with pytest.raises(teng.RequestCancelled):
            req.result(timeout=60)
        spans = tracer.collector.spans(req.span.trace_id)
        assert {s.name for s in spans} == {"engine.request",
                                           "engine.admission_wait"}
        assert req.span.attributes["outcome"] == "cancelled"
    finally:
        eng.shutdown()
