"""Serving engine and predictor of the PyTorch port.

Against the JAX ``ContinuousBatcher`` at float32 (prefix cache off), the
port's engine must give IDENTICAL greedy token streams for ragged prompts,
one longer than ``prefill_chunk`` (a chunked prefill through the flash
route).  Seeded sampling is held within the port: deterministic, and
independent of co-batched traffic (PRNG streams differ between the
frameworks by design).  The HTTP surface runs through ``PredictorApp`` as
a WSGI callable.
"""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.parallel.sharding import unbox_params
from kubeflow_tpu.serving.engine import ContinuousBatcher as JaxBatcher
from kubeflow_tpu.serving.engine import _filter_logits
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.ops import attention as tattention
from kubeflow_tpu_torch.serving import engine as teng
from kubeflow_tpu_torch.serving import predictor as tpred

MAX_SEQ, CHUNK = 128, 16


@pytest.fixture(autouse=True)
def flash_route_at_head_dim_16(monkeypatch):
    """The dispatcher takes the flash route only at the head dims the
    kernel is built for; the tiny models' head_dim is 16, so it joins them
    here and the ``use_flash`` cases run the flash Function's plain
    versions through the model."""
    monkeypatch.setattr(tattention, "HEAD_DIMS",
                        tattention.HEAD_DIMS + (16,))


@pytest.fixture(scope="module")
def jax_side():
    cfg = jl.llama_tiny(use_flash=True, dtype="float32")
    model = jl.LlamaModel(cfg)
    params = unbox_params(jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    return cfg, model, params


@pytest.fixture(scope="module")
def predictor(jax_side):
    _, _, params = jax_side
    tcfg = tl.llama_tiny(use_flash=True, dtype="float32")
    state = convert.from_jax_params(jax.tree.map(np.asarray, params), tcfg)
    pred = tpred.GenerativePredictor(
        "llama", size="tiny",
        model_config={"dtype": "float32", "use_flash": True}, state=state,
        max_seq=MAX_SEQ, prefill_chunk=CHUNK, device="cpu")
    yield pred
    pred.stop(timeout=30)


def prompts(seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, n).tolist() for n in (5, 23, 40)]


def test_greedy_streams_identical_to_jax_engine(jax_side, predictor):
    cfg, model, params = jax_side
    jb = JaxBatcher(model, params, cfg, max_batch=4, max_seq=MAX_SEQ,
                    prefill_chunk=CHUNK)
    try:
        ref = jb.generate_sync(prompts(), max_new_tokens=12)
    finally:
        jb.shutdown()
    out = predictor.engine.generate_sync(prompts(), max_new_tokens=12)
    assert out == ref
    # eos ends a stream early at the same token on both sides
    eos = ref[1][23 + 3]
    got = predictor.engine.generate_sync([prompts()[1]], max_new_tokens=12,
                                         eos_id=eos)
    assert got[0] == ref[1][:23 + 4]


def test_seeded_sampling_is_deterministic_and_batch_independent(predictor):
    p = prompts(seed=2)
    eng = predictor.engine
    alone = eng.generate_sync([p[1]], max_new_tokens=10, temperature=0.8,
                              seed=7, top_k=50, top_p=0.9)
    again = eng.generate_sync([p[1]], max_new_tokens=10, temperature=0.8,
                              seed=7, top_k=50, top_p=0.9)
    reqs = [eng.submit(p[0], 10, temperature=1.0, seed=3),
            eng.submit(p[1], 10, temperature=0.8, seed=7, top_k=50,
                       top_p=0.9),
            eng.submit(p[2], 10, temperature=0.0)]
    co = [r.result(timeout=60) for r in reqs]
    assert alone == again
    assert co[1] == alone[0]
    other = eng.generate_sync([p[1]], max_new_tokens=10, temperature=0.8,
                              seed=8, top_k=50, top_p=0.9)
    assert other != alone      # the seed matters


@pytest.mark.parametrize("top_k,top_p", [(0, 0.0), (5, 0.0), (0, 0.7),
                                         (7, 0.5), (1, 0.99)])
def test_filter_logits_matches_reference(top_k, top_p):
    logits = np.random.default_rng(4).standard_normal((3, 40)).astype(
        np.float32)
    ks = np.array([top_k, 0, top_k], np.int32)
    ps = np.array([top_p, top_p, 0.0], np.float32)
    ref = np.asarray(_filter_logits(jnp.asarray(logits), jnp.asarray(ks),
                                    jnp.asarray(ps)))
    out = teng.filter_logits(torch.from_numpy(logits),
                             torch.from_numpy(ks).long(),
                             torch.from_numpy(ps)).numpy()
    assert np.array_equal(np.isinf(out), np.isinf(ref))
    assert np.array_equal(out[~np.isinf(out)], ref[~np.isinf(ref)])


def wsgi(app, method, path, body=None):
    raw = json.dumps(body).encode() if body is not None else b""
    environ = {"REQUEST_METHOD": method, "PATH_INFO": path,
               "CONTENT_LENGTH": str(len(raw)),
               "wsgi.input": io.BytesIO(raw)}
    got = {}

    def start_response(status, headers):
        got["status"], got["headers"] = status, dict(headers)

    payload = b"".join(app(environ, start_response))
    ctype = got["headers"]["Content-Type"]
    data = json.loads(payload) if "json" in ctype else payload.decode()
    return int(got["status"].split()[0]), data, got["headers"]


def test_http_generate_and_routes(predictor):
    app = tpred.PredictorApp({"llama": predictor})
    p = prompts()
    status, body, _ = wsgi(app, "POST", "/v1/models/llama:generate",
                           {"ids": [p[0], p[2]], "max_new_tokens": 6})
    assert status == 200
    assert body["ids"] == predictor.engine.generate_sync(
        [p[0], p[2]], max_new_tokens=6)
    assert body["tokens_generated"] == 12
    assert wsgi(app, "GET", "/healthz")[:2] == (200, {"status": "ok"})
    assert wsgi(app, "GET", "/v1/models")[1] == {"models": ["llama"]}
    status, meta, _ = wsgi(app, "GET", "/v1/models/llama")
    assert status == 200 and meta["ready"] and meta["stats"]["max_batch"] == 4
    status, text, _ = wsgi(app, "GET", "/metrics")
    assert status == 200 and "serving_tokens_generated_total" in text
    assert wsgi(app, "POST", "/v1/models/nope:generate",
                {"ids": [[1]]})[0] == 404
    assert wsgi(app, "POST", "/v1/models/llama:generate",
                {"ids": [[1] * 200], "max_new_tokens": 4})[0] == 422
    assert wsgi(app, "POST", "/v1/models/llama:generate",
                {"ids": [[999999]]})[0] == 422


class _Overloaded:
    """A predictor stand-in whose engine refuses work."""
    draining = False

    def __init__(self, exc):
        self.exc = exc

    def generate(self, *a, **kw):
        raise self.exc


@pytest.mark.parametrize("exc,status", [
    (teng.QueueFull("full", retry_after=2.6), 429),
    (teng.Draining("draining"), 503),
    (teng.DeadlineExceeded("late"), 504),
])
def test_http_overload_mapping(exc, status):
    app = tpred.PredictorApp({"m": _Overloaded(exc)})
    got, _, headers = wsgi(app, "POST", "/v1/models/m:generate",
                           {"ids": [[1, 2]]})
    assert got == status
    if status == 429:
        assert headers["Retry-After"] == "3"


def test_bounded_queue_sheds_and_drain_rejects(jax_side):
    _, _, params = jax_side
    tcfg = tl.llama_tiny(dtype="float32")
    pred = tpred.GenerativePredictor(
        "llama", size="tiny", model_config={"dtype": "float32"},
        state=convert.from_jax_params(jax.tree.map(np.asarray, params),
                                      tcfg),
        max_seq=MAX_SEQ, max_batch=1, max_queue=1, device="cpu")
    eng = pred.engine
    try:
        # no batcher thread runs before the first submit, so a request
        # placed in the queue stays there
        eng.queue.append(teng.GenRequest([1, 2], 4, 0.0))
        with pytest.raises(teng.QueueFull):
            eng.submit([3, 4], 4)
        eng.queue.clear()
        pred.drain()
        with pytest.raises(teng.Draining):
            eng.submit([5], 2)
        assert eng.drained(timeout=5)
    finally:
        pred.stop(timeout=10)


@pytest.mark.parametrize("argv,flag", [
    (["--staging-mb", "0"], "--staging-mb"),
    (["--weight-budget-mb", "-64"], "--weight-budget-mb"),
    (["--checkpoint-dir", "/ckpt"], "--checkpoint-dir"),
])
def test_main_refuses_unported_flags(argv, flag, capsys):
    """The residency and checkpoint flags are served now; main refuses
    their unusable values by name before it builds anything (an empty
    window, a negative budget, a directory without a streamable
    manifest)."""
    with pytest.raises(SystemExit):
        tpred.main(argv + ["--device", "cpu"])
    assert flag in capsys.readouterr().err


class _Built(Exception):
    """Raised by the predictor stand-in once main() has built its args."""


@pytest.mark.parametrize("argv,want", [
    (["--prefix-cache-mb", "8"], {"prefix_cache_mb": 8.0}),
    (["--kv-page-size", "32"], {"kv_page_size": 32}),
    (["--host-kv-pages", "64"], {"host_kv_pages": 64}),
    (["--model", "llama:prefix_cache_mb=4,kv_page_size=8,host_kv_pages=2"],
     {"prefix_cache_mb": 4.0, "kv_page_size": 8, "host_kv_pages": 2}),
])
def test_main_accepts_prefix_cache_flags(argv, want, monkeypatch):
    seen = {}

    def built(name, **kw):
        seen.update(kw)
        raise _Built

    monkeypatch.setattr(tpred, "GenerativePredictor", built)
    with pytest.raises(_Built):
        tpred.main(argv + ["--device", "cpu"])
    defaults = {"prefix_cache_mb": 0.0, "kv_page_size": 16,
                "host_kv_pages": 0}
    assert {k: seen[k] for k in defaults} == {**defaults, **want}


@pytest.mark.parametrize("argv,want", [
    (["--role", "prefill"], {"role": "prefill"}),
    (["--role", "decode", "--kv-quant"], {"role": "decode",
                                          "kv_quant": True}),
    (["--model", "llama:quantize=int8"], {"quantize": True}),
    (["--model", "llama:role=prefill,kv_quant=true,quantize=1"],
     {"role": "prefill", "kv_quant": True, "quantize": True}),
])
def test_main_accepts_int8_and_role_flags(argv, want, monkeypatch):
    seen = {}

    def built(name, **kw):
        seen.update(kw)
        raise _Built

    monkeypatch.setattr(tpred, "GenerativePredictor", built)
    with pytest.raises(_Built):
        tpred.main(argv + ["--device", "cpu"])
    defaults = {"role": "colocated", "kv_quant": False, "quantize": False}
    assert {k: seen[k] for k in defaults} == {**defaults, **want}


@pytest.mark.parametrize("argv,want", [
    (["--speculative-tokens", "4"], {"speculative_tokens": 4}),
    (["--speculative-tokens", "4", "--draft-layers", "2"],
     {"speculative_tokens": 4, "draft_layers": 2}),
    (["--model", "llama:speculative_tokens=3,draft_layers=1"],
     {"speculative_tokens": 3, "draft_layers": 1}),
    (["--model", "llama:size=7b,moe_experts=8"],
     {"model_config": {"moe_experts": 8}, "size": "7b"}),
    (["--model", "llama:moe_experts=4,moe_every=1"],
     {"model_config": {"moe_experts": 4, "moe_every": 1}}),
])
def test_main_accepts_speculation_and_moe_options(argv, want, monkeypatch):
    seen = {}

    def built(name, **kw):
        seen.update(kw)
        raise _Built

    monkeypatch.setattr(tpred, "GenerativePredictor", built)
    with pytest.raises(_Built):
        tpred.main(argv + ["--device", "cpu"])
    defaults = {"speculative_tokens": 0, "draft_layers": 0,
                "model_config": None, "size": "tiny"}
    assert {k: seen[k] for k in defaults} == {**defaults, **want}


def test_moe_predictor_serves_with_a_float32_router():
    pred = tpred.GenerativePredictor(
        "llama", size="tiny", model_config={"moe_experts": 2}, max_seq=64,
        device="cpu", speculative_tokens=2)
    try:
        dtypes = {n: p.dtype for n, p in pred.module.named_parameters()}
        assert dtypes["layers.0.moe.router.kernel"] == torch.float32
        assert dtypes["layers.0.moe.w_in"] == torch.bfloat16
        app = tpred.PredictorApp({"llama": pred})
        status, body, _ = wsgi(app, "POST", "/v1/models/llama:generate",
                               {"ids": [prompts()[1]], "max_new_tokens": 6})
        assert status == 200 and body["tokens_generated"] == 6
        stats = wsgi(app, "GET", "/v1/models/llama")[1]["stats"]
        assert stats["speculative"]["max_tokens"] == 2
    finally:
        pred.stop(timeout=10)


def test_prefix_cache_options_reach_the_engine(jax_side):
    _, _, params = jax_side
    tcfg = tl.llama_tiny(dtype="float32")
    pred = tpred.GenerativePredictor(
        "llama", size="tiny", model_config={"dtype": "float32"},
        state=convert.from_jax_params(jax.tree.map(np.asarray, params),
                                      tcfg),
        max_seq=MAX_SEQ, device="cpu", prefix_cache_mb=0.5,
        kv_page_size=32, host_kv_pages=3)
    try:
        eng = pred.engine
        page = tl.kv_page_nbytes(tcfg, 32)
        assert eng.page_size == 32 and eng.pool.host_pages == 3
        assert eng.prefix_cache.max_pages == (1 << 19) // page
        status, meta, _ = wsgi(tpred.PredictorApp({"llama": pred}), "GET",
                               "/v1/models/llama")
        assert status == 200
        assert meta["stats"]["prefix_cache"]["max_pages"] == (1 << 19) // page
        assert meta["stats"]["kv_pool"]["host_capacity"] == 3
        assert meta["stats"]["kv_pool"]["orphan_pages"] == 0
    finally:
        pred.stop(timeout=10)


def test_main_refuses_unported_model_options():
    # a checkpoint_dir without a streamable manifest (orbax, or nothing)
    with pytest.raises(SystemExit, match="checkpoint_dir"):
        tpred.main(["--model", "llama:checkpoint_dir=/ckpt", "--device",
                    "cpu"])
    with pytest.raises(SystemExit, match="tp=2"):
        tpred.main(["--model", "llama:tp=2", "--device", "cpu"])
    # expert parallelism waits for the multi-device slice
    with pytest.raises(SystemExit, match="ep=2"):
        tpred.main(["--model", "llama:moe_experts=8,ep=2", "--device",
                    "cpu"])
