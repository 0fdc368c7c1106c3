"""Predictor runtime on one CUDA card: the process behind an
InferenceService.

Counterpart of ``kubeflow_tpu/serving/predictor.py``, trimmed to the
port's slices: a generative Llama predictor (dense, or MoE with the
``moe_experts``/``moe_every`` model options) on one card, with the radix
prefix cache over paged KV when ``--prefix-cache-mb`` > 0
(``--kv-page-size``, ``--host-kv-pages``), speculative decoding when
``--speculative-tokens`` > 0 (n-gram drafts, or a truncated-target draft
model with ``--draft-layers``), weight-only int8 (model option
``quantize=int8``), int8 KV pages (``--kv-quant``), and the
disaggregated roles (``--role prefill|decode``); no expert or tensor
parallelism, no weight residency, no checkpoint restore.
Routes, as the reference serves them:

    GET  /healthz                          ready / draining
    GET  /metrics                          Prometheus text
    GET  /v1/models                        list
    GET  /v1/models/<name>                 readiness + engine stats
    POST /v1/models/<name>:generate        {"ids": [[...]], "max_new_tokens",
                                            "temperature", "top_k", "top_p",
                                            "eos_id", "deadline_s", "seed"}
    POST /v1/models/<name>:resume          a serialized prefill handoff
                                           (decode role; serving/disagg.py)
    POST /v1/models/<name>:pages           {"ids": [...]}: the full prefix
                                           pages this engine caches

A prefill-role predictor forwards each request's handoff to the decode
peer named by the ``X-KF-Decode-Peer`` header (``host:port``), all rows
at once, and resumes it on its own engine when there is no peer or the
peer fails.  Overload maps as in the reference: queue full 429 (+
Retry-After), draining 503, deadline 504, bad request 422.  Run it with
``python -m kubeflow_tpu_torch.serving.predictor --model llama:size=7b``
(add ``--prefix-cache-mb 2048`` to reuse shared prompt prefixes,
``--speculative-tokens 4`` to speculate; serve the MoE variant with
``--model 'llama:size=7b,moe_experts=8'``, int8 weights with
``--model 'llama:size=7b,quantize=int8'``; a disaggregated pair as
``--role decode --port 8603`` and ``--role prefill``, with clients
sending ``X-KF-Decode-Peer: 127.0.0.1:8603`` to the prefill one).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any

import torch

from kubeflow_tpu_torch.device import resolve
from kubeflow_tpu_torch.serving.engine import (ContinuousBatcher,
                                               DeadlineExceeded, Draining,
                                               QueueFull)
from kubeflow_tpu_torch.utils.logging import get_logger


class GenerativePredictor:
    """Llama-style decoder serving (text generation).

    Weights come from ``state`` (a state dict, e.g. from
    ``models.convert.from_jax_params``) or, without one, from a seeded
    random init made on the device.  The model holds its weights in the
    compute dtype.  ``prefix_cache_mb`` > 0 opts into radix-tree KV prefix
    reuse over shared refcounted pages of ``kv_page_size`` positions (a
    budget in MB of device memory); ``host_kv_pages`` > 0 opens a host-RAM
    arena of that many pages that the cache spills to before it drops.
    ``speculative_tokens`` > 0 turns on speculative decoding with n-gram
    drafts, or with ``draft_layers`` > 0 a draft model made of the
    target's first ``draft_layers`` blocks (shared weights).  A draft
    depth the target does not have logs and falls back to n-gram; any
    other error while building the drafter propagates.

    ``quantize`` swaps every eligible matmul weight for int8 with
    per-channel scales (``serving/quant.py``), one weight at a time on the
    device, from ``state``'s full-precision values when given;
    ``weight_bytes`` reports the result.  ``kv_quant`` stores KV pages in
    int8.  ``role`` is ``"colocated"``, ``"prefill"`` (admit, prefill and
    forward each handoff to a decode peer through ``handoff_post``, the
    transport seam, default ``disagg.http_post_json``) or ``"decode"``
    (seed slots from ``:resume`` handoffs).  ``directory`` (with
    ``engine_id``, ``engine_addr``) joins the cluster prefix directory:
    cached prefixes are advertised and a local miss fetches a peer's
    pages through its ``:pages`` verb."""

    def __init__(self, model_name: str = "llama", size: str = "tiny",
                 model_config: dict | None = None,
                 state: dict[str, torch.Tensor] | None = None,
                 max_batch: int = 4, max_seq: int = 512, seed: int = 0,
                 prefill_chunk: int = 512, max_queue: int = 0,
                 prefix_cache_mb: float = 0.0, kv_page_size: int = 16,
                 host_kv_pages: int = 0, speculative_tokens: int = 0,
                 draft_layers: int = 0, quantize: bool = False,
                 kv_quant: bool = False, role: str = "colocated",
                 handoff_post=None, directory=None,
                 engine_id: str | None = None, engine_addr: str = "",
                 device: str | torch.device | None = None):
        from kubeflow_tpu_torch.models import registry

        self.name = model_name
        self.role = role
        self._handoff_post = handoff_post
        self.log = get_logger("predictor", model=model_name, size=size)
        device = resolve(device)
        entry = registry.get(model_name)
        if not entry.generative:
            raise ValueError(f"{model_name} is not a generative model")
        with torch.no_grad():
            self.module = entry.make_model(size=size, device=device,
                                           param_dtype="compute",
                                           **(model_config or {}))
            if state is not None:
                self.module.load_state_dict(state)
            else:
                self.module.init_weights(seed)
            if quantize:
                from kubeflow_tpu_torch.serving.quant import (
                    quantize_params, quantized_bytes)

                before = quantized_bytes(self.module)
                quantize_params(self.module, source=state)
                self.log.info("quantized weights int8", bytes_before=before,
                              bytes_after=quantized_bytes(self.module))
        self.module.eval()
        self.cfg = self.module.config
        self.max_seq = min(max_seq, self.cfg.max_seq_len)
        draft_fn = None
        if draft_layers > 0 and speculative_tokens > 0:
            from kubeflow_tpu_torch.serving.draft_model import DraftModel

            try:
                draft_fn = DraftModel(self.module,
                                      num_layers=int(draft_layers))
                self.log.info("draft model enabled",
                              draft_layers=int(draft_layers),
                              target_layers=self.cfg.num_layers)
            except ValueError as e:   # the depth: fall back to n-gram
                self.log.warning("draft model unavailable; using n-gram",
                                 error=str(e))
        self._hand_cv = threading.Condition()
        self._handoffs: dict[int, object] = {}
        engine_kw: dict = {}
        if role == "prefill":
            engine_kw.update(role="prefill",
                             handoff_fn=self._capture_handoff)
        elif role != "colocated":
            engine_kw.update(role=role)
        if directory is not None:
            engine_kw.update(directory=directory, engine_id=engine_id,
                             engine_addr=engine_addr,
                             fetch_fn=self._fetch_pages)
        self.engine = ContinuousBatcher(self.module, self.cfg,
                                        max_batch=max_batch,
                                        max_seq=self.max_seq,
                                        prefill_chunk=prefill_chunk,
                                        max_queue=max_queue,
                                        prefix_cache_bytes=int(
                                            prefix_cache_mb * (1 << 20)),
                                        page_size=kv_page_size,
                                        host_kv_pages=host_kv_pages,
                                        speculative_tokens=speculative_tokens,
                                        draft_fn=draft_fn, kv_quant=kv_quant,
                                        **engine_kw)
        self.log.info("predictor ready", device=str(device),
                      params=sum(p.numel() for p in self.module.parameters()))

    @property
    def weight_bytes(self) -> int:
        """Device bytes of the weights (int8 ones at one byte, their
        scales at four): the reference's ``quantized_bytes``."""
        from kubeflow_tpu_torch.serving.quant import quantized_bytes

        return quantized_bytes(self.module)

    # -- disaggregation handoff plumbing ---------------------------------------
    def _capture_handoff(self, req, state) -> None:
        """The prefill engine's handoff_fn: park the state for the HTTP
        thread driving this request (it forwards to the decode peer; the
        batcher thread goes on to the next prompt)."""
        with self._hand_cv:
            self._handoffs[id(req)] = state
            self._hand_cv.notify_all()

    def _await_handoff(self, req, timeout: float = 600.0):
        """Wait for ``req``'s handoff; None when it finished (or failed)
        locally or the wait gave up (the caller tells them apart by
        ``req._done``)."""
        deadline = time.monotonic() + timeout
        with self._hand_cv:
            while id(req) not in self._handoffs:
                if req._done.is_set():
                    return None
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._hand_cv.wait(min(remaining, 0.1))
            return self._handoffs.pop(id(req))

    def _fetch_pages(self, entry: dict, ids: list[int]) -> dict:
        """The engine's fetch_fn: the owner's ``:pages`` over HTTP."""
        from kubeflow_tpu_torch.serving.disagg import http_post_json

        return http_post_json(entry["addr"], f"/v1/models/{self.name}:pages",
                              {"ids": [int(t) for t in ids]}, timeout=30)

    def export_pages(self, ids: list[int]) -> dict:
        """``:pages``: the full prefix pages this engine caches for
        ``ids``, in the handoff wire format."""
        return self.engine.export_prefix([int(t) for t in ids])

    def resume(self, body: dict) -> dict:
        """``:resume`` (decode role): seed a slot from a serialized
        handoff and decode to completion."""
        from kubeflow_tpu_torch.serving import disagg

        t0 = time.perf_counter()
        timing: dict = {}
        out = disagg.resume_serialized(self.engine, body, timing)
        generated = len(out) - len(body["ids"])
        dt = time.perf_counter() - t0
        return {"ids": out, "tokens_generated": generated,
                "tokens_per_sec": generated / max(dt, 1e-9), **timing}

    def _forward_one(self, r, state, decode_peer) -> None:
        """Forward one captured handoff to the decode peer; on a peer
        failure the state is still resumable (references are released
        only on success), so the request resumes on this engine."""
        from kubeflow_tpu_torch.serving import disagg

        try:
            full = disagg.forward_handoff(
                state, self.engine.pool, decode_peer, self.name,
                post_fn=self._handoff_post or disagg.http_post_json)
            disagg.complete_forwarded(r, full)
        except Exception as e:
            self.log.warning("decode peer failed; resuming locally",
                             peer=decode_peer, error=str(e))
            self._resume_locally(r, state, f"decode peer {decode_peer} "
                                 f"failed: {e}")

    def _resume_locally(self, r, state, why: str) -> None:
        from kubeflow_tpu_torch.serving import disagg

        try:
            self.engine.submit_handoff(state)
        except BaseException as err:
            # the state is in our hands: release it or the pages leak
            disagg.release_handoff(self.engine.pool, state)
            disagg.fail_forwarded(r, f"{why}; local resume failed: {err}")

    def _generate_prefill(self, ids, max_new_tokens, temperature, seed,
                          eos_id, top_k, top_p, deadline_s,
                          decode_peer) -> list[list[int]]:
        """Prefill-role generate: admit every row, then forward each
        handoff to the decode peer CONCURRENTLY (one thread per row, so a
        batch's rows co-batch on the peer), or resume on this engine when
        there is no peer."""
        from kubeflow_tpu_torch.serving import disagg

        reqs = []
        try:
            for i, prompt in enumerate(ids):
                reqs.append(self.engine.submit(
                    prompt, max_new_tokens=max_new_tokens,
                    temperature=temperature, eos_id=eos_id,
                    seed=None if seed is None else seed + i,
                    top_k=top_k, top_p=top_p, deadline_s=deadline_s))
            forwarders = []
            for r in reqs:
                state = self._await_handoff(r)
                if state is None:
                    if not r._done.is_set():
                        # gave up waiting: fail this row, and release a
                        # capture that raced the timeout
                        r.cancel()
                        with self._hand_cv:
                            late = self._handoffs.pop(id(r), None)
                        if late is not None:
                            disagg.release_handoff(self.engine.pool, late)
                            disagg.fail_forwarded(
                                r, "prefill handoff wait timed out")
                    continue               # finished or failed locally
                if decode_peer is None:
                    self._resume_locally(r, state, "no decode peer")
                    continue
                t = threading.Thread(target=self._forward_one,
                                     args=(r, state, decode_peer),
                                     daemon=True)
                t.start()
                forwarders.append(t)
            for t in forwarders:
                t.join(timeout=600)
            return [r.result(timeout=600) for r in reqs]
        except BaseException:
            for r in reqs:
                r.cancel()
                with self._hand_cv:
                    orphan = self._handoffs.pop(id(r), None)
                if orphan is not None:
                    disagg.release_handoff(self.engine.pool, orphan)
            raise

    def generate(self, ids: list[list[int]], max_new_tokens: int = 32,
                 temperature: float = 0.0, seed: int = 0,
                 eos_id: int | None = None, top_k: int = 0,
                 top_p: float = 0.0,
                 deadline_s: float | None = None,
                 decode_peer: str | None = None) -> dict:
        """Generate continuations for a (possibly ragged) batch of prompts
        through the continuous-batching engine; a prefill-role predictor
        hands each off to ``decode_peer`` (``host:port``)."""
        t0 = time.perf_counter()
        if self.role == "prefill":
            out_ids = self._generate_prefill(
                ids, max_new_tokens, temperature, seed, eos_id, top_k,
                top_p, deadline_s, decode_peer)
        else:
            out_ids = self.engine.generate_sync(
                ids, max_new_tokens=max_new_tokens, temperature=temperature,
                eos_id=eos_id, seed=seed, top_k=top_k, top_p=top_p,
                deadline_s=deadline_s)
        dt = time.perf_counter() - t0
        generated = sum(len(o) - len(i) for o, i in zip(out_ids, ids))
        return {"ids": out_ids, "tokens_generated": generated,
                "tokens_per_sec": generated / dt}

    def drain(self) -> None:
        self.engine.drain()

    @property
    def draining(self) -> bool:
        return self.engine.stats().get("draining", False)

    def stop(self, timeout: float = 60.0) -> bool:
        """Drain, wait for the engine to go idle, then shut it down."""
        self.drain()
        idle = self.engine.drained(timeout)
        self.engine.shutdown()
        return idle


class PredictorApp:
    """WSGI app exposing one or more generative predictors."""

    def __init__(self, predictors: dict[str, Any]):
        self.predictors = predictors
        self.log = get_logger("predictor.http")

    def __call__(self, environ, start_response):
        path = environ.get("PATH_INFO", "/")
        method = environ["REQUEST_METHOD"]
        headers: list[tuple[str, str]] = []
        try:
            out = self._route(method, path, environ)
            status, body = out[0], out[1]
            if len(out) > 2:
                headers = list(out[2])
        except KeyError as e:
            status, body = "404 Not Found", {"error": f"no route {e}"}
        except QueueFull as e:
            status, body = "429 Too Many Requests", {"error": str(e)}
            headers = [("Retry-After", f"{max(1, round(e.retry_after))}")]
        except Draining as e:
            status, body = "503 Service Unavailable", {"error": str(e)}
            headers = [("Retry-After", "1")]
        except DeadlineExceeded as e:
            status, body = "504 Gateway Timeout", {"error": str(e)}
        except ValueError as e:   # includes malformed JSON bodies
            status, body = "422 Unprocessable Entity", {"error": str(e)}
        except Exception as e:
            self.log.error("request failed", exc_info=True, path=path)
            status, body = "500 Internal Server Error", {"error": str(e)}
        if isinstance(body, str):  # /metrics Prometheus text
            payload = body.encode()
            ctype = "text/plain; version=0.0.4"
        else:
            payload = json.dumps(body).encode()
            ctype = "application/json"
        start_response(status, [("Content-Type", ctype),
                                ("Content-Length", str(len(payload)))]
                       + headers)
        return [payload]

    @property
    def draining(self) -> bool:
        return any(p.draining for p in self.predictors.values())

    def drain(self) -> None:
        for pred in self.predictors.values():
            pred.drain()

    def drained(self, timeout: float = 60.0) -> bool:
        deadline = time.monotonic() + timeout
        ok = True
        for pred in self.predictors.values():
            ok &= pred.engine.drained(max(0.0, deadline - time.monotonic()))
        return ok

    @staticmethod
    def _deadline_s(environ, body) -> float | None:
        """X-Request-Deadline header (seconds) or a 'deadline_s' body
        field; header wins; non-positive or malformed means none."""
        raw = environ.get("HTTP_X_REQUEST_DEADLINE")
        if raw is None:
            raw = body.get("deadline_s")
        if raw is None:
            return None
        try:
            val = float(raw)
        except (TypeError, ValueError):
            return None
        return val if val > 0 else None

    def _route(self, method, path, environ):
        if path == "/healthz":
            if self.draining:
                return ("503 Service Unavailable", {"status": "draining"},
                        [("Retry-After", "1")])
            return "200 OK", {"status": "ok"}
        if path == "/metrics":
            from kubeflow_tpu_torch.utils.metrics import REGISTRY

            return "200 OK", REGISTRY.expose()
        if path == "/v1/models" and method == "GET":
            return "200 OK", {"models": sorted(self.predictors)}
        if path.startswith("/v1/models/"):
            rest = path[len("/v1/models/"):]
            if ":" not in rest:
                pred = self.predictors[rest]
                return "200 OK", {"name": rest, "ready": not pred.draining,
                                  "stats": pred.engine.stats()}
            name, verb = rest.split(":", 1)
            pred = self.predictors[name]
            if verb == "generate" and method == "POST":
                body = self._body(environ)
                eos = body.get("eos_id")
                kw = {}
                if getattr(pred, "role", "colocated") == "prefill":
                    # the decode worker picked for this request
                    kw["decode_peer"] = environ.get("HTTP_X_KF_DECODE_PEER")
                return "200 OK", pred.generate(
                    body["ids"],
                    max_new_tokens=int(body.get("max_new_tokens", 32)),
                    temperature=float(body.get("temperature", 0.0)),
                    seed=int(body.get("seed", 0)),
                    eos_id=int(eos) if eos is not None else None,
                    top_k=int(body.get("top_k", 0)),
                    top_p=float(body.get("top_p", 0.0)),
                    deadline_s=self._deadline_s(environ, body), **kw)
            if verb == "resume" and method == "POST":
                # a pool that cannot host the pages sheds (QueueFull: 429)
                return "200 OK", pred.resume(self._body(environ))
            if verb == "pages" and method == "POST":
                return "200 OK", pred.export_pages(
                    self._body(environ).get("ids") or [])
        raise KeyError(path)

    @staticmethod
    def _body(environ) -> dict:
        length = int(environ.get("CONTENT_LENGTH") or 0)
        body = json.loads(environ["wsgi.input"].read(length) or b"{}")
        if not isinstance(body, dict) or "ids" not in body:
            raise ValueError("body must be a JSON object with 'ids'")
        return body


# flags of the reference predictor this port does not serve yet, with the
# default that means "off"; setting one away from it is an error
_UNSUPPORTED_FLAGS = {
    "checkpoint_dir": None, "weight_budget_mb": 0.0, "staging_mb": 64.0,
}
# per-model options (``--model name:k=v``) likewise unsupported when set
_UNSUPPORTED_OPTS = {
    "checkpoint_dir": "", "tp": "1", "ep": "1", "staging_mb": "64",
    "parked": "",
}
# per-model options that configure the model itself (the MoE variant)
_MODEL_CONFIG_OPTS = ("moe_experts", "moe_every")


def _parse_model_spec(spec: str, args) -> tuple[str, dict]:
    name, _, rest = spec.partition(":")
    opts = dict(kv.split("=", 1) for kv in rest.split(",") if "=" in kv)
    for key, off in _UNSUPPORTED_OPTS.items():
        if key in opts and opts[key].lower() not in (off, "false", "0.0"):
            raise SystemExit(f"--model option {key}={opts[key]} is not yet "
                             "supported by the PyTorch predictor")
    known = {"size", "max_batch", "max_seq", "prefill_chunk", "max_queue",
             "prefix_cache_mb", "kv_page_size", "host_kv_pages",
             "speculative_tokens", "draft_layers", "quantize", "kv_quant",
             "role", *_MODEL_CONFIG_OPTS, *_UNSUPPORTED_OPTS}
    unknown = sorted(set(opts) - known)
    if unknown:
        raise SystemExit(f"unknown --model options {unknown}")
    kw = {"size": opts.get("size", args.size),
          "max_batch": int(opts.get("max_batch", args.max_batch)),
          "max_seq": int(opts.get("max_seq", args.max_seq)),
          "prefill_chunk": int(opts.get("prefill_chunk", args.prefill_chunk)),
          "max_queue": int(opts.get("max_queue", args.max_queue)),
          "prefix_cache_mb": float(opts.get("prefix_cache_mb",
                                            args.prefix_cache_mb)),
          "kv_page_size": int(opts.get("kv_page_size", args.kv_page_size)),
          "host_kv_pages": int(opts.get("host_kv_pages",
                                        args.host_kv_pages)),
          "speculative_tokens": int(opts.get("speculative_tokens",
                                             args.speculative_tokens)),
          "draft_layers": int(opts.get("draft_layers", args.draft_layers)),
          "quantize": opts.get("quantize", "").lower() in ("1", "true",
                                                           "int8"),
          "kv_quant": (opts.get("kv_quant", "").lower() in ("1", "true")
                       or args.kv_quant),
          "role": opts.get("role", args.role),
          "model_config": {k: int(opts[k]) for k in _MODEL_CONFIG_OPTS
                           if k in opts} or None}
    if kw["role"] not in ("colocated", "prefill", "decode"):
        raise SystemExit(f"--model option role={kw['role']} is not a role")
    return name, kw


def main(argv=None) -> int:
    import argparse
    import os
    import signal
    import threading

    from kubeflow_tpu_torch.serving.httpserve import serve

    parser = argparse.ArgumentParser(
        "kubeflow_tpu_torch.serving",
        description="Serve registry models from one process on one CUDA "
                    "card: --model 'llama:size=7b'.  Flags of the reference "
                    "predictor that this port does not serve yet are "
                    "accepted only at their defaults.")
    parser.add_argument("--model", action="append", dest="models",
                        default=None)
    parser.add_argument("--size", default="tiny")
    parser.add_argument("--checkpoint-dir")
    parser.add_argument("--port", type=int, default=8602)
    parser.add_argument("--max-batch", type=int, default=4)
    parser.add_argument("--max-seq", type=int, default=512)
    parser.add_argument("--prefix-cache-mb", type=float, default=0.0)
    parser.add_argument("--prefill-chunk", type=int, default=512)
    parser.add_argument("--max-queue", type=int, default=0)
    parser.add_argument("--kv-page-size", type=int, default=16)
    parser.add_argument("--host-kv-pages", type=int, default=0)
    parser.add_argument("--speculative-tokens", type=int, default=0,
                        help="max draft tokens per speculative-decoding "
                             "round (0 = off); streams are unchanged")
    parser.add_argument("--draft-layers", type=int, default=0,
                        help="draft with the target's first N blocks "
                             "instead of n-gram lookup (needs "
                             "--speculative-tokens)")
    parser.add_argument("--role", default="colocated",
                        choices=("colocated", "prefill", "decode"),
                        help="disaggregated serving: prefill admits prompts "
                             "and hands their KV pages to the decode peer "
                             "named by X-KF-Decode-Peer; decode serves "
                             ":resume")
    parser.add_argument("--kv-quant", action="store_true",
                        help="int8 KV pages with per-(page, head) scales "
                             "(~2x the pages per budget; lossy)")
    parser.add_argument("--weight-budget-mb", type=float, default=0.0)
    parser.add_argument("--staging-mb", type=float, default=64.0)
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' to run the "
                             "plain path on the host)")
    args = parser.parse_args(argv)
    for key, off in _UNSUPPORTED_FLAGS.items():
        if getattr(args, key) != off:
            parser.error(f"--{key.replace('_', '-')} is not yet supported "
                         "by the PyTorch predictor")

    predictors = {}
    for spec in [m for m in (args.models or []) if m] or ["llama"]:
        name, kw = _parse_model_spec(spec, args)
        predictors[name] = GenerativePredictor(name, device=args.device,
                                               **kw)
    port = int(os.environ.get("KF_POD_PORT", args.port))
    app = PredictorApp(predictors)
    httpd, thread = serve(app, port)

    def _drain_and_exit():
        app.drain()
        app.drained(timeout=float(os.environ.get("KF_DRAIN_GRACE", "60")))
        httpd.shutdown()

    def _on_sigterm(signum, frame):
        threading.Thread(target=_drain_and_exit, daemon=True).start()

    signal.signal(signal.SIGTERM, _on_sigterm)
    print(f"predictor serving {sorted(predictors)} on :{port}", flush=True)
    thread.join()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
