"""Predictor runtime on one CUDA card: the process behind an
InferenceService.

Counterpart of ``kubeflow_tpu/serving/predictor.py``, trimmed to this
slice: a generative Llama predictor in the default configuration
(colocated, no prefix cache, no speculation, no quantization, one card).
Routes, as the reference serves them:

    GET  /healthz                          ready / draining
    GET  /metrics                          Prometheus text
    GET  /v1/models                        list
    GET  /v1/models/<name>                 readiness + engine stats
    POST /v1/models/<name>:generate        {"ids": [[...]], "max_new_tokens",
                                            "temperature", "top_k", "top_p",
                                            "eos_id", "deadline_s", "seed"}

Overload maps as in the reference: queue full 429 (+ Retry-After),
draining 503, deadline 504, bad request 422.  Run it with
``python -m kubeflow_tpu_torch.serving.predictor --model llama:size=7b``.
"""

from __future__ import annotations

import json
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
    compute dtype."""

    def __init__(self, model_name: str = "llama", size: str = "tiny",
                 model_config: dict | None = None,
                 state: dict[str, torch.Tensor] | None = None,
                 max_batch: int = 4, max_seq: int = 512, seed: int = 0,
                 prefill_chunk: int = 512, max_queue: int = 0,
                 device: str | torch.device | None = None):
        from kubeflow_tpu_torch.models import registry

        self.name = model_name
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
        self.module.eval()
        self.cfg = self.module.config
        self.max_seq = min(max_seq, self.cfg.max_seq_len)
        self.engine = ContinuousBatcher(self.module, self.cfg,
                                        max_batch=max_batch,
                                        max_seq=self.max_seq,
                                        prefill_chunk=prefill_chunk,
                                        max_queue=max_queue)
        self.log.info("predictor ready", device=str(device),
                      params=sum(p.numel() for p in self.module.parameters()))

    def generate(self, ids: list[list[int]], max_new_tokens: int = 32,
                 temperature: float = 0.0, seed: int = 0,
                 eos_id: int | None = None, top_k: int = 0,
                 top_p: float = 0.0,
                 deadline_s: float | None = None) -> dict:
        """Generate continuations for a (possibly ragged) batch of prompts
        through the continuous-batching engine."""
        t0 = time.perf_counter()
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
                return "200 OK", pred.generate(
                    body["ids"],
                    max_new_tokens=int(body.get("max_new_tokens", 32)),
                    temperature=float(body.get("temperature", 0.0)),
                    seed=int(body.get("seed", 0)),
                    eos_id=int(eos) if eos is not None else None,
                    top_k=int(body.get("top_k", 0)),
                    top_p=float(body.get("top_p", 0.0)),
                    deadline_s=self._deadline_s(environ, body))
        raise KeyError(path)

    @staticmethod
    def _body(environ) -> dict:
        length = int(environ.get("CONTENT_LENGTH") or 0)
        body = json.loads(environ["wsgi.input"].read(length) or b"{}")
        if not isinstance(body, dict) or "ids" not in body:
            raise ValueError("body must be a JSON object with 'ids'")
        return body


# flags of the reference predictor this slice does not serve yet, with the
# default that means "off"; setting one away from it is an error
_UNSUPPORTED_FLAGS = {
    "checkpoint_dir": None, "prefix_cache_mb": 0.0, "kv_page_size": 16,
    "host_kv_pages": 0, "speculative_tokens": 0, "draft_layers": 0,
    "role": "colocated", "kv_quant": False, "weight_budget_mb": 0.0,
    "staging_mb": 64.0,
}
# per-model options (``--model name:k=v``) likewise unsupported when set
_UNSUPPORTED_OPTS = {
    "checkpoint_dir": "", "quantize": "", "tp": "1", "ep": "1",
    "prefix_cache_mb": "0", "kv_page_size": "16", "host_kv_pages": "0",
    "speculative_tokens": "0", "draft_layers": "0", "role": "colocated",
    "kv_quant": "", "staging_mb": "64", "parked": "", "moe_experts": "0",
}


def _parse_model_spec(spec: str, args) -> tuple[str, dict]:
    name, _, rest = spec.partition(":")
    opts = dict(kv.split("=", 1) for kv in rest.split(",") if "=" in kv)
    for key, off in _UNSUPPORTED_OPTS.items():
        if key in opts and opts[key].lower() not in (off, "false", "0.0"):
            raise SystemExit(f"--model option {key}={opts[key]} is not yet "
                             "supported by the PyTorch predictor")
    known = {"size", "max_batch", "max_seq", "prefill_chunk", "max_queue",
             *_UNSUPPORTED_OPTS}
    unknown = sorted(set(opts) - known)
    if unknown:
        raise SystemExit(f"unknown --model options {unknown}")
    kw = {"size": opts.get("size", args.size),
          "max_batch": int(opts.get("max_batch", args.max_batch)),
          "max_seq": int(opts.get("max_seq", args.max_seq)),
          "prefill_chunk": int(opts.get("prefill_chunk", args.prefill_chunk)),
          "max_queue": int(opts.get("max_queue", args.max_queue))}
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
    parser.add_argument("--speculative-tokens", type=int, default=0)
    parser.add_argument("--draft-layers", type=int, default=0)
    parser.add_argument("--role", default="colocated",
                        choices=("colocated", "prefill", "decode"))
    parser.add_argument("--kv-quant", action="store_true")
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
