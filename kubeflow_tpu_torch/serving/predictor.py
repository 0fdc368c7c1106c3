"""Predictor runtime on one CUDA card: the process behind an
InferenceService.

Counterpart of ``kubeflow_tpu/serving/predictor.py`` on one card.  A
generative Llama predictor (dense, or MoE with the ``moe_experts`` /
``moe_every`` model options) with the radix prefix cache over paged KV
when ``--prefix-cache-mb`` > 0 (``--kv-page-size``, ``--host-kv-pages``),
speculative decoding when ``--speculative-tokens`` > 0 (n-gram drafts, or
a truncated-target draft model with ``--draft-layers``), weight-only int8
(model option ``quantize=int8``), int8 KV pages (``--kv-quant``), the
disaggregated roles (``--role prefill|decode``), tenant-fair admission
(the ``Kubeflow-Userid`` header names the tenant; ``tenant_shares=``) and
request tracing (``KF_TRACE_SAMPLE``, W3C ``traceparent``).  Weights come
from a seeded init or a streamed checkpoint (``--checkpoint-dir``, the
``serving/model_pool.py`` format, through a ``--staging-mb`` host
window); ``--weight-budget-mb`` puts every generative model under one
weight-residency pool (idle models park, cold requests coalesce behind
one load, an engine's page pressure evicts an idle sibling's weights
into page slots), and ``parked=true`` starts a model parked.  Every
other registry model serves ``:predict`` (``ClassifierPredictor``).  No
expert or tensor parallelism (``tp``/``ep`` are refused).  Routes, as the
reference serves them:

    GET  /healthz                          ready / draining
    GET  /metrics                          Prometheus text
    GET  /v1/models                        list
    GET  /v1/models/<name>                 readiness, residency, engine stats
    POST /v1/models/<name>:generate        {"ids": [[...]], "max_new_tokens",
                                            "temperature", "top_k", "top_p",
                                            "eos_id", "deadline_s", "seed"}
    POST /v1/models/<name>:predict         {"instances": [...]} -> argmax
                                           predictions and logits
    POST /v1/models/<name>:resume          a serialized prefill handoff
                                           (decode role; serving/disagg.py)
    POST /v1/models/<name>:pages           {"ids": [...]}: the full prefix
                                           pages this engine caches

A prefill-role predictor forwards each request's handoff to the decode
peer named by the ``X-KF-Decode-Peer`` header (``host:port``), all rows
at once, and resumes it on its own engine when there is no peer or the
peer fails.  Overload maps as in the reference: queue full 429 (+
Retry-After), draining 503, deadline 504, bad request 422, anything else
(a draining residency entry included) 500.  Run it with ``python -m
kubeflow_tpu_torch.serving.predictor --model llama:size=7b`` (add
``--prefix-cache-mb 2048`` to reuse shared prompt prefixes,
``--speculative-tokens 4`` to speculate; serve the MoE variant with
``--model 'llama:size=7b,moe_experts=8'``, int8 weights with ``--model
'llama:size=7b,quantize=int8'``; a disaggregated pair as ``--role decode
--port 8603`` and ``--role prefill``, with clients sending
``X-KF-Decode-Peer: 127.0.0.1:8603`` to the prefill one; a checkpoint
with ``--checkpoint-dir /ckpt/llama``, and several models under one
weight budget with ``--weight-budget-mb``).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any

import numpy as np
import torch
from torch import nn

from kubeflow_tpu_torch import trace
from kubeflow_tpu_torch.device import resolve
from kubeflow_tpu_torch.serving import model_pool as mp
from kubeflow_tpu_torch.serving.engine import (ContinuousBatcher,
                                               DeadlineExceeded, Draining,
                                               QueueFull)
from kubeflow_tpu_torch.serving.quant import (quantize_param,
                                              quantized_bytes, wants_quant)
from kubeflow_tpu_torch.utils.logging import get_logger


class GenerativePredictor:
    """Llama-style decoder serving (text generation).

    Weights come from ``checkpoint_dir`` (a streamed checkpoint, read
    through a ``staging_mb`` host window), from ``state`` (a state dict,
    e.g. from ``models.convert.from_jax_params``) or, without either, from
    a seeded random init made on the device.  The model holds its weights
    in the compute dtype; a float32 checkpoint is cast on the card.  The
    one loader (``_load_params``) serves cold construction and every
    re-warm: the module is built without storage and each weight is made,
    restored or copied, and int8-quantized when ``quantize`` asks, before
    the next one lands, so an int8 model never holds its full-precision
    copy.  ``park`` drops the weights and keeps the engine, its page pool,
    prefix cache and drafter; ``warm`` reloads them (idempotent).
    ``prefix_cache_mb`` > 0 opts into radix-tree KV prefix reuse over
    shared refcounted pages of ``kv_page_size`` positions (a budget in MB
    of device memory); ``host_kv_pages`` > 0 opens a host-RAM arena of
    that many pages that the cache spills to before it drops.
    ``speculative_tokens`` > 0 turns on speculative decoding with n-gram
    drafts, or with ``draft_layers`` > 0 a draft model made of the
    target's first ``draft_layers`` blocks (shared weights).  A draft
    depth the target does not have logs and falls back to n-gram; any
    other error while building the drafter propagates.

    ``quantize`` swaps every eligible matmul weight for int8 with
    per-channel scales (``serving/quant.py``), from the full-precision
    values the weight is loaded from (a float32 ``state`` or checkpoint's
    included); ``weight_bytes`` reports the result.  ``kv_quant`` stores
    KV pages in int8.  ``role`` is ``"colocated"``, ``"prefill"`` (admit,
    prefill and forward each handoff to a decode peer through
    ``handoff_post``, the transport seam, default
    ``disagg.http_post_json``) or ``"decode"`` (seed slots from
    ``:resume`` handoffs).  ``directory`` (with ``engine_id``,
    ``engine_addr``) joins the cluster prefix directory: cached prefixes
    are advertised and a local miss fetches a peer's pages through its
    ``:pages`` verb.  ``tenant_shares`` ({tenant: weight}) turns on
    weighted-fair admission between tenants."""

    def __init__(self, model_name: str = "llama", size: str = "tiny",
                 model_config: dict | None = None,
                 state: dict[str, torch.Tensor] | None = None,
                 checkpoint_dir: str | None = None,
                 max_batch: int = 4, max_seq: int = 512, seed: int = 0,
                 prefill_chunk: int = 512, max_queue: int = 0,
                 prefix_cache_mb: float = 0.0, kv_page_size: int = 16,
                 host_kv_pages: int = 0, speculative_tokens: int = 0,
                 draft_layers: int = 0, quantize: bool = False,
                 kv_quant: bool = False, role: str = "colocated",
                 handoff_post=None, directory=None,
                 engine_id: str | None = None, engine_addr: str = "",
                 tenant_shares: dict | None = None, staging_mb: float = 64.0,
                 device: str | torch.device | None = None):
        from kubeflow_tpu_torch.models import registry

        if state is not None and checkpoint_dir:
            raise ValueError("pass state or checkpoint_dir, not both")
        self.name = model_name
        self.role = role
        self._handoff_post = handoff_post
        self.log = get_logger("predictor", model=model_name, size=size)
        self.device = resolve(device)
        entry = registry.get(model_name)
        if not entry.generative:
            raise ValueError(f"{model_name} is not a generative model")
        # the structure without storage; the loader fills it
        self.module = entry.make_model(size=size, device="meta",
                                       param_dtype="compute",
                                       **(model_config or {}))
        self.module.eval()
        self.cfg = self.module.config
        self.max_seq = min(max_seq, self.cfg.max_seq_len)
        self._shapes = {n: (tuple(t.shape), t.dtype) for n, t in
                        self.module.named_parameters()}
        self._seed = seed
        self._state = state
        self._quantize = quantize
        self._checkpoint_dir = checkpoint_dir
        self._staging_bytes = int(max(1.0, staging_mb) * (1 << 20))
        self._staging = None    # the pinned window, made at first restore
        self._parked_bytes = 0
        self.last_restore: dict | None = None
        self._load_params()
        self._parked = False
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
                                        tenant_shares=tenant_shares,
                                        **engine_kw)
        self.log.info("predictor ready", device=str(self.device),
                      params=sum(p.numel() for p in self.module.parameters()))

    # -- the one weight loader -------------------------------------------------
    @torch.no_grad()
    def _load_params(self) -> None:
        """Fill the storage-less module: a streamed restore when a
        checkpoint is set, else ``state``'s values, else the seeded init,
        each weight int8-quantized as it lands when ``quantize`` asks.
        Cold construction and every re-warm land here, so a re-warmed
        model is the same model."""
        if self._checkpoint_dir:
            self._restore()
        elif self._state is not None:
            missing = sorted(set(self._shapes) - set(self._state))
            extra = sorted(set(self._state) - set(self._shapes))
            if missing or extra:
                raise ValueError(f"state does not match the model: missing "
                                 f"{missing[:4]}, unexpected {extra[:4]}")
            for name in self._shapes:
                full = self._state[name].to(self.device)
                self._install(name, full.to(self._shapes[name][1]), full)
        else:
            # flax's initializers from one generator in module order, as
            # ``init_weights(seed)``; each submodule made just before it
            gen = torch.Generator(device=self.device).manual_seed(
                self._seed)
            for prefix, m in self.module.named_modules():
                if m is self.module or not hasattr(m, "init_weights"):
                    continue
                m.to_empty(device=self.device, recurse=False)
                m.init_weights(gen)
                if self._quantize:
                    for leaf in list(m._parameters):
                        quantize_param(self.module, f"{prefix}.{leaf}")
        left = [n for n, t in (*self.module.named_parameters(),
                               *self.module.named_buffers())
                if t.is_meta]
        if left:
            raise RuntimeError(f"loader left {left[:4]} without storage")

    def _install(self, name: str, tensor: torch.Tensor,
                 full: torch.Tensor | None = None) -> None:
        """Make ``tensor`` the parameter ``name``; int8-quantize it from
        ``full`` (its own values when None) when asked."""
        prefix, _, leaf = name.rpartition(".")
        owner = self.module.get_submodule(prefix)
        owner._parameters[leaf] = nn.Parameter(tensor, requires_grad=False)
        if self._quantize:
            quantize_param(self.module, name, full)

    def _restore(self) -> None:
        """Stream ``checkpoint_dir`` in by key through the staging window
        (pinned once per predictor); eligible weights of a float32
        checkpoint land in float32 and are quantized from those values
        when ``quantize`` asks."""
        like = {n: torch.empty(shape, dtype=dt, device="meta")
                for n, (shape, dt) in self._shapes.items()}
        full = frozenset(n for n, t in like.items()
                         if self._quantize and wants_quant(n, t, 1 << 12))
        if self._staging is None:
            self._staging = mp.StagingRing(self._staging_bytes, self.device)
        _, report = mp.stream_restore(
            self._checkpoint_dir, like, device=self.device,
            ring=self._staging, sink=self._install, full_precision=full)
        self.last_restore = report
        self.log.info("restored checkpoint (streamed)",
                      directory=self._checkpoint_dir,
                      tensors=report["tensors"],
                      max_staged_bytes=report["max_staged_bytes"],
                      seconds=round(report["seconds"], 3))

    # -- weight residency (serving/model_pool.py) ------------------------------
    @property
    def weight_bytes(self) -> int:
        """Device bytes of the weights (int8 ones at one byte, their
        scales at four): the reference's ``quantized_bytes``, and the
        residency pool's unit; the last resident size while parked."""
        if self._parked:
            return self._parked_bytes
        return quantized_bytes(self.module)

    @property
    def parked(self) -> bool:
        return self._parked

    @torch.no_grad()
    def park(self) -> int:
        """Drop the weights and keep everything else: the engine, its page
        pool and prefix cache, the drafter (whose blocks are this module's
        own, so they park with it).  Every parameter, an int8 weight's
        ``QTensor`` included, becomes a storage-less placeholder of its
        full-precision shape, so no reference to a weight survives; a
        parked predictor serves nothing until :meth:`warm`.  Returns the
        bytes freed."""
        if self._parked:
            return 0
        freed = self.weight_bytes
        for name, (shape, dt) in self._shapes.items():
            prefix, _, leaf = name.rpartition(".")
            owner = self.module.get_submodule(prefix)
            owner._modules.pop(leaf, None)          # an int8 QTensor
            owner._parameters[leaf] = nn.Parameter(
                torch.empty(shape, dtype=dt, device="meta"),
                requires_grad=False)
        self._parked_bytes = freed
        self._parked = True
        self.log.info("parked: weights evicted", bytes_freed=freed)
        return freed

    def warm(self) -> int:
        """Reload a parked predictor through the loader cold construction
        used; idempotent (a resident one returns its bytes).  Nothing is
        rebuilt but the weights: the kernels stay built and loaded.
        Returns resident bytes."""
        if not self._parked:
            return self.weight_bytes
        self._load_params()
        self._parked = False
        nbytes = self.weight_bytes
        self.log.info("warmed: weights resident", bytes=nbytes)
        return nbytes

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

    def resume(self, body: dict, trace_ctx=None) -> dict:
        """``:resume`` (decode role): seed a slot from a serialized
        handoff and decode to completion."""
        from kubeflow_tpu_torch.serving import disagg

        t0 = time.perf_counter()
        timing: dict = {}
        out = disagg.resume_serialized(self.engine, body, timing,
                                       trace_ctx=trace_ctx)
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
                          eos_id, top_k, top_p, deadline_s, decode_peer,
                          trace_ctx=None, tenant=None) -> list[list[int]]:
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
                    top_k=top_k, top_p=top_p, deadline_s=deadline_s,
                    trace_ctx=trace_ctx, tenant=tenant))
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
                 decode_peer: str | None = None, trace_ctx=None,
                 tenant: str | None = None) -> dict:
        """Generate continuations for a (possibly ragged) batch of prompts
        through the continuous-batching engine; a prefill-role predictor
        hands each off to ``decode_peer`` (``host:port``).  ``trace_ctx``
        parents the engine's spans; ``tenant`` is the billed tenant
        (clamped to the engine's shares)."""
        if self._parked:
            raise RuntimeError(f"model {self.name!r} is parked (warm() it, "
                               "or serve it through a ModelPool)")
        t0 = time.perf_counter()
        if self.role == "prefill":
            out_ids = self._generate_prefill(
                ids, max_new_tokens, temperature, seed, eos_id, top_k,
                top_p, deadline_s, decode_peer, trace_ctx, tenant)
        else:
            out_ids = self.engine.generate_sync(
                ids, max_new_tokens=max_new_tokens, temperature=temperature,
                eos_id=eos_id, seed=seed, top_k=top_k, top_p=top_p,
                deadline_s=deadline_s, trace_ctx=trace_ctx, tenant=tenant)
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


class ClassifierPredictor:
    """The generic ``:predict`` path for the non-generative registry
    models (``mnist_mlp``, ``cifar_convnet``, ``resnet50``, ``bert``):
    the module in eval mode on ``{"instances": [...]}``, answering
    ``{"predictions": argmax, "logits": ...}`` as the reference does.
    Weights from a seeded init, or a streamed checkpoint restored over
    it (``checkpoint_dir``).  As in the reference, the forward gets the
    parameters alone: a model with running BatchNorm averages (ResNet's
    ``batch_stats``) cannot predict, and says so."""

    def __init__(self, model_name: str, model_config: dict | None = None,
                 checkpoint_dir: str | None = None, seed: int = 0,
                 staging_mb: float = 64.0,
                 device: str | torch.device | None = None):
        from kubeflow_tpu_torch.models import registry

        entry = registry.get(model_name)
        if entry.generative:
            raise ValueError(f"{model_name} is generative: serve it with "
                             "GenerativePredictor")
        self.name = model_name
        self.device = resolve(device)
        with torch.no_grad():
            self.module = entry.make_model(device=self.device,
                                           **(model_config or {}))
            self.module.init_weights(seed)
            if checkpoint_dir:
                params = dict(self.module.named_parameters())
                _, self.last_restore = mp.stream_restore(
                    checkpoint_dir, params, device=self.device,
                    staging_bytes=int(max(1.0, staging_mb) * (1 << 20)),
                    sink=lambda name, t: params[name].copy_(t))
        self.module.eval()

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The logits of a batch (float32 images or int64 token ids)."""
        stats = next((n for n, _ in self.module.named_buffers()), None)
        if stats is not None:
            # the reference applies {"params": p} alone, and flax refuses
            # a BatchNorm's running averages from an absent collection
            path, _, leaf = stats.rpartition(".")
            raise RuntimeError(
                f'Tried to access "{leaf}" from collection "batch_stats" '
                f'in "/{path.replace(".", "/")}" but the collection is '
                "empty: :predict applies the parameters alone")
        out = self.module(x.to(self.device))
        if isinstance(out, dict):
            out = out["logits"]
        return out.float()

    def predict(self, instances: list) -> dict:
        x = np.asarray(instances)
        if x.dtype.kind == "f":
            t = torch.from_numpy(x.astype(np.float32))
        elif x.dtype.kind in "iub":
            t = torch.from_numpy(x.astype(np.int64))
        else:
            raise ValueError("instances must be a nested list of numbers")
        logits = self.forward(t)
        return {"predictions": logits.argmax(-1).tolist(),
                "logits": logits.tolist()}


class PredictorApp:
    """WSGI app exposing one or more predictors.  With a ``model_pool``,
    each verb of a registered model runs under a residency pin (a parked
    model warms on the first caller's thread; concurrent cold callers
    coalesce behind that one load).  Every request opens a
    ``predictor.request`` span that continues the caller's
    ``traceparent``; the engine's spans parent to it."""

    def __init__(self, predictors: dict[str, Any], model_pool=None):
        self.predictors = predictors
        self.model_pool = model_pool
        self.log = get_logger("predictor.http")

    def __call__(self, environ, start_response):
        path = environ.get("PATH_INFO", "/")
        method = environ["REQUEST_METHOD"]
        headers: list[tuple[str, str]] = []
        span = trace.start_server_span("predictor.request", environ,
                                       path=path)
        # unsampled too, the engine gets an explicit context: None would
        # make it roll its own sampling decision
        ctx = span.context if span else trace.propagation_context(
            span, environ)
        try:
            try:
                out = self._route(method, path, environ, ctx)
                status, body = out[0], out[1]
                if len(out) > 2:
                    headers = list(out[2])
            except KeyError as e:
                status, body = "404 Not Found", {"error": f"no route {e}"}
            except QueueFull as e:
                status, body = "429 Too Many Requests", {"error": str(e)}
                headers = [("Retry-After",
                            f"{max(1, round(e.retry_after))}")]
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
            span.set_attribute("status", int(status.split()[0]))
        finally:
            span.end()
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
        return any(getattr(p, "draining", False)
                   for p in self.predictors.values())

    def drain(self) -> None:
        for pred in self.predictors.values():
            if hasattr(pred, "drain"):
                pred.drain()

    def drained(self, timeout: float = 60.0) -> bool:
        deadline = time.monotonic() + timeout
        ok = True
        for pred in self.predictors.values():
            engine = getattr(pred, "engine", None)
            if engine is not None:
                ok &= engine.drained(max(0.0, deadline - time.monotonic()))
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

    def _route(self, method, path, environ, trace_ctx=None):
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
                meta = {"name": rest,
                        "ready": not getattr(pred, "draining", False)}
                if self.model_pool is not None \
                        and self.model_pool.has(rest):
                    # residency metadata never warms a parked model
                    meta["residency"] = self.model_pool.state_of(rest)
                engine = getattr(pred, "engine", None)
                if engine is not None:
                    meta["stats"] = engine.stats()
                return "200 OK", meta
            name, verb = rest.split(":", 1)
            pred = self.predictors[name]
            if self.model_pool is not None and self.model_pool.has(name):
                return self._leased(name, verb, pred, method, environ,
                                    trace_ctx)
            return self._dispatch(name, verb, pred, method, environ,
                                  trace_ctx)
        raise KeyError(path)

    def _leased(self, name, verb, pred, method, environ, trace_ctx):
        """A verb under a residency pin: acquire warms a parked model
        (or coalesces behind the load in flight) and pins it for the
        request; release stamps LRU recency.  A draining entry's
        ``ModelDraining`` reaches the generic 500."""
        self.model_pool.acquire(name)
        try:
            t0 = time.perf_counter()
            out = self._dispatch(name, verb, pred, method, environ,
                                 trace_ctx)
            mp.MODEL_REQUEST_SECONDS.labels(name).observe(
                time.perf_counter() - t0)
            return out
        finally:
            self.model_pool.release(name)

    def _dispatch(self, name, verb, pred, method, environ, trace_ctx):
        if verb == "generate" and method == "POST":
            body = self._body(environ, "ids")
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
                deadline_s=self._deadline_s(environ, body),
                trace_ctx=trace_ctx,
                # the gateway-resolved tenant; the engine clamps it to its
                # shares
                tenant=environ.get("HTTP_KUBEFLOW_USERID"), **kw)
        if verb == "resume" and method == "POST":
            # a pool that cannot host the pages sheds (QueueFull: 429)
            return "200 OK", pred.resume(self._body(environ, "ids"),
                                         trace_ctx=trace_ctx)
        if verb == "pages" and method == "POST":
            return "200 OK", pred.export_pages(
                self._body(environ, "ids").get("ids") or [])
        if verb == "predict" and method == "POST":
            return "200 OK", pred.predict(
                self._body(environ, "instances")["instances"])
        raise KeyError(f"/v1/models/{name}:{verb}")

    @staticmethod
    def _body(environ, key: str) -> dict:
        length = int(environ.get("CONTENT_LENGTH") or 0)
        body = json.loads(environ["wsgi.input"].read(length) or b"{}")
        if not isinstance(body, dict) or key not in body:
            raise ValueError(f"body must be a JSON object with {key!r}")
        return body


def wire_model_pool(predictors: dict[str, Any],
                    budget_bytes: int) -> "mp.ModelPool":
    """Put every generative predictor under one weight-residency pool, as
    the reference's CLI wires it: the loader is ``warm()`` (idempotent, so
    a resident predictor's first acquire only accounts its bytes), the
    evictor ``park()``, and each engine's page pressure may evict an
    idle sibling's weights into its page pool.  Classifiers stay outside
    the budget.  The pool becomes the process's (``get_model_pool``)."""
    pool = mp.set_model_pool(mp.ModelPool(int(budget_bytes)))
    for name, pred in predictors.items():
        engine = getattr(pred, "engine", None)
        if engine is None:
            continue
        pool.register(name, (lambda p=pred: (p, p.warm())),
                      evictor=pred.park, nbytes_hint=pred.weight_bytes)
        engine.pressure_fn = (lambda pages=engine.pool, mpool=pool:
                              mpool.relieve(pages))
    return pool


# per-model options (``--model name:k=v``) this port does not serve (the
# multi-device slice), with the value that means "off"
_UNSUPPORTED_OPTS = {"tp": "1", "ep": "1"}
# per-model options that configure the model itself (the MoE variant)
_MODEL_CONFIG_OPTS = ("moe_experts", "moe_every")


def _checkpoint(directory: str | None, what: str) -> str | None:
    """A checkpoint directory that holds a streamable manifest (or None);
    SystemExit naming ``what`` otherwise."""
    if directory:
        try:
            mp.read_manifest(directory)
        except ValueError as e:
            raise SystemExit(f"{what} {directory}: {e}") from None
    return directory or None


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
             "role", "checkpoint_dir", "staging_mb", "parked",
             *_MODEL_CONFIG_OPTS, *_UNSUPPORTED_OPTS}
    unknown = sorted(set(opts) - known)
    if unknown:
        raise SystemExit(f"unknown --model options {unknown}")
    staging_mb = float(opts.get("staging_mb", args.staging_mb))
    if staging_mb <= 0:
        raise SystemExit(f"--model option staging_mb={staging_mb:g} must be "
                         "> 0")
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
          "checkpoint_dir": _checkpoint(
              opts.get("checkpoint_dir", args.checkpoint_dir),
              "--model option checkpoint_dir=" if "checkpoint_dir" in opts
              else "--checkpoint-dir"),
          "staging_mb": staging_mb,
          "parked": opts.get("parked", "").lower() in ("1", "true"),
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

    from kubeflow_tpu_torch.models import registry
    from kubeflow_tpu_torch.serving.httpserve import serve

    parser = argparse.ArgumentParser(
        "kubeflow_tpu_torch.serving",
        description="Serve registry models from one process on one CUDA "
                    "card: --model 'llama:size=7b'.  --model is repeatable "
                    "and takes per-model options after a colon; the bare "
                    "flags are their defaults.")
    parser.add_argument("--model", action="append", dest="models",
                        default=None)
    parser.add_argument("--size", default="tiny")
    parser.add_argument("--checkpoint-dir",
                        help="a streamed checkpoint (weights_manifest.json "
                             "and one .npy per tensor) to serve instead of "
                             "seeded random weights")
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
    parser.add_argument("--weight-budget-mb", type=float, default=0.0,
                        help="device budget (MB) shared by every generative "
                             "model's weights: idle models park, cold "
                             "requests coalesce behind one load; 0 = off")
    parser.add_argument("--staging-mb", type=float, default=64.0,
                        help="host staging window (MB) of a streamed "
                             "checkpoint restore")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' to run the "
                             "plain path on the host)")
    args = parser.parse_args(argv)
    if args.staging_mb <= 0:
        parser.error("--staging-mb must be > 0")
    if args.weight_budget_mb < 0:
        parser.error("--weight-budget-mb must be >= 0 (0 turns the "
                     "residency pool off)")
    try:
        _checkpoint(args.checkpoint_dir, "--checkpoint-dir")
    except SystemExit as e:
        parser.error(str(e))

    predictors = {}
    for spec in [m for m in (args.models or []) if m] or ["llama"]:
        name, kw = _parse_model_spec(spec, args)
        if not registry.get(name).generative:
            predictors[name] = ClassifierPredictor(
                name, checkpoint_dir=kw["checkpoint_dir"],
                staging_mb=kw["staging_mb"], device=args.device)
            continue
        parked = kw.pop("parked")
        predictors[name] = GenerativePredictor(name, device=args.device,
                                               **kw)
        if parked:
            # start parked: the engine is built, the weights wait for the
            # first request
            predictors[name].park()
    model_pool = None
    if args.weight_budget_mb > 0:
        model_pool = wire_model_pool(predictors,
                                     int(args.weight_budget_mb * (1 << 20)))
    port = int(os.environ.get("KF_POD_PORT", args.port))
    app = PredictorApp(predictors, model_pool=model_pool)
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
