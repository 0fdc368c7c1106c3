"""Disaggregated prefill/decode serving: split engine roles and the KV
handoff.

Counterpart of ``kubeflow_tpu/serving/disagg.py`` (DistServe, Zhong et
al. OSDI'24; Splitwise, Patel et al. ISCA'24).  PREFILL engines admit
prompts through the prefix-cache / chunked-prefill path and publish the
finished prompt KV as refcounted pool pages; DECODE engines seed a slot
from those pages (the seed a prefix hit uses) and own the decode loop.
A burst of long prompts then stops stalling the decode of requests in
flight, and the two pools scale on their own signals.

The HANDOFF is a plain data object (:class:`HandoffState`): page ids in
the shared pool plus the sampling state a decode engine needs to resume
the stream.  It rides the request across the pool boundary and owns one
pool reference per page from commit until the decode seed (or the
request's death) releases it.

Deployment shapes, as in the reference:

- SAME PROCESS: a :class:`DisaggCoordinator` runs both pools over one
  shared :class:`~kubeflow_tpu_torch.serving.page_pool.PagePool` with
  device storage; the handoff is an incref and a queue append.
- SEPARATE PROCESSES: a ``--role prefill`` predictor forwards the
  serialized handoff (``serialize_handoff``) to the ``:resume`` verb of
  the ``--role decode`` peer named by ``X-KF-Decode-Peer`` and relays the
  stream; with no reachable peer it resumes the handoff on its own engine
  (the colocated fallback).

What differs from the reference, and why:

- **Sampling state.** The reference carries its JAX key chain; the port's
  streams draw from a per-request ``torch.Generator``.  In process the
  handoff carries the request with its live generator.  Across processes
  the body carries ``gen_state``, the generator's state as base64: the one
  field the port adds to the reference's body.  The decode side restores
  it into a generator on its own device, so a seeded stream handed across
  equals the colocated one.  ``key_chain`` stays, with the reference's
  two-word validation, so a port body has the reference's shape; the port
  writes the seed's two 32-bit words there and reads them nowhere.  A body
  without ``gen_state`` resumes a greedy request; a sampled one is
  refused (422).
- **Wire dtypes.** Arrays carry the reference's numpy dtype tags
  (``"bfloat16"``, ``"int8"``, ``"float32"``).  bf16 travels as its
  2-byte pattern (an int16 view) and decodes by viewing the bytes back as
  ``torch.bfloat16``: no ``ml_dtypes``.  Pages encoded here parse in the
  reference and the other way round.
- **Transport.** A plain ``http.client`` POST (``http_post_json``), with a
  ``post_fn`` seam for tests.  The reference's ``core.net`` connection
  seam serves its chaos fault injection (control-plane code) and is not
  ported.
- **Streams.** The pool's copies are ordered by the caller's current CUDA
  stream.  The coordinator's engines issue on their threads' default
  stream, the same one, so a page released after a decode seed cannot be
  rewritten by the next prefill commit before the seed's gather ran.
  Overlapping prefill and decode on separate streams needs an event in
  the ``HandoffState`` (ROADMAP).
- No tracing spans (the reference's ``engine.prefill_handoff`` span waits
  for the tracing slice).
"""

from __future__ import annotations

import base64
import time
from dataclasses import dataclass

import numpy as np
import torch

from kubeflow_tpu_torch.serving.page_pool import PagePool, pages_for
from kubeflow_tpu_torch.utils.logging import get_logger
from kubeflow_tpu_torch.utils.metrics import REGISTRY

log = get_logger("serving.disagg")

FAILOVERS = REGISTRY.counter(
    "serving_decode_failovers_total",
    "handoff requests re-run cold after a decode worker died mid-stream")


@dataclass
class HandoffState:
    """Everything a decode engine needs to resume a prefilled request.
    Owns ONE pool reference per page id from commit until released."""

    ids: list[int]
    generated: list[int]            # [first_token] at handoff time
    max_new_tokens: int
    temperature: float
    eos_id: int | None
    seed: int
    top_k: int
    top_p: float
    pages: list[int]                # pool page ids covering the prompt
    key_chain: list[int]            # the reference's field: the seed's words
    deadline: float | None = None   # absolute perf_counter deadline
    committed_at: float | None = None
    request: object = None          # in process: the live GenRequest
    released: bool = False          # page references dropped
    gen_state: torch.Tensor | None = None   # across processes


def seed_words(seed: int) -> list[int]:
    """A seed's two 32-bit words (high, low), the ``key_chain`` field."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return [seed >> 32, seed & 0xFFFFFFFF]


def release_handoff(pool: PagePool, state: HandoffState) -> None:
    """Drop the handoff's page references exactly once."""
    if state is not None and not state.released:
        state.released = True
        pool.decref(list(state.pages))


# -- cross-process wire format ------------------------------------------------

def _encode_array(t: torch.Tensor) -> dict:
    host = t.detach().contiguous().cpu()
    if host.dtype == torch.bfloat16:
        tag, raw = "bfloat16", host.view(torch.int16).numpy()
    else:
        raw = host.numpy()
        tag = str(raw.dtype)
    return {"dtype": tag, "shape": list(host.shape),
            "data": base64.b64encode(raw.tobytes()).decode()}


def encode_page(tree: dict) -> list[dict]:
    """One pool page to the JSON-safe wire form: a list of per-layer dicts
    of dtype-tagged base64 arrays (int8 pages with their scales ride the
    same shape).  Shared by the handoff (``:resume``) and the prefix
    export (``:pages``)."""
    return [{name: _encode_array(t) for name, t in layer.items()}
            for layer in tree["layers"]]


def serialize_handoff(state: HandoffState, pool: PagePool) -> dict:
    """JSON-safe handoff: the sampling state and the page payloads.  The
    absolute deadline becomes REMAINING seconds; the generator's state
    comes from the live request when there is one."""
    pages = [encode_page(pool.get(pid)) for pid in state.pages]
    remaining = None
    if state.deadline is not None:
        remaining = max(0.1, state.deadline - time.perf_counter())
    gen = getattr(state.request, "_gen", None)
    gen_state = gen.get_state() if gen is not None else state.gen_state
    return {
        "ids": state.ids, "generated": state.generated,
        "max_new_tokens": state.max_new_tokens,
        "temperature": state.temperature, "eos_id": state.eos_id,
        "seed": state.seed, "top_k": state.top_k, "top_p": state.top_p,
        "key_chain": state.key_chain, "deadline_remaining_s": remaining,
        "gen_state": (None if gen_state is None else
                      base64.b64encode(gen_state.numpy().tobytes()).decode()),
        "pages": pages,
    }


def _decode_array(enc: dict) -> torch.Tensor:
    tag = enc["dtype"]
    raw = base64.b64decode(enc["data"], validate=True)
    host = np.frombuffer(raw, dtype=np.int16 if tag == "bfloat16"
                         else np.dtype(tag))
    t = torch.from_numpy(host.copy()).reshape([int(d) for d in enc["shape"]])
    return t.view(torch.bfloat16) if tag == "bfloat16" else t


def _validate_resume(body: dict, engine) -> tuple[list, dict]:
    """Check a ``:resume`` body against the decode engine's model BEFORE
    any pool allocation: a malformed handoff answers 422 at the HTTP
    layer, never raises inside the batcher thread, and never leaks pages
    allocated before a late field error.  Returns the parsed page trees
    and every scalar field of the ``HandoffState``."""
    ids = body.get("ids")
    generated = body.get("generated")
    if not ids or not isinstance(ids, list):
        raise ValueError("resume body needs a non-empty 'ids' prompt")
    if not isinstance(generated, list) or len(generated) != 1:
        # handoff pages cover PROMPT positions only: extra tokens would
        # make decode attend to KV nobody wrote
        raise ValueError("resume body needs 'generated' = exactly the "
                         "one prefill-sampled first token")
    key_chain = body.get("key_chain")
    if not isinstance(key_chain, list) or len(key_chain) != 2:
        raise ValueError("key_chain must be the 2-word PRNG chain state")
    try:
        eos_raw = body.get("eos_id")
        fields = dict(
            ids=[int(t) for t in ids], generated=[int(t) for t in generated],
            max_new_tokens=int(body["max_new_tokens"]),
            temperature=float(body["temperature"]),
            eos_id=None if eos_raw is None else int(eos_raw),
            seed=int(body.get("seed", 0)),
            top_k=int(body.get("top_k", 0)),
            top_p=float(body.get("top_p", 0.0)),
            key_chain=[int(x) for x in key_chain])
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"bad resume field: {e}")
    if any(not 0 <= t < engine.cfg.vocab_size
           for t in fields["ids"] + fields["generated"]):
        raise ValueError(f"token id outside [0, {engine.cfg.vocab_size})")
    if len(ids) + fields["max_new_tokens"] > engine.max_seq:
        raise ValueError(
            f"prompt+new ({len(ids) + fields['max_new_tokens']}) > "
            f"max_seq {engine.max_seq}")
    fields["gen_state"] = None
    if body.get("gen_state") is not None:
        try:
            state = torch.frombuffer(bytearray(base64.b64decode(
                body["gen_state"], validate=True)), dtype=torch.uint8)
            torch.Generator(device=engine.device).set_state(state)
        except Exception as e:
            raise ValueError(f"bad gen_state: {e}")
        fields["gen_state"] = state
    elif fields["temperature"] > 0.0:
        raise ValueError("a sampled stream's resume needs 'gen_state'")
    pages = body.get("pages") or []
    needed = pages_for(len(ids), engine.page_size)
    if len(pages) != needed:
        raise ValueError(
            f"{needed} pages needed to cover {len(ids)} prompt tokens at "
            f"page_size {engine.page_size}, got {len(pages)}")
    return parse_page_trees(pages, engine), fields


def parse_page_trees(pages: list, engine) -> list:
    """Decode and check wire-format pages against ``engine``'s model and
    page store (keys, shapes and dtypes); raises ValueError on anything
    that does not match, before a single pool page is allocated.  Trees
    of host tensors."""
    cfg = engine.cfg
    want_keys = ({"k", "ks", "v", "vs"} if engine.kv_quant else {"k", "v"})
    kv_shape = (engine.page_size, cfg.num_kv_heads, cfg.head_dim)
    scale_shape = (1, cfg.num_kv_heads, 1)
    kv_dtype = torch.int8 if engine.kv_quant else cfg.torch_dtype
    trees = []
    for layers in pages:
        if not isinstance(layers, list) or len(layers) != cfg.num_layers:
            raise ValueError(
                f"page has {len(layers) if isinstance(layers, list) else 0}"
                f" layers, model has {cfg.num_layers}")
        tree = {"layers": []}
        for layer in layers:
            if not isinstance(layer, dict) or set(layer) != want_keys:
                raise ValueError(
                    f"page layer keys {sorted(layer)} != expected "
                    f"{sorted(want_keys)} (kv_quant={engine.kv_quant})")
            parsed = {}
            for name, enc in layer.items():
                try:
                    arr = _decode_array(enc)
                except Exception as e:
                    raise ValueError(f"bad page array {name!r}: {e}")
                scale = name in ("ks", "vs")
                want = scale_shape if scale else kv_shape
                dtype = torch.float32 if scale else kv_dtype
                if tuple(arr.shape) != want or arr.dtype != dtype:
                    raise ValueError(
                        f"page array {name!r} {tuple(arr.shape)} "
                        f"{arr.dtype} != expected {want} {dtype}")
                parsed[name] = arr
            tree["layers"].append(parsed)
        trees.append(tree)
    return trees


def put_trees(pool: PagePool, pids: list[int], trees: list) -> None:
    """Commit parsed host page trees into allocated pool pages: the pages
    stacked per layer and tensor, one copy to the device and one scatter
    each."""
    device = pool.kv["layers"][0]["k"].device
    layers = [{name: torch.stack([t["layers"][li][name] for t in trees]
                                 ).to(device)
               for name in trees[0]["layers"][li]}
              for li in range(len(trees[0]["layers"]))]
    pool.put_many(pids, layers)


def deserialize_handoff(body: dict, engine) -> HandoffState:
    """Materialize a serialized handoff into ``engine``'s page pool; the
    returned state has ``request=None`` (the decode engine mints one).
    The body is parsed and checked before pages are allocated (a
    malformed one is a ValueError, 422, with nothing leaked); a pool that
    cannot host the pages raises the engine's ``QueueFull`` (429)."""
    from kubeflow_tpu_torch.serving.engine import QueueFull

    trees, fields = _validate_resume(body, engine)
    deadline = None
    if body.get("deadline_remaining_s") is not None:
        try:
            deadline = (time.perf_counter()
                        + float(body["deadline_remaining_s"]))
        except (TypeError, ValueError):
            raise ValueError("deadline_remaining_s must be a number")
    n = len(trees)
    pids = engine.pool.alloc(n)
    while pids is None:
        if engine.prefix_cache is None or not engine.prefix_cache.evict_lru():
            raise QueueFull(
                f"decode worker kv pool cannot host {n} handoff pages",
                retry_after=1.0)
        pids = engine.pool.alloc(n)
    put_trees(engine.pool, pids, trees)
    return HandoffState(pages=pids, deadline=deadline,
                        committed_at=time.perf_counter(), **fields)


def resume_serialized(engine, body: dict, timing: dict | None = None,
                      trace_ctx=None) -> list[int]:
    """The decode-role predictor's ``:resume``: load the pages into the
    pool, seed a slot, decode to completion; the full token stream.
    ``timing`` receives ``deserialize_s``, the host time from the parsed
    body to the pages' copies issued; ``trace_ctx`` parents the resumed
    request's spans."""
    t0 = time.perf_counter()
    state = deserialize_handoff(body, engine)
    if timing is not None:
        timing["deserialize_s"] = time.perf_counter() - t0
    try:
        req = engine.submit_handoff(state, trace_ctx=trace_ctx)
    except BaseException:
        release_handoff(engine.pool, state)
        raise
    return req.result(timeout=600)


def http_post_json(addr: str, path: str, payload: dict,
                   timeout: float = 300.0) -> dict:
    """The handoff transport: POST ``payload`` as JSON to ``addr``
    (``host:port``) and parse the JSON response; a non-2xx status raises
    with the body as the message."""
    import http.client
    import json

    host, _, port = addr.partition(":")
    conn = http.client.HTTPConnection(host, int(port or 80), timeout=timeout)
    try:
        conn.request("POST", path, body=json.dumps(payload).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        raw = resp.read()
        if not 200 <= resp.status < 300:
            raise RuntimeError(
                f"decode peer {addr} answered {resp.status}: "
                f"{raw[:200].decode(errors='replace')}")
        return json.loads(raw)
    finally:
        conn.close()


def forward_handoff(state: HandoffState, pool: PagePool, peer: str,
                    model: str, post_fn=None) -> list[int]:
    """Prefill side: serialize, POST to the decode peer's ``:resume``,
    return the completed stream.  The local page references are released
    only after a parsed success, so a failed POST leaves the state
    resumable on the caller's own engine."""
    payload = serialize_handoff(state, pool)
    out = (post_fn or http_post_json)(peer, f"/v1/models/{model}:resume",
                                      payload)
    full = list(out["ids"])
    release_handoff(pool, state)
    return full


def complete_forwarded(req, full_ids: list[int]) -> None:
    """Terminal bookkeeping of a request whose decode ran on a peer."""
    from kubeflow_tpu_torch.serving.engine import REQS_TOTAL

    req.generated = list(full_ids[len(req.ids):])
    req.outcome = "ok"
    REQS_TOTAL.labels("ok").inc()
    req._done.set()


def fail_forwarded(req, msg: str) -> None:
    from kubeflow_tpu_torch.serving.engine import REQS_TOTAL

    req.error = msg
    req.outcome = "error"
    REQS_TOTAL.labels("error").inc()
    req._done.set()


class DisaggCoordinator:
    """Prefill-role and decode-role engines over one shared page pool with
    device storage (the in-process deployment shape).

    Routing: ``submit`` goes to the least-loaded prefill engine; the
    handoff goes to the decode engine with the most free slots (a healthy
    one with none still wins over the colocated fallback); with every
    decode engine draining or closed, the prefill engine resumes the
    handoff itself.  A decode engine that dies offers its requests back
    (``_failover``): each is re-run cold, once, on a prefill engine."""

    def __init__(self, model, cfg, *, prefill_workers: int = 1,
                 decode_workers: int = 1, max_batch: int = 4,
                 max_seq: int = 512, prefill_chunk: int = 512,
                 prefix_cache_bytes: int = 0, max_queue: int = 0,
                 page_size: int = 16, kv_pages: int = 0,
                 speculative_tokens: int = 0, kv_quant: bool = False,
                 draft_fn=None):
        from kubeflow_tpu_torch.models.llama import (init_kv_pool,
                                                     kv_page_nbytes)
        from kubeflow_tpu_torch.serving.engine import ContinuousBatcher
        from kubeflow_tpu_torch.serving.prefix_cache import PrefixCache
        from kubeflow_tpu_torch.serving.quant import kv_page_nbytes_int8

        max_seq = min(max_seq, cfg.max_seq_len)
        if max_seq % page_size:
            raise ValueError(
                f"disaggregation needs page_size ({page_size}) to divide "
                f"max_seq ({max_seq})")
        page_nbytes = (kv_page_nbytes_int8(cfg, page_size) if kv_quant
                       else kv_page_nbytes(cfg, page_size))
        cache_pages = 0
        if prefix_cache_bytes > 0:
            cache_pages = max(1, prefix_cache_bytes // page_nbytes)
        pages_per_seq = pages_for(max_seq, page_size)
        if kv_pages <= 0:
            # every slot's prompt pages in BOTH pools, plus one more decode
            # share for handoffs queued between commit and seed
            kv_pages = (1 + cache_pages
                        + (prefill_workers + 2 * decode_workers)
                        * max_batch * pages_per_seq)
        self.pool = PagePool(kv_pages, page_size, page_nbytes,
                             kv=init_kv_pool(cfg, kv_pages, page_size,
                                             device=model.device,
                                             quantized=kv_quant))
        self.prefix_cache = (PrefixCache(self.pool, cache_pages)
                             if cache_pages else None)
        common = dict(max_batch=max_batch, max_seq=max_seq,
                      prefill_chunk=prefill_chunk, page_size=page_size,
                      pool=self.pool, kv_quant=kv_quant)
        self.prefill = [
            ContinuousBatcher(model, cfg, role="prefill",
                              handoff_fn=self._handoff,
                              prefix_cache=self.prefix_cache,
                              max_queue=max_queue, **common)
            for _ in range(prefill_workers)]
        self.decode = [
            ContinuousBatcher(model, cfg, role="decode",
                              failover_fn=self._failover,
                              speculative_tokens=speculative_tokens,
                              draft_fn=draft_fn, **common)
            for _ in range(decode_workers)]

    # -- routing ---------------------------------------------------------------
    def _least_loaded_prefill(self):
        def load(eng):
            with eng._work:
                return len(eng.queue) + eng._prefilling
        return min(self.prefill, key=load)

    def _pick_decode(self):
        """Most free decode slots wins (queued handoffs count against a
        worker, so a burst spreads); closed or draining workers are out."""
        best, best_free = None, None
        for eng in self.decode:
            with eng._work:
                if eng._closed or eng._draining:
                    continue
                free = (sum(1 for s in eng.slots if s is None)
                        - len(eng.queue))
            if best is None or free > best_free:
                best, best_free = eng, free
        return best

    def submit(self, ids: list[int], **kw):
        """Admit a prompt into the prefill pool; the request completes when
        the decode pool finishes its stream."""
        return self._least_loaded_prefill().submit(ids, **kw)

    def generate_sync(self, batch, max_new_tokens: int = 32,
                      temperature: float = 0.0, eos_id=None, seed=None,
                      top_k: int = 0, top_p: float = 0.0,
                      deadline_s=None) -> list[list[int]]:
        reqs = []
        try:
            for i, ids in enumerate(batch):
                reqs.append(self.submit(
                    ids, max_new_tokens=max_new_tokens,
                    temperature=temperature, eos_id=eos_id,
                    seed=None if seed is None else seed + i,
                    top_k=top_k, top_p=top_p, deadline_s=deadline_s))
            return [r.result(timeout=600) for r in reqs]
        except BaseException:
            for r in reqs:
                r.cancel()
            raise

    # -- the handoff hop -------------------------------------------------------
    def _handoff(self, req, state: HandoffState) -> None:
        target = self._pick_decode()
        if target is None:
            # every decode worker draining or closed: resume on the
            # prefill engine itself (availability over purity)
            req._engine.submit_handoff(state)
            return
        target.submit_handoff(state)

    def _failover(self, req) -> bool:
        """A decode engine died with ``req`` mid-stream: re-run it COLD on
        a prefill engine (same seed: the same stream), once.  False tells
        the dying engine to fail the request."""
        if req._cancel_requested or req.expired():
            return False
        req._failovers += 1
        if req._failovers > 1:
            return False
        if req._handoff is not None:
            release_handoff(self.pool, req._handoff)
            req._handoff = None
        req.generated = []
        for eng in self.prefill:
            if eng.adopt(req):
                FAILOVERS.inc()
                log.warning("decode worker died; re-running cold",
                            prompt_tokens=len(req.ids))
                return True
        return False

    # -- lifecycle / introspection ---------------------------------------------
    def _engines(self):
        return list(self.prefill) + list(self.decode)

    def drain(self) -> None:
        for eng in self._engines():
            eng.drain()

    def drained(self, timeout: float = 60.0) -> bool:
        deadline = time.monotonic() + timeout
        ok = True
        for eng in self._engines():
            ok &= eng.drained(max(0.0, deadline - time.monotonic()))
        return ok

    def shutdown(self) -> None:
        # prefill first: no new handoffs while the decode pool finishes
        for eng in self._engines():
            eng.shutdown()

    def restart(self) -> None:
        for eng in self._engines():
            eng.restart()

    def stats(self) -> dict:
        pool = self.pool.stats()
        cache_pages = (self.prefix_cache.stats()["pages"]
                       if self.prefix_cache is not None else 0)
        pool["orphan_pages"] = pool["in_use"] - cache_pages
        out = {"kv_pool": pool,
               "prefill": [e.stats() for e in self.prefill],
               "decode": [e.stats() for e in self.decode]}
        if self.prefix_cache is not None:
            out["prefix_cache"] = self.prefix_cache.stats()
        return out
