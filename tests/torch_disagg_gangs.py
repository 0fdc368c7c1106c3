"""Disaggregated prefill and decode on a tp / ep serving gang: the shared
parts of ``test_torch_disagg_gang.py``.

One gang of 2 on the CPU over gloo serves five models, each on a group
of its own: ``C`` (the tiny float32 Llama, colocated, tp=2), ``D`` (the
same weights, ``role="decode"``, tp=2), ``M`` (the tiny MoE,
``role="decode"``, ep=2), ``P`` (the Llama, ``role="prefill"``, tp=2,
whose ``handoff_post`` seam carries each serialized body from rank 0's
prefill forwarder to rank 0's ``D.resume``, as the HTTP POST would) and
``X`` (as ``D``), whose gang is broken last: rank 0's page broadcast
raises, as gloo does when a follower died, while two ``:resume``
requests ride one step record.  Rank 0 drives the traffic; rank 1
follows every model.  Each rank logs, per model and in the order its
engine applied them, every finished request and every handoff command
with its page pool's statistics and the page ids in use.

The reference side (the JAX package, one process over XLA host devices)
gives the streams: its tp=2 colocated predictor, its tp=2 prefill and
decode pair, its one-process MoE, and the serialized bodies of its
one-process prefill predictors, which the gang's decode models resume.
"""

import json

import pytest
import torch

from kubeflow_tpu_torch.parallel import distributed as pd
from torch_predictor_gangs import CFG, MAX_SEQ, MOE, state_of

# the reference disaggregation test's ragged pair, and a longer prompt
# whose KV spans three pages
RAGGED = [[5, 8, 13], [2, 7, 9, 11]]
LONG = [3 + (7 * i) % 200 for i in range(40)]
NEW = 8
SEEDED = {"max_new_tokens": 12, "temperature": 1.1, "seed": 5, "top_k": 20}
PAGE_SIZE = 16
HEARTBEAT_S = 0.2

WORKER = r"""
import copy, io, json, os, threading, time
import torch
from kubeflow_tpu_torch.parallel import distributed as pd
from kubeflow_tpu_torch.serving import engine as eng
from kubeflow_tpu_torch.serving import lockstep
from kubeflow_tpu_torch.serving import predictor as tpred
from kubeflow_tpu_torch.serving.page_pool import NULL_PAGE

torch.set_num_threads(1)
spec = json.loads(os.environ["GANG_SPEC"])
pd.initialize_from_env(device="cpu")
rank = pd.rank_of(pd.default_group())
eng.HEARTBEAT_S = spec["heartbeat"]
events, _lock = {}, threading.Lock()


def pool_state(e):
    s = e.pool.stats()
    s.pop("fault_wait_seconds")
    used = [p for p, r in enumerate(e.pool._refs) if r > 0 and p != NULL_PAGE]
    return s, used


def observe(name, pred):
    e = pred.engine
    log = events.setdefault(name, [])
    finish, command = e._finish_if_done, e._apply_command

    def finished(slot):
        req = e.slots[slot]
        finish(slot)
        if req is not None and e.slots[slot] is None:
            with _lock:
                log.append(["done", req._seq, req.ids + req.generated,
                            *pool_state(e)])

    def applied(kind, arg):
        out = command(kind, arg)
        with _lock:
            log.append([kind, arg, None, *pool_state(e)])
        return out

    e._finish_if_done = finished
    e._apply_command = applied


def build(name, state, **kw):
    cfg = spec["moe_cfg"] if state == "moe" else spec["cfg"]
    pred = tpred.GenerativePredictor(
        "llama", size="tiny", max_seq=spec["max_seq"], max_batch=2,
        kv_page_size=spec["page_size"], device="cpu", model_config=cfg,
        state=torch.load(spec[state + "_state"], weights_only=True), **kw)
    observe(name, pred)
    return pred


bodies = []
peer = {"dead": False}


def post(addr, path, payload, timeout=300.0):
    # the HTTP hop, in process: the body as JSON, to D's :resume
    if peer["dead"]:
        raise ConnectionRefusedError("decode pod is gone")
    body = json.loads(json.dumps(payload))
    bodies.append(body)
    return preds["D"].resume(body)


preds = {}
preds["C"] = build("C", "dense", tp=2)
preds["D"] = build("D", "dense", tp=2, role="decode")
preds["M"] = build("M", "moe", ep=2, role="decode")
preds["P"] = build("P", "dense", tp=2, role="prefill", handoff_post=post)
preds["X"] = build("X", "dense", tp=2, role="decode")
groups = [p.engine._group for p in preds.values()]
out = {"rank": rank, "own_groups": len({id(g) for g in groups}) == 5}


def wsgi(app, path, body):
    raw = json.dumps(body).encode()
    env = {"REQUEST_METHOD": "POST", "PATH_INFO": path,
           "CONTENT_LENGTH": str(len(raw)), "wsgi.input": io.BytesIO(raw)}
    got = {}
    reply = b"".join(app(env, lambda s, h: got.update(status=s)))
    return int(got["status"].split()[0]), json.loads(reply)


def traffic():
    res = {}
    P, C, D, M = (preds[k] for k in "PCDM")
    res["greedy"] = P.generate(spec["ragged"], max_new_tokens=spec["new"],
                               decode_peer="decode:1")["ids"]
    res["greedy_bodies"] = list(bodies)
    res["long"] = P.generate([spec["long"]], max_new_tokens=spec["new"],
                             decode_peer="decode:1")["ids"]
    res["long_body"] = bodies[-1]
    res["colocated"] = C.generate(spec["ragged"],
                                  max_new_tokens=spec["new"])["ids"]
    res["seeded"] = P.generate(spec["ragged"], decode_peer="decode:1",
                               **spec["seeded"])["ids"]
    res["seeded_colocated"] = C.generate(spec["ragged"],
                                         **spec["seeded"])["ids"]
    res["seeded_gen_state"] = [bool(b.get("gen_state"))
                               for b in bodies[-2:]]
    # no decode peer, then a dead one: every rank resumes its own pages
    res["no_peer"] = P.generate(spec["ragged"],
                                max_new_tokens=spec["new"])["ids"]
    peer["dead"] = True
    res["dead_peer"] = P.generate([spec["long"]],
                                  max_new_tokens=spec["new"],
                                  decode_peer="decode:1")["ids"]
    peer["dead"] = False
    # one-process reference bodies resumed on the decode gangs
    res["ref_body"] = D.resume(copy.deepcopy(spec["ref_body"]))
    res["moe_body"] = M.resume(copy.deepcopy(spec["moe_body"]))
    # malformed bodies answer 422 on rank 0 and never reach a record
    app = tpred.PredictorApp({"llama": D})
    res["malformed"] = []
    for mutate in spec["malformed"]:
        bad = copy.deepcopy(spec["ref_body"])
        if mutate == "pages":
            bad["pages"] = bad["pages"][:1]
        elif mutate == "heads":
            for layer in bad["pages"][0]:
                layer["k"]["shape"][1] = 1
        elif mutate == "key_chain":
            bad["key_chain"] = [1, 2, 3]
        elif mutate == "generated":
            bad["generated"] = []
        res["malformed"].append(wsgi(app, "/v1/models/llama:resume", bad))
    status, body = wsgi(app, "/v1/models/llama:resume",
                        copy.deepcopy(spec["ref_body"]))
    res["after_malformed"] = [status, body.get("ids"),
                              body.get("broadcast_bytes")]
    res["stats"] = {k: p.engine.stats() for k, p in preds.items()}
    res["crash"] = crash(preds["X"])
    return res


def crash(X):
    # two :resume requests in one record of X, whose first page broadcast
    # raises on rank 0: each must fail at once
    e = X.engine
    send, exchange, body = lockstep.exchange_pages, lockstep.exchange, e._step_body
    gate, parked, entries = threading.Event(), threading.Event(), []

    def held_body():
        # the leader's loop waits here, between records, until both
        # requests are pending
        parked.set()
        gate.wait()
        body()

    def counted(rec, tally=None, group=None):
        if group is e._group and rec is not None and rec.handoffs:
            entries.append(len(rec.handoffs))
        return exchange(rec, tally, group)

    def broken(buf, nbytes, device, tally=None, group=None):
        if group is e._group:
            raise RuntimeError("Connection closed by peer")
        return send(buf, nbytes, device, tally, group)

    e._step_body = held_body
    lockstep.exchange, lockstep.exchange_pages = counted, broken
    parked.wait(30)
    got = [None, None]

    def one(i):
        t0 = time.perf_counter()
        try:
            X.resume(copy.deepcopy(spec["ref_body"]))
            got[i] = [time.perf_counter() - t0, None]
        except Exception as err:
            got[i] = [time.perf_counter() - t0,
                      f"{type(err).__name__}: {err}"]

    threads = [threading.Thread(target=one, args=(i,), daemon=True)
               for i in range(2)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 30
    while len(e._pending) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    gate.set()
    for t in threads:
        t.join(timeout=60)
    lockstep.exchange, lockstep.exchange_pages = exchange, send
    return {"requests": got, "entries": entries}


if rank == 0:
    try:
        out["result"] = traffic()
    except Exception as err:
        out["error"] = f"{type(err).__name__}: {err}"
    for p in preds.values():
        p.engine.shutdown()
else:
    errors = {}

    def run(name, p):
        try:
            p.follow()
        except Exception as err:
            errors[name] = f"{type(err).__name__}: {err}"

    threads = [threading.Thread(target=run, args=item)
               for item in preds.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    out["errors"] = errors
out["events"] = events
out["tally"] = {k: p.engine.record_tally for k, p in preds.items()}
out["held"] = {k: len(p.engine._held) for k, p in preds.items()}
print(json.dumps(out), flush=True)
os._exit(0)
"""

MALFORMED = ["pages", "heads", "key_chain", "generated"]


def _reference_pair(cfg, tp: int, prompts, new: int, **kw):
    """The reference's prefill and decode predictors (``tp``) over the
    in-process seam: the streams and the JSON bodies the prefill sent."""
    from kubeflow_tpu.serving.predictor import GenerativePredictor

    common = dict(size="tiny", max_batch=2, max_seq=MAX_SEQ,
                  model_config=cfg, kv_page_size=PAGE_SIZE, tp=tp)
    dec = GenerativePredictor("llama", role="decode", **common)
    bodies = []

    def post(addr, path, payload, timeout=300.0):
        body = json.loads(json.dumps(payload))
        bodies.append(body)
        return dec.resume(body)

    pre = GenerativePredictor("llama", role="prefill", handoff_post=post,
                              **common)
    try:
        ids = pre.generate(prompts, max_new_tokens=new,
                           decode_peer="decode:1", **kw)["ids"]
    finally:
        pre.engine.shutdown()
    return ids, bodies, dec


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's streams and bodies (module docstring), its seed-0
    weights as the port's state dicts, and a one-process reference
    decode predictor that resumes the gang's bodies."""
    from kubeflow_tpu.serving.predictor import GenerativePredictor

    root = tmp_path_factory.mktemp("disagg_gang")
    kw = dict(size="tiny", max_batch=2, max_seq=MAX_SEQ)
    ref = {"root": root}
    one = GenerativePredictor("llama", model_config=CFG, **kw)
    try:
        torch.save(state_of(one.params, CFG), root / "dense.pt")
        ref["one"] = one.generate(RAGGED, max_new_tokens=NEW)["ids"]
        ref["long"] = one.generate([LONG], max_new_tokens=NEW)["ids"]
    finally:
        one.engine.shutdown()
    tp2 = GenerativePredictor("llama", model_config=CFG, tp=2, **kw)
    try:
        ref["tp2"] = tp2.generate(RAGGED, max_new_tokens=NEW)["ids"]
    finally:
        tp2.engine.shutdown()
    ref["pair"], _, dec = _reference_pair(CFG, 2, RAGGED, NEW)
    dec.engine.shutdown()
    ids, bodies, dec = _reference_pair(CFG, 1, [LONG], NEW)
    ref["ref_body"], ref["ref_body_ids"] = bodies[0], ids[0]
    ref["decode"] = dec         # resumes the gang's bodies in the tests
    moe = GenerativePredictor("llama", model_config=MOE, **kw)
    try:
        torch.save(state_of(moe.params, MOE), root / "moe.pt")
        ref["moe_long"] = moe.generate([LONG], max_new_tokens=NEW)["ids"]
    finally:
        moe.engine.shutdown()
    ids, bodies, dec = _reference_pair(MOE, 1, [LONG], NEW)
    dec.engine.shutdown()
    ref["moe_body"], ref["moe_body_ids"] = bodies[0], ids[0]
    yield ref
    ref["decode"].engine.shutdown()


def disagg_gang(reference) -> list[dict]:
    """The gang of 2 (module docstring), spawned once per module; each
    rank's output in rank order."""
    if "gang" not in reference:
        root = reference["root"]
        spec = {"cfg": CFG, "moe_cfg": MOE, "max_seq": MAX_SEQ,
                "page_size": PAGE_SIZE, "heartbeat": HEARTBEAT_S,
                "dense_state": str(root / "dense.pt"),
                "moe_state": str(root / "moe.pt"), "ragged": RAGGED,
                "long": LONG, "new": NEW, "seeded": SEEDED,
                "ref_body": reference["ref_body"],
                "moe_body": reference["moe_body"],
                "malformed": MALFORMED}
        path = root / "spec.json"
        path.write_text(json.dumps(spec))
        reference["gang"] = pd.spawn_local_gang(
            "import os, json\n"
            f"os.environ['GANG_SPEC'] = open({str(path)!r}).read()\n"
            + WORKER, 2, timeout=300.0)
    return reference["gang"]
