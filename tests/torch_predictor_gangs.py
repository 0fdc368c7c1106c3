"""The tp / ep predictor gangs' shared parts: the reference's weights as
the port's state dicts, the gang worker, and the reference's streams,
placed shards and pool statistics.

``test_torch_predictor_tp.py`` runs a 2-process gang (tp=2 dense and
int8, the prefix cache, n-gram speculation, the lockstep cases, ep=2 on
the MoE model in float32 and int8, the refusals, and last a forced token
mismatch) and a 2-process CLI gang; ``test_torch_predictor_tp_four.py``
a 4-process tp=2 x ep=2 MoE gang, in float32 and int8.  Each gang is spawned once per module, every rank
on the CPU over gloo, and held to the reference's ``GenerativePredictor``
(the tiny Llama in float32, its seed-0 weights carried across by
``convert.from_jax_params``) and, for the layout, to its tp=2 placement.
"""

import json

import jax
import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.parallel import distributed as pd

CFG = {"dtype": "float32"}
MOE = {**CFG, "moe_experts": 2, "moe_every": 2}
MAX_SEQ = 64
# the reference test's prompts
SOLO, PAIR = [[5, 8, 13, 21]], [[5, 8, 13, 21], [2, 7]]
# the lockstep traffic: two client threads' staggered prompts, the
# cancel / deadline rows and the one after an idle gap
STAGGERED = [[3, 4, 5], [9, 1, 22, 7, 3], [40, 41], [17, 2, 2, 9]]
AFTER_IDLE = [6, 6, 1]
# prefix-cache traffic: a shared 20-token system prompt and its turns,
# each sent cold and again warm
SYS = [11, 57, 3, 98, 140, 7, 7, 21, 300, 4, 5, 61, 2, 90, 13, 8, 77, 1,
       44, 9]
PREFIX = [SYS + [7, 1], SYS + [19, 6, 2], SYS + [7, 1],
          SYS + list(range(80, 100))]
PREFIX_MB = 0.25
# text that repeats itself, so n-gram drafts land
SPEC = [[5, 6, 7, 5, 6, 7, 5, 6], [30, 31, 30, 31, 30, 31]]
HEARTBEAT_S = 0.2
IDLE_S = 1.2
# the lockstep case's leader sleeps this long per forward, so that a
# cancel lands mid-decode and a deadline passes mid-stream
SLOW_S = 0.02

WORKER = r"""
import hashlib, json, os, threading, time
import torch
from kubeflow_tpu_torch.parallel import distributed as pd
from kubeflow_tpu_torch.serving import engine as eng
from kubeflow_tpu_torch.serving.predictor import GenerativePredictor
from kubeflow_tpu_torch.serving.quant import QTensor

torch.set_num_threads(1)
spec = json.loads(os.environ["GANG_SPEC"])
pd.initialize_from_env(device="cpu")
rank = pd.rank_of(pd.default_group())
eng.HEARTBEAT_S = spec["heartbeat"]
seen = []
_enqueue = eng.ContinuousBatcher._enqueue_locked


def enqueue(self, req):
    _enqueue(self, req)
    seen.append((id(self), req))


eng.ContinuousBatcher._enqueue_locked = enqueue


def sha(t):
    return hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()


def blocks(module):
    out = {}
    for mod_name, m in module.named_modules():
        for leaf, w in [*m.named_parameters(recurse=False),
                        *((n, c) for n, c in m.named_children()
                          if isinstance(c, QTensor))]:
            rec = {a: (None if s is None else [s.dim, s.size, s.index])
                   for a in ("tp", "ep")
                   for s in [getattr(w, f"{a}_split", None)]}
            if isinstance(w, QTensor):
                rec.update(q=list(w.q.shape), scale=list(w.scale.shape),
                           q_sha=sha(w.q), scale_sha=sha(w.scale))
            else:
                rec.update(shape=list(w.shape))
            out[f"{mod_name}.{leaf}"] = rec
    return out


def refused(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return [type(e).__name__, str(e)]
    return None


def streams(engine):
    # every request this rank's engine enqueued, in arrival order
    return [{"seq": r._seq, "ids": r.ids + r.generated,
             "outcome": r.outcome} for e, r in seen if e == id(engine)]


def serve(label, traffic=None, state="dense", **kw):
    # every rank builds the predictor; rank 0 runs the traffic and shuts
    # the engine down, the others follow until that stop
    cfg = spec["moe_cfg"] if state == "moe" else spec["cfg"]
    pred = GenerativePredictor(
        "llama", size="tiny", max_seq=spec["max_seq"], device="cpu",
        model_config=cfg, state=torch.load(spec[state + "_state"],
                                           weights_only=True), **kw)
    e = pred.engine
    rec = {"blocks": blocks(pred.module),
           "view": [list(l["k"].shape) for l in e.view],
           "pool": (None if e.pool.kv is None else
                    [list(t.shape) for t in e.pool.kv["layers"][0].values()])}
    if rank == 0:
        rec["result"] = traffic(pred)
        rec["stats"] = e.stats()
        rec["refused"] = {
            "park": refused(pred.park),
            "pages": refused(lambda: pred.export_pages([1, 2])),
            "restart": refused(e.restart)}
        e.shutdown()
    else:
        rec["refused"] = {"submit": str(_raises(
            lambda: e.submit([1, 2], max_new_tokens=2)))}
        pred.follow()
    rec["scratch"] = (None if e._scratch_kv is None
                      else list(e._scratch_kv[0]["k"].shape))
    rec["streams"] = streams(e)
    rec["tally"] = dict(e.record_tally)
    out[label] = rec
    return pred


def _raises(fn):
    try:
        fn()
    except Exception as err:
        return err
    return None


def gen(prompts, n, **kw):
    return lambda p: p.generate(prompts, max_new_tokens=n, **kw)["ids"]


def lockstep(p):
    e, res = p.engine, {}
    forward = p.module.forward

    def slow(*a, **k):
        time.sleep(spec["slow"])
        return forward(*a, **k)

    p.module.forward = slow
    # two client threads, staggered
    got = {}

    def client(i):
        for j in (i, i + 2):
            time.sleep(0.03 * j)
            got[j] = e.submit(spec["staggered"][j], max_new_tokens=6)
    threads = [threading.Thread(target=client, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    res["staggered"] = [got[j].result(60) for j in range(4)]
    # a cancel mid-decode: A's deadline keeps chunks at 8 while C waits
    a = e.submit([1, 2, 3], max_new_tokens=50, deadline_s=600)
    b = e.submit([4, 5], max_new_tokens=30)
    c = e.submit(spec["staggered"][0], max_new_tokens=6)
    while not a.generated:
        time.sleep(0.001)
    a.cancel()
    res["cancel"] = {"a": _outcome(a), "b": b.result(60), "c": c.result(60)}
    # a deadline that passes mid-stream
    d = e.submit([8, 9, 10], max_new_tokens=50, deadline_s=0.3)
    res["deadline"] = _outcome(d)
    p.module.forward = forward
    # an idle gap of several heartbeats; the followers wait in them
    before = dict(e.record_tally)
    time.sleep(spec["idle"])
    res["idle_records"] = e.record_tally["records"] - before["records"]
    res["after_idle"] = e.submit(spec["after_idle"],
                                 max_new_tokens=6).result(60)
    return res


def _outcome(req):
    err = _raises(lambda: req.result(60))
    return {"outcome": req.outcome, "generated": len(req.generated),
            "error": None if err is None else type(err).__name__}


out = {"rank": rank}
if spec["layout"] == "tp2":
    serve("dense", lambda p: {"solo": gen(spec["solo"], 12)(p),
                              "pair": gen(spec["pair"], 8)(p)},
          tp=2, max_batch=2)
    serve("int8", gen(spec["solo"], 12), tp=2, max_batch=2, quantize=True)
    serve("prefix", lambda p: [gen([q], 8)(p)[0] for q in spec["prefix"]],
          tp=2, max_batch=2, prefill_chunk=16,
          prefix_cache_mb=spec["prefix_mb"])
    serve("spec", lambda p: [gen([q], 12)(p)[0] for q in spec["spec"]],
          tp=2, max_batch=2, speculative_tokens=4)
    serve("lockstep", lockstep, tp=2, max_batch=2)
    serve("ep2", gen(spec["solo"], 10), state="moe", ep=2, max_batch=2)
    # a prefill gang with no decode peer resumes the handoff itself
    serve("handoff", gen(spec["solo"], 12), tp=2, max_batch=2,
          role="prefill")
    serve("ep2_int8", gen(spec["solo"], 10), state="moe", ep=2, max_batch=2,
          quantize=True)
    kw = dict(size="tiny", max_seq=spec["max_seq"], device="cpu")
    out["refusals"] = {
        "tp8": refused(lambda: GenerativePredictor(tp=8, **kw)),
        "ep_dense": refused(lambda: GenerativePredictor(ep=2, **kw)),
        "ep4": refused(lambda: GenerativePredictor(
            ep=4, model_config=spec["moe_cfg"], **kw)),
        "directory": refused(lambda: GenerativePredictor(
            tp=2, directory=object(), **kw))}
    # a role serves on a gang now: the predictor starts on every rank
    role = GenerativePredictor(tp=2, role="prefill", **kw)
    out["refusals"]["role"] = None
    if rank == 0:
        role.engine.shutdown()
    else:
        role.follow()
    # last: a follower whose tokens differ raises at the next record, and
    # its exit breaks the leader's next collective
    if rank == 0:
        p = GenerativePredictor("llama", size="tiny", tp=2, max_batch=2,
                                max_seq=spec["max_seq"], device="cpu",
                                model_config=spec["cfg"])
        req = p.engine.submit(spec["solo"][0], max_new_tokens=20)
        out["mismatch"] = {"request": _outcome(req), "error": req.error,
                           "later": str(_raises(lambda: p.engine.submit(
                               [1], max_new_tokens=1)))}
    else:
        p = GenerativePredictor("llama", size="tiny", tp=2, max_batch=2,
                                max_seq=spec["max_seq"], device="cpu",
                                model_config=spec["cfg"])
        emit = p.engine._emit

        def wrong(req, tok):
            emit(req, tok + 1 if not req.generated else tok)
        p.engine._emit = wrong
        out["mismatch"] = {"error": str(_raises(p.follow))}
elif spec["layout"] == "moe":
    pred = serve("tp2_ep2", lambda p: {"solo": gen(spec["solo"], 10)(p),
                                       "pair": gen(spec["pair"], 8)(p)},
                 state="moe", tp=2, ep=2, max_batch=2)
    out["coords"] = [pred.mesh.coordinate("tp"), pred.mesh.coordinate("ep")]
    serve("tp2_ep2_int8", gen(spec["solo"], 10), state="moe", tp=2, ep=2,
          max_batch=2, quantize=True)
print(json.dumps(out), flush=True)
os._exit(0)
"""

# the CLI in a gang: rank 0 serves HTTP, posts to itself from a client
# thread and stops on SIGTERM; rank 1 follows
CLI_WORKER = r"""
import json, os, signal, threading, time, urllib.request
from kubeflow_tpu_torch.parallel import distributed as pd
from kubeflow_tpu_torch.serving import predictor

spec = json.loads(os.environ["GANG_SPEC"])
rank = int(os.environ["JAXJOB_PROCESS_ID"])
argv = ["--model", spec["model"], "--device", "cpu"]
out = {"rank": rank}
if rank == 0:
    os.environ["KF_POD_PORT"] = str(spec["port"])

    def client():
        url = f"http://127.0.0.1:{spec['port']}/v1/models/llama:generate"
        body = json.dumps({"ids": spec["prompts"],
                           "max_new_tokens": spec["new"]}).encode()
        for _ in range(600):
            try:
                resp = urllib.request.urlopen(urllib.request.Request(
                    url, data=body,
                    headers={"Content-Type": "application/json"}), timeout=60)
                out["status"] = resp.status
                out["body"] = json.loads(resp.read())
                break
            except OSError:
                time.sleep(0.1)
        os.kill(os.getpid(), signal.SIGTERM)

    threading.Thread(target=client, daemon=True).start()
out["rc"] = predictor.main(argv)
print(json.dumps(out), flush=True)
"""


def state_of(params, cfg: dict) -> dict:
    return convert.from_jax_params(jax.tree.map(np.asarray, params),
                                   tl.llama_tiny(**cfg))


def flat(tree: dict, prefix: str = "") -> dict:
    """A flax params tree by the port's names (an int8 leaf stays a
    ``QTensor``)."""
    out = {}
    for key, val in tree.items():
        path = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(val, dict):
            out.update(flat(val, path))
        else:
            out[path.replace("layer_", "layers.")] = val
    return out


def shard_at(x, mesh, tp: int, ep: int = 0):
    """The reference's shard of placed array ``x`` on the device at mesh
    coordinate (tp, ep), as numpy."""
    device = mesh.devices[0, 0, tp, 0, 0, ep]
    (shard,) = [s for s in x.addressable_shards if s.device == device]
    return np.asarray(shard.data)


def int8_mismatches(got: dict, placed, tp: int, ep: int) -> list[str]:
    """The int8 weights of a rank's ``blocks`` record (at mesh coordinate
    (tp, ep)) whose ``q`` or ``scale`` is not bitwise (SHA-256 and shape)
    its shard of the reference's placement ``placed``.  The other leaves
    are held by the layout tests: the port keeps the router whole where
    the reference splits its logits over ep (``parallel/sharding.py``)."""
    import hashlib

    def digest(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    bad = []
    want = flat(placed.params)
    if set(got) != set(want):
        bad.append(f"names {sorted(set(got) ^ set(want))}")
    for name, leaf in want.items():
        rec = got.get(name, {})
        if hasattr(leaf, "q"):
            q = shard_at(leaf.q, placed.mesh, tp, ep)
            scale = shard_at(leaf.scale, placed.mesh, tp, ep)
            if (rec.get("q"), rec.get("scale"), rec.get("q_sha"),
                    rec.get("scale_sha")) != (
                    list(q.shape), list(scale.shape), digest(q),
                    digest(scale)):
                bad.append(name)
    return bad


def run(pred, prompts, n, **kw):
    return pred.generate(prompts, max_new_tokens=n, **kw)["ids"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The reference's one-chip predictors (dense and MoE, and the MoE in
    int8: their streams and their seed-0 weights as the port's state
    dicts), its tp=2 placements (bf16 and int8) and its int8 MoE
    placements at ep=2 and tp=2 x ep=2 (the shards each rank must hold),
    and its prefix-cached engine's statistics after ``PREFIX``."""
    from kubeflow_tpu.serving.predictor import GenerativePredictor

    root = tmp_path_factory.mktemp("predictor_tp")
    kw = dict(size="tiny", max_batch=2, max_seq=MAX_SEQ)
    ref = {"root": root, "gangs": {}}
    dense = GenerativePredictor("llama", model_config=CFG, **kw)
    try:
        torch.save(state_of(dense.params, CFG), root / "dense.pt")
        ref["solo"] = run(dense, SOLO, 12)
        ref["pair"] = run(dense, PAIR, 8)
        ref["staggered"] = [run(dense, [p], 6)[0] for p in STAGGERED]
        ref["after_idle"] = run(dense, [AFTER_IDLE], 6)[0]
        ref["b30"] = run(dense, [[4, 5]], 30)[0]
        ref["spec"] = [run(dense, [p], 12)[0] for p in SPEC]
    finally:
        dense.engine.shutdown()
    pc = GenerativePredictor("llama", model_config=CFG, prefill_chunk=16,
                             prefix_cache_mb=PREFIX_MB, **kw)
    try:
        ref["prefix"] = [run(pc, [p], 8)[0] for p in PREFIX]
        ref["prefix_stats"] = pc.engine.stats()
    finally:
        pc.engine.shutdown()
    moe = GenerativePredictor("llama", model_config=MOE, **kw)
    try:
        torch.save(state_of(moe.params, MOE), root / "moe.pt")
        ref["moe_solo"] = run(moe, SOLO, 10)
        ref["moe_pair"] = run(moe, PAIR, 8)
    finally:
        moe.engine.shutdown()
    moe8 = GenerativePredictor("llama", model_config=MOE, quantize=True,
                               **kw)
    try:
        ref["moe_int8_solo"] = run(moe8, SOLO, 10)
    finally:
        moe8.engine.shutdown()
    for name, cfg, extra in (
            ("tp2", CFG, {"tp": 2}),
            ("tp2_int8", CFG, {"tp": 2, "quantize": True}),
            ("ep2_int8", MOE, {"ep": 2, "quantize": True}),
            ("tp2_ep2_int8", MOE, {"tp": 2, "ep": 2, "quantize": True})):
        placed = GenerativePredictor("llama", model_config=cfg, **extra,
                                     **kw)
        placed.engine.shutdown()
        ref[name] = placed
    return ref


def gang(setup, layout: str) -> list[dict]:
    """The port's gang of ``layout`` ("tp2": 2 ranks, "moe": 4), spawned
    once per module; each rank's output in rank order."""
    if layout not in setup["gangs"]:
        spec = {"layout": layout, "cfg": CFG, "moe_cfg": MOE,
                "dense_state": str(setup["root"] / "dense.pt"),
                "moe_state": str(setup["root"] / "moe.pt"),
                "max_seq": MAX_SEQ, "solo": SOLO, "pair": PAIR,
                "staggered": STAGGERED, "after_idle": AFTER_IDLE,
                "prefix": PREFIX, "prefix_mb": PREFIX_MB, "spec": SPEC,
                "slow": SLOW_S, "heartbeat": HEARTBEAT_S, "idle": IDLE_S}
        setup["gangs"][layout] = pd.spawn_local_gang(
            WORKER, 2 if layout == "tp2" else 4, timeout=240.0,
            extra_env={"GANG_SPEC": json.dumps(spec)})
    return setup["gangs"][layout]


def cli_gang(prompts: list, new: int) -> list[dict]:
    """``predictor.main`` with ``--model llama:size=tiny,tp=2`` in a gang
    of 2: rank 0's POST of ``prompts`` and both ranks' exit codes."""
    spec = {"model": f"llama:size=tiny,tp=2,max_seq={MAX_SEQ}",
            "port": pd.free_port(), "prompts": prompts, "new": new}
    return pd.spawn_local_gang(CLI_WORKER, 2, timeout=180.0,
                               extra_env={"GANG_SPEC": json.dumps(spec)})
