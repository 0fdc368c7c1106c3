"""Weight residency on a tp / ep serving gang: the shared parts of
``test_torch_predictor_residency.py`` (a 2-process gang driven through the
predictor's API) and ``test_torch_predictor_pool_gang.py`` (the CLI in a
gang of 2 under ``--weight-budget-mb``).

Each rank runs on the CPU over gloo and logs, in the order it applied
them, its residency events: every weight load, every park and warm with
its blocks' SHA-256 (or that nothing is left), every donation and
reclaim of page slots, and every finished request with its page pool's
statistics.  The tests hold the ranks' logs to each other, the streams
to the reference's (the tiny Llama in float32, its seed-0 weights carried
across by ``convert.from_jax_params``), and the pool's decisions to the
reference's ``ModelPool`` and ``PagePool`` driven through the same
sequence.
"""

import json

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.parallel import distributed as pd
from torch_predictor_gangs import CFG, MAX_SEQ, MOE, PAIR, SOLO, state_of

# a 40-token prompt: 3 full pages of 16 to commit into a's prefix cache
LONG = [int(t) for t in np.random.default_rng(20).integers(1, 512, 40)]
LONG_NEW = 6
PAGE_SIZE = 16
CACHE_MB = 0.05            # 6 pages of the tiny float32 model's 8 KiB
HEARTBEAT_S = 0.2
# cold requests sent at once to a parked model over HTTP
COLD_K = 4

_COMMON = r"""
import hashlib, io, json, os, threading, time
import torch
import torch.distributed as dist
from kubeflow_tpu_torch.parallel import distributed as pd
from kubeflow_tpu_torch.serving import engine as eng
from kubeflow_tpu_torch.serving import predictor as tpred

torch.set_num_threads(1)
spec = json.loads(os.environ["GANG_SPEC"])
GP = tpred.GenerativePredictor
events, _lock = [], threading.Lock()


def note(*rec):
    with _lock:
        events.append(list(rec))


def sha(t):
    return hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()


def blocks(module):
    # every parameter's and int8 q / scale block's bytes, by name
    return {n: sha(t) for n, t in (*module.named_parameters(),
                                   *module.named_buffers())
            if not t.is_meta}


def storage_less(module):
    return (all(t.is_meta for t in module.parameters())
            and not list(module.buffers()))


def pool_stats(e):
    s = e.pool.stats()
    s.pop("fault_wait_seconds")
    return s


_load, _init = GP._load_params, GP.__init__


def load(self):
    note(self.name, "load")
    _load(self)


def init(self, *args, name=None, **kwargs):
    # the served name, before the constructor's own load
    self.name = name
    _init(self, *args, **kwargs)
    self.name = name
    observe(self)


GP._load_params = load


PREDS = []


def observe(pred):
    PREDS.append(pred)
    e = pred.engine
    inner = e.residency_fn

    def residency(kind):
        out = inner(kind)
        note(pred.name, kind, out, storage_less(pred.module),
             blocks(pred.module))
        return out

    e.residency_fn = residency
    for what in ("donate", "reclaim"):
        def wrapped(n, fn=getattr(e.pool, what), what=what):
            out = fn(n)
            note(pred.name, what, n, out, pool_stats(e))
            return out
        setattr(e.pool, what, wrapped)
    finish = e._finish_if_done

    def finished(slot):
        req = e.slots[slot]
        finish(slot)
        if req is not None and e.slots[slot] is None:
            note(pred.name, "done", req.ids + req.generated, pool_stats(e))

    e._finish_if_done = finished


def raises(fn):
    try:
        fn()
    except Exception as err:
        return f"{type(err).__name__}: {err}"
    return None
"""

WORKER = _COMMON + r"""
pd.initialize_from_env(device="cpu")
rank = pd.rank_of(pd.default_group())
eng.HEARTBEAT_S = spec["heartbeat"]
GP.__init__ = init


def build(name, state, **kw):
    cfg = spec["moe_cfg"] if state == "moe" else spec["cfg"]
    return GP("llama", size="tiny", max_seq=spec["max_seq"], max_batch=2,
              device="cpu", model_config=cfg, name=name,
              state=torch.load(spec[state + "_state"], weights_only=True),
              **kw)


def follow_all(preds):
    # a follower: every gang model in a thread of its own
    errors = []

    def run(p):
        try:
            p.follow()
        except Exception as err:
            errors.append(f"{p.name}: {type(err).__name__}: {err}")

    threads = [threading.Thread(target=run, args=(p,)) for p in preds]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return errors


def wsgi(app, path, body):
    raw = json.dumps(body).encode()
    env = {"REQUEST_METHOD": "POST", "PATH_INFO": path,
           "CONTENT_LENGTH": str(len(raw)), "wsgi.input": io.BytesIO(raw)}
    got = {}
    out = b"".join(app(env, lambda s, h: got.update(status=s)))
    return int(got["status"].split()[0]), json.loads(out)


def concurrent():
    # two gang models, each fed from a client thread of its own at once
    a = build("a", "dense", tp=2)
    b = build("b", "moe", ep=2)
    res = {"own_groups": a.engine._group is not b.engine._group and all(
        p.engine._group is not dist.group.WORLD for p in (a, b))}
    if rank == 0:
        def client(p, jobs):
            res[p.name] = [p.generate(prompts, max_new_tokens=n)["ids"]
                           for prompts, n in jobs]

        threads = [threading.Thread(target=client, args=(
                       a, [(spec["solo"], 12), (spec["pair"], 8)])),
                   threading.Thread(target=client, args=(
                       b, [(spec["solo"], 10), (spec["pair"], 8)]))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for p in (a, b):
            p.engine.shutdown()
    else:
        res["errors"] = follow_all([a, b])
    res["tally"] = {p.name: p.engine.record_tally for p in (a, b)}
    return res


def park_warm(name, quantize):
    p = build(name, "dense", tp=2, quantize=quantize)
    res = {"blocks": blocks(p.module), "weight_bytes": p.weight_bytes,
           "rank_weight_bytes": p.rank_weight_bytes}
    if rank == 0:
        res["before"] = p.generate(spec["solo"], max_new_tokens=12)["ids"]
        res["park"] = p.park()
        res["parked_rank_bytes"] = p.rank_weight_bytes
        res["park_again"] = p.park()
        res["parked_generate"] = raises(
            lambda: p.generate(spec["solo"], max_new_tokens=2))
        res["warm"] = p.warm()
        res["warm_again"] = p.warm()
        res["after"] = p.generate(spec["solo"], max_new_tokens=12)["ids"]
        # a park waits for an idle engine: refused while a request lives
        req = p.engine.submit(spec["solo"][0], max_new_tokens=50)
        res["busy_park"] = raises(p.park)
        res["busy_stream"] = req.result(60)
        p.engine.shutdown()
    else:
        res["errors"] = follow_all([p])
    return res


def pressure():
    # a (dense, tp=2) with a small prefix cache and b (MoE, ep=2) under
    # one budget that holds both; every free page of a's pool is held on
    # every rank, so a's next commit meets page pressure with b idle
    a = build("a", "dense", tp=2, prefix_cache_mb=spec["cache_mb"],
              kv_page_size=spec["page_size"], prefill_chunk=16)
    b = build("b", "moe", ep=2)
    preds = {"a": a, "b": b}
    res = {"a_pool": pool_stats(a.engine),
           "weight_bytes": {n: p.weight_bytes for n, p in preds.items()}}
    held, start = [], len(events)

    def hold():
        # the same pages on every rank: the pools are in lockstep, and
        # a's engine is idle between the two barriers once it has
        # finished a's first request here too
        while sum(e[:2] == ["a", "done"] for e in events[start:]) < 1:
            time.sleep(0.01)
        dist.barrier()
        held.extend(a.engine.pool.alloc(a.engine.pool.free_count))
        dist.barrier()

    if rank == 0:
        pool = tpred.wire_model_pool(preds, spec["budget"])
        app = tpred.PredictorApp(preds, model_pool=pool)
        out = []

        def post(name, prompts, n):
            status, body = wsgi(app, f"/v1/models/{name}:generate",
                                {"ids": prompts, "max_new_tokens": n})
            out.append({"model": name, "status": status,
                        "ids": body.get("ids"), "error": body.get("error"),
                        "pool": pool.stats(),
                        "parked": {k: p.parked for k, p in preds.items()}})

        post("b", spec["solo"], 10)
        post("a", spec["solo"], 12)
        hold()
        post("a", [spec["long"]], spec["long_new"])     # parks b, donates
        pool.acquire("a")            # a pinned: b's warm reclaims slots
        post("b", spec["solo"], 10)
        pool.release("a")
        post("a", [spec["long"]], spec["long_new"])     # a warm hit
        res["out"] = out
        for p in preds.values():
            p.engine.shutdown()
    else:
        following = threading.Thread(target=lambda: res.update(
            errors=follow_all([a, b])))
        following.start()
        hold()
        following.join()
    res["held"] = len(held)
    return res


def crash():
    # last: a follower whose warm raises breaks the gang, and rank 0's
    # next request fails into the crash path
    p = build("c", "dense", tp=2)
    res = {}
    if rank == 0:
        res["park"] = p.park()
        res["warm"] = p.warm()
        time.sleep(1.0)              # the follower's exit lands meanwhile
        res["request"] = raises(lambda: p.engine.submit(
            spec["solo"][0], max_new_tokens=4).result(60))
        res["later"] = raises(lambda: p.engine.submit([1], max_new_tokens=1))
    else:
        def unreachable():
            raise OSError("checkpoint unreachable")

        p._load_params = unreachable
        res["error"] = raises(p.follow)
    return res


out = {"rank": rank}
out["concurrent"] = concurrent()
out["f32"] = park_warm("f32", False)
out["int8"] = park_warm("int8", True)
out["pressure"] = pressure()
out["crash"] = crash()
out["events"] = events
print(json.dumps(out), flush=True)
os._exit(0)
"""

# the CLI in a gang of 2 with two models under one weight budget: rank 0
# serves HTTP and drives the traffic from a client thread, then stops on
# SIGTERM; rank 1 follows both models
CLI_WORKER = _COMMON + r"""
import signal
import urllib.request

from kubeflow_tpu_torch.serving import model_pool as mp

rank = int(os.environ["JAXJOB_PROCESS_ID"])
_named = GP.__init__


def named(self, *args, **kwargs):
    # main names its predictors after construction; log them by the
    # checkpoint they load (one per model).  Both serve in float32, the
    # reference's precision
    kwargs["name"] = os.path.basename(kwargs["checkpoint_dir"])
    kwargs["model_config"] = {**(kwargs["model_config"] or {}),
                              "dtype": "float32"}
    init(self, *args, **kwargs)


GP.__init__ = named
_start_parked = GP.start_parked


def start_parked(self):
    out = _start_parked(self)
    note(self.name, "start_parked", out, storage_less(self.module))
    return out


GP.start_parked = start_parked
out = {"rank": rank}
_follow_all = tpred._follow_all


def follow_all(rank, predictors):
    out["followed"] = sorted(predictors)
    return _follow_all(rank, predictors)


tpred._follow_all = follow_all


def post(name, prompts, n):
    url = f"http://127.0.0.1:{spec['port']}/v1/models/{name}:generate"
    body = json.dumps({"ids": prompts, "max_new_tokens": n}).encode()
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, json.loads(resp.read())


def get(name):
    url = f"http://127.0.0.1:{spec['port']}/v1/models/{name}"
    with urllib.request.urlopen(url, timeout=60) as resp:
        return json.loads(resp.read())


def client():
    res = {"steps": []}
    try:
        for _ in range(600):
            try:
                get("a")
                break
            except OSError:
                time.sleep(0.1)
        pool = mp.get_model_pool()

        def step(label, fn):
            note("client", label)
            got = fn()
            res["steps"].append({
                "label": label, "got": got, "pool": pool.stats(),
                "residency": {n: get(n)["residency"]
                              for n in spec.get("pooled", ("a", "b"))}})

        step("start", lambda: None)
        for entry in spec["sequence"]:
            if entry[0] == "hold":
                step(f"hold {entry[1]}", lambda m=entry[1]: hold(m))
                continue
            name, n = entry[:2]
            prompts = spec[entry[2]] if len(entry) > 2 else spec["solo"]
            step(name, lambda name=name, n=n, prompts=prompts: post(
                name, prompts, n))
        if not spec.get("cold_k"):
            return
        # K cold requests to the parked b at once: one gang-wide load
        replies = [None] * spec["cold_k"]

        def cold(i):
            replies[i] = post("b", spec["solo"], spec["b_new"])

        def burst():
            threads = [threading.Thread(target=cold, args=(i,))
                       for i in range(spec["cold_k"])]
            for t in threads:
                t.start()
            for t in threads:
                t.join()

        step("cold", burst)
        res["cold"] = replies
        # the classifier rank 0 serves alone, outside the budget
        url = f"http://127.0.0.1:{spec['port']}/v1/models/mnist_mlp:predict"
        req = urllib.request.Request(url, data=json.dumps(
            {"instances": [[[[0.5]] * 28] * 28]}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            res["predict"] = [resp.status, json.loads(resp.read())]
    except Exception as err:
        res["error"] = f"{type(err).__name__}: {err}"
    finally:
        out["client"] = res
        os.kill(os.getpid(), signal.SIGTERM)


def hold(model):
    # every free page of ``model``'s pool held on every rank, once its
    # engine has finished every request the client sent it (the pools
    # are in lockstep, so the held ids are the same on each rank)
    sent = sum(1 for e in spec["sequence"][:spec["sequence"].index(
        ["hold", model])] if e[0] == model)
    while sum(e[:2] == [model, "done"] for e in events) < sent:
        time.sleep(0.01)
    (pred,) = [p for p in PREDS if p.name == model]
    dist.barrier()
    pool = pred.engine.pool
    held = pool.alloc(pool.free_count)
    note(model, "held", len(held or []), pool_stats(pred.engine))
    dist.barrier()


argv = ["--device", "cpu", "--max-seq", str(spec["max_seq"]),
        "--max-batch", "2", "--weight-budget-mb", repr(spec["budget_mb"])]
for m in spec["models"]:
    argv += ["--model", m]
if rank == 0:
    os.environ["KF_POD_PORT"] = str(spec["port"])
    threading.Thread(target=client, daemon=True).start()
else:
    for entry in spec["sequence"]:
        if entry[0] == "hold":
            threading.Thread(target=hold, args=(entry[1],),
                             daemon=True).start()
out["rc"] = tpred.main(argv)
out["events"] = events
out["tally"] = {p.name: p.engine.record_tally for p in PREDS}
print(json.dumps(out), flush=True)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's float32 tiny Llamas, dense and MoE: their seed-0
    weights as the port's state dicts and streamed checkpoints, their
    streams, the re-warm route's stream and their weight bytes."""
    from kubeflow_tpu.serving.predictor import GenerativePredictor

    from kubeflow_tpu_torch.models import registry
    from kubeflow_tpu_torch.serving import model_pool as tmp_

    root = tmp_path_factory.mktemp("residency")
    kw = dict(size="tiny", max_batch=2, max_seq=MAX_SEQ)
    ref = {"root": root, "gangs": {}}
    for label, cfg, new in (("dense", CFG, 12), ("moe", MOE, 10)):
        pred = GenerativePredictor("llama", model_config=cfg, **kw)
        try:
            state = state_of(pred.params, cfg)
            torch.save(state, root / f"{label}.pt")
            module = registry.get("llama").make_model(size="tiny",
                                                      device="cpu", **cfg)
            module.load_state_dict(state)
            tmp_.save_streamable(module, str(root / f"ckpt_{label}"))
            if label == "dense":
                # the one-card sibling's copy of the same weights
                tmp_.save_streamable(module, str(root / "ckpt_c"))
            ref[label] = {"solo": pred.generate(SOLO, new)["ids"],
                          "pair": pred.generate(PAIR, 8)["ids"],
                          "weight_bytes": pred.weight_bytes}
            if label == "dense":
                ref[label]["long"] = pred.generate([LONG], LONG_NEW)["ids"]
                # the reference's re-warm route: park, warm, the stream
                pred.park()
                pred.warm()
                ref[label]["rewarm"] = pred.generate(SOLO, new)["ids"]
        finally:
            pred.engine.shutdown()
    return ref


def reference_bytes(tp: int, quantize: bool) -> int:
    """``weight_bytes`` of the reference's float32 tiny Llama at ``tp``
    (its tp=2 placement counts the global arrays)."""
    from kubeflow_tpu.serving.predictor import GenerativePredictor

    pred = GenerativePredictor("llama", size="tiny", max_batch=2,
                               max_seq=MAX_SEQ, model_config=CFG, tp=tp,
                               quantize=quantize)
    pred.engine.shutdown()
    return pred.weight_bytes


def residency_gang(reference) -> list[dict]:
    """The API gang of 2, spawned once per module; each rank's output."""
    if "api" not in reference["gangs"]:
        root = reference["root"]
        both = (reference["dense"]["weight_bytes"]
                + reference["moe"]["weight_bytes"])
        spec = {"cfg": CFG, "moe_cfg": MOE, "max_seq": MAX_SEQ,
                "dense_state": str(root / "dense.pt"),
                "moe_state": str(root / "moe.pt"), "solo": SOLO,
                "pair": PAIR, "long": LONG, "long_new": LONG_NEW,
                "cache_mb": CACHE_MB, "page_size": PAGE_SIZE,
                "budget": both, "heartbeat": HEARTBEAT_S}
        reference["gangs"]["api"] = pd.spawn_local_gang(
            WORKER, 2, timeout=300.0,
            extra_env={"GANG_SPEC": json.dumps(spec)})
    return reference["gangs"]["api"]


# the CLI gang's traffic: a, then b (a parks), then a (b parks)
SEQUENCE = [("a", 12), ("b", 10), ("a", 12)]


def cli_budget(reference) -> int:
    """Bytes that hold either model and not both."""
    a, b = (reference[k]["weight_bytes"] for k in ("dense", "moe"))
    return (max(a, b) + a + b) // 2


def pool_gang(reference) -> list[dict]:
    """``predictor.main`` in a gang of 2 serving ``a`` (dense, tp=2) and
    ``b`` (MoE, ep=2, ``parked=true``) from the reference's streamed
    checkpoints under ``cli_budget``, and ``mnist_mlp`` from rank 0 alone;
    spawned once per module."""
    if "cli" not in reference["gangs"]:
        root = reference["root"]
        models = [f"llama:name=a,tp=2,checkpoint_dir={root / 'ckpt_dense'}",
                  f"llama:name=b,moe_experts=2,moe_every=2,ep=2,"
                  f"parked=true,checkpoint_dir={root / 'ckpt_moe'}",
                  "mnist_mlp"]
        spec = {"models": models, "max_seq": MAX_SEQ,
                "budget_mb": cli_budget(reference) / (1 << 20),
                "port": pd.free_port(), "solo": SOLO, "sequence": SEQUENCE,
                "cold_k": COLD_K, "b_new": 10}
        reference["gangs"]["cli"] = pd.spawn_local_gang(
            CLI_WORKER, 2, timeout=300.0,
            extra_env={"GANG_SPEC": json.dumps(spec)})
    return reference["gangs"]["cli"]


# the sibling gang's traffic: the one-card c, the gang model a, every
# free page of a's pool held on both ranks, then a's long prompt, whose
# commit meets page pressure with c idle
SIBLING_SEQUENCE = [["c", 12], ["a", 12], ["hold", "a"],
                    ["a", LONG_NEW, "long"]]


def sibling_gang(reference) -> list[dict]:
    """``predictor.main`` in a gang of 2 serving ``a`` (dense, tp=2, a
    small prefix cache) and ``c`` (the same weights on rank 0's card
    alone) from the reference's streamed checkpoints under a budget that
    holds both; rank 0 drives ``SIBLING_SEQUENCE``.  Spawned once per
    module."""
    if "sibling" not in reference["gangs"]:
        root = reference["root"]
        budget = 2 * reference["dense"]["weight_bytes"] + (1 << 20)
        models = [f"llama:name=a,tp=2,prefix_cache_mb={CACHE_MB},"
                  f"kv_page_size={PAGE_SIZE},prefill_chunk=16,"
                  f"checkpoint_dir={root / 'ckpt_dense'}",
                  f"llama:name=c,checkpoint_dir={root / 'ckpt_c'}"]
        spec = {"models": models, "max_seq": MAX_SEQ,
                "budget_mb": budget / (1 << 20), "port": pd.free_port(),
                "solo": SOLO, "long": [LONG], "sequence": SIBLING_SEQUENCE,
                "pooled": ["a", "c"], "cold_k": 0}
        reference["gangs"]["sibling"] = pd.spawn_local_gang(
            CLI_WORKER, 2, timeout=300.0,
            extra_env={"GANG_SPEC": json.dumps(spec)})
    return reference["gangs"]["sibling"]


def of(events: list, model: str, *kinds: str) -> list:
    """``events`` of ``model`` (of ``kinds``, or all)."""
    return [e for e in events
            if e[0] == model and (not kinds or e[1] in kinds)]
