"""Multi-tenant admission of the port against the reference's ``qos``.

The WFQ and ``fair_quota`` cases of ``tests/test_qos.py`` run on both
implementations, which must mint identical tags and admission orders.
The same multi-tenant traffic goes through the JAX ``ContinuousBatcher``
and the port's (float32 llama_tiny, the same weights, one slot, admission
held until every request is queued): identical admission order, greedy
streams and per-tenant usage; without shares the order stays FIFO.
"""

import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.parallel.sharding import unbox_params
from kubeflow_tpu.qos import accounting as jacct
from kubeflow_tpu.qos import tenants as jten
from kubeflow_tpu.qos import wfq as jwfq
from kubeflow_tpu.serving.engine import ContinuousBatcher as JaxBatcher
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.qos import accounting as tacct
from kubeflow_tpu_torch.qos import tenants as tten
from kubeflow_tpu_torch.qos import wfq as twfq
from kubeflow_tpu_torch.serving import engine as teng
from kubeflow_tpu_torch.serving import predictor as tpred
from kubeflow_tpu_torch.utils.metrics import REGISTRY

WFQS = {"reference": jwfq, "port": twfq}


def simulate(wfq_mod, arrivals, shares):
    """Tag every arrival, then admit min-tag first: (order, tags)."""
    wfq = wfq_mod.WeightedFairQueue(shares=shares)
    queue = [(wfq.tag(t), seq, t) for seq, t in enumerate(arrivals)]
    tags = [q[0] for q in queue]
    order = []
    while queue:
        queue.sort()
        tag, _, tenant = queue.pop(0)
        wfq.advance(tag)
        order.append(tenant)
    return order, tags


CASES = {
    "single_flow": (["anonymous"] * 10, None),
    "equal_shares": (["a"] * 6 + ["b"] * 3, {"a": 1.0, "b": 1.0}),
    "weighted": (["a"] * 8 + ["b"] * 4, {"a": 2.0, "b": 1.0}),
    "storm": (["storm"] * 100 + ["victim"] * 10,
              {"storm": 1.0, "victim": 1.0}),
    "weighted_victim": (["storm"] * 200 + ["victim"] * 20,
                        {"storm": 1.0, "victim": 4.0}),
    "unknown_tenant": (["a", "x", "a", "x", "b"], {"a": 3.0, "b": 1.0}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_wfq_orders_and_tags_match_reference(case):
    arrivals, shares = CASES[case]
    ref = simulate(jwfq, arrivals, shares)
    got = simulate(twfq, arrivals, shares)
    assert got == ref
    order, tags = got
    if case == "single_flow":
        assert tags == sorted(tags) and len(set(tags)) == 10
    if case == "equal_shares":
        assert [i for i, t in enumerate(order) if t == "b"] == [1, 3, 5]
    if case == "weighted":
        assert order[:8].count("a") >= 5 and "b" in order[:8]
    if case in ("storm", "weighted_victim"):
        w = shares["victim"]
        total = sum(shares.values())
        slack = 0 if case == "storm" else 1
        for k, pos in enumerate((i for i, t in enumerate(order)
                                 if t == "victim"), start=1):
            assert pos < math.ceil(k * total / w) + slack


@pytest.mark.parametrize("impl", sorted(WFQS))
def test_fifo_within_tenant_and_idle_flow_restart(impl):
    mod = WFQS[impl]
    wfq = mod.WeightedFairQueue(shares={"a": 1.0, "b": 3.0})
    tags_a = [wfq.tag("a") for _ in range(5)]
    assert tags_a == sorted(tags_a)
    idle = mod.WeightedFairQueue(shares={"a": 1.0, "b": 1.0})
    for _ in range(5):
        idle.advance(idle.tag("a"))
    idle.forget("b")
    assert idle.tag("b") >= idle.vtime


@pytest.mark.parametrize("args", [
    (8, "anyone", None), (8, "a", {"a": 2.0, "b": 1.0, "c": 1.0}),
    (8, "b", {"a": 2.0, "b": 1.0, "c": 1.0}),
    (1, "b", {"a": 2.0, "b": 1.0, "c": 1.0}),
    (0, "a", {"a": 2.0}), (8, "stranger", {"a": 3.0})])
def test_fair_quota_matches_reference(args):
    assert twfq.fair_quota(*args) == jwfq.fair_quota(*args)


def test_clamp_tenant_matches_reference():
    for claim, known in [("a", {"a": 1.0}), ("b", {"a": 1.0}),
                         (None, {"a": 1.0}), ("a", None), ("", {"": 1})]:
        assert tten.clamp_tenant(claim, known) == \
            jten.clamp_tenant(claim, known)
    assert tten.ANONYMOUS == jten.ANONYMOUS


def test_accountant_round_trip():
    acct = tacct.Accountant()
    acct.record_outcome("team-a", "ok")
    acct.record_outcome("team-a", "ok")
    acct.record_outcome("team-a", "shed")
    acct.record_throttled("team-a")
    acct.record_decode_tokens("team-a", 128)
    acct.record_slice_seconds("team-a", 1.5)
    acct.record_admission_wait("team-a", 0.2)
    acct.record_admission_wait("team-a", 0.6)
    u = acct.usage("team-a")
    assert u["requests"] == {"ok": 2, "shed": 1}
    assert u["throttled"] == 1 and u["decode_tokens"] == 128
    assert u["slice_seconds"] == pytest.approx(1.5)
    assert u["admission_wait"]["count"] == 2
    assert u["admission_wait"]["sum_s"] == pytest.approx(0.8)
    assert u["admission_wait"]["max_s"] == pytest.approx(0.6)
    assert acct.usage("ghost")["decode_tokens"] == 0
    u["requests"]["ok"] = 999
    assert acct.usage("team-a")["requests"]["ok"] == 2
    assert set(acct.all_usage()) == {"team-a"}
    prev = tacct.set_accountant(acct)
    try:
        assert tacct.get_accountant() is acct
    finally:
        tacct.set_accountant(prev)


# -- the engines side by side --------------------------------------------------

MAX_SEQ = 64
SHARES = {"a": 1.0, "b": 1.0}
# (tenant, prompt length): "a" storms first, "b" and a stranger follow
TRAFFIC = [("a", 5), ("a", 9), ("a", 7), ("a", 12), ("b", 6), ("b", 10),
           ("stranger", 8)]


@pytest.fixture(scope="module")
def weights():
    cfg = jl.llama_tiny(dtype="float32")
    model = jl.LlamaModel(cfg)
    params = unbox_params(jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    state = convert.from_jax_params(jax.tree.map(np.asarray, params),
                                    tl.llama_tiny(dtype="float32"))
    return cfg, model, params, state


def prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(1, 500, n).tolist() for _, n in TRAFFIC]


def run_gated(eng):
    """Queue the whole traffic with admission held, then release it;
    returns (tenants in admission order, streams in submit order)."""
    gate = threading.Event()
    admit = eng._admit

    def gated():
        gate.wait(30)
        admit()

    eng._admit = gated
    reqs = [eng.submit(p, max_new_tokens=4, tenant=t)
            for (t, _), p in zip(TRAFFIC, prompts())]
    gate.set()
    streams = [r.result(timeout=120) for r in reqs]
    order = sorted(range(len(reqs)), key=lambda i: reqs[i].admitted_at)
    return [reqs[i].tenant for i in order], streams


def usage(acct) -> dict:
    return {t: {"requests": u["requests"],
                "decode_tokens": u["decode_tokens"],
                "waits": u["admission_wait"]["count"]}
            for t, u in acct.all_usage().items()}


@pytest.mark.parametrize("shares_on", [True, False], ids=["wfq", "fifo"])
def test_engines_admit_serve_and_bill_alike(weights, shares_on):
    cfg, model, params, state = weights
    shares = SHARES if shares_on else None
    ref_acct, port_acct = jacct.Accountant(), tacct.Accountant()
    prev_ref = jacct.set_accountant(ref_acct)
    prev_port = tacct.set_accountant(port_acct)
    jb = JaxBatcher(model, params, cfg, max_batch=1, max_seq=MAX_SEQ,
                    tenant_shares=shares)
    module = tl.LlamaModel(tl.llama_tiny(dtype="float32"), device="cpu")
    module.load_state_dict(state)
    tb = teng.ContinuousBatcher(module, module.config, max_batch=1,
                                max_seq=MAX_SEQ, tenant_shares=shares)
    try:
        ref = run_gated(jb)
        got = run_gated(tb)
    finally:
        jb.shutdown()
        tb.shutdown()
        jacct.set_accountant(prev_ref)
        tacct.set_accountant(prev_port)
    assert got == ref
    order, _ = got
    if shares_on:
        # tags a:1..4, b:1..2, the stranger (anonymous) 1: ties by arrival
        assert order == ["a", "b", "anonymous", "a", "b", "a", "a"]
    else:
        assert order == ["anonymous"] * 7      # and in submit order:
    assert usage(port_acct) == usage(ref_acct)
    assert sum(u["decode_tokens"] for u in usage(port_acct).values()) \
        == 3 * len(TRAFFIC)


def test_fifo_without_shares_keeps_submit_order(weights):
    *_, state = weights
    module = tl.LlamaModel(tl.llama_tiny(dtype="float32"), device="cpu")
    module.load_state_dict(state)
    eng = teng.ContinuousBatcher(module, module.config, max_batch=1,
                                 max_seq=MAX_SEQ)
    try:
        gate = threading.Event()
        admit = eng._admit
        eng._admit = lambda: (gate.wait(30), admit())
        reqs = [eng.submit(p, max_new_tokens=2, tenant=t)
                for (t, _), p in zip(TRAFFIC, prompts())]
        gate.set()
        for r in reqs:
            r.result(timeout=120)
        assert sorted(reqs, key=lambda r: r.admitted_at) == reqs
        assert [r._seq for r in reqs] == sorted(r._seq for r in reqs)
    finally:
        eng.shutdown()


def test_tenant_shed_and_retry_estimate(weights):
    """The bounded queue sheds a storming tenant at its fair share while
    another tenant's slots stay open, with the reference's message."""
    *_, state = weights
    module = tl.LlamaModel(tl.llama_tiny(dtype="float32"), device="cpu")
    module.load_state_dict(state)
    acct = tacct.Accountant()
    prev = tacct.set_accountant(acct)
    eng = teng.ContinuousBatcher(module, module.config, max_batch=1,
                                 max_seq=MAX_SEQ, max_queue=4,
                                 tenant_shares=SHARES)
    try:
        gate = threading.Event()
        admit = eng._admit
        eng._admit = lambda: (gate.wait(30), admit())
        held = [eng.submit([1, 2, 3], 2, tenant="a") for _ in range(2)]
        with pytest.raises(teng.QueueFull,
                           match=r"tenant a \(2/2 fair-share slots\)"):
            eng.submit([1, 2], 2, tenant="a")
        held.append(eng.submit([4, 5], 2, tenant="b"))
        gate.set()
        for r in held:
            r.result(timeout=120)
        assert acct.usage("a")["requests"] == {"ok": 2, "shed": 1}
        eng._service_ewma = 2.0
        with eng._work:
            eng.queue.extend([teng.GenRequest([1], 1, 0.0, tenant="b")] * 2)
            # b's 2 waiters over its half of one slot, times 2 s
            assert eng._estimated_wait_locked("b") == pytest.approx(8.0)
            assert eng._estimated_wait_locked("a") == 0.0
            eng.queue.clear()
    finally:
        eng.shutdown()
        tacct.set_accountant(prev)


def test_tenant_threads_through_predictor_to_accounting():
    """generate(tenant=...) bills the resolved tenant; an unknown claim
    folds into anonymous and mints no series (the reference's
    TestEngineTenantFlow)."""
    acct = tacct.Accountant()
    prev = tacct.set_accountant(acct)
    pred = tpred.GenerativePredictor(
        "llama", size="tiny", max_batch=2, max_seq=MAX_SEQ, device="cpu",
        tenant_shares={"team-a": 2.0, "team-b": 1.0})
    try:
        pred.generate([[3, 1, 4]], max_new_tokens=4, tenant="team-a")
        pred.generate([[2, 7]], max_new_tokens=4, tenant="spoofed")
        ua = acct.usage("team-a")
        assert ua["requests"] == {"ok": 1}
        assert ua["decode_tokens"] == 3
        assert ua["admission_wait"]["count"] == 1
        assert acct.usage("anonymous")["requests"] == {"ok": 1}
        assert acct.usage("spoofed")["requests"] == {}
        ttft = REGISTRY.get_metric(
            "serving_tenant_time_to_first_token_seconds")
        assert ttft.count("team-a") >= 1 and ttft.count("anonymous") >= 1
        assert ttft.count("spoofed") == 0
        wait = REGISTRY.get_metric("serving_tenant_admission_wait_seconds")
        assert wait.count("team-a") >= 1
    finally:
        pred.stop(timeout=10)
        tacct.set_accountant(prev)
