"""Several models under one weight budget on a tp / ep serving gang: the
CLI (``predictor.main``) in a gang of 2 on the CPU over gloo
(``torch_residency_gangs.CLI_WORKER``).

``--model 'llama:name=a,tp=2,...'`` and ``--model
'llama:name=b,moe_experts=2,moe_every=2,ep=2,parked=true,...'`` restore
the reference's float32 weights from streamed checkpoints under a
``--weight-budget-mb`` that holds either model and not both.  Rank 0
serves HTTP and runs the ``ModelPool``; rank 1 follows both models, each
in a thread of its own.  ``b`` starts parked on both ranks and its first
request warms both; the requests a, b, a park the idle model on both
ranks at each switch; the pool's states, loads, evictions and bytes equal
the reference ``ModelPool``'s driven through the same sequence with the
reference predictors' ``weight_bytes``; every stream is the reference's
never-parked one; four cold requests to the parked b coalesce behind
one gang-wide load (one weight load on each rank); and ``mnist_mlp`` in
the same CLI is served by rank 0 alone.

A second CLI gang (``sibling_gang``) serves the tp=2 ``a`` beside ``c``, a
one-card Llama on rank 0's card, under a budget that holds both, and
holds every free page of a's pool on both ranks before a long prompt:
the gang's page pressure never evicts the one-card sibling (its park
would free rank 0's card alone, while every follower donated as many
page slots to its own pool), no rank's pool grows by a page, both ranks
decide alike, and the commit falls back to the prefix cache as it does
with no idle sibling.
"""

import threading

import pytest

from kubeflow_tpu.serving import model_pool as jmp
from torch_residency_gangs import (  # noqa: F401  (reference: a fixture)
    COLD_K, SEQUENCE, cli_budget, of, pool_gang, reference, sibling_gang)

KEY = {"a": "dense", "b": "moe"}


def residency_events(log: list) -> list:
    """A rank's residency events in order (client markers and finished
    requests aside), without the blocks' digests."""
    return [e[:4] for e in log if e[0] in ("a", "b")
            and e[1] in ("load", "park", "warm", "start_parked")]


def steps(reference) -> list[dict]:
    lead = pool_gang(reference)[0]
    assert lead["client"].get("error") is None, lead["client"]["error"]
    return lead["client"]["steps"]


def test_the_gang_serves_and_stops_cleanly(reference):
    lead, follow = pool_gang(reference)
    assert lead["rc"] == follow["rc"] == 0
    assert [s["label"] for s in steps(reference)] == [
        "start", *[name for name, _ in SEQUENCE], "cold"]


def test_parked_true_starts_every_rank_parked_and_a_request_warms_both(
        reference):
    for o in pool_gang(reference):
        got = residency_events(o["events"])
        want_b = reference["moe"]["weight_bytes"]
        assert of(got, "b")[:3] == [["b", "start_parked", want_b, True],
                                    ["b", "load"],
                                    ["b", "warm", want_b, False]]
    first = steps(reference)[0]
    assert first["residency"] == {"a": "parked", "b": "parked"}


def test_each_switch_parks_the_idle_model_on_every_rank(reference):
    lead, follow = pool_gang(reference)
    # each model's events in its engine's order, alike on both ranks
    for name in ("a", "b"):
        assert of(residency_events(lead["events"]), name) == \
            of(residency_events(follow["events"]), name)
    want = {"a": {"a": "resident", "b": "parked"},
            "b": {"a": "parked", "b": "resident"}}
    for step, (name, _) in zip(steps(reference)[1:], SEQUENCE):
        assert step["residency"] == want[name]
    # at each switch the park of the idle model comes before the load
    got = [e[:2] for e in residency_events(lead["events"])
           if e[1] in ("park", "load")]
    assert got == [["a", "park"], ["b", "load"], ["b", "park"],
                   ["a", "load"], ["a", "park"], ["b", "load"]]


def reference_pool(reference) -> list[dict]:
    """The reference ``ModelPool`` through the client's sequence: each
    step's ``stats()``."""
    size = {n: reference[k]["weight_bytes"] for n, k in KEY.items()}
    evicted = []
    mp = jmp.ModelPool(cli_budget(reference))
    for name in ("a", "b"):
        mp.register(name, lambda n=name: (n, size[n]),
                    evictor=lambda n=name: evicted.append(n) or size[n],
                    nbytes_hint=size[name])
    out = [mp.stats()]
    for name, _ in SEQUENCE:
        mp.acquire(name)
        mp.release(name)
        out.append(mp.stats())

    def cold():
        mp.acquire("b")
        mp.release("b")

    threads = [threading.Thread(target=cold) for _ in range(COLD_K)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    out.append(mp.stats())
    return out


def comparable(stats: dict) -> dict:
    """A pool's ``stats()`` without what timing decides (coalescing, load
    seconds)."""
    out = {k: v for k, v in stats.items() if k != "coalesced_total"}
    out["models"] = {n: {k: v for k, v in m.items()
                         if k not in ("coalesced", "last_load_seconds")}
                     for n, m in stats["models"].items()}
    return out


def test_pool_decisions_equal_the_reference_pool(reference):
    want = reference_pool(reference)
    got = [s["pool"] for s in steps(reference)]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert comparable(g) == comparable(w), i


def test_every_stream_is_the_never_parked_one(reference):
    for step, (name, _) in zip(steps(reference)[1:], SEQUENCE):
        status, body = step["got"]
        assert status == 200
        assert body["ids"] == reference[KEY[name]]["solo"]
    lead = pool_gang(reference)[0]
    assert [r[0] for r in lead["client"]["cold"]] == [200] * COLD_K
    assert all(r[1]["ids"] == reference["moe"]["solo"]
               for r in lead["client"]["cold"])


def test_cold_requests_coalesce_behind_one_gang_load(reference):
    before, after = (s["pool"]["models"]["b"] for s in steps(reference)[-2:])
    assert after["loads"] - before["loads"] == 1
    for o in pool_gang(reference):
        log = o["events"]
        if o["rank"] == 0:
            cold = log.index(["client", "cold"])
        else:
            # the follower's events since b's last park
            cold = max(i for i, e in enumerate(log) if e[:2] == ["b", "park"])
        assert len(of(log[cold:], "b", "load")) == 1
        assert len(of(log[cold:], "b", "done")) == COLD_K


def test_a_classifier_in_the_same_cli_is_served_by_rank_zero_alone(
        reference):
    import torch

    from kubeflow_tpu_torch.serving.predictor import ClassifierPredictor

    lead, follow = pool_gang(reference)
    status, body = lead["client"]["predict"]
    assert status == 200
    one = ClassifierPredictor("mnist_mlp", device="cpu")
    want = one.predict([[[[0.5]] * 28] * 28])
    assert body["predictions"] == want["predictions"]
    assert torch.equal(torch.tensor(body["logits"]),
                       torch.tensor(want["logits"]))
    # the follower built and followed the two gang models only
    assert follow["followed"] == ["a", "b"] and "followed" not in lead


def sibling_steps(reference) -> list[dict]:
    lead = sibling_gang(reference)[0]
    assert lead["client"].get("error") is None, lead["client"]["error"]
    return lead["client"]["steps"]


def test_gang_pressure_serves_every_stream_with_a_one_card_sibling(
        reference):
    lead, follow = sibling_gang(reference)
    assert lead["rc"] == follow["rc"] == 0
    want = {"c": reference["dense"]["solo"], "a": reference["dense"]["solo"]}
    got = {}
    for step in sibling_steps(reference)[1:]:
        if step["label"].startswith("hold"):
            continue
        status, body = step["got"]
        assert status == 200
        got.setdefault(step["label"], []).append(body["ids"])
    assert got == {"c": [want["c"]],
                   "a": [want["a"], reference["dense"]["long"]]}
    # the long prompt's commit met page pressure on both ranks alike
    calls = [o["tally"]["a"].get("pressure_calls", 0)
             for o in (lead, follow)]
    assert calls[0] >= 1 and calls[0] == calls[1]


def test_gang_pressure_never_evicts_a_one_card_sibling(reference):
    lead, follow = sibling_gang(reference)
    last = sibling_steps(reference)[-1]
    assert last["residency"] == {"a": "resident", "c": "resident"}
    assert last["pool"]["models"]["c"]["evictions"] == 0
    assert last["pool"]["donated_pages"] == 0
    for o in (lead, follow):
        assert of(o["events"], "c", "park") == []


def test_no_follower_pool_grows_by_pages_its_card_did_not_free(reference):
    """Each rank's donations into the gang model's pool follow a park on
    that rank's own card, and every rank decides alike: the same held
    pages, the same donations, the same pool after every request."""
    logs = [o["events"] for o in sibling_gang(reference)]
    for log in logs:
        parked = 0
        for e in log:
            if e[1] == "park" and e[2] > 0:
                parked += 1
            elif e[:2] == ["a", "donate"]:
                assert parked > 0, f"donated {e[2]} pages with no park"
                parked -= 1
    mine, theirs = (of(log, "a", "held", "done", "donate") for log in logs)
    assert [e[:2] for e in mine] == [["a", "done"], ["a", "held"],
                                     ["a", "done"]]
    assert mine == theirs
    assert mine[1][3]["free"] == 0 and mine[1][2] > 0
    # the long prompt's pages: no page slot was minted on either rank
    assert mine[2][3]["pages"] == mine[1][3]["pages"]
