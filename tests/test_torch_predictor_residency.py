"""Weight residency on a tp / ep serving gang, through the predictor's API:
a gang of 2 on the CPU over gloo (``torch_residency_gangs.WORKER``).

Two gang models (a dense tp=2 Llama and a MoE one at ep=2) serve at once
from two client threads, each on a record group of its own, token for
token the reference's one-chip streams.  ``park`` and ``warm`` on rank 0
ride the step records: every rank's weights go storage-less at the park
and come back bitwise (int8 ``q`` and ``scale`` included) at the warm,
the streams before and after equal the reference's re-warm route, a warm
of a resident model loads nothing, a park of a busy engine is refused,
and ``weight_bytes`` is the whole model's, the reference's tp=2 count.
Page pressure on a (every free page held) parks the idle b on both
ranks and donates the same pages on both, as many as the reference's
``relieve`` mints from those bytes; b's warm under a's pin reclaims only
the free donated slots on both ranks, and a's cached pages serve a warm
hit.  Last, a follower whose warm raises breaks the gang and rank 0's
next request fails into the crash path.
"""

import pytest

from kubeflow_tpu.serving import model_pool as jmp
from kubeflow_tpu.serving import page_pool as jpp
from torch_residency_gangs import (  # noqa: F401  (reference: a fixture)
    LONG, of, reference, reference_bytes, residency_gang)


def ranks(reference, section: str) -> list[dict]:
    return [o[section] for o in residency_gang(reference)]


def events(reference) -> list[list]:
    return [o["events"] for o in residency_gang(reference)]


@pytest.mark.parametrize("model, key", [("a", "dense"), ("b", "moe")])
def test_two_gang_models_serve_at_once_on_their_own_groups(reference, model,
                                                           key):
    lead, follow = ranks(reference, "concurrent")
    assert lead[model] == [reference[key]["solo"], reference[key]["pair"]]
    assert follow["errors"] == []
    assert lead["own_groups"] and follow["own_groups"]
    # every record of each model reached the follower on its group
    assert follow["tally"][model]["records"] == \
        lead["tally"][model]["records"] > 0
    mine, theirs = (of(e, model, "done") for e in events(reference))
    assert [e[2] for e in theirs] == [e[2] for e in mine]


@pytest.mark.parametrize("case", ["f32", "int8"])
def test_park_leaves_every_rank_storage_less(reference, case):
    lead, follow = ranks(reference, case)
    assert follow["errors"] == []
    assert "is parked" in lead["parked_generate"]
    assert lead["parked_rank_bytes"] == 0
    for log in events(reference):
        parks = of(log, case, "park")
        assert [p[2] for p in parks] == [lead["weight_bytes"], 0]
        assert all(p[3] and p[4] == {} for p in parks)


@pytest.mark.parametrize("case", ["f32", "int8"])
def test_warm_restores_every_ranks_blocks_bitwise(reference, case):
    for rec, log in zip(ranks(reference, case), events(reference)):
        warms = of(log, case, "warm")
        assert len(warms) == 2
        for w in warms:
            assert not w[3] and w[4] == rec["blocks"]
        if case == "int8":
            # every matmul weight's q and scale blocks
            qs = sorted(n[:-2] for n in rec["blocks"] if n.endswith(".q"))
            assert len(qs) == 10 and all(f"{n}.scale" in rec["blocks"]
                                         for n in qs)


@pytest.mark.parametrize("case", ["f32", "int8"])
def test_warm_is_idempotent_and_loads_once_on_every_rank(reference, case):
    lead, _ = ranks(reference, case)
    assert lead["warm"] == lead["warm_again"] == lead["weight_bytes"]
    assert lead["park"] == lead["weight_bytes"] and lead["park_again"] == 0
    for log in events(reference):
        # the one warm after the park: a warm of a resident model loads
        # nothing
        assert len(of(log, case, "load")) == 1


def test_streams_across_park_and_warm_equal_the_reference_rewarm(reference):
    lead, _ = ranks(reference, "f32")
    want = reference["dense"]
    assert lead["before"] == lead["after"] == want["solo"] == want["rewarm"]
    # int8 weights: the same stream before and after, on both ranks
    lead8, _ = ranks(reference, "int8")
    assert lead8["before"] == lead8["after"]
    for case in ("f32", "int8"):
        mine, theirs = (of(e, case, "done") for e in events(reference))
        assert [e[2] for e in theirs] == [e[2] for e in mine]


@pytest.mark.parametrize("case", ["f32", "int8"])
def test_weight_bytes_is_the_whole_models(reference, case):
    from kubeflow_tpu_torch.serving.predictor import GenerativePredictor

    int8 = case == "int8"
    port = GenerativePredictor("llama", size="tiny", max_seq=64,
                               model_config={"dtype": "float32"},
                               quantize=int8, device="cpu")
    port.engine.shutdown()
    # the reference counts its global arrays, at tp=2 as on one chip
    want = reference_bytes(2, int8)
    assert want == reference_bytes(1, int8) == port.weight_bytes
    for rec in ranks(reference, case):
        assert rec["weight_bytes"] == want
        # a rank's own blocks: half of every split weight, norms whole
        assert 0.5 < rec["rank_weight_bytes"] / rec["weight_bytes"] < 0.55


def test_a_busy_engine_is_not_parked(reference):
    lead, follow = ranks(reference, "f32")
    assert "cannot park a serving engine with live requests" in \
        lead["busy_park"]
    assert len(lead["busy_stream"]) == 4 + 50
    assert follow["errors"] == []


def test_pressure_parks_the_idle_sibling_and_donates_on_every_rank(
        reference):
    lead, follow = ranks(reference, "pressure")
    assert follow["errors"] == []
    assert lead["held"] == follow["held"] > 0
    out = lead["out"]
    assert [o["status"] for o in out] == [200] * 5
    # the long prompt to a parked b
    assert out[2]["parked"] == {"a": False, "b": True}
    logs = events(reference)
    for log in logs:
        assert [p[2] for p in of(log, "b", "park")] == [
            reference["moe"]["weight_bytes"]]
    donations = [of(log, "a", "donate") for log in logs]
    assert donations[0] == donations[1]
    (donated,) = donations[0]
    page_nbytes = lead["a_pool"]["page_nbytes"]
    assert donated[2] == reference["moe"]["weight_bytes"] // page_nbytes
    assert out[2]["pool"]["donated_pages"] == donated[2]


def reference_arbitration(reference, lead) -> dict:
    """The reference's ``ModelPool`` and ``PagePool`` through the gang's
    sequence: b loaded and idle, a pinned with every free page held, a
    commit that meets pressure, b's load under a's pin, and the pools'
    state after each."""
    pages, nbytes = lead["a_pool"]["pages"], lead["a_pool"]["page_nbytes"]
    size = {n: reference[k]["weight_bytes"] for n, k in (("a", "dense"),
                                                          ("b", "moe"))}
    pool = jpp.PagePool(pages + 1, lead["a_pool"]["page_size"],
                        page_nbytes=nbytes)
    mp = jmp.ModelPool(size["a"] + size["b"])
    for name in ("a", "b"):
        mp.register(name, lambda n=name: (n, size[n]),
                    nbytes_hint=size[name])
    mp.acquire("b")
    mp.release("b")
    mp.acquire("a")
    cached = pool.alloc(1)                     # a's first prompt's page
    held = pool.alloc(pool.free_count)
    assert cached and held and pool.alloc(3) is None
    out = {"relieved": mp.relieve(pool)}
    fresh = pool.alloc(3)                      # the long prompt's pages
    out["after_pressure"] = (mp.stats(), pool.num_pages, pool.free_count)
    mp.release("a")
    mp.acquire("a")
    mp.acquire("b")                            # reclaims free slots only
    out["after_reclaim"] = (mp.stats(), pool.num_pages, pool.free_count)
    assert fresh is not None
    return out


def test_donation_and_reclaim_equal_the_reference_pools(reference):
    lead, follow = ranks(reference, "pressure")
    want = reference_arbitration(reference, lead)
    assert want["relieved"]
    out = lead["out"]
    for got, (stats, num_pages, free) in ((out[2], want["after_pressure"]),
                                          (out[3], want["after_reclaim"])):
        for key in ("donated_pages", "donated_bytes", "resident", "parked",
                    "evictions_total", "weight_bytes"):
            assert got["pool"][key] == stats[key], key
    # every rank's pool took the same reclaim: the free donated slots
    logs = events(reference)
    reclaims = [of(log, "a", "reclaim") for log in logs]
    assert reclaims[0] == reclaims[1] and len(reclaims[0]) >= 1
    took = sum(r[3] for r in reclaims[0])
    donated = out[2]["pool"]["donated_pages"]
    assert took == donated - out[3]["pool"]["donated_pages"] == \
        donated - want["after_reclaim"][0]["donated_pages"]
    for log in logs:
        last = of(log, "a", "reclaim")[-1][4]
        assert last["pages"] == want["after_reclaim"][1] - 1
        assert last["free"] == want["after_reclaim"][2]


def test_a_keeps_its_kv_and_every_stream_its_never_parked_tokens(
        reference):
    lead, _ = ranks(reference, "pressure")
    out = lead["out"]
    long_stream = reference["dense"]["long"]
    assert [o["ids"] for o in out] == [
        reference["moe"]["solo"], reference["dense"]["solo"], long_stream,
        reference["moe"]["solo"], long_stream]
    # the warm hit on a's cached pages (they survived the reclaim)
    assert out[4]["ids"][0] == out[2]["ids"][0]
    assert out[3]["parked"] == {"a": False, "b": False}
    assert LONG == long_stream[0][:len(LONG)]


def test_both_ranks_page_pools_are_equal_after_every_request(reference):
    mine, theirs = (of(e, "a", "done", "donate", "reclaim")
                    for e in events(reference))
    assert len(mine) == len(theirs) >= 5
    assert mine == theirs
    rows = [e[-1]["device_rows"] for e in mine]
    assert rows[-1] > rows[0]            # the donation grew the rows


def test_a_follower_whose_warm_raises_breaks_the_gang(reference):
    lead, follow = ranks(reference, "crash")
    assert "OSError: checkpoint unreachable" in follow["error"]
    assert lead["warm"] == lead["park"] > 0
    assert "serving engine crashed" in lead["request"]
    assert "serving engine crashed" in lead["later"]
