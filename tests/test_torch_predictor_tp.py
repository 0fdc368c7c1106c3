"""The predictor's ``tp=`` and ``ep=`` on the PyTorch port: a gang of 2 on
the CPU over gloo.

The reference's ``TestShardedServing`` (``tests/test_serving_engine.py``)
across processes: tp=2 decodes token-identical to the reference's
one-chip predictor, solo and as a ragged pair, in float32 and int8; each
rank's weights and int8 ``q``/``scale`` blocks are its shard of the
reference's tp=2 placement and its view, scratch and page pool hold
``Hkv / tp`` heads; the reference's ``ValueError``s ("divisible",
"MoE").  Then the lockstep continuous batcher: staggered submits from two
client threads, a cancel mid-decode and a deadline passing mid-stream
(rank 0's verdicts, the same outcome on the follower), prefix-cache warm
== cold with the reference engine's page statistics, n-gram speculation,
an idle gap of several heartbeats, ep=2 on the MoE model, a follower
whose tokens differ raising (and its exit failing rank 0's request), and
the CLI serving ``:generate`` from rank 0 of a gang.  Shared parts in
``torch_predictor_gangs.py``; the tp=2 x ep=2 gang of 4 is
``test_torch_predictor_tp_four.py``.
"""

import hashlib

import numpy as np
import pytest

from torch_predictor_gangs import (  # noqa: F401  (setup: a fixture)
    IDLE_S, HEARTBEAT_S, PAIR, PREFIX, SOLO, SPEC, cli_gang, flat, gang,
    int8_mismatches, setup, shard_at)

# every kernel tp splits: the attention and MLP projections, the embedding
SPLIT = ("attention.q.kernel", "attention.k.kernel", "attention.v.kernel",
         "attention.o.kernel", "gate.kernel", "up.kernel", "down.kernel")


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def ranks(setup, case: str) -> list[dict]:
    return [o[case] for o in gang(setup, "tp2")]


def follower_streams(rec: dict) -> list:
    return [s["ids"] for s in rec["streams"]]


@pytest.mark.parametrize("case, key, n", [("dense", "solo", 12),
                                          ("dense", "pair", 8),
                                          ("int8", None, 12)])
def test_tp2_decode_matches_the_reference(setup, case, key, n):
    lead, follow = ranks(setup, case)
    got = lead["result"] if key is None else lead["result"][key]
    want = setup["solo" if key is None else key]
    assert got == want
    assert all(len(row) == len(p) + n for row, p in zip(
        got, SOLO if key != "pair" else PAIR))
    # every rank ran the same requests to the same tokens
    assert follower_streams(follow) == follower_streams(lead)
    assert [s["outcome"] for s in follow["streams"]] == ["ok"] * len(
        follow["streams"])


@pytest.mark.parametrize("case", ["dense", "int8"])
def test_each_rank_holds_its_shard_of_the_reference_placement(setup, case):
    placed = setup["tp2" if case == "dense" else "tp2_int8"]
    want = flat(placed.params)
    for tp, rec in enumerate(ranks(setup, case)):
        got = rec["blocks"]
        assert set(got) == set(want)
        for name in ["tok_embeddings.embedding"] + [
                f"layers.{i}.{k}" for i in range(2) for k in SPLIT]:
            assert got[name]["tp"][1:] == [2, tp], name
        for name, leaf in want.items():
            if hasattr(leaf, "q"):
                q = shard_at(leaf.q, placed.mesh, tp)
                scale = shard_at(leaf.scale, placed.mesh, tp)
                assert (got[name]["q"], got[name]["scale"]) == (
                    list(q.shape), list(scale.shape)), name
                assert got[name]["q_sha"] == sha(q), name
                assert got[name]["scale_sha"] == sha(scale), name
            else:
                assert got[name]["shape"] == list(
                    shard_at(leaf, placed.mesh, tp).shape), name
        if case == "int8":
            assert sum("q" in r for r in got.values()) == 10


@pytest.mark.parametrize("case", ["dense", "prefix"])
def test_view_scratch_and_pool_hold_the_ranks_kv_heads(setup, case):
    for rec in ranks(setup, case):
        # tiny: 2 KV heads of 16 over tp = 2
        assert rec["view"] == [[2, 64, 1, 16]] * 2
        assert rec["scratch"] == [1, 64, 1, 16]
        if case == "prefix":
            rows = rec["pool"][0][0]
            assert rec["pool"] == [[rows, 16, 1, 16]] * 2
        else:
            assert rec["pool"] is None


def test_prefix_cache_warm_equals_cold_and_the_reference_engine(setup):
    lead, follow = ranks(setup, "prefix")
    assert lead["result"] == setup["prefix"]
    assert lead["result"][0] == lead["result"][2]       # warm == cold
    assert follower_streams(follow) == follower_streams(lead)
    want = setup["prefix_stats"]
    got = lead["stats"]
    # the reference's page count over the whole model's page bytes
    for key in ("pages", "free", "in_use", "hbm_pages", "host_pages",
                "spills_total", "faults_total", "page_size",
                "page_nbytes"):
        assert got["kv_pool"][key] == want["kv_pool"][key], key
    for key in ("pages", "nodes", "covered_tokens", "max_pages"):
        assert got["prefix_cache"][key] == want["prefix_cache"][key], key


def test_ngram_speculation_is_token_identical(setup):
    lead, follow = ranks(setup, "spec")
    assert lead["result"] == setup["spec"]
    assert lead["stats"]["speculative"]["rounds"] > 0
    assert follower_streams(follow) == follower_streams(lead)


def test_staggered_submits_from_two_threads(setup):
    lead, follow = ranks(setup, "lockstep")
    assert lead["result"]["staggered"] == setup["staggered"]
    assert follower_streams(follow) == follower_streams(lead)


@pytest.mark.parametrize("row, outcome", [("cancel", "cancelled"),
                                          ("deadline", "deadline_exceeded")])
def test_rank_zero_verdicts_reach_the_follower(setup, row, outcome):
    lead, follow = ranks(setup, "lockstep")
    res = (lead["result"]["cancel"]["a"] if row == "cancel"
           else lead["result"]["deadline"])
    assert res["outcome"] == outcome
    assert 0 < res["generated"] < 50            # died mid-stream
    ended = {s["seq"]: s for s in follow["streams"]}
    mine = {s["seq"]: s for s in lead["streams"]}
    dead = [seq for seq, s in mine.items() if s["outcome"] == outcome]
    assert len(dead) == 1
    assert ended[dead[0]]["outcome"] == outcome
    assert ended[dead[0]]["ids"] == mine[dead[0]]["ids"]
    if row == "cancel":
        assert lead["result"]["cancel"]["b"] == setup["b30"]
        assert lead["result"]["cancel"]["c"] == setup["staggered"][0]


def test_an_idle_gang_keeps_its_followers(setup):
    lead, follow = ranks(setup, "lockstep")
    # one record per heartbeat while idle, and the follower served on
    assert lead["result"]["idle_records"] >= int(IDLE_S / HEARTBEAT_S) - 2
    assert lead["result"]["after_idle"] == setup["after_idle"]
    assert follow["tally"]["records"] == lead["tally"]["records"]
    assert follow["streams"][-1]["ids"] == setup["after_idle"]


def test_ep2_on_the_moe_model_matches_the_reference(setup):
    lead, follow = ranks(setup, "ep2")
    assert lead["result"] == setup["moe_solo"]
    assert follower_streams(follow) == follower_streams(lead)
    for ep, rec in enumerate((lead, follow)):
        # 2 experts over ep = 2: one each; the router stays whole
        assert rec["blocks"]["layers.0.moe.w_in"]["ep"] == [0, 2, ep]
        assert rec["blocks"]["layers.0.moe.w_in"]["shape"] == [1, 64, 128]
        assert rec["blocks"]["layers.0.moe.router.kernel"]["ep"] is None
        assert rec["view"] == [[2, 64, 2, 16]] * 2      # heads whole


def test_int8_moe_at_ep2_matches_the_reference(setup):
    """int8 weights under ep (the reference serves them): the int8 MoE
    gang decodes the reference's one-chip int8 stream, every rank
    alike."""
    lead, follow = ranks(setup, "ep2_int8")
    assert lead["result"] == setup["moe_int8_solo"]
    assert follower_streams(follow) == follower_streams(lead)


def test_int8_moe_at_ep2_blocks_are_the_reference_shards(setup):
    for ep, rec in enumerate(ranks(setup, "ep2_int8")):
        assert int8_mismatches(rec["blocks"], setup["ep2_int8"], 0, ep) == []
        w_in = rec["blocks"]["layers.0.moe.w_in"]
        # one expert a rank: q [1, d, f], its scale [1, 1, f]
        assert w_in["ep"] == [0, 2, ep]
        assert w_in["q"] == [1, 64, 128] and w_in["scale"] == [1, 1, 128]


@pytest.mark.parametrize("case, kind, message", [
    ("tp8", "ValueError", "num_kv_heads=2 not divisible by tp=8"),
    ("ep_dense", "ValueError", "ep=2 needs a MoE model"),
    ("ep4", "ValueError", "ep=4 needs a MoE model whose moe_experts "
                          "divides by it (got moe_experts=2)"),
    # a role under tp serves now (test_torch_disagg_gang.py): the case
    # keeps its id and checks that the predictor starts on every rank
    pytest.param("role", None, None,
                 id="role-NotImplementedError-ROADMAP queue A item 7c"),
    ("directory", "NotImplementedError", "ROADMAP queue A item 7c-ii-b")])
def test_refusals_carry_the_reference_messages(setup, case, kind, message):
    from kubeflow_tpu.serving.predictor import GenerativePredictor

    for o in gang(setup, "tp2"):
        if kind is None:
            assert o["refusals"][case] is None
            continue
        got_kind, got = o["refusals"][case]
        assert got_kind == kind and message in got, (case, got)
    # the reference's own messages, where it refuses the same
    if case in ("tp8", "ep_dense", "ep4"):
        kw = ({"ep": 2} if case == "ep_dense" else {"tp": 8}
              if case == "tp8" else {"ep": 4, "model_config": {
                  "moe_experts": 2, "moe_every": 2}})
        with pytest.raises(ValueError,
                           match="divisible" if case == "tp8" else "MoE"):
            GenerativePredictor("llama", size="tiny", max_batch=2,
                                max_seq=64, **kw)


@pytest.mark.parametrize("what", ["park", "pages", "restart", "submit"])
def test_gang_only_refusals(setup, what):
    lead, follow = ranks(setup, "dense")
    if what == "submit":
        assert "rank 1 of a serving gang takes no requests" in \
            follow["refused"]["submit"]
        return
    if what == "park":
        # park is served on a gang now (test_torch_predictor_residency.py),
        # and so is the handoff: a prefill gang with no decode peer
        # resumes it on every rank, to the reference's stream
        assert lead["refused"]["park"] is None
        lead_h, follow_h = ranks(setup, "handoff")
        assert lead_h["result"] == setup["solo"]
        assert lead_h["stats"]["handoffs"] == lead_h["stats"]["resumed"] == 1
        assert follower_streams(follow_h) == follower_streams(lead_h)
        return
    kind, message = lead["refused"][what]
    item = {"pages": "item 7c-ii-b", "restart": "item 7c-ii-c"}[what]
    assert kind == "NotImplementedError" and item in message


def test_a_follower_whose_tokens_differ_raises(setup):
    lead, follow = (o["mismatch"] for o in gang(setup, "tp2"))
    assert "serving gang diverged" in follow["error"]
    # rank 0's next collective fails: its request and later submits
    assert lead["request"]["outcome"] == "error"
    assert lead["error"] == "serving engine crashed"
    assert "serving engine crashed" in lead["later"]


def test_cli_serves_generate_from_rank_zero_of_a_gang():
    import torch

    from kubeflow_tpu_torch.serving.predictor import GenerativePredictor

    prompts, new = [[5, 8, 13, 21], [2, 7]], 6
    lead, follow = cli_gang(prompts, new)
    assert lead["status"] == 200 and lead["rc"] == follow["rc"] == 0
    assert lead["body"]["tokens_generated"] == len(prompts) * new
    # the seeded bf16 model of one process, its row-parallel products
    # summed in halves as tp = 2 sums them (chip_smoke.tp2_partial_sums)
    import chip_smoke

    one = GenerativePredictor("llama", size="tiny", max_seq=64,
                              device="cpu")
    try:
        with torch.no_grad(), chip_smoke.tp2_partial_sums(one.module):
            want = one.generate(prompts, max_new_tokens=new)["ids"]
    finally:
        one.engine.shutdown()
    assert lead["body"]["ids"] == want


@pytest.mark.parametrize("n_ids", [3, 5000])
def test_step_record_round_trip_and_overflow(monkeypatch, n_ids):
    """A step record crosses to a follower whole, its residency and
    handoff commands and its ``:resume`` handoffs (a generator state of
    odd length) included: one broadcast of ``RECORD_WORDS`` words, and a
    second of the exact length when new prompts overflow it (a 5000-token
    prompt)."""
    from kubeflow_tpu_torch.serving import lockstep

    rec = lockstep.StepRecord(
        stop=False, digest=(1 << 55) + 3,
        dead=[(4, "cancelled"), (9, "deadline_exceeded")],
        new=[lockstep.NewRequest(10, list(range(1, n_ids + 1)), 7, 0.8,
                                 None, 1234, 5, 0.9, True, "team-ä"),
             lockstep.NewRequest(11, [2, 3], 1, 0.0, 2, 0, 0, 0.0, False,
                                 "anonymous")],
        commands=[("park", 7), ("warm", 0), ("reclaim", 1575),
                  ("release", 12), ("resume", 13)],
        handoffs=[lockstep.Handoff(list(range(3, n_ids + 3)), 16, 1.1, None,
                                   5, 20, 0.0, True, 42, 94,
                                   bytes(range(256)) * 19 + b"\x01"),
                  lockstep.Handoff([9, 8], 4, 0.0, 7, 0, 0, 0.0, False, 3,
                                   1, b"")])
    sent = []

    def leader_broadcast(buf, group=None):
        sent.append(buf.clone())
        return buf

    monkeypatch.setattr(lockstep.pd, "broadcast_one_to_all",
                        leader_broadcast)
    tally = {}
    assert lockstep.exchange(rec, tally) is rec
    assert tally["calls"] == (1 if n_ids < lockstep.RECORD_WORDS else 2)
    assert [t.shape[0] for t in sent][0] == lockstep.RECORD_WORDS
    received = iter(sent)
    monkeypatch.setattr(lockstep.pd, "broadcast_one_to_all",
                        lambda buf, group=None: next(received))
    assert lockstep.exchange(None) == rec
