"""The predictor's ``tp=2`` x ``ep=2`` on the PyTorch port: a gang of 4
on the CPU over gloo.

The reference's ``test_moe_experts_shard_over_ep``: the tiny MoE Llama (2
GELU experts on every second layer) served by a tp=2 x ep=2 gang decodes
token-identical to the reference's one-chip predictor, solo and as a
ragged pair, every rank alike; each rank holds its expert over ep and its
FFN columns over tp, the router whole, and its KV heads.  In int8 the
same gang decodes the reference's one-chip int8 stream, and each rank's
``q`` and ``scale`` blocks are bitwise its shard of the reference's
tp=2 x ep=2 placement.  Shared parts in
``torch_predictor_gangs.py``.
"""

from torch_predictor_gangs import (  # noqa: F401  (setup: a fixture)
    gang, int8_mismatches, setup)


def test_tp2_ep2_moe_decode_matches_the_reference(setup):
    outs = gang(setup, "moe")
    lead = outs[0]["tp2_ep2"]
    assert lead["result"]["solo"] == setup["moe_solo"]
    assert lead["result"]["pair"] == setup["moe_pair"]
    for o in outs[1:]:
        assert [s["ids"] for s in o["tp2_ep2"]["streams"]] == [
            s["ids"] for s in lead["streams"]]


def test_tp2_ep2_each_rank_holds_its_expert_and_columns(setup):
    outs = gang(setup, "moe")
    # the mesh's axis order puts ep last: rank = 2 * tp + ep
    assert [o["coords"] for o in outs] == [[0, 0], [0, 1], [1, 0], [1, 1]]
    for o in outs:
        tp, ep = o["coords"]
        blocks = o["tp2_ep2"]["blocks"]
        w_in, w_out = blocks["layers.0.moe.w_in"], blocks["layers.0.moe.w_out"]
        assert w_in["ep"] == [0, 2, ep] and w_in["tp"] == [2, 2, tp]
        assert w_out["ep"] == [0, 2, ep] and w_out["tp"] == [1, 2, tp]
        assert w_in["shape"] == [1, 64, 64] and w_out["shape"] == [1, 64, 64]
        assert blocks["layers.0.moe.router.kernel"]["ep"] is None
        assert blocks["layers.0.moe.router.kernel"]["tp"] is None
        assert blocks["layers.1.down.kernel"]["tp"] == [0, 2, tp]
        assert o["tp2_ep2"]["view"] == [[2, 64, 1, 16]] * 2


def test_tp2_ep2_int8_moe_matches_the_reference(setup):
    outs = gang(setup, "moe")
    lead = outs[0]["tp2_ep2_int8"]
    assert lead["result"] == setup["moe_int8_solo"]
    for o in outs[1:]:
        assert [s["ids"] for s in o["tp2_ep2_int8"]["streams"]] == [
            s["ids"] for s in lead["streams"]]


def test_tp2_ep2_int8_blocks_are_the_reference_shards(setup):
    for o in gang(setup, "moe"):
        tp, ep = o["coords"]
        blocks = o["tp2_ep2_int8"]["blocks"]
        assert int8_mismatches(blocks, setup["tp2_ep2_int8"], tp, ep) == []
        w_in = blocks["layers.0.moe.w_in"]
        assert w_in["ep"] == [0, 2, ep] and w_in["tp"] == [2, 2, tp]
        assert w_in["q"] == [1, 64, 64] and w_in["scale"] == [1, 1, 64]
