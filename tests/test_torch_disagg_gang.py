"""Disaggregated prefill and decode on a tp / ep serving gang: one gang of
2 on the CPU over gloo (``torch_disagg_gangs.py``).

A tp=2 prefill gang hands each prompt to a tp=2 decode gang through the
``handoff_post`` seam: its tp group gathers the pages' KV heads to rank 0
inside the step, and rank 0 serializes the one-process body; the decode
gang's rank 0 checks the body against the whole model's heads and passes
its pages on in the next step record, each rank keeping its own heads.
Held to the reference (the JAX package's predictors, one process over
XLA host devices; the tiny Llama in float32, its seed-0 weights carried
across by ``convert.from_jax_params``):

- greedy streams token-identical to the reference's tp=2 prefill and
  decode pair and to its tp=2 colocated predictor;
- a seeded stream identical to the port's own colocated tp=2 stream (the
  generator's state rides the body and the step record);
- the gang's body resumes on a one-process reference decode predictor,
  and one-process reference prefill bodies resume on the decode gangs
  (the tiny MoE's at ep=2), with the reference's streams;
- with no decode peer, or a dead one, every rank resumes the pages it
  holds (a ``resume`` command);
- after every request both ranks' page pools are equal (statistics and
  page ids in use), and no page is left held or orphaned;
- a malformed ``:resume`` answers 422 on rank 0 and never reaches a
  step record;
- when the leader's page broadcast raises (a dead follower), every
  ``:resume`` of that record fails at once with "serving engine
  crashed", not after its 600 s wait.

Tokens are compared exactly; the page pools' statistics and ids exactly.
"""

import pytest

from torch_disagg_gangs import (  # noqa: F401  (reference: a fixture)
    LONG, MALFORMED, RAGGED, disagg_gang, reference)


def lead(reference) -> dict:
    out = disagg_gang(reference)[0]
    assert out.get("error") is None, out["error"]
    return out["result"]


def test_every_model_has_its_own_group_and_the_follower_ran_clean(
        reference):
    leader, follower = disagg_gang(reference)
    assert leader["own_groups"] and follower["own_groups"]
    # only X, whose gang the last test breaks, ended in an error
    assert list(follower["errors"]) == ["X"]


def test_greedy_streams_equal_the_reference_pair_and_tp2_colocated(
        reference):
    res = lead(reference)
    assert res["greedy"] == reference["pair"] == reference["tp2"]
    assert res["greedy"] == reference["one"]
    assert res["colocated"] == res["greedy"]
    assert res["long"] == reference["long"]
    # every row crossed the seam once, as one body per request
    assert len(res["greedy_bodies"]) == len(RAGGED)


def test_seeded_stream_equals_the_colocated_gang_stream(reference):
    res = lead(reference)
    assert res["seeded"] == res["seeded_colocated"]
    assert res["seeded"] != res["colocated"]           # it sampled
    assert res["seeded_gen_state"] == [True, True]


def test_gang_body_is_the_one_process_body_shape(reference):
    """The gang's body carries every KV head (the wire of a one-process
    prefill): 3 pages of 2 layers, k and v at [16, 2, 16] float32."""
    body = lead(reference)["long_body"]
    assert len(body["pages"]) == 3 and body["ids"] == LONG
    for page in body["pages"]:
        assert len(page) == 2
        for layer in page:
            assert set(layer) == {"k", "v"}
            for enc in layer.values():
                assert enc["shape"] == [16, 2, 16]
                assert enc["dtype"] == "float32"
    ref_body = reference["ref_body"]
    assert {k for k in body} >= {k for k in ref_body if k != "traceparent"}


def test_gang_body_resumes_on_a_one_process_reference_decode(reference):
    import copy

    body = copy.deepcopy(lead(reference)["long_body"])
    got = reference["decode"].resume(body)["ids"]
    assert got == reference["long"][0]


def test_reference_bodies_resume_on_the_decode_gangs(reference):
    res = lead(reference)
    assert res["ref_body"]["ids"] == reference["ref_body_ids"]
    assert res["ref_body"]["ids"] == reference["long"][0]
    # the tiny MoE at ep=2: its heads whole on each rank
    assert res["moe_body"]["ids"] == reference["moe_body_ids"]
    assert res["moe_body"]["ids"] == reference["moe_long"][0]


@pytest.mark.parametrize("case", ["no_peer", "dead_peer"])
def test_fallback_resumes_on_the_prefill_gang(reference, case):
    res = lead(reference)
    want = reference["one"] if case == "no_peer" else reference["long"]
    assert res[case] == want
    # the prefill gang resumed every row it could not forward, on both
    # ranks: one ``resume`` command each
    resumes = [[e for e in o["events"]["P"] if e[0] == "resume"]
               for o in disagg_gang(reference)]
    assert len(resumes[0]) == len(RAGGED) + 1
    assert resumes[0] == resumes[1]


@pytest.mark.parametrize("model", ["P", "D", "M", "C"])
def test_both_ranks_pools_are_equal_after_every_request(reference, model):
    leader, follower = disagg_gang(reference)
    mine, theirs = leader["events"][model], follower["events"][model]
    assert mine and mine == theirs
    stats, used = mine[-1][3], mine[-1][4]
    # nothing held, nothing orphaned once the traffic is over
    assert used == [] and stats["in_use"] == 0
    assert leader["held"][model] == follower["held"][model] == 0
    if model == "P":
        kinds = [e[0] for e in mine]
        # the forwarded rows released on every rank, the rest resumed
        assert kinds.count("release") == 2 * len(RAGGED) + 1


@pytest.mark.parametrize("case", MALFORMED)
def test_a_malformed_resume_answers_422_and_followers_never_see_it(
        reference, case):
    res = lead(reference)
    status, body = res["malformed"][MALFORMED.index(case)]
    assert status == 422, body
    # the good body after them still resumes, to the reference's stream
    status, ids, nbytes = res["after_malformed"]
    assert status == 200 and ids == reference["long"][0]
    assert nbytes > 0
    # D took exactly the good handoffs (the greedy, long and seeded rows,
    # the reference body twice), alike on both ranks
    leader, follower = disagg_gang(reference)
    good = 2 * len(RAGGED) + 1 + 2
    assert leader["tally"]["D"]["page_calls"] == good
    assert follower["tally"]["D"]["page_calls"] == good


def test_a_coordinator_over_a_sharded_model_is_refused_by_name():
    """The in-process ``DisaggCoordinator`` takes no gang's shard: its
    failover (``adopt``) and ``restart`` wait for item 7c-ii-c."""
    from kubeflow_tpu_torch.models import llama as tl
    from kubeflow_tpu_torch.parallel.sharding import Split
    from kubeflow_tpu_torch.serving.disagg import DisaggCoordinator

    model = tl.LlamaModel(tl.llama_tiny(dtype="float32"), device="cpu")
    weight = next(model.parameters())
    weight.tp_split = Split("tp", None, 0, 2, 0)
    with pytest.raises(NotImplementedError, match="item 7c-ii-c"):
        DisaggCoordinator(model, model.config, max_batch=2, max_seq=64,
                          page_size=16)


def test_a_resume_fails_at_once_when_the_page_broadcast_raises(reference):
    """Two ``:resume`` requests ride one record of X; the leader's first
    page broadcast raises, as gloo does when a follower died.  Both
    requests leave ``_pending`` before the broadcast: the crash path
    must still fail them, the second one too."""
    crash = lead(reference)["crash"]
    assert crash["entries"] == [2]
    for got in crash["requests"]:
        assert got is not None, "a :resume still waits"
        seconds, error = got
        assert error is not None and "serving engine crashed" in error
        assert seconds < 30
    # the follower's X saw the record, then its peer go
    follower = disagg_gang(reference)[1]
    assert "Connection closed" in follower["errors"]["X"]
