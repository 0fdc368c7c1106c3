"""Multi-host serving of the PyTorch port as gloo gangs on the CPU.

The reference's ``tests/test_multihost_serving.py`` across processes: a
4-process dp=2 x tp=2 gang and a 2-process tp=2 gang (the reference's
``GANG_SCRIPT``: rank 0 alone holds the prompts) decode token-identical
to the reference's ``MultiHostPredictor`` and its engine, every rank
alike; each rank's weights, int8 ``q``/``scale`` blocks and KV cache are
its shard of the reference's layout.  The shared parts are in
``torch_multihost_gangs.py``; each gang is spawned once per module.
"""

import numpy as np
import pytest

from torch_multihost_gangs import (  # noqa: F401  (setup: a fixture)
    CFG, GANG_PROMPTS, MAX_SEQ, NEW, PROMPTS, gang, is_int8,
    reference_leaves, setup, sha, shard_at)

# every matmul kernel of a block, and the embedding: the weights tp splits
SPLIT = ("attention.q.kernel", "attention.k.kernel", "attention.v.kernel",
         "attention.o.kernel", "gate.kernel", "up.kernel", "down.kernel")


def test_four_ranks_decode_like_the_reference_and_its_engine(setup):
    outs = gang(setup, "dp2_tp2")
    assert [o["rank"] for o in outs] == [0, 1, 2, 3]
    assert all(o["backend"] == "gloo" for o in outs)
    # tp minor: ranks 0, 1 are dp 0 and ranks 2, 3 are dp 1
    assert [o["coords"] for o in outs] == [[0, 0], [0, 1], [1, 0], [1, 1]]
    assert all(o["ids"] == outs[0]["ids"] for o in outs)
    assert outs[0]["ids"] == setup["ids"] == setup["engine_ids"]


def test_four_ranks_hold_the_reference_shards(setup):
    outs = gang(setup, "dp2_tp2")
    mh = setup["mh"]
    want = reference_leaves(mh)
    for o in outs:
        dp, tp = o["coords"]
        assert set(o["blocks"]) == set(want)
        names = ["tok_embeddings.embedding"] + [
            f"layers.{i}.{k}" for i in range(2) for k in SPLIT]
        for name in names:
            assert o["blocks"][name]["tp"] is not None, name
            assert o["blocks"][name]["tp"][1:] == [2, tp], name
        for name, leaf in want.items():
            shape = list(shard_at(leaf, mh.mesh, dp, tp).shape)
            assert o["blocks"][name]["shape"] == shape, (o["rank"], name)


def test_four_ranks_kv_cache_is_each_ranks_block(setup):
    outs = gang(setup, "dp2_tp2")
    for o in outs:
        # the bucket (4 rows, 8 positions, 8 new) of 2 layers: [B/dp, S,
        # Hkv/tp, D]
        assert o["gen_keys"] == [[4, 8, 8]]
        assert o["cache"] == [[2, 16, 1, 16]] * 4
        assert o["sharded_cache"] == [2, 32, 1, 16]
        assert o["accepts_own"] is True
        assert o["refuses_whole"].startswith("layers.0.k is (4, 32, 2, 16)")


def test_one_row_under_dp2_pads(setup):
    """The reference's ``test_batch_not_divisible_by_dp_pads``."""
    outs = gang(setup, "dp2_tp2")
    assert all(o["pad"] == setup["engine_pad"] for o in outs)


def test_kv_heads_not_divisible_by_tp_is_refused(setup):
    outs = gang(setup, "dp2_tp2")
    assert all(o["kv_heads"] == "num_kv_heads=2 not divisible by tp=4"
               for o in outs)


def test_two_ranks_broadcast_prompts_and_decode(setup):
    """The reference's ``GANG_SCRIPT``: rank 1 passes None to
    ``broadcast_prompts``; both ranks decode rank 0's prompts as the
    reference's engine does."""
    outs = gang(setup, "tp2")
    assert [o["rank"] for o in outs] == [0, 1]
    assert all(o["prompts"] == GANG_PROMPTS for o in outs)
    assert outs[0]["ids"] == outs[1]["ids"] == setup["engine_ids"][:2]


def test_two_ranks_int8_decode_like_the_reference(setup):
    outs = gang(setup, "tp2")
    assert outs[0]["int8_ids"] == outs[1]["int8_ids"] == setup["int8_ids"]
    assert len(outs[0]["int8_ids"][0]) == len(GANG_PROMPTS[0]) + NEW
    for o in outs:
        got = np.asarray(o["int8_logits"])
        want = setup["int8_logits"]
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_two_ranks_int8_blocks_are_the_reference_shards_bitwise(setup):
    """int8 under tp: each rank's ``q`` is its block of the kernel's spec
    and ``scale`` of ``_scale_spec``'s, from a whole-tensor quantization,
    bitwise the reference's shards; a tiny kernel below ``min_size``
    stays float32 and splits as a parameter."""
    outs = gang(setup, "tp2")
    mq = setup["mq"]
    want = reference_leaves(mq)
    int8 = [n for n, leaf in want.items() if is_int8(leaf)]
    assert len(int8) == 10      # q, o, gate, up, down of 2 layers
    for o in outs:
        tp = o["rank"]
        for name, leaf in want.items():
            got = o["blocks"][name]
            if not is_int8(leaf):
                assert "q" not in got, name
                assert got["shape"] == list(
                    shard_at(leaf, mq.mesh, 0, tp).shape), name
                continue
            q = shard_at(leaf.q, mq.mesh, 0, tp)
            scale = shard_at(leaf.scale, mq.mesh, 0, tp)
            assert got["tp"][1:] == [2, tp], name
            assert (got["q"], got["scale"]) == (list(q.shape),
                                                list(scale.shape)), name
            assert got["q_sha"] == sha(q) and got["scale_sha"] == sha(
                scale), name


def test_shard_params_of_a_whole_int8_model_is_the_predictors_placement(
        setup):
    """``sharded.shard_params`` on a whole model quantized in one piece
    gives each rank the blocks the predictor's one-weight-at-a-time
    loader keeps."""
    for o in gang(setup, "tp2"):
        assert o["shard_params_blocks"] == o["blocks"]


@pytest.mark.parametrize("name, scale_split", [
    ("layers.0.attention.q.kernel", True),   # column: scale split too
    ("layers.0.attention.o.kernel", False),  # row: the scale stays whole
    ("layers.1.down.kernel", False),
    ("layers.1.up.kernel", True)])
def test_two_ranks_int8_scale_follows_scale_spec(setup, name, scale_split):
    outs = gang(setup, "tp2")
    leaf = reference_leaves(setup["mq"])[name]
    for o in outs:
        got = o["blocks"][name]
        whole = list(leaf.scale.shape)
        assert (got["scale"] != whole) == scale_split, (name, got["scale"])


def test_two_ranks_bf16_logits_are_one_process_with_bf16_partial_sums(
        setup):
    """In bf16, tp = 2 changes the logits only where it sums each
    row-parallel product's two halves in bf16: one process computing those
    products so (``chip_smoke.tp2_partial_sums``, the card's diagnosis of
    the same gap) gives both ranks' first-token logits bitwise, while its
    plain forward does not."""
    import torch

    import chip_smoke
    from kubeflow_tpu_torch.serving.multihost import MultiHostPredictor

    outs = gang(setup, "tp2")
    mh = MultiHostPredictor("llama", size="tiny", max_seq=MAX_SEQ,
                            model_config={**CFG, "dtype": "bfloat16"},
                            device="cpu")
    mh.generate(GANG_PROMPTS, max_new_tokens=1)
    one = mh.prefill_logits.float().clone()
    with chip_smoke.tp2_partial_sums(mh.module) as patched:
        mh.generate(GANG_PROMPTS, max_new_tokens=1)
    emulated = mh.prefill_logits.float()
    assert len(patched) == 4          # attention.o and down of 2 layers
    for o in outs:
        got = torch.tensor(o["bf16_logits"])
        assert torch.equal(got, emulated), o["rank"]
        assert not torch.equal(got, one)
