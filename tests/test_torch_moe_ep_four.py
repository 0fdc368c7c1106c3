"""MoE training of the PyTorch port under dp x ep and fsdp x ep: the
4-process gloo gang on the CPU.

- The block at dp=2 x ep=2 (``test_torch_moe_ep.py`` says what it is
  held to): each data rank's rows, each ep rank's two experts.
- The tiny MoE Llama, three momentum-sgd steps of ``build_train_step``
  from the reference's init, against the reference's
  ``build_train_step`` on ``make_mesh(4, dp=2, ep=2)`` (the conftest's
  host devices) fed the same rank-major global batches: loss and
  grad_norm of every step within 1e-5, ranks bitwise equal, at dp=2 x
  ep=2 with ``grad_accum`` 1 and 2 (under 2, each data rank holds one
  whole micro-batch and runs an uncounted stand-in for the other, so
  the counts gather still runs once per global micro-batch on every
  rank), and at fsdp=2 x ep=2 (the expert weights split on both axes,
  gathered over fsdp on read).
- A one-process checkpoint restored into the fsdp=2 x ep=2 layout: every
  parameter and moment bitwise its block of the file.
"""

import pytest

from torch_moe_ep_gangs import (  # noqa: F401  (setup: a fixture)
    assert_trails_close, check_block, gang, reference_trail, setup)

BLOCKS = {"dp2_ep2": {"dp": 2, "ep": 2}}
LLAMA = {"dp2_ep2": {"dp": 2, "ep": 2, "accum": 1},
         "dp2_ep2_accum2": {"dp": 2, "ep": 2, "accum": 2},
         "fsdp2_ep2": {"dp": 1, "fsdp": 2, "ep": 2, "accum": 1}}


def four(setup) -> list[dict]:
    llama = {**LLAMA, "fsdp2_ep2": {
        **LLAMA["fsdp2_ep2"], "restore": str(setup["root"] / "ckpt-one")}}
    return gang(setup, 4, BLOCKS, llama)


def test_moe_block_matches_the_reference_on_the_global_batch(setup):
    four(setup)
    check_block(setup, "dp2_ep2", 4)


@pytest.mark.parametrize("case", list(LLAMA))
def test_four_process_moe_llama_matches_the_reference_sharded_step(
        setup, case):
    outs = four(setup)
    trails = [o["trails"][case] for o in outs]
    for r, o in enumerate(outs):
        assert trails[r] == trails[0], "ranks disagree"     # bitwise
        assert o["dropped"][case] == outs[0]["dropped"][case]
    assert_trails_close(trails[0], reference_trail(setup, LLAMA[case]["accum"]))


def test_a_one_process_checkpoint_restores_as_fsdp_ep_blocks(setup):
    outs = four(setup)
    assert all(o["restored_blocks_equal"] for o in outs)
    assert outs[0]["ep_split"] == ["layers.0.moe.w_in", "layers.0.moe.w_out"]
