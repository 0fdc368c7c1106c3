"""MoE training of the PyTorch port under tp x ep, tp x sp and dp x sp,
and lamb on fsdp x tp: the 4-process gloo gang on the CPU
(``test_torch_moe_tp_sp.py`` says what each is held to).

- The block at tp=2 x ep=2 (each rank two experts at half their columns,
  the chosen outputs summed over the joint tp x ep group) and at dp=2 x
  sp=2 (each rank two rows' chunks; per-row counts over the sp group,
  the data ranks' totals over the data group): within 1e-5 of max |ref|
  of ``jax.grad`` of the reference's block on the global batch.
- The tiny MoE Llama, three momentum-sgd steps of ``build_train_step`` at
  tp=2 x sp=2 and at dp=2 x sp=2 with ``grad_accum`` 1 and 2 (under 2,
  each data rank holds one whole micro-batch and runs an uncounted
  stand-in for the other, on both of its sp ranks): within 1e-5 of one
  process on the rank-major global batch, ranks bitwise equal, every MoE
  layer's dropped count one process's.
- lamb's update with fixed gradients on the blocks of fsdp=2 x tp=2
  within 1e-6 of the whole tensors' update.
"""

import pytest

from torch_moe_ep_gangs import (  # noqa: F401  (setup: a fixture)
    assert_trails_close, check_block, gang, one_process, setup)

BLOCKS = {"tp2_ep2": {"tp": 2, "ep": 2}, "dp2_sp2": {"dp": 2, "sp": 2}}
LLAMA = {"tp2_sp2": {"tp": 2, "sp": 2, "accum": 1},
         "dp2_sp2": {"dp": 2, "sp": 2, "accum": 1},
         "dp2_sp2_accum2": {"dp": 2, "sp": 2, "accum": 2}}
LAMB_BLOCKS = {"fsdp2_tp2": {"fsdp": 2, "tp": 2}}
LAMB_TOL = 1e-6


def four(setup) -> list[dict]:
    return gang(setup, 4, BLOCKS, LLAMA, lamb_blocks=LAMB_BLOCKS)


@pytest.mark.parametrize("layout", list(BLOCKS))
def test_moe_block_matches_the_reference_on_the_global_batch(setup, layout):
    four(setup)
    check_block(setup, layout, 4)


@pytest.mark.parametrize("case", list(LLAMA))
def test_four_process_moe_llama_trains_what_one_process_trains(setup, case):
    outs = four(setup)
    trails = [o["trails"][case] for o in outs]
    want, dropped, _ = one_process(setup, LLAMA[case].get("dp", 1),
                                   LLAMA[case]["accum"])
    for r, o in enumerate(outs):
        assert trails[r] == trails[0], "ranks disagree"     # bitwise
        assert o["dropped"][case] == dropped, r
    assert_trails_close(trails[0], want)


def test_blockwise_lamb_update_matches_the_whole_tensors(setup):
    for o in four(setup):
        errs = o["lamb_blocks"]["fsdp2_tp2"]
        assert errs["whole"] <= LAMB_TOL, errs
        assert errs["blocks"] > 1000 * LAMB_TOL, errs
