"""MoE training of the PyTorch port under tp and sp, and lamb on a mesh:
the 2-process gloo gang on the CPU.

The reference lays the MoE block's weights by its rules ("expert" over
ep, "mlp" over tp: ``w_in`` column-, ``w_out`` row-parallel) and routes
over the assembled ``[B, S]`` batch, b-major, whatever the mesh.  The
port's block (``models/moe.py``) runs its ``f / tp`` columns of the
experts on the capacity buffer every tp rank shares and sums each (token,
choice)'s ungated output once over the weights' group; under sp it orders
its chunks' assignments by (data rank, row, chunk) from per-row counts
gathered over the sp group.  One gang of 2 (``spawn_local_gang``) runs,
in turn:

- the block of ``test_torch_moe_ep.py`` (hidden 32, 4 experts, a skewed
  router, capacity factor 0.75: both choices overflow) at tp=2 and at
  sp=2 on its rows and chunks of the seeded 4 x 8 global batch: y, aux,
  the input gradient and every parameter gradient, the router's
  included, within 1e-5 of max |ref| of ``jax.grad`` of the reference's
  block on the global batch, the dropped counts equal.  Two teeth: sp
  with each rank's chunks taken as one rank-major block of the priority
  order, and tp summing the gated partials (as the dropless forward
  does), each miss the reference by more than 100 x 1e-5 (the second in
  the router's gradient);
- the tiny MoE Llama (``llama_tiny`` widths, 4 experts on every second
  layer, float32), three momentum-sgd steps of ``build_train_step`` at
  tp=2 and at sp=2 (``sequence_keys``): every step within 1e-5 of one
  process on the rank-major global batch, ranks bitwise equal, every MoE
  layer's dropped count equal, and the checkpoint saved at tp=2 restored
  bitwise by one process;
- lamb: its update with fixed gradients on the blocks of fsdp=2, tp=2 and
  ep=2 within 1e-6 of the whole tensors' update (float64; the blocks' own
  norms miss by far more); one lamb step (lr 10) of the MoE Llama at ep=2:
  the expert blocks' update within 1e-6 of one process's (the parent
  tree took the blocks' own norms there), the rest within 1e-5; three steps of the tiny dense Llama at fsdp=2 and at tp=2
  against the reference's ``optax.lamb`` step, and of the MoE Llama at
  ep=2 against one process.  Multi-step lamb holds step 0's loss at 1e-5
  and step k's at 3e-5 x 1.2^(k-1) (ROADMAP queue C item 13: adam's first
  update turns rounding-level gradient differences into lr-sized steps).

The 4-process gang is ``test_torch_moe_tp_sp_four.py``.
"""

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from kubeflow_tpu.models import registry as jreg
from kubeflow_tpu.parallel import make_mesh
from kubeflow_tpu.parallel import train_step as jts
from kubeflow_tpu.training import optim as joptim
from kubeflow_tpu_torch.parallel import train_step as tts
from kubeflow_tpu_torch.training import optim as toptim
from kubeflow_tpu_torch.training.checkpoint import CheckpointManager
from torch_moe_ep_gangs import (  # noqa: F401  (setup: a fixture)
    LAMB, LAMB_ONE, SEQ, STEPS, TOL, assert_trails_close, block_errors, check_block,
    dense_llama, gang, one_process, port_llama, rank_major_batches, rel,
    setup)

BLOCKS = {"tp2": {"tp": 2}, "sp2": {"sp": 2},
          "sp2_rank_major": {"sp": 2, "rank_major": True},
          "tp2_gated": {"tp": 2, "gated_partials": True}}
LLAMA = {"tp2": {"tp": 2, "accum": 1, "save": True},
         "sp2": {"sp": 2, "accum": 1},
         "ep2_lamb_one": {"ep": 2, "accum": 1, "opt": LAMB_ONE, "steps": 1},
         "ep2_lamb": {"ep": 2, "accum": 1, "opt": LAMB},
         "fsdp2_lamb": {"fsdp": 2, "accum": 1, "opt": LAMB, "dense": True},
         "tp2_lamb": {"tp": 2, "accum": 1, "opt": LAMB, "dense": True}}
LAMB_BLOCKS = {"fsdp2": {"fsdp": 2}, "tp2": {"tp": 2}, "ep2": {"ep": 2}}
# blockwise lamb against the whole tensors' update, relative to max |ref|
# of each tensor's update
LAMB_TOL = 1e-6


def two(setup) -> list[dict]:
    dense_llama(setup)
    return gang(setup, 2, BLOCKS, LLAMA, lamb_blocks=LAMB_BLOCKS)


def lamb_tol(k: int) -> float:
    """Relative tolerance of multi-step lamb's step ``k`` (module
    docstring)."""
    return TOL if k == 0 else 3e-5 * 1.2 ** (k - 1)


def assert_lamb_trails_close(got, want):
    for k, ((gl, gn), (wl, wn)) in enumerate(zip(got, want, strict=True)):
        assert abs(gl - wl) <= lamb_tol(k) * abs(wl), (k, got, want)
        assert abs(gn - wn) <= lamb_tol(k) * abs(wn), (k, got, want)


@pytest.mark.parametrize("layout", ["tp2", "sp2"])
def test_moe_block_matches_the_reference_on_the_global_batch(setup, layout):
    outs = two(setup)
    for r, o in enumerate(outs):
        assert o["rdv"]["process_id"] == r and o["rdv"]["backend"] == "gloo"
    check_block(setup, layout, 2)


def test_sp_chunks_taken_as_rank_major_blocks_miss_the_reference(setup):
    """Each rank's chunks routed as one contiguous block of the priority
    order (the data-parallel rule, with sp's group as the data group):
    other positions, other drops."""
    two(setup)
    for e in block_errors(setup, "sp2_rank_major", 2):
        assert e["y"] > 100 * TOL, e


def test_tp_summing_gated_partials_misses_the_router_gradient(setup):
    """The gated ``[T, D]`` partials summed over tp: the forward is the
    same, but each rank keeps a partial share of the gates' gradient, so
    the router's gradient (and the input's through it) is off."""
    two(setup)
    for e in block_errors(setup, "tp2_gated", 2):
        assert e["y"] <= TOL, e
        assert e["router.kernel"] > 100 * TOL, e


@pytest.mark.parametrize("case", ["tp2", "sp2"])
def test_moe_llama_trains_what_one_process_trains(setup, case):
    outs = two(setup)
    trails = [o["trails"][case] for o in outs]
    assert trails[1] == trails[0], "ranks disagree"          # bitwise
    want, dropped, final = one_process(setup, 1)
    assert_trails_close(trails[0], want)
    assert all(o["dropped"][case] == dropped for o in outs)
    got = torch.load(setup["root"] / f"llama-{case}.pt", weights_only=True)
    assert got.keys() == final.keys()
    for key, p in final.items():
        assert rel(got[key], p) <= TOL, key


def test_a_checkpoint_saved_at_tp2_restores_bitwise_into_one_process(setup):
    two(setup)
    root = setup["root"]
    blob = torch.load(root / "ckpt-tp2" / f"ckpt-{STEPS}.pt",
                      weights_only=True)
    gathered = torch.load(root / "llama-tp2.pt", weights_only=True)
    model = port_llama(torch.load(root / "llama.pt", weights_only=True))
    state = tts.init_train_state(model, toptim.make_optimizer(
        {"name": "sgd", "learning_rate": 1e-2, "momentum": 0.9}))
    state = CheckpointManager(str(root / "ckpt-tp2")).restore(state)
    assert state.step == STEPS
    for key, p in model.state_dict().items():
        assert torch.equal(p, gathered[key]), key
    for key, moments in blob["optimizer"]["moments"].items():
        for m, w in zip(state.tx.moments[key], moments, strict=True):
            assert torch.equal(m, w)


@pytest.mark.parametrize("layout", list(LAMB_BLOCKS))
def test_blockwise_lamb_update_matches_the_whole_tensors(setup, layout):
    outs = two(setup)
    for o in outs:
        errs = o["lamb_blocks"][layout]
        assert errs["whole"] <= LAMB_TOL, errs
        # the blocks' own norms: another trust ratio on every split tensor
        assert errs["blocks"] > 1000 * LAMB_TOL, errs


def test_one_lamb_step_at_ep2_updates_what_one_process_updates(setup):
    """The expert blocks' trust ratios are the whole tensors': their
    updates within 1e-6 of one process's (with each block's own norms,
    the parent tree's, 4.1e-04 for ``w_in``).  Every other tensor is whole
    on each rank; its update within 1e-5, since one process takes its
    norms in float32, which drift on the CPU (5.9e-07 for the embedding
    here; ``training/optim.py::sum_of_squares``)."""
    two(setup)
    root = setup["root"]
    start = torch.load(root / "llama.pt", weights_only=True)
    got = torch.load(root / "llama-ep2_lamb_one.pt", weights_only=True)
    _, _, want = one_process(setup, 1, opt=LAMB_ONE, steps=1)
    for key, w in want.items():
        tol = LAMB_TOL if key.endswith(("moe.w_in", "moe.w_out")) else TOL
        assert rel(got[key] - start[key], w - start[key]) <= tol, key


def test_lamb_at_ep2_trains_what_one_process_trains(setup):
    outs = two(setup)
    trails = [o["trails"]["ep2_lamb"] for o in outs]
    assert trails[1] == trails[0], "ranks disagree"          # bitwise
    want, dropped, _ = one_process(setup, 1, opt=LAMB)
    assert_lamb_trails_close(trails[0], want)
    assert outs[0]["dropped"]["ep2_lamb"][0] == dropped[0]


def reference_lamb_trail(setup) -> list[tuple[float, float]]:
    """The reference's ``build_train_step`` with ``optax.lamb`` on the tiny
    dense Llama, on a (dp 1, fsdp 2) mesh of the conftest's host devices,
    fed the 2 data ranks' rank-major global batches (once per module)."""
    if "lamb_reference" in setup:
        return setup["lamb_reference"]
    module, params = dense_llama(setup)
    entry = jreg.get("llama")
    mesh = make_mesh(2, dp=1, fsdp=2)
    tx = joptim.make_optimizer(LAMB)
    state, shardings = jts.init_train_state(
        module, tx, jax.random.PRNGKey(0),
        (jnp.zeros((4, SEQ), jnp.int32),), mesh)
    jparams = jax.tree.map(jnp.asarray, params)
    state = state.replace(params=jparams, opt_state=tx.init(jparams))
    batches = rank_major_batches(setup["root"], 2)
    bs = {k: NamedSharding(mesh, P(("dp", "fsdp"))) for k in batches[0]}
    step = jts.build_train_step(
        lambda p, b: entry.forward_loss(module, p, b), tx, mesh, shardings,
        bs, donate=False)
    trail = []
    with mesh:
        for nb in batches:
            state, m = step(state, jax.device_put(
                {k: jnp.asarray(v.numpy()) for k, v in nb.items()}, bs))
            trail.append((float(m["loss"]), float(m["grad_norm"])))
    setup["lamb_reference"] = trail
    return trail


@pytest.mark.parametrize("case", ["fsdp2_lamb", "tp2_lamb"])
def test_lamb_on_a_mesh_trains_the_dense_llama_as_the_reference(setup, case):
    """tp=2 reads the file's rows in order, the reference the 2 data
    ranks' rank-major rows: the same rows of a mean loss, summed in
    another order."""
    outs = two(setup)
    trails = [o["trails"][case] for o in outs]
    assert trails[1] == trails[0], "ranks disagree"          # bitwise
    assert_lamb_trails_close(trails[0], reference_lamb_trail(setup))
