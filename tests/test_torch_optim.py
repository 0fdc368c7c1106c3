"""Optimizers and schedules of the PyTorch port against optax.

The same float32 parameters and gradients (numpy, seeded) go through the
reference's ``make_optimizer`` (optax) and the port's, for 5 updates; one
parameter always gets a zero gradient, so weight decay acts on it alone.
Tolerance: parameters within 1e-6 of max |p| after every update (float32;
the schedule and bias corrections are computed in float64 on the port's
side and in float32 by optax).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeflow_tpu.training import optim as joptim
from kubeflow_tpu_torch.training import optim as toptim

SHAPES = [(4, 3), (7,), (2, 2, 2)]     # the last one's gradient is zero
SCHEDULES = [
    {"schedule": "constant"},
    {"schedule": "cosine", "warmup_steps": 2, "total_steps": 6,
     "end_lr": 0.01},
    {"schedule": "linear", "warmup_steps": 2, "total_steps": 6},
]


def run_both(cfg, updates=5, seed=0):
    rng = np.random.default_rng(seed)
    params = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[rng.standard_normal(s).astype(np.float32) * (i + 1)
              if j < len(SHAPES) - 1 else np.zeros(s, np.float32)
              for j, s in enumerate(SHAPES)] for i in range(updates)]
    tx = joptim.make_optimizer(cfg)
    jp = [jnp.asarray(p) for p in params]
    jstate = tx.init(jp)
    topt = toptim.make_optimizer(cfg)
    tp = [torch.from_numpy(p.copy()) for p in params]
    topt.init(tp)
    trail = []
    for g in grads:
        upd, jstate = tx.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        topt.update(tp, [torch.from_numpy(x) for x in g])
        trail.append(max(
            float(np.abs(t.numpy() - np.asarray(j)).max()
                  / np.abs(np.asarray(j)).max()) for t, j in zip(tp, jp)))
    moved = [float(np.abs(t.numpy() - p).max()) for t, p in zip(tp, params)]
    return trail, moved


@pytest.mark.parametrize("sched", SCHEDULES, ids=lambda s: s["schedule"])
@pytest.mark.parametrize("name", ["adamw", "adam", "sgd", "lamb"])
def test_optimizer_matches_optax(name, sched):
    cfg = {"name": name, "learning_rate": 0.1, "weight_decay": 0.05,
           **sched}
    trail, moved = run_both(cfg)
    assert max(trail) < 1e-6, trail
    decays = name in ("adamw", "lamb")
    # a zero gradient moves a parameter only through weight decay
    assert (moved[-1] > 0) == decays, moved


@pytest.mark.parametrize("name", ["adamw", "sgd"])
def test_grad_clip_matches_optax(name):
    # max norm 1.0: the first updates' gradients are clipped, the zero
    # gradient is not
    cfg = {"name": name, "learning_rate": 0.05, "weight_decay": 0.01,
           "grad_clip_norm": 1.0}
    trail, _ = run_both(cfg, seed=1)
    assert max(trail) < 1e-6, trail


@pytest.mark.parametrize("sched", SCHEDULES[1:], ids=lambda s: s["schedule"])
def test_schedule_values_match_optax(sched):
    cfg = {"learning_rate": 0.3, **sched}
    jfn, tfn = joptim.make_schedule(cfg), toptim.make_schedule(cfg)
    for step in range(9):
        assert abs(tfn(step) - float(jfn(step))) < 1e-7, step


def test_first_update_uses_step_zero_of_the_schedule():
    # linear warmup from 0: the first update is lr(0) = 0, so sgd moves
    # nothing on the first step and something on the second
    opt = toptim.make_optimizer({"name": "sgd", "schedule": "linear",
                                 "warmup_steps": 3, "total_steps": 6})
    p = [torch.ones(3)]
    opt.init(p)
    opt.update(p, [torch.ones(3)])
    assert torch.equal(p[0], torch.ones(3))
    opt.update(p, [torch.ones(3)])
    assert (p[0] < 1).all()


def test_state_dict_round_trip_continues_identically():
    cfg = {"name": "adamw", "learning_rate": 0.1, "weight_decay": 0.1}
    rng = np.random.default_rng(3)
    p0 = [torch.from_numpy(rng.standard_normal(5).astype(np.float32))]
    gs = [[torch.from_numpy(rng.standard_normal(5).astype(np.float32))]
          for _ in range(4)]
    a = toptim.make_optimizer(cfg)
    pa = [p0[0].clone()]
    a.init(pa)
    for g in gs:
        a.update(pa, g)
    b = toptim.make_optimizer(cfg)
    pb = [p0[0].clone()]
    b.init(pb)
    for g in gs[:2]:
        b.update(pb, g)
    c = toptim.make_optimizer(cfg)
    pc = [pb[0].clone()]
    c.init(pc)
    c.load_state_dict(b.state_dict())
    for g in gs[2:]:
        c.update(pc, g)
    assert torch.equal(pa[0], pc[0])


@pytest.mark.parametrize("cfg,match", [
    ({"name": "adagrad"}, "adagrad"),
    ({"schedule": "step"}, "step"),
    ({"schedule": "cosine", "warmup_steps": 5, "total_steps": 5}, "cosine"),
])
def test_unknown_names_raise(cfg, match):
    with pytest.raises(ValueError, match=match):
        toptim.make_optimizer(cfg)


def test_global_norm():
    ts = [torch.tensor([3.0]), torch.tensor([[4.0]]), torch.zeros(2)]
    assert toptim.global_norm(ts).item() == 5.0
    assert jax.numpy.isclose(optax.global_norm([jnp.asarray(t.numpy())
                                                for t in ts]), 5.0)


def list_wide_update(opt, params, grads, grad_norm):
    """The update as ``Optimizer.update`` made it before it was chunked:
    every ``_foreach`` op over the whole parameter list, with model-sized
    temporaries (the clipped gradients, adam's denominator and update)."""
    if opt.clip_norm:
        scale = torch.where(grad_norm < opt.clip_norm,
                            torch.ones_like(grad_norm),
                            opt.clip_norm / grad_norm)
        grads = torch._foreach_mul(grads, scale)
    lr = opt.schedule(opt.count)
    opt.count += 1
    mu, nu = opt.moments["mu"], opt.moments["nu"]
    torch._foreach_mul_(mu, opt.b1)
    torch._foreach_add_(mu, grads, alpha=1 - opt.b1)
    torch._foreach_mul_(nu, opt.b2)
    torch._foreach_addcmul_(nu, grads, grads, value=1 - opt.b2)
    denom = torch._foreach_div(nu, toptim._bias_correction(opt.b2,
                                                           opt.count))
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, opt.eps)
    upd = torch._foreach_div(mu, toptim._bias_correction(opt.b1, opt.count))
    torch._foreach_div_(upd, denom)
    if opt.weight_decay and opt.name in ("adamw", "lamb"):
        torch._foreach_add_(upd, params, alpha=opt.weight_decay)
    if opt.name == "lamb":
        p_norm = torch._foreach_norm(params)
        u_norm = torch._foreach_norm(upd)
        for u, pn, un in zip(upd, p_norm, u_norm):
            u.mul_(torch.where((pn == 0) | (un == 0), torch.ones_like(pn),
                               pn / un))
    torch._foreach_add_(params, upd, alpha=-lr)


@pytest.mark.parametrize("cfg", [
    {"name": "adamw", "weight_decay": 0.01},
    {"name": "lamb", "weight_decay": 0.01},
    {"name": "adamw", "weight_decay": 0.01, "grad_clip_norm": 1.0},
    {"name": "lamb", "grad_clip_norm": 0.5},
])
def test_chunked_update_is_bitwise_the_list_wide_formula(cfg):
    # sizes that make chunks of one and of three tensors (the bound is the
    # largest tensor, 60 elements), and a zero gradient
    shapes = [(60,), (10, 3), (20,), (5, 2), (7,), (4, 4), (3,)]
    rng = np.random.default_rng(4)
    params = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for s in shapes]
    cfg = {"learning_rate": 0.05, **cfg}
    chunked, wide = toptim.make_optimizer(cfg), toptim.make_optimizer(cfg)
    p_chunked = [p.clone() for p in params]
    p_wide = [p.clone() for p in params]
    chunked.init(p_chunked)
    wide.init(p_wide)
    assert [list(c) for c in toptim._chunks([p.numel() for p in params])] \
        == [[0], [1, 2, 3], [4, 5, 6]]
    for i in range(4):
        grads = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                                  * (i + 1)) for s in shapes]
        grads[-1].zero_()
        norm = toptim.global_norm(grads)
        chunked.update(p_chunked, grads, norm)
        list_wide_update(wide, p_wide, grads, norm)
        for a, b in zip(p_chunked, p_wide):
            assert torch.equal(a, b)
        for key in ("mu", "nu"):
            for a, b in zip(chunked.moments[key], wide.moments[key]):
                assert torch.equal(a, b)
