"""Training step of the PyTorch port against the JAX reference.

Five steps of ``bert_tiny(dtype="float32")`` from the same parameters
(flax's init, carried across by ``models/convert.py``) on the same numpy
batches, through the reference's ``build_train_step`` on a one-device mesh
and the port's, with the same adamw config (weight decay on, so the
pooler and NSP heads, which the MLM loss never reaches, still move).
Compared per step: ``loss`` and ``grad_norm``; after the last step every
parameter.  Tolerances, float32 (summation order only): loss and
grad_norm within 1e-5 relative, parameters within 1e-5 of max |p|.  The
attention key biases are the exception: their gradient is zero in exact
arithmetic (softmax ignores a shift shared by a query's scores), adam
turns the rounding noise on each side into full steps of random sign, so
they are held only to the most adam can move them (lr per step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from kubeflow_tpu.models import bert as jbert
from kubeflow_tpu.models import registry as jreg
from kubeflow_tpu.parallel import make_mesh
from kubeflow_tpu.parallel import train_step as jts
from kubeflow_tpu.training import optim as joptim
from kubeflow_tpu_torch.models import bert as tbert
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models import registry as treg
from kubeflow_tpu_torch.parallel import train_step as tts
from kubeflow_tpu_torch.training import optim as toptim

B, S, STEPS = 4, 32, 5
OPT = {"name": "adamw", "learning_rate": 3e-3, "weight_decay": 0.01,
       "schedule": "linear", "warmup_steps": 2, "total_steps": 10}


def batches():
    rng = np.random.default_rng(0)
    return [{"input_ids": rng.integers(0, 1024, (B, S)).astype(np.int32),
             "labels": rng.integers(0, 1024, (B, S)).astype(np.int32),
             "weights": (rng.random((B, S)) < 0.3).astype(np.float32)}
            for _ in range(STEPS)]


def reference_run(grad_accum):
    module = jbert.BertModel(jbert.bert_tiny(dtype="float32"))
    mesh = make_mesh(1, dp=1)
    tx = joptim.make_optimizer(OPT)
    state, shardings = jts.init_train_state(
        module, tx, jax.random.PRNGKey(0), (jnp.zeros((B, S), jnp.int32),),
        mesh)
    params0 = jax.tree.map(np.asarray, state.params)
    entry = jreg.get("bert")

    def forward(params, batch):
        return entry.forward_loss(module, params, batch)

    bs = {k: NamedSharding(mesh, P(("dp", "fsdp"))) for k in batches()[0]}
    step = jts.build_train_step(forward, tx, mesh, shardings, bs,
                                donate=False, grad_accum=grad_accum)
    trail = []
    with mesh:
        for nb in batches():
            state, m = step(state, jax.device_put(
                {k: jnp.asarray(v) for k, v in nb.items()}, bs))
            trail.append((float(m["loss"]), float(m["grad_norm"])))
    return params0, trail, jax.tree.map(np.asarray, state.params)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_five_steps_match_reference(grad_accum):
    params0, want, final = reference_run(grad_accum)
    model = tbert.BertModel(tbert.bert_tiny(dtype="float32"), device="cpu")
    model.load_state_dict(convert.from_jax_params(params0, model.config))
    state = tts.init_train_state(model, toptim.make_optimizer(OPT))
    entry = treg.get("bert")
    step = tts.build_train_step(entry.forward_loss, state.tx,
                                grad_accum=grad_accum)
    got = []
    for nb in batches():
        batch = {k: torch.from_numpy(v).long() if v.dtype == np.int32
                 else torch.from_numpy(v) for k, v in nb.items()}
        state, m = step(state, batch)
        assert m["loss"].dtype == m["grad_norm"].dtype == torch.float32
        got.append((m["loss"].item(), m["grad_norm"].item()))
    assert state.step == STEPS
    for (gl, gn), (wl, wn) in zip(got, want):
        assert abs(gl - wl) <= 1e-5 * abs(wl), (got, want)
        assert abs(gn - wn) <= 1e-5 * abs(wn), (got, want)
    ref = convert.from_jax_params(final, model.config)
    for name, p in model.state_dict().items():
        r = ref[name]
        if name.endswith("attention.key.bias"):
            assert p.abs().max() <= OPT["learning_rate"] * STEPS, name
            continue
        err = (p - r).abs().max() / r.abs().max().clamp_min(1e-6)
        assert err <= 1e-5, name


def test_unreached_parameters_get_zero_gradients_and_decay():
    # pooler and NSP: the MLM loss never reaches them; they get a zero
    # gradient (as jax.grad gives), so adamw still decays them
    model = treg.get("bert").make_model(size="tiny", dtype="float32",
                                        device="cpu").init_weights(0)
    state = tts.init_train_state(
        model, toptim.make_optimizer({"name": "adamw", "weight_decay": 0.5,
                                      "learning_rate": 0.1}))
    before = model.pooler.kernel.detach().clone()
    step = tts.build_train_step(treg.get("bert").forward_loss, state.tx)
    batch = treg.get("bert").make_batch(2, torch.Generator().manual_seed(0),
                                        model, seq_len=16)
    step(state, batch)
    assert torch.allclose(model.pooler.kernel, before * (1 - 0.1 * 0.5))


def test_grad_accum_splits_the_leading_axis_into_contiguous_micro_batches():
    seen = []

    def forward(model, batch):
        seen.append(batch["x"].tolist())
        return (model.w * batch["x"].float()).sum()

    model = torch.nn.Module()
    model.w = torch.nn.Parameter(torch.ones(()))
    state = tts.init_train_state(model, toptim.make_optimizer(
        {"name": "sgd", "learning_rate": 0.0}))
    step = tts.build_train_step(forward, state.tx, grad_accum=2)
    _, m = step(state, {"x": torch.arange(4)})
    assert seen == [[0, 1], [2, 3]]
    assert m["loss"].item() == 3.0          # (1 + 5) / 2
    assert m["grad_norm"].item() == 3.0
    with pytest.raises(ValueError, match="micro-batches"):
        step(state, {"x": torch.arange(5)})


def test_meshes_are_refused_by_name():
    with pytest.raises(NotImplementedError, match="mesh"):
        tts.build_train_step(lambda m, b: None, None, mesh=object())
    with pytest.raises(NotImplementedError, match="mesh"):
        tts.build_eval_step(lambda m, b: None, mesh=object())


def test_eval_step_runs_without_gradients():
    model = treg.get("bert").make_model(size="tiny", dtype="float32",
                                        device="cpu").init_weights(0)
    model.requires_grad_(True)
    batch = treg.get("bert").make_batch(2, torch.Generator().manual_seed(1),
                                        model, seq_len=16)
    ev = tts.build_eval_step(lambda m, b: {"loss": treg.get("bert")
                                           .forward_loss(m, b)})
    out = ev(model, batch)
    assert not out["loss"].requires_grad and torch.isfinite(out["loss"])
