"""A Llama with head_dim 256 in the PyTorch port against the JAX reference.

Gemma-2B's attention widths (8 query heads over 1 KV head of 256) in the
reference's Llama block, cut to a tiny model: hidden 512, 2 query heads
over 1 KV head (head_dim 256, multi-query), 2 layers, vocab 512, float32,
flax's init carried across by ``models/convert.py``.  At head_dim 256 the
port's dispatcher takes the flash route (``HEAD_DIMS``), so on the CPU the
flash Function's plain K1, K2 and K3 run through the model; the reference
runs its XLA attention there (its Pallas kernels serve D = 256 only at the
long sequences ``supported()`` admits).

- logits of one batch, through the flash route and the plain route;
- five steps of ``build_train_step`` (adamw) against the reference's:
  loss and grad_norm of every step;
- greedy streams of the port's engine (through ``GenerativePredictor``
  with the widths as ``model_config``, as a user passes them) identical to
  the JAX ``ContinuousBatcher``'s, one prompt longer than the prefill
  chunk.

Tolerances, float32 (summation order only): logits within 1e-5 of max
|logit|; loss and grad_norm within 1e-5 relative at step 0 and within
``step_tolerance(k)`` at step k.  Step 0's gradients agree to 2.9e-6 of
each tensor's max |g| (both routes), and the port's adamw applied to the
reference's step-0 gradients gives the reference's parameters within
1.2e-7: the two compute the same thing.  But adam's first update is
``lr * sign(g)`` wherever ``|g| >> eps``, so a gradient element whose
rounding error exceeds its value (3 elements of ~1e-9, against a max |g|
of ~3e-2) steps by ``2 lr`` the other way: the parameter gap
``||p - p_ref|| / ||p_ref||`` is 3.0e-5 after step 0 (3x the step-0
tolerance) and grows by 1.08-1.17x a step after it, and the metrics of
step k move by ~0.3x the gap after step k - 1 (measured gaps: 1.3e-7,
9.3e-6, 1.04e-5, 7.3e-6, 3.3e-6 for steps 0-4).  Which elements flip
depends on the host's float32 sums, so the later steps are held to the
step-0 tolerance times 3 (the first update's jump) times 1.2 a step.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.models import registry as jreg
from kubeflow_tpu.parallel import make_mesh
from kubeflow_tpu.parallel import train_step as jts
from kubeflow_tpu.parallel.sharding import unbox_params
from kubeflow_tpu.serving.engine import ContinuousBatcher as JaxBatcher
from kubeflow_tpu.training import optim as joptim
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.models import registry as treg
from kubeflow_tpu_torch.ops import attention as tattention
from kubeflow_tpu_torch.parallel import train_step as tts
from kubeflow_tpu_torch.serving import predictor as tpred
from kubeflow_tpu_torch.training import optim as toptim

WIDTHS = {"vocab_size": 512, "hidden_size": 512, "num_layers": 2,
          "num_heads": 2, "num_kv_heads": 1, "intermediate_size": 1024,
          "max_seq_len": 128, "dtype": "float32"}
B, S, STEPS = 2, 32, 5
MAX_SEQ, CHUNK = 128, 16
OPT = {"name": "adamw", "learning_rate": 3e-3, "weight_decay": 0.01}


def jax_config(**kw):
    return jl.LlamaConfig(**WIDTHS, **kw)


def port_config(**kw):
    return tl.LlamaConfig(**WIDTHS, **kw)


def numpy_batch(seed=0):
    ids = np.random.default_rng(seed).integers(
        0, WIDTHS["vocab_size"], (B, S + 1)).astype(np.int32)
    return {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}


def torch_batch(nb):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).long()
            for k, v in nb.items()}


@pytest.fixture(scope="module")
def reference():
    module = jl.LlamaModel(jax_config())
    params = module.init(jax.random.PRNGKey(0), jnp.zeros((B, S), jnp.int32))
    return module, unbox_params(params["params"])


def port_state(params, cfg):
    return convert.from_jax_params(jax.tree.map(np.asarray, params), cfg)


def port_model(params, **cfg):
    config = port_config(**cfg)
    model = tl.LlamaModel(config, device="cpu")
    model.load_state_dict(port_state(params, config))
    return model


def test_head_dim_256_takes_the_flash_route():
    assert port_config().head_dim == 256 and 256 in tattention.HEAD_DIMS


@pytest.mark.parametrize("use_flash", [True, False])
def test_logits_match_reference(reference, use_flash, monkeypatch):
    module, params = reference
    ids = numpy_batch()["input_ids"]
    want = np.asarray(module.apply({"params": params}, jnp.asarray(ids))
                      ["logits"], dtype=np.float32)
    calls = []
    flash = tattention.flash_attention
    monkeypatch.setattr(tattention, "flash_attention",
                        lambda *a, **kw: calls.append(1) or flash(*a, **kw))
    model = port_model(params, use_flash=use_flash)
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long())["logits"].numpy()
    assert len(calls) == (WIDTHS["num_layers"] if use_flash else 0)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@functools.lru_cache(maxsize=None)
def reference_run():
    module = jl.LlamaModel(jax_config())
    mesh = make_mesh(1, dp=1)
    tx = joptim.make_optimizer(OPT)
    state, shardings = jts.init_train_state(
        module, tx, jax.random.PRNGKey(0), (jnp.zeros((B, S), jnp.int32),),
        mesh)
    params0 = jax.tree.map(np.asarray, state.params)
    entry = jreg.get("llama")

    def forward(params, batch):
        return entry.forward_loss(module, params, batch)

    bs = {k: NamedSharding(mesh, P(("dp", "fsdp"))) for k in numpy_batch()}
    step = jts.build_train_step(forward, tx, mesh, shardings, bs,
                                donate=False)
    trail = []
    with mesh:
        for i in range(STEPS):
            state, m = step(state, jax.device_put(
                {k: jnp.asarray(v) for k, v in numpy_batch(i).items()}, bs))
            trail.append((float(m["loss"]), float(m["grad_norm"])))
    return params0, tuple(trail)


def step_tolerance(k: int) -> float:
    """Relative tolerance of step ``k``'s loss and grad_norm: 1e-5 at step
    0, then 1e-5 x 3 x 1.2 ** (k - 1) (module docstring)."""
    return 1e-5 if k == 0 else 3e-5 * 1.2 ** (k - 1)


@pytest.mark.parametrize("use_flash", [True, False])
def test_five_steps_match_reference(use_flash):
    params0, want = reference_run()
    model = port_model(params0, use_flash=use_flash).requires_grad_(True)
    state = tts.init_train_state(model, toptim.make_optimizer(OPT))
    step = tts.build_train_step(treg.get("llama").forward_loss, state.tx)
    got = []
    for i in range(STEPS):
        state, m = step(state, torch_batch(numpy_batch(i)))
        got.append((m["loss"].item(), m["grad_norm"].item()))
    for k, ((gl, gn), (wl, wn)) in enumerate(zip(got, want)):
        tol = step_tolerance(k)
        assert abs(gl - wl) <= tol * abs(wl), (k, got, want)
        assert abs(gn - wn) <= tol * abs(wn), (k, got, want)


def test_greedy_streams_identical_to_jax_engine(reference):
    _, params = reference
    cfg = jax_config(use_flash=True)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, WIDTHS["vocab_size"], n).tolist()
               for n in (5, 23, 40)]
    jb = JaxBatcher(jl.LlamaModel(cfg), params, cfg, max_batch=4,
                    max_seq=MAX_SEQ, prefill_chunk=CHUNK)
    try:
        ref = jb.generate_sync(prompts, max_new_tokens=12)
    finally:
        jb.shutdown()
    pred = tpred.GenerativePredictor(
        "llama", size="7b", model_config={**WIDTHS, "use_flash": True},
        state=port_state(params, port_config()), max_seq=MAX_SEQ,
        prefill_chunk=CHUNK, device="cpu")
    try:
        assert pred.cfg.head_dim == 256
        assert pred.engine.generate_sync(prompts, max_new_tokens=12) == ref
    finally:
        pred.stop(timeout=30)
