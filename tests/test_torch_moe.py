"""MoE of the PyTorch port against the JAX reference, at tiny sizes.

- ``MoEBlock`` (hidden 32, FFN 64, 4 experts) in both modes against
  ``kubeflow_tpu.models.moe.MoEBlock`` on the same seeded numpy input and
  the same weights: y, aux, the capacity drops, and the gradients of the
  router, ``w_in``, ``w_out`` and the input against ``jax.grad``; a router
  skewed so capacity overflows; an exact tie in the router's top-2.
- ``llama_tiny`` with ``moe_experts=4, moe_every=2`` (layer 0 MoE, layer 1
  dense): logits without and with a cache (capacity and dropless), the
  paged cache bitwise equal to the contiguous one, loss with its ``0.01 *
  moe_aux`` and every gradient, and five adamw steps of
  ``build_train_step`` against the reference's.
- The MoE tiny engine's greedy streams identical to the JAX engine's.

Tolerance, float32 (summation order only): 1e-5 relative to max |ref|.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.models import moe as jmoe
from kubeflow_tpu.models import registry as jreg
from kubeflow_tpu.parallel import make_mesh
from kubeflow_tpu.parallel import train_step as jts
from kubeflow_tpu.parallel.sharding import unbox_params
from kubeflow_tpu.serving.engine import ContinuousBatcher as JaxBatcher
from kubeflow_tpu.training import optim as joptim
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.models import moe as tmoe
from kubeflow_tpu_torch.models import registry as treg
from kubeflow_tpu_torch.parallel import train_step as tts
from kubeflow_tpu_torch.serving import engine as teng
from kubeflow_tpu_torch.training import optim as toptim

TOL = 1e-5
D, F, E = 32, 64, 4
MOE_CFG = {"moe_experts": 4, "moe_every": 2}
B, S, STEPS, VOCAB = 4, 32, 5, 512
OPT = {"name": "adamw", "learning_rate": 3e-3, "weight_decay": 0.01,
       "schedule": "linear", "warmup_steps": 2, "total_steps": 10}


def rel(a, b) -> float:
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def block_params(seed=0, bias=None):
    """A reference MoE block and its unboxed params (numpy), optionally
    with the router bias replaced."""
    cfg = jmoe.MoEConfig(hidden_size=D, ffn_size=F, num_experts=E,
                         dtype="float32")
    params = unbox_params(jmoe.MoEBlock(cfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 4, D)))["params"])
    params = jax.tree.map(np.asarray, params)
    if bias is not None:
        params["router"]["bias"] = np.asarray(bias, np.float32)
    return cfg, params


def port_block(params, dropless):
    block = tmoe.MoEBlock(tmoe.MoEConfig(hidden_size=D, ffn_size=F,
                                         num_experts=E, dtype="float32"),
                          dropless=dropless, device="cpu")
    block.load_state_dict({name: torch.tensor(np.array(a)) for name, a in (
        ("router.kernel", params["router"]["kernel"]),
        ("router.bias", params["router"]["bias"]),
        ("w_in", params["w_in"]), ("w_out", params["w_out"]))})
    return block.requires_grad_(True)


def expected_drops(params, x) -> int:
    """(token, choice) assignments past capacity, by numpy from the
    reference's router: priority order, first maximal index per choice."""
    logits = x.reshape(-1, D) @ params["router"]["kernel"] \
        + params["router"]["bias"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    first = probs.argmax(-1)
    masked = probs.copy()
    masked[np.arange(len(first)), first] = 0.0
    second = masked.argmax(-1)
    cap = max(1, int(1.25 * 2 * len(first) / E))
    counts = np.zeros(E, int)
    drops = 0
    for expert in np.concatenate([first, second]):
        drops += counts[expert] >= cap
        counts[expert] += 1
    return int(drops)


def check_block(params, x, dropless):
    """y, aux and every gradient of one block against the reference."""
    cfg = jmoe.MoEConfig(hidden_size=D, ffn_size=F, num_experts=E,
                         dtype="float32")
    jblock = jmoe.MoEBlock(cfg, dropless=dropless)
    r = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)

    def loss(p, xx):
        y, aux = jblock.apply({"params": p}, xx)
        return jnp.sum(y * r) + aux, (y, aux)

    (_, (jy, jaux)), (jg, jgx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    block = port_block(params, dropless)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = block(xt)
    (torch.sum(y * torch.from_numpy(r)) + aux).backward()
    assert rel(y.detach(), jy) <= TOL
    assert abs(aux.item() - float(jaux)) <= TOL * abs(float(jaux))
    assert rel(xt.grad, jgx) <= TOL
    for name, got, want in (
            ("router.kernel", block.router.kernel.grad,
             jg["router"]["kernel"]),
            ("router.bias", block.router.bias.grad, jg["router"]["bias"]),
            ("w_in", block.w_in.grad, jg["w_in"]),
            ("w_out", block.w_out.grad, jg["w_out"])):
        assert rel(got, want) <= TOL, name
    return block


@pytest.mark.parametrize("dropless", [True, False])
def test_block_matches_reference(dropless):
    _, params = block_params()
    x = np.random.default_rng(1).standard_normal((2, 8, D)).astype(
        np.float32)
    block = check_block(params, x, dropless)
    if not dropless:
        assert int(block.dropped) == expected_drops(params, x)


@pytest.mark.parametrize("dropless", [True, False])
def test_capacity_overflow_matches_reference(dropless):
    # a router bias that sends nearly every token to expert 2 first and
    # expert 0 second: both overflow their capacity of int(1.25 * 2 * 32
    # / 4) = 20 slots
    _, params = block_params(bias=[4.0, 0.0, 8.0, -4.0])
    x = np.random.default_rng(2).standard_normal((2, 16, D)).astype(
        np.float32)
    drops = expected_drops(params, x)
    assert drops >= 20
    block = check_block(params, x, dropless)
    if not dropless:
        assert int(block.dropped) == drops


@pytest.mark.parametrize("dropless", [True, False])
def test_router_tie_breaks_as_reference(dropless):
    # a zero router kernel: every token's probabilities tie exactly
    # between experts 1 and 3 (and between 0 and 2 below them)
    _, params = block_params(bias=[0.0, 2.0, 0.0, 2.0])
    params["router"]["kernel"] = np.zeros_like(params["router"]["kernel"])
    x = np.random.default_rng(3).standard_normal((1, 6, D)).astype(
        np.float32)
    probs = torch.softmax(torch.tensor([[0.0, 2.0, 0.0, 2.0]]), -1)
    gates, experts = tmoe.route(probs)
    assert experts.tolist() == [[1, 3]]
    assert torch.equal(gates, torch.tensor([[0.5, 0.5]]))
    check_block(params, x, dropless)


def test_capacity_slots_fill_in_priority_order():
    experts = torch.tensor([[0, 1], [0, 2], [0, 1], [1, 0]])
    slot, keep = tmoe.capacity_slots(experts, 3, cap=2)
    # first choices 0, 0, 0, 1 then second choices 1, 2, 1, 0
    assert keep.tolist() == [True, True, False, True,
                             True, True, False, False]
    assert slot.tolist() == [0, 1, 6, 2, 3, 4, 6, 6]


# --- MoE llama_tiny -----------------------------------------------------------

def numpy_batch(seed=0):
    ids = np.random.default_rng(seed).integers(0, VOCAB, (B, S + 1)).astype(
        np.int32)
    return {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}


def torch_batch(nb):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).long()
            for k, v in nb.items()}


@pytest.fixture(scope="module")
def reference():
    module = jl.LlamaModel(jl.llama_tiny(dtype="float32", **MOE_CFG))
    params = module.init(jax.random.PRNGKey(0), jnp.zeros((B, S), jnp.int32))
    return module, unbox_params(params["params"])


def port_model(params, **cfg):
    config = tl.llama_tiny(dtype="float32", **MOE_CFG, **cfg)
    model = tl.LlamaModel(config, device="cpu")
    model.load_state_dict(convert.from_jax_params(
        jax.tree.map(np.asarray, params), config))
    return model


def test_moe_llama_layers_and_leaves(reference):
    _, params = reference
    model = port_model(params)
    assert [blk.use_moe for blk in model.layers] == [True, False]
    assert not hasattr(model.layers[0], "gate")
    assert model.layers[0].moe.router.kernel.dtype == torch.float32
    assert set(params["layer_0"]["moe"]) == {"router", "w_in", "w_out"}
    # the predictor's compute-dtype build keeps the router in float32
    bf16 = treg.get("llama").make_model(size="tiny", device="cpu",
                                        param_dtype="compute", **MOE_CFG)
    dtypes = {n: p.dtype for n, p in bf16.named_parameters()}
    assert dtypes["layers.0.moe.router.kernel"] == torch.float32
    assert dtypes["layers.0.moe.router.bias"] == torch.float32
    assert dtypes["layers.0.moe.w_in"] == torch.bfloat16
    assert dtypes["layers.1.gate.kernel"] == torch.bfloat16


def test_moe_logits_match_reference_with_and_without_cache(reference):
    module, params = reference
    model = port_model(params)
    ids = numpy_batch()["input_ids"][:2, :12]
    jout = module.apply({"params": params}, jnp.asarray(ids))
    with torch.no_grad():
        out = model(torch.from_numpy(ids).long())
    assert rel(out["logits"], jout["logits"]) <= TOL
    assert abs(out["moe_aux"].item() - float(jout["moe_aux"])) \
        <= TOL * float(jout["moe_aux"])
    # with a cache the MoE blocks route dropless
    jcache = jl.init_cache(module.config, 2, 32)
    tcache = tl.init_cache(model.config, 2, 32, device="cpu")
    jout = module.apply({"params": params}, jnp.asarray(ids), cache=jcache)
    with torch.no_grad():
        out = model(torch.from_numpy(ids).long(), cache=tcache)
    assert rel(out["logits"], jout["logits"]) <= TOL


@torch.no_grad()
def test_moe_paged_cache_matches_contiguous_and_reference(reference):
    """The MoE FFN behind the paged branch: bitwise the contiguous
    branch's logits, and the reference's within 1e-5."""
    module, params = reference
    model = port_model(params)
    cfg = model.config
    ids = numpy_batch()["input_ids"][:2, :20]
    tids = torch.from_numpy(ids).long()
    ref = model(tids, cache=tl.init_cache(cfg, 2, 64, per_sequence=True,
                                          device="cpu"))
    pool = tl.init_kv_pool(cfg, 9, 16, device="cpu")
    tables = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]])
    out = model(tids, cache={"layers": [
        dict(pool_k=l["k"], pool_v=l["v"], pages=tables,
             index=torch.zeros(2, dtype=torch.long))
        for l in pool["layers"]]})
    assert torch.equal(out["logits"], ref["logits"])
    jcache = jl.init_cache(module.config, 2, 64, per_sequence=True)
    jout = module.apply({"params": params}, jnp.asarray(ids), cache=jcache)
    assert rel(out["logits"], jout["logits"]) <= TOL


def test_moe_loss_and_every_gradient_match_reference(reference):
    module, params = reference
    nb = numpy_batch()
    loss, grads = jax.value_and_grad(
        lambda p: jreg.get("llama").forward_loss(module, p, {
            k: jnp.asarray(v) for k, v in nb.items()}))(params)
    cfg = tl.llama_tiny(dtype="float32", **MOE_CFG)
    want = convert.from_jax_params(jax.tree.map(np.asarray, grads), cfg)
    model = port_model(params).requires_grad_(True)
    got = treg.get("llama").forward_loss(model, torch_batch(nb))
    got.backward()
    assert abs(got.item() - float(loss)) <= TOL * abs(float(loss))
    for name, p in model.named_parameters():
        assert rel(p.grad, want[name]) <= TOL, name


@functools.lru_cache(maxsize=None)
def reference_run():
    module = jl.LlamaModel(jl.llama_tiny(dtype="float32", **MOE_CFG))
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


@pytest.mark.parametrize("remat", [False, True])
def test_moe_five_steps_match_reference(remat):
    params0, want = reference_run()
    model = port_model(params0, remat=remat)
    state = tts.init_train_state(model, toptim.make_optimizer(OPT))
    step = tts.build_train_step(treg.get("llama").forward_loss, state.tx)
    got = []
    for i in range(STEPS):
        state, m = step(state, torch_batch(numpy_batch(i)))
        got.append((m["loss"].item(), m["grad_norm"].item()))
    for (gl, gn), (wl, wn) in zip(got, want):
        assert abs(gl - wl) <= TOL * abs(wl), (got, want)
        assert abs(gn - wn) <= TOL * abs(wn), (got, want)


def test_moe_remat_routes_the_recompute_as_the_forward(reference):
    _, params = reference
    batch = torch_batch(numpy_batch(3))
    grads = {}
    for remat in (False, True):
        model = port_model(params, remat=remat).requires_grad_(True)
        treg.get("llama").forward_loss(model, batch).backward()
        grads[remat] = {n: p.grad for n, p in model.named_parameters()}
    for name, g in grads[False].items():
        torch.testing.assert_close(grads[True][name], g, rtol=0, atol=0)


def test_moe_engine_greedy_streams_identical_to_jax_engine(reference):
    module, params = reference
    model = port_model(params)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, VOCAB, n).tolist() for n in (5, 23, 40)]
    jb = JaxBatcher(module, params, module.config, max_batch=4, max_seq=96,
                    prefill_chunk=16)
    try:
        want = jb.generate_sync(prompts, max_new_tokens=10)
    finally:
        jb.shutdown()
    eng = teng.ContinuousBatcher(model, model.config, max_batch=4,
                                 max_seq=96, prefill_chunk=16)
    try:
        assert eng.generate_sync(prompts, max_new_tokens=10) == want
    finally:
        eng.shutdown()
