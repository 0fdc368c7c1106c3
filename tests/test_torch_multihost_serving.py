"""Multi-host serving of the PyTorch port in one process.

Counterpart of the reference's ``tests/test_multihost_serving.py`` for
what one process shows: the port's ``MultiHostPredictor`` (tp = dp = 1)
decodes the reference test's prompts token-identical to the reference's
``MultiHostPredictor`` and its engine, with first-token logits within
1e-5; the pad-bucket ladder reuses buckets in the reference's order;
``param_specs`` and ``_scale_spec`` give the reference's specs; the error
contracts carry the reference's messages.  The gangs are in
``test_torch_multihost_gangs.py``.  Both sides run the tiny Llama in
float32, the reference's weights carried across by
``convert.from_jax_params``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from kubeflow_tpu.models import registry as jreg
from kubeflow_tpu.parallel.sharding import unbox_params
from kubeflow_tpu.serving import multihost as jmh
from kubeflow_tpu.serving import sharded as jsh
from kubeflow_tpu.serving.quant import quantize_array as jquantize
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.models import registry as treg
from kubeflow_tpu_torch.parallel.mesh import make_mesh
from kubeflow_tpu_torch.serving import multihost as tmh
from kubeflow_tpu_torch.serving import quant as tquant
from kubeflow_tpu_torch.serving import sharded as tsh

PROMPTS = [[1, 2, 3], [7, 8, 9, 10], [5], [11, 12]]
CFG = {"dtype": "float32"}
LONG = list(range(1, 15))                   # pads to 16
LADDER = [(LONG, 8), ([1, 2, 3, 4], 8), ([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], 4)]


@pytest.fixture(scope="module")
def weights():
    module = jreg.get("llama").make_model(size="tiny", **CFG)
    params = unbox_params(jax.jit(module.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    state = convert.from_jax_params(jax.tree.map(np.asarray, params),
                                    tl.llama_tiny(**CFG))
    return module, params, state


def port(state, max_seq=64, **kw):
    return tmh.MultiHostPredictor("llama", size="tiny", max_seq=max_seq,
                                  model_config=CFG, state=state,
                                  device="cpu", **kw)


@pytest.fixture(scope="module")
def reference():
    """The reference's one-process MultiHostPredictor and engine decodes of
    ``PROMPTS``."""
    from kubeflow_tpu.serving.predictor import GenerativePredictor

    mh = jmh.MultiHostPredictor("llama", size="tiny", max_seq=64,
                                model_config=CFG)
    engine = GenerativePredictor("llama", size="tiny", max_batch=4,
                                 max_seq=64, model_config=CFG)
    try:
        ids = engine.generate(PROMPTS, max_new_tokens=8,
                              temperature=0.0)["ids"]
    finally:
        engine.engine.shutdown()
    return {"mh": mh.generate(PROMPTS, max_new_tokens=8), "engine": ids}


def test_one_process_matches_the_reference_and_its_engine(weights,
                                                          reference):
    got = port(weights[2]).generate(PROMPTS, max_new_tokens=8)
    assert got == reference["mh"] == reference["engine"]


def test_first_token_logits_within_1e_5(weights):
    module, params, state = weights
    p = port(state)
    p.generate(PROMPTS, max_new_tokens=8)
    ids = np.zeros((4, 8), np.int32)
    for i, q in enumerate(PROMPTS):
        ids[i, :len(q)] = q
    logits = np.asarray(module.apply({"params": params},
                                     jnp.asarray(ids))["logits"])
    want = np.stack([logits[i, len(q) - 1] for i, q in enumerate(PROMPTS)])
    got = p.prefill_logits.numpy()
    assert got.shape == (4, 512) and p.rows == slice(0, 4)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_pad_bucket_ladder_reuses_buckets_as_the_reference(weights):
    """The reference's ``test_pad_bucket_ladder_reuses_compiled_
    executables``: after the same calls the bucket keys are the
    reference's, and padded-reuse streams are the exact-bucket ones."""
    ref, mine = (jmh.MultiHostPredictor("llama", size="tiny", max_seq=96,
                                        model_config=CFG),
                 port(weights[2], max_seq=96))
    streams = {}
    for who, pred in (("ref", ref), ("port", mine)):
        streams[who] = [pred.generate([p], max_new_tokens=n)
                        for p, n in LADDER]
    assert list(mine._gen_cache) == list(ref._gen_cache) == [(1, 16, 8)]
    assert streams["port"] == streams["ref"]
    # exact buckets: a fresh predictor makes one per rung
    fresh = port(weights[2], max_seq=96)
    exact = [fresh.generate([p], max_new_tokens=n)
             for p, n in LADDER[1:] + LADDER[:1]]
    assert exact == streams["port"][1:] + streams["port"][:1]
    assert list(fresh._gen_cache) == [(1, 8, 8), (1, 16, 8)]


def reference_specs() -> dict:
    module = jreg.get("llama").make_model(size="tiny", **CFG)
    tree = jsh.param_specs(module, jax.random.PRNGKey(0),
                           jnp.zeros((1, 8), jnp.int32))
    out = {}

    def walk(node, prefix):
        for key, val in node.items():
            path = f"{prefix}.{key}" if prefix else key
            if isinstance(val, P):
                out[path.replace("layer_", "layers.")] = tuple(val)
            else:
                walk(val, path)

    walk(tree, "")
    return out


@pytest.mark.parametrize("quantized", [False, True])
def test_param_specs_are_the_reference_spec_tree(quantized):
    model = treg.get("llama").make_model(size="tiny", device="cpu", **CFG)
    if quantized:   # an int8 QTensor keeps its kernel's name and spec
        assert tquant.quantize_params(model)
    specs = tsh.param_specs(model)
    assert specs == reference_specs()
    assert specs["layers.0.attention.o.kernel"] == ("tp", None)
    assert specs["tok_embeddings.embedding"] == ("tp", None)


KERNELS = ("attention.q.kernel", "attention.k.kernel", "attention.v.kernel",
           "attention.o.kernel", "gate.kernel", "up.kernel", "down.kernel")


@pytest.mark.parametrize("name", KERNELS)
def test_scale_spec_is_the_reference_one(weights, name):
    _, params, _ = weights
    leaf = params["layer_0"]
    for part in name.split("."):
        leaf = leaf[part]
    spec = reference_specs()[f"layers.0.{name}"]
    scale = jquantize(leaf, axis=0).scale
    want = tuple(jsh._scale_spec(P(*spec), scale.shape))
    got = tsh._scale_spec(spec, tuple(scale.shape))
    assert got == want
    assert got[0] is None           # the contraction axis stays whole


def refusal(case, state):
    """Run one of the port's error contracts (the reference's messages);
    returns its exception."""
    tiny = tl.llama_tiny(**CFG)
    calls = {
        "shard_cache": lambda: tsh.shard_cache(
            tl.init_cache(tiny, 1, 8, device="cpu"),
            make_mesh(4, dp=1, tp=4, device_type="cpu"), 2),
        "init_cache": lambda: tl.init_cache(tiny, 1, 8, device="cpu", tp=4),
        "empty_prompt": lambda: port(state).generate([[1, 2], []]),
        "too_long": lambda: port(state).generate([[1] * 60],
                                                 max_new_tokens=8),
        "rank0_none": lambda: tmh.broadcast_prompts(None),
        "too_many": lambda: tmh.broadcast_prompts([[1]] * 5, max_items=4),
        "prompt_too_long": lambda: tmh.broadcast_prompts(
            [[1], [1] * 17], max_len=16),
        "gang_too_small": lambda: port(state, tp=2),
        "ep": lambda: port(state, ep=2),
        "moe_tp": lambda: tmh.MultiHostPredictor(
            "llama", size="tiny", tp=2, device="cpu",
            model_config={**CFG, "moe_experts": 2}),
    }
    with pytest.raises(Exception) as err:
        calls[case]()
    return err


@pytest.mark.parametrize("case, kind, message", [
    ("shard_cache", ValueError, "num_kv_heads=2 not divisible by tp=4"),
    ("init_cache", ValueError, "num_kv_heads=2 not divisible by tp=4"),
    ("empty_prompt", ValueError, "empty prompt"),
    ("too_long", ValueError, "prompt+new (68) > max_seq 64"),
    ("rank0_none", ValueError, "rank 0 must supply prompts"),
    ("too_many", ValueError, "5 prompts > 4"),
    ("prompt_too_long", ValueError, "prompt 1 longer than 16"),
    ("gang_too_small", ValueError,
     "dp=1 x tp=2 x ep=1 needs 2 devices, have 1 globally"),
    ("ep", NotImplementedError, "queue A item 7b"),
    ("moe_tp", NotImplementedError, "MoE layers under tp"),
])
def test_error_contracts(weights, case, kind, message):
    err = refusal(case, weights[2])
    assert err.type is kind
    assert message in str(err.value)


def test_reference_messages_match(weights):
    """The reference raises the same messages for the cases it can run in
    one process (its mesh spans the 8 CPU devices)."""
    with pytest.raises(ValueError, match="num_kv_heads=2 not divisible by "
                                         "tp=4"):
        jmh.MultiHostPredictor("llama", size="tiny", tp=4, max_seq=64,
                               model_config=CFG)
    with pytest.raises(ValueError, match=r"dp=1 x tp=16 x ep=1 needs 16 "
                                         "devices, have 8 globally"):
        jmh.global_serving_mesh(16)
    with pytest.raises(ValueError, match="rank 0 must supply prompts"):
        jmh.broadcast_prompts(None)


def test_quantizing_a_split_parameter_is_refused():
    """int8 is made from the whole tensor: a row-parallel kernel's tp
    block would scale by its own rows' max."""
    model = treg.get("llama").make_model(size="tiny", device="cpu", **CFG)
    model.layers[0].attention.o.kernel.tp_split = object()
    with pytest.raises(ValueError, match="quantize the whole tensor"):
        tquant.quantize_param(model, "layers.0.attention.o.kernel")


def test_quantized_kernel_keeps_its_logical_axes():
    model = treg.get("llama").make_model(size="tiny", device="cpu", **CFG)
    tquant.quantize_params(model)
    qt = model.layers[1].down.kernel
    assert isinstance(qt, tquant.QTensor)
    assert qt.logical_axes == ("mlp", "embed") and qt.tp_split is None


def test_without_cuda_the_entry_point_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmh.MultiHostPredictor("llama", size="tiny")
