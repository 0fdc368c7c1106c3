"""BERT of the PyTorch port against the JAX reference.

``bert_tiny(dtype="float32")`` params are initialised by flax and carried
across with ``models/convert.py``; the same numpy batch goes through both.
Logits, ``mlm_loss`` and every parameter's gradient (``jax.grad`` of the
reference's loss against ``torch.autograd``) are compared with and without
``masked_positions``, through the plain attention route and through the
flash Function (whose CPU forward and backward are the kernels' plain
versions).  Per-layer remat (``torch.utils.checkpoint``) is on, as in
the reference.

Tolerances, float32: logits and loss within 1e-5 of max |ref|; each
gradient within 1e-4 of max(max |ref|, 1e-3) (summation order only; the
floor covers the key bias, whose gradient is zero in exact arithmetic
because softmax ignores a shift shared by a query's scores, so both sides
hold rounding noise of ~1e-10).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import bert as jbert
from kubeflow_tpu.models import registry as jreg
from kubeflow_tpu.parallel.sharding import unbox_params
from kubeflow_tpu_torch.models import bert as tbert
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models import registry as treg
from kubeflow_tpu_torch.ops import attention as tattention

B, S, P = 2, 32, 5


@pytest.fixture(autouse=True)
def flash_route_at_head_dim_16(monkeypatch):
    """The dispatcher takes the flash route only at the head dims the
    kernel is built for; the tiny models' head_dim is 16, so it joins them
    here and the ``use_flash`` cases run the flash Function's plain
    versions through the model."""
    monkeypatch.setattr(tattention, "HEAD_DIMS",
                        tattention.HEAD_DIMS + (16,))


@pytest.fixture(scope="module")
def reference():
    module = jbert.BertModel(jbert.bert_tiny(dtype="float32"))
    params = module.init(jax.random.PRNGKey(0), jnp.zeros((B, S), jnp.int32))
    return module, unbox_params(params["params"])


def numpy_batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, 1024, (B, S)).astype(np.int32),
            "labels": rng.integers(0, 1024, (B, S)).astype(np.int32),
            "weights": (rng.random((B, S)) < 0.3).astype(np.float32),
            "positions": np.sort(rng.permutation(S)[:B * P].reshape(B, P),
                                 axis=1).astype(np.int32)}


def port_model(params, use_flash):
    model = tbert.BertModel(tbert.bert_tiny(dtype="float32",
                                            use_flash=use_flash),
                            device="cpu")
    model.load_state_dict(convert.from_jax_params(
        jax.tree.map(np.asarray, params), model.config))
    return model.requires_grad_(True)


def rel(a, b, floor=1e-12) -> float:
    b = np.asarray(b, dtype=np.float32)
    return float(np.abs(np.asarray(a, dtype=np.float32) - b).max()
                 / max(np.abs(b).max(), floor))


def mlm_case(masked):
    """(ids, positions or None, labels, weights) of the comparison; with
    ``masked`` the loss covers the masked slots only."""
    nb = numpy_batch()
    if not masked:
        return nb["input_ids"], None, nb["labels"], nb["weights"]
    pos = nb["positions"]
    return (nb["input_ids"], pos, np.take_along_axis(nb["labels"], pos, 1),
            np.ones((B, P), np.float32))


@pytest.fixture(scope="module")
def jax_results(reference):
    """The reference's loss, outputs and gradients per ``masked``,
    computed once for both attention routes of the port."""
    module, params = reference
    out = {}
    for masked in (False, True):
        ids, pos, labels, weights = mlm_case(masked)

        def jloss(p):
            o = module.apply({"params": p}, jnp.asarray(ids),
                             masked_positions=None if pos is None
                             else jnp.asarray(pos))
            return jbert.mlm_loss(o, jnp.asarray(labels),
                                  jnp.asarray(weights)), o

        out[masked] = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
            params)
    return out


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_logits_loss_and_every_gradient_match_jax(reference, jax_results,
                                                  use_flash, masked):
    _, params = reference
    ids, pos, labels, weights = mlm_case(masked)
    (jl, jout), jgrads = jax_results[masked]

    model = port_model(params, use_flash)
    out = model(torch.from_numpy(ids).long(),
                masked_positions=None if pos is None
                else torch.from_numpy(pos).long())
    loss = tbert.mlm_loss(out, torch.from_numpy(labels).long(),
                          torch.from_numpy(weights))
    loss.backward()

    assert out["logits"].shape == jout["logits"].shape
    assert rel(out["logits"].detach(), jout["logits"]) < 1e-5
    assert rel(out["nsp_logits"].detach(), jout["nsp_logits"]) < 1e-5
    assert abs(loss.item() - float(jl)) < 1e-5 * abs(float(jl))
    want = convert.from_jax_params(jax.tree.map(np.asarray, jgrads),
                                   model.config)
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, g in want.items():
        if not np.any(g.numpy()):
            # pooler / NSP: the MLM loss never reaches them
            assert got[name].grad is None or not got[name].grad.any(), name
            continue
        assert rel(got[name].grad, g, floor=1e-3) < 1e-4, name


def test_registry_loss_matches_reference_loss(reference):
    module, params = reference
    nb = numpy_batch(1)
    jbatch = {k: jnp.asarray(nb[k]) for k in ("input_ids", "labels",
                                             "weights")}
    want = float(jreg.get("bert").forward_loss(module, params, jbatch))
    model = port_model(params, use_flash=False)
    entry = treg.get("bert")
    got = entry.forward_loss(model, {k: torch.from_numpy(v).long()
                                     if v.dtype == np.int32
                                     else torch.from_numpy(v)
                                     for k, v in nb.items()})
    assert abs(got.item() - want) < 1e-5 * abs(want)


def test_synthetic_batch_has_the_reference_shapes_and_rates():
    model = treg.get("bert").make_model(size="tiny", device="cpu")
    gen = torch.Generator().manual_seed(0)
    batch = treg.get("bert").make_batch(8, gen, model)
    assert batch["input_ids"].shape == (8, 128)
    assert int(batch["input_ids"].max()) < 1024
    assert set(batch) == {"input_ids", "labels", "weights"}
    assert 0.05 < float(batch["weights"].mean()) < 0.3


def test_remat_runs_each_layer_twice_and_gives_the_same_gradients(reference):
    _, params = reference
    calls = []
    grads = {}
    for remat in (False, True):
        model = port_model(params, use_flash=True)
        model.config = dataclasses.replace(model.config, remat=remat)
        hook = model.layers[0].attention.register_forward_hook(
            lambda *a: calls.append(remat))
        ids = torch.from_numpy(numpy_batch()["input_ids"]).long()
        model(ids)["logits"].square().mean().backward()
        hook.remove()
        grads[remat] = [p.grad.clone() for p in model.parameters()
                        if p.grad is not None]
    assert calls.count(False) == 1 and calls.count(True) == 2
    for a, b in zip(grads[False], grads[True]):
        assert torch.equal(a, b)


def test_serving_models_stay_frozen():
    from kubeflow_tpu_torch.models import llama

    model = llama.LlamaModel(llama.llama_tiny(), device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    assert "layers.0.attention.q.bias" not in model.state_dict()


def test_from_jax_params_rejects_a_mismatched_bert_tree(reference):
    _, params = reference
    tree = jax.tree.map(np.asarray, params)
    with pytest.raises(ValueError, match="missing"):
        convert.from_jax_params(tree, dataclasses.replace(
            tbert.bert_tiny(), num_layers=3))
    with pytest.raises(ValueError, match="shape"):
        convert.from_jax_params(tree, dataclasses.replace(
            tbert.bert_tiny(), intermediate_size=64))
