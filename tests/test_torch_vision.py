"""The vision models of the PyTorch port against the JAX reference.

``mnist_mlp``, ``cifar_convnet`` and ``resnet18(width=8, num_classes=10)``
(the ResNet-50 code at a small size, float32) on 32 x 32 images: flax
initialises the weights, ``models/convert.py`` carries them (and ResNet's
``batch_stats``) across, and the same numpy batch goes through both.
ResNet's ``bn3`` scales, zero at init, are drawn in [0.1, 0.3] and its
running averages at random first, so every block's branch carries
gradient and the eval-mode logits read the carried statistics.  Compared: logits (ResNet
in train and eval mode), the registry loss, every parameter's gradient
(``torch.autograd`` against ``jax.grad``), and three train steps (adamw,
weight decay on) in loss and grad_norm.  Then flax's ``"SAME"`` padding of
a 3x3 stride-2 convolution and max-pool on odd and even sizes.

Tolerances, float32 (summation order only): logits and loss within 1e-5
of max |ref|, loss and grad_norm of each step within 1e-5 relative, each
gradient within 1e-5 of its max |ref| (MLP, ConvNet) or of the largest
|ref| of the whole gradient tree (ResNet).  ResNet's train-mode gradients
pass through 21 BatchNorms on batch statistics, whose fast variance
``mean(x^2) - mean(x)^2`` cancels; the reference's float32 sums are the
less accurate side there (a lone BatchNorm's input gradient sits 2e-5
from a float64 evaluation on the reference against 4e-6 on the port,
``test_batchnorm_matches_flax``), and at this size the errors compound
to ~3e-5 of the smallest gradients' own scale.  A well-conditioned
case (batch 16; the ``bn3`` scales above keep every branch a moderate
perturbation) keeps the whole comparison within 1e-5 of the tree's scale.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from kubeflow_tpu.models import registry as jreg
from kubeflow_tpu.parallel import make_mesh
from kubeflow_tpu.parallel import train_step as jts
from kubeflow_tpu.parallel.sharding import unbox_params
from kubeflow_tpu.training import optim as joptim
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models import layers as kl
from kubeflow_tpu_torch.models import registry as treg
from kubeflow_tpu_torch.parallel import train_step as tts
from kubeflow_tpu_torch.training import optim as toptim

B, STEPS = 16, 3
RESNET18 = {"stage_sizes": (2, 2, 2, 2), "width": 8, "num_classes": 10,
            "dtype": "float32"}
CASES = {  # registry name: (model config, image shape)
    "mnist_mlp": ({}, (28, 28, 1)),
    "cifar_convnet": ({}, (32, 32, 3)),
    "resnet50": (RESNET18, (32, 32, 3)),
}
OPT = {"name": "adamw", "learning_rate": 1e-3, "weight_decay": 0.01}


def numpy_batch(name, seed=0):
    rng = np.random.default_rng(seed)
    shape = CASES[name][1]
    return {"image": rng.standard_normal((B, *shape)).astype(np.float32),
            "label": rng.integers(0, 10, (B,)).astype(np.int32)}


def torch_batch(nb):
    return {"image": torch.from_numpy(nb["image"]),
            "label": torch.from_numpy(nb["label"]).long()}


def perturbed(tree, rng, match, low=0.5, high=1.5):
    """``tree`` (numpy) with every leaf whose path contains ``match`` drawn
    uniform in [low, high)."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = perturbed(val, rng, match, low, high)
        elif match in key:
            out[key] = rng.uniform(low, high, val.shape).astype(val.dtype)
        else:
            out[key] = val
    return out


def perturbed_bn3(tree, rng):
    return {k: ({**v, "bn3": perturbed(v["bn3"], rng, "scale", 0.1, 0.3)}
                if isinstance(v, dict) and "bn3" in v else v)
            for k, v in tree.items()}


def reference_variables(name):
    """(flax module, params, batch_stats or None) as numpy trees."""
    cfg, shape = CASES[name]
    module = jreg.get(name).make_model(**cfg)
    variables = module.init(jax.random.PRNGKey(0), jnp.zeros((1, *shape)))
    params = jax.tree.map(np.asarray, unbox_params(variables["params"]))
    stats = None
    if "batch_stats" in variables:
        rng = np.random.default_rng(1)
        params = perturbed_bn3(params, rng)
        stats = jax.tree.map(np.asarray, variables["batch_stats"])
        stats = perturbed(perturbed(stats, rng, "var"), rng, "mean", -0.5,
                          0.5)
    return module, params, stats


def port_model(name, params, stats):
    model = treg.get(name).make_model(device="cpu", **CASES[name][0])
    model.load_state_dict(convert.from_jax_params(params, model.config,
                                                  batch_stats=stats))
    return model.requires_grad_(True)


def rel(a, b) -> float:
    b = np.asarray(b, dtype=np.float32)
    return float(np.abs(np.asarray(a, dtype=np.float32) - b).max()
                 / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("name", list(CASES))
def test_logits_loss_and_gradients_match_reference(name):
    module, params, stats = reference_variables(name)
    model = port_model(name, params, stats)
    nb = numpy_batch(name)
    image = jnp.asarray(nb["image"])
    modes = [{"train": True}, {"train": False}] if stats else [{}]
    for mode in modes:
        variables = {"params": params}
        if stats:
            variables["batch_stats"] = stats
        want = jax.jit(lambda v, x: module.apply(
            v, x, mutable=bool(stats), **mode))(variables, image)
        want = want[0] if stats else want
        with torch.no_grad():
            got = model(torch.from_numpy(nb["image"]), **mode)
        assert got.dtype == torch.float32
        assert rel(got.numpy(), want) <= 1e-5, mode

    entry = jreg.get(name)
    loss, grads = jax.jit(jax.value_and_grad(lambda p, b: entry.forward_loss(
        module, p, b)))(params, {k: jnp.asarray(v) for k, v in nb.items()})
    got = treg.get(name).forward_loss(model, torch_batch(nb))
    got.backward()
    assert abs(got.item() - float(loss)) <= 1e-5 * abs(float(loss))
    want = convert.from_jax_params(jax.tree.map(np.asarray, grads),
                                   model.config)
    scale = max(w.abs().max().item() for w in want.values()) if stats else 0
    for pname, p in model.named_parameters():
        ref = want[pname].numpy()
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= 1e-5 * max(np.abs(ref).max(), scale), pname


def reference_trail(name, params):
    module = jreg.get(name).make_model(**CASES[name][0])
    mesh = make_mesh(1, dp=1)
    tx = joptim.make_optimizer(OPT)
    shape = CASES[name][1]
    state, shardings = jts.init_train_state(
        module, tx, jax.random.PRNGKey(0), (jnp.zeros((1, *shape)),), mesh)
    state = state.replace(params=jax.tree.map(jnp.asarray, params),
                          opt_state=tx.init(jax.tree.map(jnp.asarray,
                                                         params)))
    entry = jreg.get(name)
    bs = {k: NamedSharding(mesh, P(("dp", "fsdp")))
          for k in numpy_batch(name)}
    step = jts.build_train_step(
        lambda p, b: entry.forward_loss(module, p, b), tx, mesh, shardings,
        bs, donate=False)
    trail = []
    with mesh:
        for i in range(STEPS):
            state, m = step(state, jax.device_put(
                {k: jnp.asarray(v) for k, v in numpy_batch(name, i).items()},
                bs))
            trail.append((float(m["loss"]), float(m["grad_norm"])))
    return trail


@pytest.mark.parametrize("name", list(CASES))
def test_three_train_steps_match_reference(name):
    _, params, stats = reference_variables(name)
    want = reference_trail(name, params)
    model = port_model(name, params, stats)
    state = tts.init_train_state(model, toptim.make_optimizer(OPT))
    step = tts.build_train_step(treg.get(name).forward_loss, state.tx)
    got = []
    for i in range(STEPS):
        state, m = step(state, torch_batch(numpy_batch(name, i)))
        got.append((m["loss"].item(), m["grad_norm"].item()))
    for (gl, gn), (wl, wn) in zip(got, want):
        assert abs(gl - wl) <= 1e-5 * abs(wl), (got, want)
        assert abs(gn - wn) <= 1e-5 * abs(wn), (got, want)
    if stats:   # training never moves the running averages
        for pname, buf in model.named_buffers():
            key, leaf = pname.rsplit(".", 1)
            node = stats
            for part in key.split("."):
                node = node[part]
            assert np.array_equal(buf.numpy(), node[leaf]), pname


@pytest.mark.parametrize("size", [7, 8])
@pytest.mark.parametrize("op", ["conv", "max_pool"])
def test_same_padding_matches_flax(op, size):
    rng = np.random.default_rng(size)
    x = rng.standard_normal((2, size, size + 1, 3)).astype(np.float32)
    if op == "conv":
        ref_mod = fnn.Conv(4, (3, 3), strides=(2, 2), padding="SAME")
        variables = ref_mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
        want = ref_mod.apply(variables, jnp.asarray(x))
        conv = kl.Conv(3, 4, (3, 3), strides=(2, 2), device="cpu")
        conv.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                              variables["params"].items()})
        got = conv(torch.from_numpy(x))
    else:
        want = fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                            padding="SAME")
        got = kl.max_pool(torch.from_numpy(x), (3, 3), (2, 2), "SAME")
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    # even sizes pad (0, 1) at stride 2, where PyTorch's symmetric
    # padding would take (1, 1); odd sizes pad (1, 1)
    assert kl.same_padding(size, 3, 2) == ((1, 1) if size % 2 else (0, 1))


def test_batchnorm_matches_flax():
    # train mode on batch statistics: output and the gradients of input,
    # scale and bias against jax.grad, float32, within 1e-5 of max |ref|
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 6, 6, 16)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    bias = rng.uniform(-0.5, 0.5, 16).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5, dtype=jnp.float32)
    stats = bn.init(jax.random.PRNGKey(0), x)["batch_stats"]

    def f(p, x):
        y, _ = bn.apply({"params": p, "batch_stats": stats}, x,
                        mutable=["batch_stats"])
        return y, jnp.sum(y * ct)

    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    want_y, _ = f(params, x)
    gp, gx = jax.grad(lambda p, x: f(p, x)[1], argnums=(0, 1))(params, x)
    m = kl.BatchNorm(16, device="cpu")
    m.load_state_dict({"scale": torch.from_numpy(scale),
                       "bias": torch.from_numpy(bias),
                       "mean": torch.zeros(16), "var": torch.ones(16)})
    m.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_()
    y = m(xt, True)
    (y * torch.from_numpy(ct)).sum().backward()
    assert y.dtype == torch.float32
    assert rel(y.detach().numpy(), want_y) <= 1e-5
    for got, ref in ((xt.grad, gx), (m.scale.grad, gp["scale"]),
                     (m.bias.grad, gp["bias"])):
        assert rel(got.numpy(), ref) <= 1e-5


def test_resnet_trees_are_checked_leaf_by_leaf():
    _, params, stats = reference_variables("resnet50")
    cfg = treg.get("resnet50").make_model(device="cpu",
                                          **RESNET18).config
    bad = {**params, "classifier": {**params["classifier"],
                                    "kernel": params["classifier"]["kernel"].T}}
    with pytest.raises(ValueError, match="classifier.kernel"):
        convert.from_jax_params(bad, cfg)
    missing = {k: v for k, v in stats.items() if k != "stem_bn"}
    with pytest.raises(ValueError, match="stem_bn"):
        convert.from_jax_params(params, cfg, batch_stats=missing)
