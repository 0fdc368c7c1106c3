"""Building blocks of the PyTorch port against the flax modules.

Parameters are made by flax, handed over as numpy, and loaded by name;
inputs are seeded numpy.  float32 agrees to 1e-5 relative to the output
scale (summation order); bfloat16 to 2e-2 (one bf16 rounding of outputs
computed from identically rounded inputs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import layers as jl
from kubeflow_tpu.parallel.sharding import unbox_params
from kubeflow_tpu_torch.models import layers as tl

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def rel_err(out: torch.Tensor, ref) -> float:
    ref = np.asarray(ref, dtype=np.float32)
    return float(np.max(np.abs(out.float().numpy() - ref))
                 / (np.max(np.abs(ref)) + 1e-12))


def x_of(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.standard_normal(shape, dtype=np.float32)
                       ).astype(DT[dtype][0])


def load(module, params):
    module.load_state_dict({k: to_torch(v) for k, v in params.items()})
    return module


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("features", [24, (3, 8)])
def test_dense_general(features, dtype):
    jdt, tdt = DT[dtype]
    x = x_of((2, 5, 16), dtype)
    n_out = 1 if isinstance(features, int) else len(features)
    mod = jl.DenseGeneral(features, axis_names=("embed",) + (None,) * n_out,
                          use_bias=False, dtype=jdt)
    params = unbox_params(mod.init(jax.random.PRNGKey(0), x)["params"])
    ref = mod.apply({"params": params}, x)
    ours = load(tl.DenseGeneral(16, features, dtype=tdt, device="cpu"),
                params)
    out = ours(to_torch(x))
    assert out.dtype == tdt and tuple(out.shape) == ref.shape
    assert rel_err(out, ref) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_and_attend(dtype):
    jdt, tdt = DT[dtype]
    ids = np.random.default_rng(1).integers(0, 40, (2, 6)).astype(np.int32)
    mod = jl.Embed(40, 16, dtype=jdt)
    params = unbox_params(mod.init(jax.random.PRNGKey(0),
                                   jnp.asarray(ids))["params"])
    ours = load(tl.Embed(40, 16, dtype=tdt, device="cpu"), params)
    emb = ours(torch.from_numpy(ids).long())
    ref = mod.apply({"params": params}, jnp.asarray(ids))
    assert emb.dtype == tdt
    assert rel_err(emb, ref) == 0.0            # a gather is exact
    h = x_of((2, 6, 16), dtype, seed=2)
    ref_logits = mod.apply({"params": params}, h, method=jl.Embed.attend)
    logits = ours.attend(to_torch(h))
    assert logits.dtype == torch.float32      # f32 logits at any dtype
    assert rel_err(logits, ref_logits) < 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    jdt, tdt = DT[dtype]
    x = x_of((2, 5, 16), dtype) * 3.0
    mod = jl.RMSNorm(1e-5, jdt)
    params = unbox_params(mod.init(jax.random.PRNGKey(0), x)["params"])
    params = {"scale": np.linspace(0.5, 1.5, 16, dtype=np.float32)}
    ours = load(tl.RMSNorm(16, 1e-5, device="cpu"), params)
    out = ours(to_torch(x))
    assert out.dtype == tdt
    assert rel_err(out, mod.apply({"params": params}, x)) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rotary_embedding(dtype):
    x = x_of((2, 7, 3, 16), dtype)
    pos = np.random.default_rng(3).integers(0, 1000, (2, 7)).astype(np.int32)
    ref = jl.rotary_embedding(x, jnp.asarray(pos), 10000.0)
    out = tl.rotary_embedding(to_torch(x), torch.from_numpy(pos).long(),
                              10000.0)
    assert out.dtype == DT[dtype][1]
    assert rel_err(out, ref) < TOL[dtype]


def test_seeded_init_follows_flax_statistics():
    # lecun_normal over a [in, heads, head_dim] kernel counts fan_in as
    # flax does (in_axis=-2); a unit-scale RMSNorm; normal(0.02) embedding
    gen = torch.Generator().manual_seed(0)
    dense = tl.DenseGeneral(64, (8, 32), dtype=torch.float32, device="cpu")
    dense.init_weights(gen)
    ref = jl.default_kernel_init(jax.random.PRNGKey(0), (64, 8, 32))
    assert abs(float(dense.kernel.std()) / float(jnp.std(ref)) - 1) < 0.1
    assert float(dense.kernel.abs().max()) <= 2 * float(jnp.std(ref)) * 1.2
    emb = tl.Embed(500, 64, device="cpu")
    emb.init_weights(gen)
    assert abs(float(emb.embedding.std()) - 0.02) < 0.002
    norm = tl.RMSNorm(64, device="cpu")
    norm.init_weights(gen)
    assert torch.equal(norm.scale, torch.ones(64))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("features", [24, (3, 8)])
def test_dense_general_with_bias(features, dtype):
    # f32 bias [*features], cast to the compute dtype, added after the
    # product; gradients of kernel and bias as jax.grad gives them
    jdt, tdt = DT[dtype]
    x = x_of((2, 5, 16), dtype)
    n_out = 1 if isinstance(features, int) else len(features)
    mod = jl.DenseGeneral(features, axis_names=("embed",) + (None,) * n_out,
                          use_bias=True, dtype=jdt)
    params = unbox_params(mod.init(jax.random.PRNGKey(0), x)["params"])
    params["bias"] = np.linspace(-1, 1, np.prod(features), dtype=np.float32
                                 ).reshape(params["bias"].shape)
    w = np.random.default_rng(4).standard_normal(
        (2, 5) + ((features,) if n_out == 1 else features)).astype(np.float32)

    def jloss(p):
        return jnp.sum(mod.apply({"params": p}, x).astype(jnp.float32) * w)

    jgrads = jax.grad(jloss)(params)
    ours = load(tl.DenseGeneral(16, features, use_bias=True, dtype=tdt,
                                device="cpu"), params).requires_grad_(True)
    out = ours(to_torch(x))
    assert out.dtype == tdt
    assert rel_err(out.detach(), mod.apply({"params": params}, x)) < TOL[dtype]
    (out.float() * torch.from_numpy(w)).sum().backward()
    for name in ("kernel", "bias"):
        assert rel_err(getattr(ours, name).grad, jgrads[name]) < TOL[dtype]


def test_dense_general_without_bias_keeps_its_state_dict_keys():
    dense = tl.DenseGeneral(16, 8, device="cpu")
    assert list(dense.state_dict()) == ["kernel"]
    assert list(tl.DenseGeneral(16, 8, use_bias=True, device="cpu")
                .state_dict()) == ["kernel", "bias"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm(dtype):
    jdt, tdt = DT[dtype]
    x = x_of((2, 5, 16), dtype) * 3.0 + 1.0
    mod = jl.LayerNorm(1e-12, jdt)
    mod.init(jax.random.PRNGKey(0), x)
    params = {"scale": np.linspace(0.5, 1.5, 16, dtype=np.float32),
              "bias": np.linspace(-0.2, 0.2, 16, dtype=np.float32)}
    ours = load(tl.LayerNorm(16, 1e-12, device="cpu"), params)
    out = ours(to_torch(x))
    assert out.dtype == tdt
    assert rel_err(out, mod.apply({"params": params}, x)) < TOL[dtype]
    gen = torch.Generator().manual_seed(0)
    ours.init_weights(gen)
    assert torch.equal(ours.scale, torch.ones(16))
    assert torch.equal(ours.bias, torch.zeros(16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_f32_gradients_match_jax(dtype):
    # the tied decoder's product: operands in the compute dtype, float32
    # result; gradients are the float32 cotangent times the other operand
    # (float32 sums), rounded to the operand's dtype, as jax.grad gives
    from kubeflow_tpu_torch.ops.matmul import matmul_f32

    jdt, tdt = DT[dtype]
    a, b = x_of((6, 16), dtype, seed=5), x_of((40, 16), dtype, seed=6)
    w = np.random.default_rng(7).standard_normal((6, 40)).astype(np.float32)

    def jloss(a, b):
        y = jnp.einsum("...d,vd->...v", a, b,
                       preferred_element_type=jnp.float32)
        return jnp.sum(y * w)

    ja, jb = jax.grad(jloss, argnums=(0, 1))(a, b)
    ta, tb = (to_torch(t).requires_grad_() for t in (a, b))
    out = matmul_f32(ta, tb.T)
    assert out.dtype == torch.float32
    (out * torch.from_numpy(w)).sum().backward()
    assert ta.grad.dtype == tb.grad.dtype == tdt
    # float32 sums in another order; bf16 gradients may round one ulp apart
    tol = {"float32": 1e-5, "bfloat16": 2 ** -7}[dtype]
    assert rel_err(ta.grad, ja) < tol and rel_err(tb.grad, jb) < tol
