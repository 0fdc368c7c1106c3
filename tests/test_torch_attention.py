"""Masked grouped attention of the PyTorch port against ``_xla_attention``.

Same numpy inputs (seeded) through both; GQA runs grouped on both sides,
masks are head-broadcast ``[B, 1, Sq, Sk]`` or per query head
``[B, H, Sq, Sk]``.  Tolerances: float32 1e-5 (summation order), bfloat16
2e-2 (one bf16 rounding of the output at |O| ~ 2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops.attention import _xla_attention
from kubeflow_tpu_torch.ops.attention import (dot_product_attention,
                                              plain_attention)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def inputs(seed, b, sq, sk, h, hkv, d, dtype, mask_heads):
    rng = np.random.default_rng(seed)
    jdt = jnp.dtype(dtype)
    qkv = [jnp.asarray(rng.standard_normal(s, dtype=np.float32)).astype(jdt)
           for s in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d))]
    mask = None
    if mask_heads:
        mask = rng.random((b, mask_heads, sq, sk)) < 0.7
        mask[..., 0] = True       # every query sees at least one key
    return qkv, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,hkv,mask_heads,causal", [
    (4, 2, 1, False),    # grouped, head-broadcast mask
    (4, 2, 4, False),    # grouped, per-head mask folds H into (Hkv, G)
    (4, 4, 4, True),     # ungrouped, per-head mask and causal together
    (6, 2, 1, True),     # grouped, head-broadcast, causal decode offset
])
def test_masked_attention_matches_xla(h, hkv, mask_heads, causal, dtype):
    (jq, jk, jv), mask = inputs(0, 2, 5, 11, h, hkv, 16, dtype, mask_heads)
    ref = _xla_attention(jq, jk, jv, causal=causal, mask=jnp.asarray(mask),
                         softmax_dtype=jnp.float32)
    out = plain_attention(to_torch(jq), to_torch(jk), to_torch(jv),
                          causal=causal, mask=torch.from_numpy(mask))
    assert out.dtype == to_torch(ref).dtype
    err = np.max(np.abs(out.float().numpy()
                        - np.asarray(ref, dtype=np.float32)))
    assert err < TOL[dtype]


def test_wider_value_dtype_promotes_like_the_reference():
    # an f32 KV view under a bf16 model: weights round to bf16, then the
    # PV product runs in float32 (jnp's promotion)
    (jq, jk, jv), mask = inputs(1, 1, 3, 9, 4, 2, 16, "bfloat16", 1)
    jk32, jv32 = jk.astype(jnp.float32), jv.astype(jnp.float32)
    ref = _xla_attention(jq, jk32, jv32, causal=False,
                         mask=jnp.asarray(mask), softmax_dtype=jnp.float32)
    out = plain_attention(to_torch(jq), to_torch(jk32), to_torch(jv32),
                          causal=False, mask=torch.from_numpy(mask))
    assert out.dtype == torch.float32
    assert np.max(np.abs(out.numpy() - np.asarray(ref))) < 1e-5


def test_dispatch_flash_only_when_unmasked():
    (jq, jk, jv), mask = inputs(2, 1, 7, 7, 4, 2, 16, "float32", 1)
    q, k, v = to_torch(jq), to_torch(jk), to_torch(jv)
    plain = plain_attention(q, k, v, causal=True)
    flash = dot_product_attention(q, k, v, causal=True, use_flash=True)
    assert torch.allclose(flash, plain, atol=1e-6)
    m = torch.from_numpy(mask)
    assert torch.equal(
        dot_product_attention(q, k, v, mask=m, use_flash=True),
        plain_attention(q, k, v, causal=False, mask=m))

