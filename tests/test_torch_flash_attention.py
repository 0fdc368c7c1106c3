"""Flash-attention forward of the PyTorch port against the JAX reference.

On the CPU the port's ``flash_attention`` runs its plain version; these
tests hold that version (the math the Hopper kernel implements) against
the Pallas kernel run through the Pallas interpreter, on O and on the
log-sum-exp residual, and against ``_xla_attention`` at the shapes the
Pallas kernel cannot take (ragged lengths, GQA without a repeat).  The
kernel itself is compared with its plain version on the card by
``chip_smoke.py`` and by ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops import flash_attention as jfa
from kubeflow_tpu.ops.attention import _xla_attention
from kubeflow_tpu_torch.ops import flash_attention as tfa


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jfa, "INTERPRET", True)


DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def at_head_dims(rows, rows_256):
    """Cases at head_dim 64 under their ids of before, then cases at 256
    (Gemma-2B's head_dim, which the reference's ``supported()`` admits),
    their ids marked ``d256``: rows of the parameters without ``d``."""
    return ([pytest.param(*r, 64, id="-".join(map(str, r))) for r in rows]
            + [pytest.param(*r, 256, id="-".join(map(str, r)) + "-d256")
               for r in rows_256])


def make_qkv(seed, b, sq, sk, h, hkv, d, dtype):
    """Same numbers for both frameworks: numpy f32, rounded to ``dtype``
    once, on the JAX side, and handed over bit for bit."""
    rng = np.random.default_rng(seed)
    jdt, _ = DTYPES[dtype]
    arrs = [jnp.asarray(rng.standard_normal(s, dtype=np.float32)).astype(jdt)
            for s in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d))]
    return arrs, [to_torch(a) for a in arrs]


def to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def max_err(t: torch.Tensor, ref) -> float:
    return float(np.max(np.abs(t.float().numpy()
                               - np.asarray(ref, dtype=np.float32))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,sq,sk,d", at_head_dims(
    [(False, 256, 256), (True, 256, 256), (True, 128, 384)],
    [(False, 128, 256), (True, 128, 128), (True, 128, 384)]))
def test_matches_pallas_kernel_o_and_lse(causal, sq, sk, d, dtype):
    (jq, jk, jv), (q, k, v) = make_qkv(0, 2, sq, sk, 2, 2, d, dtype)
    ref_o, res = jfa._flash_fwd(jq, jk, jv, causal=causal, block_q=256,
                                block_k=256)
    ref_lse = np.asarray(res[4]).reshape(2, 2, sq)   # [B*H, Sq, 1]
    o, lse = tfa.flash_attention_with_lse(q, k, v, causal=causal)
    assert o.dtype == DTYPES[dtype][1] and o.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == (2, 2, sq)
    assert max_err(o, ref_o) < TOL[dtype]
    assert max_err(lse, ref_lse) < 1e-4
    assert torch.equal(tfa.flash_attention(q, k, v, causal=causal), o)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,sq,sk,h,hkv,d", at_head_dims([
    (True, 37, 101, 4, 2),      # ragged, decode offset, GQA
    (True, 32, 32, 4, 4),       # the short-prompt prefill shape
    (False, 50, 77, 4, 1),      # non-causal, multi-query
], [
    (True, 37, 101, 2, 1),      # ragged, decode offset, multi-query
    (False, 50, 77, 2, 2),      # non-causal, ragged
]))
def test_ragged_and_gqa_match_xla_reference(causal, sq, sk, h, hkv, d,
                                            dtype):
    (jq, jk, jv), (q, k, v) = make_qkv(1, 2, sq, sk, h, hkv, d, dtype)
    ref = _xla_attention(jq, jk, jv, causal=causal, mask=None,
                         softmax_dtype=jnp.float32)
    out = tfa.flash_attention(q, k, v, causal=causal)
    assert max_err(out, ref) < TOL[dtype]


def test_cpu_tensors_launch_nothing():
    _, (q, k, v) = make_qkv(2, 1, 16, 16, 2, 2, 64, "float32")
    before = tfa.flash_attention.launches
    tfa.flash_attention(q, k, v, causal=True)
    assert tfa.flash_attention.launches == before


def test_kernel_rejects_unbuilt_head_dim_before_building():
    # head_dim 100 (llama_3b) has no kernel instantiation: ValueError, not
    # a build or a fallback
    q = torch.zeros(1, 8, 2, 100)
    with pytest.raises(ValueError, match="head_dim 100"):
        tfa._launch(q, q, q, causal=True)


def _view(kind: str) -> torch.Tensor:
    """A [B, S, H, D] CPU view of the given kind (see the cases below)."""
    bf = torch.bfloat16
    if kind == "contiguous":
        return torch.zeros(2, 9, 4, 64, dtype=bf)
    if kind == "bhsd_transposed":      # a [B, H, S, D] tensor seen [B, S, H, D]
        return torch.zeros(2, 4, 9, 64, dtype=bf).transpose(1, 2)
    if kind == "odd_row_offset":       # rows 1.. of a cache: 512-byte steps
        return torch.zeros(2, 9, 4, 64, dtype=bf)[:, 1:]
    if kind == "odd_element_offset":   # base 2 bytes past an aligned one
        return torch.zeros(2, 9, 4, 72, dtype=bf)[..., 1:65]
    if kind == "head_stride_68":       # heads 136 bytes apart
        return torch.zeros(2, 9, 4, 68, dtype=bf)[..., :64]
    if kind == "float32":
        return torch.zeros(2, 9, 4, 64)
    raise ValueError(kind)


@pytest.mark.parametrize("kind,ok", [
    ("contiguous", True), ("bhsd_transposed", True), ("odd_row_offset", True),
    ("odd_element_offset", False), ("head_stride_68", False),
    ("float32", False)])
def test_tma_compatible(kind, ok):
    # what the bf16 kernels' TMA loads take: a 16-byte aligned base and
    # batch / sequence / head strides that are multiples of 8 elements
    assert tfa._tma_compatible(_view(kind)) is ok


@pytest.mark.parametrize("bad", ["shape", "dtype", "device"])
def test_wrapper_validates_inputs(bad):
    q = torch.zeros(1, 8, 4, 64)
    k = torch.zeros(1, 8, 2, 64)
    v = k
    if bad == "shape":
        k = torch.zeros(1, 8, 3, 64)            # 4 heads over 3 kv heads
        v = k
    elif bad == "dtype":
        k = k.half()
        v = k
    else:
        q, k, v = (t.to("meta") for t in (q, k, v))
    with pytest.raises(ValueError):
        tfa.flash_attention(q, k, v)

