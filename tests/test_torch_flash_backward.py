"""Flash-attention backward of the PyTorch port against the JAX reference.

On the CPU the port's ``flash_attention`` is a ``torch.autograd.Function``
whose backward runs the plain versions of the two backward kernels (the
math ``csrc/flash_bwd.cu`` implements).  These tests hold its gradients
against ``jax.grad`` through ``kubeflow_tpu.ops.flash_attention``, whose
backward is the two Pallas kernels run through the Pallas interpreter,
and, at the shapes those kernels cannot take (ragged lengths, GQA), against
``jax.grad`` through ``_xla_attention``.  The kernels themselves are held
against the plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

Tolerance: max |dX_port - dX_ref| / max |dX_ref| per gradient, 1e-4 in
float32 and 4e-2 in bfloat16 (``tests/test_flash_attention.py``'s).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops import flash_attention as jfa
from kubeflow_tpu.ops.attention import _xla_attention
from kubeflow_tpu_torch.ops import flash_attention as tfa
from kubeflow_tpu_torch.ops.attention import plain_attention


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jfa, "INTERPRET", True)


DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 4e-2}


def to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def make_inputs(seed, b, sq, sk, h, hkv, d, dtype):
    """q, k, v rounded to ``dtype`` once on the JAX side and handed over
    bit for bit, and a float32 output weighting ``w`` (a weighted sum
    exercises every output position asymmetrically)."""
    rng = np.random.default_rng(seed)
    jdt, _ = DTYPES[dtype]
    qkv = [jnp.asarray(rng.standard_normal(s, dtype=np.float32)).astype(jdt)
           for s in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d))]
    w = rng.standard_normal((b, sq, h, d), dtype=np.float32)
    return qkv, w


def port_grads(qkv, w, fn):
    q, k, v = (to_torch(a).requires_grad_() for a in qkv)
    out = fn(q, k, v)
    (out.float() * torch.from_numpy(w)).sum().backward()
    return out, [t.grad for t in (q, k, v)]


def jax_grads(qkv, w, fn):
    def loss(q, k, v):
        return jnp.sum(fn(q, k, v).astype(jnp.float32) * w)

    return jax.grad(loss, argnums=(0, 1, 2))(*qkv)


def assert_grads_close(got, want, dtype):
    for name, g, r in zip("qkv", got, want):
        r = np.asarray(r, dtype=np.float32)
        assert g.dtype == DTYPES[dtype][1] and tuple(g.shape) == r.shape
        rel = np.abs(g.float().numpy() - r).max() / (np.abs(r).max() + 1e-6)
        assert rel < GRAD_TOL[dtype], f"d{name}: rel err {rel:.3e}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,s", [(False, 128), (True, 128),
                                      (False, 256), (True, 256)])
def test_backward_matches_pallas_kernels(causal, s, dtype):
    qkv, w = make_inputs(0, 2, s, s, 2, 2, 64, dtype)
    want = jax_grads(qkv, w, lambda q, k, v: jfa.flash_attention(
        q, k, v, causal=causal))
    _, got = port_grads(qkv, w, lambda q, k, v: tfa.flash_attention(
        q, k, v, causal=causal))
    assert_grads_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,sq,sk,h,hkv", [
    (True, 37, 101, 4, 2),      # ragged, decode offset, GQA
    (False, 50, 77, 4, 1),      # non-causal, multi-query
    (True, 128, 384, 2, 2),     # the reference's decode-offset case
])
def test_backward_ragged_and_gqa_match_xla_reference(causal, sq, sk, h, hkv,
                                                     dtype):
    qkv, w = make_inputs(1, 2, sq, sk, h, hkv, 64, dtype)
    want = jax_grads(qkv, w, lambda q, k, v: _xla_attention(
        q, k, v, causal=causal, mask=None, softmax_dtype=jnp.float32))
    _, got = port_grads(qkv, w, lambda q, k, v: tfa.flash_attention(
        q, k, v, causal=causal))
    assert_grads_close(got, want, dtype)


def test_backward_is_the_plain_backward_on_cpu():
    # the Function's CPU backward is exactly flash_attention_backward_reference
    # and launches no kernel
    qkv, w = make_inputs(2, 1, 40, 40, 4, 2, 64, "float32")
    before = (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches)
    out, got = port_grads(qkv, w, lambda q, k, v: tfa.flash_attention(
        q, k, v, causal=True))
    q, k, v = (to_torch(a) for a in qkv)
    o, lse = tfa.flash_attention_with_lse(q, k, v, causal=True)
    want = tfa.flash_attention_backward_reference(
        q, k, v, o, lse, torch.from_numpy(w), causal=True)
    for g, r in zip(got, want):
        assert torch.equal(g, r)
    assert (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches) == before


def test_backward_matches_autograd_of_plain_attention():
    # an independent yardstick in the port itself: autograd through the
    # dispatcher's plain route (float32, summation order only)
    qkv, w = make_inputs(3, 2, 70, 90, 4, 2, 64, "float32")
    _, got = port_grads(qkv, w, lambda q, k, v: tfa.flash_attention(
        q, k, v, causal=True))
    _, want = port_grads(qkv, w, lambda q, k, v: plain_attention(
        q, k, v, causal=True))
    for g, r in zip(got, want):
        assert (g - r).abs().max() / r.abs().max() < 1e-5


def test_strided_cotangent_goes_in_as_a_view():
    # BERT reshapes the attention output to [B, S, H*D]: the cotangent
    # arrives as a view of that; a non-unit innermost stride is copied
    qkv, w = make_inputs(4, 1, 32, 32, 2, 2, 64, "float32")
    q, k, v = (to_torch(a) for a in qkv)
    o, lse = tfa.flash_attention_with_lse(q, k, v)
    do = torch.from_numpy(w)
    ref = tfa.flash_attention_backward(q, k, v, o, lse, do)
    odd = torch.from_numpy(np.ascontiguousarray(w.transpose(0, 1, 3, 2)))
    strided = odd.transpose(2, 3)          # same values, innermost stride 2
    assert strided.stride(3) != 1
    for a, b in zip(tfa.flash_attention_backward(q, k, v, o, lse, strided),
                    ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["do_shape", "do_dtype", "device"])
def test_backward_wrappers_validate_inputs(bad):
    q = torch.zeros(1, 8, 4, 64)
    k = torch.zeros(1, 8, 2, 64)
    do = torch.zeros(1, 8, 4, 64)
    lse = delta = torch.zeros(1, 4, 8)
    if bad == "do_shape":
        do = torch.zeros(1, 8, 2, 64)
    elif bad == "do_dtype":
        do = do.bfloat16()
    else:
        q, k, do = (t.to("meta") for t in (q, k, do))
    for fn in (tfa.flash_bwd_dq, tfa.flash_bwd_dkv):
        with pytest.raises(ValueError):
            fn(q, k, k, do, lse, delta)
