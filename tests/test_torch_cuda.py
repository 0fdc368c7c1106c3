"""Tests of the PyTorch port that need a CUDA card.

Marked ``cuda``; each skips with its reason where there is no card (the
Hopper kernel has no CPU mode).  This file imports no JAX, so it runs on a
machine that has only the port's dependencies:

    python -m pytest tests/test_torch_cuda.py -q
"""

import pytest
import torch

from kubeflow_tpu_torch.ops import flash_attention as tfa
from kubeflow_tpu_torch.ops.matmul import matmul_f32


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels and cuBLAS "
                    "out_dtype products have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_flash_kernel_matches_plain_version(cuda_device, dtype, tol):
    # per element |kernel - plain| <= tol + tol * |plain|: bf16 rounds P for
    # the PV product and O at the end (one bf16 ulp is 2^-7 relative)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn(2, 77, 8, 128, generator=g, device=cuda_device).to(dtype)
    k = torch.randn(2, 130, 2, 128, generator=g, device=cuda_device).to(dtype)
    v = torch.randn(2, 130, 2, 128, generator=g, device=cuda_device).to(dtype)
    before = tfa.flash_attention.launches
    o, lse = tfa.flash_attention_with_lse(q, k, v, causal=True)
    ro, rlse = tfa.flash_attention_reference(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    torch.testing.assert_close(o.float(), ro.float(), atol=tol, rtol=tol)
    assert (lse - rlse).abs().max().item() < 1e-3


@pytest.mark.cuda
def test_flash_kernel_raises_for_unbuilt_head_dim(cuda_device):
    q = torch.zeros(1, 8, 2, 100, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim 100"):
        tfa.flash_attention(q, q, q, causal=True)


@pytest.mark.cuda
def test_f32_accumulating_products(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    a = torch.randn(4, 9, 128, generator=g, device=cuda_device).bfloat16()
    b = torch.randn(4, 300, 128, generator=g, device=cuda_device).bfloat16()
    bt = b.transpose(1, 2)                       # a strided operand
    ref = a.float() @ bt.float()
    out = matmul_f32(a, bt)
    assert out.dtype == torch.float32
    assert (out - ref).abs().max().item() < 1e-4
    assert (matmul_f32(a[0], bt[0]) - ref[0]).abs().max().item() < 1e-4
