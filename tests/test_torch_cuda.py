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


BWD_CASES = [  # (B, Sq, Sk, H, Hkv, D, causal)
    (2, 200, 200, 4, 4, 64, False),     # ragged tails
    (2, 256, 256, 4, 4, 64, True),
    (1, 77, 130, 8, 2, 128, True),      # GQA, decode offset, ragged
    (1, 128, 128, 4, 4, 128, False),
    (2, 300, 100, 4, 2, 64, False),     # more queries than keys
    (1, 40, 33, 2, 2, 64, True),        # less than one tile each way
]
# |kernel - plain| / max |plain| per gradient.  f32: summation order only.
# bf16: the kernels round P and dS to bf16 for their products (2^-8
# relative per weight) and the gradients to bf16 at the end (2^-8).
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_backward_kernels_match_plain_version(cuda_device, dtype,
                                                    case, strided):
    b, sq, sk, h, hkv, d, causal = case
    g = torch.Generator(device=cuda_device).manual_seed(1)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=cuda_device).to(dtype)

    if strided:   # [B, H, S, D] tensors viewed as [B, S, H, D]
        q, do = (randn(b, h, sq, d).transpose(1, 2) for _ in range(2))
        k, v = (randn(b, hkv, sk, d).transpose(1, 2) for _ in range(2))
    else:
        q, k = randn(b, sq, h, d), randn(b, sk, hkv, d)
        v, do = randn(b, sk, hkv, d), randn(b, sq, h, d)
    o, lse = tfa.flash_attention_with_lse(q, k, v, causal=causal)
    delta = tfa.flash_bwd_delta(o, do)
    before = (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches)
    got = (tfa.flash_bwd_dq(q, k, v, do, lse, delta, causal=causal),
           *tfa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal))
    want = (tfa.flash_bwd_dq_reference(q, k, v, do, lse, delta,
                                       causal=causal),
            *tfa.flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                         causal=causal))
    torch.cuda.synchronize()
    assert (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    for name, x, ref in zip(("dq", "dk", "dv"), got, want):
        assert x.dtype == dtype and x.shape == ref.shape
        rel = ((x.float() - ref.float()).abs().max()
               / ref.float().abs().max()).item()
        assert rel < BWD_TOL[dtype], f"{name}: {rel:.3e}"


WGMMA_CASES = [  # (B, Sq, Sk, H, Hkv, D, causal): no length a multiple of 128
    (1, 1, 63, 4, 2, 128, True),        # one query, decode offset
    (2, 63, 129, 8, 8, 64, False),
    (1, 129, 200, 32, 8, 128, True),    # GQA 32 over 8, Sk > Sq
    (1, 200, 1500, 32, 8, 64, True),
    (1, 1500, 1500, 4, 4, 128, True),
    (2, 200, 63, 4, 2, 64, False),      # more queries than keys
]


def _bf16_inputs(device, b, sq, sk, h, hkv, d, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(*shape, generator=g, device=device).bfloat16()
            for shape in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d),
                          (b, sq, h, d))]


@pytest.mark.cuda
@pytest.mark.parametrize("case", WGMMA_CASES)
def test_wgmma_forward_matches_plain_version(cuda_device, case):
    # the tolerance of test_flash_kernel_matches_plain_version, bf16
    b, sq, sk, h, hkv, d, causal = case
    q, k, v, _ = _bf16_inputs(cuda_device, *case[:6], seed=3)
    o, lse = tfa.flash_attention_with_lse(q, k, v, causal=causal)
    ro, rlse = tfa.flash_attention_reference(q, k, v, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), ro.float(), atol=1e-2, rtol=1e-2)
    assert (lse - rlse).abs().max().item() < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("case", WGMMA_CASES)
def test_wgmma_dkv_matches_plain_version(cuda_device, case):
    b, sq, sk, h, hkv, d, causal = case
    q, k, v, do = _bf16_inputs(cuda_device, *case[:6], seed=4)
    o, lse = tfa.flash_attention_with_lse(q, k, v, causal=causal)
    delta = tfa.flash_bwd_delta(o, do)
    got = tfa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal)
    want = tfa.flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                       causal=causal)
    torch.cuda.synchronize()
    for name, x, ref in zip(("dk", "dv"), got, want):
        rel = ((x.float() - ref.float()).abs().max()
               / ref.float().abs().max()).item()
        assert rel < BWD_TOL[torch.bfloat16], f"{name}: {rel:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("case", WGMMA_CASES)
def test_wgmma_dq_matches_plain_version(cuda_device, case):
    b, sq, sk, h, hkv, d, causal = case
    q, k, v, do = _bf16_inputs(cuda_device, *case[:6], seed=7)
    o, lse = tfa.flash_attention_with_lse(q, k, v, causal=causal)
    delta = tfa.flash_bwd_delta(o, do)
    dq = tfa.flash_bwd_dq(q, k, v, do, lse, delta, causal=causal)
    ref = tfa.flash_bwd_dq_reference(q, k, v, do, lse, delta, causal=causal)
    torch.cuda.synchronize()
    rel = ((dq.float() - ref.float()).abs().max()
           / ref.float().abs().max()).item()
    assert rel < BWD_TOL[torch.bfloat16], f"dq: {rel:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_wgmma_dq_is_bitwise_reproducible(cuda_device, causal):
    # each work tile owns its rows of dQ (no atomics), so two launches on
    # the same inputs give the same bits
    q, k, v, do = _bf16_inputs(cuda_device, 2, 300, 300, 8, 2, 64, seed=8)
    o, lse = tfa.flash_attention_with_lse(q, k, v, causal=causal)
    delta = tfa.flash_bwd_delta(o, do)
    first = tfa.flash_bwd_dq(q, k, v, do, lse, delta, causal=causal)
    second = tfa.flash_bwd_dq(q, k, v, do, lse, delta, causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["flash_attention", "flash_bwd_dq",
                                    "flash_bwd_dkv"])
@pytest.mark.parametrize("bad", ["base", "head_stride"])
def test_misaligned_bf16_views_raise(cuda_device, bad, kernel):
    # TMA takes 16-byte aligned bases and strides: such a view raises
    # before any launch, naming the tensor
    q, k, v, do = _bf16_inputs(cuda_device, 1, 64, 64, 2, 2, 64, seed=5)
    if bad == "base":
        flat = torch.zeros(q.numel() + 1, dtype=q.dtype, device=cuda_device)
        k = flat[1:].view(q.shape).copy_(k)
    else:
        wide = torch.zeros(1, 64, 2, 68, dtype=q.dtype, device=cuda_device)
        k = wide[..., :64].copy_(k)
    o, lse = tfa.flash_attention_with_lse(q, q, v)
    delta = tfa.flash_bwd_delta(o, do)
    calls = {
        "flash_attention": lambda: tfa.flash_attention_with_lse(q, k, v),
        "flash_bwd_dq": lambda: tfa.flash_bwd_dq(q, k, v, do, lse, delta),
        "flash_bwd_dkv": lambda: tfa.flash_bwd_dkv(q, k, v, do, lse, delta),
    }
    before = getattr(tfa, kernel).launches
    with pytest.raises(ValueError, match="^k "):
        calls[kernel]()
    assert getattr(tfa, kernel).launches == before


@pytest.mark.cuda
def test_each_kernel_counts_its_launches(cuda_device):
    q, k, v, do = _bf16_inputs(cuda_device, 1, 100, 100, 4, 4, 64, seed=6)
    names = ("flash_attention", "flash_bwd_dq", "flash_bwd_dkv")

    def counts():
        return [getattr(tfa, n).launches for n in names]

    start = counts()
    o, lse = tfa.flash_attention_with_lse(q, k, v, causal=True)
    assert counts() == [start[0] + 1, start[1], start[2]]
    delta = tfa.flash_bwd_delta(o, do)
    tfa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=True)
    assert counts() == [start[0] + 1, start[1], start[2] + 1]
    tfa.flash_bwd_dq(q, k, v, do, lse, delta, causal=True)
    assert counts() == [start[0] + 1, start[1] + 1, start[2] + 1]
    tfa.flash_attention_reference(q, k, v, causal=True)   # plain: no launch
    assert counts() == [start[0] + 1, start[1] + 1, start[2] + 1]


@pytest.mark.cuda
def test_flash_autograd_runs_the_backward_kernels(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    q, k, v = (torch.randn(2, 96, 4, 64, generator=g, device=cuda_device)
               .bfloat16().requires_grad_() for _ in range(3))
    before = (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches)
    tfa.flash_attention(q, k, v).float().square().sum().backward()
    assert (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    assert all(torch.isfinite(t.grad.float()).all() for t in (q, k, v))


@pytest.mark.cuda
def test_k1_causal_multi_wave_matches_plain_version(cuda_device):
    # Llama training's attention shape: 2048 causal work tiles of unequal
    # length, one block each (15.5 waves over 132 SMs); tolerances as
    # test_flash_kernel_matches_plain_version's bf16 case
    g = torch.Generator(device=cuda_device).manual_seed(7)
    q, k, v = (torch.randn(16, 512, 32, 128, generator=g, device=cuda_device)
               .bfloat16() for _ in range(3))
    o, lse = tfa.flash_attention_with_lse(q, k, v, causal=True)
    ro, rlse = tfa.flash_attention_reference(q, k, v, causal=True)
    torch.testing.assert_close(o.float(), ro.float(), atol=1e-2, rtol=1e-2)
    assert (lse - rlse).abs().max().item() < 1e-3


@pytest.mark.cuda
def test_llama_width_train_step_kernels_match_plain_route(cuda_device):
    # two layers at Llama-2-7B width, bf16 compute, float32 masters: one
    # step's loss and grad_norm through K1-K3 against the plain masked
    # attention route on the same weights and batch (learning rate 0), to
    # chip_smoke.py's STEP_TOL (1e-3, 5e-3 relative)
    import dataclasses

    from kubeflow_tpu_torch.models import registry
    from kubeflow_tpu_torch.parallel import train_step as ts
    from kubeflow_tpu_torch.training.optim import make_optimizer

    entry = registry.get("llama")
    model = entry.make_model(size="7b", num_layers=2,
                             device=cuda_device).init_weights(0)
    assert model.tok_embeddings.embedding.dtype == torch.float32
    state = ts.init_train_state(model, make_optimizer(
        {"name": "sgd", "learning_rate": 0.0, "momentum": 0.0}))
    step = ts.build_train_step(entry.forward_loss, state.tx)
    batch = {k: v.to(cuda_device) for k, v in entry.make_batch(
        2, torch.Generator().manual_seed(0), model).items()}
    names = ("flash_attention", "flash_bwd_dq", "flash_bwd_dkv")
    before = [getattr(tfa, n).launches for n in names]
    _, kern = step(state, batch)
    kern = {k: v.item() for k, v in kern.items()}
    assert [getattr(tfa, n).launches - b
            for n, b in zip(names, before)] == [4, 2, 2]
    flash_cfg = model.layers[0].attention.cfg
    for blk in model.layers:
        blk.attention.cfg = dataclasses.replace(flash_cfg, use_flash=False)
    _, plain = step(state, batch)
    for key, tol in (("loss", 1e-3), ("grad_norm", 5e-3)):
        assert abs(kern[key] - plain[key].item()) <= tol * abs(
            plain[key].item()), (key, kern, plain)


@pytest.mark.cuda
def test_adamw_update_holds_one_chunk_of_temporaries(cuda_device):
    # 1 B float32 parameters in 64 tensors: a list-wide update made two
    # model-sized temporaries (8 bytes per parameter); chunked, the update
    # raises the peak by its temporaries over one tensor's worth of
    # elements (adam's denominator and update: 2 tensors)
    from kubeflow_tpu_torch.training.optim import global_norm, make_optimizer

    n, count = 15_625_000, 64
    params = [torch.zeros(n, device=cuda_device) for _ in range(count)]
    grads = [torch.full((n,), 1e-3, device=cuda_device)
             for _ in range(count)]
    tx = make_optimizer({"name": "adamw", "learning_rate": 1e-3,
                         "weight_decay": 0.01})
    tx.init(params)
    norm = global_norm(grads)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tx.update(params, grads, norm)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < 3 * n * 4
    assert torch.isfinite(params[-1]).all()
    del params, grads, tx
    torch.cuda.empty_cache()
