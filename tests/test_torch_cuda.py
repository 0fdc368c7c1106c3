"""Tests of the PyTorch port that need a CUDA card.

Marked ``cuda``; each skips with its reason where there is no card (the
Hopper kernel has no CPU mode).  This file imports no JAX, so it runs on a
machine that has only the port's dependencies:

    python -m pytest tests/test_torch_cuda.py -q
"""

import json

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


D256_CASES = [  # (B, Sq, Sk, H, Hkv, D, causal): Gemma-2B's head_dim
    (1, 2048, 2048, 8, 1, 256, True),   # multi-query, one long sequence
    (2, 200, 200, 8, 1, 256, True),     # ragged, multi-query
    (1, 129, 200, 8, 2, 256, True),     # GQA, decode offset, ragged
    (2, 100, 300, 4, 4, 256, False),    # non-causal
    (2, 300, 100, 4, 2, 256, False),    # more queries than keys
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", D256_CASES)
def test_d256_kernels_match_plain_version(cuda_device, case, dtype):
    # K1 (O and lse), K2 and K3 at head_dim 256, each one launch, against
    # their plain versions: the tolerances above
    b, sq, sk, h, hkv, d, causal = case
    g = torch.Generator(device=cuda_device).manual_seed(9)
    q, k, v, do = (torch.randn(*shape, generator=g, device=cuda_device)
                   .to(dtype) for shape in ((b, sq, h, d), (b, sk, hkv, d),
                                            (b, sk, hkv, d), (b, sq, h, d)))
    before = (tfa.flash_attention.launches, tfa.flash_bwd_dq.launches,
              tfa.flash_bwd_dkv.launches)
    o, lse = tfa.flash_attention_with_lse(q, k, v, causal=causal)
    delta = tfa.flash_bwd_delta(o, do)
    got = (tfa.flash_bwd_dq(q, k, v, do, lse, delta, causal=causal),
           *tfa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal))
    ro, rlse = tfa.flash_attention_reference(q, k, v, causal=causal)
    want = (tfa.flash_bwd_dq_reference(q, k, v, do, lse, delta,
                                       causal=causal),
            *tfa.flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                         causal=causal))
    torch.cuda.synchronize()
    assert (tfa.flash_attention.launches, tfa.flash_bwd_dq.launches,
            tfa.flash_bwd_dkv.launches) == tuple(n + 1 for n in before)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(o.float(), ro.float(), atol=tol, rtol=tol)
    assert (lse - rlse).abs().max().item() < 1e-3
    for name, x, ref in zip(("dq", "dk", "dv"), got, want):
        assert x.dtype == dtype and x.shape == ref.shape
        rel = ((x.float() - ref.float()).abs().max()
               / ref.float().abs().max()).item()
        assert rel < BWD_TOL[dtype], f"{name}: {rel:.3e}"


@pytest.mark.cuda
def test_wgmma_dq_d256_is_bitwise_reproducible(cuda_device):
    q, k, v, do = _bf16_inputs(cuda_device, 2, 300, 300, 8, 1, 256, seed=10)
    o, lse = tfa.flash_attention_with_lse(q, k, v, causal=True)
    delta = tfa.flash_bwd_delta(o, do)
    first = tfa.flash_bwd_dq(q, k, v, do, lse, delta, causal=True)
    second = tfa.flash_bwd_dq(q, k, v, do, lse, delta, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_d256_dispatch_launches_k1(cuda_device):
    # at head_dim 256 the dispatcher's flash route launches K1 (no plain
    # route, no library attention): the kernel's output, one launch
    from kubeflow_tpu_torch.ops.attention import dot_product_attention

    q, k, v, _ = _bf16_inputs(cuda_device, 1, 300, 300, 8, 1, 256, seed=11)
    before = tfa.flash_attention.launches
    out = dot_product_attention(q, k, v, causal=True, use_flash=True)
    assert tfa.flash_attention.launches == before + 1
    assert torch.equal(out, tfa.flash_attention_with_lse(q, k, v,
                                                         causal=True)[0])


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


@pytest.mark.cuda
def test_unbuilt_head_dim_runs_the_plain_route(cuda_device):
    # OpenLLaMA-3B's head_dim 100: the dispatcher takes the plain route
    # (no launch, no raise) and gives plain_attention's output exactly
    from kubeflow_tpu_torch.ops.attention import (dot_product_attention,
                                                  plain_attention)

    g = torch.Generator(device=cuda_device).manual_seed(8)
    q, k, v = (torch.randn(1, 300, 32, 100, generator=g, device=cuda_device)
               .bfloat16() for _ in range(3))
    before = tfa.flash_attention.launches
    out = dot_product_attention(q, k, v, causal=True, use_flash=True)
    assert tfa.flash_attention.launches == before
    assert torch.equal(out, plain_attention(q, k, v, causal=True))


@pytest.mark.cuda
def test_pool_seed_and_commit_are_bitwise_page_copies(cuda_device):
    # the engine's commit (one scatter per layer) and seed (one gather per
    # layer) at bf16 against a plain loop over pages
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.serving.page_pool import PagePool

    cfg = llama.llama_tiny()
    ps, n = 16, 5
    pool = PagePool(12, ps, host_pages=4,
                    kv=llama.init_kv_pool(cfg, 12, ps, device=cuda_device))
    g = torch.Generator(device=cuda_device).manual_seed(9)
    scratch = [tuple(torch.randn(n * ps, cfg.num_kv_heads, cfg.head_dim,
                                 generator=g, device=cuda_device).bfloat16()
                     for _ in range(2)) for _ in range(cfg.num_layers)]
    ids = pool.alloc(n)
    pool.put_many(ids, scratch)
    for i, p in enumerate(ids):
        for layer, (k, v) in zip(pool.get(p)["layers"], scratch):
            assert torch.equal(layer["k"], k[i * ps:(i + 1) * ps])
            assert torch.equal(layer["v"], v[i * ps:(i + 1) * ps])
    # spill two pages to the pinned arena and fault them back first
    assert pool.spill(ids[:2]) == ids[:2]
    assert pool.fault(ids[:2]) == 2
    order = ids[::-1]
    out = [tuple(torch.empty_like(t) for t in layer) for layer in scratch]
    pool.gather(order, out)
    for (k, v), (sk, sv) in zip(out, scratch):
        for i, p in enumerate(order):
            j = ids.index(p)
            assert torch.equal(k[i * ps:(i + 1) * ps], sk[j * ps:(j + 1) * ps])
            assert torch.equal(v[i * ps:(i + 1) * ps], sv[j * ps:(j + 1) * ps])


@pytest.mark.cuda
def test_paged_branch_matches_contiguous_on_the_card(cuda_device):
    # tiny Llama in bf16 on the card, both caches through the plain masked
    # route over the same 64 key positions: the same products on the same
    # values, so the logits agree to 1e-6 of max |logit| (bitwise expected)
    from kubeflow_tpu_torch.models import llama

    model = llama.LlamaModel(llama.llama_tiny(),
                             device=cuda_device).init_weights(0)
    cfg = model.config
    ids = torch.randint(1, 512, (2, 20), generator=torch.Generator()
                        .manual_seed(0)).to(cuda_device)
    with torch.no_grad():
        ref = model(ids, cache=llama.init_cache(cfg, 2, 64, per_sequence=True,
                                                device=cuda_device))
        pool = llama.init_kv_pool(cfg, 9, 16, device=cuda_device)
        tables = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], device=cuda_device)
        out = model(ids, cache={"layers": [
            dict(pool_k=l["k"], pool_v=l["v"], pages=tables,
                 index=torch.zeros(2, dtype=torch.long, device=cuda_device))
            for l in pool["layers"]]})
    scale = ref["logits"].abs().max().item()
    assert (out["logits"] - ref["logits"]).abs().max().item() <= 1e-6 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dropless", [True, False])
def test_moe_block_on_the_card_matches_the_cpu(cuda_device, dropless):
    # float32, TF32 off: the same products in another summation order, so
    # y and aux agree to 1e-5 relative and routing (argmax of the same
    # router logits) is the same, drops included
    from kubeflow_tpu_torch.models import moe

    cfg = moe.MoEConfig(hidden_size=128, ffn_size=256, num_experts=8,
                        dtype="float32")
    cpu = moe.MoEBlock(cfg, dropless=dropless, device="cpu")
    cpu.init_weights(torch.Generator().manual_seed(0))
    cpu.router.init_weights(torch.Generator().manual_seed(1))
    card = moe.MoEBlock(cfg, dropless=dropless, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(2, 64, 128, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        y, aux = cpu(x)
        yc, auxc = card(x.to(cuda_device))
    scale = y.abs().max().item()
    assert (yc.cpu() - y).abs().max().item() <= 1e-5 * scale
    assert abs(auxc.item() - aux.item()) <= 1e-5 * aux.item()
    if not dropless:
        assert int(card.dropped) == int(cpu.dropped)


@pytest.mark.cuda
def test_verify_round_matches_sequential_decode_on_the_card(cuda_device):
    # tiny float32 Llama on the card: one verify forward of 5 tokens per
    # row over a per-row cache gives the logits of 5 sequential decode
    # steps (1e-5 of max |logit|), and an engine whose drafter proposes
    # the true stream with one wrong token gives the stream of an engine
    # without speculation
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.serving.engine import ContinuousBatcher

    model = llama.LlamaModel(llama.llama_tiny(dtype="float32"),
                             device=cuda_device).init_weights(0)
    cfg = model.config
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(1, 512, (2, 12), generator=g).to(cuda_device)
    toks = torch.randint(1, 512, (2, 5), generator=g).to(cuda_device)
    caches = [llama.init_cache(cfg, 2, 64, per_sequence=True,
                               device=cuda_device) for _ in range(2)]
    start = torch.tensor([12, 9], device=cuda_device)
    with torch.no_grad():
        for cache in caches:
            model(ids, cache=cache)
            for layer in cache["layers"]:
                layer["index"] = start
        verify = model(toks, cache=caches[0])["logits"]
        steps = []
        for j in range(5):
            for layer in caches[1]["layers"]:
                layer["index"] = start + j
            steps.append(model(toks[:, j:j + 1], cache=caches[1])["logits"])
    seq = torch.cat(steps, dim=1)
    assert (verify - seq).abs().max().item() <= 1e-5 * seq.abs().max().item()

    plain = ContinuousBatcher(model, cfg, max_batch=2, max_seq=64)
    prompt = ids[0].tolist()
    want = plain.generate_sync([prompt], max_new_tokens=24)[0]

    def partial(tokens, n):
        d = list(want[len(tokens):len(tokens) + n])
        return d[:1] + [d[1] % 511 + 1] if len(d) > 1 else d

    spec = ContinuousBatcher(model, cfg, max_batch=2, max_seq=64,
                             speculative_tokens=4, draft_fn=partial)
    try:
        assert spec.generate_sync([prompt], max_new_tokens=24)[0] == want
        assert spec.stats()["speculative"]["accepted"] > 0
    finally:
        plain.shutdown()
        spec.shutdown()


@pytest.mark.cuda
def test_ragged_multi_token_write_on_the_card(cuda_device):
    # the one-scatter write of a [B] index equals per-row slice writes,
    # bitwise, including a start clamped to S - s
    from kubeflow_tpu_torch.models import llama

    model = llama.LlamaModel(llama.llama_tiny(),
                             device=cuda_device).init_weights(0)
    cache = llama.init_cache(model.config, 3, 24, per_sequence=True,
                             device=cuda_device)
    index = torch.tensor([0, 7, 22], device=cuda_device)
    for layer in cache["layers"]:
        layer["index"] = index
    ids = torch.randint(1, 512, (3, 5), generator=torch.Generator()
                        .manual_seed(0)).to(cuda_device)
    new_kv = []

    def capture(module, args, output):
        x, pos = args[0], args[1]
        new_kv.append((llama.kl.rotary_embedding(module.k(x), pos, 10000.0),
                       module.v(x)))

    hooks = [blk.attention.register_forward_hook(capture)
             for blk in model.layers]
    with torch.no_grad():
        model(ids, cache=cache)
    for h in hooks:
        h.remove()
    for layer, (k_new, v_new) in zip(cache["layers"], new_kv):
        want_k = torch.zeros_like(layer["k"])
        want_v = torch.zeros_like(layer["v"])
        for b, st in enumerate([0, 7, 19]):
            want_k[b, st:st + 5] = k_new[b]
            want_v[b, st:st + 5] = v_new[b]
        assert torch.equal(layer["k"], want_k)
        assert torch.equal(layer["v"], want_v)


# -- int8 serving and disaggregation on the card --------------------------------

def _tiny_cuda_model(cuda_device, dtype="bfloat16"):
    from kubeflow_tpu_torch.models import llama

    return llama.LlamaModel(llama.llama_tiny(dtype=dtype),
                            device=cuda_device).init_weights(0).eval()


@pytest.mark.cuda
def test_quantize_on_the_card_is_bitwise_the_cpu(cuda_device):
    from kubeflow_tpu_torch.serving import quant

    g = torch.Generator().manual_seed(4)
    for shape, axis in (((512, 32, 128), 0), ((512, 1376), 0),
                        ((4, 512, 1376), 1)):
        w = torch.randn(shape, generator=g).bfloat16()
        w[:, 3] = 0                                   # an all-zero channel
        q, s = quant.quantize_array(w, axis)
        qc, sc = quant.quantize_array(w.to(cuda_device), axis)
        assert torch.equal(qc.cpu(), q) and torch.equal(sc.cpu(), s)
        deq = quant.QTensor(q, s).dequantize()
        assert torch.equal(quant.QTensor(qc, sc).dequantize().cpu(), deq)
    x = torch.randn(7, 16, 8, 128, generator=g).bfloat16()
    q, s = quant.quantize_kv(x)
    qc, sc = quant.quantize_kv(x.to(cuda_device))
    assert torch.equal(qc.cpu(), q) and torch.equal(sc.cpu(), s)
    assert torch.equal(quant.dequantize_kv(qc, sc, torch.bfloat16).cpu(),
                       quant.dequantize_kv(q, s, torch.bfloat16))


@pytest.mark.cuda
def test_int8_commit_on_the_card_is_the_cpu_quantize_kv(cuda_device):
    from kubeflow_tpu_torch.serving import quant
    from kubeflow_tpu_torch.serving.engine import ContinuousBatcher

    model = _tiny_cuda_model(cuda_device)
    eng = ContinuousBatcher(model, model.config, max_batch=2, max_seq=128,
                            page_size=32, prefix_cache_bytes=1 << 20,
                            kv_quant=True)
    try:
        long = [7] + list(range(100, 190))
        short = [9, 3, 5, 8, 13, 21, 34, 55, 89, 144]
        for prompt in (long, short):
            eng.generate_sync([prompt], max_new_tokens=2)
            node, _ = eng.prefix_cache.match(prompt)
            scratch = eng._scratch()
            for i, pid in enumerate(node.pages):
                tree = eng.pool.get(pid)["layers"]
                for layer, rows in zip(tree, scratch):
                    for name in ("k", "v"):
                        page = rows[name][0, i * 32:(i + 1) * 32].cpu()
                        q, s = quant.quantize_kv(page[None])
                        assert torch.equal(layer[name].cpu(), q[0])
                        assert torch.equal(layer[name + "s"].cpu(), s[0])
        # the short prompt's tail past its bucket (16) is zeros
        for rows in eng._scratch():
            assert not bool(rows["k"][0, 16:32].any())
        assert eng.stats()["kv_pool"]["orphan_pages"] == 0
    finally:
        eng.shutdown()


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", [False, True])
def test_card_pages_survive_the_wire_bitwise(cuda_device, kv_quant):
    import json

    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.serving import disagg, quant
    from kubeflow_tpu_torch.serving.page_pool import PagePool

    cfg = llama.llama_tiny()
    ps = 16
    pool = PagePool(4, ps, kv=llama.init_kv_pool(cfg, 4, ps,
                                                 device=cuda_device,
                                                 quantized=kv_quant))
    g = torch.Generator(device=cuda_device).manual_seed(2)
    layers = []
    for _ in range(cfg.num_layers):
        kv = [torch.randn(1, ps, cfg.num_kv_heads, cfg.head_dim, generator=g,
                          device=cuda_device) for _ in range(2)]
        if kv_quant:
            (kq, ks), (vq, vs) = (quant.quantize_kv(t) for t in kv)
            layers.append({"k": kq, "ks": ks, "v": vq, "vs": vs})
        else:
            layers.append({"k": kv[0].bfloat16(), "v": kv[1].bfloat16()})
    (pid,) = pool.alloc(1)
    pool.put_many([pid], layers)
    wire = json.loads(json.dumps([disagg.encode_page(pool.get(pid))]))
    view = type("E", (), {"cfg": cfg, "kv_quant": kv_quant,
                          "page_size": ps})()
    (tree,) = disagg.parse_page_trees(wire, view)
    for got, want in zip(tree["layers"], pool.get(pid)["layers"]):
        for name, t in want.items():
            assert torch.equal(got[name], t.cpu())


@pytest.mark.cuda
def test_card_generator_state_rides_a_serialized_handoff(cuda_device):
    import json
    import threading

    from kubeflow_tpu_torch.serving import disagg
    from kubeflow_tpu_torch.serving.engine import ContinuousBatcher

    model = _tiny_cuda_model(cuda_device)
    cfg = model.config
    kw = dict(max_new_tokens=12, temperature=1.1, top_k=20)
    prompts = [[5, 8, 13], [2, 7, 9, 11, 40]]
    ref = ContinuousBatcher(model, cfg, max_batch=2, max_seq=64)
    want = ref.generate_sync(prompts, seed=5, **kw)
    ref.shutdown()
    bodies, both = [], threading.Event()

    def capture(req, st):
        body = json.loads(json.dumps(disagg.serialize_handoff(st, pre.pool)))
        bodies.append((req, body, st))
        if len(bodies) == len(prompts):
            both.set()

    pre = ContinuousBatcher(model, cfg, max_batch=2, max_seq=64,
                            role="prefill", handoff_fn=capture)
    dec = ContinuousBatcher(model, cfg, max_batch=2, max_seq=64,
                            role="decode")
    try:
        reqs = [pre.submit(p, seed=5 + i, **kw) for i, p in
                enumerate(prompts)]
        assert both.wait(60)
        for req, body, st in bodies:
            disagg.release_handoff(pre.pool, st)
            disagg.complete_forwarded(req, disagg.resume_serialized(dec,
                                                                    body))
        assert [r.result(60) for r in reqs] == want
        assert dec.stats()["resumed"] == 2
    finally:
        pre.shutdown()
        dec.shutdown()


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", [False, True])
def test_coordinator_on_the_card_matches_colocated(cuda_device, kv_quant):
    # bf16 pages: the streams (seeded) are the colocated engine's; int8
    # pages are lossy, so those streams complete and leak nothing
    from kubeflow_tpu_torch.serving.disagg import DisaggCoordinator
    from kubeflow_tpu_torch.serving.engine import ContinuousBatcher

    model = _tiny_cuda_model(cuda_device)
    cfg = model.config
    prompts = [list(range(2, 40)), [5, 8, 13], list(range(60, 100))]
    kw = dict(max_new_tokens=10, temperature=0.8, seed=3)
    ref = ContinuousBatcher(model, cfg, max_batch=2, max_seq=128)
    want = ref.generate_sync(prompts, **kw)
    ref.shutdown()
    co = DisaggCoordinator(model, cfg, max_batch=2, max_seq=128,
                           page_size=16, kv_quant=kv_quant)
    try:
        got = co.generate_sync(prompts, **kw)
        if kv_quant:
            assert all(len(o) == len(p) + 10 for o, p in zip(got, prompts))
        else:
            assert got == want
        assert co.drained(timeout=60)
        assert co.stats()["kv_pool"]["orphan_pages"] == 0
        assert co.decode[0].stats()["resumed"] == len(prompts)
    finally:
        co.shutdown()


# -- checkpoints and weight residency on the card --------------------------------

@pytest.mark.cuda
def test_streamed_restore_to_the_card_is_the_cpu_restore(cuda_device,
                                                         tmp_path):
    # a window smaller than one tensor: every tensor goes in pieces through
    # the pinned ring and the side stream; float32 records cast to bf16
    from kubeflow_tpu_torch.serving import model_pool as mp

    model = _tiny_cuda_model(cuda_device, dtype="float32")
    mp.save_streamable(model, str(tmp_path))
    like = {n: p.detach().to(torch.bfloat16)
            for n, p in model.named_parameters()}
    window = 1000
    assert window < max(p.numel() * 4 for p in like.values())
    ring = mp.StagingRing(window, cuda_device)
    card, rep = mp.stream_restore(str(tmp_path), like, device=cuda_device,
                                  ring=ring)
    host, _ = mp.stream_restore(str(tmp_path),
                                {n: t.cpu() for n, t in like.items()},
                                staging_bytes=window)
    assert 0 < rep["max_staged_bytes"] <= window
    for name in like:
        assert card[name].device.type == "cuda"
        assert torch.equal(card[name].cpu(), host[name]), name
        assert torch.equal(host[name], like[name].cpu()), name


@pytest.mark.cuda
def test_park_frees_weight_bytes_and_warm_restores_them(cuda_device):
    from kubeflow_tpu_torch.ops import _build
    from kubeflow_tpu_torch.serving.predictor import GenerativePredictor

    pred = GenerativePredictor("llama", size="tiny", max_batch=1,
                               max_seq=128)
    try:
        prompt = [list(range(3, 40))]
        base = pred.generate(prompt, max_new_tokens=8)["ids"]
        builds = _build.BUILDS.get()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        nbytes = pred.weight_bytes
        assert pred.park() == nbytes
        torch.cuda.synchronize()
        dropped = before - torch.cuda.memory_allocated()
        # every weight's block rounds up to 512 bytes
        n = len(pred._shapes)
        assert nbytes <= dropped <= nbytes + 512 * n, (dropped, nbytes)
        pred.warm()
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated() - before in range(
            -512 * n, 512 * n + 1)
        assert pred.generate(prompt, max_new_tokens=8)["ids"] == base
        assert _build.BUILDS.get() == builds
    finally:
        pred.stop(timeout=30)


@pytest.mark.cuda
def test_donation_then_alloc_then_reclaim_on_a_card_pool(cuda_device):
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.serving.page_pool import PagePool

    cfg = llama.llama_tiny()
    kv = llama.init_kv_pool(cfg, 4, 16, device=cuda_device)
    pool = PagePool(4, 16, llama.kv_page_nbytes(cfg, 16), kv=kv)
    held = pool.alloc(3)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    layers = [(torch.randn(3 * 16, cfg.num_kv_heads, cfg.head_dim,
                           generator=g, device=cuda_device).bfloat16(),) * 2
              for _ in range(cfg.num_layers)]
    pool.put_many(held, layers)
    assert pool.alloc(1) is None
    pool.donate(5)
    assert kv["layers"][0]["k"].shape[0] == 9
    more = pool.alloc(5)
    assert more is not None
    out = [(torch.empty(3 * 16, cfg.num_kv_heads, cfg.head_dim,
                        dtype=torch.bfloat16, device=cuda_device),) * 2
           for _ in range(cfg.num_layers)]
    pool.gather(held, [(o[0], o[0]) for o in out])
    assert all(torch.equal(o[0], src[0]) for o, src in zip(out, layers))
    assert pool.reclaim(5) == 0          # every donated slot is live
    pool.decref(more)
    assert pool.reclaim(5) == 5 and pool.stats()["pages"] == 3
    # a second donation lands in the rows the reclaim kept: no new bytes
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    pool.donate(5)
    assert kv["layers"][0]["k"].shape[0] == 9
    assert pool.stats()["device_rows"] == 9
    assert torch.cuda.memory_allocated() == before
    more = pool.alloc(5)
    assert more is not None and pool.alloc(1) is None
    pool.gather(held, [(o[0], o[0]) for o in out])
    assert all(torch.equal(o[0], src[0]) for o, src in zip(out, layers))


@pytest.mark.cuda
def test_int8_restore_peak_stays_near_the_int8_size(cuda_device, tmp_path):
    # Llama-2-7B's width at 2 layers, a float32 checkpoint: each weight
    # lands, is quantized and dropped before the next, so the peak is the
    # int8 model plus one float32 weight and one temporary of its size
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.serving import model_pool as mp
    from kubeflow_tpu_torch.serving.predictor import GenerativePredictor
    from kubeflow_tpu_torch.serving.quant import wants_quant

    cfg = {"num_layers": 2}
    full = llama.LlamaModel(llama.llama2_7b(**cfg),
                            device=cuda_device).init_weights(0)
    mp.save_streamable(full, str(tmp_path))
    largest = max(p.numel() * 4 for n, p in full.named_parameters()
                  if wants_quant(n, p, 1 << 12))
    bf16_bytes = sum(p.numel() * 2 for p in full.parameters())
    del full
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    pred = GenerativePredictor("llama", size="7b", model_config=cfg,
                               checkpoint_dir=str(tmp_path), quantize=True,
                               staging_mb=64, max_batch=1, max_seq=64)
    try:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        held = torch.cuda.memory_allocated() - base   # weights and engine
        assert pred.weight_bytes < bf16_bytes
        assert peak <= held + 2 * largest + (64 << 20), (
            peak, held, pred.weight_bytes, largest)
    finally:
        pred.stop(timeout=30)


GANG_BERT = r"""
import json, os, torch
from kubeflow_tpu_torch.models import registry
from kubeflow_tpu_torch.ops import flash_attention as fa
from kubeflow_tpu_torch.parallel import distributed as pd
from kubeflow_tpu_torch.parallel import train_step as ts
from kubeflow_tpu_torch.parallel.mesh import make_mesh
from kubeflow_tpu_torch.training.optim import make_optimizer

rdv = pd.initialize_from_env()                      # the card, not the CPU
group = pd.default_group()
rank, world = pd.rank_of(group), pd.world_size(group)
entry = registry.get("bert")
model = entry.make_model(size="base", vocab_size=1024, hidden_size=256,
                         num_layers=2, num_heads=4, intermediate_size=512,
                         max_position=128, dtype="float32").init_weights(0)
state = ts.init_train_state(model, make_optimizer(
    {"name": "sgd", "learning_rate": 1e-2, "momentum": 0.9}))
step = ts.build_train_step(entry.forward_loss, state.tx, make_mesh(),
                           loss_weight=entry.loss_weight)
trail = []
for i in range(3):
    batch = entry.make_batch(8, torch.Generator().manual_seed(i), model,
                             seq_len=128)
    batch = {k: v[rank::world].cuda() for k, v in batch.items()}
    state, m = step(state, batch)
    trail.append([m["loss"].item(), m["grad_norm"].item()])
print(json.dumps({"rdv": rdv, "trail": trail,
                  "device": str(next(model.parameters()).device),
                  "launches": [fa.flash_attention.launches,
                               fa.flash_bwd_dq.launches,
                               fa.flash_bwd_dkv.launches]}))
"""


@pytest.mark.cuda
def test_two_rank_gloo_gang_on_one_card_trains_what_one_process_trains(
        cuda_device):
    # a 2-layer BERT at hidden 256 (4 heads of 64, float32: the f32 K1-K3
    # instantiations), 3 momentum-sgd steps of 8 rows: a 2-rank gang over
    # gloo on cuda:0 against one process; both ranks launch every kernel.
    # Tolerance 1e-4 relative: float32 kernels and GEMMs at 4 rows
    # against 8 sum in other orders
    from kubeflow_tpu_torch.ops import _build
    from kubeflow_tpu_torch.parallel import distributed as pd

    _build.build_all()         # once, before the ranks load it
    one = pd.spawn_local_gang(GANG_BERT, 1, timeout=300.0)[0]
    outs = pd.spawn_local_gang(GANG_BERT, 2, timeout=300.0)
    assert [o["rdv"]["backend"] for o in outs] == ["gloo", "gloo"]
    assert all(o["device"] == "cuda:0" for o in outs)
    assert outs[0]["trail"] == outs[1]["trail"]          # bitwise
    for (gl, gn), (wl, wn) in zip(outs[0]["trail"], one["trail"]):
        assert abs(gl - wl) <= 1e-4 * abs(wl), (outs, one)
        assert abs(gn - wn) <= 1e-4 * abs(wn), (outs, one)
    for o in outs:   # per step and layer: K1 twice (remat), K2, K3 once
        assert o["launches"] == [3 * 4, 3 * 2, 3 * 2], o


MESH_LLAMA = r"""
import json, os, torch
from kubeflow_tpu_torch.models import registry
from kubeflow_tpu_torch.ops import flash_attention as fa
from kubeflow_tpu_torch.parallel import distributed as pd
from kubeflow_tpu_torch.parallel import sharding as sh
from kubeflow_tpu_torch.parallel import train_step as ts
from kubeflow_tpu_torch.parallel.mesh import make_mesh
from kubeflow_tpu_torch.training.optim import make_optimizer

rdv = pd.initialize_from_env()                      # the card, not the CPU
mesh = make_mesh(dp=1, fsdp=int(os.environ["FSDP"]), tp=int(os.environ["TP"]))
index, count = mesh.data_index()
entry = registry.get("llama")
model = entry.make_model(size="7b", vocab_size=1024, hidden_size=512,
                         num_layers=2, num_heads=8, num_kv_heads=4,
                         intermediate_size=1024, dtype="float32"
                         ).init_weights(0)
sh.shard_model(model, mesh)
state = ts.init_train_state(model, make_optimizer(
    {"name": "sgd", "learning_rate": 1e-2, "momentum": 0.9}))
step = ts.build_train_step(entry.forward_loss, state.tx, mesh,
                           loss_weight=entry.loss_weight)
trail = []
for i in range(3):
    batch = entry.make_batch(8, torch.Generator().manual_seed(i), model,
                             seq_len=128)
    n = 8 // count
    batch = {k: v[index * n:(index + 1) * n].cuda() for k, v in batch.items()}
    state, m = step(state, batch)
    trail.append([m["loss"].item(), m["grad_norm"].item()])
print(json.dumps({"rdv": rdv, "trail": trail,
                  "device": str(next(model.parameters()).device),
                  "launches": [fa.flash_attention.launches,
                               fa.flash_bwd_dq.launches,
                               fa.flash_bwd_dkv.launches]}))
"""


@pytest.mark.cuda
def test_fsdp_and_tp_gang_on_one_card_trains_what_one_process_trains(
        cuda_device):
    # a 2-layer Llama at hidden 512 (8 query heads over 4 KV heads of 64,
    # float32), 3 momentum-sgd steps of 8 rows of 128 tokens: a 4-rank
    # fsdp=2 x tp=2 gloo gang on cuda:0 against one process; every rank
    # launches K1-K3 at its 2 data rows' 4 rows and 4 of the 8 heads.
    # Tolerance 1e-4 relative: float32 kernels and GEMMs at other rows
    # and heads sum in other orders
    from kubeflow_tpu_torch.ops import _build
    from kubeflow_tpu_torch.parallel import distributed as pd

    _build.build_all()         # once, before the ranks load it
    one = pd.spawn_local_gang(MESH_LLAMA, 1, timeout=300.0,
                              extra_env={"FSDP": "1", "TP": "1"})[0]
    outs = pd.spawn_local_gang(MESH_LLAMA, 4, timeout=300.0,
                               extra_env={"FSDP": "2", "TP": "2"})
    assert all(o["rdv"]["backend"] == "gloo" for o in outs)
    assert all(o["device"] == "cuda:0" for o in outs)
    assert all(o["trail"] == outs[0]["trail"] for o in outs)   # bitwise
    for (gl, gn), (wl, wn) in zip(outs[0]["trail"], one["trail"]):
        assert abs(gl - wl) <= 1e-4 * abs(wl), (outs, one)
        assert abs(gn - wn) <= 1e-4 * abs(wn), (outs, one)
    for o in outs + [one]:   # per step and layer: K1 twice (remat), K2, K3
        assert o["launches"] == [3 * 4, 3 * 2, 3 * 2], o


MOE_GANG = r"""
import json, os, torch
from kubeflow_tpu_torch.models import registry
from kubeflow_tpu_torch.ops import flash_attention as fa
from kubeflow_tpu_torch.parallel import distributed as pd
from kubeflow_tpu_torch.parallel import sharding as sh
from kubeflow_tpu_torch.parallel import train_step as ts
from kubeflow_tpu_torch.parallel.mesh import make_mesh
from kubeflow_tpu_torch.training.optim import make_optimizer

rdv = pd.initialize_from_env()                      # the card, not the CPU
axes = json.loads(os.environ["LAYOUT"])
mesh = make_mesh(dp=1, **axes)
index, count = mesh.data_index()
entry = registry.get("llama")
model = entry.make_model(size="7b", vocab_size=1024, hidden_size=512,
                         num_layers=2, num_heads=8, num_kv_heads=4,
                         intermediate_size=1024, dtype="float32",
                         moe_experts=4).init_weights(0)
sh.shard_model(model, mesh)
state = ts.init_train_state(model, make_optimizer(
    {"name": "sgd", "learning_rate": 1e-2, "momentum": 0.9}))
step = ts.build_train_step(
    entry.forward_loss, state.tx, mesh, loss_weight=entry.loss_weight,
    sequence_keys=entry.sequence_keys if axes.get("sp", 1) > 1 else ())
trail, dropped = [], []
for i in range(2):
    batch = entry.make_batch(8, torch.Generator().manual_seed(i), model,
                             seq_len=128)
    n = 8 // count
    batch = {k: v[index * n:(index + 1) * n].cuda() for k, v in batch.items()}
    state, m = step(state, batch)
    trail.append([m["loss"].item(), m["grad_norm"].item()])
    dropped.append([int(b.moe.dropped) for b in model.layers if b.use_moe])
print(json.dumps({"rdv": rdv, "trail": trail, "dropped": dropped,
                  "device": str(next(model.parameters()).device),
                  "launches": [fa.flash_attention.launches,
                               fa.flash_bwd_dq.launches,
                               fa.flash_bwd_dkv.launches]}))
"""


@pytest.mark.cuda
@pytest.mark.parametrize("axis", ["ep", "tp", "sp"])
def test_moe_gang_on_one_card_trains_what_one_process_trains(cuda_device,
                                                             axis):
    # a 2-layer MoE Llama at hidden 512 (8 query heads over 4 KV heads of
    # 64, 4 GELU experts on layer 0, float32), 2 momentum-sgd steps of 8
    # rows of 128 tokens: a 2-rank gloo gang on cuda:0 at ep=2, tp=2 or
    # sp=2 against one process; ranks bitwise equal, step 1's dropped
    # counts one process's; loss within 1e-3 and grad_norm within 5e-3
    # (STEP_TOL of chip_smoke.py: other rows, heads and sums round
    # otherwise).  Per step and layer K1 twice (remat), K2 and K3 once; at
    # sp=2 rank r once per visible ring block (r + 1 of them)
    from kubeflow_tpu_torch.ops import _build
    from kubeflow_tpu_torch.parallel import distributed as pd

    _build.build_all()         # once, before the ranks load it
    one = pd.spawn_local_gang(MOE_GANG, 1, timeout=300.0,
                              extra_env={"LAYOUT": "{}"})[0]
    outs = pd.spawn_local_gang(MOE_GANG, 2, timeout=300.0,
                               extra_env={"LAYOUT": json.dumps({axis: 2})})
    assert all(o["rdv"]["backend"] == "gloo" for o in outs)
    assert all(o["device"] == "cuda:0" for o in outs)
    assert outs[1]["trail"] == outs[0]["trail"]               # bitwise
    for (gl, gn), (wl, wn) in zip(outs[0]["trail"], one["trail"],
                                  strict=True):
        assert abs(gl - wl) <= 1e-3 * abs(wl), (outs, one)
        assert abs(gn - wn) <= 5e-3 * abs(wn), (outs, one)
    assert one["launches"] == [8, 4, 4], one
    for r, o in enumerate(outs):
        assert o["dropped"][0] == one["dropped"][0], (r, o, one)
        blocks = r + 1 if axis == "sp" else 1
        assert o["launches"] == [8 * blocks, 4 * blocks, 4 * blocks], o


RING_GANG = r"""
import json, torch
from kubeflow_tpu_torch.ops import flash_attention as fa
from kubeflow_tpu_torch.ops import ring_attention as ring
from kubeflow_tpu_torch.parallel import distributed as pd
from kubeflow_tpu_torch.parallel.mesh import make_mesh

pd.initialize_from_env()                             # the card, not the CPU
mesh = make_mesh(dp=1, sp=2)
group, i = mesh.group("sp"), mesh.coordinate("sp")
out = {}
for causal in (False, True):
    g = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = (torch.randn(2, 512, 8, 128, generator=g, device="cuda")
               [:, i * 256:(i + 1) * 256].to(torch.bfloat16)
               .requires_grad_() for _ in range(3))
    before = [fa.flash_attention.launches, fa.flash_bwd_dq.launches]
    o = ring.ring_attention(q, k, v, group=group, causal=causal)
    o.float().pow(2).sum().backward()
    got = [o.detach(), q.grad, k.grad, v.grad]
    launched = [fa.flash_attention.launches - before[0],
                fa.flash_bwd_dq.launches - before[1]]
    for t in (q, k, v):
        t.grad = None
    o = ring.ring_attention_reference(q, k, v, group=group, causal=causal)
    o.float().pow(2).sum().backward()
    want = [o.detach(), q.grad, k.grad, v.grad]
    out[str(causal)] = {
        "rel": [float((a.float() - b.float()).abs().max()
                      / b.float().abs().max()) for a, b in zip(got, want)],
        "launched": launched}
print(json.dumps(out))
"""


@pytest.mark.cuda
def test_ring_attention_kernels_match_the_plain_ring(cuda_device):
    # sp = 2 on cuda:0 (gloo; the exchange stages through pinned host
    # memory): per rank 2 x 256 tokens of 8 heads of 128, bf16.  The ring
    # (K1 per visible block, K2 and K3 in the backward) against
    # ring_attention_reference (float32 einsums) on the same chunks: O and
    # dQ, dK, dV within 2e-2 of max |ref|; under causal, rank 0 launches
    # for its diagonal block only.
    from kubeflow_tpu_torch.parallel import distributed as pd

    outs = pd.spawn_local_gang(RING_GANG, 2, timeout=300.0)
    for rank, out in enumerate(outs):
        for causal, got in out.items():
            assert max(got["rel"]) <= 2e-2, (rank, causal, got)
            blocks = 2 if causal == "False" else rank + 1
            assert got["launched"] == [blocks, blocks], (rank, causal, got)


@pytest.mark.cuda
def test_multihost_predictor_prefills_through_k1_once_per_layer(
        cuda_device):
    """A tp = 1 ``MultiHostPredictor`` on the card: every ``generate``
    prefills its padded rows through K1 once per layer (decode takes the
    plain masked route), and its tokens are those of the same weights on
    the CPU (float32, head_dim 64)."""
    from kubeflow_tpu_torch.serving.multihost import MultiHostPredictor

    # the widths are all in the config ("tiny" fixes its own)
    config = {"dtype": "float32", "use_flash": True, "vocab_size": 512,
              "hidden_size": 256, "num_layers": 2, "num_heads": 4,
              "num_kv_heads": 2, "intermediate_size": 512,
              "max_seq_len": 128}
    prompts = [[1, 2, 3], [7, 8, 9, 10], [5], [11, 12]]
    got, state = {}, None
    for device in ("cpu", "cuda"):
        mh = MultiHostPredictor("llama", size="7b", max_seq=64,
                                model_config=config, device=device,
                                state=state)
        state = {n: p.detach() for n, p in mh.module.named_parameters()}
        before = tfa.flash_attention.launches
        got[device] = mh.generate(prompts, max_new_tokens=8)
        launched = tfa.flash_attention.launches - before
        assert launched == (mh.cfg.num_layers if device == "cuda" else 0)
        got[device + "_logits"] = mh.prefill_logits.float().cpu()
    err = (got["cuda_logits"] - got["cpu_logits"]).abs().max()
    assert err <= 1e-4 * got["cpu_logits"].abs().max()
    assert got["cuda"] == got["cpu"]


TP_PREDICTOR = r"""
import json, os, torch
from kubeflow_tpu_torch.ops import attention
from kubeflow_tpu_torch.ops import flash_attention as fa
from kubeflow_tpu_torch.parallel import distributed as pd
from kubeflow_tpu_torch.serving.predictor import GenerativePredictor

pd.initialize_from_env()                             # the card, not the CPU
spec = json.loads(os.environ["GANG_SPEC"])
rank = pd.rank_of(pd.default_group())
calls = []
_flash = attention.flash_attention


def recorded(q, k, v, *args, **kwargs):
    calls.append([list(q.shape), list(k.shape)])
    return _flash(q, k, v, *args, **kwargs)


attention.flash_attention = recorded
# the widths are all in the config ("tiny" fixes its own)
pred = GenerativePredictor("llama", size="7b", max_batch=2, max_seq=64,
                           model_config=spec["config"], tp=spec["tp"])
before = fa.flash_attention.launches
out = {"rank": rank}
if rank == 0:
    out["ids"] = pred.generate(spec["prompts"], max_new_tokens=8)["ids"]
    pred.engine.shutdown()
else:
    pred.follow()
out["launches"] = fa.flash_attention.launches - before
out["calls"] = calls
print(json.dumps(out))
"""


@pytest.mark.cuda
def test_tp2_predictor_gang_on_one_card_serves_what_one_process_serves(
        cuda_device):
    """``GenerativePredictor(tp=2)`` as a 2-rank gloo gang on cuda:0 (a
    tiny Llama at hidden 256: 4 query heads over 2 KV heads of 64,
    float32, seeded): rank 0's streams equal one process's, and every
    rank prefilled each prompt through K1 once per layer at its 2 query
    heads over 1 KV head (the follower replays rank 0's steps)."""
    from kubeflow_tpu_torch.ops import _build
    from kubeflow_tpu_torch.parallel import distributed as pd

    _build.build_all()         # once, before the ranks load it
    spec = {"config": {"dtype": "float32", "use_flash": True,
                       "vocab_size": 512, "hidden_size": 256,
                       "num_layers": 2, "num_heads": 4, "num_kv_heads": 2,
                       "intermediate_size": 512, "max_seq_len": 128},
            "prompts": [[5, 8, 13, 21], [2, 7]]}
    runs = {tp: pd.spawn_local_gang(
        TP_PREDICTOR, tp, timeout=300.0,
        extra_env={"GANG_SPEC": json.dumps({**spec, "tp": tp})})
        for tp in (1, 2)}
    one, gang = runs[1][0], runs[2]
    assert gang[0]["ids"] == one["ids"]
    layers = 2
    for o in gang:
        # two prompts, one chunk each, every layer: at the rank's heads
        assert o["launches"] == 2 * layers, o
        assert all(q[2] == 2 and k[2] == 1 for q, k in o["calls"]), o
    assert one["launches"] == 2 * layers


TP_PARK_WARM = r"""
import hashlib, json, os, torch
from kubeflow_tpu_torch.ops import flash_attention as fa
from kubeflow_tpu_torch.parallel import distributed as pd
from kubeflow_tpu_torch.serving.predictor import GenerativePredictor

pd.initialize_from_env()                             # the card, not the CPU
spec = json.loads(os.environ["GANG_SPEC"])
rank = pd.rank_of(pd.default_group())
# the widths are all in the config ("tiny" fixes its own)
pred = GenerativePredictor("llama", size="7b", max_batch=2, max_seq=64,
                           model_config=spec["config"], tp=2,
                           quantize=spec["quantize"])


def blocks():
    # this rank's blocks, int8 q and scale included, and device memory
    torch.cuda.synchronize()
    return [torch.cuda.memory_allocated(), {
        n: hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()
        for n, t in (*pred.module.named_parameters(),
                     *pred.module.named_buffers()) if not t.is_meta}]


states = [[None, *blocks()]]
residency = pred.engine.residency_fn


def applied(kind):
    # the memory just before the command, beside what follows it
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    out = residency(kind)
    states.append([before, *blocks()])
    return out


pred.engine.residency_fn = applied
before = fa.flash_attention.launches
out = {"rank": rank, "block_bytes": pred.rank_weight_bytes}
if rank == 0:
    out["before"] = pred.generate(spec["prompts"], max_new_tokens=8)["ids"]
    out["park"] = pred.park()
    out["warm"] = pred.warm()
    out["after"] = pred.generate(spec["prompts"], max_new_tokens=8)["ids"]
    pred.engine.shutdown()
else:
    pred.follow()
out["launches"] = fa.flash_attention.launches - before
out["states"] = states
print(json.dumps(out))
"""


@pytest.mark.cuda
@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
def test_tp2_gang_park_and_warm_on_one_card(cuda_device, quantize):
    """``park`` and ``warm`` on rank 0 of a 2-rank gloo gang on cuda:0 (a
    tiny Llama at hidden 256, float32, seeded, and its int8 weights): both
    ranks drop their blocks at the park (the device memory falls by at
    least 90% of them) and load them back bitwise at the warm, the
    streams before the park and after the warm are equal, and every
    prefill ran K1."""
    from kubeflow_tpu_torch.ops import _build
    from kubeflow_tpu_torch.parallel import distributed as pd

    _build.build_all()         # once, before the ranks load it
    spec = {"config": {"dtype": "float32", "use_flash": True,
                       "vocab_size": 512, "hidden_size": 256,
                       "num_layers": 2, "num_heads": 4, "num_kv_heads": 2,
                       "intermediate_size": 512, "max_seq_len": 128},
            "prompts": [[5, 8, 13, 21], [2, 7]], "quantize": quantize}
    gang = pd.spawn_local_gang(TP_PARK_WARM, 2, timeout=300.0,
                               extra_env={"GANG_SPEC": json.dumps(spec)})
    lead = gang[0]
    assert lead["before"] == lead["after"]
    assert lead["park"] == lead["warm"] > 0
    for o in gang:
        (_, _, built), (mem0, mem1, parked), (_, _, warmed) = o["states"]
        assert parked == {} and warmed == built and len(built) > 0
        assert mem0 - mem1 >= 0.9 * o["block_bytes"], (o["rank"], mem0,
                                                       mem1)
        # two requests of two prompts each, one chunk, every layer
        assert o["launches"] == 2 * 2 * 2, o


TP_DISAGG = r"""
import json, os, threading, torch
from kubeflow_tpu_torch.ops import flash_attention as fa
from kubeflow_tpu_torch.parallel import distributed as pd
from kubeflow_tpu_torch.serving.predictor import GenerativePredictor

pd.initialize_from_env()                             # the card, not the CPU
spec = json.loads(os.environ["GANG_SPEC"])
rank = pd.rank_of(pd.default_group())


def build(**kw):
    # the widths are all in the config ("tiny" fixes its own)
    return GenerativePredictor("llama", size="7b", max_batch=2, max_seq=64,
                               model_config=spec["config"], tp=2, **kw)


def post(addr, path, payload, timeout=300.0):
    # the POST, in process: the body through JSON to the decode gang
    return dec.resume(json.loads(json.dumps(payload)))


col = build()
dec = build(role="decode")
pre = build(role="prefill", handoff_post=post)
preds = (col, dec, pre)
out = {"rank": rank}
before = fa.flash_attention.launches
if rank == 0:
    kw = dict(max_new_tokens=8, **spec["sampling"])
    out["colocated"] = col.generate(spec["prompts"], **kw)["ids"]
    out["disagg"] = pre.generate(spec["prompts"], decode_peer="decode:0",
                                 **kw)["ids"]
    out["no_peer"] = pre.generate(spec["prompts"], **kw)["ids"]
    for p in preds:
        p.engine.shutdown()
else:
    threads = [threading.Thread(target=p.follow) for p in preds]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
out["launches"] = fa.flash_attention.launches - before
out["in_use"] = [p.engine.pool.stats()["in_use"] for p in preds]
print(json.dumps(out))
"""


@pytest.mark.cuda
@pytest.mark.parametrize("sampling", [{}, {"temperature": 1.1, "seed": 5,
                                           "top_k": 20}],
                         ids=["greedy", "seeded"])
def test_tp2_disaggregated_gang_on_one_card_serves_the_colocated_streams(
        cuda_device, sampling):
    """A prefill-role and a decode-role ``GenerativePredictor(tp=2)`` beside
    a colocated one in a 2-rank gloo gang on cuda:0 (a tiny Llama at
    hidden 256, float32, seeded): the handed-off streams (the prefill
    gang gathers each handoff's heads to rank 0, the decode gang takes
    the body's pages in a step record) and the ones resumed on the
    prefill gang with no decode peer equal the colocated gang's, greedy
    and seeded; every prefill ran K1, and no page is left in use."""
    from kubeflow_tpu_torch.ops import _build
    from kubeflow_tpu_torch.parallel import distributed as pd

    _build.build_all()         # once, before the ranks load it
    spec = {"config": {"dtype": "float32", "use_flash": True,
                       "vocab_size": 512, "hidden_size": 256,
                       "num_layers": 2, "num_heads": 4, "num_kv_heads": 2,
                       "intermediate_size": 512, "max_seq_len": 128},
            "prompts": [[5, 8, 13, 21], list(range(3, 40))],
            "sampling": sampling}
    gang = pd.spawn_local_gang(TP_DISAGG, 2, timeout=300.0,
                               extra_env={"GANG_SPEC": json.dumps(spec)})
    lead = gang[0]
    assert lead["disagg"] == lead["colocated"]
    assert lead["no_peer"] == lead["colocated"]
    for o in gang:
        # three rounds of two prompts, one chunk each, every layer
        assert o["launches"] == 3 * 2 * 2, o
        assert o["in_use"] == [0, 0, 0], o
