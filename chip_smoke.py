#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py                 # every phase below
    python3 chip_smoke.py --kernel-times  # build, then K1-K3 times only

Phases, in order; any failure exits nonzero and prints no result:

1. Build every CUDA kernel of the port from ``kubeflow_tpu_torch/ops/csrc``
   (one nvcc per source, all at once); fail if ptxas reports a spill or
   serialised wgmma products, or if ``cuobjdump -sass`` finds no wgmma
   product (HGMMA) or no TMA load (UTMALDG) in a bf16 K1, K2 or K3
   instantiation (all three are wgmma kernels fed by TMA).  Hold the
   flash-attention forward kernel (K1) against its plain PyTorch version
   on O and lse, in bfloat16 and float32 (TF32 off for the plain
   version), at every shape the serving run of phase 2 and the training
   runs of phases 4 and 5 give it and at a GQA, a strided and a non-causal
   D=64 case; hold the backward kernels (K2 dQ, K3 dK/dV) against theirs
   at both training shapes, a causal D=128, a ragged Sq = Sk = 200 and a
   GQA (32 over 8 heads) case.
2. Serving main path at full width: a Llama-2-7B ``GenerativePredictor``
   (32 layers, random weights from a seed) served through ``PredictorApp``
   on a local port answers 4 concurrent HTTP ``:generate`` requests
   (prompts of 17, 300, 700 and 1500 tokens; 3 greedy, 1 sampled).  The
   flash kernel's launch count over that run must be 32 x the prefill
   chunks; re-sent requests must reproduce their tokens.  Then, off the
   counted run: every kernel call of a chunked 1500-token prefill is held
   against the plain version on the same inputs, and the prefill logits of
   one prompt through the kernel and through the plain routes must agree.
3. Device time by operator (torch.profiler) of one 512-token prefill
   chunk and one 4-row decode step at 7B.
4. Training main path at full width: ``python -m
   kubeflow_tpu_torch.training``'s ``main`` in-process trains BERT-large
   (24 layers, hidden 1024, 16 heads of 64, sequence 512, bf16, random
   weights from a seed) for 10 adamw steps at global batch 24.  Every step
   must launch K1 48 times (24 layers, each recomputed by remat) and K2
   and K3 24 times each, and every loss must be finite.  Then, off the
   counted run: one train step through the kernels against the same step
   through the plain attention route (same weights and batch) in loss and
   grad_norm, with every K2 and K3 call of it held against its plain
   version on the same inputs; and the step's device time by operator.
5. The same for Llama at Llama-2-7B's width (hidden 4096, 32 heads of 128,
   FFN 11008, vocab 32000, float32 masters, bf16 compute, remat, causal
   attention), ``LLAMA_LAYERS`` of its 32 layers, global batch 16 x 512:
   10 adamw steps, each launching K1 2L times and K2 and K3 L times; the
   in-step check; the step by operator; the peak memory of the phase.
6. The vision models through the same worker: ``mnist_mlp`` and
   ``cifar_convnet`` for 3 steps, ResNet-50 (224 x 224, batch 128) for 10
   (finite losses, no flash launch), and a ResNet-50 step by operator.
7. Numbers: the card's name and power limit; each kernel's device time at
   its main-path shapes beside its bound, its plain version's time and a
   PyTorch call that computes the same function (``scaled_dot_product_
   attention`` forward, and its backward for K2 and K3: yardsticks the
   port never calls); K1, K2 and K3 beside their bounds at a causal D=128
   shape of one 2048-token sequence; TTFT and decode tokens/s of phase 2;
   samples/s of every training run.

The line before the last is the ``kernels`` JSON object; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3, bf16 and
# fp32 rates in FLOP/s (the f32 kernels run on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# what each kernel moves and computes: tensors shaped like Q [B, Sq, H, D]
# and like K [B, Sk, Hkv, D] read or written once, float32 rows [B, H, Sq]
# (lse, delta), and products of 2 D FLOPs per visible (query, key) pair
KERNEL_WORK = {  # name: (q-like, k-like, rows, products)
    "flash_fwd": (2, 2, 1, 2),        # Q, O | K, V | lse | QK^T, PV
    "flash_bwd_dq": (3, 2, 2, 3),     # Q, dO, dQ | K, V | lse, delta
    "flash_bwd_dkv": (2, 4, 2, 4),    # Q, dO | K, V, dK, dV | lse, delta
}
# the bf16 K1, K2 and K3 instantiations, which must keep their wgmma
# products and TMA loads in the built code
WGMMA_KERNELS = ("flash_fwd_bf16_wgmma<64>", "flash_fwd_bf16_wgmma<128>",
                 "flash_bwd_dq_bf16_wgmma<64>", "flash_bwd_dq_bf16_wgmma<128>",
                 "flash_bwd_dkv_bf16_wgmma<64>",
                 "flash_bwd_dkv_bf16_wgmma<128>")

# phase 2's requests: prompt lengths and the engine settings
PROMPT_LENS = (17, 300, 700, 1500)
MAX_SEQ, PREFILL_CHUNK, NEW_TOKENS = 2048, 512, 16
EXTRA_SHAPES = [  # (name, B, Sq, Sk, H, Hkv, D, causal)
    ("gqa_ragged_strided", 2, 200, 700, 32, 8, 128, True),
    ("noncausal_d64", 2, 100, 300, 4, 4, 64, False),
]
# phase 4: BERT-large pretraining through the port's worker entrypoint
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 10, 24, 512
TRAIN_CONFIG = {"model": "bert", "model_config": {"size": "large"},
                "global_batch": TRAIN_BATCH, "steps": TRAIN_STEPS,
                "log_every": 1, "seed": 0,
                "optimizer": {"name": "adamw", "learning_rate": 1e-4}}
TRAIN_SHAPE = ("bert_large_train", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 16, 16,
               64, False)
# per step: K1 runs twice per layer (forward, and remat's recompute in the
# backward), K2 and K3 once per layer
TRAIN_LAUNCHES = {"flash_fwd": 48, "flash_bwd_dq": 24, "flash_bwd_dkv": 24}
# phase 5: Llama training at Llama-2-7B's width (hidden 4096, 32 heads of
# 128, FFN 11008, vocab 32000), float32 masters, bf16 compute, remat,
# sequence 512 as the Trainer makes Llama batches; depth cut from 32 to 20
# layers so masters, gradients and adamw moments (16 bytes per parameter,
# 66.9 GB) fit one 80 GB card
LLAMA_LAYERS, LLAMA_BATCH, LLAMA_SEQ = 20, 16, 512
LLAMA_CONFIG = {"model": "llama",
                "model_config": {"size": "7b", "num_layers": LLAMA_LAYERS},
                "global_batch": LLAMA_BATCH, "steps": TRAIN_STEPS,
                "log_every": 1, "seed": 0,
                "optimizer": {"name": "adamw", "learning_rate": 1e-4}}
LLAMA_SHAPE = ("llama7b_train", LLAMA_BATCH, LLAMA_SEQ, LLAMA_SEQ, 32, 32,
               128, True)
LLAMA_LAUNCHES = {"flash_fwd": 2 * LLAMA_LAYERS,
                  "flash_bwd_dq": LLAMA_LAYERS, "flash_bwd_dkv": LLAMA_LAYERS}
# phase 6: the vision models through the same Trainer (no flash kernel):
# (model, steps), global batch 128; ResNet-50 at 224 x 224
VISION_RUNS = (("mnist_mlp", 3), ("cifar_convnet", 3), ("resnet50", 10))
VISION_BATCH = 128
CAUSAL_DQ_SHAPE = (1, 2048, 2048, 32, 32, 128, True)  # B, Sq, Sk, H, Hkv, D
BWD_SHAPES = [TRAIN_SHAPE, LLAMA_SHAPE,  # (name, B, Sq, Sk, H, Hkv, D, causal)
              ("causal_d128", 2, 384, 384, 8, 8, 128, True),
              ("ragged_200_causal", 2, 200, 200, 16, 16, 64, True),
              ("gqa_32_over_8", 2, 256, 256, 32, 8, 128, True)]
# max |kernel - plain| / max |plain| per gradient (dQ, dK, dV).  f32:
# summation order only.  bf16: the kernels round P and dS to bf16 for
# their products (2^-8 relative per weight) and the gradients to bf16.
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# one train step through the kernels against the same step through the
# plain attention route, relative.  Both round the softmax weights to bf16
# before PV; the routes differ in where the backward rounds (the kernels
# round dS, the plain route's autograd rounds the weights' gradient), and
# 24 random-weight bf16 layers amplify such rounding-level differences
# (measured on an H100: 2.5e-5 on the loss, 3.7e-4 on grad_norm).
STEP_TOL = {"loss": 1e-3, "grad_norm": 5e-3}
# |kernel - plain| <= atol + rtol * |plain| per element of O, and <= lse
# absolutely.  f32: summation order only.  bf16: the kernel rounds P to
# bf16 for the PV product (2^-8 relative per weight) and both round O to
# bf16, so a rounding can flip by one ulp (2^-7 relative: 0.0156 at |O| 2)
TOL = {torch.float32: {"atol": 1e-5, "rtol": 1e-5, "lse": 1e-4},
       torch.bfloat16: {"atol": 1e-2, "rtol": 1e-2, "lse": 1e-3}}
# each bf16 kernel call inside the 7B prefill, against the plain version on
# the same activations.  Per element of O: rounding P to bf16 (relative
# 2^-8) moves O by at most 2^-8 sum_j p_j |v_j|, and the two bf16 roundings
# of O differ by at most one ulp (<= 2^-7 |O|); the check allows
# 2^-7 (|O| + sum_j p_j |v_j|), twice the P term, and reports the largest
# |dO| / allowance ("o", <= 1).  lse: |dlse| relative to max(1, |lse|)
# (float32 sums in another order).
IN_MODEL_TOL = {"o": 1.0, "lse": 1e-4}
# prefill logits of 32 bf16 layers, relative to max |logit|.  Against the
# kernel's plain version (same math, other summation order) each layer
# differs only where a bf16 rounding of O flips; against the plain masked
# route also by its rounding of every softmax weight to bf16 before PV.
# A random-weight 32-layer stack amplifies such rounding-level differences
# to a few percent of max |logit| (4.5e-2 for both, measured on an H100);
# a wrong kernel moves the logits by O(1).  The kernel itself is held
# tightly, call by call, by the in-model check above.
LOGITS_REL_TOL = {"kernel_plain_version": 1e-1, "plain_route": 1e-1}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, what) -> None:
    """Fail the run (a raise, unlike ``assert``, survives ``python -O``)."""
    if not ok:
        raise AssertionError(f"chip_smoke check failed: {what}")


def prefill_shapes() -> list[tuple[int, int]]:
    """(Sq, Sk) of every flash call per layer in phase 2: the engine's
    chunking of each prompt, each chunk padded to a prefill bucket."""
    from kubeflow_tpu_torch.serving.engine import PREFILL_BUCKETS

    shapes = []
    for n in PROMPT_LENS:
        pos = 0
        while pos < n:
            take = min(n - pos, PREFILL_CHUNK)
            cb = next((b for b in PREFILL_BUCKETS
                       if take <= b <= MAX_SEQ - pos), take)
            shapes.append((cb, pos + cb))
            pos += take
    return shapes


def main_path_shapes() -> list[tuple]:
    """Distinct 7B prefill shapes of phase 2 with their launch counts per
    layer: (name, B, Sq, Sk, H, Hkv, D, causal, count)."""
    counts: dict[tuple[int, int], int] = {}
    for s in prefill_shapes():
        counts[s] = counts.get(s, 0) + 1
    return [(f"7b_prefill_{sq}x{sk}", 1, sq, sk, 32, 32, 128, True, c)
            for (sq, sk), c in sorted(counts.items())]


def make_qkv(b, sq, sk, h, hkv, d, dtype, seed, strided=False):
    g = torch.Generator(device="cuda").manual_seed(seed)
    if strided:  # q as a [B, H, S, D] tensor viewed [B, S, H, D]
        q = torch.randn(b, h, sq, d, generator=g, device="cuda").to(dtype)
        q = q.transpose(1, 2)
    else:
        q = torch.randn(b, sq, h, d, generator=g, device="cuda").to(dtype)
    k = torch.randn(b, sk, hkv, d, generator=g, device="cuda").to(dtype)
    v = torch.randn(b, sk, hkv, d, generator=g, device="cuda").to(dtype)
    return q, k, v


def check_backward(fa, name, b, sq, sk, h, hkv, d, causal, dtype,
                   seed) -> tuple[float, float]:
    """Hold K2 and K3 against their plain versions on the same q, k, v,
    dO, lse and delta; returns the max abs errors (dQ, dK/dV)."""
    q, k, v = make_qkv(b, sq, sk, h, hkv, d, dtype, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1000)
    do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
    o, lse = fa.flash_attention_with_lse(q, k, v, causal=causal)
    delta = fa.flash_bwd_delta(o, do)
    got = (fa.flash_bwd_dq(q, k, v, do, lse, delta, causal=causal),
           *fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal))
    want = (fa.flash_bwd_dq_reference(q, k, v, do, lse, delta, causal=causal),
            *fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                        causal=causal))
    torch.cuda.synchronize()
    errs, rels = [], []
    for x, ref in zip(got, want):
        diff = (x.float() - ref.float()).abs().max().item()
        errs.append(diff)
        rels.append(diff / ref.float().abs().max().item())
    ok = all(math.isfinite(r) and r <= BWD_TOL[dtype] for r in rels)
    log(f"flash_bwd {name} {str(dtype)[6:]}: max|d| dQ {errs[0]:.3e} dK "
        f"{errs[1]:.3e} dV {errs[2]:.3e}; / max|ref| {rels[0]:.3e} "
        f"{rels[1]:.3e} {rels[2]:.3e} (tol {BWD_TOL[dtype]:g}) "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, f"flash_bwd disagrees at {name} {dtype}")
    return errs[0], max(errs[1:])


def sass_counts(path: Path) -> dict[str, tuple[int, int]]:
    """(HGMMA, UTMALDG) instructions per kernel of a built library, from
    ``cuobjdump -sass``: the wgmma products and the TMA tile loads that
    the compiler kept, by the kernel's short name (``name<D>``)."""
    from kubeflow_tpu_torch.ops import _build

    cuobjdump = Path(_build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(path)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts: dict[str, list[int]] = {}
    current = None
    for line in sass.splitlines():
        if "Function :" in line:
            mangled = line.split("Function :")[1].strip()
            m = re.search(r"(?<=\d)(flash_\w+?)ILi(\d+)E", mangled)
            current = f"{m.group(1)}<{m.group(2)}>" if m else mangled
            counts[current] = [0, 0]
        elif current is not None:
            counts[current][0] += "HGMMA" in line
            counts[current][1] += "UTMALDG" in line
    return {k: (v[0], v[1]) for k, v in counts.items()}


def check_build(libs: dict) -> None:
    """Print what ptxas and cuobjdump say of each library; fail on a
    spill, on wgmma products that ptxas serialises, or when a bf16 K1, K2
    or K3 instantiation lost its wgmma products (HGMMA) or its TMA loads
    (UTMALDG)."""
    from kubeflow_tpu_torch.ops import _build

    for name, path in libs.items():
        for line in _build.build_log(name).splitlines():
            if any(w in line for w in ("registers", "spill", "error",
                                       "Performance Loss")):
                log(f"  nvcc[{name}] {line.strip()}")
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            check(m is None or m.groups() == ("0", "0"),
                  f"ptxas spills in {name}: {line.strip()}")
            # ptxas runs the wgmma products of such a kernel one by one
            check("Performance Loss" not in line,
                  f"ptxas serialises wgmma in {name}: {line.strip()}")
        for kernel, (hgmma, utmaldg) in sorted(sass_counts(path).items()):
            log(f"  sass[{name}] {kernel}: HGMMA {hgmma} UTMALDG {utmaldg}")
    wgmma = {**sass_counts(libs["flash_fwd"]), **sass_counts(libs["flash_bwd"])}
    for kernel in WGMMA_KERNELS:
        hgmma, utmaldg = wgmma.get(kernel, (0, 0))
        check(hgmma > 0 and utmaldg > 0,
              f"{kernel}: HGMMA {hgmma}, UTMALDG {utmaldg} (wanted > 0)")


def phase_kernels(fa) -> dict:
    """Hold the kernels against their plain versions; returns each
    kernel's max abs error at the bf16 main-path shapes."""
    from kubeflow_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f}s")
    check_build(libs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    main_err = 0.0
    cases = ([s[:8] for s in main_path_shapes()] + [TRAIN_SHAPE, LLAMA_SHAPE]
             + EXTRA_SHAPES)
    for i, (name, b, sq, sk, h, hkv, d, causal) in enumerate(cases):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = make_qkv(b, sq, sk, h, hkv, d, dtype, seed=i,
                               strided=name.endswith("strided"))
            o, lse = fa.flash_attention_with_lse(q, k, v, causal=causal)
            ro, rlse = fa.flash_attention_reference(q, k, v, causal=causal)
            torch.cuda.synchronize()
            tol = TOL[dtype]
            diff = (o.float() - ro.float()).abs()
            e_o = diff.max().item()
            over = (diff - tol["atol"] - tol["rtol"] * ro.float().abs()
                    ).max().item()
            e_l = (lse - rlse).abs().max().item()
            ok = math.isfinite(e_o) and over <= 0 and e_l <= tol["lse"]
            log(f"flash_fwd {name} {str(dtype)[6:]}: max|dO| {e_o:.3e} "
                f"(tol {tol['atol']:g} + {tol['rtol']:g}|O|), max|dlse| "
                f"{e_l:.3e} (tol {tol['lse']:g}) {'ok' if ok else 'FAIL'}")
            check(ok, f"flash_fwd disagrees at {name} {dtype}")
            if dtype == torch.bfloat16 and name.startswith(
                    ("7b_prefill", TRAIN_SHAPE[0], LLAMA_SHAPE[0])):
                main_err = max(main_err, e_o)
    errs = {"flash_fwd": main_err, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for i, (name, *shape) in enumerate(BWD_SHAPES):
        for dtype in (torch.bfloat16, torch.float32):
            e_dq, e_dkv = check_backward(fa, name, *shape, dtype, seed=50 + i)
            if dtype == torch.bfloat16 and name in (TRAIN_SHAPE[0],
                                                    LLAMA_SHAPE[0]):
                errs["flash_bwd_dq"] = max(errs["flash_bwd_dq"], e_dq)
                errs["flash_bwd_dkv"] = max(errs["flash_bwd_dkv"], e_dkv)
    return errs


def post(port: int, path: str, body: dict) -> tuple[int, dict]:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", path, json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


@contextlib.contextmanager
def flash_route(replacement):
    """Route the attention dispatcher's flash calls to ``replacement``
    (same signature as ``flash_attention``) for the duration."""
    from kubeflow_tpu_torch.ops import attention

    original = attention.flash_attention
    attention.flash_attention = replacement
    try:
        yield
    finally:
        attention.flash_attention = original


@contextlib.contextmanager
def plain_attention_route(model):
    """Run ``model`` with its attention on the plain masked route
    (use_flash off) for the duration; the weights are shared."""
    attns = [blk.attention for blk in model.layers]
    flash_cfg = attns[0].cfg
    plain_cfg = dataclasses.replace(flash_cfg, use_flash=False)
    for a in attns:
        a.cfg = plain_cfg
    try:
        yield
    finally:
        for a in attns:
            a.cfg = flash_cfg


def check_in_model(fa, model, prompt: list[int]) -> None:
    """Chunked prefill of ``prompt`` through a batch-1 cache, as the engine
    runs it, with every flash call held against the plain version on the
    same q, k, v (the kernel's output goes on)."""
    from kubeflow_tpu_torch.models import llama

    worst = {"o": 0.0, "lse": 0.0}
    shapes = set()

    def checked(q, k, v, *, causal=False):
        o, lse = fa.flash_attention_with_lse(q, k, v, causal=causal)
        ro, rlse = fa.flash_attention_reference(q, k, v, causal=causal)
        sum_pv = fa.flash_attention_reference(q, k, v.abs(),
                                              causal=causal)[0].float()
        allowance = 2.0 ** -7 * (ro.float().abs() + sum_pv) + 1e-6
        e_o = ((o.float() - ro.float()).abs() / allowance).max().item()
        e_l = ((lse - rlse).abs().max()
               / rlse.abs().max().clamp_min(1.0)).item()
        check(math.isfinite(e_o) and math.isfinite(e_l), (e_o, e_l))
        worst["o"], worst["lse"] = max(worst["o"], e_o), max(worst["lse"], e_l)
        shapes.add((q.shape[1], k.shape[1]))
        return o

    cache = llama.init_cache(model.config, 1, MAX_SEQ)
    with torch.no_grad(), flash_route(checked):
        for pos in range(0, len(prompt), PREFILL_CHUNK):
            chunk = prompt[pos:pos + PREFILL_CHUNK]
            for layer in cache["layers"]:
                layer["index"] = pos
            model(torch.tensor([chunk], device="cuda"), cache=cache)
    ok = (worst["o"] <= IN_MODEL_TOL["o"]
          and worst["lse"] <= IN_MODEL_TOL["lse"])
    log(f"in-model check, {len(prompt)}-token prefill (Sq, Sk) "
        f"{sorted(shapes)} x {model.config.num_layers} layers: max "
        f"|dO|/(2^-7 (|O| + P|V|)) {worst['o']:.3e} (tol "
        f"{IN_MODEL_TOL['o']:g}), max|dlse|/max|lse| "
        f"{worst['lse']:.3e} (tol {IN_MODEL_TOL['lse']:g}) "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, worst)
    del cache


def phase_serving(fa) -> dict:
    from kubeflow_tpu_torch.serving.httpserve import serve
    from kubeflow_tpu_torch.serving.predictor import (GenerativePredictor,
                                                      PredictorApp)

    t0 = time.perf_counter()
    pred = GenerativePredictor("llama", size="7b", max_seq=MAX_SEQ,
                               prefill_chunk=PREFILL_CHUNK, max_batch=4,
                               seed=0)
    torch.cuda.synchronize()
    cfg = pred.cfg
    log(f"llama 7b built in {time.perf_counter() - t0:.1f}s: "
        f"{cfg.num_layers} layers, hidden {cfg.hidden_size}, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    httpd, thread = serve(PredictorApp({"llama": pred}), 0)
    port = httpd.server_port
    try:
        def make_bodies(seed):
            rng = np.random.default_rng(seed)
            bodies = [{"ids": [rng.integers(1, cfg.vocab_size, n).tolist()],
                       "max_new_tokens": NEW_TOKENS} for n in PROMPT_LENS]
            bodies[3].update(temperature=0.8, seed=7)
            return bodies

        def concurrent_round(bodies):
            results: list = [None] * len(bodies)

            def call(i):
                results[i] = post(port, "/v1/models/llama:generate",
                                  bodies[i])

            threads = [threading.Thread(target=call, args=(i,))
                       for i in range(len(bodies))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            return results

        # warm-up round at the same shapes (CUDA module loading, cuBLAS
        # heuristics, allocator), other prompts; not counted
        check(all(r[0] == 200 for r in concurrent_round(make_bodies(1))),
              "warm-up round")
        bodies = make_bodies(0)
        prompts = [b["ids"][0] for b in bodies]
        chunks = len(prefill_shapes())
        before = pred.engine.stats()["timing"]

        fa.flash_attention.launches = 0          # the main path starts
        t0 = time.perf_counter()
        results = concurrent_round(bodies)
        wall = time.perf_counter() - t0
        launches = fa.flash_attention.launches   # the main path ended
        after = pred.engine.stats()["timing"]

        for i, (status, body) in enumerate(results):
            check(status == 200, (i, status, body))
            out = body["ids"][0]
            check(len(out) == PROMPT_LENS[i] + NEW_TOKENS, (i, len(out)))
            check(out[:PROMPT_LENS[i]] == prompts[i], (i, "prompt echo"))
            check(all(0 <= t < cfg.vocab_size for t in out), (i, "ids"))
        expect = cfg.num_layers * chunks
        log(f"4 concurrent requests in {wall:.2f}s; flash_fwd launches "
            f"{launches} (expected {cfg.num_layers} x {chunks} chunks = "
            f"{expect})")
        check(launches == expect, (launches, expect))
        check(after["prefill_chunks"] - before["prefill_chunks"] == chunks,
              "prefill chunks")

        for i in (1, 3):  # a greedy and the seeded request, alone
            status, body = post(port, "/v1/models/llama:generate", bodies[i])
            check(status == 200 and body["ids"] == results[i][1]["ids"],
                  (i, "re-sent request"))
        log("re-sent greedy and seeded requests reproduce their tokens")

        model = pred.module
        check_in_model(fa, model, prompts[3])

        # prefill logits: kernel route vs the plain routes, same weights
        ids = torch.tensor([prompts[1]], device="cuda")

        def plain_version(q, k, v, *, causal=False):
            return fa.flash_attention_reference(q, k, v, causal=causal)[0]

        with torch.no_grad():
            k_logits = model(ids)["logits"]
            check(torch.equal(model(ids)["logits"], k_logits),
                  "the kernel route is not deterministic")
            with flash_route(plain_version):
                v_logits = model(ids)["logits"]
            with plain_attention_route(model):
                p_logits = model(ids)["logits"]
        check(bool(torch.isfinite(k_logits).all()), "finite logits")
        for name, ref in (("kernel_plain_version", v_logits),
                          ("plain_route", p_logits)):
            rel = ((k_logits - ref).abs().max() / ref.abs().max()).item()
            tol = LOGITS_REL_TOL[name]
            log(f"prefill logits [1, {len(prompts[1])}, {cfg.vocab_size}] "
                f"kernel vs {name}: max rel err {rel:.3e} (tol {tol:g})")
            check(rel <= tol, (name, rel))

        n_ttft = after["ttft_count"] - before["ttft_count"]
        dec_tok = after["decode_tokens"] - before["decode_tokens"]
        dec_s = after["decode_seconds"] - before["decode_seconds"]
        return {"launches": launches,
                "ttft_mean_s": (after["ttft_sum"] - before["ttft_sum"])
                / max(n_ttft, 1),
                "decode_tok_per_s": dec_tok / dec_s if dec_s else 0.0,
                "wall_s": wall}
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
        pred.stop(timeout=60)


def time_ms(fn, reps: int = 20, windows: int = 7) -> float:
    """Device time of one call: median over windows of the mean of
    ``reps`` back-to-back calls, from CUDA events, after a warm-up.  Each
    window is enqueued behind a device-side sleep longer than the host
    takes to enqueue it, so the calls run back to back even when the
    Python wrapper is slower than the kernel."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)      # ~10 ms at H100 clocks
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def flash_bound(kernel, b, sq, sk, h, hkv, d, causal,
                dtype) -> tuple[float, float]:
    """Least time the card needs for ``kernel`` (``KERNEL_WORK``), as
    (bytes ms, operations ms): each input read once and each output
    written once over the HBM rate; the FLOPs of the visible (q, k) pairs
    over the dtype's peak rate."""
    n_q, n_k, n_rows, products = KERNEL_WORK[kernel]
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = (n_q * b * sq * h * d + n_k * b * sk * hkv * d) * item \
        + n_rows * b * h * sq * 4
    if causal:  # query i sees keys [0, i + sk - sq]
        pairs = sum(max(0, min(sk, i + sk - sq + 1)) for i in range(sq))
    else:
        pairs = sq * sk
    flops = 2.0 * products * d * pairs * b * h
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3


def bound_fields(kernel, shape, dtype) -> dict:
    t_bytes, t_ops = flash_bound(kernel, *shape, dtype)
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "operations_ms": t_ops}


def profile_device(label: str, fn, top: int = 6) -> float:
    """Device time of one ``fn()`` by operator (torch.profiler), after a
    warm-up call: prints the total and the ``top`` kernels; returns the
    total in ms."""
    from torch.profiler import ProfilerActivity, profile

    fn()                                  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # device kernels only: operator rows repeat their kernels' time
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")
              and e.self_device_time_total > 0]
    total = sum(e.self_device_time_total for e in events)
    log(f"profile {label}: device time {total / 1e3:.3f} ms")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms "
            f"{100 * e.self_device_time_total / max(total, 1):5.1f}% "
            f"x{e.count:<4d} {e.key[:90]}")
    for e in events:
        if "flash_" in e.key:
            log(f"  ours: {e.self_device_time_total / 1e3:9.3f} ms "
                f"{100 * e.self_device_time_total / max(total, 1):5.1f}% "
                f"x{e.count:<4d} {e.key[:90]}")
    groups: dict[str, float] = {}
    for e in events:
        group = kernel_group(e.key)
        groups[group] = groups.get(group, 0.0) + e.self_device_time_total
    log("  by kind: " + ", ".join(
        f"{g} {t / 1e3:.3f} ms ({100 * t / max(total, 1):.1f}%)"
        for g, t in sorted(groups.items(), key=lambda kv: -kv[1])))
    return total / 1e3


def kernel_group(key: str) -> str:
    """A device kernel's kind, from its name."""
    if "flash_" in key:
        return "flash kernels"
    if any(w in key for w in ("fprop", "dgrad", "wgrad", "conv")):
        return "convolution"
    if "f32f32" in key or "sgemm" in key:
        return "float32 GEMM"
    if "nvjet" in key or "gemm" in key or "cutlass" in key:
        return "bf16 GEMM"
    if "indexing" in key or "index_" in key or "scatter" in key:
        return "gather/scatter"
    if "reduce" in key or "softmax" in key or "norm" in key:
        return "reductions"
    if "elementwise" in key or "copy" in key or "foreach" in key:
        return "elementwise"
    return "other"


def profile_forward(model, label: str, ids, cache) -> None:
    """Device time of one forward by operator, top 6, and the flash
    kernel's share."""
    def forward():
        with torch.no_grad():
            model(ids, cache=cache)

    profile_device(label, forward)


def phase_profile() -> None:
    """Where a prefill chunk's and a decode step's device time goes, at
    the 7B serving shapes (random weights, seed 0)."""
    from kubeflow_tpu_torch.models import llama, registry

    model = registry.get("llama").make_model(
        size="7b", param_dtype="compute").init_weights(0)
    cfg = model.config
    scratch = llama.init_cache(cfg, 1, MAX_SEQ)
    for layer in scratch["layers"]:
        layer["index"] = 512
    ids = torch.randint(1, cfg.vocab_size, (1, 512), device="cuda")
    profile_forward(model, "prefill chunk [1, 512] at offset 512", ids,
                    scratch)
    view = llama.init_cache(cfg, 4, MAX_SEQ, per_sequence=True)
    for layer in view["layers"]:
        layer["index"] = torch.tensor([16, 300, 700, 1500], device="cuda")
    tok = torch.randint(1, cfg.vocab_size, (4, 1), device="cuda")
    profile_forward(model, "decode step [4, 1] over a 4 x 2048 view", tok,
                    view)
    del model, scratch, view
    torch.cuda.empty_cache()


KERNEL_NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def counters(fa) -> dict:
    """Each kernel's launch counter, by kernel name."""
    return {"flash_fwd": fa.flash_attention.launches,
            "flash_bwd_dq": fa.flash_bwd_dq.launches,
            "flash_bwd_dkv": fa.flash_bwd_dkv.launches}


def set_counters(fa, values: dict) -> None:
    fa.flash_attention.launches = values["flash_fwd"]
    fa.flash_bwd_dq.launches = values["flash_bwd_dq"]
    fa.flash_bwd_dkv.launches = values["flash_bwd_dkv"]


def phase_training(fa, config: dict, launches: dict, label: str) -> dict:
    """A training main path: the worker entrypoint in-process with
    ``config``, every step logged (a sync per step).  Every step must
    launch each kernel ``launches[name]`` times and every loss must be
    finite."""
    from kubeflow_tpu_torch.training import __main__ as worker

    losses, stamps, per_step = [], [], []
    seen = dict.fromkeys(KERNEL_NAMES, 0)
    steps, batch = config["steps"], config["global_batch"]

    def hook(step, rec):
        now = counters(fa)
        per_step.append({n: now[n] - seen[n] for n in KERNEL_NAMES})
        seen.update(now)
        losses.append(rec["loss"])
        stamps.append(time.perf_counter())

    saved_env = os.environ.get("JAXJOB_TRAINER_CONFIG")
    os.environ["JAXJOB_TRAINER_CONFIG"] = json.dumps(config)
    try:
        set_counters(fa, dict.fromkeys(KERNEL_NAMES, 0))  # the path starts
        t0 = time.perf_counter()
        rc = worker.main(["--device", "cuda"], metrics_hook=hook)
        wall = time.perf_counter() - t0
        total = counters(fa)                              # the path ended
    finally:
        if saved_env is None:
            os.environ.pop("JAXJOB_TRAINER_CONFIG", None)
        else:
            os.environ["JAXJOB_TRAINER_CONFIG"] = saved_env
    check(rc == 0, f"{label}: training worker exited {rc}")
    check(len(losses) == steps, f"{label}: {len(losses)} logged steps")
    check(all(math.isfinite(x) for x in losses), f"{label}: losses {losses}")
    log(f"{label} training, {steps} steps at batch {batch}: losses "
        f"{' '.join(f'{x:.4f}' for x in losses)}")
    for i, got in enumerate(per_step):
        check(got == launches, f"{label} step {i + 1} launches {got}, "
              f"expected {launches}")
    log(f"{label} launches per step {per_step[0]} in each of "
        f"{len(per_step)} steps (expected {launches}); total {total}")
    steady = batch * (len(stamps) - 1) / (stamps[-1] - stamps[0])
    log(f"{label} samples/s: {steady:.2f} over steps 2-{steps} "
        f"({1e3 * batch / steady:.1f} ms per step), "
        f"{batch * steps / wall:.2f} over the whole run including model "
        f"build ({wall:.1f}s)")
    return {"launches": total, "losses": losses, "samples_per_sec": steady,
            "wall_s": wall}


@contextlib.contextmanager
def backward_checked(fa, worst: dict):
    """Route the flash Function's backward through a wrapper that runs it
    (K2 and K3 launch as usual), then runs each kernel's plain version on
    that call's inputs (q, k, v, dO, lse and the same delta) and keeps the
    largest max|kernel - plain| / max|plain| per gradient."""
    backward = fa.flash_attention_backward

    def note(key, x, ref):
        rel = ((x.float() - ref.float()).abs().max()
               / ref.float().abs().max()).item()
        check(math.isfinite(rel), (key, rel))
        worst[key] = max(worst.get(key, 0.0), rel)

    def checked(q, k, v, o, lse, do, *, causal=False):
        dq, dk, dv = backward(q, k, v, o, lse, do, causal=causal)
        do = do.to(q.dtype)
        delta = fa.flash_bwd_delta(o, do)
        note("dq", dq, fa.flash_bwd_dq_reference(q, k, v, do, lse, delta,
                                                 causal=causal))
        rdk, rdv = fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                              causal=causal)
        note("dk", dk, rdk)
        note("dv", dv, rdv)
        worst["calls"] = worst.get("calls", 0) + 1
        return dq, dk, dv

    fa.flash_attention_backward = checked
    try:
        yield
    finally:
        fa.flash_attention_backward = backward


def free_memory() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def build_training(config: dict, optimizer: dict):
    """(model, state, step, batch) of ``config``'s model on the card with
    weights from seed 0 and the first synthetic batch."""
    from kubeflow_tpu_torch.models import registry
    from kubeflow_tpu_torch.parallel import train_step as ts
    from kubeflow_tpu_torch.training.data import to_device
    from kubeflow_tpu_torch.training.optim import make_optimizer

    entry = registry.get(config["model"])
    model = entry.make_model(device="cuda",
                             **config["model_config"]).init_weights(0)
    state = ts.init_train_state(model, make_optimizer(optimizer))
    step = ts.build_train_step(entry.forward_loss, state.tx)
    batch = to_device(entry.make_batch(
        config["global_batch"], torch.Generator().manual_seed(0), model),
        torch.device("cuda"))
    return model, state, step, batch


def profile_step(label: str, state, step, batch) -> None:
    """Wall and device time of one train step, by operator, and the
    device's idle share over it."""
    step(state, batch)                      # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(state, batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    device = profile_device(label, lambda: step(state, batch), top=15)
    log(f"train step wall {wall:.3f} ms, device busy {device:.3f} ms, "
        f"idle share {max(0.0, 1 - device / wall):.3f}")


def check_training_step(fa, config: dict, launches: dict,
                        label: str) -> None:
    """One train step of ``config``'s model through the kernels (every K2
    and K3 call held against its plain version) against the same step
    through the plain attention route; then the device time by operator
    of a step with the main path's optimizer."""
    from kubeflow_tpu_torch.models import registry
    from kubeflow_tpu_torch.parallel import train_step as ts
    from kubeflow_tpu_torch.training.optim import make_optimizer

    # learning rate 0: each step computes loss, gradients and grad_norm and
    # leaves the weights as they were, so both routes see the same ones
    model, state, step, batch = build_training(
        config, {"name": "sgd", "learning_rate": 0.0, "momentum": 0.0})

    def run() -> dict:
        _, metrics = step(state, batch)
        return {k: v.item() for k, v in metrics.items()}

    run()                                   # warm
    worst: dict = {}
    before = counters(fa)
    with backward_checked(fa, worst):
        kern = run()
    launched = {n: counters(fa)[n] - before[n] for n in KERNEL_NAMES}
    check(launched == launches, f"checked step launched {launched}")
    with plain_attention_route(model):
        plain = run()
    calls = worst.pop("calls")
    ok_calls = (calls == model.config.num_layers
                and max(worst.values()) <= BWD_TOL[torch.bfloat16])
    log(f"in-step check: {calls} K2 and K3 calls of one {label} step vs "
        f"plain: max|d|/max|ref| dQ {worst['dq']:.3e} dK {worst['dk']:.3e} "
        f"dV {worst['dv']:.3e} (tol {BWD_TOL[torch.bfloat16]:g}) "
        f"{'ok' if ok_calls else 'FAIL'}")
    check(ok_calls, (calls, worst))
    for key in ("loss", "grad_norm"):
        rel = abs(kern[key] - plain[key]) / abs(plain[key])
        ok = math.isfinite(rel) and rel <= STEP_TOL[key]
        log(f"{label} train step {key}: kernels {kern[key]:.6f}, plain "
            f"route {plain[key]:.6f}, rel diff {rel:.3e} (tol "
            f"{STEP_TOL[key]:g}) {'ok' if ok else 'FAIL'}")
        check(ok, (key, kern, plain))

    # the main path's step (its optimizer), by operator
    del state, step
    free_memory()
    state = ts.init_train_state(model, make_optimizer(config["optimizer"]))
    step = ts.build_train_step(registry.get(config["model"]).forward_loss,
                               state.tx)
    profile_step(f"{label} {config['optimizer']['name']} train step "
                 f"{list(batch['input_ids'].shape)}", state, step, batch)
    del model, state, step, batch
    free_memory()


def card_line() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30)
    return (smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
            else f"nvidia-smi: {smi.stderr.strip()}")


def phase_numbers(fa, num_layers: int) -> list[dict]:
    """K1's kernel, plain and library times with the bound, at each
    serving main-path shape; rows carry the shape's launches per layer and
    in the whole serving run."""
    from torch.nn.attention.bias import causal_lower_right
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    rows = []
    for name, b, sq, sk, h, hkv, d, causal, count in main_path_shapes():
        dtype = torch.bfloat16
        q, k, v = make_qkv(b, sq, sk, h, hkv, d, dtype, seed=11)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = causal_lower_right(sq, sk) if causal else None
        saved = counters(fa)
        ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=causal))
        set_counters(fa, saved)                  # timing is not the path
        plain_ms = time_ms(
            lambda: fa.flash_attention_reference(q, k, v, causal=causal))
        library_ms = time_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask))
        row = {"shape": name, "per_layer": count,
               "launches": count * num_layers, "ms": ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               **bound_fields("flash_fwd", (b, sq, sk, h, hkv, d, causal),
                              dtype)}
        log(f"flash_fwd {name} bf16 (x{count} per layer): kernel {ms:.4f} "
            f"ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}), plain "
            f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms")
        rows.append(row)
    return rows


def training_numbers(fa, shape_row: tuple, launches: dict,
                     per_step: dict) -> dict[str, dict]:
    """Each kernel's times at a training shape: kernel, plain version,
    bound, and the library yardstick (SDPA forward for K1; SDPA's
    backward, which computes dQ, dK and dV in one call, for K2 and K3).
    Rows carry the main path's ``launches`` of each kernel."""
    name, b, sq, sk, h, hkv, d, causal = shape_row
    shape = (b, sq, sk, h, hkv, d, causal)
    ms, plain, library = kernel_times(fa, shape, seed=12)
    rows = {}
    for kernel in KERNEL_NAMES:
        rows[kernel] = row = {
            "shape": name, "launches": launches[kernel], "ms": ms[kernel],
            "plain_ms": plain[kernel], "library_ms": library[kernel],
            **bound_fields(kernel, shape, torch.bfloat16)}
        log(f"{kernel} {name} bf16 (x{per_step[kernel]} per step): "
            f"kernel {row['ms']:.5f} ms, bound {row['bound_ms']:.5f} ms "
            f"({row['bound_by']}), plain {row['plain_ms']:.5f} ms, "
            f"library {row['library_ms']:.5f} ms")
    log(f"sdpa {name} bf16: forward {library['flash_fwd']:.5f} ms, backward "
        f"(dQ, dK, dV) {library['flash_bwd_dq']:.5f} ms; flash kernels: "
        f"forward {ms['flash_fwd']:.5f} ms, backward "
        f"{ms['flash_bwd_dq'] + ms['flash_bwd_dkv']:.5f} ms")
    return rows


def kernel_times(fa, shape: tuple, seed: int, plain_too: bool = True):
    """({kernel: ms}, {kernel: plain ms}, {kernel: SDPA ms}) of K1, K2 and
    K3 on bf16 inputs of ``shape`` (B, Sq, Sk, H, Hkv, D, causal); the
    launches made here are not counted."""
    from torch.nn.attention.bias import causal_lower_right
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    b, sq, sk, h, hkv, d, causal = shape
    dtype = torch.bfloat16
    q, k, v = make_qkv(b, sq, sk, h, hkv, d, dtype, seed=seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
    o, lse = fa.flash_attention_with_lse(q, k, v, causal=causal)
    delta = fa.flash_bwd_delta(o, do)
    saved = counters(fa)
    ms = {"flash_fwd": time_ms(
              lambda: fa.flash_attention_with_lse(q, k, v, causal=causal)),
          "flash_bwd_dq": time_ms(lambda: fa.flash_bwd_dq(
              q, k, v, do, lse, delta, causal=causal)),
          "flash_bwd_dkv": time_ms(lambda: fa.flash_bwd_dkv(
              q, k, v, do, lse, delta, causal=causal))}
    set_counters(fa, saved)                      # timing is not the path
    if not plain_too:
        return ms, {}, {}
    plain = {"flash_fwd": time_ms(
                 lambda: fa.flash_attention_reference(q, k, v, causal=causal)),
             "flash_bwd_dq": time_ms(lambda: fa.flash_bwd_dq_reference(
                 q, k, v, do, lse, delta, causal=causal)),
             "flash_bwd_dkv": time_ms(lambda: fa.flash_bwd_dkv_reference(
                 q, k, v, do, lse, delta, causal=causal))}
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    mask = causal_lower_right(sq, sk) if causal else None
    sdpa_fwd = time_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask))
    ot = sdpa(qt, kt, vt, attn_mask=mask)
    dot = do.transpose(1, 2)
    sdpa_bwd = time_ms(lambda: torch.autograd.grad(
        ot, (qt, kt, vt), dot, retain_graph=True))
    return ms, plain, {"flash_fwd": sdpa_fwd, "flash_bwd_dq": sdpa_bwd,
                       "flash_bwd_dkv": sdpa_bwd}


def causal_numbers(fa) -> None:
    """K1, K2 and K3 under the causal mask at D = 128 (Llama-2-7B's heads,
    one sequence of 2048), off the main paths, beside their bounds."""
    ms, _, _ = kernel_times(fa, CAUSAL_DQ_SHAPE, seed=15, plain_too=False)
    for kernel in KERNEL_NAMES:
        bound = bound_fields(kernel, CAUSAL_DQ_SHAPE, torch.bfloat16)
        log(f"{kernel} causal {CAUSAL_DQ_SHAPE} bf16: kernel "
            f"{ms[kernel]:.5f} ms, bound {bound['bound_ms']:.5f} ms "
            f"({bound['bound_by']})")


def per_launch(rows: list[dict], key: str) -> float:
    """Mean over the main paths' launches (each shape weighted by its
    launches)."""
    n = sum(r["launches"] for r in rows)
    return sum(r[key] * r["launches"] for r in rows) / n


def kernel_entry(name: str, rows: list[dict], max_err: float) -> dict:
    """One kernel's object of the ``kernels`` line; times per launch over
    the main paths' mix of shapes."""
    source, replaces = {
        "flash_fwd": ("flash_fwd.cu", ":136"),
        "flash_bwd_dq": ("flash_bwd.cu", ":264"),
        "flash_bwd_dkv": ("flash_bwd.cu", ":282"),
    }[name]
    bytes_ms, ops_ms = (per_launch(rows, k) for k in ("bytes_ms",
                                                       "operations_ms"))
    ms = per_launch(rows, "ms")
    return {
        "name": name, "route": "cuda",
        "source": f"kubeflow_tpu_torch/ops/csrc/{source}",
        "replaces": f"kubeflow_tpu/ops/flash_attention.py{replaces}",
        "launches": sum(r["launches"] for r in rows), "max_abs_err": max_err,
        "ms": ms, "kernel_ms": ms, "plain_ms": per_launch(rows, "plain_ms"),
        "bound_ms": per_launch(rows, "bound_ms"),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": per_launch(rows, "library_ms"), "shapes": rows,
    }


def phase_vision(fa) -> dict:
    """Phase 6: ``VISION_RUNS`` through the worker entrypoint (no flash
    kernel: every step must launch none), then one ResNet-50 adamw step by
    operator."""
    results = {}
    for model, steps in VISION_RUNS:
        config = {"model": model, "model_config": {},
                  "global_batch": VISION_BATCH, "steps": steps,
                  "log_every": 1, "seed": 0, "prefetch": 2,
                  "optimizer": {"name": "adamw", "learning_rate": 1e-3}}
        results[model] = phase_training(
            fa, config, dict.fromkeys(KERNEL_NAMES, 0), model)
        free_memory()
    model, state, step, batch = build_training(config, config["optimizer"])
    profile_step(f"ResNet-50 adamw train step {list(batch['image'].shape)}",
                 state, step, batch)
    del model, state, step, batch
    free_memory()
    return results


def kernel_times_only(fa) -> int:
    """``--kernel-times``: build the kernels and time K1, K2 and K3 at the
    Llama training shape and at the causal 2048 shape (for an A/B of two
    trees' kernels in one call); prints no result line."""
    from kubeflow_tpu_torch.ops import _build

    check_build(_build.build_all())
    log(card_line())
    name, *shape = LLAMA_SHAPE
    ms, _, _ = kernel_times(fa, tuple(shape), seed=12, plain_too=False)
    for kernel in KERNEL_NAMES:
        bound = bound_fields(kernel, tuple(shape), torch.bfloat16)
        log(f"{kernel} {name} bf16: kernel {ms[kernel]:.5f} ms, bound "
            f"{bound['bound_ms']:.5f} ms ({bound['bound_by']})")
    causal_numbers(fa)
    return 0


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 2
    import kubeflow_tpu_torch
    from kubeflow_tpu_torch.ops import flash_attention as fa

    pkg = Path(kubeflow_tpu_torch.__file__).resolve().parent
    if pkg.parent != ROOT:
        print(f"chip_smoke: kubeflow_tpu_torch was imported from {pkg}, not "
              f"from the checkout beside this script ({ROOT})",
              file=sys.stderr)
        return 2
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    if argv == ["--kernel-times"]:
        return kernel_times_only(fa)
    if argv:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    errs = phase_kernels(fa)
    serving = phase_serving(fa)
    phase_profile()
    free_memory()
    log(f"before training: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated on the card")
    bert = phase_training(fa, TRAIN_CONFIG, TRAIN_LAUNCHES, "BERT-large")
    check_training_step(fa, TRAIN_CONFIG, TRAIN_LAUNCHES, "BERT-large")
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    llama = phase_training(fa, LLAMA_CONFIG, LLAMA_LAUNCHES,
                           f"Llama-7B-width x{LLAMA_LAYERS} layers")
    free_memory()
    check_training_step(fa, LLAMA_CONFIG, LLAMA_LAUNCHES,
                        f"Llama-7B-width x{LLAMA_LAYERS} layers")
    peak = torch.cuda.max_memory_allocated()
    card = torch.cuda.get_device_properties(0).total_memory
    log(f"Llama phase peak memory (max_memory_allocated over the counted run "
        f"and its checks): {peak / 1e9:.2f} GB, {100 * peak / card:.1f}% of "
        f"the card's {card / 1e9:.2f} GB")
    vision = phase_vision(fa)
    log(card_line())
    serving_rows = phase_numbers(fa, num_layers=32)
    bert_rows = training_numbers(fa, TRAIN_SHAPE, bert["launches"],
                                 TRAIN_LAUNCHES)
    llama_rows = training_numbers(fa, LLAMA_SHAPE, llama["launches"],
                                  LLAMA_LAUNCHES)
    causal_numbers(fa)
    log(f"phase 2: TTFT mean {serving['ttft_mean_s'] * 1e3:.1f} ms over the "
        f"4 concurrent requests; decode "
        f"{serving['decode_tok_per_s']:.1f} tok/s over 4 slots")
    log(f"training samples/s: BERT-large {bert['samples_per_sec']:.2f}, "
        f"Llama-7B-width x{LLAMA_LAYERS} {llama['samples_per_sec']:.3f}, "
        + ", ".join(f"{m} {r['samples_per_sec']:.1f}"
                    for m, r in vision.items())
        + f"; total {time.perf_counter() - t_start:.1f}s")
    check(serving["launches"] == sum(r["launches"] for r in serving_rows),
          "serving launches")
    kernels = [kernel_entry("flash_fwd", serving_rows + [
        bert_rows["flash_fwd"], llama_rows["flash_fwd"]], errs["flash_fwd"])]
    kernels += [kernel_entry(name, [bert_rows[name], llama_rows[name]],
                             errs[name])
                for name in ("flash_bwd_dq", "flash_bwd_dkv")]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
