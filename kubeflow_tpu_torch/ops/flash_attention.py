"""Flash attention forward over [B, S, H, D]: the Hopper kernel and its
plain PyTorch version.

``flash_attention`` is the counterpart of
``kubeflow_tpu/ops/flash_attention.py::flash_attention`` (forward only; the
backward kernels come with the training slice).  On a CUDA tensor it
launches ``csrc/flash_fwd.cu`` or raises; on a CPU tensor it runs
``flash_attention_reference``, the same math in plain PyTorch.  Every
launch of the kernel adds one to ``flash_attention.launches``.

Contract (the TPU kernel's, minus its tiling limits): causal masking is
offset by ``sk - sq`` (query i sits at absolute position i + sk - sq);
K/V may carry fewer heads than Q (GQA, read in place, never repeated);
Sq and Sk are any lengths; the output is in the input dtype and the
log-sum-exp per query row is float32 ``[B, H, Sq]``.
"""

from __future__ import annotations

import ctypes
import math

import torch

NEG_INF = -1e30
HEAD_DIMS = (64, 128)          # template instantiations of the kernel
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k, v must be [B, S, H, D]")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "disagree on batch or head_dim")
    if h % k.shape[2]:
        raise ValueError(f"{h} query heads are not a multiple of "
                         f"{k.shape[2]} kv heads")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise ValueError("q, k, v must share one dtype, float32 or bfloat16")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")


def flash_attention_reference(q, k, v, *, causal: bool = False):
    """Plain PyTorch forward with the kernel's math: float32 scores, the
    -1e30 mask, softmax probabilities kept in float32 through the PV
    product.  Returns ``(O, lse)``."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    # grouped: [B, Hkv, G, Sq, D] against [B, Hkv, 1, Sk, D]
    qf = q.float().reshape(b, sq, hkv, g, d).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    s = (qf * (1.0 / math.sqrt(d))) @ kf.transpose(-1, -2)
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        kpos = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = (p @ vf) / l                                   # [B, Hkv, G, Sq, D]
    lse = (m + torch.log(l))[..., 0].reshape(b, h, sq)
    o = o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)
    return o, lse


def _kernel():
    from kubeflow_tpu_torch.ops import _build

    lib = _build.load("flash_fwd")
    fn = lib.kf_flash_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                          ctypes.c_void_p])
    return fn


def _launch(q, k, v, causal: bool):
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernel has no head_dim {d} "
                         f"(built for {HEAD_DIMS})")
    if sq == 0 or sk == 0:
        raise ValueError("flash kernel needs Sq > 0 and Sk > 0")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must have a unit innermost stride")
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 12)(*(
        s for t in (q, k, v, o) for s in t.stride()[:3]))
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), _DTYPE_CODE[q.dtype], b, sq, sk, h, hkv, d,
                 ctypes.cast(strides, ctypes.c_void_p), 1.0 / math.sqrt(d),
                 int(causal), stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: cudaError {err}")
    flash_attention.launches += 1
    return o, lse


def flash_attention_with_lse(q, k, v, *, causal: bool = False):
    """``(O, lse)``: O [B, Sq, H, D] in the input dtype, lse float32
    [B, H, Sq] (what the backward kernels and ring attention consume)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for device {q.device}")
    return _launch(q, k, v, causal)


def flash_attention(q, k, v, *, causal: bool = False) -> torch.Tensor:
    """Flash attention over [B, S, H, D]; returns O only."""
    return flash_attention_with_lse(q, k, v, causal=causal)[0]


flash_attention.launches = 0
