"""Flash attention over [B, S, H, D]: the Hopper kernels and their plain
PyTorch versions, forward and backward.

``flash_attention`` is the counterpart of
``kubeflow_tpu/ops/flash_attention.py::flash_attention``: a
``torch.autograd.Function`` (in place of the reference's
``jax.custom_vjp``) whose forward runs ``flash_attention_with_lse`` and
whose backward runs ``flash_attention_backward``.  On a CUDA tensor each
step launches its kernel or raises: ``csrc/flash_fwd.cu`` (K1) forward,
``csrc/flash_bwd.cu`` (K2 ``flash_bwd_dq`` and K3 ``flash_bwd_dkv``)
backward.  On a CPU tensor each runs its plain version, the same math in
PyTorch (``flash_attention_reference``, ``flash_bwd_dq_reference``,
``flash_bwd_dkv_reference``).  Every kernel launch adds one to its
wrapper's counter: ``flash_attention.launches``,
``flash_bwd_dq.launches``, ``flash_bwd_dkv.launches``.

Contract (the TPU kernels', minus their tiling limits): causal masking is
offset by ``sk - sq`` (query i sits at absolute position i + sk - sq);
K/V may carry fewer heads than Q (GQA, read in place, never repeated; dK
and dV sum over each kv head's query heads); Sq and Sk are any lengths;
outputs and gradients are in the input dtype and the log-sum-exp per
query row is float32 ``[B, H, Sq]``.  Inputs are [B, S, H, D] views with a
unit innermost stride; the bf16 kernels load them with TMA, so a bf16
input on the card must also pass ``_tma_compatible`` (16-byte aligned
base, batch / sequence / head strides that are multiples of 8 elements),
or the wrapper raises ``ValueError`` naming it.
"""

from __future__ import annotations

import ctypes
import math

import torch

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)     # template instantiations of the kernels
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


def _tma_compatible(t: torch.Tensor) -> bool:
    """Whether the bf16 kernels can load ``t`` ([B, S, H, D]) with TMA: a
    bf16 tensor with a unit innermost stride, a 16-byte aligned base, and
    batch / sequence / head strides that are positive multiples of 8
    elements (16 bytes).  The stride of a dimension of size 1 is never
    used and is not checked."""
    if t.dtype != torch.bfloat16 or t.ndim != 4 or t.stride(3) != 1:
        return False
    if t.data_ptr() % 16:
        return False
    return all(n == 1 or (s > 0 and s % 8 == 0)
               for n, s in zip(t.shape[:3], t.stride()[:3]))


def _strides(t: torch.Tensor) -> list[int]:
    """Batch, sequence and head strides of ``t`` as the kernels take them:
    a dimension of size 1 gets its contiguous stride (TMA checks every
    stride, even one that is never stepped)."""
    contiguous = (t.shape[1] * t.shape[2] * t.shape[3],
                  t.shape[2] * t.shape[3], t.shape[3])
    return [s if n > 1 else c
            for n, s, c in zip(t.shape[:3], t.stride()[:3], contiguous)]


def _check_tma(dtype, **tensors) -> None:
    if dtype != torch.bfloat16:
        return
    for name, t in tensors.items():
        if not _tma_compatible(t):
            raise ValueError(
                f"{name} {tuple(t.shape)} with strides {t.stride()} at "
                f"address {t.data_ptr():#x}: the bf16 kernels load it with "
                "TMA, which needs a 16-byte aligned base and batch / "
                "sequence / head strides that are multiples of 8 elements")


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
    _check_tma(q.dtype, q=q, k=k, v=v)
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 12)(*(
        s for t in (q, k, v, o) for s in _strides(t)))
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
    [B, H, Sq] (what the backward kernels and ring attention consume).
    Not differentiable: ``flash_attention`` is."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for device {q.device}")
    return _launch(q, k, v, causal)


# --- backward (K2, K3) ------------------------------------------------------

def _grouped_scores(q, k, v, do, lse, delta, causal: bool):
    """Float32 (Q, K, dO, P, dS) of the plain backward, grouped as the
    forward's plain version: Q/dO [B, Hkv, G, Sq, D], K [B, Hkv, 1, Sk, D],
    P and dS [B, Hkv, G, Sq, Sk].  Scores as ``flash_attention_reference``
    computes them (Q pre-scaled), masked to -1e30 as the reference's
    ``_flash_bwd``; dS carries the scale."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(d)

    def grouped(t):   # [B, S, H, D] -> [B, Hkv, G, S, D]
        return t.float().reshape(b, t.shape[1], hkv, g, d).permute(
            0, 2, 3, 1, 4)

    qf, dof = grouped(q), grouped(do)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    s = (qf * scale) @ kf.transpose(-1, -2)
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        kpos = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, NEG_INF)
    p = torch.exp(s - lse.reshape(b, hkv, g, sq, 1))
    dp = dof @ vf.transpose(-1, -2)
    ds = p * (dp - delta.reshape(b, hkv, g, sq, 1)) * scale
    return qf, kf, dof, p, ds


def _ungroup(t, s: int, heads: int) -> torch.Tensor:
    """[B, Hkv, G|1, S, D] -> [B, S, heads, D]."""
    b, d = t.shape[0], t.shape[-1]
    return t.permute(0, 3, 1, 2, 4).reshape(b, s, heads, d)


def flash_bwd_dq_reference(q, k, v, do, lse, delta, *, causal: bool = False):
    """Plain PyTorch K2: dQ = dS K, float32 sums, in ``q.dtype``."""
    _, kf, _, _, ds = _grouped_scores(q, k, v, do, lse, delta, causal)
    return _ungroup(ds @ kf, q.shape[1], q.shape[2]).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, *,
                            causal: bool = False):
    """Plain PyTorch K3: ``(dK, dV)`` = (dS^T Q, P^T dO), each summed over
    the query heads of its kv head, float32 sums, in the input dtype."""
    qf, _, dof, p, ds = _grouped_scores(q, k, v, do, lse, delta, causal)
    sk, hkv = k.shape[1], k.shape[2]
    dk = (ds.transpose(-1, -2) @ qf).sum(2, keepdim=True)
    dv = (p.transpose(-1, -2) @ dof).sum(2, keepdim=True)
    return (_ungroup(dk, sk, hkv).to(k.dtype),
            _ungroup(dv, sk, hkv).to(v.dtype))


def flash_bwd_delta(o, do) -> torch.Tensor:
    """delta = rowsum(dO o O) in float32, ``[B, H, Sq]`` contiguous: one
    PyTorch reduction, as the reference computes it outside its kernels
    (``flash_attention.py:259-261``)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _bwd_kernel(name: str, n_ptr: int):
    from kubeflow_tpu_torch.ops import _build

    fn = getattr(_build.load("flash_bwd"), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 7
                       + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                          ctypes.c_void_p])
    return fn


def _launch_bwd(name: str, q, k, v, do, lse, delta, outs, causal: bool):
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernel has no head_dim {d} "
                         f"(built for {HEAD_DIMS})")
    if sq == 0 or sk == 0:
        raise ValueError("flash kernel needs Sq > 0 and Sk > 0")
    for tname, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        if t.stride(3) != 1:
            raise ValueError(f"{tname} must have a unit innermost stride")
    for tname, t in (("lse", lse), ("delta", delta)):
        if (t.shape != (b, h, sq) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device
                or t.data_ptr() % 16):
            raise ValueError(f"{tname} must be contiguous float32 "
                             f"[{b}, {h}, {sq}] on {q.device}, 16-byte "
                             "aligned")
    _check_tma(q.dtype, q=q, k=k, v=v, do=do)
    strides = (ctypes.c_int64 * 12)(*(
        s for t in (q, k, v, do) for s in _strides(t)))
    fn = _bwd_kernel(f"kf_{name}", 6 + len(outs))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(),
                 *(t.data_ptr() for t in outs), _DTYPE_CODE[q.dtype], b, sq,
                 sk, h, hkv, d, ctypes.cast(strides, ctypes.c_void_p),
                 1.0 / math.sqrt(d), int(causal), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _check_bwd(q, k, v, do, lse, delta) -> None:
    _check(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"do {tuple(do.shape)} {do.dtype} must match q "
                         f"{tuple(q.shape)} {q.dtype} on {q.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash attention for device {q.device}")


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = False):
    """K2: dQ [B, Sq, H, D] in ``q.dtype`` from the forward's lse and
    ``flash_bwd_delta``."""
    _check_bwd(q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, causal=causal)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bwd("flash_bwd_dq", q, k, v, do, lse, delta, (dq,), causal)
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool = False):
    """K3: ``(dK, dV)``, each [B, Sk, Hkv, D] in the input dtype."""
    _check_bwd(q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                       causal=causal)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch_bwd("flash_bwd_dkv", q, k, v, do, lse, delta, (dk, dv), causal)
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


def cotangent_view(do, dtype) -> torch.Tensor:
    """A cotangent in ``dtype`` that K2 and K3 can read: a view with a unit
    innermost stride and, in bf16 on the card, ``_tma_compatible`` goes in
    as it is, any other is made contiguous."""
    do = do.to(dtype)
    if do.stride(3) != 1 or (do.is_cuda and dtype == torch.bfloat16
                             and not _tma_compatible(do)):
        do = do.contiguous()
    return do


def flash_attention_backward(q, k, v, o, lse, do, *, causal: bool = False):
    """``(dQ, dK, dV)`` of ``flash_attention`` at cotangent ``do``: delta,
    then K2 and K3 (their plain versions on a CPU tensor).  ``do`` is
    taken in the input dtype, as the reference rounds it (:280).  It is
    the cotangent autograd hands over, in whatever layout
    (``cotangent_view``)."""
    do = cotangent_view(do, q.dtype)
    delta = flash_bwd_delta(o, do)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal=causal)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal)
    return dq, dk, dv


def flash_attention_backward_reference(q, k, v, o, lse, do, *,
                                       causal: bool = False):
    """Plain PyTorch backward, the counterpart of the reference's
    ``_flash_bwd`` (:311-359): ``(dQ, dK, dV)``."""
    do = do.to(q.dtype)
    delta = flash_bwd_delta(o, do)
    dq = flash_bwd_dq_reference(q, k, v, do, lse, delta, causal=causal)
    return (dq, *flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                         causal=causal))


class FlashAttentionFunction(torch.autograd.Function):
    """Forward K1, saving q, k, v, O and lse; backward K2 and K3."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_attention_with_lse(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, o, lse, do,
                                              causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, causal: bool = False) -> torch.Tensor:
    """Flash attention over [B, S, H, D]; returns O, differentiable in
    q, k and v."""
    _check(q, k, v)
    return FlashAttentionFunction.apply(q, k, v, causal)


flash_attention.launches = 0
