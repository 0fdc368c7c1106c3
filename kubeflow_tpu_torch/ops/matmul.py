"""Matrix products with float32 accumulation and a float32 result.

The reference asks XLA for ``preferred_element_type=float32`` on products
of bf16 operands (attention scores, the tied LM head): exact products,
float32 sums, float32 output.  ``a.float() @ b.float()`` computes that
function but writes float32 copies of both operands first; on CUDA,
16-bit operands go to cuBLAS with ``out_dtype=float32`` instead, which
reads them as they are.  Plain PyTorch, not a kernel of the port.

The gradient is the reference's transpose of that product (what
``jax.grad`` gives): the float32 cotangent times the other operand upcast
to float32, float32 sums, rounded to the operand's dtype.  The
``out_dtype`` overload of ``torch.mm`` has no established autograd rule, so
``matmul_f32`` is a ``torch.autograd.Function`` that states it.
"""

from __future__ import annotations

import torch

_HALF = (torch.bfloat16, torch.float16)


def _product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.is_cuda and a.dtype == b.dtype and a.dtype in _HALF:
        fn = torch.mm if a.ndim == 2 else torch.bmm
        return fn(a, b, torch.float32)
    return a.float() @ b.float()


class _MatmulF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _product(a, b)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.float()
        da = db = None
        if ctx.needs_input_grad[0]:
            da = (g @ b.float().transpose(-1, -2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = (a.float().transpose(-1, -2) @ g).to(b.dtype)
        return da, db


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for 2-D or 3-D (batched) operands, float32 result;
    differentiable in both operands."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _MatmulF32.apply(a, b)
    return _product(a, b)
