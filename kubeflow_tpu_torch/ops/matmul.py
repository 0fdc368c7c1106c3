"""Matrix products with float32 accumulation and a float32 result.

The reference asks XLA for ``preferred_element_type=float32`` on products
of bf16 operands (attention scores, the tied LM head): exact products,
float32 sums, float32 output.  ``a.float() @ b.float()`` computes that
function but writes float32 copies of both operands first; on CUDA,
16-bit operands go to cuBLAS with ``out_dtype=float32`` instead, which
reads them as they are.  Plain PyTorch, not a kernel of the port.
"""

from __future__ import annotations

import torch

_HALF = (torch.bfloat16, torch.float16)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for 2-D or 3-D (batched) operands, float32 result."""
    if a.is_cuda and a.dtype == b.dtype and a.dtype in _HALF:
        fn = torch.mm if a.ndim == 2 else torch.bmm
        return fn(a, b, torch.float32)
    return a.float() @ b.float()
