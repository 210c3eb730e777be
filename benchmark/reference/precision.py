"""The control's precision: TF32, the one below the configurations' float32
with TF32 off.

On the card a TF32 matrix product rounds both operands to TF32 (a float32
with a 10-bit mantissa) and accumulates in float32. ``tf32()`` computes
every matrix product of the reference so, on any device: inside it, the
float32 operands of torch's matrix products and einsums are rounded to the
nearest TF32 value (ties to even) before the product.
"""

from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode

_PRODUCTS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__,
             torch.Tensor.__rmatmul__, torch.bmm, torch.mm, torch.Tensor.bmm,
             torch.Tensor.mm, torch.einsum, torch.mv, torch.Tensor.mv,
             torch.baddbmm, torch.addmm}


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), as float32."""
    if not (torch.is_tensor(x) and x.dtype == torch.float32):
        return x
    i = x.contiguous().view(torch.int32)
    keep = 13                                   # 23 - 10 mantissa bits
    half = (1 << (keep - 1)) - 1 + ((i >> keep) & 1)
    r = ((i + half) >> keep) << keep
    finite = torch.isfinite(x)
    return torch.where(finite, r.view(torch.float32), x)


class tf32(TorchFunctionMode):
    """Inside this mode every float32 matrix product rounds its operands to
    TF32 first."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS:
            args = tuple(round_tf32(a) if torch.is_tensor(a) else
                         [round_tf32(t) for t in a] if isinstance(a, list)
                         else a for a in args)
        return func(*args, **kwargs)
