"""TF32 for the reference: the control's precision.

:class:`TF32` is a torch function mode under which every float32 matrix
product (``matmul``, ``@``, ``mm``, ``bmm``, ``einsum``, ...) takes its
operands rounded to TF32 (10 explicit mantissa bits, round to nearest even)
and accumulates in float32, as the card's tensor cores do with
``torch.backends.cuda.matmul.allow_tf32`` on.  Rounding the operands
explicitly makes the control the same on every device and for products so
small that cuBLAS would not pick a tensor-core kernel."""

from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode

_PRODUCTS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__,
             torch.Tensor.__rmatmul__, torch.mm, torch.Tensor.mm, torch.bmm,
             torch.Tensor.bmm, torch.einsum, torch.mv, torch.Tensor.mv,
             torch.tensordot, torch.inner, torch.baddbmm, torch.addmm}


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to the nearest TF32 value (ties to even)."""
    bits = x.view(torch.int32)
    low = bits & 0x1FFF
    keep = bits & ~0x1FFF
    up = (low > 0x1000) | ((low == 0x1000) & ((bits & 0x2000) != 0))
    out = torch.where(up, keep + 0x2000, keep).view(torch.float32)
    return torch.where(torch.isfinite(x), out, x)


def _round(a):
    if isinstance(a, torch.Tensor) and a.dtype == torch.float32:
        return to_tf32(a)
    if isinstance(a, (list, tuple)):
        return type(a)(_round(x) for x in a)
    return a


class TF32(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS:
            args = tuple(_round(a) for a in args)
        return func(*args, **kwargs)
