"""The precisions the reference computes in.

``REFERENCE`` computes everything in float64: the yardstick. ``CONTROL`` is
the reference one step below what each configuration states, the step that
would tempt a later change: its float32 products in TF32 (the operands
rounded to TF32's 10-bit mantissa, then an fp32 product with fp32
accumulation, as the tensor cores do), everything else in float32. The rounding is written out so
that the control is the same arithmetic on the CPU and on the card.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32, 10 explicit mantissa bits, to nearest
    with ties away from zero (cvt.rna.tf32.f32)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class _TF32Product(torch.autograd.Function):
    """a @ b with both operands rounded to TF32, and so each product of its
    backward, as TF32 tensor cores compute a product and its gradient."""

    @staticmethod
    def forward(ctx, a, b):
        ra, rb = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(ra, rb)
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = round_tf32(g)
        return rg @ rb.T, ra.T @ rg


@dataclass(frozen=True)
class Precision:
    name: str
    dtype: torch.dtype        # of every tensor
    tf32: bool                # float32-stated products through TF32

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """A product the configuration states in float32."""
        if self.tf32:
            return _TF32Product.apply(a, b)
        return a @ b


REFERENCE = Precision("reference", torch.float64, tf32=False)
CONTROL = Precision("control", torch.float32, tf32=True)


@contextlib.contextmanager
def exact_products():
    """No TF32 in any product the reference issues itself."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
