"""Arithmetic of the reference: float64 (or float32) with TF32 off, and the
two lower precisions that the controls put in the program's place.

* ``tf32``: every matrix product's operands rounded to TF32 (10 mantissa
  bits, round to nearest even), the products accumulated in float32: the
  step below a float32 configuration.
* ``fp8``: every matrix product's operands scaled by their absolute maximum
  to e4m3's range (448), rounded to float8 e4m3 and scaled back: the step
  below a bfloat16 configuration, as a per-tensor-scaled fp8 path computes.

The rounding is written out on the operands, so a control reads the same on
the CPU as on the card. Gradients pass the rounding unchanged (straight
through), so a control's backward runs at the reference's dtype on rounded
forward operands.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.nn import functional as F

E4M3_MAX = 448.0


@dataclasses.dataclass(frozen=True)
class Precision:
    dtype: torch.dtype = torch.float64
    #: "" (none), "tf32" or "fp8": the operand rounding of every linear layer
    rounding: str = ""


EXACT = Precision(torch.float64)
#: the control of each configuration's precision: the next step below it
CONTROL = {"f32": Precision(torch.float32, "tf32"), "bf16": Precision(torch.bfloat16, "fp8")}


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to 10 mantissa bits, to nearest even."""
    bits = x.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0x0FFF + lsb) & ~0x1FFF
    finite = torch.isfinite(x)
    return torch.where(finite, rounded.view(torch.float32), x.float()).to(x.dtype)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` scaled to e4m3's range by its absolute maximum, rounded to
    float8 e4m3, scaled back."""
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    return ((x / scale).to(torch.float8_e4m3fn).to(x.dtype)) * scale


def _straight_through(x: torch.Tensor, rounded: torch.Tensor) -> torch.Tensor:
    return x + (rounded - x).detach()


def operand(x: torch.Tensor, prec: Precision) -> torch.Tensor:
    if prec.rounding == "tf32":
        return _straight_through(x, round_tf32(x))
    if prec.rounding == "fp8":
        return _straight_through(x, round_fp8(x))
    if prec.rounding:
        msg = f"unknown rounding {prec.rounding!r}"
        raise ValueError(msg)
    return x


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, prec: Precision) -> torch.Tensor:
    """``x @ w.T + b`` with ``w`` in PyTorch's ``[out, in]`` layout."""
    return F.linear(operand(x, prec), operand(w, prec), b)


@contextlib.contextmanager
def no_tf32():
    """TF32 off for every matrix product on the card inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
