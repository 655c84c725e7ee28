"""Number formats of the plain reference and of its controls.

A precision is named by a string:

* ``float32``: float32 everywhere, TF32 off for convolutions and matmuls;
* ``tf32``: the same with TF32 on (the control of a float32 configuration);
* ``bfloat16``: the values a low-precision network rounds are rounded to
  bf16, products summed in float32;
* ``fp8``: those values rounded to fp8 (e4m3) with a power-of-two scale per
  tensor, then held in bf16 (the control of a bf16 configuration).

:func:`lowp` is the one rounding step of the low-precision networks.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator

import torch
from torch import Tensor

PRECISIONS = ("float32", "tf32", "bfloat16", "fp8")
#: largest finite value of float8_e4m3fn
FP8_MAX = 448.0


def check(precision: str) -> str:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; have {PRECISIONS}")
    return precision


@contextlib.contextmanager
def tf32(on: bool) -> Iterator[None]:
    """TF32 on or off for cuDNN convolutions and CUDA matmuls; the previous
    settings come back on exit."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


def _fp8_values(t: Tensor) -> Tensor:
    """``t`` rounded to the fp8 e4m3 grid under a power-of-two scale that
    maps its largest magnitude into range; float32."""
    t = t.float()
    amax = float(t.detach().abs().max()) if t.numel() else 0.0
    if amax == 0.0 or not math.isfinite(amax):
        return t
    scale = 2.0 ** math.floor(math.log2(FP8_MAX / amax))
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


def lowp(t: Tensor, precision: str) -> Tensor:
    """Round ``t`` to the working format of a low-precision network, as a
    bf16 tensor. fp8 values are exact in bf16; their rounding passes the
    gradient straight through."""
    if precision == "bfloat16":
        return t.to(torch.bfloat16)
    if precision == "fp8":
        q = _fp8_values(t)
        return (t.float() + (q - t.float()).detach()).to(torch.bfloat16)
    raise ValueError(f"lowp: {precision!r} is not a low precision")
