"""The precisions the reference computes its convolutions in.

``float32`` is the reference itself, run with TF32 off (``exact_float32``
sets both flags and restores them). The others are the controls: the
reference put in the program's place one step below the precision the
configuration states, which a comparison has to fail.

* ``tf32``: each operand rounded to TF32 (10-bit mantissa, to nearest),
  the products summed in float32, as the tensor cores' TF32 route does.
* ``bfloat16``: the convolution computed in bfloat16 (autograd flows).
* ``fp8``: each operand scaled by its own largest magnitude onto
  float8 e4m3's range, rounded to it and scaled back, the sums in float32.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

PRECISIONS = ("float32", "tf32", "bfloat16", "fp8")
FP8_MAX = 448.0


@contextlib.contextmanager
def exact_float32():
    """TF32 off for cuDNN and matmul inside the block; both flags restored."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def round_tf32(t):
    """float32 → the nearest TF32 value (ties away from zero), as float32."""
    bits = t.detach().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def round_fp8(t):
    """Per-tensor scaled float8 e4m3 round trip."""
    t = t.detach()
    scale = FP8_MAX / t.abs().amax().clamp(min=1e-30)
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


def conv_fn(precision: str):
    """``conv(x, weight, bias, padding)`` computing in ``precision``."""
    if precision == "float32":
        return None
    if precision == "bfloat16":
        def conv(x, w, b, p):
            b16 = None if b is None else b.bfloat16()
            return F.conv2d(x.bfloat16(), w.bfloat16(), b16, padding=p).float()
        return conv
    rnd = {"tf32": round_tf32, "fp8": round_fp8}[precision]

    def conv(x, w, b, p):
        return F.conv2d(rnd(x), rnd(w), b, padding=p)
    return conv
