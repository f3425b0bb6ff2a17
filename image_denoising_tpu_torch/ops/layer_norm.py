"""Restormer's residual add and BiasFree LayerNorm over NHWC activations: a
CUDA kernel and its plain version.

The JAX package has no Restormer, so this replaces no TPU kernel. The served
Restormer forward (``models/restormer.py``) runs each of its blocks' adds and
norms here as one kernel of ``csrc/add_layer_norm.cu``, which exists to move
fewer bytes than the plain ops:

* ``add_ln(x, w, residual=None)`` → (s, y): x and the residual NHWC
  ``[N, H, W, C]``, float32 or bfloat16, w float32 ``[C]``. ``s = x +
  residual`` rounded to x's dtype as PyTorch's add on that dtype rounds (s
  is x without a residual); ``y = s / sqrt(Var_c(s) + eps) · w`` in float32
  from the rounded s, the variance biased and centred, the numerator not
  centred, rounded once to x's dtype. Both NHWC out.

On a CPU tensor it takes its plain version (``add_ln_reference``); on a CUDA
tensor it launches the kernel on the current stream or raises: there is no
fallback. ``add_ln.launches`` counts the calls that ran a kernel, and
each adds 1 to the program counter ``restormer.add_ln`` while a profiler
records (``utils/profiling.py``). ``add_ln_plan`` picks the kernel's
vectors, lanes and blocks from C and N·H·W, and the kernel takes them as
they are.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..utils.profiling import count

__all__ = ["AddLnPlan", "add_ln", "add_ln_plan", "add_ln_reference"]

EPS = 1e-5
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 256  # a block (csrc/add_layer_norm.cu's kThreads)
VECTORS = (1, 2, 3, 4)  # 16-byte vectors a lane may hold (the kernel's instances)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class AddLnPlan(NamedTuple):
    vectors: int  # 16-byte vectors a lane holds; 0: one value a lane
    lanes: int  # lanes a pixel
    blocks: int


@functools.lru_cache(maxsize=256)
def add_ln_plan(p: int, c: int, dtype: torch.dtype, aligned: bool = True) -> AddLnPlan:
    """How the kernel launches on ``p`` pixels of ``c`` channels: a pixel
    is ``lanes`` lanes of one warp (a power of two, at most 32), each holding
    ``vectors`` 16-byte vectors, the fewest of ``VECTORS`` that allow it;
    where none does, or a tensor is not 16-byte ``aligned``, a warp a pixel
    and one value a lane. ``blocks``: enough to give every pixel its lanes
    (the kernel launches at most one wave of them). Kept per shape: the
    forward asks at every call."""
    vec = 16 // dtype.itemsize
    vectors, lanes = 0, 32
    if aligned and c % vec == 0:
        for k in VECTORS:
            g = c // vec // k
            if c // vec % k == 0 and g <= 32 and g & (g - 1) == 0:
                vectors, lanes = k, g
                break
    return AddLnPlan(vectors, lanes, _cdiv(p, THREADS // lanes))


def add_ln_reference(x, w, residual=None, eps: float = EPS):
    """Plain PyTorch version of ``add_ln``: the add on x's dtype, the norm in
    float32 over the last dimension (any strides)."""
    s = x if residual is None else x + residual
    z = s.float()
    var = z.var(-1, keepdim=True, unbiased=False)
    return s, (z / torch.sqrt(var + eps) * w.float()).to(x.dtype)


def _check(x, w, residual) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC [N,H,W,C]; got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"add_ln takes float32 or bfloat16; got {x.dtype}")
    if tuple(w.shape) != (x.shape[-1],):
        raise ValueError(f"w must be [{x.shape[-1]}]; got {tuple(w.shape)}")
    if residual is not None and (residual.shape != x.shape or residual.dtype != x.dtype
                                 or residual.device != x.device):
        raise ValueError(f"residual must be a {x.dtype} {tuple(x.shape)} on {x.device}; got "
                         f"{residual.dtype} {tuple(residual.shape)} on {residual.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"add_ln runs on CUDA or CPU, not {x.device}")


def _add_ln_cuda(x, w, residual, eps: float):
    from ._build import load_add_layer_norm

    for name, t in (("x", x), ("residual", residual)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"add_ln needs a contiguous NHWC {name} "
                             "(a channels_last NCHW tensor, permuted)")
    if w.dtype != torch.float32 or not w.is_contiguous() or w.device != x.device:
        raise ValueError(f"w must be contiguous float32 on {x.device}; "
                         f"got {w.dtype} on {w.device}")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"too many elements for one launch: {tuple(x.shape)}")
    y = torch.empty_like(x)
    s = x if residual is None else torch.empty_like(x)
    ptrs = [t.data_ptr() for t in (x, residual, s, y) if t is not None]
    n, h, wd, c = x.shape
    plan = add_ln_plan(n * h * wd, c, x.dtype, all(p % 16 == 0 for p in ptrs))
    with torch.cuda.device(x.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
        err = load_add_layer_norm().idt_add_ln(
            _DTYPE_CODE[x.dtype], plan.vectors, plan.lanes, x.data_ptr(),
            residual.data_ptr() if residual is not None else None, w.data_ptr(),
            s.data_ptr() if residual is not None else None, y.data_ptr(),
            n * h * wd, c, eps, plan.blocks, stream)
    if err != 0:
        raise RuntimeError(f"add_ln kernel launch failed: CUDA error {err} "
                           f"(shape {tuple(x.shape)}, {x.dtype})")
    add_ln.launches += 1
    count("restormer.add_ln")
    return s, y


def add_ln(x, w, residual=None, eps: float = EPS):
    """(s, y): s = x + ``residual`` (x without one), y its BiasFree
    LayerNorm over the channels scaled by ``w``; x and the residual NHWC
    ``[N, H, W, C]``, float32 or bfloat16, w float32 ``[C]``; both results
    NHWC in x's dtype. A CPU tensor takes ``add_ln_reference``; a CUDA
    tensor runs the kernel or raises."""
    _check(x, w, residual)
    if x.device.type == "cpu":
        return add_ln_reference(x, w, residual, eps)
    return _add_ln_cuda(x, w, residual, eps)


add_ln.launches = 0
