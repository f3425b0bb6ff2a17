"""GroupNorm over NHWC activations: a CUDA kernel pair and its plain version.

The JAX package has no kernel for this: XLA fuses GroupNorm with the ops
around it. The serving forward's ResBlock tail
(``models/fused_forward.py::_res_tail``) runs it here as two kernels of
``csrc/group_norm.cu``, which exist to move fewer bytes than the plain ops:

* ``gn_stats(x, groups)``: x NHWC ``[N, H, W, C]`` → (mean, rstd), float32
  ``[N, G]``: each sample's and group's mean over H·W·C/G values and
  1/sqrt(var + eps), with the biased variance of ``F.group_norm``.
* ``gn_apply(x, mean, rstd, gamma, beta, act=True | residual=r)``:
  ``y = x·a + b`` in float32 (a = rstd·γ, b = β − a·mean), rounded to x's
  dtype, then LeakyReLU(0.2) (``act``) or ``r + y`` (``residual``), each
  rounded to x's dtype as the plain ops on x's dtype round. NHWC out.

On a CPU tensor each takes its plain version (``gn_stats_reference``,
``gn_apply_reference``); on a CUDA tensor it launches the kernel on the
current stream or raises: there is no fallback. ``gn_stats.launches`` and
``gn_apply.launches`` count the calls that ran a kernel. ``gn_plan`` sizes
both grids from N·H·W: contiguous runs of pixels of one sample, between one
block and four for each of the card's 132 SMs, in one wave.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

__all__ = ["GnPlan", "gn_apply", "gn_apply_reference", "gn_plan", "gn_stats", "gn_stats_reference"]

EPS = 1e-5
LEAKY_SLOPE = 0.2
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 256  # a block: rows of C / vec lanes (csrc/group_norm.cu's kThreads)
MAX_C = 2048  # channels its shared-memory partials hold (kMaxC)
SMS = 132  # streaming multiprocessors of an H100
GRID_BLOCKS = 4 * SMS  # one wave: four blocks on each SM
ROW_PIXELS = 16  # pixels a block row is given where the grid allows: fewer
# blocks mean fewer partials for the statistics' last block to merge


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class GnPlan(NamedTuple):
    vec: int
    rows: int
    per_sample: int
    pixels: int
    blocks: int


@functools.lru_cache(maxsize=256)
def gn_plan(n: int, p: int, c: int, dtype: torch.dtype, aligned: bool = True) -> GnPlan:
    """How both kernels launch on ``n`` samples of ``p`` pixels of ``c``
    channels: ``vec`` channels a thread moves at once (16 bytes, or 1 where
    ``c`` is no multiple of that or a tensor is not 16-byte ``aligned``),
    ``rows`` of ``c / vec`` lanes a block, ``per_sample`` blocks of
    ``pixels`` contiguous pixels each, ``blocks`` in all: ``ROW_PIXELS`` a
    row, but one wave of at most ``GRID_BLOCKS`` and at least one block a
    SM (or one a pixel, where there are fewer pixels).
    Kept per shape: the forward asks at every call."""
    vec = 16 // dtype.itemsize
    if not aligned or c % vec:
        vec = 1
    if c > MAX_C or c // vec > THREADS:
        raise ValueError(f"GroupNorm kernels take at most {MAX_C} channels, {THREADS} "
                         f"unless 16-byte vectors fit; got {c} ({dtype})")
    rows = THREADS // (c // vec)
    fewest = _cdiv(p, max(1, GRID_BLOCKS // n))  # at most one wave
    most = max(1, p // _cdiv(SMS, n))  # a block on every SM
    pixels = max(fewest, min(rows * ROW_PIXELS, most))
    per_sample = _cdiv(p, pixels)
    return GnPlan(vec, rows, per_sample, pixels, n * per_sample)


def _check(x, groups: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC [N,H,W,C]; got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"GroupNorm kernels take float32 or bfloat16; got {x.dtype}")
    if groups <= 0 or x.shape[-1] % groups:
        raise ValueError(f"{x.shape[-1]} channels do not split into {groups} groups")


def _device(x) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"GroupNorm kernels run on CUDA or CPU, not {x.device}")
    return x.device.type


def gn_stats_reference(x, groups: int, eps: float = EPS):
    """Plain PyTorch version of ``gn_stats``: float32 statistics."""
    n, h, w, c = x.shape
    var, mean = torch.var_mean(x.float().reshape(n, h * w, groups, c // groups),
                               dim=(1, 3), correction=0)
    return mean, (var + eps).rsqrt()


def gn_apply_reference(x, mean, rstd, gamma, beta, *, act: bool = False, residual=None):
    """Plain PyTorch version of ``gn_apply``: the affine in float32, then
    the epilogue on x's dtype."""
    c = x.shape[-1]
    per = c // mean.shape[1]
    a = rstd.repeat_interleave(per, 1) * gamma.float()
    b = beta.float() - a * mean.repeat_interleave(per, 1)
    y = (x.float() * a[:, None, None] + b[:, None, None]).to(x.dtype)
    return F.leaky_relu(y, LEAKY_SLOPE) if act else residual + y


_TICKETS: dict = {}  # (device, stream) -> int32 tickets, all 0 between launches


def _tickets(device, stream: int, n: int):
    """The stats kernel's per-sample tickets on ``stream``: zeros, which the
    kernel leaves zero, so launches in stream order share them."""
    key = (device, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = _TICKETS[key] = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
    return t


def _nhwc_cuda(x) -> None:
    if not x.is_contiguous():
        raise ValueError("GroupNorm kernels need a contiguous NHWC x "
                         "(a channels_last NCHW tensor, permuted)")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"too many elements for one launch: {tuple(x.shape)}")


def _launch_error(name: str, err: int, x) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"(shape {tuple(x.shape)}, {x.dtype})")


def _gn_stats_cuda(x, groups: int, eps: float):
    from ._build import load_group_norm

    _nhwc_cuda(x)
    n, h, w, c = x.shape
    plan = gn_plan(n, h * w, c, x.dtype, x.data_ptr() % 16 == 0)
    ws = torch.empty(plan.blocks * 2 * c, dtype=torch.float32, device=x.device)
    mean = torch.empty((n, groups), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        tickets = _tickets(x.device, stream, n)
        err = load_group_norm().idt_gn_stats(
            _DTYPE_CODE[x.dtype], plan.vec, x.data_ptr(), n, h * w, c, groups, eps,
            plan.per_sample, plan.pixels, ws.data_ptr(), tickets.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), ctypes.c_void_p(stream))
    _launch_error("gn_stats", err, x)
    gn_stats.launches += 1
    return mean, rstd


def _gn_apply_cuda(x, mean, rstd, gamma, beta, residual):
    from ._build import load_group_norm

    _nhwc_cuda(x)
    n, h, w, c = x.shape
    groups = mean.shape[1]
    for name, t, shape in (("mean", mean, (n, groups)), ("rstd", rstd, (n, groups)),
                           ("gamma", gamma, (c,)), ("beta", beta, (c,))):
        if (t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous()
                or t.device != x.device):
            raise ValueError(f"{name} must be contiguous float32 {shape} on {x.device}; "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if residual is not None and (residual.shape != x.shape or residual.dtype != x.dtype
                                 or residual.device != x.device
                                 or not residual.is_contiguous()):
        raise ValueError(f"residual must be a contiguous {x.dtype} {tuple(x.shape)} "
                         f"on {x.device}")
    out = torch.empty_like(x)
    ptrs = [x.data_ptr(), out.data_ptr()] + ([residual.data_ptr()] if residual is not None
                                             else [])
    plan = gn_plan(n, h * w, c, x.dtype, all(p % 16 == 0 for p in ptrs))
    with torch.cuda.device(x.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
        err = load_group_norm().idt_gn_apply(
            _DTYPE_CODE[x.dtype], plan.vec, x.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            residual.data_ptr() if residual is not None else None, out.data_ptr(),
            n, h * w, c, groups, plan.per_sample, plan.pixels, stream)
    _launch_error("gn_apply", err, x)
    gn_apply.launches += 1
    return out


def gn_stats(x, groups: int, eps: float = EPS):
    """x: NHWC ``[N, H, W, C]``, float32 or bfloat16, C a multiple of
    ``groups``. Returns (mean, rstd), float32 ``[N, groups]``. A CPU tensor
    takes ``gn_stats_reference``; a CUDA tensor runs the kernel or raises."""
    _check(x, groups)
    if _device(x) == "cpu":
        return gn_stats_reference(x, groups, eps)
    return _gn_stats_cuda(x, groups, eps)


def gn_apply(x, mean, rstd, gamma, beta, *, act: bool = False, residual=None):
    """GroupNorm's affine with one epilogue: LeakyReLU(0.2) (``act=True``)
    or ``residual + y`` (``residual``: NHWC like x). x: NHWC as for
    ``gn_stats``; mean, rstd: its result; gamma, beta: float32 ``[C]``.
    Returns NHWC in x's dtype. A CPU tensor takes ``gn_apply_reference``; a
    CUDA tensor runs the kernel or raises."""
    _check(x, mean.shape[1])
    if act == (residual is not None):
        raise ValueError("gn_apply takes one epilogue: act=True or a residual")
    if _device(x) == "cpu":
        return gn_apply_reference(x, mean, rstd, gamma, beta, act=act, residual=residual)
    return _gn_apply_cuda(x, mean, rstd, gamma, beta, residual)


gn_stats.launches = 0
gn_apply.launches = 0
