"""Top-1 L2 retrieval over a memory bank: a CUDA kernel and its plain version.

Counterpart of ``image_denoising_tpu/memory/retrieval_pallas.py``. For
queries ``[B, D]`` against a bank ``[N, D]`` with precomputed squared norms
``[N]`` it returns int32 ``[B]`` = argmin_n (‖b_n‖² − 2 q·b_n), ties to the
first minimum. Three regimes, picked by the bank's dtype:

* float32 bank: float32 queries, float32 accumulation and norms;
* bfloat16 bank: queries cast to bfloat16, float32 accumulation and norms;
* int8 bank (centered bytes, ``build_memory_bank(bank_dtype="int8")``):
  centered-int8 queries (``round(x·255) − 128``), int32 norms, exact int32
  accumulation.

``top1_l2_retrieval`` on a CUDA tensor runs ``csrc/retrieval.cu`` (one
launch on the tensor cores: wgmma bf16, wgmma s8, or 3xTF32 for float32,
fed by TMA; the ``[B, N]`` distance matrix never exists); on a CPU tensor
it runs ``top1_l2_retrieval_reference``. There is no fallback on CUDA.
``top1_l2_retrieval.launches`` counts the calls that ran the kernel.
Unlike the TPU kernel's grid, N need not be a multiple of a tile; rows
padded by ``pad_bank_for_retrieval`` carry the worst norm and never win.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = [
    "pad_bank_for_retrieval",
    "top1_l2_retrieval",
    "top1_l2_retrieval_reference",
]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _worst(dtype):
    """The 'never selected' distance: +inf for floats, INT_MAX for ints."""
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def pad_bank_for_retrieval(bank_flat, bank_sq_norms, tile_n: int = 512):
    """Pad N up to a tile multiple; padded rows get +inf (float) or INT32_MAX
    (int8 banks) norms so they are never chosen."""
    n, d = bank_flat.shape
    n_pad = (-n) % tile_n
    if n_pad == 0:
        return bank_flat, bank_sq_norms
    bank_flat = torch.cat([bank_flat, bank_flat.new_zeros((n_pad, d))])
    bank_sq_norms = torch.cat([
        bank_sq_norms,
        bank_sq_norms.new_full((n_pad,), _worst(bank_sq_norms.dtype))])
    return bank_flat, bank_sq_norms


def _prepare(queries_flat, bank_flat, sq_norms):
    """Check the operands and bring queries and norms to the regime's dtypes."""
    if queries_flat.dim() != 2 or bank_flat.dim() != 2:
        raise ValueError(f"queries [B, D] and bank [N, D] expected; got "
                         f"{tuple(queries_flat.shape)} and {tuple(bank_flat.shape)}")
    (b, d), n = queries_flat.shape, bank_flat.shape[0]
    if bank_flat.shape[1] != d or d % 16:
        raise ValueError(f"D must match and be a multiple of 16; got queries "
                         f"D={d}, bank D={bank_flat.shape[1]}")
    if tuple(sq_norms.shape) != (n,):
        raise ValueError(f"sq_norms must be [{n}]; got {tuple(sq_norms.shape)}")
    if b == 0 or n == 0:
        raise ValueError("need at least one query and one bank row")
    if not (queries_flat.device == bank_flat.device == sq_norms.device):
        raise ValueError("queries, bank and norms must share one device")
    if bank_flat.dtype == torch.int8:
        if queries_flat.dtype != torch.int8:
            raise TypeError(
                "int8 banks need centered-int8 queries (round(x*255)-128); "
                f"got {queries_flat.dtype}")
        if sq_norms.dtype != torch.int32:
            raise TypeError(f"int8 banks need int32 sq_norms; got {sq_norms.dtype}")
        return queries_flat, sq_norms
    if bank_flat.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"bank must be float32, bfloat16 or int8; got "
                        f"{bank_flat.dtype}")
    return queries_flat.to(bank_flat.dtype), sq_norms.to(torch.float32)


def top1_l2_retrieval_reference(queries_flat, bank_flat, sq_norms,
                                chunk: int = 4096):
    """Plain PyTorch version.

    float32 / bfloat16 banks: ``sqn − 2·(q @ bankᵀ)`` in float32, then the
    first ``argmin`` (on a CUDA device the caller keeps
    ``torch.backends.cuda.matmul.allow_tf32`` off). int8 banks: the same in
    float64 over N-chunks of ``chunk`` rows, which is exact
    (|2ab| ≤ 2·D·128² < 2⁵³) and keeps the float64 copy of the bank small.
    """
    q, sqn = _prepare(queries_flat, bank_flat, sq_norms)
    if bank_flat.dtype == torch.int8:
        qd = q.double()
        n = bank_flat.shape[0]
        dists = torch.empty((q.shape[0], n), dtype=torch.float64, device=q.device)
        for s in range(0, n, chunk):
            blk = bank_flat[s : s + chunk].double()
            dists[:, s : s + chunk] = sqn[s : s + chunk].double() - 2.0 * (qd @ blk.T)
        return dists.argmin(dim=1).to(torch.int32)
    ab = q.float() @ bank_flat.float().T
    return (sqn[None, :] - 2.0 * ab).argmin(dim=1).to(torch.int32)


def _top1_cuda(q, bank, sqn):
    from ..ops._build import load_retrieval

    for name, t in (("queries", q), ("bank", bank), ("sq_norms", sqn)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"top1_l2_retrieval needs a contiguous, 16-byte "
                             f"aligned {name} tensor")
    (b, d), n = q.shape, bank.shape[0]
    if max(b, n) >= 2 ** 31:
        raise ValueError(f"B={b} and N={n} must fit in int32")
    lib = load_retrieval()
    keys = torch.empty(b, dtype=torch.int64, device=q.device)
    out = torch.empty(b, dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
        err = lib.idt_top1_l2(_DTYPE_CODE[bank.dtype], q.data_ptr(),
                              bank.data_ptr(), sqn.data_ptr(), b, n, d,
                              keys.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"top1_l2_retrieval kernel launch failed: CUDA error "
                           f"{err} (B={b}, N={n}, D={d}, bank {bank.dtype})")
    top1_l2_retrieval.launches += 1
    return out


def top1_l2_retrieval(queries_flat, bank_flat, sq_norms):
    """queries_flat [B, D], bank_flat [N, D], sq_norms [N] → best index [B]
    int32. D must be a multiple of 16.

    float32 / bfloat16 banks take float queries (cast to the bank dtype
    here) and float32 norms; int8 banks take centered-int8 queries and int32
    norms. A CPU tensor takes ``top1_l2_retrieval_reference``; a CUDA tensor
    runs the kernel or raises.
    """
    if bank_flat.device.type == "cpu":
        return top1_l2_retrieval_reference(queries_flat, bank_flat, sq_norms)
    if bank_flat.device.type != "cuda":
        raise ValueError(f"top1_l2_retrieval runs on CUDA or CPU, not "
                         f"{bank_flat.device}")
    q, sqn = _prepare(queries_flat, bank_flat, sq_norms)
    return _top1_cuda(q.contiguous(), bank_flat, sqn.contiguous())


top1_l2_retrieval.launches = 0
