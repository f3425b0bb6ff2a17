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

``top1_l2_keys`` returns, instead of the index, the 64-bit key the kernel
already computes for the winner: an order-preserving form of the distance
in the high word and the row in the low word (``csrc/retrieval.cu``,
``make_key``), here as int64 whose signed order is the lexicographic order
of (distance, row). Keys from several banks compare directly, which is how
``memory/sharded.py`` merges its shards exactly. It runs the same kernel,
and its launches count in ``top1_l2_retrieval.launches``.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = [
    "KEY_ROW_MASK",
    "pad_bank_for_retrieval",
    "retrieval_queries",
    "top1_l2_keys",
    "top1_l2_keys_reference",
    "top1_l2_retrieval",
    "top1_l2_retrieval_reference",
]

KEY_ROW_MASK = 0xFFFFFFFF  # a key's low word: the bank row

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


def _plain_min(queries_flat, bank_flat, sq_norms, chunk: int = 4096):
    """(least distance, first row reaching it) per query, in the arithmetic
    of ``top1_l2_retrieval_reference``: the distance float32, or int32 for
    int8 banks (exact, clamped to int32 as the kernel's key is)."""
    q, sqn = _prepare(queries_flat, bank_flat, sq_norms)
    if bank_flat.dtype == torch.int8:
        qd = q.double()
        n = bank_flat.shape[0]
        dists = torch.empty((q.shape[0], n), dtype=torch.float64, device=q.device)
        for s in range(0, n, chunk):
            blk = bank_flat[s : s + chunk].double()
            dists[:, s : s + chunk] = sqn[s : s + chunk].double() - 2.0 * (qd @ blk.T)
        idx = dists.argmin(dim=1)
        best = dists.gather(1, idx[:, None])[:, 0]
        info = torch.iinfo(torch.int32)
        return best.clamp(info.min, info.max).to(torch.int32), idx
    ab = q.float() @ bank_flat.float().T
    dists = sqn[None, :] - 2.0 * ab
    idx = dists.argmin(dim=1)
    return dists.gather(1, idx[:, None])[:, 0], idx


def top1_l2_retrieval_reference(queries_flat, bank_flat, sq_norms,
                                chunk: int = 4096):
    """Plain PyTorch version.

    float32 / bfloat16 banks: ``sqn − 2·(q @ bankᵀ)`` in float32, then the
    first ``argmin`` (on a CUDA device the caller keeps
    ``torch.backends.cuda.matmul.allow_tf32`` off). int8 banks: the same in
    float64 over N-chunks of ``chunk`` rows, which is exact
    (|2ab| ≤ 2·D·128² < 2⁵³) and keeps the float64 copy of the bank small.
    """
    return _plain_min(queries_flat, bank_flat, sq_norms, chunk)[1].to(torch.int32)


def _encode_keys(dist, rows):
    """(distance, row) → int64 keys in (distance, row) order: the distance's
    order-preserving int32 (float32: its bits, the magnitude bits flipped
    when negative, -0 taken as +0; int32: itself) times 2³² plus the row.
    The kernel's key with its top bit flipped."""
    if dist.dtype == torch.float32:
        bits = torch.where(dist == 0, torch.zeros_like(dist), dist).view(torch.int32)
        dist = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return dist.long() * (1 << 32) + rows.long()


def top1_l2_keys_reference(queries_flat, bank_flat, sq_norms, chunk: int = 4096):
    """Plain version of ``top1_l2_keys``: the winner's (distance, row) of
    ``top1_l2_retrieval_reference`` as an int64 key."""
    return _encode_keys(*_plain_min(queries_flat, bank_flat, sq_norms, chunk))


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
    return keys, out


def _on_device(queries_flat, bank_flat, sq_norms, what):
    if bank_flat.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or CPU, not {bank_flat.device}")
    q, sqn = _prepare(queries_flat, bank_flat, sq_norms)
    return _top1_cuda(q.contiguous(), bank_flat, sqn.contiguous())


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
    return _on_device(queries_flat, bank_flat, sq_norms, "top1_l2_retrieval")[1]


top1_l2_retrieval.launches = 0


def top1_l2_keys(queries, bank, sq_norms):
    """The winner of ``top1_l2_retrieval`` as an int64 key [B]: signed order
    = (distance, row) order, ``key & KEY_ROW_MASK`` = the row. Same operands
    and regimes; a CPU tensor takes ``top1_l2_keys_reference``, a CUDA
    tensor runs the retrieval kernel (one launch) or raises. Keys of one
    query against different banks compare as their distances do, and on a
    tie the lower row wins."""
    if bank.device.type == "cpu":
        return top1_l2_keys_reference(queries, bank, sq_norms)
    keys = _on_device(queries, bank, sq_norms, "top1_l2_keys")[0]
    return keys ^ torch.iinfo(torch.int64).min  # unsigned order → signed


def retrieval_queries(noisy, bank_dtype, sq_norms=None, bank_flat=None):
    """The query operand of a bank regime from patches in [0, 1] (any
    shape, flattened per patch): centered int8 ``round(x·255) − 128`` for an
    int8 bank (``torch.round`` rounds half to even, as ``jnp.round`` does:
    for uint8-sourced tiles the distances are then exact integers), the
    float patches otherwise. With ``bank_flat`` and no ``sq_norms`` it also
    computes the norms; returns (queries, sq_norms)."""
    flat = noisy.detach().reshape(noisy.shape[0], -1)
    if bank_dtype == torch.int8:
        q = (torch.round(flat * 255.0) - 128.0).to(torch.int8)
        if sq_norms is None and bank_flat is not None:
            bi = bank_flat.int()
            sq_norms = (bi * bi).sum(dim=1, dtype=torch.int32)
        return q, sq_norms
    if sq_norms is None and bank_flat is not None:
        sq_norms = (bank_flat.float() ** 2).sum(dim=1)
    return flat, sq_norms
