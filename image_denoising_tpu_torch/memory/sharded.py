"""Memory bank sharded over a device mesh, and its exact top-1 retrieval
(counterpart of ``image_denoising_tpu/memory/sharded.py``).

At the production stride of 4 (``eval_704_iqsl_memory.sh:38``) the float32
(noise, clean) bank is about 13.8 GB. ``shard_bank`` splits both banks and
the norms into one contiguous shard of rows per mesh entry, so each card
holds 1/k of them.

``make_ring_retrieval`` keeps the JAX name and signature, but not the JAX
dataflow. JAX rotates the shards around a ring of devices (``ppermute``,
k − 1 moves of up to 6.9 GB per call) while each device keeps its queries.
One controller can do the cheaper thing: it moves the queries, B × D
elements (a few MB), to every shard. Each shard's device runs the retrieval
kernel (``memory/retrieval.py::top1_l2_keys``, one launch per shard) on the
whole query batch. The low word of each key becomes the global row
(``owner · n_local + local``), an elementwise minimum over the k key tensors
picks the winner, and its clean patch is gathered from the owning shard.
The key orders (distance, global row) as JAX's ring compares them
(``sharded.py:132-136``), so the result is the global first minimum, in any
shard order, and equals the unsharded retrieval's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import torch

from ..parallel.mesh import Mesh
from .bank import MemoryBank
from .retrieval import KEY_ROW_MASK, _worst, retrieval_queries, top1_l2_keys

__all__ = ["ShardedBank", "shard_bank", "make_ring_retrieval"]

# a shard's row count is a multiple of this, so each shard of the float32 /
# int32 norms starts 16-byte aligned, as the retrieval kernel needs
_SHARD_ROWS = 4


@dataclass
class ShardedBank:
    """A ``MemoryBank`` split over a mesh: ``noise_flat``, ``clean`` and
    ``sq_norms`` are tuples of per-entry shards of ``n_local`` rows each,
    shard i on ``mesh.devices[i]``. Rows past the bank's end carry the
    worst norm (+inf, or INT32_MAX for int8 banks) and zero patches."""

    noise_flat: Tuple[torch.Tensor, ...]
    clean: Tuple[torch.Tensor, ...]
    sq_norms: Tuple[torch.Tensor, ...]
    patch_size: int
    stride: int
    n_rows: int  # rows of the bank before padding
    mesh: Mesh

    @property
    def n_local(self) -> int:
        return int(self.noise_flat[0].shape[0])

    @property
    def size(self) -> int:
        return self.n_local * self.mesh.size


def _shard(t, lo, hi, n_local, fill, device, view):
    """Rows [lo, hi) of ``t`` padded with ``fill`` to ``n_local`` rows, on
    ``device``: a view of ``t`` where ``view`` allows it, nothing is padded
    and the device is ``t``'s own."""
    part = t[lo:hi]
    pad = n_local - part.shape[0]
    if pad:
        part = torch.cat([part, part.new_full((pad,) + tuple(t.shape[1:]), fill)])
    elif not view and torch.device(device) == t.device:
        part = part.clone()
    return part.to(device)


def shard_bank(bank: MemoryBank, mesh: Mesh, axis_name: str = "data") -> ShardedBank:
    """Split ``bank`` over ``mesh``: ``n_local`` = ceil(N / k) rounded up to
    a multiple of 4 rows per entry. On a mesh of one repeated device the
    shards whose rows all lie in the bank are views of it, and only the
    shards that reach past its end are padded copies: one bank's memory in
    all. Over several devices every shard is its own copy, so the caller's
    bank can be freed and each card keeps 1/k. ``axis_name`` is the JAX
    signature's; the port's mesh has one axis."""
    del axis_name
    k, n = mesh.size, bank.size
    view = len(mesh.distinct()) == 1
    n_local = -(-n // k)
    n_local += (-n_local) % _SHARD_ROWS
    worst = _worst(bank.sq_norms.dtype)
    shards = {"noise": [], "clean": [], "norms": []}
    for i, dev in enumerate(mesh.devices):
        lo, hi = min(i * n_local, n), min((i + 1) * n_local, n)
        shards["noise"].append(_shard(bank.noise_flat, lo, hi, n_local, 0, dev, view))
        shards["clean"].append(_shard(bank.clean, lo, hi, n_local, 0, dev, view))
        shards["norms"].append(_shard(bank.sq_norms, lo, hi, n_local, worst, dev, view))
    return ShardedBank(tuple(shards["noise"]), tuple(shards["clean"]),
                       tuple(shards["norms"]), bank.patch_size, bank.stride, n, mesh)


def make_ring_retrieval(mesh: Mesh, axis_name: str = "data",
                        queries_sharded: bool = True) -> Callable:
    """``retrieval_fn(noisy, bank_noise_flat, bank_clean, sq_norms)`` over
    the shards of a ``ShardedBank`` (tuples, one shard per mesh entry):
    the retrieved clean patches [B, P, P, C] float32 of the query patches
    [B, P, P, C], on the queries' device. A drop-in for
    ``adapters.wrappers.select_memory_patch`` in
    ``DenoiserWithMemoryAdapter(retrieval_fn=)`` and
    ``batched_select_memory_patch(retrieval_fn=)``.

    ``queries_sharded`` and ``axis_name`` keep the JAX signature. JAX's ring
    needs the query batch split over the mesh (True, the tiled evaluators)
    or replicated (False, the finetuner); here every shard scores the whole
    query batch in either case, so the result does not depend on them.
    """
    del axis_name, queries_sharded

    def retrieval_fn(noisy, bank_noise_flat, bank_clean, sq_norms):
        from ..adapters.wrappers import _clean01

        if len(bank_noise_flat) != mesh.size:
            raise ValueError(f"{len(bank_noise_flat)} shards for a mesh of "
                             f"{mesh.size}: shard the bank with shard_bank")
        home = noisy.device
        q, _ = retrieval_queries(noisy, bank_noise_flat[0].dtype)
        n_local = bank_noise_flat[0].shape[0]
        # every copy of the queries before any launch: a copy runs on its
        # source's stream, where it would wait behind the first shard's scan
        q_on = {nb.device: q.to(nb.device) for nb in bank_noise_flat}
        best = None
        for s, (nb, nrm) in enumerate(zip(bank_noise_flat, sq_norms)):
            keys = top1_l2_keys(q_on[nb.device], nb, nrm) + s * n_local
            keys = keys.to(home)
            best = keys if best is None else torch.minimum(best, keys)
        row = best & KEY_ROW_MASK
        owner = torch.div(row, n_local, rounding_mode="floor")
        local = row - owner * n_local
        out = None
        for s, clean in enumerate(bank_clean):
            mine = owner == s
            cand = clean[local.to(clean.device)].to(home)
            if out is None:
                out = cand
            else:
                out = torch.where(mine.view((-1,) + (1,) * (cand.dim() - 1)),
                                  cand, out)
        return _clean01(out)

    return retrieval_fn
