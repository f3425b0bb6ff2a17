"""Frozen-base + adapter wrappers and top-1 memory retrieval.

Counterpart of ``image_denoising_tpu/adapters/wrappers.py``:

* ``DenoiserWithAdapter`` (reference ``adapter.py:29-67``): frozen base
  forward, ``OutputAdapter`` refinement.
* ``DenoiserWithMemoryAdapter`` (reference ``finetune_memory.py:1195-1291``):
  frozen base + memory adapter (v1–v5) + top-1 L2 retrieval over a
  (noise, clean) patch bank. The banks are inputs, not parameters.

The base is a callable, NCHW in and out (``models.make_fused_forward`` on
the card, or an ``nn.Module``); its output is detached and cast to float32,
so with a bfloat16 base the adapter computes in float32 on the upcast
``base_out``, as JAX's dtype promotion does. The wrappers and adapters are
NCHW; ``select_memory_patch`` and ``batched_select_memory_patch`` keep the
JAX package's NHWC ``[B, P, P, C]`` patches, whose flattening is the bank's.
Retrieval goes through ``memory/retrieval.py::top1_l2_retrieval``: the
CUDA kernel on the card (in every bank regime), its plain version on the CPU.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from ..memory.retrieval import retrieval_queries, top1_l2_retrieval
from ..parallel.mesh import module_on

__all__ = [
    "DenoiserWithAdapter",
    "DenoiserWithMemoryAdapter",
    "select_memory_patch",
    "batched_select_memory_patch",
]

# uint8 clean banks decode by table, not by a division on the device: the
# table is numpy's correctly rounded float32 k/255, which is what the float32
# bank holds (memory/bank.py), so both stores give the same floats to the bit.
# One copy per device, made at its first use: a training step copies nothing
# from the host
_CLEAN01 = {torch.device("cpu"): torch.from_numpy(
    np.arange(256, dtype=np.float32) / np.float32(255.0))}


def _clean01(mem):
    """uint8-stored clean patches → their exact k/255 floats; floats pass."""
    if mem.dtype == torch.uint8:
        table = _CLEAN01.get(mem.device)
        if table is None:
            table = _CLEAN01[mem.device] = _CLEAN01[torch.device("cpu")].to(mem.device)
        return table[mem.long()]
    return mem


def _frozen_base(base_forward, x):
    """The base's output, float32, outside autograd. A base run under
    ``torch.inference_mode`` (``make_fused_forward``) returns an inference
    tensor, which autograd may not save for the adapter's backward: outside
    inference mode it is cloned into a normal tensor."""
    with torch.no_grad():
        out = base_forward(x).float()
    if out.is_inference() and not torch.is_inference_mode_enabled():
        out = out.clone()
    return out


def select_memory_patch(noisy, memory_noise_flat, memory_clean, sq_norms=None):
    """Top-1 L2 retrieval of the clean bank patch for each query patch.

    noisy: [B, P, P, C] float in [0, 1]; memory_noise_flat: [N, D]
    (D = P·P·C); memory_clean: [N, P, P, C]. Returns [B, P, P, C] float32.

    An int8 bank takes centered-int8 queries ``round(x·255) − 128``
    (``memory/retrieval.py::retrieval_queries``): for uint8-sourced tiles
    the distances are then exact integers.
    """
    q, sq_norms = retrieval_queries(noisy, memory_noise_flat.dtype, sq_norms,
                                    memory_noise_flat)
    idx = top1_l2_retrieval(q, memory_noise_flat, sq_norms)
    return _clean01(memory_clean[idx.long()])


def batched_select_memory_patch(noisy, memory_noise_flat, memory_clean,
                                sq_norms=None, chunk: int = 128,
                                retrieval_fn: Optional[Callable] = None):
    """One retrieval pass over a whole tile stack in chunks of ``chunk``
    queries, the tail chunk zero-padded (the hoisted retrieval of the tiled
    evaluators). Each query's result does not depend on the chunking.
    ``retrieval_fn`` (default ``select_memory_patch``) retrieves each chunk:
    ``memory/sharded.py::make_ring_retrieval`` over a sharded bank."""
    select = retrieval_fn or select_memory_patch
    t = noisy.shape[0]
    if t <= chunk:
        return select(noisy, memory_noise_flat, memory_clean, sq_norms)
    pad = (-t) % chunk
    q = noisy
    if pad:
        q = torch.cat([q, q.new_zeros((pad,) + tuple(q.shape[1:]))])
    mem = [select(q[s : s + chunk], memory_noise_flat, memory_clean, sq_norms)
           for s in range(0, q.shape[0], chunk)]
    return torch.cat(mem)[:t]


def _base_on(base_forward, device):
    """The base's forward for one device: a ``parallel.PerDevice`` base's
    copy there, any other callable as it is."""
    return base_forward.on(device) if hasattr(base_forward, "on") else base_forward


class DenoiserWithAdapter(nn.Module):
    """``adapter(x, base_forward(x))`` with the base frozen (no gradient)."""

    def __init__(self, base_forward: Callable, adapter: nn.Module):
        super().__init__()
        self.base_forward = base_forward
        self.adapter = adapter

    def forward(self, x):
        return self.adapter(x, _frozen_base(self.base_forward, x))

    def replica(self, device):
        """This wrapper on one device of a mesh: the base's forward there and
        ``parallel.module_on(adapter, device)`` (differentiable); itself
        where nothing would change. Build it anew each step."""
        base = _base_on(self.base_forward, device)
        adapter = module_on(self.adapter, device)
        if base is self.base_forward and adapter is self.adapter:
            return self
        return type(self)(base, adapter).train(self.training)


class DenoiserWithMemoryAdapter(nn.Module):
    """Frozen base + memory adapter over NCHW tiles.

    ``forward(noisy, memory_noise_flat, memory_clean, bank_sq_norms)``
    retrieves each tile's clean bank patch; ``mem_clean=`` (NCHW, float or
    uint8) skips retrieval and uses the given patches — the hoisted path of
    the tiled evaluator, which retrieves once per tile stack. In a training
    step the batch (any size: a tail batch of 1–3 patches too) retrieves
    inside the forward, one kernel launch per step on the card.
    ``retrieval_fn`` (default ``select_memory_patch``) takes the place of
    the retrieval, as in the JAX wrapper: ``memory/sharded.py::
    make_ring_retrieval`` over a ``shard_bank`` bank (one launch per shard).
    """

    def __init__(self, base_forward: Callable, adapter: nn.Module,
                 retrieval_fn: Optional[Callable] = None):
        super().__init__()
        self.base_forward = base_forward
        self.adapter = adapter
        self.retrieval_fn = retrieval_fn

    def retrieve(self, noisy, memory_noise_flat, memory_clean, bank_sq_norms=None):
        """The retrieved clean patches of NCHW ``noisy``, NCHW float32."""
        select = self.retrieval_fn or select_memory_patch
        mem = select(noisy.permute(0, 2, 3, 1), memory_noise_flat, memory_clean,
                     bank_sq_norms)
        return mem.permute(0, 3, 1, 2)

    def forward(self, noisy, memory_noise_flat=None, memory_clean=None,
                bank_sq_norms=None, mem_clean=None):
        base_out = _frozen_base(self.base_forward, noisy)
        if mem_clean is None:
            if memory_noise_flat is None or memory_clean is None:
                raise ValueError("pass the bank (memory_noise_flat, "
                                 "memory_clean) or mem_clean")
            mem_clean = self.retrieve(noisy, memory_noise_flat, memory_clean,
                                      bank_sq_norms)
        return self.adapter(noisy, base_out, _clean01(mem_clean))

    def replica(self, device):
        """As ``DenoiserWithAdapter.replica``; the retrieval stays the same."""
        base = _base_on(self.base_forward, device)
        adapter = module_on(self.adapter, device)
        if base is self.base_forward and adapter is self.adapter:
            return self
        return type(self)(base, adapter, self.retrieval_fn).train(self.training)
