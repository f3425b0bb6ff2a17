"""Device mesh and data-parallel helpers (counterpart of
``image_denoising_tpu/parallel/mesh.py``).

The reference's only parallelism is single-process ``nn.DataParallel``
(``train.py:324-326``); the JAX package's is SPMD in one process over
``make_mesh()``. The port keeps that model: one process drives an ordered
list of devices. A batch is split into per-device chunks in batch order,
each device runs its chunk, and the outputs are gathered on the first
device (the primary), where the loss of a training step is taken over the
whole batch, so the gradient is the one of the global batch, as the SPMD
mean gives it. PyTorch's launches are asynchronous, so the devices' chunks
run at once on distinct cards.

A mesh may repeat a device (``make_mesh(devices=["cpu"] * 8)`` in the CPU
tests, ``["cuda:0"] * k`` on one card): every split, gather and per-device
path then runs, and the copies between devices are no-ops.
"""
from __future__ import annotations

import copy
from typing import Callable, Optional, Sequence

import torch

__all__ = ["Mesh", "make_mesh", "shard_batch", "replicate", "forward_over_mesh",
           "module_on", "grad_replica", "PerDevice"]


class Mesh:
    """An ordered list of ``torch.device``s; ``devices[0]`` is the primary."""

    def __init__(self, devices: Sequence):
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(torch.device(d) for d in devices)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def primary(self) -> torch.device:
        return self.devices[0]

    def distinct(self):
        """The mesh's devices without repeats, in mesh order."""
        return list(dict.fromkeys(self.devices))

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """Every visible CUDA card (the first ``n_devices``), or the explicit
    ``devices`` list, which may repeat a device. Raises where no card is
    visible and no list is given."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh() needs a CUDA device, and "
                               "torch.cuda.is_available() is False; pass devices= "
                               "(e.g. ['cpu'] * 8), or device='cpu' to a CLI")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices)


def shard_batch(mesh: Mesh, batch):
    """Per-device chunks of ``batch`` (a tensor, or a tuple of tensors with
    one leading batch size), in batch order: chunk i on ``mesh.devices[i]``.

    B that does not divide the mesh is split into ``min(B, k)`` near-equal
    chunks, the first ones one larger. (The JAX package regroups the mesh by
    gcd(B, k) instead, a limit of SPMD shardings; both steps take the mean
    over the global batch.)
    """
    single = isinstance(batch, torch.Tensor)
    parts = (batch,) if single else tuple(batch)
    b = parts[0].shape[0]
    if any(p.shape[0] != b for p in parts):
        raise ValueError("batch leaves disagree on the leading dimension")
    if b == 0:
        raise ValueError("empty batch")
    n = min(b, mesh.size)
    split = [torch.tensor_split(p, n) for p in parts]
    chunks = []
    for i in range(n):
        dev = mesh.devices[i]
        chunk = tuple(s[i].to(dev, non_blocking=True) for s in split)
        chunks.append(chunk[0] if single else chunk)
    return chunks


def _gather(outs, primary):
    """Concatenate per-device outputs (tensors, or tuples of tensors) on the
    primary, in chunk order."""
    if isinstance(outs[0], torch.Tensor):
        return torch.cat([o.to(primary) for o in outs])
    return tuple(_gather([o[j] for o in outs], primary) for j in range(len(outs[0])))


def forward_over_mesh(mesh: Mesh, fn: Callable, *batch):
    """``fn(device, *chunk)`` on each device's chunk of ``batch``
    (``shard_batch``), its outputs (a tensor or a tuple of tensors with the
    chunk's leading size) gathered on the primary in batch order. The
    gather is differentiable: a loss taken on it sends its gradient back to
    each device."""
    chunks = shard_batch(mesh, batch if len(batch) > 1 else batch[0])
    devices = mesh.devices[: len(chunks)]
    if len(batch) == 1:
        outs = [fn(d, c) for d, c in zip(devices, chunks)]
    else:
        outs = [fn(d, *c) for d, c in zip(devices, chunks)]
    return _gather(outs, mesh.primary)


def replicate(mesh: Mesh, obj):
    """One copy of ``obj`` (a module, a tensor, or a tuple or list of
    tensors) per mesh entry, in mesh order. A device that repeats shares one
    copy, and a module or tensor already on a device is not copied there.
    Module copies are frozen replicas for inference (``module_on`` gives a
    differentiable one)."""
    copies = {}
    for d in mesh.distinct():
        copies[d] = _to(obj, d)
    return [copies[d] for d in mesh.devices]


def _to(obj, device):
    if isinstance(obj, torch.nn.Module):
        p = next(obj.parameters(), None)
        if p is not None and p.device == device:
            return obj
        return copy.deepcopy(obj).to(device)
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to(v, device) for v in obj)
    raise TypeError(f"cannot replicate {type(obj).__name__}")


def module_on(module: torch.nn.Module, device) -> torch.nn.Module:
    """``module`` itself where its parameters already lie on ``device``,
    else ``grad_replica(module, device)``."""
    device = torch.device(device)
    p = next(module.parameters(), None)
    if p is None or p.device == device:
        return module
    return grad_replica(module, device)


def grad_replica(module: torch.nn.Module, device) -> torch.nn.Module:
    """A replica of ``module`` whose parameters and buffers are
    ``.to(device)`` copies, differentiable, so a backward through the
    replica accumulates into the module's own ``.grad`` (what
    ``nn.DataParallel``'s replicate does). The replica holds the copies as
    attributes, so a block recomputed under ``torch.utils.checkpoint`` finds
    them too. Build it anew each step: the copies do not follow later
    updates of the parameters."""
    device = torch.device(device)
    memo = {}

    def rep(m):
        if m in memo:
            return memo[m]
        r = copy.copy(m)
        memo[m] = r
        r._parameters = {k: None if v is None else v.to(device)
                         for k, v in m._parameters.items()}
        r._buffers = {k: None if v is None else v.to(device)
                      for k, v in m._buffers.items()}
        r._modules = {k: None if v is None else rep(v) for k, v in m._modules.items()}
        return r

    return rep(module)


class PerDevice:
    """A callable made once per distinct device of a mesh.

    ``make(device)`` builds the device's callable (a repeated device shares
    one). ``on(device)`` returns it; calling the object splits an NCHW batch
    over the mesh, runs each chunk on its device and gathers the outputs on
    the primary (``forward_over_mesh``), the whole-batch contract of a
    single-device forward.
    """

    def __init__(self, mesh: Mesh, make: Callable):
        self.mesh = mesh
        self._fns = {d: make(d) for d in mesh.distinct()}

    def on(self, device):
        return self._fns[torch.device(device)]

    def __call__(self, x):
        return forward_over_mesh(self.mesh, lambda d, c: self._fns[d](c),
                                 x.to(self.mesh.primary))
