"""A dry run of every multi-device path on one mesh (counterpart of the JAX
package's ``__graft_entry__.py::dryrun_multichip``).

``dryrun_multidevice(mesh)`` runs, on ImprovedUNet-8 at small shapes:

* the data-parallel structure step at batch 2k, and at batch 4, which a
  mesh of k = 8 does not divide (four chunks of one);
* the data-parallel N2N step (noise and sub-sampler once, on the first
  device);
* one frame through the pyramid runner with its tile stack split over the
  mesh;
* one frame through the Hann runner with the memory adapter, the tiles
  split and both banks sharded (retrieval inside the forward, through the
  sharded bank's key merge);
* the memory finetune step with the sharded bank;
* int8 retrieval over the sharded bank, which must equal the unsharded
  retrieval exactly.

The CPU tests run it on ``make_mesh(devices=["cpu"] * 8)``; on a card
``["cuda:0"] * k`` runs the kernels on every path.
"""
from __future__ import annotations

import numpy as np
import torch

from .mesh import Mesh, PerDevice

__all__ = ["dryrun_multidevice"]


def dryrun_multidevice(mesh: Mesh, seed: int = 0) -> dict:
    """Run every multi-device path once on ``mesh``; returns the losses and
    shapes, and raises on a non-finite result or a retrieval mismatch."""
    from ..adapters import DenoiserWithMemoryAdapter, build_memory_adapter
    from ..adapters.wrappers import select_memory_patch
    from ..eval.tiled import make_tiled_hann_runner, make_tiled_pyramid_runner
    from ..memory import MemoryBank, make_ring_retrieval, shard_bank
    from ..models import ImprovedUNet
    from ..models.fused_forward import make_forward
    from ..ops import AugmentNoise
    from ..train import (create_train_state, make_memory_finetune_step,
                         make_n2n_train_step, make_structure_train_step)

    dev, k = mesh.primary, mesh.size
    rng = np.random.default_rng(seed)
    torch.manual_seed(seed)
    model = ImprovedUNet(1, 1, 8).to(dev)
    out = {}

    def finite(name, value):
        value = float(value)
        if not np.isfinite(value):
            raise RuntimeError(f"{name}: non-finite {value}")
        out[name] = value

    def frames(b, size=32):
        return (rng.random((b, size, size, 1), dtype=np.float32) * 255).astype(np.float32)

    state = create_train_state(model, lr=1e-3)
    step = make_structure_train_step(model, state, mesh=mesh)
    finite("dp_loss", step(frames(2 * k), frames(2 * k))["loss"])
    finite("dp_batch4_loss", step(frames(4), frames(4))["loss"])

    n2n_model = ImprovedUNet(1, 1, 8).to(dev)
    n2n = make_n2n_train_step(n2n_model, create_train_state(n2n_model, lr=1e-3),
                              noise_fn=AugmentNoise("gauss25").add_train_noise,
                              n_epoch=10, mesh=mesh)
    clean = frames(2 * k)
    finite("n2n_loss", n2n(clean, clean, seed + 7, 3)["loss"])

    model.eval()
    fwd = make_forward(model, device=dev, mesh=mesh)
    runner = make_tiled_pyramid_runner(fwd, 96, 96, ps=32, overlap=16, mesh=mesh)
    pred, l1 = runner(rng.integers(0, 256, (96, 96)).astype(np.uint8))
    if not torch.isfinite(pred).all():
        raise RuntimeError("tile-parallel pyramid frame: non-finite output")
    finite("pyramid_l1", l1)
    out["pyramid_shape"] = tuple(pred.shape)

    n_bank, ps = 2 * k + 3, 32
    noise = torch.from_numpy(rng.random((n_bank, ps * ps), dtype=np.float32)).to(dev)
    bank = MemoryBank(noise_flat=noise,
                      clean=torch.from_numpy(rng.random((n_bank, ps, ps, 1),
                                                        dtype=np.float32)).to(dev),
                      sq_norms=(noise ** 2).sum(1), patch_size=ps, stride=4)
    sharded = shard_bank(bank, mesh)
    adapter = build_memory_adapter("hyper_gated_fft", 1, 8).to(dev)
    wrapper = DenoiserWithMemoryAdapter(fwd, adapter,
                                        make_ring_retrieval(mesh, queries_sharded=True))
    banks = (sharded.noise_flat, sharded.clean, sharded.sq_norms)
    mem_call = PerDevice(mesh, lambda d: (lambda tiles, w=wrapper.replica(d): w(tiles, *banks)))
    hann = make_tiled_hann_runner(mem_call, 64, 64, ps=ps, overlap=16, batch=-2, mesh=mesh)
    mem_pred = hann(rng.integers(0, 256, (64, 64)).astype(np.uint8))
    if not torch.isfinite(mem_pred).all():
        raise RuntimeError("sharded-bank Hann memory frame: non-finite output")
    out["hann_shape"] = tuple(mem_pred.shape)

    ft_adapter = build_memory_adapter("hyper_gated_fft", 1, 8).to(dev)
    ft_wrapper = DenoiserWithMemoryAdapter(
        fwd, ft_adapter, make_ring_retrieval(mesh, queries_sharded=False))
    ft_step = make_memory_finetune_step(ft_wrapper, create_train_state(ft_adapter, lr=1e-3),
                                        lambda_grad=0.1)
    q = rng.random((2, ps, ps, 1), dtype=np.float32)
    finite("finetune_loss", ft_step(q, rng.random((2, ps, ps, 1), dtype=np.float32),
                                    *banks)["loss"])

    centered = rng.integers(0, 256, (n_bank, ps * ps)).astype(np.int32) - 128
    i8 = MemoryBank(noise_flat=torch.from_numpy(centered.astype(np.int8)).to(dev),
                    clean=bank.clean,
                    sq_norms=torch.from_numpy((centered ** 2).sum(1).astype(np.int32)).to(dev),
                    patch_size=ps, stride=4)
    q01 = torch.from_numpy(rng.integers(0, 256, (3, ps, ps, 1)).astype(np.float32) / 255).to(dev)
    want = select_memory_patch(q01, i8.noise_flat, i8.clean, i8.sq_norms)
    s8 = shard_bank(i8, mesh)
    got = make_ring_retrieval(mesh, queries_sharded=False)(q01, s8.noise_flat, s8.clean,
                                                           s8.sq_norms)
    if not torch.equal(got, want):
        raise RuntimeError("int8 retrieval over the sharded bank differs from the "
                           "unsharded retrieval")
    out["int8_sharded_exact"] = True
    print(f"dryrun_multidevice OK on {mesh}: " + ", ".join(f"{n}={v}" for n, v in out.items()))
    return out
