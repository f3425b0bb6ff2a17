"""Train steps (counterpart of ``image_denoising_tpu/train/steps.py``).

``make_n2n_train_step`` is the Neighbor2Neighbor step of ``steps.py:144-200``
in eager PyTorch: [synthetic noise] → one call to the sub-sampler kernel →
no-grad f(noisy) → f(sub1) → regularized loss → backward → Adam. Both
forwards run the module (cuDNN on the card): the chain kernel has no
backward, as in JAX. The step returns its metrics as device tensors, so
the caller decides when to wait for them.

The bad-batch guard (``_guarded_update``) and the structure and L1 steps
come with the structure-trainer slice (ROADMAP.md): the N2N step uses no
guard, as in JAX.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..losses import n2n_regularized_loss
from ..ops.neighbor import generate_subimages, subsample_pair_fused
from ..ops.rng import split_seed
from .state import TrainState

__all__ = ["make_n2n_train_step", "to_nchw01"]


def to_nchw01(batch255, device: torch.device) -> torch.Tensor:
    """NHWC frames in [0,255] (numpy or tensor) → NCHW float32 in [0,1] on
    ``device``; /255 runs on the device. Host arrays go through pinned
    memory, so the copy does not wait for the work queued before it."""
    t = torch.as_tensor(batch255)
    if t.device != device:
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
    return t.permute(0, 3, 1, 2).float().contiguous() / 255.0


def make_n2n_train_step(
    model: torch.nn.Module,
    state: TrainState,
    noise_fn: Optional[Callable] = None,
    increase_ratio: float = 2.0,
    n_epoch: int = 100,
    subsample: Callable = subsample_pair_fused,
    lambda1: float = 1.0,
    lambda2: float = 1.0,
):
    """``step(clean255, noisy255, seed, epoch) -> {"loss", "loss_rec",
    "loss_reg"}`` on ``state``; frames NHWC in [0,255], seed a 64-bit int.

    ``noise_fn(gen, clean01) -> noisy01`` is optional: with it the step
    splits the seed into a noise seed (a ``torch.Generator`` on the model's
    device) and a mask seed; without it the step trains on ``noisy255`` and
    the seed is the mask seed. ``subsample(seed, noisy01)`` returns
    ``(sub1, sub2, (sel1, sel2))``; it is the kernel's wrapper unless a test
    injects selectors drawn elsewhere.
    """
    device = next(model.parameters()).device
    gen = torch.Generator(device=device) if noise_fn is not None else None

    def step(clean255, noisy255, seed: int, epoch: int):
        if noise_fn is not None:
            noise_seed, mask_seed = split_seed(seed)
            gen.manual_seed(noise_seed)
            noisy01 = noise_fn(gen, to_nchw01(clean255, device))
        else:
            mask_seed = seed
            noisy01 = to_nchw01(noisy255, device)
        # Λ in float32, as the JAX step computes it
        lam = float(np.float32(epoch) / np.float32(n_epoch) * np.float32(increase_ratio))
        sub1, sub2, (sel1, sel2) = subsample(mask_seed, noisy01)
        with torch.no_grad():
            denoised = model(noisy01)
            den_sub1 = generate_subimages(denoised, sel1)
            den_sub2 = generate_subimages(denoised, sel2)
        pred = model(sub1)
        total, (l_rec, l_reg) = n2n_regularized_loss(
            pred, sub2, den_sub1, den_sub2, lam, lambda1=lambda1, lambda2=lambda2)
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        state.optimizer.step()
        state.step += 1
        return {"loss": total.detach(), "loss_rec": l_rec.detach(),
                "loss_reg": l_reg.detach()}

    return step
