"""Train steps (counterpart of ``image_denoising_tpu/train/steps.py``).

Each factory returns ``step(...) -> metrics`` over a ``TrainState``, in
eager PyTorch: /255 on the device → forward(s) → loss → backward → Adam.
The metrics are device tensors, so the caller decides when to wait for
them (the CLI fetches them one step late).

``_guarded_update`` is the bad-batch guard of ``steps.py:33-55``: it
keeps or drops the whole update on the device, with no host sync, as
JAX's ``lax.cond`` does. The N2N step uses no guard, as in JAX.

``make_n2n_train_step`` is the Neighbor2Neighbor step of ``steps.py:144-200``:
[synthetic noise] → one call to the sub-sampler kernel → no-grad f(noisy)
→ f(sub1) → regularized loss → backward → Adam. Every forward runs the
module (cuDNN on the card): the chain kernel has no backward, as in JAX.

``mesh=`` (``parallel.make_mesh``) makes a step data-parallel, as the JAX
step is under a sharded batch: the batch comes to the mesh's first device,
is split into per-device chunks (``parallel.shard_batch``), each device
runs the network on its chunk (``parallel.module_on``: differentiable
copies of the parameters on another card, the module itself on the first),
and the outputs are gathered back, where the loss is taken over the whole
batch. One backward then leaves the global batch's gradient on the
parameters, and Adam and the guard run there unchanged. No network of the
repo has a batch statistic (GroupNorm is per sample), so a chunk's forward
is the batch's, sample by sample. The N2N step draws its noise and runs
the sub-sampler once on the first device over the whole batch (the draw is
keyed by the image's index in the call), then splits.
"""
from __future__ import annotations

import itertools
from typing import Callable, Optional

import numpy as np
import torch

from ..losses import l1_loss, n2n_regularized_loss, structure_loss
from ..ops.neighbor import generate_subimages, subsample_pair_fused
from ..ops.rng import split_seed
from ..parallel.mesh import forward_over_mesh, module_on
from ..utils.profiling import Backlog, span
from .state import TrainState

__all__ = ["make_l1_train_step", "make_n2n_train_step", "make_structure_train_step",
           "to_nchw01"]


def to_nchw01(batch, device: torch.device, scale: float = 255.0) -> torch.Tensor:
    """NHWC frames in [0, scale] (numpy or tensor) → NCHW float32 in [0,1]
    on ``device``; the division runs on the device. Host arrays go through
    pinned memory, so the copy does not wait for the work queued before it."""
    t = torch.as_tensor(batch)
    if t.device != device:
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
    return t.permute(0, 3, 1, 2).float().contiguous() / scale


def _apply(model, mesh, fn, *batch):
    """``fn(net, *batch)`` with ``net`` the model, or over the mesh: each
    device's chunk through ``fn(module_on(model, device), *chunk)``, the
    outputs gathered on the first device. Every replica is made before any
    forward runs: its parameter copies run on the first device's stream,
    where they would wait behind that device's forward."""
    if mesh is None:
        return fn(model, *batch)
    nets = {d: module_on(model, d) for d in mesh.distinct()}
    return forward_over_mesh(mesh, lambda d, *c: fn(nets[d], *c), *batch)


@torch.no_grad()
def _guarded_update(state: TrainState, loss: torch.Tensor, *,
                    grad_clip: Optional[float], max_loss_skip: Optional[float],
                    max_grad_norm: Optional[float]):
    """Apply the gradients on the parameters only when the loss and their
    global norm pass the guards; else count a skip. Returns (norm, ok).

    ok = loss finite [and ≤ max_loss_skip], norm finite [and ≤
    10·max_grad_norm]; ``grad_clip`` scales the gradients by
    min(1, clip/(norm + 1e-12)) first. Adam steps unconditionally, then
    every parameter, moment and Adam step count is set back to its copy
    from before the step where ``ok`` is false: a rejected batch changes
    none of them, bit for bit, and nothing waits for the host.
    """
    opt = state.optimizer
    params = [p for g in opt.param_groups for p in g["params"] if p.grad is not None]
    grads = [p.grad for p in params]
    gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    ok = torch.isfinite(loss) & torch.isfinite(gnorm)
    if max_loss_skip is not None:
        ok &= loss <= max_loss_skip
    if max_grad_norm is not None:
        ok &= gnorm <= max_grad_norm * 10.0
    if grad_clip is not None:
        torch._foreach_mul_(grads, torch.clamp(grad_clip / (gnorm + 1e-12), max=1.0))
    kept = params + [opt.state[p][k] for k in ("exp_avg", "exp_avg_sq", "step")
                     for p in params]
    before = [t.clone() for t in kept]
    opt.step()
    for t, old in zip(kept, before):
        torch.where(ok, t, old, out=t)
    state.step += ok.to(torch.int32)
    state.skipped += (~ok).to(torch.int32)
    return gnorm, ok


def make_structure_train_step(
    model: torch.nn.Module,
    state: TrainState,
    alpha: float = 1.0,
    beta: float = 0.5,
    gamma: float = 0.5,
    guards: bool = False,
    grad_clip: Optional[float] = None,
    fused: bool = True,
    mesh=None,
):
    """A-domain trainer step (reference ``train.py:354-368``):
    ``step(clean255, noisy255) -> {"loss", "l1"}``, frames NHWC in [0,255].

    ``fused=True`` runs network(noisy) and network(clean) as one
    concatenated batch-2B forward and splits the output: the same function
    (convs, pools and GroupNorm are per sample, the loss terms elementwise),
    with every conv at twice the batch. ``fused=False`` keeps the literal
    two forwards. ``l1`` is L1(network(noisy), clean), the log's ``Loss1``.
    ``mesh``: data-parallel (module docstring); each device runs its
    chunk's fused forward.

    Under a profiler each call is a device-timed ``train.step`` span (its
    unit the call's index) over ``train.step.input``, ``.forward``,
    ``.loss``, ``.backward`` and ``.optimizer``, and the
    ``train.step.queued`` counter samples the device queue at its start
    (``utils/profiling.py``).
    """
    device = next(model.parameters()).device
    backlog = Backlog("train.step")
    units = itertools.count()

    def forward(net, noisy01, clean01):
        if fused:
            b = noisy01.shape[0]
            both = net(torch.cat([noisy01, clean01], 0))
            return both[:b], both[b:]
        return net(noisy01), net(clean01)

    def step(clean255, noisy255):
        with span("train.step", device, unit=next(units)) as entry:
            backlog.sample()
            with span("train.step.input"):
                clean01 = to_nchw01(clean255, device)
                noisy01 = to_nchw01(noisy255, device)
            with span("train.step.forward"):
                pred_n, pred_c = _apply(model, mesh, forward, noisy01, clean01)
            with span("train.step.loss"):
                loss = structure_loss(pred_n, pred_c, clean01, alpha, beta, gamma)
            with span("train.step.backward"):
                state.optimizer.zero_grad(set_to_none=True)
                loss.backward()
            with span("train.step.optimizer"):
                if guards or grad_clip is not None:
                    _guarded_update(state, loss, grad_clip=grad_clip,
                                    max_loss_skip=5.0 if guards else None,
                                    max_grad_norm=20.0 if guards else None)
                else:
                    state.optimizer.step()
                    state.step += 1
            l1 = l1_loss(pred_n.detach(), clean01)
        backlog.add(entry)
        return {"loss": loss.detach(), "l1": l1}

    return step


def make_l1_train_step(model: torch.nn.Module, state: TrainState, guards: bool = True,
                       grad_clip: Optional[float] = 1.0, inputs_01: bool = True,
                       mesh=None):
    """HPO trainer step (reference ``train_opt.py:118-160``): L1 loss and the
    full guard set; ``step(clean, noisy) -> {"loss", "grad_norm", "ok"}``.

    ``inputs_01``: the frames are already [0,1] floats (train_opt's
    dataset); else [0,255]. ``mesh``: data-parallel (module docstring).
    """
    device = next(model.parameters()).device
    scale = 1.0 if inputs_01 else 255.0

    def step(clean, noisy):
        clean01 = to_nchw01(clean, device, scale)
        noisy01 = to_nchw01(noisy, device, scale)
        loss = l1_loss(_apply(model, mesh, lambda net, x: net(x), noisy01), clean01)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        gnorm, ok = _guarded_update(state, loss, grad_clip=grad_clip,
                                    max_loss_skip=5.0 if guards else None,
                                    max_grad_norm=20.0 if guards else None)
        return {"loss": loss.detach(), "grad_norm": gnorm, "ok": ok}

    return step


def make_n2n_train_step(
    model: torch.nn.Module,
    state: TrainState,
    noise_fn: Optional[Callable] = None,
    increase_ratio: float = 2.0,
    n_epoch: int = 100,
    subsample: Callable = subsample_pair_fused,
    lambda1: float = 1.0,
    lambda2: float = 1.0,
    mesh=None,
):
    """``step(clean255, noisy255, seed, epoch) -> {"loss", "loss_rec",
    "loss_reg"}`` on ``state``; frames NHWC in [0,255], seed a 64-bit int.

    ``noise_fn(gen, clean01) -> noisy01`` is optional: with it the step
    splits the seed into a noise seed (a ``torch.Generator`` on the model's
    device) and a mask seed; without it the step trains on ``noisy255`` and
    the seed is the mask seed. ``subsample(seed, noisy01)`` returns
    ``(sub1, sub2, (sel1, sel2))``; it is the kernel's wrapper unless a test
    injects selectors drawn elsewhere. ``mesh``: data-parallel (module
    docstring); the noise and the sub-sampler run once, over the whole
    batch, on the first device, and both forwards split over the mesh.

    Under a profiler it records the structure step's spans and counters
    (``train.step`` over ``.input``: the frames to the device, the noise
    and the sub-sampler; ``.forward``: both forwards; ``.loss``,
    ``.backward``, ``.optimizer``; ``train.step.queued``).
    """
    device = next(model.parameters()).device
    gen = torch.Generator(device=device) if noise_fn is not None else None
    backlog = Backlog("train.step")
    units = itertools.count()

    def step(clean255, noisy255, seed: int, epoch: int):
        with span("train.step", device, unit=next(units)) as entry:
            backlog.sample()
            with span("train.step.input"):
                if noise_fn is not None:
                    noise_seed, mask_seed = split_seed(seed)
                    gen.manual_seed(noise_seed)
                    noisy01 = noise_fn(gen, to_nchw01(clean255, device))
                else:
                    mask_seed = seed
                    noisy01 = to_nchw01(noisy255, device)
                sub1, sub2, (sel1, sel2) = subsample(mask_seed, noisy01)
            # Λ in float32, as the JAX step computes it
            lam = float(np.float32(epoch) / np.float32(n_epoch) * np.float32(increase_ratio))
            with span("train.step.forward"):
                with torch.no_grad():
                    denoised = _apply(model, mesh, lambda net, x: net(x), noisy01)
                    den_sub1 = generate_subimages(denoised, sel1)
                    den_sub2 = generate_subimages(denoised, sel2)
                pred = _apply(model, mesh, lambda net, x: net(x), sub1)
            with span("train.step.loss"):
                total, (l_rec, l_reg) = n2n_regularized_loss(
                    pred, sub2, den_sub1, den_sub2, lam, lambda1=lambda1, lambda2=lambda2)
            with span("train.step.backward"):
                state.optimizer.zero_grad(set_to_none=True)
                total.backward()
            with span("train.step.optimizer"):
                state.optimizer.step()
                state.step += 1
        backlog.add(entry)
        return {"loss": total.detach(), "loss_rec": l_rec.detach(),
                "loss_reg": l_reg.detach()}

    return step
