"""Finetune steps: frozen base, adapter-only gradients (counterpart of
``image_denoising_tpu/train/finetune_steps.py``).

The state is ``create_train_state(wrapper.adapter, lr)``: Adam covers the
adapter's parameters only, and the wrapper runs the base under no-grad
(``adapters/wrappers.py``), as torch's requires_grad=False + no_grad in
the reference and JAX's stop_gradient do. Each step takes NHWC batches
in [0,1] (``DenoisePatchDataset``), runs forward → loss → backward → Adam
in eager PyTorch and returns the metrics as device tensors, so the caller
fetches them when it likes (the CLIs one step late); no op of a step waits
for the card.

``mesh=`` (``parallel.make_mesh``) makes a step data-parallel, as the JAX
step under a sharded batch: the batch is split over the mesh, each device
runs the frozen base (its own copy of the forward: the chain kernel for an
ImprovedUNet) and the adapter (``wrapper.replica``) on its chunk, and the
predictions are gathered on the first device, where the loss is taken over
the whole batch (IQSL's Dice sums over it) and one backward leaves the
global gradient on the adapter. A memory step retrieves its patches once,
on the first device, over the whole batch, and splits them with the batch.
With a sharded bank (``memory/sharded.py``, the wrapper's ``retrieval_fn``)
the CLI keeps the batch whole, as JAX's ``queries_sharded=False`` does.

Loss semantics:
* plain — L1 + λ_grad·gradient (finetune.py:277-298)
* iqsl  — + λ_iqsl·IQSL (finetune_iqsl.py / finetune_memory.py)
"""
from __future__ import annotations

from typing import Optional

from ..losses import gradient_loss, iqsl_loss, l1_loss
from ..parallel.mesh import forward_over_mesh
from .state import TrainState
from .steps import to_nchw01

__all__ = ["make_adapter_finetune_step", "make_memory_finetune_step"]


def _total_loss(pred, clean01, lambda_grad, lambda_iqsl, iqsl_cfg):
    loss_l1 = l1_loss(pred, clean01)
    loss_grad = gradient_loss(pred, clean01)
    if lambda_iqsl > 0.0:
        loss_iq = iqsl_loss(
            pred, clean01, t1=iqsl_cfg["t1"], t2=iqsl_cfg["t2"],
            tau=iqsl_cfg.get("tau", 0.1), margin=iqsl_cfg.get("margin", 0.0),
            ce_factor=iqsl_cfg.get("ce_factor", 0.5))
    else:
        loss_iq = loss_l1.new_zeros(())
    total = loss_l1 + lambda_grad * loss_grad + lambda_iqsl * loss_iq
    return total, {"l1": loss_l1, "grad": loss_grad, "iqsl": loss_iq}


def _predict(wrapper, mesh, noisy, bank):
    """The wrapper's prediction of ``noisy``, on one device or over the mesh."""
    if mesh is None:
        return wrapper(noisy, *bank)
    # every replica before any forward (as train/steps.py::_apply)
    reps = {d: wrapper.replica(d) for d in mesh.distinct()}
    if bank:
        mem = wrapper.retrieve(noisy, *bank)
        return forward_over_mesh(
            mesh, lambda d, n, m: reps[d](n, mem_clean=m), noisy, mem)
    return forward_over_mesh(mesh, lambda d, n: reps[d](n), noisy)


def _make_step(wrapper, state: TrainState, lambda_grad, lambda_iqsl, iqsl_cfg,
               mesh=None):
    device = next(wrapper.adapter.parameters()).device
    cfg = iqsl_cfg or {}

    def step(clean01, noisy01, *bank):
        clean = to_nchw01(clean01, device, scale=1.0)
        noisy = to_nchw01(noisy01, device, scale=1.0)
        pred = _predict(wrapper, mesh, noisy, bank)
        loss, parts = _total_loss(pred, clean, lambda_grad, lambda_iqsl, cfg)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return {"loss": loss.detach(), **{k: v.detach() for k, v in parts.items()}}

    return step


def make_adapter_finetune_step(wrapper, state: TrainState, lambda_grad: float = 0.1,
                               lambda_iqsl: float = 0.0,
                               iqsl_cfg: Optional[dict] = None, mesh=None):
    """Step for ``DenoiserWithAdapter``: ``step(clean01, noisy01) ->
    {"loss", "l1", "grad", "iqsl"}``, batches NHWC in [0,1]; ``state`` is
    ``create_train_state(wrapper.adapter, lr)``; ``mesh``: data-parallel."""
    return _make_step(wrapper, state, lambda_grad, lambda_iqsl, iqsl_cfg, mesh)


def make_memory_finetune_step(wrapper, state: TrainState, lambda_grad: float = 0.1,
                              lambda_iqsl: float = 0.0,
                              iqsl_cfg: Optional[dict] = None, mesh=None):
    """Step for ``DenoiserWithMemoryAdapter``: ``step(clean01, noisy01,
    bank_noise_flat, bank_clean, bank_sq_norms) -> {"loss", "l1", "grad",
    "iqsl"}``, the banks device-resident. Each step retrieves its batch's
    patches once: one retrieval launch on the card, or one per shard of a
    sharded bank. ``mesh``: data-parallel."""
    return _make_step(wrapper, state, lambda_grad, lambda_iqsl, iqsl_cfg, mesh)
