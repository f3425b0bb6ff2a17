"""Train state (counterpart of ``image_denoising_tpu/train/state.py``).

The JAX state is a pytree of params, Adam moments and counters; here it is
the module, a ``torch.optim.Adam`` over its parameters, and the counters.
torch's Adam (betas 0.9/0.999, eps 1e-8 outside the square root,
bias-corrected) computes optax ``adam``'s update, and its ``weight_decay``
is the coupled L2 (grad += wd·param before the moments) that the JAX
version builds from ``optax.add_decayed_weights``.

As JAX's ``tx.init``, the Adam state (moments and step count) is made when
the state is, and the counters are int32 scalars on the parameters'
device. On a GPU the Adam is ``capturable``: its step count lives on the
card too, so a guarded step (``steps.py::_guarded_update``) can keep or
drop a whole update there without waiting for the host.
"""
from __future__ import annotations

import torch

__all__ = ["TrainState", "create_train_state", "set_learning_rate"]


class TrainState:
    """``model``, its ``optimizer``, ``step`` (updates applied) and
    ``skipped`` (guard-rejected batches), both int32 scalars on the
    parameters' device."""

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer):
        self.model = model
        self.optimizer = optimizer
        device = next(model.parameters()).device
        self.step = torch.zeros((), dtype=torch.int32, device=device)
        self.skipped = torch.zeros((), dtype=torch.int32, device=device)


def create_train_state(model: torch.nn.Module, lr: float = 3e-4,
                       weight_decay: float = 0.0) -> TrainState:
    params = list(model.parameters())
    capturable = params[0].is_cuda
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=weight_decay, capturable=capturable)
    for p in params:  # the state Adam would make at its first step
        opt.state[p] = {
            "step": (torch.zeros((), dtype=torch.float32, device=p.device)
                     if capturable else torch.tensor(0.0, dtype=torch.float32)),
            "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
            "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format),
        }
    return TrainState(model, opt)


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Set the learning rate of every parameter group (host-side, cheap)."""
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    return state
