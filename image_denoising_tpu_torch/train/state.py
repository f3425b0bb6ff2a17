"""Train state (counterpart of ``image_denoising_tpu/train/state.py``).

The JAX state is a pytree of params, Adam moments and counters; here it is
the module, a ``torch.optim.Adam`` over its parameters, and the counters.
torch's Adam (betas 0.9/0.999, eps 1e-8 outside the square root,
bias-corrected) computes optax ``adam``'s update, and its ``weight_decay``
is the coupled L2 (grad += wd·param before the moments) that the JAX
version builds from ``optax.add_decayed_weights``.
"""
from __future__ import annotations

import torch

__all__ = ["TrainState", "create_train_state", "set_learning_rate"]


class TrainState:
    """``model``, its ``optimizer``, ``step`` (updates applied) and
    ``skipped`` (guard-rejected batches; no N2N step rejects one)."""

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer):
        self.model = model
        self.optimizer = optimizer
        self.step = 0
        self.skipped = 0


def create_train_state(model: torch.nn.Module, lr: float = 3e-4,
                       weight_decay: float = 0.0) -> TrainState:
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8, weight_decay=weight_decay)
    return TrainState(model, opt)


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Set the learning rate of every parameter group (host-side, cheap)."""
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    return state
