"""Weight initializers with the reference's PyTorch init semantics
(counterpart of ``image_denoising_tpu/models/init.py``).

Two regimes exist in the reference (``arch_unet.py``):

* UNet / RESNET / UpsampleCat call ``initialize_weights(m, 0.1)``:
  Kaiming-normal (fan_in, a=0, gain √2) scaled by 0.1, biases zeroed. The
  last 1×1 head (``nin_c``) stays at torch's default when ``zero_last=True``.
* ImprovedUNet and its blocks keep torch's default ``kaiming_uniform_(a=√5)``:
  weights and biases ~ U(±1/√fan_in).

``torch.nn.init`` computes a ConvTranspose2d's fan_in from
``weight.size(1)`` (its *out* channels) times the kernel area, the quirk the
JAX package reproduces by hand; here it comes for free. The draws come from
torch's global generator (``torch.manual_seed``), so the values differ from
the JAX package's ``PRNGKey`` stream; the distributions are the same.
"""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["INIT_REGIMES", "init_conv_", "initialize_weights", "kaiming_normal_scaled_"]

INIT_REGIMES = ("kaiming01", "torch", "zeros")


@torch.no_grad()
def kaiming_normal_scaled_(weight: torch.Tensor, scale: float = 0.1) -> torch.Tensor:
    """Kaiming-normal (fan_in, gain √2) times ``scale``, in place."""
    nn.init.kaiming_normal_(weight, a=0, mode="fan_in")
    return weight.mul_(scale)


@torch.no_grad()
def init_conv_(conv: nn.modules.conv._ConvNd, regime: str) -> None:
    """Re-draw a conv's (or deconv's) parameters under one of JAX ``Conv``'s
    regimes: ``kaiming01`` (Kaiming-normal·0.1, zero bias), ``torch`` (the
    module's own default, drawn when it was built: left as it is) or
    ``zeros``."""
    if regime == "kaiming01":
        kaiming_normal_scaled_(conv.weight, 0.1)
        if conv.bias is not None:
            conv.bias.zero_()
    elif regime == "zeros":
        conv.weight.zero_()
        if conv.bias is not None:
            conv.bias.zero_()
    elif regime != "torch":
        raise ValueError(f"unknown init regime {regime!r} (choose from {INIT_REGIMES})")


def initialize_weights(module: nn.Module, scale: float = 0.1) -> nn.Module:
    """The reference's ``initialize_weights(m, scale)`` over every conv and
    deconv of ``module``: Kaiming-normal·``scale``, zero biases."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            kaiming_normal_scaled_(m.weight, scale)
            if m.bias is not None:
                with torch.no_grad():
                    m.bias.zero_()
    return module
