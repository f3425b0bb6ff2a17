"""Restormer (Zamir et al., CVPR 2022) as NCHW ``nn.Module``s.

The transformer of "Restormer: Efficient Transformer for High-Resolution
Image Restoration", at its grayscale Gaussian-denoising configuration by
default (``Denoising/Options/GaussianGrayDenoising_Restormer.yml``: 1 channel
in and out, dim 48, blocks [4, 6, 6, 8], 4 refinement blocks, heads [1, 2,
4, 8], FFN expansion 2.66, no bias, BiasFree LayerNorm; 26.11 M
parameters). The JAX package has no counterpart. The module tree carries
the upstream state-dict names (``basicsr/models/archs/restormer_arch.py``):
``patch_embed.proj``, ``encoder_level{1,2,3}.{i}``, ``latent.{i}``,
``decoder_level{3,2,1}.{i}``, ``refinement.{i}`` (each block ``norm1.body``,
``attn.{temperature,qkv,qkv_dwconv,project_out}``, ``norm2.body``,
``ffn.{project_in,dwconv,project_out}``), ``down1_2`` … ``up2_1`` (each
``body.0``), ``reduce_chan_level{3,2}`` and ``output``, so the released
weights load with ``strict=True``.

A block is z ← z + MDTA(LN₁ z), z ← z + GDFN(LN₂ z):

* LN (BiasFree): z / √(Var_c z + 1e-5) ⊙ w over the channels, not centred.
* MDTA: q, k, v from a 1×1 and a depthwise 3×3 conv; per head the
  (C/h) × (C/h) matrix softmax(τ · q̂ k̂ᵀ) over the tile's H·W pixels, q̂ and
  k̂ the rows divided by max(‖row‖₂, 1e-12); then A v and a 1×1 conv. The
  row norms are applied to the small product, q̂ k̂ᵀ = (q kᵀ) / (‖q‖ ‖k‖ᵀ),
  which is the same matrix without two passes over the tile.
* GDFN: a 1×1 conv to 2·⌊2.66·C⌋, a depthwise 3×3, GELU(u₁) ⊙ u₂, a 1×1
  conv back.

``dtype`` is the compute dtype with the port's semantics (parameters stay
float32; every conv casts its input and weight to it): the LayerNorm
statistics, the row norms and the softmax are float32 whatever it is, the
attention products accumulate in float32 (cuBLAS), and the convs and
activations are in it. ``FLOAT32_PARAMS`` names the parameters a serving
copy keeps in float32 when it casts the rest (``make_forward``). The output
conv's result plus the float32 input is float32.

Each stage threads its pending residual through its blocks: every add but
the stage's last goes into the norm that follows it
(``BiasFreeLayerNorm.add_forward``), so a stage of n blocks makes 2n such
calls, 2n − 1 of them with a residual, and one plain add at its end.
Without autograd (serving's ``inference_mode``) each call is
``ops/layer_norm.py::add_ln``, one kernel on a CUDA tensor; under autograd
it is the same arithmetic as plain ops (the kernel has no backward).

Under a profiler each forward records a device-timed span around each
stage's transformer blocks (``restormer.enc1`` … ``restormer.refine``) and
adds its batch to the ``restormer.tiles`` counter; ``add_ln`` adds 1 to
``restormer.add_ln`` at each kernel launch (``utils/profiling.py``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.layer_norm import add_ln, add_ln_reference
from ..utils.profiling import count, span

__all__ = ["Restormer", "TransformerBlock"]

LN_EPS = 1e-5
NORM_EPS = 1e-12
_CL = torch.channels_last


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


class Conv(nn.Conv2d):
    """Bias-free SAME conv (groups for the depthwise ones) that computes in
    ``compute_dtype`` when one is set."""

    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, cin: int, cout: int, kernel: int, groups: int = 1):
        super().__init__(cin, cout, kernel, padding=kernel // 2, groups=groups, bias=False)

    def forward(self, x):
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return self._conv_forward(x.to(dt), self.weight.to(dt), None)


class BiasFreeLayerNorm(nn.Module):
    """z / √(Var_c z + eps) ⊙ w at each pixel over dim 1; statistics and
    scale in float32, the result in the input's dtype."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))

    def forward(self, x):
        return self.add_forward(x)[1]

    def add_forward(self, x, residual=None):
        """(s, y): s = x + ``residual`` (x without one) on x's dtype, y its
        norm, both NCHW. Without autograd ``add_ln``: on a CUDA tensor one
        kernel, which reads channels_last, so x and the residual are made so
        (a no-op in the serving copy). Under autograd its plain version,
        which has a backward."""
        fn = add_ln
        if torch.is_grad_enabled():
            fn = add_ln_reference
        elif x.is_cuda:
            x = x.contiguous(memory_format=_CL)
            if residual is not None:
                residual = residual.contiguous(memory_format=_CL)
        s, y = fn(_nhwc(x), self.weight.float(),
                  None if residual is None else _nhwc(residual), LN_EPS)
        return _nchw(s), _nchw(y)


class LayerNorm(nn.Module):
    """Upstream's wrapper: the norm is its ``body``."""

    def __init__(self, channels: int):
        super().__init__()
        self.body = BiasFreeLayerNorm(channels)

    def forward(self, x):
        return self.body(x)


class Attention(nn.Module):
    """MDTA: multi-Dconv head transposed attention over the channels."""

    def __init__(self, channels: int, heads: int):
        super().__init__()
        self.heads = heads
        self.temperature = nn.Parameter(torch.ones(heads, 1, 1))
        self.qkv = Conv(channels, 3 * channels, 1)
        self.qkv_dwconv = Conv(3 * channels, 3 * channels, 3, groups=3 * channels)
        self.project_out = Conv(channels, channels, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        qkv = self.qkv_dwconv(self.qkv(x))
        q, k, v = (t.reshape(b, self.heads, c // self.heads, h * w)
                   for t in qkv.chunk(3, 1))
        nq = torch.linalg.vector_norm(q, dim=-1, dtype=torch.float32).clamp_min(NORM_EPS)
        nk = torch.linalg.vector_norm(k, dim=-1, dtype=torch.float32).clamp_min(NORM_EPS)
        logits = (q @ k.transpose(-2, -1)).float() / (nq[..., :, None] * nk[..., None, :])
        attn = torch.softmax(logits * self.temperature.float(), dim=-1)
        out = (attn.to(v.dtype) @ v).reshape(b, c, h, w)
        if x.is_contiguous(memory_format=torch.channels_last):  # keep x's layout
            out = out.contiguous(memory_format=torch.channels_last)
        return self.project_out(out)


class FeedForward(nn.Module):
    """GDFN: gated depthwise-conv feed-forward."""

    def __init__(self, channels: int, expansion: float):
        super().__init__()
        hid = int(channels * expansion)
        self.project_in = Conv(channels, 2 * hid, 1)
        self.dwconv = Conv(2 * hid, 2 * hid, 3, groups=2 * hid)
        self.project_out = Conv(hid, channels, 1)

    def forward(self, x):
        u1, u2 = self.dwconv(self.project_in(x)).chunk(2, 1)
        return self.project_out(F.gelu(u1) * u2)


class TransformerBlock(nn.Module):
    def __init__(self, channels: int, heads: int, expansion: float):
        super().__init__()
        self.norm1 = LayerNorm(channels)
        self.attn = Attention(channels, heads)
        self.norm2 = LayerNorm(channels)
        self.ffn = FeedForward(channels, expansion)

    def forward(self, x):
        x, f = self.add_forward(x)
        return x + f

    def add_forward(self, x, residual=None):
        """``forward`` of x + ``residual`` (x without one) with its adds
        fused into the norms and the last one left to the caller: (z, f)
        with ``forward(x + residual) == z + f``."""
        x, h = self.norm1.body.add_forward(x, residual)
        x, h = self.norm2.body.add_forward(x, self.attn(h))
        return x, self.ffn(h)


class Resample(nn.Module):
    """``body.0`` a bias-free 3×3 conv, then PixelUnshuffle(2) (down: C →
    C/2 → 2C) or PixelShuffle(2) (up: C → 2C → C/2)."""

    def __init__(self, channels: int, down: bool):
        super().__init__()
        self.down = down
        self.body = nn.ModuleList([Conv(channels, channels // 2 if down else 2 * channels, 3)])

    def forward(self, x):
        y = self.body[0](x)
        return F.pixel_unshuffle(y, 2) if self.down else F.pixel_shuffle(y, 2)


class Stage(nn.Sequential):
    """A level's transformer blocks: the residual each block leaves pending
    goes into the next block's first norm (``TransformerBlock.add_forward``),
    and only the stage's last add is a plain one."""

    def forward(self, x):
        residual = None
        for block in self:
            x, residual = block.add_forward(x, residual)
        return x if residual is None else x + residual


def _stage(channels: int, heads: int, n: int, expansion: float) -> Stage:
    return Stage(*[TransformerBlock(channels, heads, expansion) for _ in range(n)])


class Restormer(nn.Module):
    """NCHW ``[B, inp_channels, H, W]`` in [0, 1], H and W multiples of 8 →
    ``[B, out_channels, H, W]`` (the input plus the predicted residual; not
    clipped)."""

    # parameter-name suffixes that stay float32 in a serving copy cast to bf16
    FLOAT32_PARAMS = (".norm1.body.weight", ".norm2.body.weight", ".attn.temperature")

    def __init__(self, inp_channels: int = 1, out_channels: int = 1, dim: int = 48,
                 num_blocks: Sequence[int] = (4, 6, 6, 8),
                 num_refinement_blocks: int = 4, heads: Sequence[int] = (1, 2, 4, 8),
                 ffn_expansion_factor: float = 2.66,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        d = [dim * 2 ** i for i in range(4)]
        e = ffn_expansion_factor
        self.patch_embed = nn.Module()
        self.patch_embed.proj = Conv(inp_channels, dim, 3)
        self.encoder_level1 = _stage(d[0], heads[0], num_blocks[0], e)
        self.down1_2 = Resample(d[0], down=True)
        self.encoder_level2 = _stage(d[1], heads[1], num_blocks[1], e)
        self.down2_3 = Resample(d[1], down=True)
        self.encoder_level3 = _stage(d[2], heads[2], num_blocks[2], e)
        self.down3_4 = Resample(d[2], down=True)
        self.latent = _stage(d[3], heads[3], num_blocks[3], e)
        self.up4_3 = Resample(d[3], down=False)
        self.reduce_chan_level3 = Conv(d[3], d[2], 1)
        self.decoder_level3 = _stage(d[2], heads[2], num_blocks[2], e)
        self.up3_2 = Resample(d[2], down=False)
        self.reduce_chan_level2 = Conv(d[2], d[1], 1)
        self.decoder_level2 = _stage(d[1], heads[1], num_blocks[1], e)
        self.up2_1 = Resample(d[1], down=False)
        self.decoder_level1 = _stage(d[1], heads[0], num_blocks[0], e)
        self.refinement = _stage(d[1], heads[0], num_refinement_blocks, e)
        self.output = Conv(d[1], out_channels, 3)
        self.dtype = dtype

    @property
    def dtype(self) -> Optional[torch.dtype]:
        return self._dtype

    @dtype.setter
    def dtype(self, dt: Optional[torch.dtype]) -> None:
        self._dtype = dt
        for m in self.modules():
            if isinstance(m, Conv):
                m.compute_dtype = dt

    def forward(self, x):
        if x.shape[2] % 8 or x.shape[3] % 8:
            raise ValueError(f"Restormer needs H and W divisible by 8 (three "
                             f"PixelUnshuffle levels); got {tuple(x.shape[2:])}")
        count("restormer.tiles", x.shape[0])
        dev = x.device

        def stage(name, blocks, z):
            with span(f"restormer.{name}", dev):
                return blocks(z)

        e1 = stage("enc1", self.encoder_level1, self.patch_embed.proj(x))
        e2 = stage("enc2", self.encoder_level2, self.down1_2(e1))
        e3 = stage("enc3", self.encoder_level3, self.down2_3(e2))
        lat = stage("latent", self.latent, self.down3_4(e3))
        d3 = self.reduce_chan_level3(torch.cat([self.up4_3(lat), e3], 1))
        d3 = stage("dec3", self.decoder_level3, d3)
        d2 = self.reduce_chan_level2(torch.cat([self.up3_2(d3), e2], 1))
        d2 = stage("dec2", self.decoder_level2, d2)
        d1 = stage("dec1", self.decoder_level1, torch.cat([self.up2_1(d2), e1], 1))
        r = stage("refine", self.refinement, d1)
        return self.output(r) + x
