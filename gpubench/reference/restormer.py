"""Restormer in plain PyTorch, on a state dict: the yardstick's transformer.

Written from the equations of Zamir et al., "Restormer: Efficient
Transformer for High-Resolution Image Restoration" (CVPR 2022), at the
grayscale Gaussian-denoising configuration of
``Denoising/Options/GaussianGrayDenoising_Restormer.yml``. Keys are the
upstream state-dict names (``basicsr/models/archs/restormer_arch.py``), so
the released weights would load as they are. Every conv has no bias.

* LN (BiasFree), at each pixel over the C channels: z / √(Var_c z + 1e-5)
  ⊙ w, the variance biased; z is divided, not centred.
* MDTA(C, h): q, k, v = split₃(DW3×3(Conv1×1(C→3C)(LN₁ z))); per head q and
  k are (C/h) × HW and each row is divided by max(‖row‖₂, 1e-12) over HW;
  A = softmax over rows of τ_head · q̂ k̂ᵀ; z ← z + Conv1×1(A v).
* GDFN(C), hid = ⌊2.66·C⌋: u₁, u₂ = split₂(DW3×3(Conv1×1(C→2·hid)(LN₂ z)));
  z ← z + Conv1×1(hid→C)(GELU_erf(u₁) ⊙ u₂).
* Down: PixelUnshuffle₂(Conv3×3(C→C/2)); Up: PixelShuffle₂(Conv3×3(C→2C));
  each concatenation is [upsampled, skip].
* The network: f₀ = Conv3×3(1→dim)(x); encoder levels of ``num_blocks``
  blocks at dim, 2·dim, 4·dim and the latent at 8·dim; decoder levels 3 and
  2 after a 1×1 reduce of the concatenation, level 1 at 2·dim with no
  reduce; ``num_refinement_blocks`` more at 2·dim; out = Conv3×3(2·dim→1)
  + x.

This file imports nothing of the program. The benchmark runs it in float32
with TF32 off to judge what the program returned, and as the controls: in
fp8 (every conv and attention product's operands rounded, ``precision.py``),
with a centred LayerNorm (``centred=True``), and with τ dropped
(``tau=False``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .precision import round_fp8

LN_EPS = 1e-5
NORM_EPS = 1e-12
# the controls: ``forward``'s arguments that put each in the program's place
CONTROLS = {"fp8": {"precision": "fp8"}, "centred_ln": {"centred": True},
            "no_tau": {"tau": False}}
# the output conv's gain over torch's default draw: with it, and its taps
# summing to zero, the residual (out − x) over the SEM-like frame pool has a
# mean near 0 and a standard deviation near 25 levels, as a trained
# denoiser's would under σ = 25 noise
OUTPUT_GAIN = 1.5


def level_dims(cfg):
    """Channels of each encoder level: dim, 2·dim, 4·dim, 8·dim."""
    return [cfg["dim"] * 2 ** i for i in range(4)]


def hidden(cfg, c: int) -> int:
    return int(c * cfg["ffn_expansion_factor"])


def stages(cfg):
    """The transformer stages in forward order: (name, state-dict prefix,
    channels, heads, blocks, level), level 0 at full resolution."""
    d, h, n = level_dims(cfg), cfg["heads"], cfg["num_blocks"]
    return [("enc1", "encoder_level1", d[0], h[0], n[0], 0),
            ("enc2", "encoder_level2", d[1], h[1], n[1], 1),
            ("enc3", "encoder_level3", d[2], h[2], n[2], 2),
            ("latent", "latent", d[3], h[3], n[3], 3),
            ("dec3", "decoder_level3", d[2], h[2], n[2], 2),
            ("dec2", "decoder_level2", d[1], h[1], n[1], 1),
            ("dec1", "decoder_level1", d[1], h[0], n[0], 0),
            ("refine", "refinement", d[1], h[0], cfg["num_refinement_blocks"], 0)]


def block_specs(cfg, prefix: str, c: int, heads: int):
    """(key, shape) of one transformer block's parameters."""
    hid = hidden(cfg, c)
    return [(f"{prefix}.norm1.body.weight", (c,)),
            (f"{prefix}.attn.temperature", (heads, 1, 1)),
            (f"{prefix}.attn.qkv.weight", (3 * c, c, 1, 1)),
            (f"{prefix}.attn.qkv_dwconv.weight", (3 * c, 1, 3, 3)),
            (f"{prefix}.attn.project_out.weight", (c, c, 1, 1)),
            (f"{prefix}.norm2.body.weight", (c,)),
            (f"{prefix}.ffn.project_in.weight", (2 * hid, c, 1, 1)),
            (f"{prefix}.ffn.dwconv.weight", (2 * hid, 1, 3, 3)),
            (f"{prefix}.ffn.project_out.weight", (c, hid, 1, 1))]


def param_specs(cfg):
    """Every parameter's (key, shape), in the upstream module's order."""
    d = level_dims(cfg)
    st = {name: (prefix, c, h, n) for name, prefix, c, h, n, _ in stages(cfg)}

    def blocks(name):
        prefix, c, h, n = st[name]
        return [s for i in range(n) for s in block_specs(cfg, f"{prefix}.{i}", c, h)]

    specs = [("patch_embed.proj.weight", (d[0], cfg["inp_channels"], 3, 3))]
    specs += blocks("enc1") + [("down1_2.body.0.weight", (d[0] // 2, d[0], 3, 3))]
    specs += blocks("enc2") + [("down2_3.body.0.weight", (d[1] // 2, d[1], 3, 3))]
    specs += blocks("enc3") + [("down3_4.body.0.weight", (d[2] // 2, d[2], 3, 3))]
    specs += blocks("latent") + [("up4_3.body.0.weight", (2 * d[3], d[3], 3, 3)),
                                 ("reduce_chan_level3.weight", (d[2], d[3], 1, 1))]
    specs += blocks("dec3") + [("up3_2.body.0.weight", (2 * d[2], d[2], 3, 3)),
                               ("reduce_chan_level2.weight", (d[1], d[2], 1, 1))]
    specs += blocks("dec2") + [("up2_1.body.0.weight", (2 * d[1], d[1], 3, 3))]
    specs += blocks("dec1") + blocks("refine")
    specs.append(("output.weight", (cfg["out_channels"], d[1], 3, 3)))
    return specs


def make_weights(cfg, seed: int, device) -> dict:
    """float32 weights from ``seed``: one uniform draw in ±1 on ``device``
    fills every tensor. Conv weights are torch's default range, ±fan_in^-½
    (the output conv times ``OUTPUT_GAIN``, less its mean over the 3×3 taps,
    so that a feature's constant level adds no offset to the residual);
    LayerNorm weights 1 ± 0.25 and temperatures in [1, 4], so that dropping
    either changes the answer.
    The same seed and device give the same weights."""
    dev = torch.device(device)
    specs = param_specs(cfg)
    sizes = [int(torch.Size(shape).numel()) for _, shape in specs]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed % 2 ** 63)
    flat = torch.empty(sum(sizes), device=dev).uniform_(-1.0, 1.0, generator=gen)
    sd = {}
    for (key, shape), u in zip(specs, torch.split(flat, sizes)):
        u = u.view(shape)
        if key.endswith(".body.weight") and len(shape) == 1:
            sd[key] = 1.0 + 0.25 * u
        elif key.endswith(".temperature"):
            sd[key] = 2.5 + 1.5 * u
        else:
            w = u * (shape[1] * shape[2] * shape[3]) ** -0.5
            if key == "output.weight":
                w = OUTPUT_GAIN * (w - w.mean((2, 3), keepdim=True))
            sd[key] = w
    return sd


def _operands(precision: str):
    if precision == "float32":
        return lambda t: t
    if precision == "fp8":
        return round_fp8
    raise ValueError(f"no such precision: {precision!r}")


def forward(sd, x, cfg, precision: str = "float32", centred: bool = False,
            tau: bool = True):
    """NCHW ``[B, inp_channels, H, W]`` in [0, 1], H and W multiples of 8 →
    ``[B, out_channels, H, W]``, float32.

    ``precision``: every conv's and attention product's operands as they
    are (``float32``) or rounded to per-tensor fp8 (``fp8``). ``centred``:
    the LayerNorm subtracts the channel mean first. ``tau``: False drops
    the temperatures.
    """
    rnd = _operands(precision)

    def conv(h, key, groups=1):
        w = sd[key]
        return F.conv2d(rnd(h), rnd(w), None, padding=w.shape[-1] // 2, groups=groups)

    def layer_norm(z, key):
        if centred:
            z = z - z.mean(1, keepdim=True)
        var = z.var(1, keepdim=True, unbiased=False)
        return z / torch.sqrt(var + LN_EPS) * sd[key].view(1, -1, 1, 1)

    def mdta(z, p, heads):
        b, c, h, w = z.shape
        y = conv(layer_norm(z, f"{p}.norm1.body.weight"), f"{p}.attn.qkv.weight")
        y = conv(y, f"{p}.attn.qkv_dwconv.weight", groups=3 * c)
        q, k, v = (t.reshape(b, heads, c // heads, h * w) for t in y.chunk(3, 1))
        q = q / q.norm(dim=-1, keepdim=True).clamp_min(NORM_EPS)
        k = k / k.norm(dim=-1, keepdim=True).clamp_min(NORM_EPS)
        logits = rnd(q) @ rnd(k).transpose(-2, -1)
        if tau:
            logits = logits * sd[f"{p}.attn.temperature"].view(1, heads, 1, 1)
        out = (rnd(torch.softmax(logits, dim=-1)) @ rnd(v)).reshape(b, c, h, w)
        return z + conv(out, f"{p}.attn.project_out.weight")

    def gdfn(z, p):
        c2 = sd[f"{p}.ffn.dwconv.weight"].shape[0]
        y = conv(layer_norm(z, f"{p}.norm2.body.weight"), f"{p}.ffn.project_in.weight")
        u1, u2 = conv(y, f"{p}.ffn.dwconv.weight", groups=c2).chunk(2, 1)
        return z + conv(F.gelu(u1) * u2, f"{p}.ffn.project_out.weight")

    st = {name: (prefix, h, n) for name, prefix, _, h, n, _ in stages(cfg)}

    def stage(z, name):
        prefix, heads, n = st[name]
        for i in range(n):
            z = gdfn(mdta(z, f"{prefix}.{i}", heads), f"{prefix}.{i}")
        return z

    def down(z, key):
        return F.pixel_unshuffle(conv(z, key), 2)

    def up(z, key):
        return F.pixel_shuffle(conv(z, key), 2)

    e1 = stage(conv(x, "patch_embed.proj.weight"), "enc1")
    e2 = stage(down(e1, "down1_2.body.0.weight"), "enc2")
    e3 = stage(down(e2, "down2_3.body.0.weight"), "enc3")
    lat = stage(down(e3, "down3_4.body.0.weight"), "latent")
    d3 = stage(conv(torch.cat([up(lat, "up4_3.body.0.weight"), e3], 1),
                    "reduce_chan_level3.weight"), "dec3")
    d2 = stage(conv(torch.cat([up(d3, "up3_2.body.0.weight"), e2], 1),
                    "reduce_chan_level2.weight"), "dec2")
    d1 = stage(torch.cat([up(d2, "up2_1.body.0.weight"), e1], 1), "dec1")
    return conv(stage(d1, "refine"), "output.weight") + x
