"""ImprovedUNet in plain PyTorch, on a state dict: the yardstick's network.

The math of the reference's ``arch_unet.py`` ImprovedUNet (lines 422-531):
an optional sigmoid noise-estimator map concatenated to the input, four
down levels of lead conv → LeakyReLU(0.2) → RDB → ResBlock with 2×2
max-pool, an RDB + ResBlock bottleneck, four up levels of conv →
PixelShuffle(2) → skip concat → fuse conv → LeakyReLU → RDB → ResBlock,
and a final conv over the features and the input, then a sigmoid. Keys
are the reference's state-dict names.

This file imports nothing of the program: the benchmark runs it in place
of the program, in float32 with TF32 off, to judge what the program
returned, and in a lower precision as the control (``precision.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

GROWTH, N_GROWTH = 32, 4
SLOPE = 0.2
GN_EPS = 1e-5


def gn_groups(channels: int, groups: int = 32) -> int:
    """The reference's group count: min(32, C), lowered until it divides C."""
    g = min(groups, channels)
    while channels % g:
        g -= 1
    return g


def _rdb_specs(prefix, c):
    out = [(f"{prefix}.convs.{j}", GROWTH, c + j * GROWTH, 3, True)
           for j in range(N_GROWTH)]
    out.append((f"{prefix}.lff", c, c + N_GROWTH * GROWTH, 1, True))
    return out


def _res_specs(prefix, c):
    return [(f"{prefix}.block.0", c, c, 3, False), (f"{prefix}.block.1", c),
            (f"{prefix}.block.3", c, c, 3, False), (f"{prefix}.block.4", c)]


def layer_specs(cfg):
    """Every layer in forward order: ``(key, cout, cin, k, bias)`` for a
    conv, ``(key, channels)`` for a GroupNorm."""
    nc, nf, depth = cfg["n_channel"], cfg["n_feature"], cfg["depth"]
    specs = []
    if cfg["noise"]:
        specs += [("noise_estimator.0", nf, nc, 3, True),
                  ("noise_estimator.2", 1, nf, 3, True)]
    cin = nc + (1 if cfg["noise"] else 0)
    widths = [nf * 2 ** i for i in range(depth)]
    for i, w in enumerate(widths):
        specs.append((f"downs.{i}.0", w, cin, 3, True))
        specs += _rdb_specs(f"downs.{i}.2", w) + _res_specs(f"downs.{i}.3", w)
        cin = w
    specs += _rdb_specs("bottle.0", cin) + _res_specs("bottle.1", cin)
    for i, skip in enumerate(reversed(widths)):
        out = cin // 2
        specs += [(f"ups.{i}.conv_ps", out * 4, cin, 3, True),
                  (f"ups.{i}.fuse", out, out + skip, 3, True)]
        specs += _rdb_specs(f"ups.{i}.rdb", out) + _res_specs(f"ups.{i}.res", out)
        cin = out
    specs.append(("final", nc, cin + nc, 3, True))
    return specs


def make_weights(cfg, seed: int, device) -> dict:
    """float32 weights from ``seed`` with torch's default init: conv weights
    and biases uniform in ±fan_in^-½, GroupNorm weight 1 and bias 0. One
    draw on ``device`` fills every conv tensor; the same seed and device
    give the same weights."""
    dev = torch.device(device)
    convs = [s for s in layer_specs(cfg) if len(s) == 5]
    sizes = []
    for key, cout, cin, k, bias in convs:
        sizes.append(cout * cin * k * k)
        if bias:
            sizes.append(cout)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed % 2 ** 63)
    flat = torch.empty(sum(sizes), device=dev).uniform_(-1.0, 1.0, generator=gen)
    parts = iter(torch.split(flat, sizes))
    sd = {}
    for spec in layer_specs(cfg):
        if len(spec) == 2:
            key, c = spec
            sd[f"{key}.weight"] = torch.ones(c, device=dev)
            sd[f"{key}.bias"] = torch.zeros(c, device=dev)
            continue
        key, cout, cin, k, bias = spec
        scale = (cin * k * k) ** -0.5
        sd[f"{key}.weight"] = next(parts).view(cout, cin, k, k) * scale
        if bias:
            sd[f"{key}.bias"] = next(parts) * scale
    return sd


def _leaky(x):
    return F.leaky_relu(x, SLOPE)


def forward(sd, x, cfg, conv=None):
    """NCHW ``[B, n_channel, H, W]`` in [0, 1] → the same shape in (0, 1).

    ``conv(x, weight, bias, padding)`` computes every convolution
    (default ``F.conv2d`` in the inputs' precision); GroupNorm, the
    activations and the concatenations stay float32.
    """
    conv2d = conv or (lambda a, w, b, p: F.conv2d(a, w, b, padding=p))

    def c(h, key):
        w = sd[f"{key}.weight"]
        return conv2d(h, w, sd.get(f"{key}.bias"), w.shape[-1] // 2)

    def gn(h, key):
        return F.group_norm(h, gn_groups(h.shape[1]), sd[f"{key}.weight"],
                            sd[f"{key}.bias"], GN_EPS)

    def rdb(h, p):
        feats = [h]
        for j in range(N_GROWTH):
            feats.append(_leaky(c(torch.cat(feats, 1), f"{p}.convs.{j}")))
        return h + c(torch.cat(feats, 1), f"{p}.lff")

    def res(h, p):
        r = _leaky(gn(c(h, f"{p}.block.0"), f"{p}.block.1"))
        return h + gn(c(r, f"{p}.block.3"), f"{p}.block.4")

    nc, depth = cfg["n_channel"], cfg["depth"]
    if cfg["noise"]:
        sigma = torch.sigmoid(c(_leaky(c(x, "noise_estimator.0")), "noise_estimator.2"))
        x = torch.cat([x, sigma], 1)
    orig = x[:, :nc]
    skips = []
    for i in range(depth):
        x = res(rdb(_leaky(c(x, f"downs.{i}.0")), f"downs.{i}.2"), f"downs.{i}.3")
        skips.append(x)
        x = F.max_pool2d(x, 2)
    x = res(rdb(x, "bottle.0"), "bottle.1")
    for i in range(depth):
        x = F.pixel_shuffle(c(x, f"ups.{i}.conv_ps"), 2)
        x = _leaky(c(torch.cat([x, skips[-(i + 1)]], 1), f"ups.{i}.fuse"))
        x = res(rdb(x, f"ups.{i}.rdb"), f"ups.{i}.res")
    return torch.sigmoid(c(torch.cat([x, orig], 1), "final"))
