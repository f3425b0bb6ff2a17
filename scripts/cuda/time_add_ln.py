"""Restormer's add-and-norm kernel (``csrc/add_layer_norm.cu``) on the card, at
the shapes of an E2 burst: its device time beside its byte bound, the time
of its plain version (``ops/layer_norm.py::add_ln_reference``) and of the
blocks' old ops (the add, then ``BiasFreeLayerNorm.forward``'s six plain ops,
on NCHW channels_last), a call each and summed over a burst's 792 calls.

    python3 scripts/cuda/time_add_ln.py [--out build/add_ln_timing.json]

bf16, as the Restormer cell serves. Each call is timed queued behind a sleep
kernel between CUDA events (``chip_smoke.queued_ms``), and each launch takes
the next set of inputs of a ring larger than the 50 MB L2 cache, as the
forward finds its activations: cold.
"""
from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
CHUNKS = 9  # 8-tile chunks of 352² in an E2 burst
TILES = 8
# (stage, channels, side, blocks) of a 352² tile's forward
STAGES = [("enc1", 48, 352, 4), ("enc2", 96, 176, 6), ("enc3", 192, 88, 6),
          ("latent", 384, 44, 8), ("dec3", 192, 88, 6), ("dec2", 96, 176, 6),
          ("dec1", 96, 352, 4), ("refine", 96, 352, 4)]
RING_BYTES = 256e6
REPS = 40


def _ring(call, sets):
    it = itertools.cycle(sets)
    return lambda: call(*next(it))


def time_shape(c: int, side: int, queued_ms) -> dict:
    """Device ms a call at ``TILES`` × side² × c, with and without a
    residual, of the kernel, its plain version and the old ops."""
    import torch

    from image_denoising_tpu_torch.models.restormer import BiasFreeLayerNorm
    from image_denoising_tpu_torch.ops.layer_norm import add_ln, add_ln_reference

    dev = torch.device("cuda")
    shape = (TILES, side, side, c)
    numel = TILES * side * side * c
    k = max(2, -(-int(RING_BYTES) // (4 * 2 * numel)))
    g = torch.Generator(device=dev).manual_seed(c * side)
    sets = [tuple(torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
                  for _ in range(2)) for _ in range(k)]
    norm = BiasFreeLayerNorm(c).to(dev)
    w = norm.weight.detach()

    def old(x, r):
        s = x.permute(0, 3, 1, 2) + r.permute(0, 3, 1, 2)
        return s, norm(s)

    with torch.inference_mode():
        out = {
            "kernel_ms": queued_ms(_ring(lambda x, r: add_ln(x, w, r), sets), REPS),
            "kernel_alone_ms": queued_ms(_ring(lambda x, r: add_ln(x, w), sets), REPS),
            "plain_ms": queued_ms(_ring(lambda x, r: add_ln_reference(x, w, r), sets), REPS),
            "old_ms": queued_ms(_ring(old, sets), REPS),
            "old_alone_ms": queued_ms(_ring(lambda x, r: norm(x.permute(0, 3, 1, 2)), sets),
                                      REPS),
        }
    out["bound_ms"] = 4 * 2 * numel / PEAK_BYTES_S * 1e3  # read x, r; write s, y
    out["bound_alone_ms"] = 2 * 2 * numel / PEAK_BYTES_S * 1e3  # read x; write y
    out["kernel_tb_s"] = 4 * 2 * numel / out["kernel_ms"] * 1e-9
    return out


def burst(per_shape: dict) -> dict:
    """Each time summed over an E2 burst: a stage of n blocks makes 2n - 1
    calls with a residual and one without, in each of its chunks."""
    keys = [("kernel_ms", "kernel_alone_ms"), ("plain_ms", "plain_ms"),
            ("old_ms", "old_alone_ms"), ("bound_ms", "bound_alone_ms")]
    out = {k: 0.0 for k, _ in keys}
    calls = 0
    for _, c, side, n in STAGES:
        t = per_shape[f"{c}x{side}"]
        for res, alone in keys:
            out[res] += CHUNKS * ((2 * n - 1) * t[res] + t[alone])
        calls += CHUNKS * 2 * n
    out["calls"] = calls
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default="build/add_ln_timing.json")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("time_add_ln: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from chip_smoke import queued_ms

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    shapes = sorted({(c, side) for _, c, side, _ in STAGES})
    per_shape = {f"{c}x{side}": time_shape(c, side, queued_ms) for c, side in shapes}
    result = {"card": card, "torch": torch.__version__, "per_call": per_shape,
              "burst": burst(per_shape)}
    print(json.dumps(result, indent=1))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
