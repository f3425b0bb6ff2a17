#!/usr/bin/env python3
"""The port's trainers shown to learn, on the card.

Counterpart of ``scripts/tpu_n2n_convergence.py``: train on 16 seeded 128²
frames (noisy = clean + N(0, 25)), snapshot every quarter of the run, score
each snapshot with the whole-frame evaluator (E1, float32) and hold the PSNR
trajectory against the noisy input's. Three legs on the same data:

* ``n2n`` — the JAX script's run flag for flag: ``cli.train --loss n2n
  --noisetype gauss25 --subsampler pallas --n_feature 16 --n_epoch 60
  --batchsize 4 --n_snapshot 15 --log_name UNET_n2n_convergence`` (the UNet,
  the sub-sampler kernel once a step on the card).
* ``structure_float32`` / ``structure_bfloat16`` — the main path's trainer:
  ``cli.train`` with the default structure loss, ``--log_name
  UNetImproved_convergence --n_feature 48``, the same epochs and snapshots,
  once in float32 and once with ``--dtype bfloat16``.

A leg passes when its final PSNR is above the noisy input's by more than
1 dB and at most 0.2 dB below its first snapshot's (the JAX script's test).

    python scripts/cuda/convergence.py [--n_epoch 60] [--hw 128] [--device cpu]

prints one JSON line per leg: noisy PSNR, PSNR by epoch, final gain, pass.
It imports the port and never JAX. On the card TF32 is off, so float32
means float32.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_FRAMES, SIGMA = 16, 25.0
# (leg, --log_name, extra train flags); n_feature is added per leg
LEGS = (
    ("n2n", "UNET_n2n_convergence",
     ["--loss", "n2n", "--noisetype", "gauss25", "--subsampler", "pallas"]),
    ("structure_float32", "UNetImproved_convergence", []),
    ("structure_bfloat16", "UNetImproved_convergence", ["--dtype", "bfloat16"]),
)
N_FEATURE = {"n2n": 16, "structure_float32": 48, "structure_bfloat16": 48}
GAIN_DB, DROP_DB = 1.0, 0.2


def make_dataset(root: str, n: int, hw: int, sigma: float = 25.0):
    """Clean structured frames; noisy = clean + N(0, sigma) (gauss25 —
    the same distribution the n2n trainer re-draws per step)."""
    from PIL import Image

    os.makedirs(os.path.join(root, "clean"), exist_ok=True)
    os.makedirs(os.path.join(root, "noise"), exist_ok=True)
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:hw, 0:hw]
    for i in range(n):
        f1, f2 = 5 + (i % 5) * 2, 9 + (i % 3) * 4
        clean = (
            120
            + 55 * np.sin(xx / f1 + i)
            + 45 * np.cos(yy / f2 - 0.5 * i)
            + 25 * (((yy + 8 * i) // 20 + xx // 20) % 2)
        ).clip(0, 255).astype(np.uint8)
        noisy = np.clip(
            clean.astype(np.float32) + rng.normal(0, sigma, clean.shape),
            0, 255,
        ).astype(np.uint8)
        Image.fromarray(clean).save(f"{root}/clean/n2n_{i:02d}.png")
        Image.fromarray(noisy).save(f"{root}/noise/n2n_{i:02d}.png")


def noisy_psnr(root: str) -> float:
    """Mean PSNR of the noisy frames against the clean ones."""
    from PIL import Image

    sys.path.insert(0, REPO)
    from image_denoising_tpu_torch.metrics import calculate_psnr

    psnrs = []
    for cp in sorted(glob.glob(os.path.join(root, "clean", "*.png"))):
        c = np.asarray(Image.open(cp), np.uint8)
        n = np.asarray(Image.open(cp.replace(os.sep + "clean" + os.sep,
                                             os.sep + "noise" + os.sep)), np.uint8)
        psnrs.append(calculate_psnr(n, c))
    return float(np.mean(psnrs))


def snapshot_every(n_epoch: int) -> int:
    return max(n_epoch // 4, 1)


def passed(noisy: float, psnr_by_epoch: dict) -> bool:
    """The JAX script's test: the last snapshot beats the noisy input by
    more than ``GAIN_DB`` and is at most ``DROP_DB`` below the first."""
    traj = [psnr_by_epoch[e] for e in sorted(psnr_by_epoch, key=int)]
    return bool(traj[-1] > noisy + GAIN_DB and traj[-1] >= traj[0] - DROP_DB)


def run_leg(leg: str, root: str, work: str, *, n_epoch: int = 60, device: str = "cuda",
            noisy: float | None = None) -> dict:
    """Train one leg on ``root``'s pairs under ``work``, score every
    snapshot with E1 and return its result: the JSON line's fields, the
    leg's seconds and the path of its final checkpoint."""
    sys.path.insert(0, REPO)
    from image_denoising_tpu_torch.cli import evaluation as eval_cli
    from image_denoising_tpu_torch.cli import train as train_cli

    log_name, extra = next((ln, ex) for name, ln, ex in LEGS if name == leg)
    nf = str(N_FEATURE[leg])
    snap = snapshot_every(n_epoch)
    save_root = os.path.join(work, leg)
    dev = ["--device", device]
    t0 = time.perf_counter()
    train_cli.main(["--data_dir", root, "--save_model_path", save_root,
                    "--log_name", log_name, "--n_feature", nf,
                    "--n_epoch", str(n_epoch), "--batchsize", "4",
                    "--n_snapshot", str(snap)] + extra + dev)
    train_s = time.perf_counter() - t0
    traj, final_ckpt = {}, None
    for ck in sorted(glob.glob(os.path.join(save_root, "**", "epoch_model_*.ckpt"),
                               recursive=True)):
        epoch = int(os.path.basename(ck).split("_")[-1].split(".")[0])
        if epoch == 0 or epoch % snap:
            continue
        avg = eval_cli.main(["--data_dir", root, "--checkpoint", ck,
                             "--save_dir", os.path.join(work, f"eval_{leg}_{epoch}"),
                             "--n_feature", nf, "--log_name", log_name,
                             "--save_images", "none"] + dev)
        traj[epoch] = float(avg["psnr"])
        final_ckpt = ck
    epochs = sorted(traj)
    noisy = noisy_psnr(root) if noisy is None else noisy
    final = traj[epochs[-1]]
    return {
        "kind": "convergence", "leg": leg, "log_name": log_name,
        "n_feature": int(nf), "n_epoch": n_epoch, "noisy_psnr": noisy,
        "psnr_by_epoch": {str(e): traj[e] for e in epochs},
        "final_gain_db": final - noisy,
        "pass": passed(noisy, traj),
        "train_seconds": train_s, "seconds": time.perf_counter() - t0,
        "final_ckpt": final_ckpt,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n_epoch", type=int, default=60)
    ap.add_argument("--hw", type=int, default=128,
                    help="frame size (a multiple of 64 for the UNet's N2N)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("convergence: no CUDA device (pass --device cpu for the CPU)",
                  file=sys.stderr)
            return 1
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as work:
        root = os.path.join(work, "data")
        make_dataset(root, N_FRAMES, args.hw, SIGMA)
        noisy = noisy_psnr(root)
        ok = True
        for leg, _, _ in LEGS:
            res = run_leg(leg, root, work, n_epoch=args.n_epoch, device=args.device,
                          noisy=noisy)
            ok &= res["pass"]
            print(json.dumps({k: v for k, v in res.items() if k != "final_ckpt"}),
                  flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
