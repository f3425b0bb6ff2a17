#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--json build/chip_smoke.json]

Phases (any failure exits non-zero; nothing falls back to the CPU):
  1. device  — the card's name and power limit.
  2. build   — nvcc builds csrc/fused_block.cu for sm_90a (seconds printed).
  3. kernels — fused_rdb_chain's CUDA kernel against its plain PyTorch version
               (fused_rdb_chain_reference, TF32 off) at the 9 chain shapes of
               the main path (B=8 tiles of 352², ImprovedUNet-48), in float32
               and bfloat16; per-shape times (CUDA events, median) and bounds.
  4. main    — the E2 serving path: ImprovedUNet-48 (seeded init) through
               make_tiled_pyramid_runner_frames(make_fused_forward(model), 8,
               704, 704, 352, 64, batch=-8, out_dtype="uint8_floor") on 3
               bursts of 8 seeded 704² uint8 frames, in float32 and bfloat16;
               launch counts asserted (9 chains × 9 chunks per burst); output
               held against the same runner over the per-conv module forward,
               in float32 and in the same dtype; end-to-end MP/s from host
               frames to host uint8 frames.
Prints the card line, a {"kernels": [...]} line, and last
{"ok": true, "device": {...}}. Per-shape details go to the --json file.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

B, TILE, FRAME, OVERLAP, NF = 8, 352, 704, 64, 48
BURSTS = 3  # timed bursts per dtype on the main path
# bf16 fused output against the per-conv forward in f32 and in bf16, in
# uint8 levels: largest and mean difference allowed. Seeds 0 and 1 read at
# most 5 and 0.71 on an H100 (PERF.md)
BF16_MAX_LEVELS, BF16_MEAN_LEVELS = 8, 1.0
GROWTH, N_GROWTH = 32, 4
HBM_BYTES_PER_S = 3.35e12
# H100 SXM dense peaks (NVIDIA data sheet): f32 on the CUDA cores, bf16 on
# the tensor cores — the rate for the type of the kernel's inputs
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# (name, H, Cin, nf, lead) of the 9 level blocks at n_feature 48, B=8
CHAIN_SHAPES = [
    ("down0", 352, 2, 48, True), ("down1", 176, 48, 96, True),
    ("down2", 88, 96, 192, True), ("down3", 44, 192, 384, True),
    ("bottle", 22, 384, 384, False),
    ("up0", 44, 576, 192, True), ("up1", 88, 288, 96, True),
    ("up2", 176, 144, 48, True), ("up3", 352, 72, 24, True),
]
SOURCE = "image_denoising_tpu_torch/csrc/fused_block.cu"
REPLACES = "image_denoising_tpu/ops/fused_block_pallas.py:241"  # fused_rdb_chain


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, warmup: int = 1, reps: int = 5) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def chain_work(h: int, cin: int, nf: int, lead: bool, itemsize: int):
    """(FLOPs, bytes) one chain call needs at batch B: 2 per multiply-add;
    x, weights and biases read once, rdb_out and c0 written once."""
    px = B * h * h
    macs_w = (9 * cin * nf if lead else 0) + sum(
        9 * (nf + i * GROWTH) * GROWTH for i in range(N_GROWTH))
    macs_w += (nf + N_GROWTH * GROWTH) * nf + 9 * nf * nf
    params = macs_w + (nf if lead else 0) + N_GROWTH * GROWTH + nf
    nbytes = (px * (cin if lead else nf) + params + 2 * px * nf) * itemsize
    return 2 * px * macs_w, nbytes


def random_chain(rng, cin, nf, lead, dtype):
    """Chain weights with torch's default conv init scale, from numpy."""
    import torch

    from image_denoising_tpu_torch.ops.fused_block import FusedChainWeights

    def t(shape, fan_in):
        bound = fan_in ** -0.5
        a = rng.uniform(-bound, bound, shape).astype("float32")
        return torch.from_numpy(a).to("cuda", dtype)

    growth_w = [t((3, 3, nf + i * GROWTH, GROWTH), 9 * (nf + i * GROWTH))
                for i in range(N_GROWTH)]
    growth_b = [t((GROWTH,), 9 * (nf + i * GROWTH)) for i in range(N_GROWTH)]
    cat = nf + N_GROWTH * GROWTH
    return FusedChainWeights(
        t((3, 3, cin, nf), 9 * cin) if lead else None,
        t((nf,), 9 * cin) if lead else None,
        growth_w, growth_b, t((cat, nf), cat), t((nf,), cat),
        t((3, 3, nf, nf), 9 * nf))


def phase_kernels(seed: int):
    import numpy as np
    import torch

    from image_denoising_tpu_torch.ops.fused_block import (
        fused_rdb_chain, fused_rdb_chain_reference)

    rng = np.random.default_rng(seed)
    results = {}
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        rows = []
        for name, h, cin, nf, lead in CHAIN_SHAPES:
            x = torch.from_numpy(
                rng.standard_normal((B, h, h, cin)).astype("float32")).to("cuda", dt)
            wts = random_chain(rng, cin, nf, lead, dt)
            got = fused_rdb_chain(x, wts)
            want = fused_rdb_chain_reference(x, wts)
            torch.cuda.synchronize()
            err, scale = 0.0, 0.0
            for g, w in zip(got, want):
                assert g.shape == w.shape == (B, h, h, nf) and g.dtype == dt
                assert torch.isfinite(g.float()).all()
                err = max(err, (g.float() - w.float()).abs().max().item())
                scale = max(scale, w.float().abs().max().item())
            # f32: summation order only (≤ 5184-term sums, 6 convs deep);
            # bf16: one rounding per stored value, as the reference; a flip
            # is one ulp (≤ 2^-7 of the value): 4 ulps of the largest output
            tol = (1e-4 * max(1.0, scale) if dname == "float32"
                   else 4 * 2.0 ** -7 * scale)
            del got, want
            ms = time_ms(lambda: fused_rdb_chain(x, wts))
            plain_ms = time_ms(lambda: fused_rdb_chain_reference(x, wts))
            flops, nbytes = chain_work(h, cin, nf, lead, x.element_size())
            t_ops = flops / PEAK_FLOPS[dname] * 1e3
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            row = dict(name=name, h=h, cin=cin, nf=nf, lead=lead,
                       max_abs_err=err, tol=tol, max_abs_ref=scale,
                       ms=ms, plain_ms=plain_ms, gflop=flops / 1e9,
                       mbytes=nbytes / 1e6, bound_ms=max(t_ops, t_bytes),
                       bound_by="operations" if t_ops >= t_bytes else "bytes",
                       tflops=flops / ms / 1e9)
            rows.append(row)
            log(f"[kernels] {dname:8s} {name:6s} B={B} {h}x{h} {cin}->{nf}: "
                f"max_abs_err {err:.3g} (tol {tol:.3g}) kernel {ms:.3f} ms "
                f"plain {plain_ms:.3f} ms bound {row['bound_ms']:.3f} ms "
                f"({row['bound_by']}) {row['tflops']:.2f} TFLOP/s")
            if not err <= tol:
                raise AssertionError(f"{dname} {name}: max_abs_err {err} > {tol}")
            del x, wts
        results[dname] = rows
    return results


def phase_main(seed: int):
    import numpy as np
    import torch

    from image_denoising_tpu_torch.eval.tiled import (
        make_tiled_pyramid_runner_frames, reference_tile_grid)
    from image_denoising_tpu_torch.models import ImprovedUNet, make_fused_forward
    from image_denoising_tpu_torch.ops.fused_block import fused_rdb_chain

    torch.manual_seed(seed)
    model = ImprovedUNet(in_nc=1, out_nc=1, n_feature=NF).eval()
    rng = np.random.default_rng(seed)
    bursts = [rng.integers(0, 256, (B, FRAME, FRAME)).astype(np.uint8)
              for _ in range(BURSTS)]

    def runner(call):
        return make_tiled_pyramid_runner_frames(
            call, B, FRAME, FRAME, TILE, OVERLAP, batch=-B,
            out_dtype="uint8_floor")

    module = model.to("cuda")
    chunk = torch.rand(B, 1, TILE, TILE, device="cuda")
    tiles = B * len(reference_tile_grid(FRAME, FRAME, TILE, TILE - OVERLAP))
    chunks_per_burst = -(-tiles // B)  # 72 tiles in 8-tile chunks: 9

    def warm_up(run):  # cuDNN plans, the kernel library
        run(torch.from_numpy(bursts[0]))[0].cpu()

    def timed_bursts(run):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preds = [run(torch.from_numpy(b))[0].cpu().numpy() for b in bursts]
        return np.stack(preds).astype(np.int16), time.perf_counter() - t0

    def level_diff(a, b):
        d = np.abs(a - b)
        return dict(max_level_diff=int(d.max()), mean_level_diff=float(d.mean()),
                    frac_pixels_diff=float((d > 0).mean()))

    mp = BURSTS * B * FRAME * FRAME / 1e6
    out, module_preds = {}, {}
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        # yardstick: the same runner over the per-conv module forward (cuDNN)
        mod = copy.deepcopy(module).to(dt)
        mod_call = torch.inference_mode()(lambda t, m=mod, d=dt: m(t.to(d)))
        module_ms = time_ms(lambda: mod_call(chunk), reps=3)
        mod_run = runner(mod_call)
        warm_up(mod_run)
        module_preds[dname], module_sec = timed_bursts(mod_run)
        del mod

        fwd = make_fused_forward(model, dtype=dt)
        run = runner(fwd)
        warm_up(run)
        fwd_ms = time_ms(lambda: fwd(chunk), reps=3)
        fused_rdb_chain.launches = 0
        preds, sec = timed_bursts(run)
        launches = fused_rdb_chain.launches
        want = 9 * chunks_per_burst * BURSTS  # 9 level blocks per forward
        if launches != want:
            raise AssertionError(f"{dname}: {launches} chain launches, want {want}")
        assert preds.shape == (BURSTS, B, FRAME, FRAME)
        vs_f32 = level_diff(preds, module_preds["float32"])
        vs_same = level_diff(preds, module_preds[dname])
        out[dname] = dict(launches=launches, seconds=sec, mps=mp / sec,
                          fused_forward_ms_per_chunk=fwd_ms,
                          module_forward_ms_per_chunk=module_ms,
                          module_seconds=module_sec, module_mps=mp / module_sec,
                          **vs_f32, vs_same_dtype_module=vs_same)
        log(f"[main] {dname:8s} {BURSTS} bursts of {B}x{FRAME}^2: "
            f"{sec:.3f} s, {mp / sec:.4f} MP/s end to end (per-conv module: "
            f"{mp / module_sec:.4f}); forward {fwd_ms:.2f} ms per {B}-tile "
            f"chunk (per-conv module: {module_ms:.2f}); chain launches "
            f"{launches}")
        for what, d in {"float32": vs_f32, dname: vs_same}.items():
            log(f"[main] {dname:8s} vs per-conv {what} forward: max "
                f"{d['max_level_diff']} levels, mean {d['mean_level_diff']:.4f}, "
                f"{d['frac_pixels_diff']:.3e} of pixels differ")
        # f32: the kernel and cuDNN differ only in summation order, which can
        # move a blended pixel across one rounding edge. bf16 rounds every
        # stored activation to 8 significant bits, and cuDNN's bf16 forward
        # rounds in another order: both differences are held to the
        # BF16_* limits
        if dname == "float32":
            ok = vs_f32["max_level_diff"] <= 1 and vs_f32["frac_pixels_diff"] <= 1e-3
        else:
            ok = all(d["max_level_diff"] <= BF16_MAX_LEVELS
                     and d["mean_level_diff"] <= BF16_MEAN_LEVELS
                     for d in (vs_f32, vs_same))
        if not ok:
            raise AssertionError(f"{dname} fused path too far from the per-conv "
                                 "forward")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=os.path.join(REPO, "build", "chip_smoke.json"),
                    help="where to write the per-shape details")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        from image_denoising_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {kind}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    so, nvcc_log = _build.build("fused_block.cu")
    build_s = time.perf_counter() - t0
    log(f"[build] {so.name} in {build_s:.2f} s")
    for line in nvcc_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")
    _build.load_fused_block()

    kernels = phase_kernels(args.seed)
    main_path = phase_main(args.seed)

    summary = []
    for dname, rows in kernels.items():
        summary.append(dict(
            name="fused_rdb_chain", dtype=dname, route="cuda", source=SOURCE,
            replaces=REPLACES, launches=main_path[dname]["launches"],
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=sum(r["ms"] for r in rows),
            plain_ms=sum(r["plain_ms"] for r in rows),
            bound_ms=sum(r["bound_ms"] for r in rows),
            bound_by="operations" if all(r["bound_by"] == "operations"
                                         for r in rows) else "bytes",
            library_ms=None))
    os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
    with open(args.json, "w") as f:
        json.dump(dict(device=kind, nvidia_smi=smi, build_seconds=build_s,
                       torch=torch.__version__, cuda=torch.version.cuda,
                       kernels=kernels, main=main_path, summary=summary),
                  f, indent=1)
    log(f"[kernels] ms/plain_ms/bound_ms sum the 9 chain calls of one {B}-tile "
        "chunk; library_ms is null: no single PyTorch call computes the chain")
    log(smi)
    log(json.dumps({"kernels": summary}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
