#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--json build/chip_smoke.json]
    python3 chip_smoke.py --subsample-times CHECKOUT   # one kernel's times
    python3 chip_smoke.py --multidevice-cards          # [multidevice] on 4 cards

Phases (any failure exits non-zero; nothing falls back to the CPU):
  1. device  — the card's name and power limit.
  2. build   — nvcc builds csrc/fused_block.cu, csrc/retrieval.cu and
               csrc/neighbor.cu for sm_90a and g++ the host patch sampler
               csrc/patch_sampler.cpp, all at once (seconds printed).
  3. kernels — each kernel against its plain PyTorch version (TF32 off),
               with its route (wgmma bf16, wgmma s8, 3xTF32 for float32,
               CUDA cores) and the earlier CUDA-core kernel's time (PERF.md):
               fused_rdb_chain at the 9 chain shapes of E2 (B=8 tiles of
               352²) and of E6 (B=8 tiles of 128², down to the 8×8
               bottleneck), and of the finetune path (B=4 tiles of 128², a
               whole 704² frame), in float32 and bfloat16, with the blocks
               of each launch; top1_l2_retrieval on
               seeded device banks of N=105,125 rows of D=16,384 in float32,
               bfloat16 and int8, with B=400, 8 and 4 queries (B=1-4 held to
               the same limits), a duplicated
               row (the first must win), near ties that one TF32 product
               gets wrong and a bank padded to 512 rows (no padded row may
               win); the launch floor (an empty kernel issued back to back);
               subsample_pair at N=4 352² frames, C=1
               float32 (the training shape) and C=3 float32 and bfloat16,
               at N=4 704² C=1 float32 (N2N of the UNet), and at the edge
               shapes 4x1x352x350 (W/2 not a multiple of 4),
               4x3x352x356 bfloat16 (rows not 16-byte aligned) and N=1:
               selectors and sub-images bit-equal, only the 8 listed
               pairs, each within 0.005 of 1/8, same seed same maps, another
               seed other maps, one map for all channels; its device time
               with L2 flushed before each call (held to its byte bound at
               HBM's rate) and with the image in L2 (calls back to back, as
               in the N2N step), and per call issued back to back. Times
               (CUDA events, median; the sub-sampler's device time from
               torch.profiler) and bounds.
  4. main    — the E2 serving path: ImprovedUNet-48 (seeded init) through
               make_tiled_pyramid_runner_frames(make_fused_forward(model), 8,
               704, 704, 352, 64, batch=-8, out_dtype="uint8_floor") on 3
               bursts of 8 seeded 704² uint8 frames, in float32 and bfloat16;
               launch counts asserted (9 chains × 9 chunks per burst); output
               held against the same runner over the per-conv module forward,
               in float32 and in the same dtype; end-to-end MP/s.
  5. memory  — the E6 path at its production preset: ImprovedUNet-48 base
               through make_fused_forward, hyper_gated_fft adapter (hidden
               16, every weight drawn non-zero from the seed), an int8/uint8
               bank of 5 seeded 704² pairs at stride 4 (N = 5·145², padded to
               512), make_tiled_hann_runner_frames(…, 4, 704, 704, ps=128,
               overlap=64, batch=-8, out_dtype="uint8_round", hoisted
               retrieval) on 3 bursts of 4 frames, in float32 and bfloat16;
               burst 1 (the bank's own noisy frames) must retrieve each
               tile's own patch; launch counts asserted (1 retrieval and
               9 × 50 chains per burst); output held against the same runner
               over the per-conv module base and the plain retrieval; one
               burst each with a float32 and a bfloat16 bank; per-layer times
               and end-to-end MP/s.
  6. train   — the N2N training step of ImprovedUNet-48 (seeded init, f32,
               TF32 off) on batches of 4 seeded 352² frames with gauss25
               noise, epoch 1 of 100: 2 warm-up and 10 timed steps, one
               sub-sampler launch each; the same 12 steps with the plain
               sub-sampler must give the same losses (TRAIN_LOSS_RTOL);
               ms/step, MP/s of input frames, per-part times and the busy
               share of one profiled step. Then cli/train.main (--loss n2n,
               1 epoch of 2 steps) on 8 seeded 352² PNG pairs: checkpoints
               and A_log.csv written, 2 launches.
  7. structure — the structure-loss step of ImprovedUNet-48 (seeded init,
               Adam 3e-4, α = 1, β = γ = 0.5, no guard) on batch 4 of
               seeded 352² pairs (noisy = clean + N(0, 25)) as one fused
               batch-8 forward: 2 warm-up and 10 timed steps, losses
               fetched one step late, timed steps under
               torch.cuda.set_sync_debug_mode("error"), in float32 (TF32
               off) and bfloat16 compute; ms/step, MP/s, peak memory and
               share of the bound (bench.py's 4.063 TFLOP over 67 or 989
               TFLOP/s). Checks: the two-forward step's losses within
               TRAIN_LOSS_RTOL, bf16 within JAX's envelope of f32, remat and
               remat_depth=2 within REMAT_LOSS_RTOL at lower peak memory,
               the guarded L1 step skipping a NaN batch bit-exactly, no
               chain launch. One profiled step per dtype and the parts
               alone. Then cli/train.main with its defaults and with
               --dtype bfloat16 --remat_depth 2 --profile_dir, 2 steps each.
  8. hpo     — cli/train_opt.main on 32 seeded 352² grayscale PNG pairs:
               3 trials of 1 tuning epoch (8 guarded L1 steps of
               ImprovedUNet at the TPE's widths, batch 4) and a 2-epoch
               retrain, SQLite storage in a temporary directory; the study
               holds 3 trials, trials.log 3 lines on device 0, every init
               snapshot loads strictly at its trial's width with its w0_sum
               exact, epoch_final_002.ckpt loads strictly, A_log.csv has 2
               finite rows, no kernel launched; a second main with
               --n_trials 1 resumes to 4 trials; trial 0 trained again from
               its snapshot (equal losses or not, reported); seconds per
               trial, the retrain's ms/step (A_log.csv); the guarded L1
               step alone at n_feature 48 and 128 (ms/step with no sync,
               peak GB).
  9. finetune — the B-domain loop: ImprovedUNet-48 (seeded) written as a
               .ckpt and read back (bit-equal forward); the memory finetune
               step at the launcher preset (scripts/finetune_memory.sh:
               batch 4 of 128² patches of the 5 E6 pairs, hyper_gated_fft
               hidden 16, λ_grad = λ_iqsl = 0.1, thresholds from the clean
               frames) against a stride-4 bank of N = 105,125 in float32 and
               in E6's int8/uint8: 2 warm-up and 10 timed steps under
               torch.cuda.set_sync_debug_mode("error"), 9 chain launches and
               1 retrieval launch each; the same 12 steps with the plain
               retrieval and the module base within TRAIN_LOSS_RTOL (int8
               indices bit-equal); base bit-equal after; ms/step, MP/s,
               parts, peak GB, one profiled step's busy share and kernel
               launches. Then cli.finetune, cli.finetune_iqsl and
               cli.finetune_memory for 1 epoch of --patches_per_image 2 (a
               tail batch) over the .ckpt base, each on the native patch
               stream, and the E6 CLI serving the adapter_only .ckpt the
               memory finetuner wrote.
  10. data   — the finetuners' patch stream: the native sampler
               (csrc/patch_sampler.cpp) bit-equal to its plain numpy version
               over every batch of one shuffled epoch at the finetune preset
               (5 seeded 704² uint8 pairs, patch 128, batch 4, 16 patches a
               pair: 20 batches) through DenoisePatchDataset.batches, with 1
               and 4 threads, and at C = 3 frames of 130 x 200, patch 127, a
               tail batch of 2; host ms per batch of the native sampler (4
               threads, and 1), the numpy stream and the plain version at
               batch 4 and 32 of 128², beside [finetune]'s ms/step. Then
               cli.finetune_memory.main with scripts/cuda/finetune_memory.sh's
               flags (read by cli/launchers.py, as the launcher tests read
               them; data, base .ckpt and output swapped, --n_epoch 1: 20
               steps at full width, the float32 stride-4 bank): its first
               batch the plain sampler's batch 0, epoch_adapter_only_001.ckpt
               read back bit-equal, chain and retrieval launches, seconds,
               ms/step from its log, peak GB.
  11. serving — the serving CLIs through their main, with PyTorch's default
               TF32 flags, over 9 seeded 704² pairs (a burst of 8 and a tail
               of 1) and [finetune]'s base and adapters: denoise at its
               defaults (bf16, bursts of 8, host pass inline and in 4
               threads: the same PNGs) and at f32 / -1 / floor, byte-equal to
               E2's PNGs; E1 in f32 within E2's limits of the per-conv
               module's whole-frame forward, in bf16 within them of the f32
               module and no farther from it than the module's own bf16
               forward, and its device metrics against its host path; the
               whole-frame forward timed alone; E2 and E3 at bursts of 8 with IoU: the
               device metrics against the host path (PSNR 1e-3 dB, SSIM 1e-4,
               IoU 1e-6), 4 host workers giving identical lines, metrics.txt
               and PNGs, a --profile_dir trace; E4 and E5 per frame within
               0.01 dB of the output adapter over the per-conv module base;
               E6 at the [memory] preset, device metrics and 4 workers
               likewise; ssim_torch within 1e-4 of the host SSIM; chain and
               retrieval launches counted per run. Frames, seconds, frames/s,
               denoise MP/s, the host pass's s/frame and the device metrics'
               ms per burst.
  12. networks — UNet-48, the blind-spot UNet-48 and RESNET-48 (seeded init)
               through E2's runner over make_forward (cuDNN; bursts of 8
               704² frames, 1 warm-up and 2 timed bursts per dtype): float32
               within 1 level on 1e-3 of pixels of the module in float64
               (2 frames), bfloat16 within E2's limits of float32, MP/s, the
               busy share and top kernels of one profiled burst, no chain
               launch. 12 N2N steps of UNet-48 at batch 4 of 704² (one
               sub-sampler launch each) against the plain sub-sampler's
               (TRAIN_LOSS_RTOL); 12 structure steps of the blind-spot UNet
               (f32 and bf16, bf16 within JAX's envelope) and of RESNET-48
               (f32) at batch 4 of 352², timed under
               set_sync_debug_mode("error"): ms/step, MP/s, peak GB. Then
               cli.train with the blind-spot launcher preset (checkpoint of
               the blind-spot topology), cli.evaluation_704 on it by the same
               log name, cli.denoise --arch RESNET and
               cli.evaluation_704_iqsl_memory --arch UNet over [finetune]'s
               memory adapter (1 retrieval launch a burst, no chain launch).
  13. multidevice — every multi-device path on meshes that repeat the one
               card (make_mesh(devices=["cuda:0"] * k)): the sharded
               retrieval (memory/sharded.py) at the production bank
               (N = 105,125, D = 16,384, int8 and float32) over 2 and 4
               shards at B = 400 and 4, k launches a call, the unsharded
               kernel's indices (int8 bit-equal; a float32 pick that differs
               within f32_pick_tol of the float64 best row), ms a call; E2
               through the pyramid runner with each tile stack split over 2
               (2 bursts of 8 per dtype) within 1 level on 0.1 % of pixels
               of the single-device runner; E6 with the int8 bank sharded
               over 2 and the tiles split (1 burst of 4): patches and output
               equal to the single-device run's; the data-parallel structure
               step over 2 and 3 entries (batch 4), the N2N step over 2 and
               the memory finetune step over the sharded int8 bank, 12 steps
               each within TRAIN_LOSS_RTOL of one device's (and the first
               step's loss and gradient); train --parallel,
               evaluation_704 --parallel, evaluation_704_iqsl_memory
               --parallel --bank_sharded, denoise --parallel and
               finetune_memory --bank_sharded on make_mesh() against the
               runs without the flags (the same files, losses and launches).
Prints the card line, a {"kernels": [...]} line, and last
{"ok": true, "device": {...}}. Per-shape details go to the --json file.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import copy
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

B, TILE, FRAME, OVERLAP, NF = 8, 352, 704, 64, 48
BURSTS = 3  # timed bursts per dtype on each path
# bf16 fused output against the per-conv forward in f32 and in bf16, in
# uint8 levels: largest and mean difference allowed. Seeds 0 and 1 read at
# most 5 and 0.71 on an H100 (PERF.md)
BF16_MAX_LEVELS, BF16_MEAN_LEVELS = 8, 1.0
# E6 adds a float32 adapter on the bf16 base's output and a Hann blend that
# does not clip; seeds 0, 1 and 2 read at most 8 levels and a mean of 1.04
# against the yardstick (PERF.md): limits 1.5 times those readings
E6_BF16_MAX_LEVELS, E6_BF16_MEAN_LEVELS = 12, 1.5
GROWTH, N_GROWTH = 32, 4
# the chain kernel's device functions (csrc/fused_block.cu), as the profiler names them
CHAIN_KERNELS = ("chain_conv_kernel<", "chain_finish_kernel<")
# cuDNN's FFT convolution path: its FFT kernels and the complex GEMM between
# them (names lower-cased)
FFT_KERNELS = ("fft", "cf32", "cgemm")
HBM_BYTES_PER_S = 3.35e12
# H100 SXM dense peaks (NVIDIA data sheet): f32 on the CUDA cores, bf16 and
# int8 on the tensor cores, and float32 as 3xTF32 (three TF32 products on the
# tensor cores at 495 TFLOP/s) — the rate of the route a kernel runs
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12,
            "tf32x3": 495e12 / 3}
# the tensor-core route of each kernel and input type: (name, PEAK_OPS key)
ROUTES = {"float32": ("3xTF32", "tf32x3"), "bfloat16": ("wgmma bf16", "bfloat16"),
          "int8": ("wgmma s8", "int8")}
# the CUDA-core kernels these replaced, as PERF.md records them (NVIDIA H100
# 80GB HBM3, 700 W): per 8-tile chunk of the 9 chain calls at E2 and E6, and
# per retrieval at B = 400 and B = 8. Not measured by this script, so they
# appear in the [kernels] log lines only, never in the kernels result line
EARLIER_CHAIN_MS = {("E2", "float32"): 60.39, ("E2", "bfloat16"): 59.06,
                    ("E6", "float32"): 14.15, ("E6", "bfloat16"): 13.81}
EARLIER_TOP1_MS = {("float32", 400): 42.09, ("bfloat16", 400): 41.17,
                   ("int8", 400): 13.51, ("float32", 8): 7.06,
                   ("bfloat16", 8): 7.03, ("int8", 8): 2.25}
# (name, H, Cin, nf, lead) of the 9 level blocks at n_feature 48
CHAIN_LEVELS = [
    ("down0", 1, 2, 48, True), ("down1", 2, 48, 96, True),
    ("down2", 4, 96, 192, True), ("down3", 8, 192, 384, True),
    ("bottle", 16, 384, 384, False),
    ("up0", 8, 576, 192, True), ("up1", 4, 288, 96, True),
    ("up2", 2, 144, 48, True), ("up3", 1, 72, 24, True),
]


def chain_shapes(tile):
    """The 9 chain shapes (name, H, Cin, nf, lead) for a tile size."""
    return [(n, tile // div, cin, nf, lead) for n, div, cin, nf, lead in CHAIN_LEVELS]


CHAIN_SOURCE = "image_denoising_tpu_torch/csrc/fused_block.cu"
CHAIN_REPLACES = "image_denoising_tpu/ops/fused_block_pallas.py:241"  # fused_rdb_chain
TOP1_SOURCE = "image_denoising_tpu_torch/csrc/retrieval.cu"
TOP1_REPLACES = "image_denoising_tpu/memory/retrieval_pallas.py:101"  # top1_l2_retrieval

# E6 production preset (scripts/eval_704_iqsl_memory_tpu_fast.sh)
E6_TILE, E6_BURST, E6_STRIDE, E6_PAIRS, E6_HIDDEN = 128, 4, 4, 5, 16
E6_GRID = (FRAME - E6_TILE) // E6_STRIDE + 1          # 145 patches per axis
E6_BANK_ROWS = E6_PAIRS * E6_GRID ** 2                # 105,125
PATCH_D = E6_TILE * E6_TILE                            # 16,384
E6_TILES = E6_BURST * ((FRAME - E6_TILE) // (E6_TILE - OVERLAP) + 1) ** 2  # 400
SUB_SOURCE = "image_denoising_tpu_torch/csrc/neighbor.cu"
SUB_REPLACES = "image_denoising_tpu/ops/neighbor_pallas.py:81"  # subsample_pair_pallas
# the N2N trainer's reference geometry (bench.py:29): batch 4 of 352² frames
TRAIN_B, TRAIN_FRAME, TRAIN_WARMUP, TRAIN_STEPS, TRAIN_EPOCHS = 4, 352, 2, 10, 100
VALID_PAIRS = ((0, 1), (0, 2), (1, 3), (2, 3), (1, 0), (2, 0), (3, 1), (3, 2))
PAIR_FREQ_TOL = 0.005  # 5.3 binomial standard deviations at 123,904 cells
# kernel and plain sub-sampler give bit-equal maps and noise, so the two
# runs' losses differ only by the order of cuDNN's backward sums, which Adam
# carries into the next steps
TRAIN_LOSS_RTOL = 1e-3
# the structure step: XLA's count of the fused batch-8 step's work
# (bench.py:73), and the losses of the remat runs against the plain run's
# (recomputation repeats the same ops; cuDNN may pick other algorithms)
STRUCT_FLOP_PER_STEP = 4.0633e12
REMAT_LOSS_RTOL = 1e-3
# bf16 losses against f32 (tests/test_bf16_compute.py:89-92): step 1
# absolute, every step relative
BF16_STEP1_ABS, BF16_REL = 5e-3, 0.15
# integer operations of one cell's draw: 10 Philox rounds of 2 multiplies, 2
# high multiplies, 4 xors and 2 key adds, plus the table look-ups
PHILOX_OPS_PER_CELL = 10 * 10 + 8
# the sub-sampler's shapes: the N2N step's (C = 1 f32) and C = 3 at N = 4,
# 352^2, the UNet's N2N step at N = 4, C = 1, 704^2, then edge shapes: W/2 = 175 (not a multiple of 4), bf16 rows of 712
# bytes (not 16-byte aligned), N = 1
SUB_SHAPES = ((TRAIN_B, 1, TRAIN_FRAME, TRAIN_FRAME, "float32"),
              (TRAIN_B, 3, TRAIN_FRAME, TRAIN_FRAME, "float32"),
              (TRAIN_B, 3, TRAIN_FRAME, TRAIN_FRAME, "bfloat16"),
              (TRAIN_B, 1, FRAME, FRAME, "float32"))  # N2N of the UNet: 704^2 frames
SUB_EDGE_SHAPES = ((TRAIN_B, 1, TRAIN_FRAME, 350, "float32"),
                   (TRAIN_B, 3, TRAIN_FRAME, 356, "bfloat16"),
                   (1, 1, TRAIN_FRAME, TRAIN_FRAME, "float32"))
# bytes read between two timed calls to flush the card's 50 MB L2
L2_FLUSH_BYTES = 256 << 20
# profiler windows kernel_device_ms takes at most to see every timed call
PROFILE_WINDOWS = 3
# the [hpo] phase: cli/train_opt.main on HPO_FRAMES seeded 352^2 grayscale
# pairs (HPO_FRAMES / HPO_B steps a tuning epoch, so that steps and not a
# trial's set-up take most of its time), HPO_TRIALS trials of 1 tuning epoch
# and a retrain of 2 epochs at batch HPO_B; the guarded L1 step timed alone
# at the widths HPO_WIDTHS (48, and the search space's top, 128)
HPO_FRAMES, HPO_TRIALS, HPO_B, HPO_WIDTHS, HPO_STEPS = 32, 3, 4, (48, 128), 5

# the memory finetune step at the launcher preset (scripts/finetune_memory.sh):
# batch 4 of 128² patches, 16 patches per image, hidden 16, Adam 1e-4,
# λ_grad = λ_iqsl = 0.1, IQSL quantiles 0.2 / 0.8, τ 0.1; the queries a step
# retrieves (4, and 1-3 in a tail batch)
FT_B, FT_PATCHES, FT_LR, FT_LAMBDA = 4, 16, 1e-4, 0.1
FT_QUERY_COUNTS = (1, 2, 3, 4)
FT_EMPTY_LAUNCHES = 2000  # empty kernels issued back to back for the floor

# retrieval check: a duplicated bank row (dup_hi := dup_lo), queries that
# sit near no row, where float32 rankings come closest to a tie, and queries
# whose two nearest rows (near_tie_rows, from row TIE_ROW on) are twice the
# float32 tolerance apart
DUP_LO, DUP_HI, N_FAR = 1234, 98765, 6
N_TIE, TIE_ROW, TIE_S = 6, 50000, 0.6


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


def bound(ops: float, nbytes: float, peak: str):
    """(bound_ms, bound_by): the larger of operations over the peak of the
    kernel's route (a ``PEAK_OPS`` key) and bytes over the memory rate."""
    t_ops = ops / PEAK_OPS[peak] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def chain_work(h: int, cin: int, nf: int, lead: bool, itemsize: int, batch: int = B):
    """(FLOPs, bytes) one chain call needs at ``batch``: 2 per multiply-add;
    x, weights and biases read once, rdb_out and c0 written once."""
    px = batch * h * h
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
        bound_ = fan_in ** -0.5
        a = rng.uniform(-bound_, bound_, shape).astype("float32")
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


def phase_chain(seed: int, shapes, label: str, reps: int = 5, batch: int = B):
    """fused_rdb_chain against its plain version at ``shapes``, batch ``batch``."""
    import numpy as np
    import torch

    from image_denoising_tpu_torch.ops.fused_block import (
        chain_conv_plans, fused_rdb_chain, fused_rdb_chain_reference)

    rng = np.random.default_rng(seed)
    results = {}
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        route, peak = ROUTES[dname]
        rows = []
        for name, h, cin, nf, lead in shapes:
            x = torch.from_numpy(
                rng.standard_normal((batch, h, h, cin)).astype("float32")).to("cuda", dt)
            wts = random_chain(rng, cin, nf, lead, dt)
            got = fused_rdb_chain(x, wts)
            want = fused_rdb_chain_reference(x, wts)
            torch.cuda.synchronize()
            err, scale = 0.0, 0.0
            for g, w in zip(got, want):
                assert g.shape == w.shape == (batch, h, h, nf) and g.dtype == dt
                assert torch.isfinite(g.float()).all()
                err = max(err, (g.float() - w.float()).abs().max().item())
                scale = max(scale, w.float().abs().max().item())
            # f32: summation order only (≤ 5184-term sums, 6 convs deep);
            # bf16: one rounding per stored value, as the reference; a flip
            # is one ulp (≤ 2^-7 of the value): 4 ulps of the largest output
            tol = (1e-4 * max(1.0, scale) if dname == "float32"
                   else 4 * 2.0 ** -7 * scale)
            del got, want
            ms = time_ms(lambda: fused_rdb_chain(x, wts), reps=reps)
            plain_ms = time_ms(lambda: fused_rdb_chain_reference(x, wts), reps=reps)
            flops, nbytes = chain_work(h, cin, nf, lead, x.element_size(), batch)
            bound_ms, bound_by = bound(flops, nbytes, peak)
            blocks = {conv: p["blocks"] for conv, p in chain_conv_plans(batch, h, h, cin, wts)}
            row = dict(name=name, h=h, cin=cin, nf=nf, lead=lead, blocks=blocks,
                       max_abs_err=err, tol=tol, max_abs_ref=scale,
                       ms=ms, plain_ms=plain_ms, gflop=flops / 1e9,
                       mbytes=nbytes / 1e6, bound_ms=bound_ms, bound_by=bound_by,
                       tflops=flops / ms / 1e9)
            rows.append(row)
            log(f"[kernels] chain {label} {dname:8s} {name:6s} B={batch} {h}x{h} "
                f"{cin}->{nf}: max_abs_err {err:.3g} (tol {tol:.3g}) kernel "
                f"{ms:.3f} ms plain {plain_ms:.3f} ms bound {bound_ms:.3f} ms "
                f"({bound_by}) {row['tflops']:.2f} TFLOP/s; {route}; blocks per "
                f"launch {list(blocks.values())}")
            if not err <= tol:
                raise AssertionError(f"{label} {dname} {name}: max_abs_err {err} > {tol}")
            del x, wts
        results[dname] = rows
        ms = sum(r["ms"] for r in rows)
        earlier = EARLIER_CHAIN_MS.get((label, dname))
        log(f"[kernels] chain {label} {dname:8s} the 9 calls of one {batch}-tile chunk: "
            f"{ms:.3f} ms on the {route} route"
            + (f" (the CUDA-core kernel: {earlier} ms, PERF.md)" if earlier else "")
            + f"; bound {sum(r['bound_ms'] for r in rows):.3f} ms")
    return results


def _f64_top1(q, bank, rows: int = 8192):
    """Per query: the kernel-independent best and second-best distance
    ‖b‖² − 2q·b in float64 over the whole bank, the best row, and the
    distance of every row (as a callable on picked indices)."""
    import torch

    qd = q.double()
    n = bank.shape[0]
    best = torch.full((q.shape[0], 2), float("inf"), dtype=torch.float64, device=q.device)
    arg = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
    sqn64 = torch.empty(n, dtype=torch.float64, device=q.device)
    for s in range(0, n, rows):
        bd = bank[s : s + rows].double()
        sqn64[s : s + rows] = (bd * bd).sum(1)
        d = sqn64[s : s + rows][None] - 2.0 * (qd @ bd.T)
        cand = torch.cat([best, d], 1)
        vals, idx = torch.topk(cand, 2, dim=1, largest=False, sorted=True)
        # a new best row comes from this chunk when index 0 is past the 2 carried
        new0 = idx[:, 0] >= 2
        arg = torch.where(new0, idx[:, 0] - 2 + s, arg)
        best = vals
        del bd, d, cand

    def dist(picks):
        bp = bank[picks].double()
        return sqn64[picks] - 2.0 * (qd * bp).sum(1)

    return best[:, 0], best[:, 1], arg, dist


def f32_pick_tol(d: int, qn: float, bn: float) -> float:
    """The float32 tolerance on the float64 distance excess of a pick, for
    queries and rows of norms at most ``qn`` and ``bn``: float32 sums of D
    products in sequence err by ≲ √D·2⁻²⁴·Σ|q b| per q·b, doubled in the
    distance; Σ|q b| ≤ ‖q‖‖b‖; a 16× margin."""
    return 16 * d ** 0.5 * 2.0 ** -24 * 2 * qn * bn


def near_tie_rows(q, gap: float, s: float = TIE_S):
    """Two bank rows for each query of ``q`` (float32 ``[k, D]``, entries
    ≥ 0): A = (1 − s)·q and B = (1 + s′)·q, B nearer than A by ``gap`` in
    ‖b‖² − 2q·b. q·B exceeds q·A by about 2s‖q‖², and a product that reads
    float32 as TF32 (the tensor cores drop 13 mantissa bits, each product
    shrinks by ~2⁻¹⁰) overstates B's distance more than A's by some
    2⁻⁹·s‖q‖²: far more than ``gap``, so it picks A."""
    import torch

    qd = q.double()
    s2 = torch.sqrt(s * s - gap / (qd * qd).sum(1, keepdim=True))
    return ((1 - s) * qd).float(), ((1 + s2) * qd).float()


def phase_retrieval(seed: int):
    """top1_l2_retrieval against its plain version at the E6 bank shape."""
    import torch

    from image_denoising_tpu_torch.memory.retrieval import (
        pad_bank_for_retrieval, top1_l2_retrieval, top1_l2_retrieval_reference)

    n, d = E6_BANK_ROWS, PATCH_D
    g = torch.Generator(device="cuda").manual_seed(seed)
    bank32 = torch.rand((n, d), generator=g, device="cuda")
    bank32[DUP_HI] = bank32[DUP_LO]
    picks = torch.randint(0, n, (E6_TILES,), generator=g, device="cuda")
    q32 = bank32[picks] + 0.1 * torch.randn((E6_TILES, d), generator=g, device="cuda")
    q32[0] = bank32[DUP_LO]                      # an exact copy of both rows
    q32[1 : 1 + N_FAR] = torch.rand((N_FAR, d), generator=g, device="cuda")
    tie = slice(1 + N_FAR, 1 + N_FAR + N_TIE)
    q32[tie] = torch.rand((N_TIE, d), generator=g, device="cuda")
    # the rows of norm (1 + s′)‖q‖ may set the tolerance's largest row norm
    bn = max(float(bank32.norm(dim=1).max()), (1 + TIE_S) * float(q32[tie].norm(dim=1).max()))
    gap = 2 * f32_pick_tol(d, float(q32.norm(dim=1).max()), bn)
    a_rows, b_rows = near_tie_rows(q32[tie], gap)
    bank32[TIE_ROW : TIE_ROW + 2 * N_TIE : 2] = a_rows
    bank32[TIE_ROW + 1 : TIE_ROW + 2 * N_TIE : 2] = b_rows

    regimes = {}
    bank8 = torch.clamp(torch.round(bank32 * 255.0) - 128.0, -128, 127).to(torch.int8)
    regimes["int8"] = (bank8, (bank8.int() ** 2).sum(1, dtype=torch.int32),
                       torch.clamp(torch.round(q32 * 255.0) - 128.0, -128, 127)
                       .to(torch.int8))
    bank16 = bank32.to(torch.bfloat16)
    regimes["bfloat16"] = (bank16, (bank16.float() ** 2).sum(1), q32)
    regimes["float32"] = (bank32, (bank32 ** 2).sum(1), q32)

    results = {}
    for dname in ("float32", "bfloat16", "int8"):
        bank, sqn, q = regimes[dname]
        idx = top1_l2_retrieval(q, bank, sqn)
        ref = top1_l2_retrieval_reference(q, bank, sqn)
        torch.cuda.synchronize()
        assert idx.dtype == torch.int32 and tuple(idx.shape) == (E6_TILES,)
        if int(idx[0]) != DUP_LO:
            raise AssertionError(f"{dname}: the duplicated row {DUP_LO} lost to "
                                 f"{int(idx[0])}")
        mism_plain = int((idx != ref).sum())
        if dname == "int8":
            tol, excess, mism_gap = 0.0, 0.0, mism_plain
            ties = int((idx[tie] == ref[tie]).sum())
            if mism_plain:
                raise AssertionError(f"int8: {mism_plain} indices differ from the "
                                     "exact plain version")
        else:
            # the values the kernel saw (bf16 banks take bf16 queries)
            qk = q.to(bank.dtype)
            best, second, arg, dist = _f64_top1(qk, bank)
            excess_all = dist(idx.long()) - best
            excess = float(excess_all.max())
            tol = f32_pick_tol(d, float(qk.float().norm(dim=1).max()),
                               float(bank.float().norm(dim=1).max()))
            decisive = (second - best) > tol
            mism_gap = int(((idx.long() != arg) & decisive).sum())
            ties = int((idx[tie].long() == arg[tie]).sum())
            if not excess <= tol or mism_gap:
                raise AssertionError(
                    f"{dname}: largest f64 excess {excess:.4g} (tol {tol:.4g}); "
                    f"{mism_gap} indices differ where the f64 gap exceeds tol")
        # the finetune step's query counts: B = 4 and a tail batch's 1-3,
        # each held to the same limits (wgmma's N is the query count)
        small_b = {}
        for b in FT_QUERY_COUNTS:
            idx_b = top1_l2_retrieval(q[:b].contiguous(), bank, sqn)
            if dname == "int8":
                ok, ex = torch.equal(idx_b, ref[:b]), 0.0
            else:
                picks = idx.long().clone()
                picks[:b] = idx_b.long()
                ex = float((dist(picks)[:b] - best[:b]).max())
                ok = ex <= tol and not int(((idx_b.long() != arg[:b]) & decisive[:b]).sum())
            small_b[b] = dict(max_f64_excess=ex, same_as_b400=bool(torch.equal(idx_b, idx[:b])))
            if not ok:
                raise AssertionError(f"{dname}: B={b} picks outside the limits "
                                     f"(f64 excess {ex:.4g}, tol {tol:.4g})")
        log(f"[kernels] top1 {dname:8s} B=1,2,3,4: within the limits; the same "
            f"picks as at B=400: {[v['same_as_b400'] for v in small_b.values()]}")
        # padded to 512 rows: no padded row may win, the picks do not move
        bp, sp = pad_bank_for_retrieval(bank, sqn, 512)
        idx_p = top1_l2_retrieval(q, bp, sp)
        if not torch.equal(idx_p, idx) or int(idx_p.max()) >= n:
            raise AssertionError(f"{dname}: the padded bank changed the picks")
        del bp, sp, idx_p

        route, peak = ROUTES[dname]
        rows = []
        for b in (E6_TILES, 8, FT_B):
            qb = q[:b].contiguous()
            ms = time_ms(lambda: top1_l2_retrieval(qb, bank, sqn), reps=5)
            plain_ms = time_ms(lambda: top1_l2_retrieval_reference(qb, bank, sqn), reps=3)
            library_ms = time_ms(_library_top1(qb, bank, sqn), reps=3)
            item = bank.element_size()
            nbytes = (b * d + n * d) * item + n * 4 + b * 4
            bound_ms, bound_by = bound(2.0 * b * n * d, nbytes, peak)
            rows.append(dict(batch=b, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             tops=2.0 * b * n * d / ms / 1e9))
            earlier = EARLIER_TOP1_MS.get((dname, b))
            log(f"[kernels] top1 {dname:8s} B={b:3d} N={n} D={d}: kernel {ms:.3f} ms "
                f"plain {plain_ms:.3f} ms library {library_ms:.3f} ms bound "
                f"{bound_ms:.3f} ms ({bound_by}) {rows[-1]['tops']:.2f} TOP/s; {route}"
                + (f" (the CUDA-core kernel: {earlier} ms, PERF.md)" if earlier else ""))
        results[dname] = dict(max_f64_excess=excess, tol=tol,
                              mismatched_vs_plain=mism_plain,
                              mismatched_where_gap_exceeds_tol=mism_gap,
                              near_ties_right=ties, rows=rows, small_batches=small_b)
        log(f"[kernels] top1 {dname:8s}: duplicate row {DUP_LO} wins; padded bank "
            f"agrees; vs plain {mism_plain} of {E6_TILES} indices differ; largest "
            f"f64 excess {excess:.4g} (tol {tol:.4g}); {ties} of {N_TIE} near ties "
            "pick the best row")
        del bank, sqn, q, regimes[dname]
        torch.cuda.empty_cache()
    return results


def _library_top1(q, bank, sqn):
    """One cuBLAS product (torch.mm; torch._int_mm for int8) plus argmin: two
    calls, since no single PyTorch call computes top-1 L2. int8 runs on the
    bank padded to a multiple of 8 rows with queries padded to 32 rows
    (_int_mm needs both)."""
    import torch

    if bank.dtype == torch.int8:
        n = bank.shape[0]
        bt = torch.cat([bank, bank.new_zeros(((-n) % 8, bank.shape[1]))]).t()
        qp = torch.cat([q, q.new_zeros((max(0, 32 - q.shape[0]), q.shape[1]))])
        s = torch.cat([sqn, sqn.new_full(((-n) % 8,), torch.iinfo(torch.int32).max)])
        return lambda: (s[None] - 2 * torch._int_mm(qp, bt)).argmin(1)
    qc = q.to(bank.dtype)
    return lambda: (sqn[None] - 2.0 * torch.mm(qc, bank.t()).float()).argmin(1)


def level_diff(a, b):
    import numpy as np

    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return dict(max_level_diff=int(d.max()), mean_level_diff=float(d.mean()),
                frac_pixels_diff=float((d > 0).mean()))


def check_levels(dname, vs_f32, vs_same, what, bf16_limits=(BF16_MAX_LEVELS,
                                                           BF16_MEAN_LEVELS)):
    """f32: the kernel and cuDNN differ only in summation order, which can
    move a blended pixel across one rounding edge. bf16 rounds every stored
    activation to 8 significant bits, and cuDNN's bf16 forward rounds in
    another order: both differences are held to ``bf16_limits`` (largest,
    mean level difference)."""
    if dname == "float32":
        ok = vs_f32["max_level_diff"] <= 1 and vs_f32["frac_pixels_diff"] <= 1e-3
    else:
        ok = all(d["max_level_diff"] <= bf16_limits[0]
                 and d["mean_level_diff"] <= bf16_limits[1]
                 for d in (vs_f32, vs_same))
    if not ok:
        raise AssertionError(f"{what} {dname}: fused path too far from the "
                             "per-conv forward")


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

    mp = BURSTS * B * FRAME * FRAME / 1e6
    out, module_preds = {}, {}
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        # yardstick: the same runner over the per-conv module forward (cuDNN)
        mod = copy.deepcopy(module).to(dt)
        mod_call = torch.inference_mode()(lambda t, m=mod, d=dt: m(t.to(d)))
        module_ms = time_ms(lambda: mod_call(chunk), reps=3)
        mod_run = runner(mod_call)
        run_bursts(mod_run, bursts[:1])  # warm-up: cuDNN plans
        module_preds[dname], module_sec = run_bursts(mod_run, bursts)
        del mod

        fwd = make_fused_forward(model, dtype=dt)
        run = runner(fwd)
        run_bursts(run, bursts[:1])  # warm-up: the kernel library
        fwd_ms = time_ms(lambda: fwd(chunk), reps=3)
        fused_rdb_chain.launches = 0
        preds, sec = run_bursts(run, bursts)
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
        check_levels(dname, vs_f32, vs_same, "E2")
        out[dname]["profile"] = prof = profile_burst(run, bursts[0])
        log(f"[main] {dname:8s} one burst under torch.profiler: wall "
            f"{prof['wall_ms']:.1f} ms, device busy {prof['device_busy_ms']:.1f} ms "
            f"(share {prof['busy_share']}); {chain_share(prof, sec / BURSTS)}; top "
            f"kernels {prof['top_kernels_ms'][:3]}")
    return out


def e6_frames(seed: int):
    """5 memory pairs of 704² uint8 (a smooth pattern, Gaussian noise on top)
    and 3 bursts of 4 noisy frames: burst 1 is the bank's noisy frames 0-3,
    bursts 2 and 3 fresh noise on clean frames 1-4 and 0-3."""
    import numpy as np

    rng = np.random.default_rng(seed + 6)
    yy, xx = np.mgrid[0:FRAME, 0:FRAME].astype(np.float32)

    def noisy(c):
        return np.clip(c + rng.normal(0, 20, c.shape), 0, 255).astype(np.uint8)

    clean = [np.clip(128 + 60 * np.sin(xx / (17 + f) + f) * np.cos(yy / (23 + 2 * f))
                     + 30 * np.sin((xx + yy) / 41 + f), 0, 255).astype(np.uint8)
             for f in range(E6_PAIRS)]
    noise = [noisy(c) for c in clean]
    bursts = [np.stack(noise[:4]), np.stack([noisy(c) for c in clean[1:5]]),
              np.stack([noisy(c) for c in clean[:4]])]
    return clean, noise, bursts


def phase_memory(seed: int):
    import numpy as np
    import torch

    from image_denoising_tpu_torch.adapters import (DenoiserWithMemoryAdapter,
                                                    build_memory_adapter)
    from image_denoising_tpu_torch.adapters.wrappers import _clean01
    from image_denoising_tpu_torch.cli.evaluation_704_iqsl_memory import (
        make_memory_model_call)
    from image_denoising_tpu_torch.eval import tiled
    from image_denoising_tpu_torch.memory import (MemoryBank,
                                                  build_memory_bank_from_frames)
    from image_denoising_tpu_torch.memory.retrieval import (
        pad_bank_for_retrieval, top1_l2_retrieval, top1_l2_retrieval_reference)
    from image_denoising_tpu_torch.models import ImprovedUNet, make_fused_forward
    from image_denoising_tpu_torch.ops.fused_block import fused_rdb_chain

    clean, noise, bursts = e6_frames(seed)
    t0 = time.perf_counter()
    bank = build_memory_bank_from_frames(
        clean, noise, E6_TILE, E6_STRIDE, bank_dtype="int8", pad_to=512,
        clean_dtype="uint8", device="cuda")
    torch.cuda.synchronize()
    bank_s = time.perf_counter() - t0
    n = E6_BANK_ROWS
    assert tuple(bank.noise_flat.shape) == (n + (-n) % 512, PATCH_D)
    log(f"[memory] bank: {n} patches of {E6_TILE}^2 at stride {E6_STRIDE} from "
        f"{E6_PAIRS} pairs, int8 noise + uint8 clean, padded to "
        f"{bank.noise_flat.shape[0]}: {bank_s:.2f} s on the host and copy")

    torch.manual_seed(seed)
    model = ImprovedUNet(in_nc=1, out_nc=1, n_feature=NF).eval()
    adapter = build_memory_adapter("hyper_gated_fft", 1, E6_HIDDEN)
    with torch.no_grad():  # every weight non-zero, the zero-init tails too
        for p in adapter.parameters():
            fan_in = p[0].numel() if p.dim() > 1 else 16
            p.uniform_(-fan_in ** -0.5, fan_in ** -0.5)
    adapter = adapter.to("cuda").eval()

    grid = tiled.edge_aligned_grid(FRAME, FRAME, E6_TILE, OVERLAP)
    t_per_frame = len(grid)
    chunks = -(-E6_TILES // B)

    def queries(frames):  # the hoisted pass's int8 queries for one burst
        f = torch.from_numpy(frames).to("cuda")
        t = torch.stack([f[:, r : r + E6_TILE, c : c + E6_TILE] for r, c in grid], 1)
        return (t.reshape(-1, PATCH_D).int() - 128).to(torch.int8)

    # burst 1's tiles are bank patches: frame f, corner (r, c) is row
    # f·145² + (r/4)·145 + c/4 (the grid's corners are multiples of 64)
    own = torch.tensor([f * E6_GRID ** 2 + (r // E6_STRIDE) * E6_GRID + c // E6_STRIDE
                        for f in range(E6_BURST) for r, c in grid], device="cuda")
    for k, frames in enumerate(bursts):
        q = queries(frames)
        idx = top1_l2_retrieval(q, bank.noise_flat, bank.sq_norms)
        ref = top1_l2_retrieval_reference(q, bank.noise_flat, bank.sq_norms)
        if not torch.equal(idx, ref):
            raise AssertionError(f"E6 burst {k + 1}: retrieval indices differ "
                                 "from the plain version")
        if k == 0 and not torch.equal(idx.long(), own):
            raise AssertionError("E6 burst 1: a tile did not retrieve its own "
                                 f"bank patch ({int((idx.long() != own).sum())} of "
                                 f"{E6_TILES})")
    log(f"[memory] retrieval indices of the 3 bursts equal the plain version's; "
        f"burst 1's {E6_TILES} tiles each retrieve their own bank patch")

    def plain_pre_tile(tiles):  # the yardstick's retrieval: the plain version
        q = (torch.round(tiles.reshape(tiles.shape[0], -1) * 255.0) - 128.0).to(torch.int8)
        idx = top1_l2_retrieval_reference(q, bank.noise_flat, bank.sq_norms)
        mem = _clean01(bank.clean[idx.long()]).permute(0, 3, 1, 2)
        return torch.cat([tiles, mem], 1)

    def runner(model_call, pre):
        return tiled.make_tiled_hann_runner_frames(
            model_call, E6_BURST, FRAME, FRAME, ps=E6_TILE, overlap=OVERLAP,
            batch=-B, out_dtype="uint8_round", pre_tile_fn=pre, device="cuda")

    # per-layer timing inputs: burst 1's 400 real tiles, and its first
    # 8-tile chunk with the retrieved patches as a second channel
    f1 = torch.from_numpy(bursts[0]).to("cuda").float() / 255.0
    tiles400 = torch.stack([f1[:, r : r + E6_TILE, c : c + E6_TILE] for r, c in grid],
                           1).reshape(E6_TILES, 1, E6_TILE, E6_TILE)
    stack = plain_pre_tile(tiles400[:B])
    geo = tiled._HannGeometry(FRAME, FRAME, E6_TILE, OVERLAP, torch.device("cuda"))
    preds_f = torch.rand((E6_BURST, t_per_frame, E6_TILE, E6_TILE), device="cuda")
    with torch.inference_mode():
        blend_ms = time_ms(lambda: tiled._quantize(geo.blend(preds_f), "uint8_round"))
        base_out = torch.rand((B, 1, E6_TILE, E6_TILE), device="cuda")
        adapter_ms = time_ms(lambda: adapter(stack[:, :1], base_out, stack[:, 1:]))

    mp = BURSTS * E6_BURST * FRAME * FRAME / 1e6
    out, module_preds = {}, {}
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        # yardstick: per-conv module base (cuDNN) and the plain retrieval
        mod = copy.deepcopy(model).to("cuda", dt)
        mod_call = torch.inference_mode()(lambda t, m=mod, d=dt: m(t.to(d)))
        y_call, _ = make_memory_model_call(
            DenoiserWithMemoryAdapter(mod_call, adapter), bank)
        y_run = runner(y_call, plain_pre_tile)
        run_bursts(y_run, bursts[:1])  # warm-up: cuDNN and FFT plans
        module_preds[dname], module_sec = run_bursts(y_run, bursts)
        with torch.inference_mode():
            module_ms = time_ms(lambda: mod_call(stack[:, :1]), reps=3)
        del mod, y_run

        fwd = make_fused_forward(model, device="cuda", dtype=dt)
        model_call, pre = make_memory_model_call(
            DenoiserWithMemoryAdapter(fwd, adapter), bank)
        run = runner(model_call, pre)
        with torch.inference_mode():
            fwd_ms = time_ms(lambda: fwd(stack[:, :1]), reps=3)
            pre_ms = time_ms(lambda: pre(tiles400), reps=3)
        run_bursts(run, bursts[:1])
        fused_rdb_chain.launches = 0
        top1_l2_retrieval.launches = 0
        preds, sec = run_bursts(run, bursts)
        launches = dict(fused_rdb_chain=fused_rdb_chain.launches,
                        top1_l2_retrieval=top1_l2_retrieval.launches)
        want = dict(fused_rdb_chain=9 * chunks * BURSTS, top1_l2_retrieval=BURSTS)
        if launches != want:
            raise AssertionError(f"E6 {dname}: launches {launches}, want {want}")
        assert preds.shape == (BURSTS, E6_BURST, FRAME, FRAME) and preds.dtype == np.uint8
        vs_f32 = level_diff(preds, module_preds["float32"])
        vs_same = level_diff(preds, module_preds[dname])
        out[dname] = dict(launches=launches, seconds=sec, mps=mp / sec,
                          module_seconds=module_sec, module_mps=mp / module_sec,
                          fused_forward_ms_per_chunk=fwd_ms,
                          module_forward_ms_per_chunk=module_ms,
                          hoisted_retrieval_ms=pre_ms, adapter_ms_per_chunk=adapter_ms,
                          blend_quantise_ms_per_burst=blend_ms,
                          **vs_f32, vs_same_dtype_module=vs_same)
        if dname == "float32":
            preds_f32 = preds
        log(f"[memory] {dname:8s} {BURSTS} bursts of {E6_BURST}x{FRAME}^2 "
            f"({E6_TILES} tiles): {sec:.3f} s, {mp / sec:.4f} MP/s end to end "
            f"(per-conv module base + plain retrieval: {mp / module_sec:.4f}); "
            f"per burst: hoisted retrieval {pre_ms:.2f} ms, {chunks} chunks of "
            f"fused forward {fwd_ms:.2f} ms (per-conv module: {module_ms:.2f}) + "
            f"adapter {adapter_ms:.2f} ms, blend+quantise {blend_ms:.2f} ms; "
            f"launches {launches}")
        for what, d in {"float32": vs_f32, dname: vs_same}.items():
            log(f"[memory] {dname:8s} vs yardstick {what}: max "
                f"{d['max_level_diff']} levels, mean {d['mean_level_diff']:.4f}, "
                f"{d['frac_pixels_diff']:.3e} of pixels differ")
        check_levels(dname, vs_f32, vs_same, "E6",
                     (E6_BF16_MAX_LEVELS, E6_BF16_MEAN_LEVELS))
        out[dname]["profile"] = prof = profile_burst(run, bursts[0])
        log(f"[memory] {dname:8s} one burst under torch.profiler: wall "
            f"{prof['wall_ms']:.1f} ms, device busy {prof['device_busy_ms']:.1f} ms "
            f"(share {prof['busy_share']}); {chain_share(prof, sec / BURSTS)}; top "
            f"kernels {prof['top_kernels_ms'][:3]}")
        y_prof = profile_burst(runner(y_call, plain_pre_tile), bursts[0])
        out[dname]["module_profile"] = y_prof
        log(f"[memory] {dname:8s} yardstick burst under torch.profiler: wall "
            f"{y_prof['wall_ms']:.1f} ms, device busy {y_prof['device_busy_ms']:.1f} ms "
            f"(share {y_prof['busy_share']})")

    # the other bank regimes, built on the card from the same bytes: burst 1
    # retrieves the same (own) patches, so the output is the int8 run's
    fwd = make_fused_forward(model, device="cuda", dtype=torch.float32)
    noise32 = (bank.noise_flat[:n].float() + 128.0) / 255.0
    regime_launches = {}
    for dname in ("float32", "bfloat16"):
        nb = noise32 if dname == "float32" else noise32.to(torch.bfloat16)
        nb, sq = pad_bank_for_retrieval(nb, (noise32 ** 2).sum(1), 512)
        other = MemoryBank(nb, bank.clean, sq, E6_TILE, E6_STRIDE)
        model_call, pre = make_memory_model_call(DenoiserWithMemoryAdapter(fwd, adapter), other)
        run = runner(model_call, pre)
        run_bursts(run, bursts[:1])
        fused_rdb_chain.launches = 0
        top1_l2_retrieval.launches = 0
        got, sec = run_bursts(run, bursts[:1])
        regime_launches[dname] = dict(fused_rdb_chain=fused_rdb_chain.launches,
                                      top1_l2_retrieval=top1_l2_retrieval.launches)
        if regime_launches[dname] != dict(fused_rdb_chain=9 * chunks, top1_l2_retrieval=1):
            raise AssertionError(f"E6 {dname} bank: launches {regime_launches[dname]}")
        if not np.array_equal(got[0], preds_f32[0]):
            raise AssertionError(f"E6 {dname} bank: burst 1 differs from the int8 "
                                 "bank's output")
        out[f"{dname}_bank"] = dict(launches=regime_launches[dname], seconds=sec,
                                    mps=E6_BURST * FRAME * FRAME / 1e6 / sec)
        log(f"[memory] {dname} bank, float32 compute, burst 1: {sec:.3f} s "
            f"({out[f'{dname}_bank']['mps']:.4f} MP/s), output equal to the int8 "
            f"bank's; launches {regime_launches[dname]}")
        del nb, sq, other
    out.update(bank_seconds=bank_s, bank_rows=n)
    return out


def kernel_device_ms(fn, name: str, reps: int = 50, flush=None) -> float:
    """Median device time (ms) of the kernel whose name contains ``name``,
    over ``reps`` calls of ``fn``, from torch.profiler: a launch of a few
    microseconds is shorter than the host's time to issue it, so CUDA events
    around calls would time the host. ``flush``, if given, runs before each
    call (its kernels are not ``name``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # one call more than timed: the profiler can miss the first launch of
    # its window, so it must see at least ``reps`` of the ``reps + 1``. It
    # can also drop more of a window's records (seen with flushes between
    # the calls): such a window is taken again, at most PROFILE_WINDOWS in all
    seen = []
    for _ in range(PROFILE_WINDOWS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps + 1):
                if flush is not None:
                    flush()
                fn()
            torch.cuda.synchronize()
        times = [(e.time_range.end - e.time_range.start) / 1e3 for e in prof.events()
                 if e.device_type == DeviceType.CUDA and name in e.name]
        if len(times) in (reps, reps + 1):
            return statistics.median(times[-reps:])
        seen.append(len(times))
        log(f"[kernels] the profiler saw {len(times)} of {reps + 1} '{name}' kernels; "
            "the window is taken again")
    raise AssertionError(f"the profiler saw {seen} '{name}' kernels in {PROFILE_WINDOWS} "
                         f"windows, want {reps} or {reps + 1}")


def l2_flush():
    """A function that reads L2_FLUSH_BYTES on the card, so that what a
    kernel reads after it comes from HBM; the reads leave no dirty line for
    the kernel to write back."""
    import torch

    buf = torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    return lambda: buf.sum()


def call_ms(fn, reps: int = 200) -> float:
    """CUDA-event time (ms) per call of ``reps`` calls issued back to back:
    the rate at which the host issues them when the kernel is shorter."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _bits(t):
    """A float tensor's bits as integers, for bit-equality checks."""
    import torch

    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])


def subsample_device_times(fn, img, flush):
    """(ms with L2 flushed before each call, ms with the image in L2,
    bound_ms, bound_by, bytes) of the sub-sampler call ``fn`` on ``img``. The
    bound counts the image read once and the two sub-images and two int32
    maps written once, at HBM's rate, and the draws' integer operations at
    the float32 rate (bytes bound it by far)."""
    n, _, h, w = img.shape
    cells = n * (h // 2) * (w // 2)
    item = img.element_size()
    nbytes = img.numel() * item + 2 * (img.numel() // 4) * item + 2 * cells * 4
    ms = kernel_device_ms(fn, "subsample_pair_kernel", flush=flush)
    warm_ms = kernel_device_ms(fn, "subsample_pair_kernel")
    bound_ms, bound_by = bound(cells * PHILOX_OPS_PER_CELL, nbytes, "float32")
    return ms, warm_ms, bound_ms, bound_by, nbytes


def subsample_times(root: str) -> int:
    """The ``--subsample-times`` mode: the sub-sampler kernel of the port in
    the checkout ``root``, built there (into its git-ignored build/kernels/),
    checked bit-equal to that checkout's plain version and timed at
    SUB_SHAPES with this script's flush, timer and bound; one JSON line. Run
    it for two checkouts in turn (A, B, B, A) to compare them on one card."""
    import numpy as np
    import torch

    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import image_denoising_tpu_torch as pkg
    from image_denoising_tpu_torch.ops import _build
    from image_denoising_tpu_torch.ops.neighbor import subsample_pair, subsample_pair_fused

    if os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__))) != root:
        raise AssertionError(f"imported {pkg.__file__}, not the package in {root}")
    _build.build("neighbor.cu")
    flush = l2_flush()
    rng = np.random.default_rng(0)
    shapes = {}
    for n, c, h, w, dname in SUB_SHAPES:
        img = torch.from_numpy(rng.random((n, c, h, w), dtype=np.float32)).to(
            "cuda", getattr(torch, dname))
        got, want = subsample_pair_fused(1, img), subsample_pair(1, img)
        if not all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got[:2], want[:2])) or \
                not all(torch.equal(a, b) for a, b in zip(got[2], want[2])):
            raise AssertionError(f"{n}x{c}x{h}x{w} {dname}: the kernel of {root} differs "
                                 "from its plain version")
        ms, warm_ms, bound_ms, bound_by, _ = subsample_device_times(
            lambda: subsample_pair_fused(1, img), img, flush)
        shapes[f"n{n}_c{c}_{h}x{w}_{dname}"] = dict(
            ms=ms, warm_ms=warm_ms, bound_ms=bound_ms, bound_by=bound_by,
            share_of_bound=bound_ms / ms)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(json.dumps(dict(root=root, card=smi, subsample_pair=shapes)))
    return 0


def phase_subsample(seed: int):
    """subsample_pair_fused against its plain version at SUB_SHAPES (the
    training shape N=4, 352², C=1 f32, and C=3 f32 and bf16) and at
    SUB_EDGE_SHAPES (the scalar path, N = 1), bit-equal; timed at SUB_SHAPES
    with L2 flushed before each call (``ms``, held to the byte bound at HBM's
    rate) and with the image in L2 (``warm_ms``: calls back to back, as the
    N2N step finds the image the noise op has just written)."""
    import numpy as np
    import torch

    from image_denoising_tpu_torch.ops.neighbor import (
        generate_subimages, subsample_pair, subsample_pair_fused)
    from image_denoising_tpu_torch.ops.rng import OperationSeed

    rng = np.random.default_rng(seed + 3)
    seeds = OperationSeed(seed + 3)
    valid = [4 * a + b for a, b in VALID_PAIRS]
    flush = l2_flush()
    results = {}

    def parts(r):
        return _bits(r[0]), _bits(r[1]), r[2][0], r[2][1]

    for n, c, h, w, dname in SUB_SHAPES + SUB_EDGE_SHAPES:
        dt = getattr(torch, dname)
        img = torch.from_numpy(rng.random((n, c, h, w), dtype=np.float32)).to("cuda", dt)
        s, other = seeds.next(), seeds.next()
        got = subsample_pair_fused(s, img)
        want = subsample_pair(s, img)
        again = subsample_pair_fused(s, img)
        _, _, (o1, o2) = subsample_pair_fused(other, img)
        torch.cuda.synchronize()
        sub1, sub2, (sel1, sel2) = got
        what = f"subsample_pair {n}x{c}x{h}x{w} {dname}"
        assert sub1.shape == sub2.shape == (n, c, h // 2, w // 2) and sub1.dtype == dt
        assert sel1.shape == sel2.shape == (n, h // 2, w // 2) and sel1.dtype == torch.int32

        if not all(torch.equal(a, b) for a, b in zip(parts(got), parts(want))):
            raise AssertionError(f"{what}: the kernel differs from the plain version")
        err = max(float((g.float() - w_.float()).abs().max())
                  for g, w_ in zip(got[:2], want[:2]))
        if not all(torch.equal(a, b) for a, b in zip(parts(got), parts(again))):
            raise AssertionError(f"{what}: the same seed gave other maps")
        if torch.equal(o1, sel1) and torch.equal(o2, sel2):
            raise AssertionError(f"{what}: another seed gave the same maps")
        cells = sel1.numel()
        counts = torch.bincount((sel1 * 4 + sel2).flatten().long(), minlength=16).cpu()
        if int(counts[valid].sum()) != cells:
            raise AssertionError(f"{what}: pairs outside the 8 listed: {counts.tolist()}")
        freq = counts[valid].double() / cells
        freq_err = float((freq - 1 / 8).abs().max())
        if not freq_err <= PAIR_FREQ_TOL:
            raise AssertionError(f"{what}: pair frequencies {freq.tolist()} off 1/8 by "
                                 f"{freq_err:.4g} > {PAIR_FREQ_TOL}")
        # one pair of maps for all channels: each channel's sub-images are
        # its own plane gathered at those maps
        for ch in range(c):
            plane = img[:, ch : ch + 1]
            for sub, sel in ((sub1, sel1), (sub2, sel2)):
                if not torch.equal(_bits(sub[:, ch : ch + 1]),
                                   _bits(generate_subimages(plane, sel))):
                    raise AssertionError(f"{what}: channel {ch} does not follow the "
                                         "shared maps")
        key = f"n{n}_c{c}_{h}x{w}_{dname}"
        if (n, c, h, w, dname) in SUB_EDGE_SHAPES:
            results[key] = dict(n=n, c=c, h=h, w=w, dtype=dname, max_abs_err=err,
                                max_pair_freq_err=freq_err, cells=cells)
            log(f"[kernels] subsample_pair {n}x{c}x{h}x{w} {dname:8s} (edge shape, "
                f"{'vector' if (w // 2) % 4 == 0 else 'scalar'} path): bit-equal to the "
                f"plain version; pair frequencies within {freq_err:.4g} of 1/8")
            continue
        ms, warm_ms, bound_ms, bound_by, nbytes = subsample_device_times(
            lambda: subsample_pair_fused(s, img), img, flush)
        wrapper_ms = call_ms(lambda: subsample_pair_fused(s, img))
        plain_ms = time_ms(lambda: subsample_pair(s, img), reps=5)
        share = bound_ms / ms
        results[key] = dict(
            n=n, c=c, h=h, w=w, dtype=dname, max_abs_err=err, max_pair_freq_err=freq_err,
            ms=ms, warm_ms=warm_ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, share_of_bound=share, mbytes=nbytes / 1e6,
            cells=cells)
        log(f"[kernels] subsample_pair N={n} {h}^2 C={c} {dname:8s}: bit-equal to the plain "
            f"version; {cells} cells, pair frequencies within {freq_err:.4g} of 1/8; "
            f"kernel_device_ms {ms * 1e3:.3f} us with L2 flushed, {warm_ms * 1e3:.3f} us with "
            f"the image in L2; {wrapper_ms * 1e3:.2f} us per call issued back to back; plain "
            f"{plain_ms:.3f} ms; bound {bound_ms * 1e3:.3f} us ({bound_by}, HBM): {share:.3f} "
            "of the bound with L2 flushed")
    return results


def top_convolutions(fn, top: int = 4):
    """The convolution calls of ``fn`` that take most device time, grouped by
    input shapes: [(device ms, input shapes)]."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.device_time_total / 1e3, str(e.input_shapes)[:60])
            for e in prof.key_averages(group_by_input_shape=True)
            if e.key == "aten::convolution"]
    return sorted(rows, reverse=True)[:top]


def n2n_frames(seed: int, count: int, size: int = TRAIN_FRAME):
    """``count`` smooth seeded size² uint8 frames [count, size, size]."""
    import numpy as np

    rng = np.random.default_rng(seed + 9)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, count)
    return np.stack([
        np.clip(128 + 60 * np.sin(xx / (17 + f) + phase[f]) * np.cos(yy / (23 + 2 * f))
                + 30 * np.sin((xx + yy) / 41 + f), 0, 255).astype(np.uint8)
        for f in range(count)])


def phase_train(seed: int):
    """The N2N step of ImprovedUNet-48 at batch 4 of 352², f32."""
    import numpy as np
    import torch

    from image_denoising_tpu_torch.losses import n2n_regularized_loss
    from image_denoising_tpu_torch.models import ImprovedUNet
    from image_denoising_tpu_torch.ops import AugmentNoise, OperationSeed
    from image_denoising_tpu_torch.ops.fused_block import fused_rdb_chain
    from image_denoising_tpu_torch.ops.neighbor import (
        generate_subimages, subsample_pair, subsample_pair_fused)
    from image_denoising_tpu_torch.train import (
        create_train_state, make_n2n_train_step, to_nchw01)

    torch.manual_seed(seed)
    model = ImprovedUNet(in_nc=1, out_nc=1, n_feature=NF).to("cuda")
    init = copy.deepcopy(model.state_dict())
    clean = n2n_frames(seed, TRAIN_B)[..., None].astype(np.float32)  # NHWC, [0,255]
    aug = AugmentNoise("gauss25")

    def run(subsample):
        model.load_state_dict(init)
        state = create_train_state(model, lr=3e-4)
        step = make_n2n_train_step(model, state, noise_fn=aug.add_train_noise,
                                   increase_ratio=2.0, n_epoch=TRAIN_EPOCHS,
                                   subsample=subsample)
        seeds = OperationSeed(seed)
        losses = [step(clean, clean, seeds.next(), 1)["loss"] for _ in range(TRAIN_WARMUP)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += [step(clean, clean, seeds.next(), 1)["loss"] for _ in range(TRAIN_STEPS)]
        torch.cuda.synchronize()
        return state, step, seeds, [float(x) for x in losses], (time.perf_counter() - t0) / TRAIN_STEPS

    torch.cuda.reset_peak_memory_stats()
    subsample_pair_fused.launches = 0
    fused_rdb_chain.launches = 0
    state, step, seeds, losses, step_s = run(subsample_pair_fused)
    launches = subsample_pair_fused.launches
    chain_launches = fused_rdb_chain.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches != TRAIN_WARMUP + TRAIN_STEPS:
        raise AssertionError(f"N2N: {launches} sub-sampler launches, want "
                             f"{TRAIN_WARMUP + TRAIN_STEPS} (one per step)")
    _, _, _, plain_losses, plain_step_s = run(subsample_pair)
    if subsample_pair_fused.launches != launches:
        raise AssertionError("N2N: the plain run launched the kernel")
    if not all(np.isfinite(losses + plain_losses)):
        raise AssertionError(f"N2N: non-finite loss: {losses} {plain_losses}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain_losses))
    log(f"[train] N2N losses of {TRAIN_WARMUP}+{TRAIN_STEPS} steps, kernel: "
        f"{[round(x, 6) for x in losses]}; largest relative difference to the "
        f"plain sub-sampler's run {rel:.3g} (limit {TRAIN_LOSS_RTOL})")
    if not rel <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"N2N: losses differ from the plain run by {rel} > "
                             f"{TRAIN_LOSS_RTOL}")

    # the step's parts, each timed alone on this step's inputs
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    clean01 = to_nchw01(clean, dev)
    s = seeds.next()
    noisy01 = aug.add_train_noise(gen, clean01)
    sub1, sub2, (sel1, sel2) = subsample_pair_fused(s, noisy01)
    with torch.no_grad():
        den = model(noisy01)
    d1, d2 = generate_subimages(den, sel1), generate_subimages(den, sel2)

    def fwd_bwd():
        loss, _ = n2n_regularized_loss(model(sub1), sub2, d1, d2, 2.0 / TRAIN_EPOCHS)
        loss.backward()

    parts = dict(
        noise_subsample_ms=time_ms(lambda: subsample_pair_fused(s, aug.add_train_noise(gen, clean01))),
        nograd_forward_ms=time_ms(torch.no_grad()(lambda: model(noisy01)), reps=3),
        forward_backward_ms=time_ms(fwd_bwd, reps=3),
        adam_ms=time_ms(state.optimizer.step))
    # the same two forwards with cuDNN's algorithms picked by timing instead
    # of its heuristics: what a later change could gain (the port keeps the
    # default, cudnn.benchmark off)
    torch.backends.cudnn.benchmark = True
    try:
        autotuned = dict(
            nograd_forward_ms=time_ms(torch.no_grad()(lambda: model(noisy01)), warmup=2, reps=3),
            forward_backward_ms=time_ms(fwd_bwd, warmup=2, reps=3))
    finally:
        torch.backends.cudnn.benchmark = False
    state.optimizer.zero_grad(set_to_none=True)
    slow_convs = top_convolutions(torch.no_grad()(lambda: model(noisy01)))
    prof = profile_window(lambda: float(step(clean, clean, seeds.next(), 1)["loss"]))
    mp = TRAIN_B * TRAIN_FRAME ** 2 / 1e6
    log(f"[train] N2N step, ImprovedUNet-{NF} f32, batch {TRAIN_B}x{TRAIN_FRAME}^2 "
        f"(sub-images {TRAIN_FRAME // 2}^2): {step_s * 1e3:.2f} ms/step, "
        f"{mp / step_s:.4f} MP/s of input frames (plain sub-sampler: "
        f"{plain_step_s * 1e3:.2f} ms/step); sub-sampler launches {launches}, "
        f"chain launches {chain_launches}; peak memory {peak_gb:.2f} GB")
    log(f"[train] parts, each alone: noise+subsample {parts['noise_subsample_ms']:.3f} ms, "
        f"no-grad forward {parts['nograd_forward_ms']:.2f} ms, forward+backward "
        f"{parts['forward_backward_ms']:.2f} ms, Adam {parts['adam_ms']:.3f} ms; with "
        f"cudnn.benchmark on (not the port's setting): no-grad forward "
        f"{autotuned['nograd_forward_ms']:.2f} ms, forward+backward "
        f"{autotuned['forward_backward_ms']:.2f} ms")
    log(f"[train] the no-grad forward's slowest convolutions (device ms, input "
        f"shapes): {slow_convs}")
    log(f"[train] one step under torch.profiler: wall {prof['wall_ms']:.1f} ms, device "
        f"busy {prof['device_busy_ms']:.1f} ms (share {prof['busy_share']}); top "
        f"kernels {prof['top_kernels_ms'][:3]}")
    return dict(launches=launches, chain_launches=chain_launches, ms_per_step=step_s * 1e3,
                mps=mp / step_s, plain_ms_per_step=plain_step_s * 1e3, losses=losses,
                plain_losses=plain_losses, max_rel_loss_diff=rel, peak_gb=peak_gb,
                parts=parts, autotuned_parts=autotuned, slow_convolutions=slow_convs,
                profile=prof)


def struct_pair(seed: int):
    """One batch of 4 seeded 352² uint8 pairs, NHWC: smooth clean frames,
    noisy = clean + N(0, 25), clipped."""
    import numpy as np

    clean = n2n_frames(seed + 2, TRAIN_B)[..., None]
    rng = np.random.default_rng(seed + 13)
    noisy = np.clip(clean + rng.normal(0, 25, clean.shape), 0, 255).astype(np.uint8)
    return clean, noisy


def _train_tensors(state):
    """Every parameter, Adam moment and Adam step count of a train state."""
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    return params + [t for p in params for t in state.optimizer.state[p].values()]


def phase_structure(seed: int):
    """The structure-loss step of ImprovedUNet-48 at batch 4 of 352²."""
    import numpy as np
    import torch

    from image_denoising_tpu_torch.losses import structure_loss
    from image_denoising_tpu_torch.models import ImprovedUNet
    from image_denoising_tpu_torch.ops.fused_block import fused_rdb_chain
    from image_denoising_tpu_torch.train import (create_train_state, make_l1_train_step,
                                                 make_structure_train_step, to_nchw01)
    from image_denoising_tpu_torch.train.steps import _guarded_update

    torch.manual_seed(seed)
    init = ImprovedUNet(in_nc=1, out_nc=1, n_feature=NF).state_dict()
    clean, noisy = struct_pair(seed)
    mp = TRAIN_B * TRAIN_FRAME ** 2 / 1e6
    fused_rdb_chain.launches = 0

    def run(dtype=None, remat=False, remat_depth=None, fused=True):
        model = ImprovedUNet(1, 1, NF, dtype=dtype, remat=remat, remat_depth=remat_depth)
        model.load_state_dict(init)
        model = model.to("cuda")
        state = create_train_state(model, lr=3e-4)
        step = make_structure_train_step(model, state, fused=fused)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, pending = [], None
        for i in range(TRAIN_WARMUP + TRAIN_STEPS):
            if i == TRAIN_WARMUP:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            # the step must not wait for the card: any op that would
            # raises here (the loss is fetched outside, one step late)
            torch.cuda.set_sync_debug_mode("error" if i >= TRAIN_WARMUP else 0)
            try:
                m = step(clean, noisy)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            if pending is not None:
                losses.append(float(pending["loss"]))
            pending = m
        losses.append(float(pending["loss"]))
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / TRAIN_STEPS
        if not np.all(np.isfinite(losses)):
            raise AssertionError(f"structure: non-finite loss {losses}")
        return dict(model=model, state=state, step=step, losses=losses,
                    ms=step_s * 1e3, mps=mp / step_s,
                    peak_gb=torch.cuda.max_memory_allocated() / 1e9)

    def release(r):
        for k in ("model", "state", "step"):
            r.pop(k, None)
        torch.cuda.empty_cache()

    def rel_diff(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    def parts(r):
        """forward (with autograd), forward+backward and Adam, and Adam with
        the guard, each alone on this run's batch."""
        model, state = r["model"], r["state"]
        dev = torch.device("cuda")
        c01, n01 = to_nchw01(clean, dev), to_nchw01(noisy, dev)
        both = torch.cat([n01, c01], 0)

        def fwd_bwd():
            out = model(both)
            loss = structure_loss(out[:TRAIN_B], out[TRAIN_B:], c01)
            loss.backward()
            return loss

        out = dict(forward_ms=time_ms(lambda: model(both), reps=3),
                   forward_backward_ms=time_ms(fwd_bwd, reps=3))
        loss = fwd_bwd().detach()
        out["adam_ms"] = time_ms(state.optimizer.step)
        out["adam_guard_ms"] = time_ms(lambda: _guarded_update(
            state, loss, grad_clip=None, max_loss_skip=5.0, max_grad_norm=20.0))
        state.optimizer.zero_grad(set_to_none=True)
        return out

    out = {}
    for dname in ("float32", "bfloat16"):
        r = run(dtype=torch.bfloat16 if dname == "bfloat16" else None)
        bound_ms = STRUCT_FLOP_PER_STEP / PEAK_OPS[dname] * 1e3
        r.update(bound_ms=bound_ms, share_of_bound=bound_ms / r["ms"], parts=parts(r))
        r["profile"] = prof = profile_window(
            lambda r=r: float(r["step"](clean, noisy)["loss"]))
        p = r["parts"]
        log(f"[structure] {dname:8s} step, ImprovedUNet-{NF}, batch {TRAIN_B}x"
            f"{TRAIN_FRAME}^2 as one batch-{2 * TRAIN_B} forward: {r['ms']:.2f} ms/step, "
            f"{r['mps']:.4f} MP/s of input frames, peak memory {r['peak_gb']:.2f} GB, "
            f"{r['share_of_bound']:.4f} of the {bound_ms:.2f} ms bound; timed steps "
            f"under set_sync_debug_mode('error')")
        log(f"[structure] {dname:8s} parts, each alone: forward {p['forward_ms']:.2f} ms, "
            f"forward+backward {p['forward_backward_ms']:.2f} ms, Adam {p['adam_ms']:.3f} "
            f"ms, Adam with the guard {p['adam_guard_ms']:.3f} ms")
        log(f"[structure] {dname:8s} one step under torch.profiler: wall "
            f"{prof['wall_ms']:.1f} ms, device busy {prof['device_busy_ms']:.1f} ms "
            f"(share {prof['busy_share']}); cuDNN FFT-path kernels "
            f"{prof['fft_ms']:.1f} ms; top kernels {prof['top_kernels_ms'][:3]}")
        release(r)
        out[dname] = r
    f32, bf16 = out["float32"]["losses"], out["bfloat16"]["losses"]
    step1, rel = abs(bf16[0] - f32[0]), rel_diff(bf16, f32)
    log(f"[structure] losses f32 {[round(x, 6) for x in f32]}; bf16 "
        f"{[round(x, 6) for x in bf16]}: step 1 |d| {step1:.3g} (limit "
        f"{BF16_STEP1_ABS}), largest relative {rel:.3g} (limit {BF16_REL})")
    if not (step1 < BF16_STEP1_ABS and rel < BF16_REL):
        raise AssertionError("structure: bf16 losses outside the envelope of f32")
    out["bf16_vs_f32"] = dict(step1_abs=step1, max_rel=rel)

    for name, kw, limit in (("two_forwards", dict(fused=False), TRAIN_LOSS_RTOL),
                            ("remat", dict(remat=True), REMAT_LOSS_RTOL),
                            ("remat_depth2", dict(remat=True, remat_depth=2),
                             REMAT_LOSS_RTOL)):
        r = run(**kw)
        release(r)
        r["max_rel_loss_diff"] = d = rel_diff(r["losses"], f32)
        log(f"[structure] float32 {name}: {r['ms']:.2f} ms/step, peak memory "
            f"{r['peak_gb']:.2f} GB (fused, no remat: {out['float32']['peak_gb']:.2f}); "
            f"losses within {d:.3g} of the fused run's (limit {limit})")
        if not d <= limit:
            raise AssertionError(f"structure {name}: losses differ by {d} > {limit}")
        if name != "two_forwards" and not r["peak_gb"] < out["float32"]["peak_gb"]:
            raise AssertionError(f"structure {name}: peak memory {r['peak_gb']} GB not "
                                 "below the run without remat")
        out[name] = r

    # the guarded L1 step at full width: a batch it takes, then one with a
    # NaN pixel that it must skip without touching any state
    model = ImprovedUNet(1, 1, NF)
    model.load_state_dict(init)
    model = model.to("cuda")
    state = create_train_state(model, lr=3e-4)
    step = make_l1_train_step(model, state, guards=True, grad_clip=1.0)
    c01, n01 = clean.astype(np.float32) / 255.0, noisy.astype(np.float32) / 255.0
    bad = c01.copy()
    bad[1, 100, 200, 0] = np.nan
    torch.cuda.set_sync_debug_mode("error")
    try:
        good_m = step(c01, n01)
        before = [t.clone() for t in _train_tensors(state)]
        bad_m = step(bad, n01)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    same = all(torch.equal(_bits(a), _bits(b))
               for a, b in zip(before, _train_tensors(state)))
    guard = dict(good_ok=bool(good_m["ok"]), good_grad_norm=float(good_m["grad_norm"]),
                 bad_ok=bool(bad_m["ok"]), skipped=int(state.skipped), step=int(state.step),
                 state_bit_equal=same)
    log(f"[structure] guarded L1 step (guards, grad_clip 1.0) at batch {TRAIN_B}x"
        f"{TRAIN_FRAME}^2 under set_sync_debug_mode('error'): clean batch ok "
        f"{guard['good_ok']} (grad norm {guard['good_grad_norm']:.4g}), NaN batch ok "
        f"{guard['bad_ok']}; skipped {guard['skipped']}, step {guard['step']}; "
        f"parameters and Adam state bit-equal across the skip: {same}")
    if not (guard["good_ok"] and not guard["bad_ok"] and guard["skipped"] == 1
            and guard["step"] == 1 and same):
        raise AssertionError(f"structure: the guard did not skip exactly: {guard}")
    out["guard"] = guard
    del model, state, step, before
    torch.cuda.empty_cache()

    out["chain_launches"] = fused_rdb_chain.launches
    if fused_rdb_chain.launches:
        raise AssertionError(f"structure: {fused_rdb_chain.launches} chain launches; "
                             "the trainer runs the module")
    return out


def phase_train_cli(seed: int):
    """cli/train.main for 1 epoch of 2 steps on 8 seeded 352² PNG pairs in a
    temporary directory under build/: --loss n2n, then the default
    (structure), then --dtype bfloat16 --remat_depth 2 --profile_dir."""
    import glob
    import tempfile

    import numpy as np
    from PIL import Image

    from image_denoising_tpu_torch.ckpt import load_checkpoint
    from image_denoising_tpu_torch.cli import train as train_cli
    from image_denoising_tpu_torch.models import ImprovedUNet
    from image_denoising_tpu_torch.ops.fused_block import fused_rdb_chain
    from image_denoising_tpu_torch.ops.neighbor import subsample_pair_fused

    build_dir = os.path.join(REPO, "build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        data = os.path.join(tmp, "data")
        rng = np.random.default_rng(seed + 11)
        for sub in ("clean", "noise"):
            os.makedirs(os.path.join(data, sub))
        for i, c in enumerate(n2n_frames(seed + 1, 2 * TRAIN_B)):
            noisy = np.clip(c + rng.normal(0, 25, c.shape), 0, 255).astype(np.uint8)
            Image.fromarray(c).save(os.path.join(data, "clean", f"sem{i:03d}.png"))
            Image.fromarray(noisy).save(os.path.join(data, "noise", f"sem{i:03d}.png"))
        trace_dir = os.path.join(tmp, "structure_trace")
        runs = (("n2n", ["--loss", "n2n"]), ("structure", []),
                ("structure_bf16_remat", ["--dtype", "bfloat16", "--remat_depth", "2",
                                          "--profile_dir", trace_dir]))
        out = {}
        for name, extra in runs:
            subsample_pair_fused.launches = 0
            fused_rdb_chain.launches = 0
            t0 = time.perf_counter()
            train_cli.main(["--data_dir", data, "--save_model_path", os.path.join(tmp, name),
                            "--arch", "UNetImproved", "--n_epoch", "1",
                            "--max_steps_per_epoch", "2", "--batchsize", str(TRAIN_B),
                            "--seed", str(seed)] + extra)
            sec = time.perf_counter() - t0
            launches = subsample_pair_fused.launches
            want = 2 if name == "n2n" else 0  # one per N2N step
            if launches != want or fused_rdb_chain.launches:
                raise AssertionError(f"train CLI {name}: {launches} sub-sampler launches "
                                     f"(want {want}), {fused_rdb_chain.launches} chain "
                                     "launches (want 0)")
            (run_dir,) = glob.glob(os.path.join(tmp, name, "*", "*"))
            for ckpt in ("epoch_model_000.ckpt", "epoch_model_001.ckpt"):
                ImprovedUNet(1, 1, NF).load_state_dict(
                    load_checkpoint(os.path.join(run_dir, ckpt), arch="UNetImproved"),
                    strict=True)
            with open(os.path.join(run_dir, "validation", "A_log.csv")) as f:
                a_log = f.read().strip()
            mean_loss = float(a_log.split("loss_")[1].split(",")[0])
            if not (a_log.startswith("epoch1,") and np.isfinite(mean_loss)):
                raise AssertionError(f"train CLI {name}: A_log.csv reads {a_log!r}")
            if len(glob.glob(os.path.join(run_dir, "validation", "*_denoised.png"))) != 1:
                raise AssertionError(f"train CLI {name}: no validation PNG")
            traces = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
            if "--profile_dir" in extra and not traces:
                raise AssertionError(f"train CLI {name}: no trace in {trace_dir}")
            out[name] = dict(seconds=sec, launches=launches, a_log=a_log)
            tag = "[train]" if name == "n2n" else "[structure]"
            log(f"{tag} cli.train.main {' '.join(extra[:4]) or '(defaults: structure)'}, "
                f"1 epoch of 2 steps at batch {TRAIN_B} of {TRAIN_FRAME}^2, validation of "
                f"8 frames: {sec:.2f} s; checkpoints 000/001 load strict; A_log.csv "
                f"{a_log!r}; sub-sampler launches {launches}"
                + (f"; trace {os.path.basename(traces[0])}" if traces else ""))
    return dict(out["n2n"], structure=out["structure"],
                structure_bf16_remat=out["structure_bf16_remat"])


def phase_hpo(seed: int):
    """cli/train_opt.main on the card: HPO_TRIALS trials and the retrain on
    HPO_FRAMES seeded 352² grayscale PNG pairs, storage and outputs in a
    temporary directory under build/, then a resumed study of one trial
    more; a trial trained again from its snapshot; the guarded L1 step
    timed alone at HPO_WIDTHS."""
    import glob
    import tempfile

    import numpy as np
    import torch

    from image_denoising_tpu_torch.ckpt import load_checkpoint
    from image_denoising_tpu_torch.cli import train_opt
    from image_denoising_tpu_torch.data import DenoiseDataset
    from image_denoising_tpu_torch.models import ImprovedUNet
    from image_denoising_tpu_torch.ops.fused_block import fused_rdb_chain
    from image_denoising_tpu_torch.ops.neighbor import subsample_pair_fused
    from image_denoising_tpu_torch.train import (create_train_state, hpo_milestones,
                                                 make_l1_train_step)

    def strict(path, nf):
        model = ImprovedUNet(1, 1, nf)
        model.load_state_dict(load_checkpoint(path, arch="UNetImproved"), strict=True)
        return model

    phase_t0 = time.perf_counter()
    build_dir = os.path.join(REPO, "build")
    os.makedirs(build_dir, exist_ok=True)
    out = {}
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        data = os.path.join(tmp, "data")
        rng = np.random.default_rng(seed + 13)
        clean = n2n_frames(seed + 12, HPO_FRAMES)
        _write_pairs(data, clean, [np.clip(c + rng.normal(0, 25, c.shape), 0, 255)
                                   .astype(np.uint8) for c in clean])
        trials_log = os.path.join(tmp, "trials.log")
        args = ["--data_dir", data, "--save_model_path", os.path.join(tmp, "results"),
                "--log_name", "hpo", "--tune_epochs", "1", "--n_epoch", "2",
                "--batchsize", str(HPO_B), "--storage",
                f"sqlite:///{os.path.join(tmp, 'hpo.db')}", "--trials_log", trials_log]
        fused_rdb_chain.launches = 0
        subsample_pair_fused.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()  # the wall clock of the trials' completion stamps
        study = train_opt.main(args + ["--n_trials", str(HPO_TRIALS)])
        torch.cuda.synchronize()
        run_s = time.time() - t0
        if fused_rdb_chain.launches or subsample_pair_fused.launches:
            raise AssertionError("hpo: the HPO path launched a kernel (it runs none)")
        trials = study.trials
        if len(trials) != HPO_TRIALS or not all(np.isfinite(t.value) for t in trials):
            raise AssertionError(f"hpo: {len(trials)} trials, values "
                                 f"{[t.value for t in trials]}")
        with open(trials_log) as f:
            recs = [json.loads(line) for line in f]
        if len(recs) != HPO_TRIALS or any(r["device"] != 0 for r in recs):
            raise AssertionError(f"hpo: trials.log holds {recs}")
        for t in trials:
            model = strict(t.user_attrs["init_weight_path"], t.params["n_feature"])
            if train_opt.w0_sum(model) != t.user_attrs["w0_sum"]:
                raise AssertionError(f"hpo: trial {t.number}'s snapshot sums to "
                                     f"{train_opt.w0_sum(model)!r}, the trial recorded "
                                     f"{t.user_attrs['w0_sum']!r}")
        done = [t0] + [t.datetime_complete.timestamp() for t in trials]
        trial_s = [b - a for a, b in zip(done, done[1:])]
        (run_dir,) = glob.glob(os.path.join(tmp, "results", "hpo", "*"))
        best = study.best_trial
        strict(os.path.join(run_dir, "epoch_final_002.ckpt"), best.params["n_feature"])
        with open(os.path.join(run_dir, "validation", "A_log.csv")) as f:
            rows = f.read().strip().splitlines()[1:]
        a_log = [[float(v) for v in r.split(", ")] for r in rows]
        if len(a_log) != 2 or not np.all(np.isfinite(a_log)):
            raise AssertionError(f"hpo: A_log.csv rows {rows}")
        # the retrain's epochs as the CLI timed them (train_time, to the
        # epoch's loss fetch), per step
        epoch_steps = -(-HPO_FRAMES // HPO_B)
        retrain_step_ms = [row[2] / epoch_steps * 1e3 for row in a_log]
        log(f"[hpo] cli.train_opt.main, {HPO_TRIALS} trials of 1 epoch and a 2-epoch "
            f"retrain at batch {HPO_B} of {HPO_FRAMES} frames of {TRAIN_FRAME}^2: "
            f"{run_s:.2f} s; seconds per trial (to its completion stamp; the first with "
            f"the dataset's load) {', '.join(f'{x:.2f}' for x in trial_s)}; trials "
            + "; ".join(f"{t.number}: n_feature {t.params['n_feature']}, lr "
                        f"{t.params['lr']:.3g}, loss {t.value:.6f}" for t in trials)
            + f"; best {best.number}; the retrain at n_feature {best.params['n_feature']}: "
            f"{', '.join(f'{x:.1f}' for x in retrain_step_ms)} ms/step (A_log.csv, "
            f"{epoch_steps} steps an epoch); trials.log {len(recs)} lines, device 0; every "
            f"snapshot strict with its w0_sum exact; epoch_final_002.ckpt strict; A_log.csv "
            f"{len(a_log)} finite rows")

        # resume: the same storage, one trial more
        t1 = time.time()
        study2 = train_opt.main(args + ["--n_trials", "1"])
        resume_s = time.time() - t1
        if len(study2.trials) != HPO_TRIALS + 1 or study2.trials[-1].number != HPO_TRIALS:
            raise AssertionError(f"hpo: the resumed study holds {len(study2.trials)} trials")
        strict(study2.trials[-1].user_attrs["init_weight_path"],
               study2.trials[-1].params["n_feature"])

        # trial 0 again from its snapshot: XLA is deterministic, cuDNN may not be
        t = trials[0]
        model = strict(t.user_attrs["init_weight_path"], t.params["n_feature"]).to("cuda")
        ds = DenoiseDataset(data, convert_l=True)
        again = train_opt.train_epochs(model, ds, t.params["lr"], t.user_attrs["init_seed"],
                                       1, hpo_milestones(1), HPO_B)
        log(f"[hpo] resumed with --n_trials 1: {len(study2.trials)} trials, {resume_s:.2f} s; "
            f"trial 0 trained again from its snapshot: loss {again!r} against {t.value!r} "
            f"({'equal' if again == t.value else 'NOT equal: cuDNN ran another order'})")
        out.update(seconds=run_s, trial_seconds=trial_s, resume_seconds=resume_s,
                   retrain_step_ms=retrain_step_ms,
                   trials=[dict(number=t.number, params=t.params, value=t.value,
                                device=t.user_attrs["device"], w0_sum=t.user_attrs["w0_sum"])
                           for t in study2.trials],
                   a_log=a_log, rerun_loss=again, rerun_equal=again == t.value)
        del model

        # the guarded L1 step alone, float32, at batch HPO_B of 352^2
        batches = [b for b in ds.batches(HPO_B, np.random.default_rng(seed), shuffle=True)]
        steps = {}
        for nf in HPO_WIDTHS:
            torch.manual_seed(seed)
            model = ImprovedUNet(1, 1, nf).to("cuda")
            state = create_train_state(model, lr=1e-4, weight_decay=1e-5)
            step = make_l1_train_step(model, state, guards=True, grad_clip=1.0,
                                      inputs_01=False)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            pending, losses = None, []
            for i in range(TRAIN_WARMUP + HPO_STEPS):
                if i == TRAIN_WARMUP:
                    torch.cuda.synchronize()
                    t2 = time.perf_counter()
                torch.cuda.set_sync_debug_mode("error" if i >= TRAIN_WARMUP else 0)
                try:
                    m = step(*batches[i % len(batches)])
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                if pending is not None:
                    losses.append(float(pending["loss"]))
                pending = m
            losses.append(float(pending["loss"]))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t2) / HPO_STEPS * 1e3
            peak = torch.cuda.max_memory_allocated() / 1e9
            if not (np.all(np.isfinite(losses)) and int(state.step) == len(losses)):
                raise AssertionError(f"hpo: L1 step at n_feature {nf}: losses {losses}, "
                                     f"{int(state.step)} updates kept")
            steps[nf] = dict(ms=ms, peak_gb=peak, losses=losses)
            log(f"[hpo] guarded L1 step, ImprovedUNet-{nf}, batch {HPO_B} of "
                f"{TRAIN_FRAME}^2, float32 (TF32 off): {ms:.2f} ms/step over {HPO_STEPS} "
                f"steps with no sync; peak {peak:.2f} GB")
            del model, state, step, pending, m
            torch.cuda.empty_cache()
        out["l1_step"] = steps
    out["phase_seconds"] = time.perf_counter() - phase_t0
    log(f"[hpo] the phase: {out['phase_seconds']:.2f} s")
    return out


def phase_launch_floor():
    """The card's least time per launch: an empty sm_90a kernel
    (csrc/neighbor.cu) issued back to back from C, timed with CUDA events,
    and its device time from torch.profiler."""
    import ctypes

    import torch

    from image_denoising_tpu_torch.ops._build import load_neighbor

    lib = load_neighbor()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def launch(n):
        if lib.idt_empty_launches(n, stream) != 0:
            raise AssertionError("the empty kernel did not launch")

    launch(100)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    launch(FT_EMPTY_LAUNCHES)
    end.record()
    end.synchronize()
    per_launch_ms = start.elapsed_time(end) / FT_EMPTY_LAUNCHES
    device_ms = kernel_device_ms(lambda: launch(1), "empty_kernel")
    log(f"[kernels] launch floor: an empty sm_90a kernel issued {FT_EMPTY_LAUNCHES} times "
        f"back to back from C takes {per_launch_ms * 1e3:.3f} us per launch; its device "
        f"time {device_ms * 1e3:.3f} us (torch.profiler)")
    return dict(back_to_back_ms=per_launch_ms, device_ms=device_ms)


def _write_pairs(root, clean, noise):
    """PNG pairs under root/clean and root/noise, as the CLIs read them."""
    from PIL import Image

    for sub, frames in (("clean", clean), ("noise", noise)):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        for i, f in enumerate(frames):
            Image.fromarray(f).save(os.path.join(root, sub, f"sem{i:03d}.png"))


def phase_finetune(seed: int, keep_dir: str):
    """The B-domain loop on the card: a .ckpt base written and read back, 12
    memory finetune steps at the launcher preset with a float32 and E6's
    int8/uint8 bank, each against the same steps with the plain retrieval
    and the module base, and short runs of the three finetune CLIs with the
    E6 CLI serving the adapter the memory finetuner wrote. The base and the
    three CLIs' checkpoints are copied into ``keep_dir`` for [serving]
    (``out["kept"]``)."""
    import tempfile

    import numpy as np
    import torch

    from image_denoising_tpu_torch.adapters import (DenoiserWithMemoryAdapter,
                                                    build_memory_adapter, wrappers)
    from image_denoising_tpu_torch.ckpt import load_checkpoint, save_checkpoint
    from image_denoising_tpu_torch.data import DenoisePatchDataset
    from image_denoising_tpu_torch.losses import estimate_intensity_thresholds
    from image_denoising_tpu_torch.memory import MemoryBank, build_memory_bank_from_frames
    from image_denoising_tpu_torch.memory.retrieval import (top1_l2_retrieval,
                                                            top1_l2_retrieval_reference)
    from image_denoising_tpu_torch.models import ImprovedUNet, make_fused_forward
    from image_denoising_tpu_torch.ops.fused_block import fused_rdb_chain
    from image_denoising_tpu_torch.train import create_train_state, make_memory_finetune_step

    build_dir = os.path.join(REPO, "build")
    os.makedirs(build_dir, exist_ok=True)
    tmp_ctx = tempfile.TemporaryDirectory(dir=build_dir)
    tmp = tmp_ctx.name
    clean, noise, _ = e6_frames(seed)
    data = os.path.join(tmp, "data")
    _write_pairs(data, clean, noise)
    t1, t2 = estimate_intensity_thresholds(data)
    iqsl_cfg = {"t1": t1, "t2": t2, "tau": 0.1, "margin": 0.0, "ce_factor": 0.5}
    out = dict(iqsl_thresholds=(t1, t2))

    # the base through the port's .ckpt writer and reader
    torch.manual_seed(seed)
    model = ImprovedUNet(in_nc=1, out_nc=1, n_feature=NF).eval()
    base_ckpt = save_checkpoint(model, os.path.join(tmp, "base"), "model", 1)
    back = ImprovedUNet(in_nc=1, out_nc=1, n_feature=NF)
    back.load_state_dict(load_checkpoint(base_ckpt, arch="UNetImproved"), strict=True)
    back = back.eval()
    same_sd = all(torch.equal(_bits(a), _bits(b)) for a, b in
                  zip(model.state_dict().values(), back.state_dict().values()))
    x_probe = torch.rand((FT_B, 1, E6_TILE, E6_TILE), device="cuda")
    fwd = make_fused_forward(model, device="cuda")
    same_fwd = torch.equal(_bits(fwd(x_probe)),
                           _bits(make_fused_forward(back, device="cuda")(x_probe)))
    with torch.inference_mode():
        module_cuda = copy.deepcopy(model).to("cuda")
        same_module = torch.equal(_bits(module_cuda(x_probe)),
                                  _bits(copy.deepcopy(back).to("cuda")(x_probe)))
    log(f"[finetune] base ImprovedUNet-{NF} (seeded) written as "
        f"{os.path.basename(base_ckpt)} ({os.path.getsize(base_ckpt)} bytes) and read "
        f"back: state dict bit-equal {same_sd}, fused forward bit-equal {same_fwd}, "
        f"module forward bit-equal {same_module}; IQSL thresholds t1={t1:.6f} t2={t2:.6f}")
    if not (same_sd and same_fwd and same_module):
        raise AssertionError("finetune: the .ckpt round trip changed the base")

    # the banks: E6's int8/uint8 bank, and the float32 one from the same bytes
    t0 = time.perf_counter()
    bank8 = build_memory_bank_from_frames(clean, noise, E6_TILE, E6_STRIDE,
                                          bank_dtype="int8", clean_dtype="uint8",
                                          device="cuda")
    torch.cuda.synchronize()
    n = E6_BANK_ROWS
    assert tuple(bank8.noise_flat.shape) == (n, PATCH_D)
    log(f"[finetune] bank: {n} patches of {E6_TILE}^2 at stride {E6_STRIDE}, int8 noise + "
        f"uint8 clean ({time.perf_counter() - t0:.2f} s on the host and copy); the "
        "float32 + float32 bank is made on the card from the same bytes after the "
        "int8 runs")

    dataset = DenoisePatchDataset(data, patch_size=E6_TILE, patches_per_image=FT_PATCHES)
    log(f"[finetune] patch stream: "
        f"{'native sampler' if dataset.native is not None else 'numpy stream'}")
    stream = dataset.batches(FT_B, np.random.default_rng(seed))
    batches = [next(stream) for _ in range(TRAIN_WARMUP + TRAIN_STEPS)]
    base_before = [t.clone() for t in model.state_dict().values()]
    probe_before = fwd(x_probe).clone()
    module_call = torch.inference_mode()(lambda t: module_cuda(t))
    mp = FT_B * E6_TILE ** 2 / 1e6

    def run(bank, base_call, retrieval):
        """12 steps from one adapter init: (losses, indices per step, step
        seconds, peak GB, launches, state, step, adapter)."""
        torch.manual_seed(seed)
        adapter = build_memory_adapter("hyper_gated_fft", 1, E6_HIDDEN).to("cuda")
        state = create_train_state(adapter, lr=FT_LR)
        step = make_memory_finetune_step(DenoiserWithMemoryAdapter(base_call, adapter), state,
                                         lambda_grad=FT_LAMBDA, lambda_iqsl=FT_LAMBDA,
                                         iqsl_cfg=iqsl_cfg)
        picked = []

        def recording(q, b, sq):
            idx = retrieval(q, b, sq)
            picked.append(idx)
            return idx

        wrappers.top1_l2_retrieval = recording
        losses, pending = [], None
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for i, (c, nz) in enumerate(batches):
                if i == TRAIN_WARMUP:
                    torch.cuda.synchronize()
                    fused_rdb_chain.launches = 0
                    top1_l2_retrieval.launches = 0
                    t0 = time.perf_counter()
                torch.cuda.set_sync_debug_mode("error" if i >= TRAIN_WARMUP else 0)
                try:
                    m = step(c, nz, bank.noise_flat, bank.clean, bank.sq_norms)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                if pending is not None:
                    losses.append([float(pending[k]) for k in ("loss", "l1", "grad", "iqsl")])
                pending = m
            losses.append([float(pending[k]) for k in ("loss", "l1", "grad", "iqsl")])
            torch.cuda.synchronize()
            step_s = (time.perf_counter() - t0) / TRAIN_STEPS
        finally:
            wrappers.top1_l2_retrieval = top1_l2_retrieval
        launches = dict(fused_rdb_chain=fused_rdb_chain.launches,
                        top1_l2_retrieval=top1_l2_retrieval.launches)
        if not np.all(np.isfinite(losses)):
            raise AssertionError(f"finetune: non-finite losses {losses}")
        return dict(losses=losses, picked=picked, ms=step_s * 1e3, mps=mp / step_s,
                    peak_gb=torch.cuda.max_memory_allocated() / 1e9, launches=launches,
                    state=state, step=step, adapter=adapter)

    # int8 first, then the float32 bank in its place: each run's peak holds
    # its own bank only
    bank = bank8
    for name in ("int8", "float32"):
        if name == "float32":
            noise32 = (bank.noise_flat.float() + 128.0) / 255.0
            bank = MemoryBank(noise32, wrappers._clean01(bank.clean), (noise32 ** 2).sum(1),
                              E6_TILE, E6_STRIDE)
            del noise32, bank8
            torch.cuda.empty_cache()
        bank_gb = sum(t.numel() * t.element_size()
                      for t in (bank.noise_flat, bank.clean, bank.sq_norms)) / 1e9
        r = run(bank, fwd, top1_l2_retrieval)
        want = dict(fused_rdb_chain=9 * TRAIN_STEPS, top1_l2_retrieval=TRAIN_STEPS)
        if r["launches"] != want:
            raise AssertionError(f"finetune {name}: launches {r['launches']}, want {want}")
        y = run(bank, module_call, top1_l2_retrieval_reference)
        if y["launches"] != dict(fused_rdb_chain=0, top1_l2_retrieval=0):
            raise AssertionError(f"finetune {name}: the plain run launched {y['launches']}")
        got, ref = np.asarray(r["losses"]), np.asarray(y["losses"])
        rel = float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1e-12)))
        idx_diff = [int((a != b).sum()) for a, b in zip(r["picked"], y["picked"])]
        log(f"[finetune] {name} bank: losses (total, l1, grad, iqsl) of the "
            f"{TRAIN_WARMUP}+{TRAIN_STEPS} steps within {rel:.3g} relative of the plain "
            f"retrieval + module base run (limit {TRAIN_LOSS_RTOL}); retrieved indices "
            f"differ in {sum(idx_diff)} of {FT_B * len(batches)}")
        if not rel <= TRAIN_LOSS_RTOL:
            raise AssertionError(f"finetune {name}: losses differ by {rel}")
        if name == "int8" and sum(idx_diff):
            raise AssertionError(f"finetune int8: indices differ from the plain run "
                                 f"{idx_diff}")

        # the step's parts, each alone on the last batch
        c, nz = batches[-1]
        dev = torch.device("cuda")
        clean01 = torch.from_numpy(c).to(dev).permute(0, 3, 1, 2).contiguous()
        noisy01 = torch.from_numpy(nz).to(dev).permute(0, 3, 1, 2).contiguous()
        adapter, state = r["adapter"], r["state"]
        with torch.inference_mode():
            base_out = fwd(noisy01).float()
            mem = wrappers.select_memory_patch(noisy01.permute(0, 2, 3, 1), bank.noise_flat,
                                               bank.clean, bank.sq_norms).permute(0, 3, 1, 2)
        base_out, mem = base_out.clone(), mem.clone()

        def adapter_fwd_bwd():
            from image_denoising_tpu_torch.train.finetune_steps import _total_loss

            loss, _ = _total_loss(adapter(noisy01, base_out, mem), clean01, FT_LAMBDA,
                                  FT_LAMBDA, iqsl_cfg)
            loss.backward()

        parts = dict(
            base_forward_ms=time_ms(lambda: fwd(noisy01), reps=5),
            retrieval_ms=time_ms(lambda: wrappers.select_memory_patch(
                noisy01.permute(0, 2, 3, 1), bank.noise_flat, bank.clean, bank.sq_norms),
                reps=5),
            adapter_forward_backward_loss_ms=time_ms(adapter_fwd_bwd, reps=5),
            adam_ms=time_ms(state.optimizer.step, reps=5))
        state.optimizer.zero_grad(set_to_none=True)
        prof = profile_window(lambda: float(r["step"](
            c, nz, bank.noise_flat, bank.clean, bank.sq_norms)["loss"]))
        counts = prof["launch_counts"]
        chain_dev = sum(v for k, v in counts.items() if any(x in k for x in CHAIN_KERNELS))
        top1_dev = sum(v for k, v in counts.items() if "top1_kernel" in k)
        if not (chain_dev > 0 and top1_dev > 0):
            raise AssertionError(f"finetune {name}: the profiled step ran chain "
                                 f"{chain_dev} and retrieval {top1_dev} kernels")
        log(f"[finetune] {name} bank, step of ImprovedUNet-{NF} base + hyper_gated_fft "
            f"(hidden {E6_HIDDEN}) at batch {FT_B}x{E6_TILE}^2, N={n}: {r['ms']:.2f} ms/step, "
            f"{r['mps']:.4f} MP/s of input, peak memory {r['peak_gb']:.2f} GB (the bank "
            f"{bank_gb:.2f} GB of it; plain "
            f"retrieval + module base: {y['ms']:.2f} ms/step); timed steps under "
            f"set_sync_debug_mode('error'); launches per step: chain "
            f"{r['launches']['fused_rdb_chain'] / TRAIN_STEPS:g}, retrieval "
            f"{r['launches']['top1_l2_retrieval'] / TRAIN_STEPS:g}")
        log(f"[finetune] {name} bank parts, each alone: base forward "
            f"{parts['base_forward_ms']:.3f} ms, retrieval {parts['retrieval_ms']:.3f} ms, "
            f"adapter forward+backward+loss {parts['adapter_forward_backward_loss_ms']:.3f} "
            f"ms, Adam {parts['adam_ms']:.3f} ms")
        log(f"[finetune] {name} bank, one step under torch.profiler: wall "
            f"{prof['wall_ms']:.1f} ms, device busy {prof['device_busy_ms']:.1f} ms (share "
            f"{prof['busy_share']}); device launches of the chain kernel's functions "
            f"{chain_dev}, of the retrieval kernel {top1_dev}; chain {prof['chain_ms']:.2f} "
            f"ms; top kernels {prof['top_kernels_ms'][:3]}")
        out[name] = dict(ms_per_step=r["ms"], mps=r["mps"], peak_gb=r["peak_gb"],
                         bank_gb=bank_gb,
                         launches=r["launches"], losses=r["losses"],
                         plain_losses=y["losses"], plain_ms_per_step=y["ms"],
                         max_rel_loss_diff=rel, index_differences=idx_diff, parts=parts,
                         profile=prof, profiled_chain_launches=chain_dev,
                         profiled_retrieval_launches=top1_dev)
        del r, y, adapter, state
        torch.cuda.empty_cache()

    same_base = all(torch.equal(_bits(a), _bits(b))
                    for a, b in zip(base_before, model.state_dict().values()))
    same_probe = torch.equal(_bits(probe_before), _bits(fwd(x_probe)))
    log(f"[finetune] base parameters bit-equal before and after the runs: {same_base}; "
        f"its fused forward bit-equal: {same_probe}")
    if not (same_base and same_probe):
        raise AssertionError("finetune: the frozen base changed")
    del bank, module_cuda
    torch.cuda.empty_cache()
    out["cli"] = _finetune_clis(data, base_ckpt, tmp, seed)
    out["kept"] = {name: shutil.copy(path, os.path.join(keep_dir, f"{name}.ckpt"))
                   for name, path in [("base", base_ckpt)] + [
                       (k, v["path"]) for k, v in out["cli"].items() if "path" in v]}
    tmp_ctx.cleanup()
    return out


def _finetune_clis(data, base_ckpt, tmp, seed):
    """The three finetune CLIs for 1 epoch of --patches_per_image 2 (10
    patches: batches of 4, 4 and a tail of 2) over the .ckpt base, then the
    E6 CLI serving the adapter finetune_memory wrote."""
    import glob

    import numpy as np

    from image_denoising_tpu_torch.ckpt import load_params_tree
    from image_denoising_tpu_torch.cli import (evaluation_704_iqsl_memory, finetune,
                                               finetune_iqsl, finetune_memory)
    from image_denoising_tpu_torch.memory.retrieval import top1_l2_retrieval
    from image_denoising_tpu_torch.ops.fused_block import fused_rdb_chain

    common = ["--data_dir", data, "--pretrained_ckpt", base_ckpt, "--n_epoch", "1",
              "--patches_per_image", "2", "--seed", str(seed)]
    bank_flags = ["--memory_stride", str(E6_STRIDE), "--bank_dtype", "int8",
                  "--clean_bank_dtype", "uint8"]
    runs = (("finetune", finetune.main, [], "adapter"),
            ("finetune_iqsl", finetune_iqsl.main, [], "adapter_only"),
            ("finetune_memory", finetune_memory.main, bank_flags, "adapter_only"))
    out = {}
    for name, main, extra, role in runs:
        fused_rdb_chain.launches = 0
        top1_l2_retrieval.launches = 0
        save = os.path.join(tmp, name)
        t0 = time.perf_counter()
        with patch_streams() as seen:
            state = main(common + extra + ["--save_model_path", save])
        sec = time.perf_counter() - t0
        launches = dict(fused_rdb_chain=fused_rdb_chain.launches,
                        top1_l2_retrieval=top1_l2_retrieval.launches)
        (ckpt,) = glob.glob(os.path.join(save, "*", f"epoch_{role}_001.ckpt"))
        tree = load_params_tree(ckpt)
        pngs = glob.glob(os.path.join(save, "*", "val_*", "*.png"))
        ok = (int(state.step) == 3 and launches["fused_rdb_chain"] > 0 and pngs
              and (launches["top1_l2_retrieval"] > 0 or name != "finetune_memory")
              and (sorted(tree) == ["adapter", "base"]) == (role == "adapter")
              and [r["native"] for r in seen] == [True])
        out[name] = dict(seconds=sec, launches=launches, steps=int(state.step),
                         checkpoint=os.path.basename(ckpt), pngs=len(pngs), path=ckpt,
                         stream=stream_name(seen))
        log(f"[finetune] cli.{name}.main, 1 epoch of 10 patches (batches 4, 4, 2) over "
            f"the .ckpt base, patch stream: {stream_name(seen)}: {sec:.2f} s; "
            f"{int(state.step)} steps; wrote "
            f"{os.path.basename(ckpt)}; {len(pngs)} validation PNG(s); launches {launches}")
        if not ok:
            raise AssertionError(f"finetune CLI {name}: {out[name]}")
        if name == "finetune_memory":
            adapter_ckpt = ckpt
    fused_rdb_chain.launches = 0
    top1_l2_retrieval.launches = 0
    t0 = time.perf_counter()
    avg = evaluation_704_iqsl_memory.main([
        "--data_dir", data, "--base_ckpt", base_ckpt, "--adapter_ckpt", adapter_ckpt,
        "--frame_burst", "4", "--save_images", "none",
        "--save_dir", os.path.join(tmp, "e6")] + bank_flags)
    sec = time.perf_counter() - t0
    launches = dict(fused_rdb_chain=fused_rdb_chain.launches,
                    top1_l2_retrieval=top1_l2_retrieval.launches)
    out["e6"] = dict(seconds=sec, psnr=avg["psnr"], launches=launches)
    log(f"[finetune] cli.evaluation_704_iqsl_memory.main serving "
        f"{os.path.basename(adapter_ckpt)} over the .ckpt base ({E6_PAIRS} frames, bursts "
        f"of 4, int8/uint8 bank): {sec:.2f} s, average PSNR {avg['psnr']:.4f} dB; "
        f"launches {launches}")
    if not (np.isfinite(avg["psnr"]) and all(launches.values())):
        raise AssertionError(f"finetune: E6 CLI over the finetuned adapter: {out['e6']}")
    return out


# [data]: the finetuners' patch stream. The native sampler (csrc/patch_sampler.cpp)
# against its plain numpy version over one shuffled epoch at the finetune
# preset (5 pairs of 704², patch 128, batch 4, 16 patches a pair: 20 batches)
# with 1 and 4 threads, and at an odd shape (C = 3 frames of 130 x 200, patch
# 127, 2 pairs of 3 patches: batches of 4 and a tail of 2); host ms per batch
# at batch 4 and 32 (DATA_TIME_BATCHES calls each); then the memory finetuner
# through its CUDA twin's flags for 1 epoch
DATA_THREADS = (1, 4)
DATA_ODD = dict(c=3, h=130, w=200, patch=127, pairs=2, per_image=3)
DATA_TIME_BATCHES, DATA_TIME_CALLS = (4, 32), 20
DATA_TWIN = os.path.join("scripts", "cuda", "finetune_memory.sh")


@contextlib.contextmanager
def patch_streams():
    """Record each DenoisePatchDataset.batches stream in the block: whether
    the native sampler drew it, and (a copy of) its first batch, which is
    what a finetune CLI's first step receives."""
    from image_denoising_tpu_torch.data import pairs

    orig = pairs.DenoisePatchDataset.batches
    seen = []

    def batches(self, *args, **kwargs):
        rec = dict(native=self.native is not None, first=None)
        seen.append(rec)
        for i, b in enumerate(orig(self, *args, **kwargs)):
            if i == 0:
                rec["first"] = (b[0].copy(), b[1].copy())
            yield b

    pairs.DenoisePatchDataset.batches = batches
    try:
        yield seen
    finally:
        pairs.DenoisePatchDataset.batches = orig


def stream_name(seen) -> str:
    kinds = {"native sampler" if r["native"] else "numpy stream" for r in seen}
    return " + ".join(sorted(kinds)) or "none"


def plain_patch_epoch(images, per_image, batch, patch, rng):
    """One epoch of DenoisePatchDataset's native stream (tail batch kept)
    from the plain sampler: the shuffle of the items, the batch seed drawn
    after it, and each batch keyed by its index, its items mapped to their
    pairs."""
    import numpy as np

    from image_denoising_tpu_torch.data.native_sampler import sample_plain

    order = np.arange(len(images) * per_image)
    rng.shuffle(order)
    batch_seed = int(rng.integers(0, 2**63 - 1))
    return [sample_plain(images, batch_seed, bi, order[s:s + batch] // per_image, patch)
            for bi, s in enumerate(range(0, len(order), batch))]


def _same_batches(got, want) -> bool:
    import numpy as np

    return len(got) == len(want) and all(
        g.shape == w.shape and np.array_equal(g.view(np.uint32), w.view(np.uint32))
        for gb, wb in zip(got, want) for g, w in zip(gb, wb))


def phase_data(seed: int, step_ms: float):
    """The finetuners' patch stream on the card's machine: the native
    sampler bit-equal to its plain version through DenoisePatchDataset, its
    host ms per batch beside the numpy stream's and the plain version's,
    then the memory finetuner run through scripts/cuda/finetune_memory.sh's
    flags (data, base and output swapped, 1 epoch): its first batch the
    plain sampler's batch 0, its adapter .ckpt read back, its launches.
    ``step_ms`` is [finetune]'s float32 ms/step, logged beside the sampler's
    ms per batch."""
    import re
    import tempfile

    import numpy as np
    import torch

    from image_denoising_tpu_torch.adapters import build_memory_adapter
    from image_denoising_tpu_torch.ckpt import load_checkpoint, save_checkpoint
    from image_denoising_tpu_torch.cli import finetune_memory
    from image_denoising_tpu_torch.cli.launchers import flag_values, read_launcher
    from image_denoising_tpu_torch.data import DenoisePatchDataset
    from image_denoising_tpu_torch.data.native_sampler import NativePatchSampler, sample_plain
    from image_denoising_tpu_torch.memory.retrieval import top1_l2_retrieval
    from image_denoising_tpu_torch.models import ImprovedUNet
    from image_denoising_tpu_torch.ops.fused_block import fused_rdb_chain

    t_phase = time.perf_counter()
    build_dir = os.path.join(REPO, "build")
    os.makedirs(build_dir, exist_ok=True)
    tmp_ctx = tempfile.TemporaryDirectory(dir=build_dir)
    tmp = tmp_ctx.name
    clean, noise, _ = e6_frames(seed)
    data = os.path.join(tmp, "data")
    _write_pairs(data, clean, noise)
    out = {}

    # the preset's epoch, native against plain, with 1 and 4 threads
    ds = DenoisePatchDataset(data, patch_size=E6_TILE, patches_per_image=FT_PATCHES)
    if ds.native is None:
        raise AssertionError("data: the uint8 preset frames did not take the native sampler")
    images = [(c.astype(np.uint8), n.astype(np.uint8)) for c, n in ds.images]
    want = plain_patch_epoch(images, FT_PATCHES, FT_B, E6_TILE, np.random.default_rng(seed))
    for threads in DATA_THREADS:
        ds.native.n_threads = threads
        got = list(ds.batches(FT_B, np.random.default_rng(seed)))
        same = _same_batches(got, want)
        log(f"[data] native sampler, {threads} thread(s): one shuffled epoch of "
            f"{len(got)} batches of {FT_B} x {E6_TILE}^2 from {len(images)} {FRAME}^2 uint8 "
            f"pairs through DenoisePatchDataset.batches, bit-equal to the plain version: "
            f"{same}")
        if not (same and len(got) == E6_PAIRS * FT_PATCHES // FT_B):
            raise AssertionError(f"data: native sampler ({threads} threads) differs from "
                                 "the plain version at the preset")
    out["preset_batches"] = len(want)

    # an odd shape: RGB frames, a patch of 127, a tail batch of 2
    odd = DATA_ODD
    rng = np.random.default_rng(seed + 11)
    odd_frames = [rng.integers(0, 256, (odd["h"], odd["w"], odd["c"])).astype(np.uint8)
                  for _ in range(2 * odd["pairs"])]
    odd_dir = os.path.join(tmp, "odd")
    _write_pairs(odd_dir, odd_frames[:odd["pairs"]], odd_frames[odd["pairs"]:])
    ds_odd = DenoisePatchDataset(odd_dir, patch_size=odd["patch"],
                                 patches_per_image=odd["per_image"])
    odd_images = [(c.astype(np.uint8), n.astype(np.uint8)) for c, n in ds_odd.images]
    got = list(ds_odd.batches(FT_B, np.random.default_rng(seed)))
    want_odd = plain_patch_epoch(odd_images, odd["per_image"], FT_B, odd["patch"],
                                 np.random.default_rng(seed))
    sizes = [c.shape[0] for c, _ in got]
    same = (ds_odd.native is not None and _same_batches(got, want_odd)
            and sizes == [4, 2] and got[0][0].shape[1:] == (odd["patch"], odd["patch"], 3))
    log(f"[data] native sampler at C = {odd['c']}, {odd['h']} x {odd['w']} frames, patch "
        f"{odd['patch']}: batches of {sizes}, bit-equal to the plain version: {same}")
    if not same:
        raise AssertionError("data: native sampler differs from the plain version at the "
                             "odd shape")

    # host ms per batch: the native sampler (4 threads), the numpy stream, the
    # plain version
    ds.native.n_threads = 4
    ds_np = DenoisePatchDataset(data, patch_size=E6_TILE, patches_per_image=FT_PATCHES,
                                use_native=False)
    one_thread = NativePatchSampler(images, n_threads=1)
    n_items = len(ds)
    timing = {}
    for batch in DATA_TIME_BATCHES:
        rng = np.random.default_rng(seed + batch)
        idxs = [rng.integers(0, n_items, batch) for _ in range(DATA_TIME_CALLS)]

        def numpy_batch(i, bi):
            pairs = [ds_np.sample(int(k), rng) for k in i]
            return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])

        fns = dict(
            native=lambda i, bi: ds.native.sample(seed, bi, i // FT_PATCHES, E6_TILE),
            native_1_thread=lambda i, bi: one_thread.sample(seed, bi, i // FT_PATCHES,
                                                            E6_TILE),
            numpy=numpy_batch,
            plain=lambda i, bi: sample_plain(images, seed, bi, i // FT_PATCHES, E6_TILE))
        row = {}
        for name, fn in fns.items():
            fn(idxs[0], 0)  # warm-up
            t0 = time.perf_counter()
            for bi, i in enumerate(idxs):
                fn(i, bi)
            row[name] = (time.perf_counter() - t0) / DATA_TIME_CALLS * 1e3
        timing[batch] = row
        log(f"[data] host ms per batch of {batch} x {E6_TILE}^2 ({DATA_TIME_CALLS} calls): "
            f"native sampler (4 threads) {row['native']:.3f} (1 thread "
            f"{row['native_1_thread']:.3f}), numpy stream "
            f"{row['numpy']:.3f}, plain version {row['plain']:.3f}; [finetune]'s float32 "
            f"memory step at batch {FT_B} {step_ms:.2f} ms")
    out["ms_per_batch"] = timing

    # the memory finetuner through its CUDA twin's flags
    ((module, argv),) = read_launcher(os.path.join(REPO, DATA_TWIN))
    if module != "image_denoising_tpu_torch.cli.finetune_memory":
        raise AssertionError(f"data: {DATA_TWIN} calls {module}")
    torch.manual_seed(seed)
    base_ckpt = save_checkpoint(ImprovedUNet(in_nc=1, out_nc=1, n_feature=NF),
                                os.path.join(tmp, "base"), "model", 1)
    save = os.path.join(tmp, "run")
    swap = {"--data_dir": data, "--pretrained_ckpt": base_ckpt, "--save_model_path": save,
            "--n_epoch": "1"}
    args = []
    for i, tok in enumerate(argv):
        args.append(swap[argv[i - 1]] if i and argv[i - 1] in swap else tok)
    flags = flag_values(args)
    if any(flags.get(k) != v for k, v in swap.items()):
        raise AssertionError(f"data: the twin's argv lacks {sorted(swap)}: {argv}")
    steps = -(-E6_PAIRS * int(flags["--patches_per_image"]) // int(flags["--batchsize"]))
    log(f"[data] {DATA_TWIN}: cli.finetune_memory.main with its flags "
        f"({' '.join(a for a in argv if a.startswith('--'))}), --data_dir, "
        f"--pretrained_ckpt and --save_model_path swapped and --n_epoch 1 ({steps} steps)")
    buf = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_rdb_chain.launches = 0
    top1_l2_retrieval.launches = 0
    t0 = time.perf_counter()
    with patch_streams() as seen, contextlib.redirect_stdout(buf):
        state = finetune_memory.main(args)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = dict(fused_rdb_chain=fused_rdb_chain.launches,
                    top1_l2_retrieval=top1_l2_retrieval.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    said = buf.getvalue()
    for line in said.splitlines():
        if line.startswith(("==>", "End of epoch", "Val ", "Epoch [")):
            log(f"[data]   {line}")
    epoch_s = re.search(r"End of epoch 1, .*time=([0-9.]+)s", said)
    ms_step = float(epoch_s.group(1)) / steps * 1e3 if epoch_s else float("nan")
    seed_flag = int(flags.get("--seed") or 0)
    batch0 = plain_patch_epoch(images, int(flags["--patches_per_image"]),
                               int(flags["--batchsize"]), int(flags["--patch_size"]),
                               np.random.default_rng(seed_flag))[0]
    first_ok = (len(seen) == 1 and seen[0]["native"]
                and _same_batches([seen[0]["first"]], [batch0]))
    (ckpt,) = [os.path.join(dp, f) for dp, _, fs in os.walk(save) for f in fs
               if f == "epoch_adapter_only_001.ckpt"]
    variant = flags.get("--adapter_variant") or "hyper_gated_fft"  # the CLI's default
    back = build_memory_adapter(variant, int(flags["--n_channel"]),
                                int(flags["--adapter_hidden"]))
    back.load_state_dict(load_checkpoint(ckpt, arch=variant), strict=True)
    read_back = all(torch.equal(_bits(a.detach().cpu()), _bits(b))
                    for a, b in zip(state.model.parameters(), back.parameters()))
    out["cli"] = dict(seconds=sec, steps=int(state.step), ms_per_step_from_log=ms_step,
                      launches=launches, peak_gb=peak_gb, stream=stream_name(seen),
                      first_batch_equals_plain=first_ok, checkpoint=os.path.basename(ckpt),
                      read_back=read_back, argv=args)
    log(f"[data] cli.finetune_memory through the twin: {sec:.2f} s; {int(state.step)} steps "
        f"at {ms_step:.2f} ms/step (the CLI's epoch time over {steps} steps); patch stream: "
        f"{stream_name(seen)}; first batch equals the plain sampler's batch 0 for "
        f"default_rng({seed_flag}): {first_ok}; wrote {os.path.basename(ckpt)}, read back "
        f"bit-equal: {read_back}; launches {launches} (chain 9 a step and the validation's, "
        f"retrieval 1 a step and 1 a validation frame); peak memory {peak_gb:.2f} GB")
    if not (int(state.step) == steps and first_ok and read_back
            and launches["fused_rdb_chain"] >= 9 * steps
            and launches["top1_l2_retrieval"] >= steps and np.isfinite(ms_step)):
        raise AssertionError(f"data: the memory finetuner through its twin: {out['cli']}")
    del state
    torch.cuda.empty_cache()
    tmp_ctx.cleanup()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[data] phase {out['seconds']:.2f} s")
    return out


# [serving]: the serving CLIs over 9 seeded 704² pairs (a burst of 8 and a
# tail of 1); the limits of the device metrics against the host path
SERVE_FRAMES, SERVE_BURST, SERVE_WORKERS = 9, 8, 4
DM_PSNR_TOL, DM_SSIM_TOL, DM_IOU_TOL = 1e-3, 1e-4, 1e-6
ADAPTER_PSNR_TOL = 0.01
_DEFAULT_TF32 = {}  # PyTorch's own TF32 flags, read before main turns them off


@contextlib.contextmanager
def user_tf32():
    """PyTorch's default TF32 flags inside the block (what a user's run
    sees), this script's own after it."""
    import torch

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = _DEFAULT_TF32["cudnn"]
    torch.backends.cuda.matmul.allow_tf32 = _DEFAULT_TF32["matmul"]
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def run_cli(main, args):
    """One CLI run through its ``main`` under the default TF32 flags, with
    the kernels' launch counts set to 0 just before and read just after.
    Records what the CLI's modules compute per frame: its MetricsWriter's
    lists, every PSNR it computes on the host, and each host pass's
    seconds. Its stdout is kept apart: the lines of its frames are returned."""
    import io

    import torch

    import image_denoising_tpu_torch.metrics as metrics
    from image_denoising_tpu_torch.cli import common
    from image_denoising_tpu_torch.memory.retrieval import top1_l2_retrieval
    from image_denoising_tpu_torch.ops.fused_block import fused_rdb_chain

    rec = dict(writers=[], psnr=[], host_s=[])
    host_psnr = metrics.calculate_psnr

    class Writer(common.MetricsWriter):
        def __init__(self):
            super().__init__()
            rec["writers"].append(self)

    class Pool(common.HostWorkPool):
        def submit(self, fn, *a):
            def timed(*b):
                t0 = time.perf_counter()
                r = fn(*b)
                rec["host_s"].append(time.perf_counter() - t0)
                return r

            super().submit(timed, *a)

    def psnr(*a, **k):
        v = host_psnr(*a, **k)
        rec["psnr"].append(v)
        return v

    saved = common.MetricsWriter, common.HostWorkPool
    common.MetricsWriter, common.HostWorkPool, metrics.calculate_psnr = Writer, Pool, psnr
    buf = io.StringIO()
    try:
        with user_tf32(), contextlib.redirect_stdout(buf):
            torch.cuda.synchronize()
            fused_rdb_chain.launches = 0
            top1_l2_retrieval.launches = 0
            t0 = time.perf_counter()
            result = main(args)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            launches = dict(fused_rdb_chain=fused_rdb_chain.launches,
                            top1_l2_retrieval=top1_l2_retrieval.launches)
    finally:
        common.MetricsWriter, common.HostWorkPool = saved
        metrics.calculate_psnr = host_psnr
    w = rec["writers"][-1] if rec["writers"] else None
    frames = dict(psnr=w.psnr, ssim=w.ssim, l1=w.l1,
                  ious=list(zip(w.iou_dark, w.iou_mid, w.iou_bright))) if w else {}
    return dict(result=result, seconds=sec, launches=launches, frames=frames,
                host_psnr=rec["psnr"], host_s=rec["host_s"], stdout=buf.getvalue(),
                lines=[ln for ln in buf.getvalue().splitlines() if ln.startswith("[")])


def serving_frames(seed: int, count: int = SERVE_FRAMES):
    """``count`` seeded 704² uint8 pairs: a smooth pattern with texture, and
    Gaussian noise on top."""
    import numpy as np

    rng = np.random.default_rng(seed + 40)
    yy, xx = np.mgrid[0:FRAME, 0:FRAME].astype(np.float32)
    clean = [np.clip(128 + 70 * np.sin(xx / (13 + f) + f) * np.cos(yy / (19 + f))
                     + rng.normal(0, 6, (FRAME, FRAME)), 0, 255).astype(np.uint8)
             for f in range(count)]
    noise = [np.clip(c + rng.normal(0, 20, c.shape), 0, 255).astype(np.uint8)
             for c in clean]
    return clean, noise


def _read_pngs(d, suffix=".png"):
    import numpy as np
    from PIL import Image

    return {f: np.asarray(Image.open(os.path.join(d, f)))
            for f in sorted(os.listdir(d)) if f.endswith(suffix)}


def _same_files(a, b):
    names = sorted(os.listdir(a))
    return names == sorted(os.listdir(b)) and all(
        open(os.path.join(a, f), "rb").read() == open(os.path.join(b, f), "rb").read()
        for f in names)


def _dm_vs_host(dm, host, what, ssim=True, iou=False):
    """Per-frame device metrics against the host path's; raises past the
    limits. Returns the largest differences."""
    import numpy as np

    d = dict(psnr=max(abs(a - b) for a, b in zip(dm["psnr"], host["psnr"])))
    if ssim:
        d["ssim"] = max(abs(a - b) for a, b in zip(dm["ssim"], host["ssim"]))
    if iou:
        d["iou"] = float(np.nanmax(np.abs(np.asarray(dm["ious"]) - np.asarray(host["ious"]))))
        same_nan = np.array_equal(np.isnan(dm["ious"]), np.isnan(host["ious"]))
    if (len(dm["psnr"]) != len(host["psnr"]) or not d["psnr"] <= DM_PSNR_TOL
            or (ssim and not d["ssim"] <= DM_SSIM_TOL)
            or (iou and not (d["iou"] <= DM_IOU_TOL and same_nan))):
        raise AssertionError(f"{what}: device metrics against the host path {d}")
    return d


def check_whole_frame_bf16(vs_f32, vs_same, own_bf16):
    """E1's bf16 PNGs: within E2's bf16 limits of the float32 module, and no
    farther from it (mean) than the per-conv module's own bf16 forward is;
    against that bf16 module, E2's largest difference. Its mean difference
    is not held to E2's 1.0: a bf16 output in [0.5, 1) is stored to 2^-8,
    one uint8 level, so two bf16 forwards that round differently part by
    about a level wherever the frame is brighter than mid-grey."""
    ok = (vs_f32["max_level_diff"] <= BF16_MAX_LEVELS
          and vs_f32["mean_level_diff"] <= BF16_MEAN_LEVELS
          and vs_f32["mean_level_diff"] <= own_bf16["mean_level_diff"]
          and vs_same["max_level_diff"] <= BF16_MAX_LEVELS)
    if not ok:
        raise AssertionError("E1 bfloat16: fused path too far from the per-conv "
                             f"forward ({vs_f32}, {vs_same}; the module's own bf16 "
                             f"{own_bf16})")


def phase_serving(seed: int, kept):
    """The serving CLIs through their ``main``, over 9 seeded 704² pairs and
    [finetune]'s checkpoints (``kept``): denoise, E1, E2/E3, E4, E5 and E6,
    each checked as the module docstring says."""
    import tempfile

    import numpy as np
    import torch

    from image_denoising_tpu_torch.adapters import DenoiserWithAdapter, OutputAdapter
    from image_denoising_tpu_torch.ckpt import load_checkpoint
    from image_denoising_tpu_torch.cli import (denoise, evaluation, evaluation_704,
                                               evaluation_704_iqsl,
                                               evaluation_704_iqsl_memory,
                                               evaluation_adapter, evaluation_adapter_iqsl)
    from image_denoising_tpu_torch.eval.tiled import denoise_whole_frame, reference_tile_grid
    from image_denoising_tpu_torch.metrics import (calculate_psnr, calculate_ssim,
                                                   make_device_metrics, ssim_torch)
    from image_denoising_tpu_torch.models import ImprovedUNet, make_fused_forward

    tmp_ctx = tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build"))
    tmp = tmp_ctx.name
    clean, noise = serving_frames(seed)
    data = os.path.join(tmp, "data")
    _write_pairs(data, clean, noise)
    n = len(clean)
    mp = n * FRAME * FRAME / 1e6
    base = kept["base"]
    out = {}
    totals = {"float32": 0, "bfloat16": 0, "int8": 0}  # chain by dtype; retrieval (int8 bank)

    def save(name):
        return ["--save_dir", os.path.join(tmp, name)]

    def report(name, r, extra="", dtype="float32"):
        totals[dtype] += r["launches"]["fused_rdb_chain"]
        totals["int8"] += r["launches"]["top1_l2_retrieval"]
        fps = n / r["seconds"]
        out[name] = dict(seconds=r["seconds"], fps=fps, launches=r["launches"],
                         host_pass_s_per_frame=(statistics.mean(r["host_s"])
                                                if r["host_s"] else None))
        log(f"[serving] {name}: {n} frames of {FRAME}^2, {r['seconds']:.3f} s, "
            f"{fps:.4f} frames/s{extra}; launches {r['launches']}")

    def need_chain(name, r, want=None):
        got = r["launches"]["fused_rdb_chain"]
        if not got or (want is not None and got != want):
            raise AssertionError(f"{name}: {got} chain launches, want {want or '> 0'}")

    # denoise at its defaults: bf16, bursts of 8 (and a tail of 1), 8-tile
    # chunks, floor; from PNG in to PNG out, with the host pass inline and
    # in 4 threads. 72 tiles of a burst are 9 chunks of 9 chain calls
    net = ["--n_feature", str(NF)]
    tiles = ["--tile", str(TILE), "--overlap", str(OVERLAP)] + net
    dn = ["--input_dir", os.path.join(data, "noise"), "--checkpoint", base] + tiles
    bursts = -(-n // SERVE_BURST)
    per_burst = 9 * -(-SERVE_BURST * len(reference_tile_grid(FRAME, FRAME, TILE,
                                                             TILE - OVERLAP)) // B)
    for workers in (0, SERVE_WORKERS):
        name = f"denoise_bf16_hw{workers}"
        r = run_cli(denoise.main, dn + save(name) + ["--host_workers", str(workers)])
        need_chain(name, r, per_burst * bursts)
        if r["result"] != n or len(_read_pngs(os.path.join(tmp, name))) != n:
            raise AssertionError(f"{name}: {r['result']} frames written, want {n}")
        report(name, r, f", {mp / r['seconds']:.4f} MP/s end to end (PNG in to PNG out)",
               "bfloat16")
        out[name]["mps"] = mp / r["seconds"]
    if not _same_files(os.path.join(tmp, "denoise_bf16_hw0"),
                       os.path.join(tmp, f"denoise_bf16_hw{SERVE_WORKERS}")):
        raise AssertionError("denoise: --host_workers 4 wrote other PNGs than 0")
    prof = profile_window(lambda: run_cli(denoise.main, dn + save("denoise_profiled")))
    out["denoise_profile"] = prof
    log(f"[serving] one denoise run at its defaults under torch.profiler: wall "
        f"{prof['wall_ms']:.1f} ms, device busy {prof['device_busy_ms']:.1f} ms (share "
        f"{prof['busy_share']}); chain kernel {prof['chain_ms']:.1f} ms; top kernels "
        f"{prof['top_kernels_ms'][:3]}")

    # denoise at E2's numerics against E2's own denoised PNGs, byte for byte
    r = run_cli(denoise.main, dn + save("denoise_f32") + [
        "--dtype", "float32", "--tile_batch", "-1", "--frame_burst", "0",
        "--rounding", "floor"])
    need_chain("denoise_f32", r)
    report("denoise_f32", r, f", {mp / r['seconds']:.4f} MP/s (tile by tile)")
    e2 = ["--data_dir", data, "--checkpoint", base] + tiles
    r = run_cli(evaluation_704.main, e2 + save("e2_ref") + ["--save_images", "denoised"])
    need_chain("e2_ref", r)
    report("e2_f32_tile_by_tile", r)
    ref = {f.rsplit("_", 2)[0] + "_denoised.png": v
           for f, v in _read_pngs(os.path.join(tmp, "e2_ref"), "_denoised.png").items()}
    got = _read_pngs(os.path.join(tmp, "denoise_f32"))
    if got.keys() != ref.keys() or not all(np.array_equal(got[f], ref[f]) for f in got):
        raise AssertionError("denoise at f32 / -1 / floor differs from E2's PNGs")
    log(f"[serving] denoise --dtype float32 --tile_batch -1 --frame_burst 0: {n} PNGs "
        "byte-equal to E2's *_denoised.png")

    # E1: whole frames at batch 1, against the per-conv module (TF32 off)
    torch.manual_seed(seed)
    model = ImprovedUNet(1, 1, NF).eval()
    model.load_state_dict(load_checkpoint(base, arch="UNetImproved"), strict=True)
    module_preds = {}
    x1 = torch.from_numpy(noise[0].astype(np.float32) / 255.0).to("cuda")[None, None]
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        mod = copy.deepcopy(model).to("cuda", dt)
        module_preds[dname] = np.stack([np.clip(denoise_whole_frame(
            lambda t, m=mod, d=dt: m(t.to(d)), f[..., None].astype(np.float32) / 255.0,
            device="cuda") * 255.0 + 0.5, 0, 255).astype(np.uint8)[..., 0] for f in noise])
        # E1's forward alone at 1 x 704^2: the fused path (and its set-up:
        # weights copied and repacked) against the per-conv module
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fwd = make_fused_forward(model, device="cuda", dtype=dt)
        torch.cuda.synchronize()
        with torch.inference_mode():
            out[f"e1_forward_{dname}"] = dict(
                setup_ms=(time.perf_counter() - t0) * 1e3,
                fused_ms=time_ms(lambda: fwd(x1), reps=5),
                module_ms=time_ms(lambda m=mod, d=dt: m(x1.to(d)), reps=5))
        with torch.inference_mode():
            prof = profile_window(lambda: fwd(x1).cpu(), top=4)
        out[f"e1_forward_{dname}"]["profile"] = prof
        log(f"[serving] whole-frame forward 1x{FRAME}^2 {dname}: fused "
            f"{out[f'e1_forward_{dname}']['fused_ms']:.2f} ms (set-up "
            f"{out[f'e1_forward_{dname}']['setup_ms']:.1f} ms), per-conv module "
            f"{out[f'e1_forward_{dname}']['module_ms']:.2f} ms; under torch.profiler: "
            f"device busy {prof['device_busy_ms']:.2f} ms, chain kernel "
            f"{prof['chain_ms']:.2f} ms, cuDNN FFT path {prof['fft_ms']:.2f} ms, top "
            f"kernels {prof['top_kernels_ms']}")
        del mod, fwd
    own_bf16 = level_diff(module_preds["bfloat16"], module_preds["float32"])
    out["module_bf16_vs_f32"] = own_bf16
    log(f"[serving] per-conv module bfloat16 against float32, whole frames: {own_bf16}")
    with user_tf32():
        mod = copy.deepcopy(model).to("cuda")
        tf32_pred = np.stack([np.clip(denoise_whole_frame(
            mod, f[..., None].astype(np.float32) / 255.0, device="cuda") * 255.0 + 0.5,
            0, 255
        ).astype(np.uint8)[..., 0] for f in noise])
        del mod
    out["module_tf32_vs_f32"] = level_diff(tf32_pred, module_preds["float32"])
    log(f"[serving] per-conv module float32 with PyTorch's default TF32 against TF32 "
        f"off (why a float32 forward turns TF32 off): {out['module_tf32_vs_f32']}")
    e1 = ["--data_dir", data, "--checkpoint", base, "--save_images", "denoised"] + net
    for dname in ("float32", "bfloat16"):
        name = f"e1_{dname}"
        r = run_cli(evaluation.main, e1 + save(name) + ["--dtype", dname])
        need_chain(name, r, 9 * n)
        report(name, r, dtype=dname)
        pngs = _read_pngs(os.path.join(tmp, name), "_denoised.png")
        preds = np.stack([v[..., 0] for v in pngs.values()])
        vs_f32 = level_diff(preds, module_preds["float32"])
        vs_same = level_diff(preds, module_preds[dname])
        out[name].update(vs_f32, vs_same_dtype_module=vs_same)
        log(f"[serving] {name} denoised PNGs vs denoise_whole_frame over the per-conv "
            f"module: float32 {vs_f32}; {dname} {vs_same}")
        if dname == "float32":
            check_levels(dname, vs_f32, vs_same, "E1")
        else:
            check_whole_frame_bf16(vs_f32, vs_same, own_bf16)
        if dname == "float32":
            host = r["frames"]
    r = run_cli(evaluation.main, e1 + save("e1_dm") + ["--device_metrics"])
    d = _dm_vs_host(r["frames"], host, "E1")
    if r["frames"]["l1"] != host["l1"]:
        raise AssertionError("E1: --device_metrics changed L1")
    report("e1_float32_device_metrics", r, f"; against the host path {d}, L1 equal")

    # E2 and E3 at the serving shape, host and device metrics, 0 and 4 workers
    burst = ["--frame_burst", str(SERVE_BURST), "--tile_batch", f"-{B}", "--compute_iq_iou"]
    for cli, main in (("e2", evaluation_704.main), ("e3", evaluation_704_iqsl.main)):
        args = ["--data_dir", data, "--checkpoint", base] + burst + tiles
        host = run_cli(main, args + save(f"{cli}_host"))
        need_chain(f"{cli}_host", host, per_burst * bursts)
        report(f"{cli}_host_metrics", host,
               f", host pass {statistics.mean(host['host_s']):.4f} s/frame (PSNR, SSIM, "
               "IoU and 3 PNGs per frame)")
        dm = run_cli(main, args + save(f"{cli}_dm") + ["--device_metrics",
                                                      "--save_images", "none"])
        d = _dm_vs_host(dm["frames"], host["frames"], cli.upper(), iou=True)
        report(f"{cli}_device_metrics", dm,
               f", host pass {statistics.mean(dm['host_s']):.6f} s/frame; against "
               f"the host path {d}")
        # E3's pooled run is also traced; E2's is timed without the profiler
        trace_dir = os.path.join(tmp, f"{cli}_trace")
        prof = ["--profile_dir", trace_dir] if cli == "e3" else []
        pooled = run_cli(main, args + save(f"{cli}_hw{SERVE_WORKERS}") + prof + [
            "--host_workers", str(SERVE_WORKERS)])
        report(f"{cli}_hw{SERVE_WORKERS}" + ("_profiled" if prof else ""), pooled)
        if not (pooled["lines"] == host["lines"] and _same_files(
                os.path.join(tmp, f"{cli}_host"), os.path.join(tmp, f"{cli}_hw{SERVE_WORKERS}"))):
            raise AssertionError(f"{cli}: --host_workers {SERVE_WORKERS} output differs")
        log(f"[serving] {cli} --host_workers {SERVE_WORKERS}: frame lines, metrics.txt and "
            "PNGs identical to 0")
        if prof:
            traces = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
            if not traces:
                raise AssertionError(f"{cli}: --profile_dir wrote no trace")
            log(f"[serving] {cli} --profile_dir wrote {traces[0]} "
                f"({os.path.getsize(os.path.join(trace_dir, traces[0]))} bytes)")

    # the device metrics alone: one burst of 8 704² frames, and ssim_torch
    # against the float64 host SSIM, under the default TF32 flags
    p8 = torch.from_numpy(np.stack(noise[:B])).to("cuda")
    c8 = torch.from_numpy(np.stack(clean[:B])).to("cuda")
    with user_tf32():
        score = make_device_metrics(iq_iou=True)
        out["device_metrics_ms_per_burst"] = time_ms(lambda: score(p8, c8), reps=5)
        s = ssim_torch(p8.float(), c8.float()).cpu().numpy()
    host_ssim = [calculate_ssim(noise[k], clean[k]) for k in range(B)]
    out["ssim_torch_max_diff"] = float(np.max(np.abs(s - host_ssim)))
    log(f"[serving] device metrics (PSNR, SSIM, IoU) of one burst of {B}x{FRAME}^2: "
        f"{out['device_metrics_ms_per_burst']:.3f} ms; ssim_torch with TF32 on within "
        f"{out['ssim_torch_max_diff']:.3g} of the float64 host SSIM (limit {DM_SSIM_TOL})")
    if not out["ssim_torch_max_diff"] <= DM_SSIM_TOL:
        raise AssertionError("ssim_torch: too far from the host SSIM with TF32 on")

    # E4 and E5 over [finetune]'s adapters, per frame against the output
    # adapter over the per-conv module base, float32
    for name, main, args, ckpts in (
            ("e4", evaluation_adapter.main, ["--ckpt", kept["finetune"]],
             (kept["finetune"], "base", "adapter")),
            ("e5", evaluation_adapter_iqsl.main,
             ["--base_ckpt", base, "--adapter_ckpt", kept["finetune_iqsl"],
              "--compute_iq_iou"], (kept["finetune_iqsl"], "", ""))):
        r = run_cli(main, ["--data_dir", data] + args + net + save(name))
        need_chain(name, r, 9 * n)
        report(name, r)
        head = OutputAdapter(1, E6_HIDDEN)
        head.load_state_dict(load_checkpoint(ckpts[0], arch="output_adapter",
                                             prefix=ckpts[2]), strict=True)
        mod = copy.deepcopy(model).to("cuda")
        if ckpts[1]:
            mod.load_state_dict(load_checkpoint(ckpts[0], arch="UNetImproved",
                                                prefix=ckpts[1]), strict=True)
        ref = DenoiserWithAdapter(mod, head).to("cuda").eval()
        want = []
        for f, c in zip(noise, clean):
            with torch.inference_mode():
                x = torch.from_numpy(f.astype(np.float32) / 255.0).to("cuda")[None, None]
                p = ref(x)[0, 0].cpu().numpy()
            want.append(calculate_psnr(np.clip(p * 255.0 + 0.5, 0, 255).astype(np.uint8),
                                       c, zero_mse_psnr=99.0))
        got = r["frames"]["psnr"] if r["frames"] else r["host_psnr"]
        d = max(abs(a - b) for a, b in zip(got, want))
        out[name].update(max_psnr_diff=d, psnr=got)
        log(f"[serving] {name}: per-frame PSNR within {d:.3g} dB of the output adapter "
            f"over the per-conv module base (limit {ADAPTER_PSNR_TOL})")
        if len(got) != n or not d <= ADAPTER_PSNR_TOL:
            raise AssertionError(f"{name}: PSNR {got} against {want}")
        del mod, ref

    # E6 at [memory]'s preset over the memory finetuner's adapter
    e6 = ["--data_dir", data, "--base_ckpt", base, "--adapter_ckpt",
          kept["finetune_memory"], "--frame_burst", str(E6_BURST), "--memory_stride",
          str(E6_STRIDE), "--bank_dtype", "int8", "--clean_bank_dtype", "uint8",
          "--compute_iq_iou", "--patch_size", str(E6_TILE), "--overlap", str(OVERLAP)] + net
    host = run_cli(evaluation_704_iqsl_memory.main, e6 + save("e6_host"))
    want_e6 = dict(fused_rdb_chain=9 * -(-E6_TILES // B) * -(-n // E6_BURST),
                   top1_l2_retrieval=-(-n // E6_BURST))
    if host["launches"] != want_e6:
        raise AssertionError(f"E6: launches {host['launches']}, want {want_e6}")
    report("e6_host_metrics", host)
    dm = run_cli(evaluation_704_iqsl_memory.main,
                 e6 + save("e6_dm") + ["--device_metrics", "--save_images", "none"])
    d = _dm_vs_host(dm["frames"], host["frames"], "E6", ssim=False, iou=True)
    report("e6_device_metrics", dm, f"; against the host path {d}")
    pooled = run_cli(evaluation_704_iqsl_memory.main, e6 + save(f"e6_hw{SERVE_WORKERS}")
                     + ["--host_workers", str(SERVE_WORKERS)])
    report(f"e6_hw{SERVE_WORKERS}", pooled)
    if not (pooled["lines"] == host["lines"] and _same_files(
            os.path.join(tmp, "e6_host"), os.path.join(tmp, f"e6_hw{SERVE_WORKERS}"))):
        raise AssertionError(f"E6: --host_workers {SERVE_WORKERS} output differs")
    log(f"[serving] e6 --host_workers {SERVE_WORKERS}: frame lines, metrics.txt and PNGs "
        "identical to 0")
    tmp_ctx.cleanup()
    out["launches"] = totals
    return out


# [networks]: UNet-48 (blind spot off and on) and RESNET-48 at full width.
# Serving: E2's runner over make_forward, NET_WARMUP + NET_BURSTS bursts of
# 8 704^2 frames per dtype, float32 held to the module in float64 on the
# first NET_F64_FRAMES frames; training: N2N of the UNet on 704^2 frames (its
# sub-images must divide by 32) and the structure step of the blind-spot UNet
# and of the RESNET at [structure]'s batch; the CLIs on NET_CLI_FRAMES pairs
NETWORKS = (("UNet", False), ("UNet", True), ("RESNET", False))
NET_WARMUP, NET_BURSTS, NET_F64_FRAMES, NET_CLI_FRAMES = 1, 2, 2, 5
NET_N2N_FRAME = FRAME
BLINDSPOT_LOG = "UNET_blindspot_gauss25"  # scripts/train_blindspot.sh
# bf16 against f32 in [networks], in uint8 levels (largest, mean): E2's
# limits, except for a network whose own bf16 forward in the JAX package
# reads above them at this seed's weights: there 1.5 times its readings, as
# for E6. RESNET-48 reads 12 levels and a mean of 1.583 on two 256^2 crops of
# the serving frames on the CPU (tests/test_torch_networks.py::
# test_bf16_levels_of_the_jax_package): the bf16 nin_c output is added to
# the float32 input, and its rounding alone moves the sum by up to a level
NET_BF16_LIMITS = {"RESNET": (18, 2.4)}


def net_name(arch: str, blindspot: bool) -> str:
    return f"{arch}-{NF}" + (" blind-spot" if blindspot else "")


def phase_networks(seed: int, kept):
    """UNet and RESNET through make_forward (cuDNN, no kernel of the port),
    their training steps (the N2N step of the UNet through the sub-sampler
    kernel at 4 x 1 x 704^2) and the CLIs with them; ``kept``: [finetune]'s
    checkpoints (the memory adapter served by E6 over a UNet base)."""
    import glob
    import tempfile

    import numpy as np
    import torch

    from image_denoising_tpu_torch.ckpt import load_checkpoint, save_checkpoint
    from image_denoising_tpu_torch.cli import (denoise, evaluation_704,
                                               evaluation_704_iqsl_memory)
    from image_denoising_tpu_torch.cli import train as train_cli
    from image_denoising_tpu_torch.eval.tiled import make_tiled_pyramid_runner_frames
    from image_denoising_tpu_torch.models import build_model, make_forward
    from image_denoising_tpu_torch.models.init import initialize_weights
    from image_denoising_tpu_torch.ops import AugmentNoise, OperationSeed
    from image_denoising_tpu_torch.ops.fused_block import fused_rdb_chain
    from image_denoising_tpu_torch.ops.neighbor import subsample_pair, subsample_pair_fused
    from image_denoising_tpu_torch.train import (create_train_state, make_n2n_train_step,
                                                 make_structure_train_step)

    def runner(call, n=B):
        return make_tiled_pyramid_runner_frames(call, n, FRAME, FRAME, TILE, OVERLAP,
                                                batch=-B, out_dtype="uint8_floor")

    def seeded(arch, bs):
        """The network with He-normal weights (scale 1) from the seed: the
        reference's Kaiming x 0.1 leaves an untrained UNet's output within
        3e-6 of 0 (RESNET's within 2e-6 of its input), where every uint8
        check would pass whatever the forward computed."""
        torch.manual_seed(seed)
        return initialize_weights(build_model(arch, 1, NF, blindspot=bs), 1.0).eval()

    _, noise = serving_frames(seed, B + 1)
    bursts = [np.stack(noise[:B]), np.stack(noise[1:])]
    mp = NET_BURSTS * B * FRAME * FRAME / 1e6
    fused_rdb_chain.launches = 0
    out = dict(serving={}, train={})

    # serving: float32 and bfloat16 bursts, float32 against float64
    for arch, bs in NETWORKS:
        name = net_name(arch, bs)
        model = seeded(arch, bs)
        res, preds = {}, {}
        for dname in ("float32", "bfloat16"):
            run = runner(make_forward(model, device="cuda", dtype=getattr(torch, dname)))
            run_bursts(run, bursts[:NET_WARMUP])  # cuDNN plans
            preds[dname], sec = run_bursts(run, bursts[:NET_BURSTS])
            prof = profile_burst(run, bursts[0])
            res[dname] = dict(seconds=sec, mps=mp / sec, profile=prof)
            log(f"[networks] {name} {dname:8s} E2 runner, {NET_BURSTS} bursts of "
                f"{B}x{FRAME}^2: {sec:.3f} s, {mp / sec:.4f} MP/s; one burst under "
                f"torch.profiler: wall {prof['wall_ms']:.1f} ms, device busy "
                f"{prof['device_busy_ms']:.1f} ms (share {prof['busy_share']}); top "
                f"kernels {prof['top_kernels_ms'][:3]}")
            del run
        f64 = copy.deepcopy(model).to("cuda", torch.float64)
        ref, _ = run_bursts(runner(torch.inference_mode()(lambda t: f64(t.double())),
                                   NET_F64_FRAMES), [bursts[0][:NET_F64_FRAMES]])
        del f64
        vs_f64 = level_diff(preds["float32"][0][:NET_F64_FRAMES], ref[0])
        bf16 = level_diff(preds["bfloat16"], preds["float32"])
        max_levels, mean_levels = NET_BF16_LIMITS.get(arch, (BF16_MAX_LEVELS,
                                                             BF16_MEAN_LEVELS))
        res.update(f32_vs_f64=vs_f64, bf16_vs_f32=bf16)
        log(f"[networks] {name} float32 vs the module in float64 ({NET_F64_FRAMES} "
            f"frames): max {vs_f64['max_level_diff']} levels, "
            f"{vs_f64['frac_pixels_diff']:.3e} of pixels differ (limit 1 level on "
            f"1e-3); bfloat16 vs float32: max {bf16['max_level_diff']} levels, mean "
            f"{bf16['mean_level_diff']:.4f} (limits {max_levels}, {mean_levels})")
        if not (vs_f64["max_level_diff"] <= 1 and vs_f64["frac_pixels_diff"] <= 1e-3):
            raise AssertionError(f"{name}: float32 too far from float64: {vs_f64}")
        if not (bf16["max_level_diff"] <= max_levels
                and bf16["mean_level_diff"] <= mean_levels):
            raise AssertionError(f"{name}: bfloat16 outside E2's limits: {bf16}")
        out["serving"][name] = res
        del model
        torch.cuda.empty_cache()

    # N2N of the UNet on 704^2 frames: the kernel against the plain sub-sampler
    clean = n2n_frames(seed, TRAIN_B, NET_N2N_FRAME)[..., None].astype(np.float32)
    aug = AugmentNoise("gauss25")
    init = seeded("UNet", False).state_dict()

    def n2n(subsample):
        model = build_model("UNet", 1, NF).to("cuda")
        model.load_state_dict(init)
        state = create_train_state(model, lr=3e-4)
        step = make_n2n_train_step(model, state, noise_fn=aug.add_train_noise,
                                   increase_ratio=2.0, n_epoch=TRAIN_EPOCHS,
                                   subsample=subsample)
        seeds = OperationSeed(seed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses = [step(clean, clean, seeds.next(), 1)["loss"] for _ in range(TRAIN_WARMUP)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += [step(clean, clean, seeds.next(), 1)["loss"] for _ in range(TRAIN_STEPS)]
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / TRAIN_STEPS
        return [float(x) for x in losses], step_s, torch.cuda.max_memory_allocated() / 1e9

    subsample_pair_fused.launches = 0
    losses, step_s, peak = n2n(subsample_pair_fused)
    launches = subsample_pair_fused.launches
    plain, plain_s, _ = n2n(subsample_pair)
    if launches != TRAIN_WARMUP + TRAIN_STEPS or subsample_pair_fused.launches != launches:
        raise AssertionError(f"N2N UNet: {launches} sub-sampler launches, want "
                             f"{TRAIN_WARMUP + TRAIN_STEPS} and none in the plain run")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain))
    n2n_mp = TRAIN_B * NET_N2N_FRAME ** 2 / 1e6
    out["train"]["n2n_unet"] = dict(
        launches=launches, ms_per_step=step_s * 1e3, mps=n2n_mp / step_s, peak_gb=peak,
        plain_ms_per_step=plain_s * 1e3, losses=losses, plain_losses=plain,
        max_rel_loss_diff=rel)
    log(f"[networks] N2N step, UNet-{NF} f32, batch {TRAIN_B}x{NET_N2N_FRAME}^2 "
        f"(sub-images {NET_N2N_FRAME // 2}^2): {step_s * 1e3:.2f} ms/step, "
        f"{n2n_mp / step_s:.4f} MP/s of input frames, peak memory {peak:.2f} GB (plain "
        f"sub-sampler: {plain_s * 1e3:.2f} ms/step); sub-sampler launches {launches}; "
        f"losses {[round(x, 6) for x in losses]}, largest relative difference to the "
        f"plain run {rel:.3g} (limit {TRAIN_LOSS_RTOL})")
    if not (np.all(np.isfinite(losses + plain)) and rel <= TRAIN_LOSS_RTOL):
        raise AssertionError(f"N2N UNet: losses {losses} against the plain run's {plain}")

    # the structure step: blind-spot UNet in float32 and bfloat16, RESNET in float32
    sclean, snoisy = struct_pair(seed)
    smp = TRAIN_B * TRAIN_FRAME ** 2 / 1e6
    for arch, bs, dname in (("UNet", True, "float32"), ("UNet", True, "bfloat16"),
                            ("RESNET", False, "float32")):
        model = seeded(arch, bs)
        model.dtype = torch.bfloat16 if dname == "bfloat16" else None
        model = model.to("cuda").train()
        state = create_train_state(model, lr=3e-4)
        step = make_structure_train_step(model, state)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, pending = [], None
        for i in range(TRAIN_WARMUP + TRAIN_STEPS):
            if i == TRAIN_WARMUP:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error" if i >= TRAIN_WARMUP else 0)
            try:
                m = step(sclean, snoisy)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            if pending is not None:
                losses.append(float(pending["loss"]))
            pending = m
        losses.append(float(pending["loss"]))
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / TRAIN_STEPS
        peak = torch.cuda.max_memory_allocated() / 1e9
        key = f"structure_{arch.lower()}{'_blindspot' if bs else ''}_{dname}"
        out["train"][key] = dict(ms_per_step=step_s * 1e3, mps=smp / step_s, peak_gb=peak,
                                 losses=losses)
        log(f"[networks] structure step, {net_name(arch, bs)} {dname}, batch {TRAIN_B}x"
            f"{TRAIN_FRAME}^2 as one batch-{2 * TRAIN_B} forward"
            + (f" ({8 * TRAIN_B} rotated frames)" if bs else "")
            + f": {step_s * 1e3:.2f} ms/step, {smp / step_s:.4f} MP/s of input frames, "
            f"peak memory {peak:.2f} GB; timed steps under set_sync_debug_mode('error'); "
            f"losses {[round(x, 6) for x in losses]}")
        if not np.all(np.isfinite(losses)):
            raise AssertionError(f"{key}: non-finite loss {losses}")
        del model, state, step, pending, m
        torch.cuda.empty_cache()
    f32 = out["train"]["structure_unet_blindspot_float32"]["losses"]
    b16 = out["train"]["structure_unet_blindspot_bfloat16"]["losses"]
    step1 = abs(b16[0] - f32[0])
    brel = max(abs(a - b) / abs(b) for a, b in zip(b16, f32))
    log(f"[networks] blind-spot structure losses, bf16 against f32: step 1 |d| "
        f"{step1:.3g} (limit {BF16_STEP1_ABS}), largest relative {brel:.3g} (limit "
        f"{BF16_REL})")
    if not (step1 < BF16_STEP1_ABS and brel < BF16_REL):
        raise AssertionError("blind-spot structure: bf16 losses outside the envelope of f32")
    if fused_rdb_chain.launches:
        raise AssertionError(f"networks: {fused_rdb_chain.launches} chain launches")

    # the CLIs through their main
    cli = out["cli"] = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        tdata = os.path.join(tmp, "train_data")
        rng = np.random.default_rng(seed + 12)
        tclean = list(n2n_frames(seed + 5, 2 * TRAIN_B, TRAIN_FRAME))
        _write_pairs(tdata, tclean, [np.clip(c + rng.normal(0, 25, c.shape), 0, 255)
                                     .astype(np.uint8) for c in tclean])
        subsample_pair_fused.launches = 0
        t0 = time.perf_counter()
        train_cli.main(["--log_name", BLINDSPOT_LOG, "--n_feature", str(NF), "--data_dir",
                        tdata, "--save_model_path", os.path.join(tmp, "runs"),
                        "--n_epoch", "1", "--max_steps_per_epoch", "2", "--seed", str(seed)])
        sec = time.perf_counter() - t0
        (ckpt,) = glob.glob(os.path.join(tmp, "runs", BLINDSPOT_LOG, "*",
                                         "epoch_model_001.ckpt"))
        sd = load_checkpoint(ckpt, arch="UNet")
        build_model("UNet", 1, NF, blindspot=True).load_state_dict(sd, strict=True)
        nin_a = tuple(sd["nin_a.weight"].shape)
        cli["train_blindspot"] = dict(seconds=sec, nin_a=nin_a,
                                      launches=subsample_pair_fused.launches)
        log(f"[networks] cli.train.main --log_name {BLINDSPOT_LOG} --n_feature {NF} "
            f"(the launcher's preset), 1 epoch of 2 steps at batch {TRAIN_B} of "
            f"{TRAIN_FRAME}^2: {sec:.2f} s; epoch_model_001.ckpt loads strict into the "
            f"blind-spot UNet, nin_a {nin_a}")
        if nin_a != (384, 384, 1, 1) or subsample_pair_fused.launches:
            raise AssertionError(f"train CLI {BLINDSPOT_LOG}: {cli['train_blindspot']}")

        clean, noise = serving_frames(seed + 1, NET_CLI_FRAMES)
        data = os.path.join(tmp, "data")
        _write_pairs(data, clean, noise)
        e2 = run_cli(evaluation_704.main, [
            "--data_dir", data, "--checkpoint", ckpt, "--log_name", BLINDSPOT_LOG,
            "--n_feature", str(NF), "--frame_burst", "4", "--save_images", "none",
            "--save_dir", os.path.join(tmp, "e2")])
        resnet = save_checkpoint(seeded("RESNET", False), os.path.join(tmp, "resnet"),
                                 "model", 1)
        unet = save_checkpoint(seeded("UNet", False), os.path.join(tmp, "unet"), "model", 1)
        den = run_cli(denoise.main, ["--input_dir", os.path.join(data, "noise"),
                                     "--checkpoint", resnet, "--arch", "RESNET",
                                     "--n_feature", str(NF),
                                     "--save_dir", os.path.join(tmp, "denoise")])
        e6 = run_cli(evaluation_704_iqsl_memory.main, [
            "--data_dir", data, "--base_ckpt", unet, "--arch", "UNet", "--n_feature", str(NF),
            "--adapter_ckpt",
            kept["finetune_memory"], "--frame_burst", str(E6_BURST), "--memory_stride",
            str(E6_STRIDE), "--bank_dtype", "int8", "--clean_bank_dtype", "uint8",
            "--patch_size", str(E6_TILE), "--overlap", str(OVERLAP), "--save_images",
            "none", "--save_dir", os.path.join(tmp, "e6")])
        e6_bursts = -(-NET_CLI_FRAMES // E6_BURST)
        pngs = glob.glob(os.path.join(tmp, "denoise", "*.png"))
        for what, r in (("E2 blind-spot UNet by log name", e2),
                        ("denoise --arch RESNET", den), ("E6 --arch UNet", e6)):
            log(f"[networks] {what}: {NET_CLI_FRAMES} frames of {FRAME}^2 in "
                f"{r['seconds']:.2f} s; launches {r['launches']}"
                + (f"; average PSNR {r['result']['psnr']:.4f} dB"
                   if isinstance(r["result"], dict) else ""))
        cli.update(e2=dict(seconds=e2["seconds"], launches=e2["launches"],
                           psnr=e2["result"]["psnr"]),
                   denoise=dict(seconds=den["seconds"], launches=den["launches"],
                                frames=len(pngs)),
                   e6=dict(seconds=e6["seconds"], launches=e6["launches"],
                           psnr=e6["result"]["psnr"], bursts=e6_bursts))
        if not (np.isfinite(e2["result"]["psnr"]) and np.isfinite(e6["result"]["psnr"])
                and len(pngs) == NET_CLI_FRAMES):
            raise AssertionError(f"networks CLIs: {cli}")
        if not (e2["launches"] == den["launches"] == dict(fused_rdb_chain=0,
                                                          top1_l2_retrieval=0)
                and e6["launches"] == dict(fused_rdb_chain=0,
                                           top1_l2_retrieval=e6_bursts)):
            raise AssertionError(f"networks CLIs: launches {cli}")
    return out


# the [multidevice] phase. The script needs one card, so each mesh repeats it
# (make_mesh(devices=["cuda:0"] * k)): every split, per-device forward, shard
# and key merge runs, and the copies between devices are no-ops. Shard
# counts of the sharded retrieval; the mesh of E2, E6 and the data-parallel
# steps; the uneven mesh of the structure step (batch 4 over 3); E2's bursts
# per dtype; the CLIs' frames and bank stride (the production stride 4 takes
# 10 s a bank build on the host, and the CLIs' check is their output with
# and without the flags)
MD_SHARDS, MD_MESH, MD_UNEVEN, MD_BURSTS = (2, 4), 2, 3, 2
MD_CARDS = 4  # --multidevice-cards: distinct cards, and E2/E6/steps split over them
MD_CLI_FRAMES, MD_CLI_STRIDE = 5, 16


def _md_mesh(k: int):
    from image_denoising_tpu_torch.parallel import make_mesh

    return make_mesh(devices=["cuda:0"] * k)


def _share_chunks(tiles: int, split: int) -> int:
    """B-tile chunks of one device's share of a stack of ``tiles`` tiles
    split over ``split`` devices (the stack padded to a multiple of them)."""
    return -(-(-(-tiles // split)) // B)


def _md_retrieval(seed: int, mesh_of):
    """The sharded retrieval at the production bank (N = 105,125, D =
    16,384; uint8-sourced rows, as int8 and as float32) over 2 and 4 shards
    at B = 400 (queries split, the tiled evaluator's) and B = 4 (queries
    whole, the finetuner's): k launches a call, the unsharded kernel's
    indices (int8 bit-equal; a float32 pick that differs must lie within
    f32_pick_tol of the float64 best row), ms per call against the
    unsharded call. The bank's "clean" patches are each row's own index,
    so the retrieved patch is the global row."""
    import torch

    from image_denoising_tpu_torch.adapters import select_memory_patch
    from image_denoising_tpu_torch.memory import (MemoryBank, make_ring_retrieval,
                                                  shard_bank)
    from image_denoising_tpu_torch.memory.retrieval import top1_l2_retrieval

    n, d = E6_BANK_ROWS, PATCH_D
    g = torch.Generator(device="cuda").manual_seed(seed + 70)
    u8 = torch.randint(0, 256, (n, d), generator=g, device="cuda", dtype=torch.uint8)
    u8[DUP_HI] = u8[DUP_LO]
    picks = torch.randint(0, n, (E6_TILES,), generator=g, device="cuda")
    jitter = torch.randint(-6, 7, (E6_TILES, d), generator=g, device="cuda",
                           dtype=torch.int16)
    qu8 = (u8[picks].short() + jitter).clamp(0, 255)
    qu8[0] = u8[DUP_LO]  # a copy of both rows: the first must win
    q = (qu8.float() / 255.0).reshape(E6_TILES, E6_TILE, E6_TILE, 1)
    del jitter, qu8
    rows = torch.arange(n, dtype=torch.int32, device="cuda").reshape(n, 1, 1, 1)
    i8 = (u8.short() - 128).to(torch.int8)
    banks = {"int8": MemoryBank(i8, rows, (i8.int() ** 2).sum(1, dtype=torch.int32),
                                E6_TILE, E6_STRIDE)}
    f32 = u8.float() / 255.0
    banks["float32"] = MemoryBank(f32, rows, (f32 ** 2).sum(1), E6_TILE, E6_STRIDE)
    del u8, i8, f32
    out = {}
    for dname, bank in banks.items():
        res = {}
        for b in (E6_TILES, FT_B):
            qb = q[:b].contiguous()
            want = select_memory_patch(qb, bank.noise_flat, bank.clean, bank.sq_norms)
            one_ms = time_ms(lambda: select_memory_patch(qb, bank.noise_flat, bank.clean,
                                                         bank.sq_norms), reps=5)
            item = bank.noise_flat.element_size()
            bound_ms, bound_by = bound(2.0 * b * n * d,
                                       (b * d + n * d) * item + n * 4 + b * 4,
                                       ROUTES[dname][1])
            for k in MD_SHARDS:
                mesh = mesh_of(k)
                sb = shard_bank(bank, mesh)
                ring = make_ring_retrieval(mesh, queries_sharded=b == E6_TILES)
                torch.cuda.synchronize()
                top1_l2_retrieval.launches = 0
                got = ring(qb, sb.noise_flat, sb.clean, sb.sq_norms)
                torch.cuda.synchronize()
                launches = top1_l2_retrieval.launches
                if launches != k:
                    raise AssertionError(f"sharded {dname} k={k}: {launches} launches")
                if int(got[0]) != DUP_LO:
                    raise AssertionError(f"sharded {dname} k={k}: row {DUP_LO} lost "
                                         f"to {int(got[0])}")
                differ = int((got != want).sum())
                excess = 0.0
                if differ and dname == "int8":
                    raise AssertionError(f"sharded int8 k={k} B={b}: {differ} indices "
                                         "differ from the unsharded kernel's")
                if differ:
                    qf = qb.reshape(b, -1)
                    best, _, _, dist = _f64_top1(qf, bank.noise_flat)
                    excess = float((dist(got.reshape(-1).long()) - best).max())
                    tol = f32_pick_tol(d, float(qf.norm(dim=1).max()),
                                       float(bank.noise_flat.norm(dim=1).max()))
                    if not excess <= tol:
                        raise AssertionError(f"sharded f32 k={k} B={b}: f64 excess "
                                             f"{excess:.4g} over tol {tol:.4g}")
                ms = time_ms(lambda: ring(qb, sb.noise_flat, sb.clean, sb.sq_norms), reps=5)
                res[f"k{k}_b{b}"] = dict(shards=k, batch=b, launches=launches,
                                         differing_indices=differ, max_f64_excess=excess,
                                         ms=ms, unsharded_ms=one_ms, bound_ms=bound_ms,
                                         bound_by=bound_by, n_local=sb.n_local)
                log(f"[multidevice] sharded retrieval {dname:8s} k={k} B={b:3d}: "
                    f"{launches} launches, {differ} of {b} indices differ from the "
                    f"unsharded kernel's, {ms:.3f} ms a call (unsharded {one_ms:.3f} ms, "
                    f"bound {bound_ms:.3f} ms, {bound_by}); {sb.n_local} rows a shard")
                del sb, ring, got
        out[dname] = res
        torch.cuda.empty_cache()
    del banks
    torch.cuda.empty_cache()
    return out


def _md_e2(seed: int, mesh_of, split: int):
    """E2 through the pyramid runner on a 2-entry mesh (each 72-tile stack
    split into two shares of 36, each in 8-tile chunks) against the
    single-device runner, MD_BURSTS bursts of 8 704² frames per dtype: at
    most 1 level on at most 0.1 % of pixels (E2's f32 limit), MP/s."""
    import numpy as np
    import torch

    from image_denoising_tpu_torch.eval.tiled import make_tiled_pyramid_runner_frames
    from image_denoising_tpu_torch.models import ImprovedUNet, make_forward
    from image_denoising_tpu_torch.ops.fused_block import fused_rdb_chain

    torch.manual_seed(seed + 71)
    model = ImprovedUNet(in_nc=1, out_nc=1, n_feature=NF).eval()
    rng = np.random.default_rng(seed + 72)
    bursts = [rng.integers(0, 256, (B, FRAME, FRAME)).astype(np.uint8)
              for _ in range(MD_BURSTS)]
    mesh = mesh_of(split)
    share_chunks = _share_chunks(B * 9, split)
    mp = MD_BURSTS * B * FRAME * FRAME / 1e6
    out = {}
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        runs = {}
        for name, m in (("single", None), ("mesh", mesh)):
            fwd = make_forward(model, device="cuda", dtype=dt, mesh=m)
            run = make_tiled_pyramid_runner_frames(
                fwd, B, FRAME, FRAME, TILE, OVERLAP, batch=-B, out_dtype="uint8_floor",
                device="cuda", mesh=m)
            run_bursts(run, bursts[:1])  # warm-up
            fused_rdb_chain.launches = 0
            preds, sec = run_bursts(run, bursts)
            runs[name] = (preds, sec, fused_rdb_chain.launches)
        (p1, s1, l1), (pm, sm, lm) = runs["single"], runs["mesh"]
        want = 9 * split * share_chunks * MD_BURSTS
        if lm != want:
            raise AssertionError(f"E2 mesh {dname}: {lm} chain launches, want {want}")
        diff = level_diff(pm, p1)
        if not (diff["max_level_diff"] <= 1 and diff["frac_pixels_diff"] <= 1e-3):
            raise AssertionError(f"E2 mesh {dname}: {diff} from the single-device run")
        out[dname] = dict(launches=lm, single_launches=l1, seconds=sm, mps=mp / sm,
                          single_mps=mp / s1, bit_equal=bool(np.array_equal(pm, p1)),
                          **diff)
        log(f"[multidevice] E2 {dname:8s} on a {split}-entry mesh, {MD_BURSTS} "
            f"bursts of {B}x{FRAME}^2: {mp / sm:.4f} MP/s (one device {mp / s1:.4f}); "
            f"{lm} chain launches ({l1} on one device); against one device: max "
            f"{diff['max_level_diff']} levels on {diff['frac_pixels_diff']:.3e} of "
            f"pixels, bit-equal {out[dname]['bit_equal']}")
    return out


def _md_e6(seed: int, bank, model, adapter, mesh_of, split: int):
    """E6 with the int8/uint8 bank sharded over 2 and each 400-tile stack
    split over 2: 1 burst of 4 frames, the hoisted retrieval's patches and
    the output equal to the single-device hoisted run's; 2 retrieval
    launches a burst."""
    import numpy as np
    import torch

    from image_denoising_tpu_torch.adapters import DenoiserWithMemoryAdapter
    from image_denoising_tpu_torch.cli.evaluation_704_iqsl_memory import (
        make_memory_mesh_call, make_memory_model_call)
    from image_denoising_tpu_torch.eval import tiled
    from image_denoising_tpu_torch.memory import make_ring_retrieval, shard_bank
    from image_denoising_tpu_torch.memory.retrieval import top1_l2_retrieval
    from image_denoising_tpu_torch.models import make_forward
    from image_denoising_tpu_torch.ops.fused_block import fused_rdb_chain

    _, _, bursts = e6_frames(seed)
    frames = bursts[1]
    mesh = mesh_of(split)
    grid = tiled.edge_aligned_grid(FRAME, FRAME, E6_TILE, OVERLAP)
    f = torch.from_numpy(frames).to("cuda").float() / 255.0
    tiles = torch.stack([f[:, r : r + E6_TILE, c : c + E6_TILE] for r, c in grid],
                        1).reshape(E6_TILES, 1, E6_TILE, E6_TILE)

    def runner(call, pre, m):
        return tiled.make_tiled_hann_runner_frames(
            call, E6_BURST, FRAME, FRAME, ps=E6_TILE, overlap=OVERLAP, batch=-B,
            out_dtype="uint8_round", pre_tile_fn=pre, device="cuda", mesh=m)

    fwd = make_forward(model, device="cuda")
    call1, pre1 = make_memory_model_call(DenoiserWithMemoryAdapter(fwd, adapter), bank)
    run1 = runner(call1, pre1, None)
    run_bursts(run1, [frames])
    sb = shard_bank(bank, mesh)
    wrapper = DenoiserWithMemoryAdapter(make_forward(model, device="cuda", mesh=mesh),
                                        adapter, make_ring_retrieval(mesh))
    callm, prem = make_memory_mesh_call(wrapper, sb, mesh)
    runm = runner(callm, prem, mesh)
    run_bursts(runm, [frames])  # warm-up
    with torch.inference_mode():
        same_patches = torch.equal(pre1(tiles), prem(tiles))
    p1, s1 = run_bursts(run1, [frames])
    fused_rdb_chain.launches = 0
    top1_l2_retrieval.launches = 0
    pm, sm = run_bursts(runm, [frames])
    launches = dict(fused_rdb_chain=fused_rdb_chain.launches,
                    top1_l2_retrieval=top1_l2_retrieval.launches)
    share_chunks = _share_chunks(E6_TILES, split)
    want = dict(fused_rdb_chain=9 * split * share_chunks, top1_l2_retrieval=split)
    if launches != want:
        raise AssertionError(f"E6 sharded: launches {launches}, want {want}")
    same = bool(np.array_equal(pm, p1))
    if not (same and same_patches):
        raise AssertionError(f"E6 sharded: patches equal {same_patches}, output equal "
                             f"{same} to the single-device hoisted run")
    mp = E6_BURST * FRAME * FRAME / 1e6
    log(f"[multidevice] E6 float32, bank sharded over {split} ({sb.n_local} rows a "
        f"shard) and tiles split over {split}, 1 burst of {E6_BURST}x{FRAME}^2: "
        f"{mp / sm:.4f} MP/s (one device {mp / s1:.4f}); retrieved patches and output "
        f"equal to the single-device run's; launches {launches}")
    return dict(launches=launches, seconds=sm, mps=mp / sm, single_mps=mp / s1,
                same_patches=same_patches, same_output=same)


def _md_steps(clean, noisy, make_step, step_args, counters):
    """2 warm-up and 10 timed steps of ``make_step()`` (batch i: ``clean[i]``,
    ``noisy[i]`` where they are lists, then ``step_args(i)``), the timed ones under
    set_sync_debug_mode("error"), losses fetched one step late: (losses,
    ms/step, the counters' launches in the 12 steps)."""
    import numpy as np
    import torch

    step = make_step()
    for c in counters:
        c.launches = 0
    losses, pending = [], None
    for i in range(TRAIN_WARMUP + TRAIN_STEPS):
        if i == TRAIN_WARMUP:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error" if i >= TRAIN_WARMUP else 0)
        try:
            m = step(clean[i] if isinstance(clean, list) else clean,
                     noisy[i] if isinstance(noisy, list) else noisy, *step_args(i))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if pending is not None:
            losses.append(float(pending["loss"]))
        pending = m
    losses.append(float(pending["loss"]))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"non-finite losses {losses}")
    return losses, ms, [c.launches for c in counters]


def _md_train(seed: int, bank, mesh_of, split: int):
    """The data-parallel steps, 12 each, against the single-device steps,
    each also by its first step's loss and gradient: the structure step
    (f32) on a 2-entry mesh and on a 3-entry one, both at batch 4; the N2N
    step on a 2-entry mesh (one sub-sampler launch a step); the memory
    finetune step with the int8 bank sharded over 2 (the batch whole;
    retrieved indices equal to the unsharded bank's)."""
    import numpy as np
    import torch

    from image_denoising_tpu_torch.adapters import (DenoiserWithMemoryAdapter,
                                                    build_memory_adapter,
                                                    select_memory_patch)
    from image_denoising_tpu_torch.memory import (MemoryBank, make_ring_retrieval,
                                                  shard_bank)
    from image_denoising_tpu_torch.memory.retrieval import top1_l2_retrieval
    from image_denoising_tpu_torch.models import ImprovedUNet, make_forward
    from image_denoising_tpu_torch.ops import AugmentNoise, OperationSeed
    from image_denoising_tpu_torch.ops.fused_block import fused_rdb_chain
    from image_denoising_tpu_torch.ops.neighbor import subsample_pair_fused
    from image_denoising_tpu_torch.train import (create_train_state,
                                                 make_memory_finetune_step,
                                                 make_n2n_train_step,
                                                 make_structure_train_step)

    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    def first_step(make_model, make_step, batch, mesh):
        """One step from the same weights on the same batch: (loss, the
        gradient of every parameter, flattened)."""
        model = make_model()
        m = make_step(model, mesh)(*batch)
        loss = float(m["loss"])
        return loss, torch.cat([p.grad.flatten() for p in model.parameters()])

    def check_first_step(what, make_model, make_step, batch, k):
        """The data-parallel step's first loss and gradient against one
        device's: the loss within 1e-5 relative (cuDNN sums a chunk's convs
        in another order than the batch's), the gradient within
        TRAIN_LOSS_RTOL of its largest entry."""
        loss1, g1 = first_step(make_model, make_step, batch, None)
        lossk, gk = first_step(make_model, make_step, batch, mesh_of(k))
        loss_rel = abs(lossk - loss1) / abs(loss1)
        grad_rel = float((gk - g1).abs().max() / g1.abs().max())
        log(f"[multidevice] {what} on a {k}-entry mesh, first step from the same "
            f"weights: loss {lossk:.8f} against {loss1:.8f} ({loss_rel:.3g} relative, "
            f"limit 1e-5), gradient within {grad_rel:.3g} of its largest entry (limit "
            f"{TRAIN_LOSS_RTOL})")
        if not (loss_rel <= 1e-5 and grad_rel <= TRAIN_LOSS_RTOL):
            raise AssertionError(f"{what} k={k}: first step {loss_rel}, {grad_rel}")
        return dict(first_loss_rel=loss_rel, first_grad_rel=grad_rel)

    # [structure]'s f32 configuration (its seeded weights and batch), where
    # the two-forward step's 12 losses meet TRAIN_LOSS_RTOL: Adam's first
    # steps move every parameter by about lr, whatever its gradient's size,
    # so rounding-level differences part the trajectories at a rate that
    # depends on the weights and the batch
    out = {}
    torch.manual_seed(seed)
    init = ImprovedUNet(in_nc=1, out_nc=1, n_feature=NF).state_dict()
    clean, noisy = struct_pair(seed)

    def make_model():
        model = ImprovedUNet(1, 1, NF)
        model.load_state_dict(init)
        return model.to("cuda")

    def make_structure(model, mesh):
        return make_structure_train_step(model, create_train_state(model, lr=3e-4),
                                         mesh=mesh)

    def structure(mesh):
        return _md_steps(clean, noisy, lambda: make_structure(make_model(), mesh),
                         lambda i: (), (fused_rdb_chain,))

    ref, ref_ms, _ = structure(None)
    mp = TRAIN_B * TRAIN_FRAME ** 2 / 1e6
    for k in (split, MD_UNEVEN):
        first = check_first_step("structure step f32", make_model, make_structure,
                                 (clean, noisy), k)
        losses, ms, (chain,) = structure(mesh_of(k))
        r = rel(losses, ref)
        out[f"structure_k{k}"] = dict(losses=losses, single_losses=ref, ms=ms,
                                      mps=mp / ms * 1e3, single_ms=ref_ms,
                                      max_rel_loss_diff=r, **first)
        log(f"[multidevice] structure step f32 on a {k}-entry mesh, batch {TRAIN_B}x"
            f"{TRAIN_FRAME}^2: {ms:.2f} ms/step (one device {ref_ms:.2f}); 12 losses "
            f"within {r:.3g} relative of one device's (limit {TRAIN_LOSS_RTOL}); timed "
            f"steps under set_sync_debug_mode('error'); chain launches {chain}")
        if not r <= TRAIN_LOSS_RTOL or chain:
            raise AssertionError(f"structure k={k}: losses {r} apart, {chain} chain launches")

    # [train]'s N2N configuration: its seeded weights, frames and step seeds
    torch.manual_seed(seed)
    init = ImprovedUNet(in_nc=1, out_nc=1, n_feature=NF).state_dict()
    frames = n2n_frames(seed, TRAIN_B)[..., None].astype(np.float32)
    aug = AugmentNoise("gauss25")

    def make_n2n(model, mesh, seeds=None):
        seeds = seeds or OperationSeed(seed)
        step = make_n2n_train_step(model, create_train_state(model, lr=3e-4),
                                   noise_fn=aug.add_train_noise, increase_ratio=2.0,
                                   n_epoch=TRAIN_EPOCHS, mesh=mesh)
        return lambda c, nz: step(c, nz, seeds.next(), 1)

    def n2n(mesh):
        return _md_steps(frames, frames, lambda: make_n2n(make_model(), mesh),
                         lambda i: (), (subsample_pair_fused,))

    first = check_first_step("N2N step", make_model, make_n2n, (frames, frames), split)
    ref, ref_ms, (ref_sub,) = n2n(None)
    losses, ms, (sub,) = n2n(mesh_of(split))
    r = rel(losses, ref)
    out["n2n"] = dict(losses=losses, single_losses=ref, ms=ms, single_ms=ref_ms,
                      launches=sub, max_rel_loss_diff=r, **first)
    log(f"[multidevice] N2N step on a {split}-entry mesh, batch {TRAIN_B}x"
        f"{TRAIN_FRAME}^2: {ms:.2f} ms/step (one device {ref_ms:.2f}); sub-sampler "
        f"launches {sub} in {TRAIN_WARMUP + TRAIN_STEPS} steps; losses within {r:.3g} "
        f"relative (limit {TRAIN_LOSS_RTOL})")
    if sub != TRAIN_WARMUP + TRAIN_STEPS or ref_sub != sub or not r <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"N2N mesh: {sub} launches, losses {r} apart")

    # the memory finetune step with the int8 bank sharded over 2
    torch.manual_seed(seed + 75)
    base = ImprovedUNet(in_nc=1, out_nc=1, n_feature=NF).eval()
    fwd = make_forward(base, device="cuda")
    rng = np.random.default_rng(seed + 75)
    cf, nf_, _ = e6_frames(seed)
    batches = []
    for _ in range(TRAIN_WARMUP + TRAIN_STEPS):
        pick = rng.integers(0, E6_PAIRS, FT_B)
        ys, xs = rng.integers(0, FRAME - E6_TILE, (2, FT_B))
        cl = np.stack([cf[p][y : y + E6_TILE, x : x + E6_TILE] for p, y, x in zip(pick, ys, xs)])
        nz = np.stack([nf_[p][y : y + E6_TILE, x : x + E6_TILE] for p, y, x in zip(pick, ys, xs)])
        batches.append(((cl[..., None] / np.float32(255)).astype(np.float32),
                        (nz[..., None] / np.float32(255)).astype(np.float32)))
    mesh = mesh_of(split)
    sharded = shard_bank(bank, mesh)
    cfg = {"t1": 0.3, "t2": 0.7, "tau": 0.1, "margin": 0.0, "ce_factor": 0.5}

    def finetune(banks, retrieval_fn):
        def make():
            torch.manual_seed(seed + 76)
            adapter = build_memory_adapter("hyper_gated_fft", 1, E6_HIDDEN).to("cuda")
            return make_memory_finetune_step(
                DenoiserWithMemoryAdapter(fwd, adapter, retrieval_fn),
                create_train_state(adapter, lr=FT_LR), lambda_grad=FT_LAMBDA,
                lambda_iqsl=FT_LAMBDA, iqsl_cfg=cfg)
        return _md_steps([c for c, _ in batches], [nz for _, nz in batches], make,
                         lambda i: (banks.noise_flat, banks.clean, banks.sq_norms),
                         (top1_l2_retrieval, fused_rdb_chain))

    ref, ref_ms, ref_launches = finetune(bank, None)
    losses, ms, (top1, chain) = finetune(sharded, make_ring_retrieval(mesh, queries_sharded=False))
    r = rel(losses, ref)
    # the indices themselves: the bank with each row's index as its patch
    rows = torch.arange(bank.size, dtype=torch.int32, device="cuda").reshape(-1, 1, 1, 1)
    by_row = MemoryBank(bank.noise_flat, rows, bank.sq_norms, E6_TILE, E6_STRIDE)
    sharded_rows = shard_bank(by_row, mesh)
    ring = make_ring_retrieval(mesh, queries_sharded=False)
    differ = 0
    for _, nz in batches:
        q = torch.from_numpy(nz).to("cuda")
        differ += int((ring(q, sharded_rows.noise_flat, sharded_rows.clean,
                            sharded_rows.sq_norms)
                       != select_memory_patch(q, by_row.noise_flat, by_row.clean,
                                              by_row.sq_norms)).sum())
    out["finetune_sharded"] = dict(losses=losses, ms=ms, single_ms=ref_ms,
                                   launches=dict(top1_l2_retrieval=top1,
                                                 fused_rdb_chain=chain),
                                   max_rel_loss_diff=r, differing_indices=differ)
    log(f"[multidevice] memory finetune step, int8 bank sharded over {split}, batch "
        f"{FT_B}x{E6_TILE}^2 whole: {ms:.2f} ms/step (one bank {ref_ms:.2f}); losses "
        f"within {r:.3g} relative (limit {TRAIN_LOSS_RTOL}); {differ} of "
        f"{FT_B * len(batches)} retrieved indices differ; launches in 12 steps: "
        f"retrieval {top1} (one bank {ref_launches[0]}), chain {chain}")
    if (differ or not r <= TRAIN_LOSS_RTOL
            or top1 != split * (TRAIN_WARMUP + TRAIN_STEPS)):
        raise AssertionError(f"finetune sharded: {differ} indices, losses {r} apart, "
                             f"{top1} retrieval launches")
    return out


def _md_clis(seed: int):
    """The CLIs over ``make_mesh()`` (every visible card) with
    and without the flags: train --parallel (2 steps, losses within
    TRAIN_LOSS_RTOL), evaluation_704 --parallel, evaluation_704_iqsl_memory
    --parallel --bank_sharded and denoise --parallel on 5 frames (the same
    PNGs), finetune_memory --bank_sharded for 1 epoch (the same epoch mean
    L1 within TRAIN_LOSS_RTOL); on one card the same launches too."""
    import re
    import tempfile

    import torch

    from image_denoising_tpu_torch.adapters import build_memory_adapter
    from image_denoising_tpu_torch.ckpt import save_checkpoint
    from image_denoising_tpu_torch.cli import (denoise, evaluation_704,
                                               evaluation_704_iqsl_memory,
                                               finetune_memory, train)
    from image_denoising_tpu_torch.models import ImprovedUNet

    build_dir = os.path.join(REPO, "build")
    os.makedirs(build_dir, exist_ok=True)
    out = {}
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        clean, noise = serving_frames(seed + 77, MD_CLI_FRAMES)
        data = os.path.join(tmp, "data")
        _write_pairs(data, clean, noise)
        torch.manual_seed(seed + 77)
        base = save_checkpoint(ImprovedUNet(in_nc=1, out_nc=1, n_feature=NF),
                               os.path.join(tmp, "base"), "model", 1)
        adapter = save_checkpoint(build_memory_adapter("hyper_gated_fft", 1, E6_HIDDEN),
                                  os.path.join(tmp, "adapter"), "adapter_only", 1)
        train_line = re.compile(r"Loss1=(\d+\.\d+), Loss_Full=(\d+\.\d+)")
        l1_line = re.compile(r"End of epoch 1, mean L1=(\d+\.\d+)")
        nf = ["--n_feature", str(NF)]
        tiles = ["--tile", str(TILE), "--overlap", str(OVERLAP)]
        mem = ["--patch_size", str(E6_TILE), "--adapter_hidden", str(E6_HIDDEN),
               "--memory_stride", str(MD_CLI_STRIDE)]
        cases = {
            "train": (train.main, nf + ["--data_dir", data, "--arch", "UNetImproved",
                                        "--batchsize", "2", "--n_epoch", "1",
                                        "--max_steps_per_epoch", "2"],
                      ["--parallel"], "save_model_path", train_line),
            "evaluation_704": (evaluation_704.main,
                               nf + tiles + ["--data_dir", data, "--checkpoint", base],
                               ["--parallel"], "save_dir", None),
            "evaluation_704_iqsl_memory": (
                evaluation_704_iqsl_memory.main,
                nf + mem + ["--data_dir", data, "--base_ckpt", base, "--adapter_ckpt",
                            adapter, "--overlap", str(OVERLAP), "--bank_dtype", "int8",
                            "--clean_bank_dtype", "uint8"],
                ["--parallel", "--bank_sharded"], "save_dir", None),
            "denoise": (denoise.main, nf + tiles + ["--input_dir", os.path.join(data, "noise"),
                                                    "--checkpoint", base],
                        ["--parallel"], "save_dir", None),
            "finetune_memory": (finetune_memory.main,
                                nf + mem + ["--data_dir", data, "--pretrained_ckpt", base,
                                            "--patches_per_image", "2", "--n_epoch", "1"],
                                ["--bank_sharded"], "save_model_path", l1_line),
        }
        for name, (main, args, flags, where, line) in cases.items():
            runs = {}
            for tag, extra in (("without", []), ("with", flags)):
                target = os.path.join(tmp, f"{name}_{tag}")
                runs[tag] = run_cli(main, args + extra + [f"--{where}", target])
                runs[tag]["dir"] = target
            a, b = runs["with"], runs["without"]
            if line is None:
                same = _same_files(a["dir"], b["dir"])
                agree = f"the same {len(os.listdir(a['dir']))} files: {same}"
            else:
                va = [float(x) for m in line.findall(a["stdout"]) for x in
                      (m if isinstance(m, tuple) else (m,))]
                vb = [float(x) for m in line.findall(b["stdout"]) for x in
                      (m if isinstance(m, tuple) else (m,))]
                r = max(abs(x - y) / abs(y) for x, y in zip(va, vb)) if vb else float("nan")
                same = bool(vb) and len(va) == len(vb) and r <= TRAIN_LOSS_RTOL
                agree = f"{len(va)} logged losses within {r:.3g} relative"
            out[name] = dict(flags=flags, seconds=a["seconds"],
                             seconds_without=b["seconds"], launches=a["launches"],
                             launches_without=b["launches"], same_output=same)
            log(f"[multidevice] {name} {' '.join(flags)} on make_mesh() "
                f"({torch.cuda.device_count()} card): {a['seconds']:.2f} s (without "
                f"{b['seconds']:.2f} s); {agree}; launches {a['launches']} (without "
                f"{b['launches']})")
            # over several cards a tile stack is padded to a multiple of
            # them, which adds launches; over one card the runs are the same
            if not same or (torch.cuda.device_count() == 1
                            and a["launches"] != b["launches"]):
                raise AssertionError(f"{name} {flags}: output or launches differ from "
                                     "the run without the flags")
    return out


def multidevice_cards(seed: int) -> int:
    """``--multidevice-cards``: the [multidevice] phase with each mesh made
    of the machine's first k cards (``make_mesh(devices=["cuda:0", ...,
    "cuda:{k-1}"])``) in place of one card repeated, E2, E6 and the
    data-parallel steps split over MD_CARDS cards and the CLIs over every
    card: the same checks, with peer copies and the cards running at once.
    Prints each card's name and power limit, the phase's lines and one JSON
    line of its numbers; 1 where there are fewer than MD_CARDS cards."""
    import torch

    from image_denoising_tpu_torch.ops import _build
    from image_denoising_tpu_torch.parallel import make_mesh

    n = torch.cuda.device_count()
    if n < MD_CARDS:
        print(f"chip_smoke: --multidevice-cards needs {MD_CARDS} CUDA cards, found {n}",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    for i, line in enumerate(smi):
        log(f"[cards] cuda:{i} {line}")
    log(f"[cards] {n} cards; cuda:0 reaches the others by peer access: "
        f"{[torch.cuda.can_device_access_peer(0, i) for i in range(1, n)]}")
    t0 = time.perf_counter()
    sources = ("fused_block.cu", "retrieval.cu", "neighbor.cu")
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_build.build, sources))
    log(f"[build] {len(sources)} sources in {time.perf_counter() - t0:.2f} s")
    out = phase_multidevice(
        seed, mesh_of=lambda k: make_mesh(devices=[f"cuda:{i}" for i in range(k)]),
        split=MD_CARDS)
    log(json.dumps({"cards": smi, "multidevice": out}, default=str))
    return 0


def multidevice_launches(multi):
    """[multidevice]'s launches of each kernel, by the kernels line's
    entries: chain by compute dtype, retrieval by bank dtype."""
    cli = multi["cli"]
    chain = {"float32": multi["e2"]["float32"]["launches"]
             + multi["e6"]["launches"]["fused_rdb_chain"]
             + multi["train"]["finetune_sharded"]["launches"]["fused_rdb_chain"]
             + sum(cli[k]["launches"]["fused_rdb_chain"] for k in
                   ("evaluation_704", "evaluation_704_iqsl_memory", "finetune_memory")),
             "bfloat16": multi["e2"]["bfloat16"]["launches"]
             + cli["denoise"]["launches"]["fused_rdb_chain"]}
    top1 = {d: sum(r["launches"] for r in multi["retrieval"][d].values())
            for d in multi["retrieval"]}
    top1["int8"] += (multi["e6"]["launches"]["top1_l2_retrieval"]
                     + multi["train"]["finetune_sharded"]["launches"]["top1_l2_retrieval"]
                     + cli["evaluation_704_iqsl_memory"]["launches"]["top1_l2_retrieval"])
    top1["float32"] += cli["finetune_memory"]["launches"]["top1_l2_retrieval"]
    return dict(fused_rdb_chain=chain, top1_l2_retrieval=top1,
                subsample_pair=multi["train"]["n2n"]["launches"])


def phase_multidevice(seed: int, mesh_of=_md_mesh, split: int = MD_MESH):
    """Every multi-device path: the sharded retrieval over 2 and 4 shards,
    E2 and E6 with their tile stacks split over ``split`` (E6 with the
    sharded bank), the data-parallel steps over ``split`` and 3 and the
    CLIs' flags. ``mesh_of(k)`` gives a mesh of k entries: the one card
    repeated (``_md_mesh``), or k distinct cards (``multidevice_cards``)."""
    import torch

    from image_denoising_tpu_torch.adapters import build_memory_adapter
    from image_denoising_tpu_torch.memory import build_memory_bank_from_frames
    from image_denoising_tpu_torch.models import ImprovedUNet

    t0 = time.perf_counter()
    out = dict(retrieval=_md_retrieval(seed, mesh_of), e2=_md_e2(seed, mesh_of, split))
    clean, noise, _ = e6_frames(seed)
    bank = build_memory_bank_from_frames(clean, noise, E6_TILE, E6_STRIDE,
                                         bank_dtype="int8", clean_dtype="uint8",
                                         device="cuda")
    torch.manual_seed(seed)
    model = ImprovedUNet(in_nc=1, out_nc=1, n_feature=NF).eval()
    adapter = build_memory_adapter("hyper_gated_fft", 1, E6_HIDDEN)
    with torch.no_grad():  # every weight non-zero, as in [memory]
        for p in adapter.parameters():
            fan_in = p[0].numel() if p.dim() > 1 else 16
            p.uniform_(-fan_in ** -0.5, fan_in ** -0.5)
    adapter = adapter.to("cuda").eval()
    out["e6"] = _md_e6(seed, bank, model, adapter, mesh_of, split)
    out["train"] = _md_train(seed, bank, mesh_of, split)
    del bank
    torch.cuda.empty_cache()
    out["cli"] = _md_clis(seed)
    out["phase_seconds"] = time.perf_counter() - t0
    one = len(mesh_of(2).distinct()) == 1
    log(f"[multidevice] the phase: {out['phase_seconds']:.2f} s. "
        + ("Each mesh repeats one card: the copies between devices are no-ops; peer "
           "copies, concurrency across cards and scaling are not measured here"
           if one else "Each mesh is distinct cards"))
    return out


def _preds(out):
    """A runner's predictions: the pyramid engine returns (preds, L1)."""
    return out[0] if isinstance(out, tuple) else out


def run_bursts(run, frames):
    """Host frames → host uint8 predictions for each burst, and the seconds
    on the host clock."""
    import numpy as np
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    preds = [_preds(run(torch.from_numpy(b))).cpu().numpy() for b in frames]
    return np.stack(preds), time.perf_counter() - t0


def profile_burst(run, frames, top: int = 5):
    """One burst under torch.profiler (``profile_window``)."""
    import torch

    return profile_window(lambda: _preds(run(torch.from_numpy(frames))).cpu(), top)


def profile_window(fn, top: int = 5):
    """``fn`` under torch.profiler: the host wall time of the window, the
    union of the device's kernel and copy intervals in it (busy time), and
    the kernels that take most device time. The profiler's own cost lengthens
    the window, so the idle share it gives is an upper bound. ``fn`` ends
    with a copy to the host or a synchronise."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_name, counts = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
            counts[e.name] = counts.get(e.name, 0) + 1
    names = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    chain_us = sum(t for n, t in by_name.items() if any(k in n for k in CHAIN_KERNELS))
    fft_us = sum(t for n, t in by_name.items() if any(k in n.lower() for k in FFT_KERNELS))
    return dict(wall_ms=wall_ms, device_busy_ms=busy_us / 1e3,
                busy_share=busy_us / 1e3 / wall_ms if spans else None,
                chain_ms=chain_us / 1e3, fft_ms=fft_us / 1e3,
                top_kernels_ms=[(n[:80], t / 1e3) for n, t in names],
                launch_counts=counts)


def chain_share(prof, burst_s: float) -> str:
    """The chain kernel's device time in a profiled burst, as a share of
    that burst's wall and of a timed burst's (``burst_s``, profiler off)."""
    prof["chain_share_of_timed_burst"] = prof["chain_ms"] / (burst_s * 1e3)
    return (f"chain kernel {prof['chain_ms']:.1f} ms (share "
            f"{prof['chain_ms'] / prof['wall_ms']:.3f} of this wall, "
            f"{prof['chain_share_of_timed_burst']:.3f} of a timed burst's)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=os.path.join(REPO, "build", "chip_smoke.json"),
                    help="where to write the per-shape details")
    ap.add_argument("--subsample-times", metavar="CHECKOUT",
                    help="only time the sub-sampler kernel of the port in CHECKOUT "
                         "(with L2 flushed and in L2, at N=4 352^2) and print one JSON "
                         "line, to compare two checkouts on one card")
    ap.add_argument("--multidevice-cards", action="store_true",
                    help="only run the [multidevice] phase on the machine's first "
                         f"{MD_CARDS} distinct cards (a machine with {MD_CARDS} or more)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    if args.subsample_times:
        return subsample_times(args.subsample_times)
    sys.path.insert(0, REPO)
    try:
        from image_denoising_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})", file=sys.stderr)
        return 1
    _DEFAULT_TF32.update(cudnn=torch.backends.cudnn.allow_tf32,
                         matmul=torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.multidevice_cards:
        return multidevice_cards(args.seed)

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {kind}; torch {torch.__version__} cuda {torch.version.cuda}; {smi}")

    t0 = time.perf_counter()
    sources = ("fused_block.cu", "retrieval.cu", "neighbor.cu")
    host_sources = ("patch_sampler.cpp",)  # g++, for the finetuners' patch stream
    with concurrent.futures.ThreadPoolExecutor(len(sources) + len(host_sources)) as pool:
        # one nvcc or g++ each, together
        futures = ([pool.submit(_build.build, src) for src in sources]
                   + [pool.submit(_build.build_host, src) for src in host_sources])
        built = [f.result() for f in futures]
    build_s = time.perf_counter() - t0
    for (so, nvcc_log) in built:
        log(f"[build] {so.name}")
        for line in nvcc_log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build] {line.strip()}")
    log(f"[build] {len(sources)} CUDA and {len(host_sources)} host sources in "
        f"{build_s:.2f} s")
    _build.load_fused_block()
    _build.load_retrieval()
    _build.load_neighbor()
    _build.load_patch_sampler()

    chain_e2 = phase_chain(args.seed, chain_shapes(TILE), "E2")
    chain_e6 = phase_chain(args.seed + 1, chain_shapes(E6_TILE), "E6")
    # the finetune path's shapes: the step's base at 4 x 128^2 (split K),
    # the output-adapter CLIs' whole-frame validation at 1 x 704^2
    chain_ft = phase_chain(args.seed + 2, chain_shapes(E6_TILE), "FT4x128", reps=3,
                           batch=FT_B)
    chain_frame = phase_chain(args.seed + 3, chain_shapes(FRAME), "FT1x704", reps=3,
                              batch=1)
    top1 = phase_retrieval(args.seed)
    subsample = phase_subsample(args.seed)
    floor = phase_launch_floor()
    main_path = phase_main(args.seed)
    memory = phase_memory(args.seed)
    train = phase_train(args.seed)
    structure = phase_structure(args.seed)
    train_cli = phase_train_cli(args.seed)
    hpo = phase_hpo(args.seed)
    import tempfile

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as keep:
        fine = phase_finetune(args.seed, keep)
        data = phase_data(args.seed, fine["float32"]["ms_per_step"])
        serving = phase_serving(args.seed, fine["kept"])
        networks = phase_networks(args.seed, fine["kept"])
    multi = phase_multidevice(args.seed)
    ft_launches = {k: fine["float32"]["launches"][k] + fine["int8"]["launches"][k]
                   for k in ("fused_rdb_chain", "top1_l2_retrieval")}
    md = multidevice_launches(multi)
    data_launches = data["cli"]["launches"]  # the float32 finetuner and bank of the twin

    summary = []
    for dname, rows in chain_e2.items():
        e6_rows = chain_e6[dname]
        summary.append(dict(
            name="fused_rdb_chain", dtype=dname, route="cuda", design=ROUTES[dname][0],
            source=CHAIN_SOURCE, replaces=CHAIN_REPLACES,
            launches=main_path[dname]["launches"]
            + memory[dname]["launches"]["fused_rdb_chain"]
            + (ft_launches["fused_rdb_chain"] if dname == "float32" else 0)
            + (data_launches["fused_rdb_chain"] if dname == "float32" else 0)
            + serving["launches"][dname] + md["fused_rdb_chain"][dname],
            launches_by_path={"E2": main_path[dname]["launches"],
                              "E6": memory[dname]["launches"]["fused_rdb_chain"],
                              "finetune": (ft_launches["fused_rdb_chain"]
                                           if dname == "float32" else 0),
                              "data": (data_launches["fused_rdb_chain"]
                                       if dname == "float32" else 0),
                              "serving": serving["launches"][dname],
                              "multidevice": md["fused_rdb_chain"][dname]},
            max_abs_err=max(r["max_abs_err"] for r in rows + e6_rows),
            ms=sum(r["ms"] for r in rows),
            plain_ms=sum(r["plain_ms"] for r in rows),
            bound_ms=sum(r["bound_ms"] for r in rows),
            bound_by="operations" if all(r["bound_by"] == "operations"
                                         for r in rows) else "bytes",
            library_ms=None,
            e6={k: sum(r[k] for r in e6_rows) for k in ("ms", "plain_ms", "bound_ms")},
            ft4x128={k: sum(r[k] for r in chain_ft[dname]) for k in ("ms", "plain_ms",
                                                                     "bound_ms")},
            ft1x704={k: sum(r[k] for r in chain_frame[dname]) for k in ("ms", "plain_ms",
                                                                        "bound_ms")},
            max_abs_err_ft=max(r["max_abs_err"] for r in chain_ft[dname]
                               + chain_frame[dname])))
    for dname, res in top1.items():
        big, small, ft = res["rows"]
        launches = (memory["float32"]["launches"]["top1_l2_retrieval"]
                    + memory["bfloat16"]["launches"]["top1_l2_retrieval"]
                    if dname == "int8" else
                    memory[f"{dname}_bank"]["launches"]["top1_l2_retrieval"])
        by_path = {"E6": launches,
                   "finetune": fine[dname]["launches"]["top1_l2_retrieval"]
                   if dname in fine else 0,
                   "data": data_launches["top1_l2_retrieval"] if dname == "float32" else 0,
                   "serving": serving["launches"]["int8"] if dname == "int8" else 0,
                   "E6 UNet base": networks["cli"]["e6"]["launches"]["top1_l2_retrieval"]
                   if dname == "int8" else 0,
                   "multidevice": md["top1_l2_retrieval"].get(dname, 0)}
        summary.append(dict(
            name="top1_l2_retrieval", dtype=dname, route="cuda", design=ROUTES[dname][0],
            source=TOP1_SOURCE, replaces=TOP1_REPLACES, launches=sum(by_path.values()),
            launches_by_path=by_path,
            max_abs_err=res["max_f64_excess"],
            mismatched_indices=res["mismatched_vs_plain"],
            ms=big["ms"], plain_ms=big["plain_ms"], bound_ms=big["bound_ms"],
            bound_by=big["bound_by"], library_ms=big["library_ms"],
            b8={k: small[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
            b4={k: ft[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
            sharded={k: {f: r[f] for f in ("ms", "unsharded_ms", "launches",
                                            "differing_indices")}
                     for k, r in multi["retrieval"].get(dname, {}).items()}))
    sub = subsample[f"n{TRAIN_B}_c1_{TRAIN_FRAME}x{TRAIN_FRAME}_float32"]
    sub704 = subsample[f"n{TRAIN_B}_c1_{FRAME}x{FRAME}_float32"]
    n2n_unet = networks["train"]["n2n_unet"]["launches"]
    summary.append(dict(
        name="subsample_pair", dtype="float32", route="cuda",
        design="4 cells a thread, 16-byte vectors, exact grid (CUDA cores)",
        source=SUB_SOURCE,
        replaces=SUB_REPLACES, launches=train["launches"] + md["subsample_pair"],
        launches_by_path={"N2N train": train["launches"], "train CLI": train_cli["launches"],
                          "N2N UNet 704^2": n2n_unet, "multidevice": md["subsample_pair"]},
        max_abs_err=max(r["max_abs_err"] for r in subsample.values()),
        ms=sub["ms"], plain_ms=sub["plain_ms"], bound_ms=sub["bound_ms"],
        bound_by=sub["bound_by"], library_ms=None, wrapper_ms=sub["wrapper_ms"],
        warm_ms=sub["warm_ms"],
        launch_floor_ms=floor["back_to_back_ms"], empty_kernel_device_ms=floor["device_ms"],
        c3={k: {f: r[f] for f in ("ms", "warm_ms", "plain_ms", "bound_ms")}
            for k, r in subsample.items() if r["c"] == 3 and "ms" in r},
        n2n_704=dict({f: sub704[f] for f in ("ms", "warm_ms", "plain_ms", "bound_ms",
                                             "bound_by")}, launches=n2n_unet)))
    os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
    with open(args.json, "w") as f:
        json.dump(dict(device=kind, nvidia_smi=smi, build_seconds=build_s,
                       torch=torch.__version__, cuda=torch.version.cuda,
                       kernels=dict(chain_e2=chain_e2, chain_e6=chain_e6,
                                    chain_ft4x128=chain_ft, chain_ft1x704=chain_frame,
                                    top1=top1, subsample=subsample, launch_floor=floor),
                       main=main_path, memory=memory, train=train, train_cli=train_cli,
                       structure=structure, hpo=hpo, finetune=fine, data=data,
                       serving=serving,
                       networks=networks, multidevice=multi, summary=summary),
                  f, indent=1)
    log(f"[kernels] fused_rdb_chain: ms/plain_ms/bound_ms sum the 9 chain calls "
        f"of one {B}-tile E2 chunk (e6: of one E6 chunk); design is the route "
        "inside the kernel; "
        "float32 bounds count three TF32 products; library_ms is null: no "
        "single PyTorch call computes the chain. top1_l2_retrieval: B=400 (b8: "
        "B=8); library_ms is torch.mm (torch._int_mm for int8) plus argmin, two "
        "calls, as no single PyTorch call computes top-1 L2; max_abs_err is the "
        "largest float64 distance excess of the kernel's pick over the best row; "
        "launches per entry from the E2 and E6 runs and the 10 timed steps of each "
        "[finetune] bank (float32 entries: the float32 bank; int8: the int8 bank); "
        "launches_by_path[data]: the memory finetuner's run through "
        "scripts/cuda/finetune_memory.sh in [data] (float32, its float32 bank); "
        "ft4x128/ft1x704: the chain at the finetune step's 4x128^2 and the "
        "whole-frame 1x704^2; b4: retrieval at the step's B=4. subsample_pair: "
        "N=4 352^2 C=1 f32 (c3: C=3 f32/bf16); ms is the kernel's device time "
        "(torch.profiler) with L2 flushed before each call, against the bound at "
        "HBM's rate, warm_ms with the image in L2 as in the N2N step, wrapper_ms "
        "the per-call time of calls issued back to "
        "back, launch_floor_ms the per-launch time of an empty kernel issued back "
        "to back; library_ms is null: no one PyTorch call draws and gathers; "
        "launches from the 12 N2N steps; n2n_704: N=4 704^2 C=1 f32, the UNet's N2N "
        "shape, with the launches of [networks]' 12 N2N steps of UNet-48; "
        "launches_by_path[serving]: the [serving] CLI "
        "runs (chain float32 / bfloat16 by the runs' compute dtype; retrieval: E6's "
        "int8 bank); launches_by_path[multidevice]: [multidevice]'s paths on meshes "
        "of the one card (E2 and E6 split, the sharded retrieval's first call per "
        "shard count and batch, the data-parallel steps, the CLIs with their flags); "
        "sharded: ms per sharded retrieval call by shard count and batch")
    log(smi)
    log(json.dumps({"kernels": summary}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
