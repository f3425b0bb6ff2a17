#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--json build/chip_smoke.json]

Phases (any failure exits non-zero; nothing falls back to the CPU):
  1. device  — the card's name and power limit.
  2. build   — nvcc builds csrc/fused_block.cu, csrc/retrieval.cu and
               csrc/neighbor.cu for sm_90a, all at once (seconds printed).
  3. kernels — each kernel against its plain PyTorch version (TF32 off),
               with its route (wgmma bf16, wgmma s8, 3xTF32 for float32,
               CUDA cores) and the earlier CUDA-core kernel's time (PERF.md):
               fused_rdb_chain at the 9 chain shapes of E2 (B=8 tiles of
               352²) and of E6 (B=8 tiles of 128², down to the 8×8
               bottleneck), in float32 and bfloat16, with the blocks of
               each launch; top1_l2_retrieval on
               seeded device banks of N=105,125 rows of D=16,384 in float32,
               bfloat16 and int8, with B=400 and B=8 queries, a duplicated
               row (the first must win), near ties that one TF32 product
               gets wrong and a bank padded to 512 rows (no padded row may
               win); subsample_pair at N=4 352² frames, C=1
               float32 (the training shape) and C=3 float32 and bfloat16:
               selectors and sub-images bit-equal, only the 8 listed pairs,
               each within 0.005 of 1/8, same seed same maps, another seed
               other maps, one map for all channels. Times (CUDA events,
               median; the sub-sampler's device time from torch.profiler)
               and bounds.
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
Prints the card line, a {"kernels": [...]} line, and last
{"ok": true, "device": {...}}. Per-shape details go to the --json file.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import copy
import json
import os
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
# integer operations of one cell's draw: 10 Philox rounds of 2 multiplies, 2
# high multiplies, 4 xors and 2 key adds, plus the table look-ups
PHILOX_OPS_PER_CELL = 10 * 10 + 8

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


def phase_chain(seed: int, shapes, label: str, reps: int = 5):
    """fused_rdb_chain against its plain version at ``shapes``, batch B."""
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
            ms = time_ms(lambda: fused_rdb_chain(x, wts), reps=reps)
            plain_ms = time_ms(lambda: fused_rdb_chain_reference(x, wts), reps=reps)
            flops, nbytes = chain_work(h, cin, nf, lead, x.element_size())
            bound_ms, bound_by = bound(flops, nbytes, peak)
            blocks = {conv: p["blocks"] for conv, p in chain_conv_plans(B, h, h, cin, wts)}
            row = dict(name=name, h=h, cin=cin, nf=nf, lead=lead, blocks=blocks,
                       max_abs_err=err, tol=tol, max_abs_ref=scale,
                       ms=ms, plain_ms=plain_ms, gflop=flops / 1e9,
                       mbytes=nbytes / 1e6, bound_ms=bound_ms, bound_by=bound_by,
                       tflops=flops / ms / 1e9)
            rows.append(row)
            log(f"[kernels] chain {label} {dname:8s} {name:6s} B={B} {h}x{h} "
                f"{cin}->{nf}: max_abs_err {err:.3g} (tol {tol:.3g}) kernel "
                f"{ms:.3f} ms plain {plain_ms:.3f} ms bound {bound_ms:.3f} ms "
                f"({bound_by}) {row['tflops']:.2f} TFLOP/s; {route}; blocks per "
                f"launch {list(blocks.values())}")
            if not err <= tol:
                raise AssertionError(f"{label} {dname} {name}: max_abs_err {err} > {tol}")
            del x, wts
        results[dname] = rows
        ms = sum(r["ms"] for r in rows)
        log(f"[kernels] chain {label} {dname:8s} the 9 calls of one {B}-tile chunk: "
            f"{ms:.3f} ms on the {route} route (the CUDA-core kernel: "
            f"{EARLIER_CHAIN_MS[label, dname]} ms, PERF.md); bound "
            f"{sum(r['bound_ms'] for r in rows):.3f} ms")
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
        # padded to 512 rows: no padded row may win, the picks do not move
        bp, sp = pad_bank_for_retrieval(bank, sqn, 512)
        idx_p = top1_l2_retrieval(q, bp, sp)
        if not torch.equal(idx_p, idx) or int(idx_p.max()) >= n:
            raise AssertionError(f"{dname}: the padded bank changed the picks")
        del bp, sp, idx_p

        route, peak = ROUTES[dname]
        rows = []
        for b in (E6_TILES, 8):
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
            log(f"[kernels] top1 {dname:8s} B={b:3d} N={n} D={d}: kernel {ms:.3f} ms "
                f"plain {plain_ms:.3f} ms library {library_ms:.3f} ms bound "
                f"{bound_ms:.3f} ms ({bound_by}) {rows[-1]['tops']:.2f} TOP/s; {route} "
                f"(the CUDA-core kernel: {EARLIER_TOP1_MS[dname, b]} ms, PERF.md)")
        results[dname] = dict(max_f64_excess=excess, tol=tol,
                              mismatched_vs_plain=mism_plain,
                              mismatched_where_gap_exceeds_tol=mism_gap,
                              near_ties_right=ties, rows=rows)
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


def kernel_device_ms(fn, name: str, reps: int = 50) -> float:
    """Median device time (ms) of the kernel whose name contains ``name``,
    over ``reps`` calls of ``fn``, from torch.profiler: a launch of a few
    microseconds is shorter than the host's time to issue it, so CUDA events
    around calls would time the host."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [(e.time_range.end - e.time_range.start) / 1e3 for e in prof.events()
             if e.device_type == DeviceType.CUDA and name in e.name]
    if len(times) != reps:
        raise AssertionError(f"the profiler saw {len(times)} '{name}' kernels, want {reps}")
    return statistics.median(times)


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


def phase_subsample(seed: int):
    """subsample_pair_fused against its plain version at the training shape
    (N=4, 352², C=1, f32) and at C=3 in f32 and bf16."""
    import numpy as np
    import torch

    from image_denoising_tpu_torch.ops.neighbor import (
        generate_subimages, subsample_pair, subsample_pair_fused)
    from image_denoising_tpu_torch.ops.rng import OperationSeed

    rng = np.random.default_rng(seed + 3)
    seeds = OperationSeed(seed + 3)
    valid = [4 * a + b for a, b in VALID_PAIRS]
    h2 = TRAIN_FRAME // 2
    results = {}
    for c, dname in ((1, "float32"), (3, "float32"), (3, "bfloat16")):
        dt = getattr(torch, dname)
        img = torch.from_numpy(rng.random((TRAIN_B, c, TRAIN_FRAME, TRAIN_FRAME),
                                          dtype=np.float32)).to("cuda", dt)
        s, other = seeds.next(), seeds.next()
        got = subsample_pair_fused(s, img)
        want = subsample_pair(s, img)
        again = subsample_pair_fused(s, img)
        _, _, (o1, o2) = subsample_pair_fused(other, img)
        torch.cuda.synchronize()
        sub1, sub2, (sel1, sel2) = got
        what = f"subsample_pair C={c} {dname}"
        assert sub1.shape == sub2.shape == (TRAIN_B, c, h2, h2) and sub1.dtype == dt
        assert sel1.shape == sel2.shape == (TRAIN_B, h2, h2) and sel1.dtype == torch.int32

        def parts(r):
            return _bits(r[0]), _bits(r[1]), r[2][0], r[2][1]

        if not all(torch.equal(a, b) for a, b in zip(parts(got), parts(want))):
            raise AssertionError(f"{what}: the kernel differs from the plain version")
        err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got[:2], want[:2]))
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
        ms = kernel_device_ms(lambda: subsample_pair_fused(s, img), "subsample_pair_kernel")
        wrapper_ms = call_ms(lambda: subsample_pair_fused(s, img))
        plain_ms = time_ms(lambda: subsample_pair(s, img), reps=5)
        item = img.element_size()
        nbytes = img.numel() * item + 2 * sub1.numel() * item + 2 * cells * 4
        # integer operations, counted at the f32 rate: bytes bound by far
        bound_ms, bound_by = bound(cells * PHILOX_OPS_PER_CELL, nbytes, "float32")
        results[f"c{c}_{dname}"] = dict(
            c=c, dtype=dname, max_abs_err=err, max_pair_freq_err=freq_err,
            ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, mbytes=nbytes / 1e6, cells=cells)
        log(f"[kernels] subsample_pair N={TRAIN_B} {TRAIN_FRAME}^2 C={c} {dname:8s}: "
            f"bit-equal to the plain version; {cells} cells, pair frequencies within "
            f"{freq_err:.4g} of 1/8; kernel {ms * 1e3:.3f} us on the device, "
            f"{wrapper_ms * 1e3:.2f} us per call issued back to back; plain "
            f"{plain_ms:.3f} ms; bound {bound_ms * 1e3:.3f} us ({bound_by})")
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


def phase_train_cli(seed: int):
    """cli/train.main with --loss n2n for 1 epoch of 2 steps on 8 seeded
    352² PNG pairs in a temporary directory under build/."""
    import glob
    import tempfile

    import numpy as np
    import torch
    from PIL import Image

    from image_denoising_tpu_torch.cli import train as train_cli
    from image_denoising_tpu_torch.models import ImprovedUNet
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
        subsample_pair_fused.launches = 0
        t0 = time.perf_counter()
        train_cli.main(["--data_dir", data, "--save_model_path", os.path.join(tmp, "out"),
                        "--loss", "n2n", "--arch", "UNetImproved", "--n_epoch", "1",
                        "--max_steps_per_epoch", "2", "--batchsize", str(TRAIN_B),
                        "--seed", str(seed)])
        sec = time.perf_counter() - t0
        launches = subsample_pair_fused.launches
        if launches != 2:
            raise AssertionError(f"train CLI: {launches} sub-sampler launches, want 2")
        (run_dir,) = glob.glob(os.path.join(tmp, "out", "*", "*"))
        for name in ("epoch_model_000.pth", "epoch_model_001.pth"):
            ImprovedUNet(1, 1, NF).load_state_dict(
                torch.load(os.path.join(run_dir, name), weights_only=True), strict=True)
        with open(os.path.join(run_dir, "validation", "A_log.csv")) as f:
            a_log = f.read().strip()
        mean_loss = float(a_log.split("loss_")[1].split(",")[0])
        if not (a_log.startswith("epoch1,") and np.isfinite(mean_loss)):
            raise AssertionError(f"train CLI: A_log.csv reads {a_log!r}")
        if len(glob.glob(os.path.join(run_dir, "validation", "*_denoised.png"))) != 1:
            raise AssertionError("train CLI: no validation PNG")
    log(f"[train] cli.train.main --loss n2n, 1 epoch of 2 steps at batch {TRAIN_B} "
        f"of {TRAIN_FRAME}^2, validation of 8 frames: {sec:.2f} s; checkpoints "
        f"000/001 load strict; A_log.csv {a_log!r}; sub-sampler launches {launches}")
    return dict(seconds=sec, launches=launches, a_log=a_log)


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
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    names = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    chain_us = sum(t for n, t in by_name.items() if any(k in n for k in CHAIN_KERNELS))
    return dict(wall_ms=wall_ms, device_busy_ms=busy_us / 1e3,
                busy_share=busy_us / 1e3 / wall_ms if spans else None,
                chain_ms=chain_us / 1e3,
                top_kernels_ms=[(n[:80], t / 1e3) for n, t in names])


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
    sources = ("fused_block.cu", "retrieval.cu", "neighbor.cu")
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(_build.build, sources))  # one nvcc each, together
    build_s = time.perf_counter() - t0
    for (so, nvcc_log) in built:
        log(f"[build] {so.name}")
        for line in nvcc_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {line.strip()}")
    log(f"[build] {len(sources)} sources in {build_s:.2f} s")
    _build.load_fused_block()
    _build.load_retrieval()
    _build.load_neighbor()

    chain_e2 = phase_chain(args.seed, chain_shapes(TILE), "E2")
    chain_e6 = phase_chain(args.seed + 1, chain_shapes(E6_TILE), "E6")
    top1 = phase_retrieval(args.seed)
    subsample = phase_subsample(args.seed)
    main_path = phase_main(args.seed)
    memory = phase_memory(args.seed)
    train = phase_train(args.seed)
    train_cli = phase_train_cli(args.seed)

    summary = []
    for dname, rows in chain_e2.items():
        e6_rows = chain_e6[dname]
        summary.append(dict(
            name="fused_rdb_chain", dtype=dname, route="cuda", design=ROUTES[dname][0],
            source=CHAIN_SOURCE, replaces=CHAIN_REPLACES,
            launches=main_path[dname]["launches"]
            + memory[dname]["launches"]["fused_rdb_chain"],
            launches_by_path={"E2": main_path[dname]["launches"],
                              "E6": memory[dname]["launches"]["fused_rdb_chain"]},
            max_abs_err=max(r["max_abs_err"] for r in rows + e6_rows),
            ms=sum(r["ms"] for r in rows),
            plain_ms=sum(r["plain_ms"] for r in rows),
            bound_ms=sum(r["bound_ms"] for r in rows),
            bound_by="operations" if all(r["bound_by"] == "operations"
                                         for r in rows) else "bytes",
            library_ms=None,
            e6={k: sum(r[k] for r in e6_rows) for k in ("ms", "plain_ms", "bound_ms")}))
    for dname, res in top1.items():
        big, small = res["rows"]
        launches = (memory["float32"]["launches"]["top1_l2_retrieval"]
                    + memory["bfloat16"]["launches"]["top1_l2_retrieval"]
                    if dname == "int8" else
                    memory[f"{dname}_bank"]["launches"]["top1_l2_retrieval"])
        summary.append(dict(
            name="top1_l2_retrieval", dtype=dname, route="cuda", design=ROUTES[dname][0],
            source=TOP1_SOURCE, replaces=TOP1_REPLACES, launches=launches,
            max_abs_err=res["max_f64_excess"],
            mismatched_indices=res["mismatched_vs_plain"],
            ms=big["ms"], plain_ms=big["plain_ms"], bound_ms=big["bound_ms"],
            bound_by=big["bound_by"], library_ms=big["library_ms"],
            b8={k: small[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")}))
    sub = subsample["c1_float32"]
    summary.append(dict(
        name="subsample_pair", dtype="float32", route="cuda", design="CUDA cores",
        source=SUB_SOURCE,
        replaces=SUB_REPLACES, launches=train["launches"],
        launches_by_path={"N2N train": train["launches"], "train CLI": train_cli["launches"]},
        max_abs_err=max(r["max_abs_err"] for r in subsample.values()),
        ms=sub["ms"], plain_ms=sub["plain_ms"], bound_ms=sub["bound_ms"],
        bound_by=sub["bound_by"], library_ms=None, wrapper_ms=sub["wrapper_ms"],
        c3={k: {f: r[f] for f in ("ms", "plain_ms", "bound_ms")}
            for k, r in subsample.items() if r["c"] == 3}))
    os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
    with open(args.json, "w") as f:
        json.dump(dict(device=kind, nvidia_smi=smi, build_seconds=build_s,
                       torch=torch.__version__, cuda=torch.version.cuda,
                       kernels=dict(chain_e2=chain_e2, chain_e6=chain_e6, top1=top1,
                                    subsample=subsample),
                       main=main_path, memory=memory, train=train, train_cli=train_cli,
                       summary=summary),
                  f, indent=1)
    log(f"[kernels] fused_rdb_chain: ms/plain_ms/bound_ms sum the 9 chain calls "
        f"of one {B}-tile E2 chunk (e6: of one E6 chunk); design is the route "
        "inside the kernel; "
        "float32 bounds count three TF32 products; library_ms is null: no "
        "single PyTorch call computes the chain. top1_l2_retrieval: B=400 (b8: "
        "B=8); library_ms is torch.mm (torch._int_mm for int8) plus argmin, two "
        "calls, as no single PyTorch call computes top-1 L2; max_abs_err is the "
        "largest float64 distance excess of the kernel's pick over the best row; "
        "launches per entry from the E2 and E6 runs. subsample_pair: N=4 352^2 "
        "C=1 f32 (c3: C=3 f32/bf16); ms is the kernel's device time "
        "(torch.profiler), wrapper_ms the per-call time of calls issued back to "
        "back; library_ms is null: no one PyTorch call draws and gathers; "
        "launches from the 12 N2N steps")
    log(smi)
    log(json.dumps({"kernels": summary}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
