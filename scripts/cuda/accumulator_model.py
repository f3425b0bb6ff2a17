#!/usr/bin/env python3
"""A numpy model of the tensor cores' float32 accumulator, and what it does
to the port's checks.

    python3 scripts/cuda/accumulator_model.py      # numpy only, no card

A ``wgmma`` instruction adds the products of its K slice to the float32
accumulator and truncates the result toward zero. The model sums each
instruction's products exactly (float64), then truncates, in the kernels'
order:

* the chain (``csrc/fused_block.cu``, float32): a K-stage is 8 input
  channels; per stage and tap, one k8 step of 3 instructions (3xTF32:
  hi·hi, hi·lo, lo·hi). One accumulator over the conv, or a fresh one per
  stage whose sum is added, rounded to nearest, to a second accumulator.
  Read against ``chip_smoke.chain_tol``: the largest error over outputs, as
  a share of the limit at those outputs' largest magnitude.
* the bf16 retrieval (``csrc/retrieval.cu``): one accumulator over D, one
  instruction per 16 products. Read as the shift of the distance between
  the two rows of a near tie (``chip_smoke.bf16_tie_rows``), as a share of
  ``chip_smoke.f32_pick_tol``.

It prints one JSON line per reading. The readings are predictions for the
card, not measurements of it.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
TAPS = 9
STAGE_CHANNELS = 8  # two 16-byte chunks of 4 float32 channels
# (name, input channels) of three float32 convs of E2's chain: up0's lead,
# the bottleneck's first growth conv, down3's lead
CONVS = (("up0 lead", 576), ("bottle growth0", 384), ("down3 lead", 192))


def _chip_smoke():
    sys.path.insert(0, str(REPO))
    import chip_smoke

    return chip_smoke


def truncate(x: np.ndarray) -> np.ndarray:
    """float64 ``x`` to the float32 next to it toward zero."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    return np.where(over, np.nextafter(f, np.float32(0)), f)


def split_tf32(x: np.ndarray):
    """float32 ``x`` → (hi, lo): hi rounded to TF32 (10 mantissa bits, ties
    away from zero), lo = x − hi exact; the tensor cores read lo's top 19
    bits."""
    bits = x.astype(np.float32).view(np.int32)
    hi = ((bits & np.int32(-0x80000000)) | (((bits & 0x7FFFFFFF) + 0x1000) & 0x7FFFE000))
    hi = hi.astype(np.int32).view(np.float32)
    lo = (x.astype(np.float32) - hi).view(np.int32) & np.int32(-0x2000)
    return hi, lo.view(np.float32)


def chain_inputs(cin: int, outputs: int, one_way: bool, seed: int = 0):
    """Activations and weights of ``outputs`` output values of one 3×3 conv
    of ``cin`` input channels, float32 ``[outputs, K]`` in the kernel's K
    order (stage, tap, channel): one way, activations uniform in [0, 1) and
    weights in [0, bound); else standard normal and uniform in
    (−bound, bound); bound = fan_in^-½, as ``chip_smoke.random_chain``."""
    rng = np.random.default_rng(seed)
    k = TAPS * cin
    bound = k ** -0.5
    if one_way:
        x = rng.uniform(0.0, 1.0, (outputs, k))
        w = rng.uniform(0.0, bound, (outputs, k))
    else:
        x = rng.standard_normal((outputs, k))
        w = rng.uniform(-bound, bound, (outputs, k))
    return x.astype(np.float32), w.astype(np.float32)


def chain_conv(x: np.ndarray, w: np.ndarray, per_stage: bool) -> np.ndarray:
    """The model of the float32 chain kernel's sum of ``x·w`` along K, per
    output: 3 instructions per k8 step (hi·hi, hi·lo, lo·hi), each step 8
    channels of one tap; with ``per_stage``, a fresh accumulator per K-stage
    (9 taps) added to a second one, rounded to nearest."""
    xh, xl = split_tf32(x)
    wh, wl = split_tf32(w)
    steps = x.shape[1] // STAGE_CHANNELS
    parts = [(a.astype(np.float64) * b.astype(np.float64)).reshape(
        len(x), steps, STAGE_CHANNELS).sum(2) for a, b in ((xh, wh), (xh, wl), (xl, wh))]
    total = np.zeros(len(x), np.float32)
    acc = np.zeros(len(x), np.float32)
    for step in range(steps):
        for part in parts:
            acc = truncate(acc.astype(np.float64) + part[:, step])
        if per_stage and (step + 1) % TAPS == 0:
            total = (total.astype(np.float64) + acc).astype(np.float32)
            acc = np.zeros_like(acc)
    return (total.astype(np.float64) + acc).astype(np.float32) if per_stage else acc


def chain_reading(cin: int, one_way: bool, per_stage: bool, outputs: int = 256,
                  seed: int = 0) -> float:
    """The largest error of ``chain_conv`` against the float64 sum, over
    ``outputs`` outputs, as a share of ``chip_smoke.chain_tol``."""
    x, w = chain_inputs(cin, outputs, one_way, seed)
    exact = (x.astype(np.float64) * w.astype(np.float64)).sum(1)
    err = np.abs(chain_conv(x, w, per_stage) - exact).max()
    return float(err / _chip_smoke().chain_tol("float32", float(np.abs(exact).max())))


def bf16_tie_shift(d: int = 16384, ties: int = 6, per_instruction: int = 16,
                   seed: int = 0) -> float:
    """The largest shift of d(A) − d(B) (d = ‖b‖² − 2q·b) between the two
    rows of a bf16 near tie when q·b is summed by one truncating float32
    accumulator, ``per_instruction`` products an instruction, as a share of
    ``chip_smoke.f32_pick_tol``. Queries uniform in [0, 1), rows
    (1 − s)·q and (1 + s)·q, s = ``chip_smoke.TIE_S``, all rounded to bf16
    (8 mantissa bits)."""
    cs = _chip_smoke()
    rng = np.random.default_rng(seed)

    def bf16(v):
        bits = v.astype(np.float32).view(np.uint32)
        bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & np.uint32(0xFFFF0000)
        return bits.view(np.float32)

    q = bf16(rng.uniform(0.0, 1.0, (ties, d)))
    rows = [bf16((1 - cs.TIE_S) * q.astype(np.float64)),
            bf16((1 + cs.TIE_S) * q.astype(np.float64))]
    shifts = []
    for r in rows:
        prods = (q.astype(np.float64) * r).reshape(ties, d // per_instruction,
                                                   per_instruction).sum(2)
        acc = np.zeros(ties, np.float32)
        for i in range(prods.shape[1]):
            acc = truncate(acc.astype(np.float64) + prods[:, i])
        shifts.append(-2.0 * (acc - (q.astype(np.float64) * r).sum(1)))
    tol = cs.f32_pick_tol(d, float(np.linalg.norm(q, axis=1).max()),
                          float(np.linalg.norm(rows[1], axis=1).max()))
    return float(np.abs(shifts[0] - shifts[1]).max() / tol)


def main() -> int:
    for name, cin in CONVS:
        for one_way in (True, False):
            for per_stage in (False, True):
                print(json.dumps(dict(
                    conv=name, k=TAPS * cin,
                    instructions_on_one_accumulator=(
                        3 * TAPS if per_stage else 3 * TAPS * cin // STAGE_CHANNELS),
                    inputs="one way" if one_way else "zero mean",
                    accumulator="per-stage sum" if per_stage else "one",
                    share_of_chain_tol=chain_reading(cin, one_way, per_stage))))
    print(json.dumps(dict(bf16_retrieval_tie_shift_share_of_f32_pick_tol=bf16_tie_shift(),
                          instructions=16384 // 16)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
