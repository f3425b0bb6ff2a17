#!/usr/bin/env python3
"""Write ``image_denoising_tpu_torch/csrc/wgmma.cuh``: inline-PTX wrappers of
Hopper's ``wgmma.mma_async`` with both operands in shared memory.

    python3 scripts/gen_wgmma.py

A ``wgmma`` names every accumulator register in its operand list (N/2 of
them for an m64nN tile), so each (type, N) pair is its own asm statement.
This script writes one explicit specialisation of
``wgmma_ss<N, KIND>(acc, desc_a, desc_b)`` per pair the kernels use
(``tests/test_torch_tf32x3.py`` checks that the header is up to date).
"""
from __future__ import annotations

import sys
from pathlib import Path

OUT = (Path(__file__).resolve().parents[1]
       / "image_denoising_tpu_torch" / "csrc" / "wgmma.cuh")

# kind: (enum name, PTX type suffix, k, accumulator C type, constraint,
#        trailing immediates after scale-d)
KINDS = {
    "kTF32": ("f32.tf32.tf32", 8, "float", "f", ", 1, 1"),
    "kBF16": ("f32.bf16.bf16", 16, "float", "f", ", 1, 1, 0, 0"),
    "kS8": ("s32.s8.s8", 32, "int", "r", ""),
}
# N of the retrieval kernel's query tiles and of the chain kernel's
# output-channel tiles
WIDTHS = {
    "kTF32": (8, 16, 32, 48, 64, 96, 128, 208, 256),
    "kBF16": (8, 16, 32, 48, 64, 96, 128, 192, 208, 256),
    "kS8": (8, 64, 128, 208, 256),
}

HEAD = """\
// Generated by scripts/gen_wgmma.py: do not edit by hand.
//
// wgmma_ss<N, KIND>(d, desc_a, desc_b): one warpgroup-wide
//   d[64 x N] += A[64 x K] * B[K x N]
// with A and B in shared memory, both K-major, read through 64-bit matrix
// descriptors; K is 32 bytes of the input type (8 tf32, 16 bf16, 32 s8).
// Each thread holds N/2 accumulators: d[4i + 2j + c] is row
// 16*warp + lane/4 + 8j, column 8i + 2*(lane%4) + c. The call is
// asynchronous: fence, commit and wait around it (hopper.cuh).
#pragma once

#include <cstdint>

namespace idt {

enum WgmmaKind : int { kTF32 = 0, kBF16 = 1, kS8 = 2 };

template <int KIND>
struct WgmmaAcc { using type = float; };
template <>
struct WgmmaAcc<kS8> { using type = int; };

template <int N, int KIND>
__device__ __forceinline__ void wgmma_ss(typename WgmmaAcc<KIND>::type (&d)[N / 2],
                                         uint64_t desc_a, uint64_t desc_b);
"""


def spec(kind: str, n: int) -> str:
    ptx, k, ctype, cons, tail = KINDS[kind]
    regs = n // 2
    dlist = ", ".join(f"%{i}" for i in range(regs))
    outs = ",\n        ".join(
        ", ".join(f'"+{cons}"(d[{i}])' for i in range(r, min(r + 8, regs)))
        for r in range(0, regs, 8))
    return f"""
template <>
__device__ __forceinline__ void wgmma_ss<{n}, {kind}>({ctype} (&d)[{regs}],
                                                   uint64_t desc_a, uint64_t desc_b) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{regs + 2}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k{k}.{ptx} "
      "{{{dlist}}}, %{regs}, %{regs + 1}, p{tail};\\n}}\\n"
      : {outs}
      : "l"(desc_a), "l"(desc_b), "r"(1));
}}
"""


def render() -> str:
    body = "".join(spec(kind, n) for kind in KINDS for n in WIDTHS[kind])
    return HEAD + body + "\n}  // namespace idt\n"


def main() -> int:
    OUT.write_text(render())
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
