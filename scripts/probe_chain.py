#!/usr/bin/env python3
"""Which part of the chain kernel (csrc/fused_block.cu) bounds its time.

    python3 scripts/probe_chain.py        # on a machine with an H100

Builds three variants of the source with ``IDT_PROBE_SKIP`` set (their
results are wrong; only their times are read), each with one part taken
out: ``no_mma`` issues no wgmma, ``no_act`` loads no activation halo, and
``no_weight`` copies no weights. It runs the source and each variant through
the wrapper ``fused_rdb_chain`` in bfloat16 at five of the main paths' chain
shapes (E2 down0, down3 and up3; E6 down0 and the bottleneck) and prints the
chain kernels' device time per call (``chip_smoke.profile_window``). Where
taking a part out leaves the time as it was, that part does not bound the
kernel. The libraries build under the git-ignored ``build/kernels/``.
"""
from __future__ import annotations

import concurrent.futures
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

# csrc/fused_block.cu's kSkipMma, kSkipAct, kSkipWeight
VARIANTS = {"whole": (), "no_mma": ("IDT_PROBE_SKIP=1",),
            "no_act": ("IDT_PROBE_SKIP=2",), "no_weight": ("IDT_PROBE_SKIP=4",)}
REPS = 5


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from image_denoising_tpu_torch.ops import _build
    from image_denoising_tpu_torch.ops import fused_block as fbm

    if not torch.cuda.is_available():
        print("probe_chain: no CUDA device", file=sys.stderr)
        return 1
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        list(pool.map(lambda d: _build.build("fused_block.cu", d), VARIANTS.values()))

    rng = np.random.default_rng(0)
    shapes = ([(s, "E2") for s in cs.chain_shapes(cs.TILE) if s[0] in ("down0", "down3", "up3")]
              + [(s, "E6") for s in cs.chain_shapes(cs.E6_TILE) if s[0] in ("down0", "bottle")])
    cases = []
    for (name, h, cin, nf, lead), label in shapes:
        x = torch.from_numpy(rng.standard_normal((cs.B, h, h, cin)).astype("float32"))
        cases.append((f"{label} {name} {h}^2", x.to("cuda", torch.bfloat16),
                      cs.random_chain(rng, cin, nf, lead, torch.bfloat16)))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    load = _build.load_fused_block
    try:
        for name, defines in VARIANTS.items():
            _build.load_fused_block = lambda d=defines: load(d)
            row = []
            for label, x, wts in cases:
                for _ in range(2):
                    fbm.fused_rdb_chain(x, wts)

                def calls():
                    for _ in range(REPS):
                        fbm.fused_rdb_chain(x, wts)
                    torch.cuda.synchronize()

                row.append(f"{label} {cs.profile_window(calls)['chain_ms'] / REPS:.3f}")
            print(f"[probe] {name:9s} device ms per chain call | " + " | ".join(row), flush=True)
    finally:
        _build.load_fused_block = load
    return 0


if __name__ == "__main__":
    sys.exit(main())
