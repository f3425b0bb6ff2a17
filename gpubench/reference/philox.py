"""Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
3", SC'11; Random123's constants and round order), the reference's own, on
numpy ``uint64`` arrays that hold 32-bit words, and the draws of the N2N
step that the program keys with it.

A round multiplies counter words 0 and 2 by the two constants, and the
64-bit product of a 32-bit constant and a 32-bit word fits ``uint64``
exactly; the key takes its Weyl increments between rounds.

The program's layout (``ops/rng.py``, ``ops/neighbor.py``): a 64-bit key k
is (k mod 2³², k div 2³²). A run's n-th operation seed (n from 1) is words
0 and 1 of the block at counter (n mod 2³², n div 2³², 0, 0) under the
run's seed. A step's seed splits into a noise seed (words 0, 1) and a mask
seed (words 2, 3) of the block at counter 0. The N2N mask draws, for image
i and 2×2 cell j (row-major over the half-size grid), word 0 of the block
at counter (j, i, 0, 0) under the mask seed, mod 8.
"""
from __future__ import annotations

import numpy as np

M32 = 0xFFFFFFFF
MUL = (np.uint64(0xD2511F53), np.uint64(0xCD9E8D57))
WEYL = (0x9E3779B9, 0xBB67AE85)


def philox(c0, c1, c2, c3, key: int):
    """The four output words of counter (c0, c1, c2, c3) under a 64-bit
    ``key``; counter words broadcastable ints or arrays below 2³²."""
    c = [np.asarray(w, dtype=np.uint64) for w in (c0, c1, c2, c3)]
    k0, k1 = key & M32, key >> 32 & M32
    for r in range(10):
        if r:
            k0, k1 = (k0 + WEYL[0]) & M32, (k1 + WEYL[1]) & M32
        p0, p1 = MUL[0] * c[0], MUL[1] * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ np.uint64(k0), p1 & np.uint64(M32),
             (p0 >> np.uint64(32)) ^ c[3] ^ np.uint64(k1), p0 & np.uint64(M32)]
    return c


def block64(key: int, counter: int):
    """Two 64-bit words of the block at a 64-bit ``counter``."""
    w = [int(x) for x in philox(counter & M32, counter >> 32 & M32, 0, 0, key)]
    return w[0] | w[1] << 32, w[2] | w[3] << 32


def step_seeds(seed: int, n: int):
    """The run's first ``n`` operation seeds."""
    return [block64(seed, i)[0] for i in range(1, n + 1)]


def mask_draws(key: int, n: int, cells: int, counter_offset: int = 0) -> np.ndarray:
    """int64 [n, cells]: each cell's draw in 0..7; ``counter_offset`` moves
    every cell's counter (a control)."""
    j = np.arange(cells, dtype=np.uint64)[None, :] + np.uint64(counter_offset)
    i = np.arange(n, dtype=np.uint64)[:, None]
    return (philox(j, i, 0, 0, key)[0] & np.uint64(7)).astype(np.int64)
