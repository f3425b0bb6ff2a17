"""Counter-based random numbers (counterpart of ``image_denoising_tpu/ops/rng.py``).

``philox4x32_10`` is Philox4x32-10 (Salmon et al., SC'11; Random123's
constants and round order) written with integer operators only, so the same
function runs on Python ints and on int64 tensors that hold uint32 values.
The N2N selector draw (``ops/neighbor.py``) and its CUDA kernel
(``csrc/neighbor.cu``) use it with one counter per 2×2 cell.

``OperationSeed`` derives a fresh 64-bit seed for every random op of a run
from (base_seed, counter), as the JAX version derives a fresh PRNG key: the
n-th random op of a run is a pure function of the run seed. The two
packages' streams differ by design.
"""
from __future__ import annotations

__all__ = ["OperationSeed", "philox4x32_10", "split_seed"]

MASK32 = 0xFFFFFFFF
MASK64 = 0xFFFFFFFFFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57   # round multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85   # key schedule (Weyl) increments


def _mulhilo(m: int, x):
    """(high, low) 32-bit words of m·x for a 32-bit constant m and uint32
    values x. x is split into 16-bit halves so that no partial product
    reaches 2⁴⁹: int64 tensors never overflow."""
    p_lo = m * (x & 0xFFFF)
    p_hi = m * (x >> 16)
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & MASK32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 of counter (c0, c1, c2, c3) under key (k0, k1).

    Counter words are Python ints or int64 tensors of uint32 values
    (broadcastable); the key is two ints. Returns the four output words in
    the counter words' type.
    """
    k0, k1 = k0 & MASK32, k1 & MASK32
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & MASK32, (k1 + _W1) & MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _block64(seed: int, counter: int):
    """Two 64-bit words of one Philox block keyed by a 64-bit seed."""
    seed &= MASK64
    w = philox4x32_10(counter & MASK32, counter >> 32 & MASK32, 0, 0,
                      seed & MASK32, seed >> 32)
    return w[0] | w[1] << 32, w[2] | w[3] << 32


def split_seed(seed: int):
    """Two independent 64-bit seeds from one (``jax.random.split``'s role)."""
    return _block64(seed, 0)


class OperationSeed:
    """Stateful per-op seed source: ``seeds.next()`` → a fresh 64-bit int.

    Host-side state (a plain int counter); the seeds are passed to the
    device functions as arguments.
    """

    def __init__(self, base_seed: int = 0):
        self.base_seed = int(base_seed)
        self.counter = 0

    def next(self) -> int:
        self.counter += 1
        return _block64(self.base_seed, self.counter)[0]

    def next_n(self, n: int):
        return [self.next() for _ in range(n)]

    def state(self) -> dict:
        return {"base_seed": self.base_seed, "counter": self.counter}

    @classmethod
    def from_state(cls, state: dict) -> "OperationSeed":
        obj = cls(state["base_seed"])
        obj.counter = int(state["counter"])
        return obj
