"""The port's top-1 retrieval (memory/retrieval.py, plain path on the CPU)
and patch selection (adapters/wrappers.py) against the JAX package: the
Pallas kernel in interpret mode, and ``select_memory_patch`` /
``batched_select_memory_patch``."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

import image_denoising_tpu.memory.retrieval_pallas as jax_rp
from image_denoising_tpu.adapters import wrappers as jax_wrappers
from image_denoising_tpu_torch.adapters import (batched_select_memory_patch,
                                                select_memory_patch)
from image_denoising_tpu_torch.memory import bank as port_bank
from image_denoising_tpu_torch.memory.retrieval import (
    pad_bank_for_retrieval, top1_l2_retrieval, top1_l2_retrieval_reference)

from _torch_port_helpers import one_torch_thread  # noqa: F401

B, N, D = 9, 100, 256   # N is a multiple of no tile the kernels use
TILE_N, TILE_D = 32, 64


def _jax_top1(q, bank, sqn):
    """The Pallas kernel in interpret mode, on the bank padded to TILE_N."""
    bank_j, sqn_j = jax_rp.pad_bank_for_retrieval(
        jnp.asarray(bank), jnp.asarray(sqn), tile_n=TILE_N)
    orig = pl.pallas_call

    def interpret(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    pl.pallas_call = interpret
    try:
        idx = jax_rp.top1_l2_retrieval(jnp.asarray(q), bank_j, sqn_j,
                                       tile_n=TILE_N, tile_d=TILE_D)
    finally:
        pl.pallas_call = orig
    return np.asarray(idx)


def _case(regime, data, seed=0):
    """(queries, bank, sq_norms) as numpy. 'noisy': random rows, queries are
    rows plus small noise. 'exact': dyadic values (k/8, or small ints), so
    every distance is exact in float32 and bfloat16 and ties are real; row
    70 duplicates row 10 and two queries sit on it, so the first must win."""
    rng = np.random.default_rng(seed)
    if regime == "int8":
        lim = 128 if data == "noisy" else 4
        bank = rng.integers(-lim, lim, (N, D)).astype(np.int8)
    elif data == "noisy":
        bank = rng.random((N, D), dtype=np.float32)
    else:
        bank = rng.integers(0, 9, (N, D)).astype(np.float32) / 8
    bank[70] = bank[10]
    picks = np.r_[10, 70, rng.integers(0, N, B - 2)]
    q = bank[picks].astype(np.float32)
    if data == "noisy":
        scale = 3.0 if regime == "int8" else 0.01
        q = q + rng.normal(0, scale, q.shape).astype(np.float32)
        q[:2] = bank[10]
    if regime == "int8":
        q = np.clip(np.round(q), -128, 127).astype(np.int8)
        bi = bank.astype(np.int64)
        sqn = (bi * bi).sum(1).astype(np.int32)
    else:
        b32 = bank.astype(jnp.bfloat16).astype(np.float32) if regime == "bfloat16" else bank
        sqn = np.sum(b32.astype(np.float32) ** 2, axis=1)
        if regime == "bfloat16":
            bank = bank.astype(jnp.bfloat16)
    return q, bank, sqn


def _torch(a):
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("data", ["noisy", "exact"])
@pytest.mark.parametrize("regime", ["float32", "bfloat16", "int8"])
def test_top1_matches_jax_pallas_interpret(regime, data):
    q, bank, sqn = _case(regime, data)
    want = _jax_top1(q, bank, sqn)
    assert want[0] == want[1] == 10  # the duplicate row 70 never wins
    qt, bt, st = _torch(q), _torch(bank), _torch(sqn)
    got = top1_l2_retrieval(qt, bt, st)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B,)
    np.testing.assert_array_equal(got.numpy(), want)
    # padded to the TPU tile: padded rows (worst norms) never win
    bp, sp = pad_bank_for_retrieval(bt, st, tile_n=TILE_N)
    assert bp.shape[0] == 128 and sp[-1].item() == (
        float("inf") if regime != "int8" else np.iinfo(np.int32).max)
    np.testing.assert_array_equal(top1_l2_retrieval(qt, bp, sp).numpy(), want)


def test_top1_reference_int8_chunks_and_refusals():
    q, bank, sqn = _case("int8", "noisy", seed=4)
    args = _torch(q), _torch(bank), _torch(sqn)
    np.testing.assert_array_equal(
        top1_l2_retrieval_reference(*args, chunk=7).numpy(),
        top1_l2_retrieval_reference(*args).numpy())
    with pytest.raises(TypeError, match="centered-int8 queries"):
        top1_l2_retrieval(args[0].float(), args[1], args[2])
    with pytest.raises(TypeError, match="int32 sq_norms"):
        top1_l2_retrieval(args[0], args[1], args[2].float())
    with pytest.raises(ValueError, match="multiple of 16"):
        top1_l2_retrieval(args[0][:, :40], args[1][:, :40], args[2])
    with pytest.raises(TypeError, match="float32, bfloat16 or int8"):
        top1_l2_retrieval(args[0].float(), args[1].double(), args[2].float())


def _patch_bank(rng, bank_dtype, clean_dtype, ps=16, stride=8):
    """A bank from 2 uint8 frame pairs, built by the port (its arrays
    equal JAX's: test_torch_memory_bank.py), and 13 query tiles of the noisy
    frames: 5 on the bank grid, 8 off it. Returns (bank, tiles, the bank
    index of each on-grid tile)."""
    frames = [(rng.integers(0, 256, (40, 48)).astype(np.uint8),
               rng.integers(0, 256, (40, 48)).astype(np.uint8)) for _ in range(2)]
    bank = port_bank.build_memory_bank_from_frames(
        [c for c, _ in frames], [n for _, n in frames], ps, stride,
        bank_dtype=bank_dtype, clean_dtype=clean_dtype, device="cpu")
    tiles, own = [], []
    for k in range(13):
        f = k % 2
        if k < 5:  # grid of 4 x 5 positions per frame
            r, c = 8 * (k % 4), 8 * k
            own.append(f * 20 + (r // 8) * 5 + c // 8)
        else:
            r, c = rng.integers(0, 25, 2)
        tiles.append(frames[f][1][r : r + ps, c : c + ps])
    tiles = (np.stack(tiles)[..., None].astype(np.float32) / 255.0).astype(np.float32)
    return bank, tiles, own


@pytest.mark.parametrize("bank_dtype,clean_dtype",
                         [("float32", "float32"), ("int8", "uint8"),
                          ("int8", "float32"), ("float32", "uint8")])
def test_select_memory_patch_matches_jax(bank_dtype, clean_dtype):
    rng = np.random.default_rng(11)
    bank, tiles, own = _patch_bank(rng, bank_dtype, clean_dtype)
    np_bank = (bank.noise_flat.numpy(), bank.clean.numpy(), bank.sq_norms.numpy())
    jbank = tuple(jnp.asarray(a) for a in np_bank)
    want = np.asarray(jax_wrappers.select_memory_patch(jnp.asarray(tiles), *jbank))
    got = select_memory_patch(torch.from_numpy(tiles), bank.noise_flat,
                              bank.clean, bank.sq_norms)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    clean01 = bank.clean.float() / (255.0 if clean_dtype == "uint8" else 1.0)
    np.testing.assert_allclose(got[:5].numpy(), clean01[own].numpy(), atol=1e-7)
    # the norms are optional: computed from the bank when absent
    np.testing.assert_array_equal(
        select_memory_patch(torch.from_numpy(tiles), bank.noise_flat,
                            bank.clean).numpy(), want)
    # hoisted pass in chunks of 4 queries: 13 tiles leave a zero-padded tail
    want_b = np.asarray(jax_wrappers.batched_select_memory_patch(
        jnp.asarray(tiles), *jbank, chunk=4))
    got_b = batched_select_memory_patch(torch.from_numpy(tiles), bank.noise_flat,
                                        bank.clean, bank.sq_norms, chunk=4)
    np.testing.assert_array_equal(got_b.numpy(), want_b)
    np.testing.assert_array_equal(got_b.numpy(), want)
