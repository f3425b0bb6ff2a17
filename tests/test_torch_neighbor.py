"""The port's N2N sub-sampler (ops/neighbor.py, ops/rng.py) against its
contract and the JAX package's plain functions.

The TPU kernel (``subsample_pair_pallas``) draws with the on-core PRNG, which
has no CPU lowering, and its stream differs from the port's Philox by design.
So the port is held to the kernel's contract: given the selector maps, the
sub-images equal JAX's ``generate_subimages`` exactly; only the 8 listed
pairs occur, each with probability 1/8; a seed gives the same draw every
time; one draw serves all channels of an image."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from image_denoising_tpu.ops.neighbor import generate_subimages as jax_generate_subimages
from image_denoising_tpu_torch.ops import rng
from image_denoising_tpu_torch.ops.neighbor import (
    generate_mask_pair,
    generate_subimages,
    subsample_pair,
    subsample_pair_fused,
)

from _torch_port_helpers import one_torch_thread  # noqa: F401

VALID_PAIRS = {(0, 1), (0, 2), (1, 3), (2, 3), (1, 0), (2, 0), (3, 1), (3, 2)}
M32 = 0xFFFFFFFF


# Random123's known answers for Philox4x32-10: (counter, key) → output
@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M32,) * 4, (M32, M32), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
])
def test_philox_known_answers(counter, key, want):
    assert rng.philox4x32_10(*counter, *key) == want
    # the int64-tensor path gives the same words
    t = [torch.tensor([c], dtype=torch.int64) for c in counter]
    assert tuple(int(w) for w in rng.philox4x32_10(*t, *key)) == want


def _philox_r(seed, cell, image):
    """The draw of one cell, from the Python-int Philox: r = word 0 mod 8."""
    return rng.philox4x32_10(cell, image, 0, 0, seed & M32, seed >> 32 & M32)[0] % 8


def test_mask_draw_follows_the_counter_layout():
    """sel maps = _POS1/_POS2[Philox(counter=(h2·W/2 + w2, n, 0, 0),
    key=(seed lo, seed hi)) word 0 mod 8], checked per cell with Python ints."""
    pos1, pos2 = (0, 0, 1, 2, 1, 2, 3, 3), (1, 2, 3, 3, 0, 0, 1, 2)
    seed = 0x0123456789ABCDEF
    sel1, sel2 = generate_mask_pair(seed, (2, 1, 6, 10), device="cpu")
    assert sel1.shape == (2, 3, 5) and sel1.dtype == torch.int32
    for n in range(2):
        for h2 in range(3):
            for w2 in range(5):
                r = _philox_r(seed, h2 * 5 + w2, n)
                assert (int(sel1[n, h2, w2]), int(sel2[n, h2, w2])) == (pos1[r], pos2[r])


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_subimages_equal_jax_generate_subimages(c, dtype):
    img = torch.from_numpy(np.random.default_rng(c).random((2, c, 12, 16), dtype=np.float32))
    img = img.to(dtype)
    sub1, sub2, (sel1, sel2) = subsample_pair(99, img)
    img_nhwc = jnp.asarray(img.float().permute(0, 2, 3, 1).numpy())
    for sub, sel in ((sub1, sel1), (sub2, sel2)):
        want = np.asarray(jax_generate_subimages(img_nhwc, jnp.asarray(sel.numpy())))
        assert sub.dtype == dtype and sub.shape == (2, c, 6, 8)
        np.testing.assert_array_equal(sub.float().permute(0, 2, 3, 1).numpy(), want)


def test_jax_drawn_selectors_gather_alike():
    """Selectors drawn by jax.random (as the step-parity test feeds them)
    gather the same sub-images in both packages."""
    import jax

    from image_denoising_tpu.ops.neighbor import generate_mask_pair as jax_mask_pair

    img = np.random.default_rng(4).random((3, 16, 8, 2), dtype=np.float32)
    s1, s2 = jax_mask_pair(jax.random.PRNGKey(5), img.shape)
    for sel in (s1, s2):
        want = np.asarray(jax_generate_subimages(jnp.asarray(img), sel))
        got = generate_subimages(torch.from_numpy(img).permute(0, 3, 1, 2),
                                 torch.from_numpy(np.array(sel)))
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_pairs_valid_and_uniform():
    """Only the 8 listed pairs, each within 0.03 of 1/8 (the TPU kernel's
    uniformity test) over 64² cells."""
    img = torch.rand(1, 1, 128, 128)
    _, _, (sel1, sel2) = subsample_pair_fused(11, img)
    pairs = list(zip(sel1.flatten().tolist(), sel2.flatten().tolist()))
    assert set(pairs) <= VALID_PAIRS
    counts = np.array([pairs.count(p) for p in sorted(VALID_PAIRS)])
    freq = counts / counts.sum()
    assert np.all(np.abs(freq - 1 / 8) < 0.03), freq


def test_deterministic_and_seed_sensitive():
    img = torch.rand(2, 1, 32, 32)
    a = subsample_pair_fused(3, img)
    b = subsample_pair_fused(3, img)
    c = subsample_pair_fused(4, img)
    for x, y in zip((a[0], a[1], *a[2]), (b[0], b[1], *b[2])):
        assert torch.equal(x, y)
    assert not torch.equal(a[2][0], c[2][0])
    # images of one batch draw independently
    assert not torch.equal(a[2][0][0], a[2][0][1])


def test_one_draw_shared_by_all_channels():
    img = torch.rand(2, 3, 16, 20)
    sub1, sub2, (sel1, sel2) = subsample_pair_fused(21, img)
    one = subsample_pair_fused(21, img[:, :1])
    assert torch.equal(one[2][0], sel1) and torch.equal(one[2][1], sel2)
    for ch in range(3):
        assert torch.equal(sub1[:, ch : ch + 1], generate_subimages(img[:, ch : ch + 1], sel1))
        assert torch.equal(sub2[:, ch : ch + 1], generate_subimages(img[:, ch : ch + 1], sel2))


def test_sub_images_take_two_distinct_cell_values():
    """Each cell's two values come from its 4 pixels, at distinct positions."""
    img = torch.arange(2 * 8 * 8, dtype=torch.float32).reshape(2, 1, 8, 8)
    sub1, sub2, (sel1, sel2) = subsample_pair_fused(8, img)
    assert torch.all(sel1 != sel2)
    rows, cols = torch.meshgrid(torch.arange(4), torch.arange(4), indexing="ij")
    for sub, sel in ((sub1, sel1), (sub2, sel2)):
        r = 2 * rows + sel.long() // 2
        c = 2 * cols + sel.long() % 2
        for n in range(2):
            assert torch.equal(sub[n, 0], img[n, 0, r[n], c[n]])


def test_wrapper_on_cpu_is_the_plain_version():
    img = torch.rand(2, 2, 10, 14)
    before = subsample_pair_fused.launches
    got = subsample_pair_fused(2 ** 63 + 5, img)
    want = subsample_pair(2 ** 63 + 5, img)
    assert subsample_pair_fused.launches == before
    for x, y in zip((got[0], got[1], *got[2]), (want[0], want[1], *want[2])):
        assert torch.equal(x, y)


@pytest.mark.parametrize("shape", [(1, 1, 7, 8), (1, 1, 8, 9), (1, 1, 0, 8)])
def test_odd_or_empty_sides_raise(shape):
    with pytest.raises(ValueError, match="even"):
        subsample_pair_fused(0, torch.zeros(shape))


def test_operation_seed_state_round_trip():
    a = rng.OperationSeed(7)
    first = a.next_n(3)
    assert len(set(first)) == 3 and all(0 <= s < 2 ** 64 for s in first)
    b = rng.OperationSeed.from_state(a.state())
    assert b.next() == a.next()
    assert rng.OperationSeed(7).next_n(3) == first
    assert rng.OperationSeed(8).next() != first[0]
    lo, hi = rng.split_seed(first[0])
    assert lo != hi and rng.split_seed(first[0]) == (lo, hi)
