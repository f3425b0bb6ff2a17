"""The port's native patch sampler (data/native_sampler.py over its own
csrc/patch_sampler.cpp) against the JAX package's (native/patch_sampler.cpp,
built by native/'s make) and against the port's numpy version: bit-equal
crops on the same frames, seed, batch index and image map, for any thread
count; clean and noisy crops from one window; bad input raises."""
import numpy as np
import pytest

from image_denoising_tpu.data.native_sampler import NativePatchSampler as JaxSampler
from image_denoising_tpu.data.native_sampler import load_library as jax_load_library
from image_denoising_tpu_torch.data.native_sampler import (NativePatchSampler,
                                                           load_library, sample_plain)

SEEDS = (0, 2 ** 63 - 2)


def _frames(c, h, w, n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (h, w, c)).astype(np.uint8),
             rng.integers(0, 256, (h, w, c)).astype(np.uint8)) for _ in range(n)]


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


@pytest.mark.parametrize("c,h,w,patch", [(1, 40, 48, 16), (3, 36, 52, 20),
                                         (1, 32, 32, 32), (3, 24, 24, 24)])
@pytest.mark.parametrize("seed", SEEDS)
def test_bit_equal_to_jax_and_to_the_plain_version(c, h, w, patch, seed):
    """C = 1 and 3, a patch smaller than and equal to the frame's side."""
    assert jax_load_library() is not None, "the JAX package's sampler did not build"
    frames = _frames(c, h, w, seed=c + patch)
    port, ref = NativePatchSampler(frames, n_threads=3), JaxSampler(frames, n_threads=3)
    img_of_item = np.array([0, 2, 1, 1, 0, 2, 2], np.int32)
    for batch_index in (0, 5, 2 ** 40 + 3):
        got = port.sample(seed, batch_index, img_of_item, patch)
        want = ref.sample(seed, batch_index, img_of_item, patch)
        plain = sample_plain(frames, seed, batch_index, img_of_item, patch)
        for g, wt, p in zip(got, want, plain):
            assert g.dtype == np.float32 and g.shape == (7, patch, patch, c)
            np.testing.assert_array_equal(_bits(g), _bits(wt))
            np.testing.assert_array_equal(_bits(g), _bits(p))


def test_thread_count_does_not_change_the_batch():
    frames = _frames(1, 48, 40, n=4, seed=3)
    img_of_item = np.arange(13, dtype=np.int32) % 4
    runs = [NativePatchSampler(frames, n_threads=t).sample(11, 4, img_of_item, 17)
            for t in (1, 3, 8)]
    for clean, noisy in runs[1:]:
        np.testing.assert_array_equal(_bits(clean), _bits(runs[0][0]))
        np.testing.assert_array_equal(_bits(noisy), _bits(runs[0][1]))


def test_clean_and_noisy_crops_are_aligned():
    """Noisy = clean + 10 everywhere below saturation: every crop pair
    differs by exactly 10/255 there, so both come from one window."""
    base = np.random.default_rng(4).integers(0, 200, (64, 64, 1)).astype(np.uint8)
    s = NativePatchSampler([(base, base + 10)])
    clean, noisy = s.sample(1, 0, np.zeros(6, np.int32), 24)
    np.testing.assert_allclose(noisy - clean, 10 / 255.0, atol=1e-6)
    # and the window is one of the frame's
    top_left = [(t, l) for t in range(41) for l in range(41)
                if np.array_equal(np.round(clean[0, ..., 0] * 255).astype(np.uint8),
                                  base[t:t + 24, l:l + 24, 0])]
    assert top_left


@pytest.mark.parametrize("img_of_item,patch,code", [([0, 3], 8, -2), ([-1], 8, -2),
                                                    ([0, 1], 33, -3), ([], 8, -1),
                                                    ([0], 0, -1)])
def test_bad_input_raises(img_of_item, patch, code):
    """An index outside the frames, a patch larger than its frame, an empty
    batch or an empty patch: the library and the plain version raise the
    library's return code."""
    frames = _frames(1, 32, 40, n=2)
    s = NativePatchSampler(frames)
    for fn in (s.sample, lambda *a: sample_plain(frames, *a)):
        with pytest.raises(RuntimeError, match=f"ps_sample_batch failed: {code}"):
            fn(0, 0, np.asarray(img_of_item, np.int32), patch)


def test_pairs_of_other_shapes_are_refused():
    frames = _frames(1, 32, 32, n=1)
    with pytest.raises(ValueError, match="one shape"):
        NativePatchSampler([(frames[0][0], frames[0][1][:16])])
    with pytest.raises(ValueError, match="one shape"):
        NativePatchSampler(frames + _frames(3, 32, 32, n=1))


def test_a_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    """No silent fallback: a compiler that fails makes ``load_library``
    raise with its output, where JAX's prints and returns None."""
    from image_denoising_tpu_torch.ops import _build

    bad = tmp_path / "g++"
    bad.write_text("#!/bin/sh\necho no compiler here >&2\nexit 3\n")
    bad.chmod(0o755)
    monkeypatch.setenv("CXX", str(bad))
    monkeypatch.setattr(_build, "HOST_BUILD_DIR", tmp_path / "host")
    _build.load_patch_sampler.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="no compiler here"):
            load_library()
        with pytest.raises(RuntimeError, match="no compiler here"):
            NativePatchSampler(_frames(1, 16, 16, n=1))
    finally:
        _build.load_patch_sampler.cache_clear()
