"""The port's full-frame pairs (data/pairs.py: ``load_image_f32`` and
``DenoiseDataset`` with ``convert_l=`` and ``cache=``) against the JAX
package's, on RGB, 8-bit grayscale and 16-bit grayscale frames: the same
float32 arrays and the same shuffled batches."""
import numpy as np
import pytest

from image_denoising_tpu.data import DenoiseDataset as JaxDenoiseDataset
from image_denoising_tpu.data import load_image_f32 as jax_load_image_f32
from image_denoising_tpu_torch.data import DenoiseDataset, load_image_f32

MODES = ("RGB", "L", "I;16")


def _frame(rng, mode, h=24, w=32):
    from PIL import Image

    if mode == "RGB":
        return Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(np.uint8), "RGB")
    if mode == "L":
        return Image.fromarray(rng.integers(0, 256, (h, w)).astype(np.uint8), "L")
    return Image.fromarray(rng.integers(0, 65536, (h, w)).astype(np.uint16), "I;16")


@pytest.fixture(scope="module")
def data_dirs(tmp_path_factory):
    """One clean/noise pair directory per mode, 5 pairs each."""
    rng = np.random.default_rng(14)
    dirs = {}
    for mode in MODES:
        root = tmp_path_factory.mktemp(mode.replace(";", ""))
        for sub in ("clean", "noise"):
            (root / sub).mkdir()
            for i in range(5):
                _frame(rng, mode).save(root / sub / f"f{i}.png")
        dirs[mode] = str(root)
    return dirs


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("convert_l", [False, True])
def test_load_image_f32_equals_jax(data_dirs, mode, convert_l):
    path = f"{data_dirs[mode]}/clean/f0.png"
    got = load_image_f32(path, convert_l=convert_l)
    want = jax_load_image_f32(path, convert_l=convert_l)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # RGB becomes one channel under convert_l; 16-bit keeps its depth
    assert got.ndim == (3 if mode == "RGB" and not convert_l else 2)
    if mode == "I;16":
        assert not np.array_equal(got, np.round(got))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("cache", [True, False])
def test_denoise_dataset_convert_l_equals_jax(data_dirs, mode, cache):
    port = DenoiseDataset(data_dirs[mode], convert_l=True, cache=cache)
    ref = JaxDenoiseDataset(data_dirs[mode], convert_l=True, cache=cache)
    assert len(port) == len(ref) == 5
    for i in range(len(ref)):
        for g, w in zip(port.get(i), ref.get(i)):
            assert g.shape == w.shape and g.shape[-1] == 1
            np.testing.assert_array_equal(g, w)
    rng_p, rng_j = np.random.default_rng(3), np.random.default_rng(3)
    got = list(port.batches(2, rng_p, shuffle=True, drop_last=False))
    want = list(ref.batches(2, rng_j, shuffle=True, drop_last=False))
    assert len(got) == len(want) == 3  # a tail batch of 1
    for (gc, gn), (wc, wn) in zip(got, want):
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gn, wn)


def test_denoise_dataset_defaults_keep_the_frames(data_dirs):
    """The trainers' default (no convert_l, cached) keeps RGB frames as
    three channels, as before."""
    port = DenoiseDataset(data_dirs["RGB"])
    assert port.get(0)[0].shape == (24, 32, 3)
    np.testing.assert_array_equal(port.get(0)[0],
                                  JaxDenoiseDataset(data_dirs["RGB"]).get(0)[0])
