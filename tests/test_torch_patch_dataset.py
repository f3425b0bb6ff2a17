"""The port's finetune patch stream (data/pairs.py::DenoisePatchDataset)
against the JAX package's: at their defaults (the native sampler on
uint8-exact frames), on the numpy stream (``use_native=False``) and on
16-bit frames (the numpy stream in both), the same patches in the same
batch order from one seeded generator, the tail batch included, over two
epochs; and the ``limit=`` of ``list_pairs`` and ``validation_denoise``."""
import numpy as np
import pytest

from image_denoising_tpu.data import DenoisePatchDataset as JaxPatchDataset
from image_denoising_tpu_torch.data import (DenoisePatchDataset, list_pairs,
                                            validation_denoise)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("patches")
    rng = np.random.default_rng(8)
    for sub in ("clean", "noise"):
        (root / sub).mkdir()
    for i in range(7):  # more than the 5 the finetuners use
        h, w = 48 + 8 * (i % 3), 56
        clean = rng.integers(0, 256, (h, w)).astype(np.uint8)
        noisy = np.clip(clean + rng.normal(0, 20, clean.shape), 0, 255).astype(np.uint8)
        Image.fromarray(clean).save(root / "clean" / f"s{i:02d}.png")
        Image.fromarray(noisy).save(root / "noise" / f"s{i:02d}.png")
    return str(root)


@pytest.mark.parametrize("batch", [4, 3])
def test_patches_equal_jax_numpy_stream(data_dir, batch):
    """5 images × 3 patches of 32² = 15 samples: batches of 4 leave a tail
    of 3, batches of 3 none."""
    port = DenoisePatchDataset(data_dir, patch_size=32, patches_per_image=3,
                               use_native=False)
    ref = JaxPatchDataset(data_dir, patch_size=32, patches_per_image=3, use_native=False)
    assert port.native is None and len(port) == len(ref) == 15
    rng_p, rng_j = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(2):
        got = list(port.batches(batch, rng_p))
        want = list(ref.batches(batch, rng_j))
        assert [c.shape[0] for c, _ in got] == [c.shape[0] for c, _ in want]
        assert sum(c.shape[0] for c, _ in got) == 15
        for (gc, gn), (wc, wn) in zip(got, want):
            assert gc.dtype == gn.dtype == np.float32 and gc.shape[1:] == (32, 32, 1)
            np.testing.assert_array_equal(gc, wc)
            np.testing.assert_array_equal(gn, wn)
    # the generators stand at the same point of their streams
    assert rng_p.integers(0, 2 ** 62) == rng_j.integers(0, 2 ** 62)
    # drop_last drops the tail as JAX does
    assert len(list(port.batches(4, np.random.default_rng(0), drop_last=True))) == 3


def _same_epochs(port, ref, batch, drop_last, n_items, epochs=2, seed=5):
    rng_p, rng_j = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(epochs):
        got = list(port.batches(batch, rng_p, drop_last=drop_last))
        want = list(ref.batches(batch, rng_j, drop_last=drop_last))
        assert [c.shape[0] for c, _ in got] == [c.shape[0] for c, _ in want]
        assert sum(c.shape[0] for c, _ in got) == n_items
        for (gc, gn), (wc, wn) in zip(got, want):
            assert gc.dtype == gn.dtype == np.float32
            np.testing.assert_array_equal(gc, wc)
            np.testing.assert_array_equal(gn, wn)
    assert rng_p.integers(0, 2 ** 62) == rng_j.integers(0, 2 ** 62)


@pytest.mark.parametrize("batch,drop_last,n_items", [(4, False, 15), (4, True, 12),
                                                     (3, False, 15)])
def test_default_stream_equals_jax_default(data_dir, batch, drop_last, n_items):
    """Both packages at their defaults crop with the native sampler (the
    frames are uint8), keyed by one batch seed an epoch: equal batches,
    with a tail of 3 at batch 4 unless ``drop_last``."""
    port = DenoisePatchDataset(data_dir, patch_size=32, patches_per_image=3)
    ref = JaxPatchDataset(data_dir, patch_size=32, patches_per_image=3)
    assert port.native is not None and ref._native is not None
    _same_epochs(port, ref, batch, drop_last, n_items)


def test_16bit_frames_take_the_numpy_stream_in_both(tmp_path, capsys):
    """16-bit PNG frames are not uint8-exact: both packages say so and
    draw the numpy stream, with sub-8-bit values kept."""
    from PIL import Image

    rng = np.random.default_rng(12)
    for sub in ("clean", "noise"):
        (tmp_path / sub).mkdir()
        for i in range(3):
            arr = rng.integers(0, 65536, (40, 44), dtype=np.uint16)
            Image.fromarray(arr).save(tmp_path / sub / f"f{i}.png")
    port = DenoisePatchDataset(str(tmp_path), patch_size=16, patches_per_image=3)
    port_out = capsys.readouterr().out
    ref = JaxPatchDataset(str(tmp_path), patch_size=16, patches_per_image=3)
    assert port.native is None and ref._native is None
    msg = "frames not uint8-exact (high-bit-depth input): using the numpy sampler"
    assert msg in port_out and msg in capsys.readouterr().out
    _same_epochs(port, ref, 4, False, 9)
    clean, _ = next(port.batches(4, np.random.default_rng(0)))
    assert not np.allclose(clean * 255.0, np.round(clean * 255.0))


def test_limit(data_dir):
    clean, noise = list_pairs(data_dir)
    assert len(clean) == len(noise) == 7
    assert list_pairs(data_dir, limit=5) == (clean[:5], noise[:5])
    c, n, cp, np_ = validation_denoise(data_dir, limit=2)
    assert (len(c), len(n), cp, np_) == (2, 2, clean[:2], noise[:2])
    assert c[0].dtype == np.float32 and c[0].shape == (48, 56)
