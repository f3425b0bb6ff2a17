"""The port's finetune patch stream (data/pairs.py::DenoisePatchDataset)
against the JAX package's numpy sampler: the same patches in the same batch
order from one seeded generator, the tail batch included, over two epochs;
and the ``limit=`` of ``list_pairs`` and ``validation_denoise``."""
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
    port = DenoisePatchDataset(data_dir, patch_size=32, patches_per_image=3)
    ref = JaxPatchDataset(data_dir, patch_size=32, patches_per_image=3, use_native=False)
    assert len(port) == len(ref) == 15
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


def test_limit(data_dir):
    clean, noise = list_pairs(data_dir)
    assert len(clean) == len(noise) == 7
    assert list_pairs(data_dir, limit=5) == (clean[:5], noise[:5])
    c, n, cp, np_ = validation_denoise(data_dir, limit=2)
    assert (len(c), len(n), cp, np_) == (2, 2, clean[:2], noise[:2])
    assert c[0].dtype == np.float32 and c[0].shape == (48, 56)
