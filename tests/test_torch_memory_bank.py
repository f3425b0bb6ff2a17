"""The port's memory bank (memory/bank.py) against the JAX package's, array
for array and to the bit, for every bank and clean-store dtype, with and
without padding."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from image_denoising_tpu.memory import bank as jax_bank
from image_denoising_tpu_torch.memory import bank as port_bank

from _torch_port_helpers import one_torch_thread  # noqa: F401

PS, STRIDE = 16, 8


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """2 uint8 pairs of 40x48 PNGs (4 x 5 patches each at stride 8) and a
    16-bit pair whose values are not byte-exact."""
    from PIL import Image

    root = tmp_path_factory.mktemp("bank")
    rng = np.random.default_rng(5)
    paths = {"clean": [], "noise": []}
    for i in range(2):
        for kind in paths:
            p = str(root / f"{kind}{i}.png")
            Image.fromarray(rng.integers(0, 256, (40, 48)).astype(np.uint8)).save(p)
            paths[kind].append(p)
    p16 = str(root / "deep.png")
    Image.fromarray(rng.integers(0, 65536, (40, 48)).astype(np.uint16)).save(p16)
    return paths["clean"], paths["noise"], p16


def _np(x):
    """A JAX or torch array as numpy; bfloat16 as float32 (exact)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


@pytest.mark.parametrize("pad_to", [0, 32])
@pytest.mark.parametrize("clean_dtype", ["float32", "uint8"])
@pytest.mark.parametrize("bank_dtype", ["float32", "bfloat16", "int8"])
def test_bank_matches_jax(pairs, bank_dtype, clean_dtype, pad_to):
    clean, noise, _ = pairs
    kw = dict(bank_dtype=bank_dtype, pad_to=pad_to, clean_dtype=clean_dtype)
    want = jax_bank.build_memory_bank(clean, noise, PS, STRIDE, **kw)
    got = port_bank.build_memory_bank(clean, noise, PS, STRIDE, device="cpu", **kw)
    assert got.size == want.size == (64 if pad_to else 40)
    assert (got.patch_size, got.stride) == (PS, STRIDE)
    for name in ("noise_flat", "clean", "sq_norms"):
        a, b = getattr(got, name), getattr(want, name)
        assert str(a.dtype).split(".")[-1] == str(np.asarray(b).dtype), name
        assert tuple(a.shape) == np.asarray(b).shape, name
        np.testing.assert_array_equal(_np(a), _np(b), err_msg=name)


def test_byte_path_equals_float_route(pairs):
    """int8 + uint8 banks come straight from the bytes; the float route
    (int8 + float32 clean, float32 + uint8 clean) gives the same arrays."""
    clean, noise, _ = pairs
    build = lambda b, c: port_bank.build_memory_bank(  # noqa: E731
        clean, noise, PS, STRIDE, bank_dtype=b, clean_dtype=c, device="cpu")
    direct = build("int8", "uint8")
    via_float = build("int8", "float32")
    np.testing.assert_array_equal(direct.noise_flat.numpy(), via_float.noise_flat.numpy())
    np.testing.assert_array_equal(direct.sq_norms.numpy(), via_float.sq_norms.numpy())
    np.testing.assert_array_equal(direct.clean.numpy(), build("float32", "uint8").clean.numpy())


@pytest.mark.parametrize("shape", [(24, 20), (24, 20, 3)])
def test_extract_patches_matches_jax(shape):
    img = np.random.default_rng(1).random(shape, dtype=np.float32)
    want = jax_bank.extract_patches(img, 8, 3)
    got = port_bank.extract_patches(img, 8, 3)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bank_dtype,clean_dtype,match", [
    ("int8", "float32", "--bank_dtype int8 requires uint8-exact noise"),
    ("float32", "uint8", "--clean_bank_dtype uint8 requires uint8-exact clean"),
])
def test_non_byte_exact_frames_refused(pairs, bank_dtype, clean_dtype, match):
    clean, noise, deep = pairs
    kw = dict(bank_dtype=bank_dtype, clean_dtype=clean_dtype)
    for build, extra in ((jax_bank.build_memory_bank, {}),
                         (port_bank.build_memory_bank, {"device": "cpu"})):
        with pytest.raises(ValueError, match=match):
            build([deep], [deep], PS, STRIDE, **kw, **extra)
    # 16-bit frames still build float banks
    got = port_bank.build_memory_bank([deep], [deep], PS, STRIDE, device="cpu")
    assert got.size == 20
