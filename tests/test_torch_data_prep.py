"""The port's dataset tools (data/prep.py, cli/dataset_tool.py,
cli/dataset_tool_raw.py) against the JAX package's on synthetic files (the
cases of tests/test_data_prep.py): the same kept lists and prints, byte-equal
re-encoded images, the same tile names and values from an h5py-written
``*NOISY*.MAT``, the same return values, and parsers with equal flags and
defaults."""
import argparse
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from image_denoising_tpu.cli import dataset_tool as jax_tool
from image_denoising_tpu.cli import dataset_tool_raw as jax_tool_raw
from image_denoising_tpu.data import prep as jax_prep
from image_denoising_tpu_torch.cli import dataset_tool, dataset_tool_raw
from image_denoising_tpu_torch.data import prep

REPO = Path(__file__).resolve().parents[1]


def _images(root):
    """Kept and dropped sizes at a bound of [64, 128], modes L and RGB, PNG
    and both JPEG spellings, one level of sub-folders and a corrupt file."""
    from PIL import Image

    rng = np.random.default_rng(21)
    sizes = {"a/keep_min.png": (64, 64, "L"), "a/keep_max.JPEG": (128, 128, "RGB"),
             "b/keep_rect.jpg": (64, 128, "L"), "b/too_small.png": (63, 64, "L"),
             "too_big.png": (129, 64, "RGB"), "keep_rgb.png": (96, 80, "RGB"),
             "ignored.bmp": (64, 64, "L")}
    for name, (w, h, mode) in sizes.items():
        shape = (h, w) if mode == "L" else (h, w, 3)
        path = root / name
        path.parent.mkdir(parents=True, exist_ok=True)
        fmt = "JPEG" if name.lower().endswith(("jpeg", "jpg")) else None
        Image.fromarray(rng.integers(0, 256, shape).astype(np.uint8)).save(path, format=fmt)
    (root / "a" / "corrupt.png").write_bytes(b"not an image")
    return root


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(Path(d).iterdir())}


def test_filter_image_sizes_equals_jax(tmp_path, capsys):
    root = _images(tmp_path / "src")
    paths = sorted(str(p) for p in root.rglob("*") if p.is_file())
    got = prep.filter_image_sizes(paths, min_side=64, max_side=128)
    said = capsys.readouterr().out
    want = jax_prep.filter_image_sizes(paths, min_side=64, max_side=128)
    assert got == want and said == capsys.readouterr().out
    assert sorted(os.path.basename(p) for p in got) == [
        "ignored.bmp", "keep_max.JPEG", "keep_min.png", "keep_rect.jpg", "keep_rgb.png"]
    assert "Could not load image" in said


def test_filter_imagenet_equals_jax(tmp_path, capsys):
    """Only ``*.JPEG``/``*.jpg``/``*.png`` within the bounds, re-encoded as
    RGB at quality 100 without chroma subsampling: the same bytes."""
    root = _images(tmp_path / "src")
    got = prep.filter_imagenet(str(root), str(tmp_path / "port"), 64, 128)
    said = capsys.readouterr().out
    want = jax_prep.filter_imagenet(str(root), str(tmp_path / "jax"), 64, 128)
    assert got == want == 4 and said == capsys.readouterr().out
    port, ref = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(port) == ["keep_max.JPEG", "keep_min.png", "keep_rect.jpg",
                            "keep_rgb.png"]
    assert port == ref


def _raw(root, shapes):
    import h5py

    rng = np.random.default_rng(22)
    frames = {}
    for i, (sub, shape) in enumerate(shapes):
        (root / sub).mkdir(parents=True, exist_ok=True)
        name = root / sub / f"{i:04d}_NOISY_RAW_010.MAT"
        frames[name.stem] = rng.random(shape)
        with h5py.File(name, "w") as f:
            f.create_dataset("x", data=frames[name.stem])
        with h5py.File(root / sub / f"{i:04d}_GT_RAW_010.MAT", "w") as f:
            f.create_dataset("x", data=np.zeros(shape))  # not NOISY: not cropped
    return frames


def _tiles(d):
    from scipy.io import loadmat

    return {n: loadmat(os.path.join(d, n))["x"] for n in sorted(os.listdir(d))}


@pytest.mark.parametrize("crop,step", [(64, 32), (48, 48)])
def test_crop_sidd_raw_equals_jax(tmp_path, capsys, crop, step):
    """The edge-snapped grid (80 × 112 at 64/32: rows 0, 16; columns 0,
    32, 48), ``{name}_s{index:03d}`` with the lower-cased extension; a
    second run empties the folder first."""
    frames = _raw(tmp_path / "raw", [("s1", (80, 112)), ("s2/deeper", (96, 96))])
    got = prep.crop_sidd_raw(str(tmp_path / "raw"), str(tmp_path / "port"), crop, step)
    said = capsys.readouterr().out
    want = jax_prep.crop_sidd_raw(str(tmp_path / "raw"), str(tmp_path / "jax"), crop, step)
    assert got == want and said == capsys.readouterr().out
    port, ref = _tiles(tmp_path / "port"), _tiles(tmp_path / "jax")
    assert sorted(port) == sorted(ref) and len(port) == got
    for name in port:
        np.testing.assert_array_equal(port[name], ref[name])
    if (crop, step) == (64, 32):
        assert got == 2 * 3 + 2 * 2
        np.testing.assert_array_equal(port["0000_NOISY_RAW_010_s006.mat"],
                                      frames["0000_NOISY_RAW_010"][16:80, 48:112])
    assert prep.crop_sidd_raw(str(tmp_path / "raw"), str(tmp_path / "port"), crop,
                              step) == got
    assert len(os.listdir(tmp_path / "port")) == got


def test_dataset_tool_clis_equal_jax(tmp_path, capsys):
    root = _images(tmp_path / "src")
    common = ["--input_dir", str(root), "--min_side", "64", "--max_side", "128"]
    got = dataset_tool.main(common + ["--save_dir", str(tmp_path / "port")])
    want = jax_tool.main(common + ["--save_dir", str(tmp_path / "jax")])
    assert got == want == 4
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    _raw(tmp_path / "raw", [("s1", (80, 112))])
    common = ["--data_dir", str(tmp_path / "raw"), "--crop_size", "64", "--step", "32"]
    got = dataset_tool_raw.main(common + ["--save_folder", str(tmp_path / "tp")])
    want = jax_tool_raw.main(common + ["--save_folder", str(tmp_path / "tj")])
    assert got == want == 6
    assert sorted(os.listdir(tmp_path / "tp")) == sorted(os.listdir(tmp_path / "tj"))


class _Parsed(Exception):
    pass


def _parser_of(main, monkeypatch):
    """(flag, default, type, required) of every option ``main`` parses."""
    got = {}

    def fake(self, args=None, namespace=None):
        got["opts"] = sorted((a.option_strings[0], a.default, a.type, a.required)
                             for a in self._actions if a.option_strings)
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", fake)
    with pytest.raises(_Parsed):
        main([])
    return got["opts"]


@pytest.mark.parametrize("port,ref", [(dataset_tool, jax_tool),
                                      (dataset_tool_raw, jax_tool_raw)])
def test_parsers_equal_jax(monkeypatch, port, ref):
    """The same flags and defaults, and no ``--device``: host tools."""
    got, want = _parser_of(port.main, monkeypatch), _parser_of(ref.main, monkeypatch)
    assert got == want
    assert "--device" not in [flag for flag, *_ in got]


def test_crop_sidd_raw_without_h5py(tmp_path):
    """Where h5py is missing the module and the CLI still import, and
    ``crop_sidd_raw`` raises ImportError when called."""
    code = textwrap.dedent(f"""
        import sys
        sys.modules["h5py"] = None
        from image_denoising_tpu_torch.cli import dataset_tool_raw
        from image_denoising_tpu_torch.data import prep
        try:
            prep.crop_sidd_raw({str(tmp_path)!r}, {str(tmp_path / "out")!r})
        except ImportError:
            print("ImportError")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ImportError"
