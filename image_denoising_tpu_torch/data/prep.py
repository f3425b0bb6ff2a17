"""Dataset preparation tools (counterpart of ``image_denoising_tpu/data/prep.py``).

The reference's two prep scripts, as host tools with no tensor work:

* ``filter_imagenet`` — ``dataset_tool.py``: filter ILSVRC2012-val style
  folders to images within [256, 512] px on both sides and re-encode as
  max-quality RGB JPEG/PNG.
* ``crop_sidd_raw`` — ``dataset_tool_raw.py``: load SIDD Medium Raw
  ``*NOISY*.MAT`` (HDF5) mosaics, crop 512² tiles at stride 256 with
  edge-snapped last rows/cols, save each tile as ``.mat``.

PIL, ``h5py`` and ``scipy.io`` are imported inside the functions: where
``h5py`` is missing, ``crop_sidd_raw`` raises ``ImportError`` when called
and importing this module still works.
"""
from __future__ import annotations

import fnmatch
import glob
import os
from typing import List

import numpy as np

__all__ = ["filter_image_sizes", "filter_imagenet", "crop_sidd_raw"]


def filter_image_sizes(images: List[str], min_side: int = 256,
                       max_side: int = 512) -> List[str]:
    """Keep images whose width and height are within [min_side, max_side]."""
    from PIL import Image

    filtered = []
    for idx, fname in enumerate(images):
        if idx % 10000 == 0:
            print("loading images", idx, "/", len(images))
        try:
            with Image.open(fname) as img:
                w, h = img.size
                if (w > max_side or h > max_side) or (w < min_side or h < min_side):
                    continue
                filtered.append(fname)
        except Exception:
            print("Could not load image", fname, "skipping file..")
    return filtered


def filter_imagenet(input_dir: str, save_dir: str, min_side: int = 256,
                    max_side: int = 512) -> int:
    """Filter + re-encode (RGB, quality 100, no chroma subsampling)."""
    from PIL import Image

    pattern = os.path.join(input_dir, "**/*")
    all_fnames = glob.glob(pattern, recursive=True)
    images = sorted(
        f for f in all_fnames
        if any(fnmatch.fnmatch(f, p) for p in ("*.JPEG", "*.jpg", "*.png"))
    )
    filtered = filter_image_sizes(images, min_side, max_side)
    print(len(filtered))

    os.makedirs(save_dir, exist_ok=True)
    for idx, img_path in enumerate(filtered):
        if idx % 1000 == 0:
            print("loading and saving images", idx, "/", len(filtered))
        img = Image.open(img_path).convert("RGB")
        img.save(os.path.join(save_dir, os.path.basename(img_path)),
                 quality=100, subsampling=0)
    return len(filtered)


def crop_sidd_raw(data_dir: str, save_folder: str, crop_size: int = 512,
                  step: int = 256, overwrite: bool = True) -> int:
    """Crop SIDD Medium Raw NOISY mosaics into .mat tiles (edge-snapped grid)."""
    import h5py
    from scipy.io import savemat

    paths = sorted(glob.glob(os.path.join(data_dir, "**/*NOISY*.MAT"),
                             recursive=True))
    print(f"Number of big images: {len(paths)}")

    if overwrite and os.path.exists(save_folder):
        import shutil

        shutil.rmtree(save_folder)
    os.makedirs(save_folder, exist_ok=True)

    n_tiles = 0
    for path in paths:
        img_name, extension = os.path.splitext(os.path.basename(path))
        print(img_name)
        with h5py.File(path, "r") as mat:
            im = np.asarray(mat["x"])
        h, w = im.shape
        h_space = np.arange(0, h - crop_size + 1, step)
        if h - (h_space[-1] + crop_size) > 0:
            h_space = np.append(h_space, h - crop_size)
        w_space = np.arange(0, w - crop_size + 1, step)
        if w - (w_space[-1] + crop_size) > 0:
            w_space = np.append(w_space, w - crop_size)
        index = 0
        for x in h_space:
            for y in w_space:
                index += 1
                tile = np.ascontiguousarray(im[x:x + crop_size, y:y + crop_size])
                savemat(
                    os.path.join(
                        save_folder,
                        "{}_s{:0>3d}{}".format(img_name, index, extension.lower()),
                    ),
                    {"x": tile},
                )
        n_tiles += index
    return n_tiles
