"""ImageNet prep CLI (counterpart of ``image_denoising_tpu/cli/dataset_tool.py``,
reference ``dataset_tool.py``): a host tool, so it takes no ``--device``.

Run: ``python -m image_denoising_tpu_torch.cli.dataset_tool --input_dir d
--save_dir out``; ``main`` returns the number of images kept.
"""
from __future__ import annotations

import argparse

from ..data.prep import filter_imagenet


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_dir", type=str, default="./ILSVRC2012_img_val")
    parser.add_argument("--save_dir", type=str, default="./Imagenet_val")
    parser.add_argument("--min_side", type=int, default=256)
    parser.add_argument("--max_side", type=int, default=512)
    opt = parser.parse_args(argv)
    return filter_imagenet(opt.input_dir, opt.save_dir, opt.min_side, opt.max_side)


if __name__ == "__main__":
    main()
