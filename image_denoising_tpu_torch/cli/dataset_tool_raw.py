"""SIDD raw prep CLI (counterpart of ``image_denoising_tpu/cli/dataset_tool_raw.py``,
reference ``dataset_tool_raw.py``): a host tool, so it takes no ``--device``;
it needs ``h5py``.

Run: ``python -m image_denoising_tpu_torch.cli.dataset_tool_raw --data_dir d
--save_folder out``; ``main`` returns the number of tiles written.
"""
from __future__ import annotations

import argparse

from ..data.prep import crop_sidd_raw


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", type=str,
                        default="./datasets/SIDD/SIDD_Medium_Raw/Data")
    parser.add_argument("--save_folder", type=str,
                        default="./datasets/SIDD/SIDD_Medium_Raw_noisy_sub512")
    parser.add_argument("--crop_size", type=int, default=512)
    parser.add_argument("--step", type=int, default=256)
    opt = parser.parse_args(argv)
    return crop_sidd_raw(opt.data_dir, opt.save_folder, opt.crop_size, opt.step)


if __name__ == "__main__":
    main()
