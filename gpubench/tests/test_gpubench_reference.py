"""The yardstick's plain network and tiling against the program, at a small size on the CPU."""
import json

import numpy as np
import pytest
import torch

from gpubench.reference import net as ref_net
from gpubench.reference.precision import round_fp8, round_tf32
from gpubench.reference.tiling import denoise_frames, tile_grid
from gpubench.traffic import frame_pool
from image_denoising_tpu_torch.eval.tiled import make_tiled_pyramid_runner_frames
from image_denoising_tpu_torch.models.improved_unet import ImprovedUNet

CFG = dict(json.load(open("gpubench/configs/improved_unet48_f32.json")), n_feature=8)


def _module(seed):
    net = ImprovedUNet(in_nc=1, out_nc=1, n_feature=8, depth=4, noise=True)
    net.load_state_dict(ref_net.make_weights(CFG, seed, "cpu"))
    return net.eval()


def test_weights_load_strictly_into_the_program_module():
    sd = ref_net.make_weights(CFG, 3, "cpu")
    assert set(sd) == set(ImprovedUNet(1, 1, 8).state_dict())
    again = ref_net.make_weights(CFG, 3, "cpu")
    assert all(torch.equal(sd[k], again[k]) for k in sd)


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 11])
def test_reference_forward_matches_the_program_module(seed):
    x = torch.rand(2, 1, 96, 96, generator=torch.Generator().manual_seed(seed % 1000))
    with torch.no_grad():
        want = _module(seed)(x)
        got = ref_net.forward(ref_net.make_weights(CFG, seed, "cpu"), x, CFG)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_reference_tiling_matches_the_program_engine():
    frames = frame_pool(5, {"pool": 2, "hw": 96, "sigma": 25.0})
    module = _module(5)
    run = make_tiled_pyramid_runner_frames(lambda t: module(t), 2, 96, 96, 64, 16,
                                           batch=-2, out_dtype="uint8_floor", device="cpu")
    got, _ = run(frames)
    sd = ref_net.make_weights(CFG, 5, "cpu")
    want = denoise_frames(frames, lambda t: ref_net.forward(sd, t, CFG), 64, 16, 2, "cpu")
    d = np.abs(got.numpy().astype(int) - want.astype(int))
    assert len(tile_grid(96, 96, 64, 16)) == 4
    assert d.max() <= 1 and (d > 0).mean() < 2e-3


def test_control_roundings():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -12, -3.0000002])
    assert round_tf32(x).tolist() == [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -3.0]
    y = torch.linspace(-2.0, 2.0, 101)
    err = (round_fp8(y) - y).abs().max()
    assert 0 < err <= 2.0 / 448 * 16


def test_frame_readings_by_hand():
    from gpubench.check import frame_readings

    ref = np.full((2, 8, 8), 100, np.uint8)
    out = ref.copy()
    out[1, 4:8, 4:8] += 8  # one footprint of frame 1, eight levels up
    out[0, 0, 0] += 1
    grid = tile_grid(8, 8, 4, 0)
    r = frame_readings([(0, out)], ref, 2, 2, grid)
    assert r["off1_share"] == 17 / 128 and r["mean_levels"] == 129 / 128
    assert r["max_levels"] == 8.0 and r["frames_compared"] == 2.0
    assert r["tile_off1_max"] == 1.0 and r["tile_mean_levels_max"] == 8.0
