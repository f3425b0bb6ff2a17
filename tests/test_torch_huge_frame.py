"""scripts/cuda/huge_frame.py on the CPU: its float64 host oracles against
the port's two tiled engines at frames past 256 tiles (a small tile, as
tests/test_torch_tiled.py sets the scatter regime up), with an identity
model and ImprovedUNet-8, and the script's two legs at a tiny size."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from image_denoising_tpu.eval import tiled as jax_tiled
from image_denoising_tpu_torch.ckpt import load_jax_params
from image_denoising_tpu_torch.eval import tiled
from image_denoising_tpu_torch.models import ImprovedUNet, make_fused_forward

from _torch_port_helpers import (load_script, one_torch_thread,  # noqa: F401
                                 seeded_improved_unet_params)

REPO = Path(__file__).resolve().parents[1]
# 17 x 17 = 289 tiles of 16² in both grids: the pyramid's stride-8 grid on
# 136², the Hann engine's edge-aligned one on 144²
PYR, HANN, PS, OVERLAP = 136, 144, 16, 8


@pytest.fixture(scope="module")
def hf():
    return load_script(REPO / "scripts" / "cuda" / "huge_frame.py")


def _model(name):
    if name == "identity":
        return lambda t: t
    _, params = seeded_improved_unet_params(8, seed=9)
    return make_fused_forward(load_jax_params(ImprovedUNet(1, 1, 8), params), device="cpu")


def test_geometries_are_past_256_tiles():
    assert len(tiled.reference_tile_grid(PYR, PYR, PS, PS - OVERLAP)) == 289
    assert len(tiled.edge_aligned_grid(HANN, HANN, PS, OVERLAP)) == 289
    assert len(tiled.reference_tile_grid(4672, 4672, 352, 288)) == 289
    assert len(tiled.edge_aligned_grid(2816, 2816, 128, 64)) == 1849
    assert jax_tiled._UNROLL_MAX_TILES == 256


def _identity_preds(hf, frame, grid):
    """The identity model's tile predictions: the script's own reflect-padded
    crops of the frame, in [0, 1]."""
    return hf.pyramid_crops(frame, grid, PS).astype(np.float32) / 255.0


def test_crops_equal_the_runners_gathers(hf):
    """The script's crops, taken with ``np.pad``, equal the tiles the two
    runners' gathers take, past 256 tiles (the pyramid's last row and
    column of tiles reflect 8 valid pixels out to 16)."""
    frame = torch.from_numpy(hf.seeded_frame(HANN))
    pyr = tiled._PyramidGeometry(PYR, PYR, PS, OVERLAP, "cpu")
    assert min(th for (_, _, th, _) in pyr.grid) < PS
    np.testing.assert_array_equal(
        pyr.gather(frame[None, :PYR, :PYR])[0].numpy(),
        hf.pyramid_crops(frame[:PYR, :PYR].numpy(), pyr.grid, PS))
    hann = tiled._HannGeometry(HANN, HANN, PS, OVERLAP, "cpu")
    np.testing.assert_array_equal(hann.gather(frame[None])[0].numpy(),
                                  hf.hann_crops(frame.numpy(), hann.grid, PS))


def test_pyramid_oracle_against_the_runner_identity(hf):
    """The identity model blends each pixel with itself: the oracle gives
    the frame back wherever a tile weighs it (the pyramid is 0 on each
    tile's first row and column, so the frame's are 0), and the runner's
    float32 blend is within 1e-6 of the oracle.
    (Its ``uint8_floor`` would land on exact integers, where float32 and
    float64 rounding take either side; the network below is held in uint8.)"""
    frame = hf.seeded_frame(PYR)
    grid = tiled.reference_tile_grid(PYR, PYR, PS, PS - OVERLAP)
    preds = _identity_preds(hf, frame, grid)
    want = hf.pyramid_oracle(preds, grid, PS, PYR, PYR, "float32")
    weighed = hf.pyramid_oracle(np.ones_like(preds), grid, PS, PYR, PYR, "float32") > 0.5
    assert weighed.mean() > 0.98 and not weighed[0].any() and not weighed[:, 0].any()
    np.testing.assert_allclose(want[weighed], frame[weighed] / 255.0, atol=1e-7)
    run = tiled.make_tiled_pyramid_runner(lambda t: t, PYR, PYR, PS, OVERLAP, -8,
                                          out_dtype="float32", device="cpu")
    np.testing.assert_allclose(run(frame)[0].numpy(), want, atol=1e-6)


def test_pyramid_oracle_against_the_runner_improved_unet(hf):
    frame = hf.seeded_frame(PYR)
    res = hf.pyramid_leg(_model("improved_unet"), frame, ps=PS, overlap=OVERLAP,
                         device="cpu", reps=1)
    assert res["tiles"] == 289 and res["within_limits"] and res["tiles_equal_to_crops"], res
    assert res["max_abs_diff_uint8"] <= 1 and res["mismatch_frac"] <= 1e-3


@pytest.mark.parametrize("model", ["identity", "improved_unet"])
def test_hann_oracle_against_the_runner(hf, model):
    frame = hf.seeded_frame(HANN)
    res, q, idx = hf.hann_leg(_model(model), frame, ps=PS, overlap=OVERLAP, device="cpu",
                              reps=1)
    assert q is None and idx is None
    assert res["tiles"] == 289 and res["within_limits"] and res["tiles_equal_to_crops"], res


@pytest.mark.parametrize("leg", ["pyramid", "hann"])
def test_a_shifted_gather_is_caught(hf, monkeypatch, leg):
    """A runner whose gather takes every tile one column to the right still
    blends the predictions it got as its oracle does; only the check of
    its tiles against the script's own crops sees the fault."""
    geo = tiled._PyramidGeometry if leg == "pyramid" else tiled._HannGeometry
    gather = geo.gather
    monkeypatch.setattr(geo, "gather", lambda self, imgs: gather(self, imgs.roll(-1, 2)))
    model = _model("improved_unet")
    if leg == "pyramid":
        res = hf.pyramid_leg(model, hf.seeded_frame(PYR), ps=PS, overlap=OVERLAP,
                             device="cpu", reps=1)
    else:
        res, _, _ = hf.hann_leg(model, hf.seeded_frame(HANN), ps=PS, overlap=OVERLAP,
                                device="cpu", reps=1)
    assert res["within_limits"] and not res["tiles_equal_to_crops"], res


def test_pyramid_oracle_equals_the_jax_scatter_blend(hf):
    """The oracle's blend against the JAX package's >256-tile scatter regime
    on the same tile predictions (an affine model that leaves [0, 1], so
    the clip is at work): float32 within 1e-6."""
    frame = hf.seeded_frame(PYR)
    grid = tiled.reference_tile_grid(PYR, PYR, PS, PS - OVERLAP)
    run = jax_tiled.make_tiled_pyramid_runner(lambda t: 1.3 * t - 0.1, PYR, PYR, PS,
                                              OVERLAP, out_dtype="float32")
    want = np.asarray(run(jnp.asarray(frame))[0])
    got = hf.pyramid_oracle(1.3 * _identity_preds(hf, frame, grid) - 0.1, grid, PS, PYR, PYR,
                            "float32")
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_the_script_runs_on_the_cpu(hf, monkeypatch):
    for name, value in dict(N_FEATURE=8, PS=PS, OVERLAP=OVERLAP, HANN_PS=PS,
                            HANN_OVERLAP=OVERLAP, BANK_FRAME=32, BANK_STRIDE=4,
                            REPS=1).items():
        monkeypatch.setattr(hf, name, value)
    lines = []
    res = hf.run(PYR, HANN, device="cpu", emit=lines.append)
    pyr, hann = (json.loads(line) for line in lines)
    for leg in (pyr, hann):
        for key in ("hw", "tiles", "s_per_frame", "mps", "max_abs_diff_uint8",
                    "mismatch_frac", "within_limits", "dtype"):
            assert key in leg, key
        assert leg["tiles"] == 289 and leg["within_limits"] and leg["tiles_equal_to_crops"]
    assert pyr["leg"] == "pyramid" and hann["leg"] == "hann_memory"
    # 4 pairs of 32² at stride 4: 25 patches each, padded to 512 rows
    assert hann["bank_rows"] == 100 and hann["bank_rows_padded"] == 512
    assert hann["retrieval_batch"] == 289 and hann["retrieval_equal_to_plain"]
    assert hann["queries_equal_to_crops"] and hann["memory_equal_to_bank"]
    q, idx, bank = res["retrieval"]
    assert q.dtype == torch.int8 and tuple(q.shape) == (289, PS * PS)
    assert int(idx.max()) < 100


def test_main_needs_a_card_unless_told(hf, capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    assert hf.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err
