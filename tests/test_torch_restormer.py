"""Restormer (``models/restormer.py``) against the benchmark's plain
reference (``gpubench/reference/restormer.py``, written from the paper's
equations), on the CPU at small sizes: the module in float32 and bf16, its
published widths and upstream names, the registry and the CLIs' ``--arch``,
the serving path (``make_forward`` under the tiled pyramid engine), the
float32 parameters a bf16 serving copy keeps, the upstream checkpoint
layout, and the spans and counter it records under a profiler. No JAX."""
import os

import numpy as np
import pytest
import torch
from PIL import Image
from torch.profiler import ProfilerActivity, profile

from gpubench.reference import restormer as ref
from gpubench.reference.tiling import denoise_frames
from gpubench.traffic import frame_pool
from image_denoising_tpu_torch.ckpt import load_checkpoint
from image_denoising_tpu_torch.ckpt.io import module_arch
from image_denoising_tpu_torch.cli import denoise, evaluation_704
from image_denoising_tpu_torch.cli.common import build_network, load_params
from image_denoising_tpu_torch.eval.tiled import make_tiled_pyramid_runner_frames
from image_denoising_tpu_torch.models import build_model, build_model_from_log_name
from image_denoising_tpu_torch.models import restormer as port
from image_denoising_tpu_torch.models.fused_forward import make_forward
from image_denoising_tpu_torch.models.registry import ARCHS
from image_denoising_tpu_torch.utils import profiling

PUBLISHED = dict(inp_channels=1, out_channels=1, dim=48, num_blocks=[4, 6, 6, 8],
                 num_refinement_blocks=4, heads=[1, 2, 4, 8], ffn_expansion_factor=2.66)
# dim 8, heads [1, 2, 4, 8], one block a stage: every head width is 8
SMALL = dict(PUBLISHED, dim=8, num_blocks=[1, 1, 1, 1], num_refinement_blocks=1)
SEEDS = [3, 2 ** 31 + 11]
STAGE_SPANS = [f"restormer.{s}" for s in ("enc1", "enc2", "enc3", "latent", "dec3",
                                          "dec2", "dec1", "refine")]
# bf16 against the float32 reference, outputs in [0, 1] plus the residual:
# each conv rounds its operands and its result to bf16 (8 bits, 2^-9
# relative) through 8 stages, read 1.1e-3 mean and 5.7e-3 most on these
# tiles (seed 3). The limits are about 3.5 times that; the same forward with
# every operand in fp8 reads 1.0e-2 mean, over them.
BF16_MEAN, BF16_MAX = 4e-3, 2e-2


def _assert_frames_agree(got, want):
    """uint8 frames within one level, off in under 0.2 % of the pixels the
    reference leaves below 255. Where it saturates, the engine's float32
    blend can land one ulp under 1.0 and floor to 254 (Restormer's output,
    unlike a sigmoid's, reaches past 1)."""
    d = got.astype(int) - want.astype(int)
    assert np.abs(d).max() <= 1 and (d[want < 255] != 0).mean() < 2e-3
    assert set(np.unique(d[want == 255])) <= {-1, 0}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.reset()
    yield
    profiling.reset()
    torch.set_num_threads(n)


def _small(seed, **kw):
    net = port.Restormer(dim=8, num_blocks=[1, 1, 1, 1], num_refinement_blocks=1, **kw)
    net.load_state_dict(ref.make_weights(SMALL, seed, "cpu"), strict=True)
    return net.eval()


def _tiles(seed, n=2, hw=64):
    return torch.rand(n, 1, hw, hw, generator=torch.Generator().manual_seed(seed % 1000))


def _want(seed, x, **variant):
    with torch.no_grad():
        return ref.forward(ref.make_weights(SMALL, seed, "cpu"), x, SMALL, **variant)


@pytest.mark.parametrize("seed", SEEDS)
def test_float32_module_matches_the_reference(seed):
    x = _tiles(seed)
    with torch.no_grad():
        got = _small(seed)(x)
    torch.testing.assert_close(got, _want(seed, x), rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("path", ["serving_copy", "module_dtype"])
def test_bf16_matches_the_reference_within_its_rounding(seed, path):
    """``serving_copy``: ``make_forward``'s bf16 copy (weights cast);
    ``module_dtype``: the module's float32 parameters cast in each conv."""
    x = _tiles(seed)
    if path == "serving_copy":
        got = make_forward(_small(seed), device="cpu", dtype=torch.bfloat16)(x)
    else:
        with torch.no_grad():
            got = _small(seed, dtype=torch.bfloat16)(x)
    assert got.dtype == torch.float32  # the output conv's result plus the input
    d = (got - _want(seed, x)).abs()
    assert float(d.mean()) <= BF16_MEAN and float(d.max()) <= BF16_MAX
    fp8 = (_want(seed, x, precision="fp8") - _want(seed, x)).abs()
    assert float(fp8.mean()) > BF16_MEAN


@pytest.mark.parametrize("variant", [{"centred": True}, {"tau": False}])
def test_the_reference_controls_change_the_answer(variant):
    x = _tiles(5)
    assert float((_want(5, x, **variant) - _want(5, x)).abs().mean()) > BF16_MEAN


def test_published_widths_and_upstream_names():
    with torch.device("meta"):
        net = port.Restormer()
    shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert sum(v.numel() for v in net.parameters()) == 26_109_076
    assert shapes == {k: tuple(s) for k, s in ref.param_specs(PUBLISHED)}
    for key, shape in [("patch_embed.proj.weight", (48, 1, 3, 3)),
                       ("encoder_level1.3.attn.temperature", (1, 1, 1)),
                       ("latent.7.attn.qkv_dwconv.weight", (1152, 1, 3, 3)),
                       ("latent.7.ffn.project_in.weight", (2042, 384, 1, 1)),
                       ("decoder_level1.0.norm1.body.weight", (96,)),
                       ("refinement.3.ffn.project_out.weight", (96, 255, 1, 1)),
                       ("down3_4.body.0.weight", (96, 192, 3, 3)),
                       ("up2_1.body.0.weight", (192, 96, 3, 3)),
                       ("reduce_chan_level3.weight", (192, 384, 1, 1)),
                       ("output.weight", (1, 96, 3, 3))]:
        assert shapes[key] == shape, key
    assert not any(k.endswith(".bias") for k in shapes)


def test_registry_and_the_arch_flags():
    assert "Restormer" in ARCHS
    with torch.device("meta"):
        net = build_model("Restormer", n_channel=1, n_feature=48, dtype=torch.bfloat16)
        by_log = build_model_from_log_name("Restormer_gray_sigma25")
        args = ["--checkpoint", "w.pth", "--arch", "Restormer", "--n_feature", "16"]
        for opt in (denoise.parse_args(["--input_dir", "in"] + args),
                    evaluation_704.parse_args(args)):
            cli_net = build_network(opt.arch, opt.log_name, opt.n_channel, opt.n_feature)
            assert isinstance(cli_net, port.Restormer)
            assert cli_net.patch_embed.proj.weight.shape == (16, 1, 3, 3)
    assert isinstance(net, port.Restormer) and net.dtype == torch.bfloat16
    assert net.latent[0].attn.qkv.compute_dtype == torch.bfloat16
    assert isinstance(by_log, port.Restormer) and module_arch(by_log) == "Restormer"


@pytest.mark.parametrize("seed", SEEDS)
def test_served_burst_matches_the_reference_tiling(seed):
    frames = frame_pool(seed, {"pool": 2, "hw": 128, "sigma": 25.0})
    fwd = make_forward(_small(seed), device="cpu", dtype=torch.float32)
    run = make_tiled_pyramid_runner_frames(fwd, 2, 128, 128, 64, 16, batch=-4,
                                           out_dtype="uint8_floor", device="cpu")
    got, _ = run(frames)
    sd = ref.make_weights(SMALL, seed, "cpu")
    want = denoise_frames(frames, lambda t: ref.forward(sd, t, SMALL), 64, 16, 4, "cpu")
    _assert_frames_agree(got.numpy(), want)


def test_bf16_serving_copy_keeps_its_float32_parameters(monkeypatch):
    net = _small(7)
    seen = {}
    real_ln, real_attn = port.BiasFreeLayerNorm.add_forward, port.Attention.forward

    def ln(self, x, residual=None):  # the served path's norms, each fused with an add
        seen.setdefault("ln", []).append((self.weight, x.dtype))
        return real_ln(self, x, residual)

    def attn(self, x):
        seen.setdefault("tau", []).append(self.temperature)
        seen.setdefault("qkv", []).append(self.qkv.weight.dtype)
        return real_attn(self, x)

    monkeypatch.setattr(port.BiasFreeLayerNorm, "add_forward", ln)
    monkeypatch.setattr(port.Attention, "forward", attn)
    make_forward(net, device="cpu", dtype=torch.bfloat16)(_tiles(7, n=1))
    originals = dict(net.named_parameters())
    kept = [p for p, _ in seen["ln"]] + seen["tau"]
    assert len(kept) == 3 * 8 and all(p.dtype == torch.float32 for p in kept)
    assert all(dt == torch.bfloat16 for _, dt in seen["ln"])
    assert set(seen["qkv"]) == {torch.bfloat16}
    names = [n for n, _ in net.named_parameters()
             if n.endswith(port.Restormer.FLOAT32_PARAMS)]
    assert sorted(torch.cat([p.flatten() for p in kept]).tolist()) == sorted(
        torch.cat([originals[n].detach().flatten() for n in names]).tolist())
    assert all(p.dtype == torch.float32 for p in net.parameters())  # caller's untouched


def test_stage_spans_and_tile_counter_only_under_a_profiler():
    net, x = _small(9), _tiles(9, n=3)
    with torch.no_grad():
        off = net(x)
        assert profiling.record() == {"spans": [], "counters": {}}
        with profile(activities=[ProfilerActivity.CPU]):
            on = net(x)
    assert torch.equal(off, on)
    rec = profiling.record()
    assert [s["name"] for s in rec["spans"]] == STAGE_SPANS
    assert rec["counters"] == {"restormer.tiles": 3}
    assert all(s["device_ms"] is None for s in rec["spans"])  # device-timed on CUDA only


@pytest.mark.parametrize("name", ["restormer.pth", "restormer.ckpt"])
def test_upstream_checkpoint_loads_strictly(tmp_path, name):
    sd = ref.make_weights(SMALL, 4, "cpu")
    path = str(tmp_path / name)
    torch.save({"params": sd}, path)
    net = port.Restormer(dim=8, num_blocks=[1, 1, 1, 1], num_refinement_blocks=1)
    loaded = load_checkpoint(path, arch="Restormer")
    assert set(loaded) == set(sd) and all(torch.equal(loaded[k], sd[k]) for k in sd)
    load_params(path, net)
    assert all(torch.equal(net.state_dict()[k], sd[k]) for k in sd)


def test_denoise_cli_serves_an_upstream_checkpoint(tmp_path):
    """``denoise --arch Restormer --checkpoint <upstream .pth>`` on two 128²
    frames in float32 gives the reference's tiled frames."""
    cfg = dict(PUBLISHED, dim=8)
    sd = ref.make_weights(cfg, 6, "cpu")
    ckpt = str(tmp_path / "gaussian_gray_denoising.pth")
    torch.save({"params": sd}, ckpt)
    frames = frame_pool(6, {"pool": 2, "hw": 128, "sigma": 25.0})
    os.makedirs(tmp_path / "in")
    for i, f in enumerate(frames):
        Image.fromarray(f).save(tmp_path / "in" / f"f{i}.png")
    n = denoise.main(["--input_dir", str(tmp_path / "in"), "--save_dir", str(tmp_path / "out"),
                      "--checkpoint", ckpt, "--arch", "Restormer", "--n_feature", "8",
                      "--device", "cpu", "--dtype", "float32", "--tile", "64",
                      "--overlap", "16", "--frame_burst", "2", "--tile_batch", "-4"])
    assert n == 2
    want = denoise_frames(frames, lambda t: ref.forward(sd, t, cfg), 64, 16, 4, "cpu")
    for i in range(2):
        _assert_frames_agree(np.asarray(Image.open(tmp_path / "out" / f"f{i}_denoised.png")),
                             want[i])
