"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a GPU. The file imports no JAX, so
it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from image_denoising_tpu_torch.memory.retrieval import (
    pad_bank_for_retrieval,
    top1_l2_retrieval,
    top1_l2_retrieval_reference,
)
from image_denoising_tpu_torch.models.improved_unet import RDB, ResBlock
from image_denoising_tpu_torch.ops.fused_block import (
    FusedChainWeights,
    fused_rdb_chain,
    fused_rdb_chain_reference,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("lead", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_rdb_chain_kernel_matches_plain_version(cuda, lead, dtype):
    """Ragged spatial tiles (40x56) and a partial channel tile (nf 24)."""
    torch.manual_seed(3)
    nf = 24
    lead_conv = torch.nn.Conv2d(2, nf, 3, padding=1) if lead else None
    wts = FusedChainWeights.from_modules(RDB(nf), lead=lead_conv,
                                         res=ResBlock(nf), dtype=dtype,
                                         device=cuda)
    x = torch.randn(2, 40, 56, 2 if lead else nf, device=cuda).to(dtype)
    before = fused_rdb_chain.launches
    got = fused_rdb_chain(x, wts)
    torch.cuda.synchronize()
    assert fused_rdb_chain.launches == before + 1
    want = fused_rdb_chain_reference(x, wts)
    for g, w in zip(got, want):
        # f32: summation order; bf16: 4 ulps (2^-7 relative each) of the largest
        atol = 1e-5 if dtype == torch.float32 else 4 * 2.0 ** -7 * w.float().abs().max().item()
        torch.testing.assert_close(g.float(), w.float(), atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_rdb_chain_kernel_at_8x8(cuda, dtype):
    """The E6 bottleneck: an 8x8 image, narrower than one 8x16-pixel block."""
    torch.manual_seed(5)
    nf = 384
    wts = FusedChainWeights.from_modules(RDB(nf), res=ResBlock(nf), dtype=dtype,
                                         device=cuda)
    x = torch.randn(8, 8, 8, nf, device=cuda).to(dtype)
    got = fused_rdb_chain(x, wts)
    torch.cuda.synchronize()
    want = fused_rdb_chain_reference(x, wts)
    for g, w in zip(got, want):
        atol = 1e-4 if dtype == torch.float32 else 4 * 2.0 ** -7 * w.float().abs().max().item()
        torch.testing.assert_close(g.float(), w.float(), atol=atol, rtol=0)


def _retrieval_case(regime, device, b=5, n=1000, d=64):
    """Ragged B, N and D (no tile multiple); row 700 duplicates row 300 and
    query 0 is that row, so the first must win."""
    g = torch.Generator().manual_seed(7)
    bank = torch.rand((n, d), generator=g)
    bank[700] = bank[300]
    q = bank[torch.randint(0, n, (b,), generator=g)] + 0.02 * torch.randn((b, d), generator=g)
    q[0] = bank[300]
    if regime == "int8":
        bank = (torch.round(bank * 255) - 128).to(torch.int8)
        q = torch.clamp(torch.round(q * 255) - 128, -128, 127).to(torch.int8)
        sqn = (bank.int() ** 2).sum(1, dtype=torch.int32)
    else:
        bank = bank.to(getattr(torch, regime))
        sqn = (bank.float() ** 2).sum(1)
    return q.to(device), bank.to(device), sqn.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("regime", ["float32", "bfloat16", "int8"])
def test_top1_l2_retrieval_kernel_matches_plain_version(cuda, regime):
    q, bank, sqn = _retrieval_case(regime, cuda)
    before = top1_l2_retrieval.launches
    got = top1_l2_retrieval(q, bank, sqn)
    torch.cuda.synchronize()
    assert top1_l2_retrieval.launches == before + 1
    assert got.dtype == torch.int32 and got.device.type == "cuda"
    want = top1_l2_retrieval_reference(q, bank, sqn)
    # queries sit 0.02-noise away from a row: every pick is decisive in
    # float32 and bfloat16, and the int8 distances are exact
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert int(got[0]) == 300
    bp, sp = pad_bank_for_retrieval(bank, sqn, 512)
    torch.testing.assert_close(top1_l2_retrieval(q, bp, sp), want, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 1008])
@pytest.mark.parametrize("b", [1, 8, 257])
@pytest.mark.parametrize("regime", ["float32", "bfloat16", "int8"])
def test_top1_l2_retrieval_kernel_edges(cuda, regime, b, d):
    """The tensor-core kernel at one query (a query tile of 8 with 7 empty),
    8 and 257 (two tiles), D = 16 (one partial K-stage) and D = 1008 (no
    multiple of the 32/64/128-element K-stage), N = 1000 (no multiple of
    the 128-row bank tile); the duplicated row's first copy wins and a bank
    padded to 512 rows picks the same."""
    q, bank, sqn = _retrieval_case(regime, cuda, b=b, d=d)
    got = top1_l2_retrieval(q, bank, sqn)
    torch.cuda.synchronize()
    want = top1_l2_retrieval_reference(q, bank, sqn)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert int(got[0]) == 300
    bp, sp = pad_bank_for_retrieval(bank, sqn, 512)
    torch.testing.assert_close(top1_l2_retrieval(q, bp, sp), want, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["lead_cin2_6x6", "split_k_16x16", "ragged_40x56"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_rdb_chain_kernel_edges(cuda, dtype, case):
    """A 6x6 image with the Cin = 2 lead conv (x padded to one 16-byte
    chunk; the image smaller than one 8x8 tile; nf 24, a partial channel
    tile), a 16x16 bottleneck, and a ragged 40x56 image with the lead conv
    at nf 48 (4 M-tiles of 8x8 side by side, so the last of the two
    32-pixel-wide tiles of a row is partial), each with K split across
    blocks in some of its convs: within the chain tolerances of
    chip_smoke.py, and a second call bit-equal."""
    from image_denoising_tpu_torch.ops.fused_block import chain_conv_plans

    torch.manual_seed(7)
    if case == "lead_cin2_6x6":
        nf, lead, shape = 24, torch.nn.Conv2d(2, 24, 3, padding=1), (3, 6, 6, 2)
    elif case == "split_k_16x16":
        nf, lead, shape = 96, None, (1, 16, 16, 96)
    else:
        nf, lead, shape = 48, torch.nn.Conv2d(2, 48, 3, padding=1), (2, 40, 56, 2)
    wts = FusedChainWeights.from_modules(RDB(nf), lead=lead, res=ResBlock(nf),
                                         dtype=dtype, device=cuda)
    x = torch.randn(*shape, device=cuda).to(dtype)
    # every case has fewer than 132 blocks per launch: K is split
    plans = dict(chain_conv_plans(*shape, wts))
    assert max(p["splits"] for p in plans.values()) > 1
    if case == "ragged_40x56":
        assert plans["growth0"]["mt"] == 4 and shape[2] % (8 * 4) != 0
    got = fused_rdb_chain(x, wts)
    again = fused_rdb_chain(x, wts)
    torch.cuda.synchronize()
    want = fused_rdb_chain_reference(x, wts)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        scale = w.float().abs().max().item()
        atol = 1e-4 * max(1.0, scale) if dtype == torch.float32 else 4 * 2.0 ** -7 * scale
        torch.testing.assert_close(g.float(), w.float(), atol=atol, rtol=0)


@pytest.mark.cuda
def test_eval704_cli_on_card_matches_cpu(cuda, tmp_path):
    """The port's evaluation_704 CLI on the card (burst mode, through the
    kernel) against the same CLI on the CPU (plain chain)."""
    import numpy as np
    from PIL import Image

    from image_denoising_tpu_torch.cli import evaluation_704
    from image_denoising_tpu_torch.models import ImprovedUNet

    rng = np.random.default_rng(8)
    for sub in ("clean", "noise"):
        (tmp_path / sub).mkdir()
    for i in range(3):
        clean = rng.integers(0, 256, (96, 80)).astype(np.uint8)
        noisy = np.clip(clean + rng.normal(0, 15, clean.shape), 0, 255).astype(np.uint8)
        Image.fromarray(clean).save(tmp_path / "clean" / f"f{i}.png")
        Image.fromarray(noisy).save(tmp_path / "noise" / f"f{i}.png")
    torch.manual_seed(4)
    torch.save(ImprovedUNet(1, 1, 16).state_dict(), tmp_path / "m.pth")
    args = ["--data_dir", str(tmp_path), "--checkpoint", str(tmp_path / "m.pth"),
            "--n_feature", "16", "--tile", "32", "--overlap", "8",
            "--save_images", "none"]
    before = fused_rdb_chain.launches
    gpu = evaluation_704.main(args + ["--save_dir", str(tmp_path / "g"),
                                      "--frame_burst", "2", "--tile_batch", "-4"])
    assert fused_rdb_chain.launches > before
    cpu = evaluation_704.main(args + ["--save_dir", str(tmp_path / "c"),
                                      "--device", "cpu"])
    assert abs(gpu["psnr"] - cpu["psnr"]) < 0.01
    assert abs(gpu["ssim"] - cpu["ssim"]) < 1e-4


@pytest.mark.cuda
def test_e6_cli_on_card_matches_cpu(cuda, tmp_path):
    """The port's E6 CLI on the card (bursts, hoisted retrieval, both
    kernels) against the same CLI on the CPU (plain versions), with an int8
    bank: its indices are exact, so only the base's summation order differs."""
    import numpy as np
    from PIL import Image

    from image_denoising_tpu_torch.adapters import build_memory_adapter
    from image_denoising_tpu_torch.cli import evaluation_704_iqsl_memory as e6
    from image_denoising_tpu_torch.models import ImprovedUNet

    rng = np.random.default_rng(9)
    for sub in ("clean", "noise"):
        (tmp_path / sub).mkdir()
    for i in range(3):
        clean = rng.integers(0, 256, (96, 80)).astype(np.uint8)
        noisy = np.clip(clean + rng.normal(0, 15, clean.shape), 0, 255).astype(np.uint8)
        Image.fromarray(clean).save(tmp_path / "clean" / f"f{i}.png")
        Image.fromarray(noisy).save(tmp_path / "noise" / f"f{i}.png")
    torch.manual_seed(4)
    torch.save(ImprovedUNet(1, 1, 16).state_dict(), tmp_path / "b.pth")
    adapter = build_memory_adapter("hyper_gated_fft", 1, 16)
    with torch.no_grad():
        for p in adapter.parameters():
            p.uniform_(-0.2, 0.2)
    torch.save(adapter.state_dict(), tmp_path / "a.pth")
    args = ["--data_dir", str(tmp_path), "--base_ckpt", str(tmp_path / "b.pth"),
            "--adapter_ckpt", str(tmp_path / "a.pth"), "--n_feature", "16",
            "--patch_size", "32", "--overlap", "16", "--memory_stride", "8",
            "--bank_dtype", "int8", "--clean_bank_dtype", "uint8",
            "--save_images", "none", "--compute_iq_iou"]
    before = (fused_rdb_chain.launches, top1_l2_retrieval.launches)
    gpu = e6.main(args + ["--save_dir", str(tmp_path / "g"), "--frame_burst", "2"])
    assert fused_rdb_chain.launches > before[0]
    assert top1_l2_retrieval.launches == before[1] + 2  # one per burst
    cpu = e6.main(args + ["--save_dir", str(tmp_path / "c"), "--device", "cpu"])
    assert abs(gpu["psnr"] - cpu["psnr"]) < 0.01
    for k in ("iou_dark", "iou_mid", "iou_bright"):
        assert abs(gpu[k] - cpu[k]) < 1e-3, k


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_subsample_pair_kernel_matches_plain_version(cuda, c, dtype):
    """Bit-equal maps and sub-images; 26 cells per row (no multiple of a
    warp) and 3 images."""
    from image_denoising_tpu_torch.ops.neighbor import subsample_pair, subsample_pair_fused

    img = torch.rand((3, c, 38, 52), generator=torch.Generator().manual_seed(c)).to(cuda, dtype)
    before = subsample_pair_fused.launches
    got = subsample_pair_fused(2 ** 40 + 3, img)
    torch.cuda.synchronize()
    assert subsample_pair_fused.launches == before + 1
    want = subsample_pair(2 ** 40 + 3, img)
    for g, w in zip((got[0], got[1], *got[2]), (want[0], want[1], *want[2])):
        assert g.dtype == w.dtype and g.device.type == "cuda"
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="even"):
        subsample_pair_fused(0, img[..., :51])


def _png_pairs(root, count, size, seed):
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    for sub in ("clean", "noise"):
        (root / sub).mkdir()
    for i in range(count):
        clean = rng.integers(0, 256, (size, size)).astype(np.uint8)
        noisy = np.clip(clean + rng.normal(0, 25, clean.shape), 0, 255).astype(np.uint8)
        Image.fromarray(clean).save(root / "clean" / f"f{i}.png")
        Image.fromarray(noisy).save(root / "noise" / f"f{i}.png")


@pytest.mark.cuda
def test_n2n_step_on_card_matches_cpu(cuda):
    """Two N2N steps at n_feature 8 on 64² frames, without synthetic noise
    (the card's and the CPU's generators differ; the Philox maps do not),
    from one init: the card (kernel, cuDNN) against the CPU (plain version).
    Losses within rtol 1e-4: the sums run in another order, and Adam carries
    the first step's rounding into the second."""
    import copy

    import numpy as np

    from image_denoising_tpu_torch.models import ImprovedUNet
    from image_denoising_tpu_torch.ops.neighbor import subsample_pair_fused
    from image_denoising_tpu_torch.train import create_train_state, make_n2n_train_step

    torch.manual_seed(6)
    cpu_model = ImprovedUNet(1, 1, 8)
    gpu_model = copy.deepcopy(cpu_model).to(cuda)
    rng = np.random.default_rng(6)
    batches = [np.clip(rng.normal(128, 60, (2, 64, 64, 1)), 0, 255).round().astype(np.float32)
               for _ in range(2)]
    losses = {}
    for name, model in (("cpu", cpu_model), ("cuda", gpu_model)):
        step = make_n2n_train_step(model, create_train_state(model), noise_fn=None)
        losses[name] = [float(step(None, b, 40 + i, 1)["loss"]) for i, b in enumerate(batches)]
    assert subsample_pair_fused.launches >= 2
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


@pytest.mark.cuda
def test_train_cli_on_card(cuda, tmp_path):
    """The port's train CLI on the card for 2 steps at n_feature 8: one
    kernel launch per step, finite losses, checkpoints and A_log.csv."""
    import glob
    import os

    import numpy as np

    from image_denoising_tpu_torch.cli import train
    from image_denoising_tpu_torch.ops.neighbor import subsample_pair_fused

    _png_pairs(tmp_path, 4, 64, 9)
    before = subsample_pair_fused.launches
    state = train.main(["--data_dir", str(tmp_path), "--save_model_path", str(tmp_path / "out"),
                        "--loss", "n2n", "--arch", "UNetImproved", "--n_feature", "8",
                        "--n_epoch", "1", "--batchsize", "2"])
    assert subsample_pair_fused.launches == before + 2 and state.step == 2
    assert next(state.model.parameters()).device.type == "cuda"
    (run_dir,) = glob.glob(str(tmp_path / "out" / "*" / "*"))
    assert {"epoch_model_000.pth", "epoch_model_001.pth"} <= set(os.listdir(run_dir))
    with open(os.path.join(run_dir, "validation", "A_log.csv")) as f:
        row = f.read().strip()
    assert row.startswith("epoch1, loss_")
    assert np.isfinite(float(row.split("loss_")[1].split(",")[0]))
