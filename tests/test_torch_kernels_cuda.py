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
