"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a GPU. The file imports no JAX, so
it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

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
