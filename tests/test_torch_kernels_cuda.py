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
from image_denoising_tpu_torch.ops.group_norm import (
    gn_apply,
    gn_apply_reference,
    gn_stats,
    gn_stats_reference,
)
from image_denoising_tpu_torch.ops.layer_norm import add_ln, add_ln_plan, add_ln_reference


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


@pytest.mark.cuda
@pytest.mark.parametrize("shape, dtype", [
    ((4, 1, 352, 350), torch.float32),    # W/2 = 175: not a multiple of 4
    ((4, 3, 352, 356), torch.bfloat16),   # rows of 712 bytes: not 16-byte aligned
    ((1, 1, 352, 352), torch.float32),    # N = 1
    ((1, 3, 352, 352), torch.bfloat16),
    ((4, 3, 352, 352), torch.float32),    # C = 3, the vector path
    ((4, 3, 352, 352), torch.bfloat16),
    ((2, 5, 16, 40), torch.float32),      # C = 5: a second group of channels
])
@pytest.mark.parametrize("offset", [0, 2])
def test_subsample_pair_kernel_edge_shapes(cuda, shape, dtype, offset):
    """The vector and scalar paths, and an image whose start is two
    elements past a 16-byte boundary (offset 2), bit-equal to the plain
    version."""
    from image_denoising_tpu_torch.ops.neighbor import subsample_pair, subsample_pair_fused

    numel = shape[0] * shape[1] * shape[2] * shape[3]
    flat = torch.rand(numel + offset, generator=torch.Generator().manual_seed(numel))
    img = flat.to(cuda, dtype)[offset:].view(shape)
    assert img.is_contiguous() and (img.data_ptr() % 16 != 0) == (offset != 0)
    want = subsample_pair(2 ** 33 + 5, img)
    before = subsample_pair_fused.launches
    got = subsample_pair_fused(2 ** 33 + 5, img)
    torch.cuda.synchronize()
    assert subsample_pair_fused.launches == before + 1
    for g, w in zip((got[0], got[1], *got[2]), (want[0], want[1], *want[2])):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


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
    assert {"epoch_model_000.ckpt", "epoch_model_001.ckpt"} <= set(os.listdir(run_dir))
    with open(os.path.join(run_dir, "validation", "A_log.csv")) as f:
        row = f.read().strip()
    assert row.startswith("epoch1, loss_")
    assert np.isfinite(float(row.split("loss_")[1].split(",")[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("guards", [False, True])
def test_structure_step_on_card_matches_cpu(cuda, guards):
    """Two structure steps at n_feature 8 on 64² frames: the card (cuDNN,
    TF32 off, a ``capturable`` Adam) against the CPU, losses within rtol
    1e-4 (sums in another order, one Adam step apart). With guards, a NaN
    batch between them is skipped on both; on the card under
    ``set_sync_debug_mode("error")``, leaving every parameter and Adam
    tensor equal."""
    import copy

    import numpy as np

    from image_denoising_tpu_torch.models import ImprovedUNet
    from image_denoising_tpu_torch.train import create_train_state, make_structure_train_step

    torch.manual_seed(7)
    cpu_model = ImprovedUNet(1, 1, 8)
    gpu_model = copy.deepcopy(cpu_model).to(cuda)
    rng = np.random.default_rng(7)
    batches = []
    for _ in range(2):
        clean = rng.integers(0, 256, (2, 64, 64, 1)).astype(np.float32)
        batches.append((clean, np.clip(clean + rng.normal(0, 25, clean.shape), 0, 255)))
    bad = batches[0][0].copy()
    bad[0, 3, 5, 0] = np.nan
    losses = {}
    for name, model in (("cpu", cpu_model), ("cuda", gpu_model)):
        state = create_train_state(model)
        step = make_structure_train_step(model, state, guards=guards)
        losses[name] = [float(step(*batches[0])["loss"])]
        if guards:
            def tensors():
                return list(model.parameters()) + [
                    t for s in state.optimizer.state.values() for t in s.values()]

            before = [t.clone() for t in tensors()]
            torch.cuda.set_sync_debug_mode("error" if name == "cuda" else 0)
            try:
                step(bad, batches[0][1])
            finally:
                torch.cuda.set_sync_debug_mode(0)
            assert all(torch.equal(a, b) for a, b in zip(before, tensors()))
            assert int(state.skipped) == 1
        losses[name].append(float(step(*batches[1])["loss"]))
        assert int(state.step) == 2
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["down0_1x704", "bottle_1x44", "bottle_4x8", "down1_4x64"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_rdb_chain_kernel_at_finetune_shapes(cuda, dtype, case):
    """The finetune path's chain shapes at n_feature 48: a whole 704² frame
    of the output-adapter CLIs' validation (its first level, Cin = 2, and
    its 44² bottleneck) and the memory step's batch of 4 128² patches (its
    8² bottleneck and the second level, K split across blocks): within the
    chain tolerances of chip_smoke.py."""
    from image_denoising_tpu_torch.ops.fused_block import chain_conv_plans

    torch.manual_seed(11)
    nf, cin, shape = {"down0_1x704": (48, 2, (1, 704, 704, 2)),
                      "bottle_1x44": (384, 384, (1, 44, 44, 384)),
                      "bottle_4x8": (384, 384, (4, 8, 8, 384)),
                      "down1_4x64": (96, 48, (4, 64, 64, 48))}[case]
    lead = None if case.startswith("bottle") else torch.nn.Conv2d(cin, nf, 3, padding=1)
    wts = FusedChainWeights.from_modules(RDB(nf), lead=lead, res=ResBlock(nf),
                                         dtype=dtype, device=cuda)
    x = torch.randn(*shape, device=cuda).to(dtype)
    if case == "bottle_4x8":
        assert max(p["splits"] for _, p in chain_conv_plans(*shape, wts)) > 1
    got = fused_rdb_chain(x, wts)
    torch.cuda.synchronize()
    want = fused_rdb_chain_reference(x, wts)
    for g, w in zip(got, want):
        scale = w.float().abs().max().item()
        atol = 1e-4 * max(1.0, scale) if dtype == torch.float32 else 4 * 2.0 ** -7 * scale
        torch.testing.assert_close(g.float(), w.float(), atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 2, 3, 4])
@pytest.mark.parametrize("regime", ["float32", "bfloat16", "int8"])
def test_top1_l2_retrieval_kernel_at_finetune_batches(cuda, regime, b):
    """The memory step's query counts: 4, and 1-3 in a tail batch, at
    D = 16,384 (one 128² patch): the plain version's picks (decisive
    queries, exact int8 distances)."""
    q, bank, sqn = _retrieval_case(regime, cuda, b=b, n=3000, d=128 * 128)
    got = top1_l2_retrieval(q, bank, sqn)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, top1_l2_retrieval_reference(q, bank, sqn), atol=0, rtol=0)
    assert int(got[0]) == 300


def _ft_pairs(root, count=5, size=64, seed=12):
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    for sub in ("clean", "noise"):
        (root / sub).mkdir(exist_ok=True)
    for i in range(count):
        clean = np.clip(120 + 60 * np.sin(xx / (6.0 + i)) + 30 * np.cos(yy / 7.0),
                        0, 255).astype(np.uint8)
        noisy = np.clip(clean + rng.normal(0, 15, clean.shape), 0, 255).astype(np.uint8)
        Image.fromarray(clean).save(root / "clean" / f"f{i}.png")
        Image.fromarray(noisy).save(root / "noise" / f"f{i}.png")


@pytest.mark.cuda
def test_memory_finetune_step_on_card_matches_cpu(cuda, tmp_path):
    """Three memory finetune steps (ImprovedUNet-8 base, hyper_gated_fft,
    int8/uint8 bank, λ_grad = λ_iqsl = 0.1) on the card, under
    ``set_sync_debug_mode("error")``: 9 chain launches and 1 retrieval
    launch per step, losses within rtol 1e-4 of the CPU's, and the base
    unchanged."""
    import numpy as np

    from image_denoising_tpu_torch.adapters import (DenoiserWithMemoryAdapter,
                                                    build_memory_adapter)
    from image_denoising_tpu_torch.data import DenoisePatchDataset, list_pairs
    from image_denoising_tpu_torch.memory import build_memory_bank
    from image_denoising_tpu_torch.models import ImprovedUNet, make_fused_forward
    from image_denoising_tpu_torch.train import create_train_state, make_memory_finetune_step

    _ft_pairs(tmp_path)
    clean_p, noise_p = list_pairs(str(tmp_path))
    torch.manual_seed(12)
    base = ImprovedUNet(1, 1, 8).eval()
    before = {k: v.clone() for k, v in base.state_dict().items()}
    stream = DenoisePatchDataset(str(tmp_path), 32, 4).batches(3, np.random.default_rng(1))
    batches = [next(stream) for _ in range(3)]
    cfg = {"t1": 0.35, "t2": 0.65}
    losses = {}
    for dev in ("cpu", "cuda"):
        bank = build_memory_bank(clean_p, noise_p, 32, 16, bank_dtype="int8",
                                 clean_dtype="uint8", device=dev)
        torch.manual_seed(13)
        adapter = build_memory_adapter("hyper_gated_fft", 1, 8).to(dev)
        state = create_train_state(adapter, lr=1e-4)
        step = make_memory_finetune_step(
            DenoiserWithMemoryAdapter(make_fused_forward(base, device=dev), adapter),
            state, lambda_grad=0.1, lambda_iqsl=0.1, iqsl_cfg=cfg)
        counts = (fused_rdb_chain.launches, top1_l2_retrieval.launches)
        out = []
        for c, n in batches:
            torch.cuda.set_sync_debug_mode("error" if dev == "cuda" else 0)
            try:
                m = step(c, n, bank.noise_flat, bank.clean, bank.sq_norms)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            out.append([float(m[k]) for k in ("loss", "l1", "grad", "iqsl")])
        losses[dev] = out
        if dev == "cuda":
            assert fused_rdb_chain.launches - counts[0] == 9 * 3
            assert top1_l2_retrieval.launches - counts[1] == 3
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
    assert all(torch.equal(v, before[k]) for k, v in base.state_dict().items())


@pytest.mark.cuda
@pytest.mark.parametrize("cli", ["finetune", "finetune_iqsl", "finetune_memory"])
def test_finetune_clis_on_card(cuda, tmp_path, cli):
    """Each finetune CLI on the card for 1 epoch at n_feature 8 over a
    ``.ckpt`` base (10 patches: a tail batch of 2): both kernels launched
    (retrieval in the memory CLI only), its checkpoint written, and the
    memory CLI's adapter served by the E6 CLI."""
    import glob
    import importlib

    import numpy as np

    from image_denoising_tpu_torch.ckpt import save_checkpoint
    from image_denoising_tpu_torch.cli import evaluation_704_iqsl_memory as e6
    from image_denoising_tpu_torch.models import ImprovedUNet

    _ft_pairs(tmp_path)
    torch.manual_seed(14)
    base = save_checkpoint(ImprovedUNet(1, 1, 8), str(tmp_path / "base"), "model", 1)
    main = importlib.import_module(f"image_denoising_tpu_torch.cli.{cli}").main
    bank = ["--memory_stride", "16", "--bank_dtype", "int8", "--clean_bank_dtype", "uint8"]
    before = (fused_rdb_chain.launches, top1_l2_retrieval.launches)
    state = main(["--data_dir", str(tmp_path), "--pretrained_ckpt", base, "--n_feature", "8",
                  "--patch_size", "32", "--patches_per_image", "2", "--n_epoch", "1",
                  "--save_model_path", str(tmp_path / "out")]
                 + (bank if cli == "finetune_memory" else []))
    assert int(state.step) == 3 and next(state.model.parameters()).is_cuda
    assert fused_rdb_chain.launches > before[0]
    assert (top1_l2_retrieval.launches > before[1]) == (cli == "finetune_memory")
    role = "adapter" if cli == "finetune" else "adapter_only"
    (ckpt,) = glob.glob(str(tmp_path / "out" / "*" / f"epoch_{role}_001.ckpt"))
    if cli == "finetune_memory":
        avg = e6.main(["--data_dir", str(tmp_path), "--base_ckpt", base, "--adapter_ckpt",
                       ckpt, "--n_feature", "8", "--patch_size", "32", "--overlap", "16",
                       "--save_images", "none", "--save_dir", str(tmp_path / "e6")] + bank)
        assert np.isfinite(avg["psnr"])


@pytest.mark.cuda
def test_device_metrics_on_card_with_default_tf32(cuda):
    """make_device_metrics on 3 frames of 704² with PyTorch's default TF32
    flags (the fixture turns them off): PSNR within 1e-3 dB, SSIM within
    1e-4 of the float64 host SSIM, IoU within 1e-6 of the host IoU."""
    import numpy as np

    from image_denoising_tpu_torch.metrics import (calculate_psnr, calculate_ssim,
                                                   compute_iq_iou, make_device_metrics)

    rng = np.random.default_rng(23)
    yy, xx = np.mgrid[0:704, 0:704]
    clean = np.stack([(128 + 60 * np.sin(xx / (9.0 + i)) * np.cos(yy / 13.0)
                       + rng.normal(0, 6, (704, 704))).clip(0, 255) for i in range(3)])
    pred = np.clip(clean + rng.normal(0, 10, clean.shape), 0, 255).astype(np.uint8)
    clean = clean.astype(np.uint8)
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        psnr, ssim, ious = (t.cpu().numpy() for t in make_device_metrics(iq_iou=True)(
            torch.from_numpy(pred).to(cuda), torch.from_numpy(clean).to(cuda)))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    for k in range(3):
        assert abs(psnr[k] - calculate_psnr(pred[k], clean[k])) <= 1e-3
        assert abs(ssim[k] - calculate_ssim(pred[k], clean[k])) <= 1e-4
        np.testing.assert_allclose(ious[k], compute_iq_iou(pred[k], clean[k]), atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(704, 704), (512, 704)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_whole_frame_forward_matches_module(cuda, shape, dtype):
    """The whole-frame forward of E1, E4 and E5 at batch 1: ImprovedUNet-48
    through the chain kernel (9 launches) against the per-conv module
    forward, in uint8 levels within E2's limits (f32: 1 level on at most
    0.1 % of pixels; bf16: at most 8 levels and a mean of 1.0 against the
    module in float32 and in bfloat16)."""
    import copy

    import numpy as np

    from image_denoising_tpu_torch.eval.tiled import denoise_whole_frame
    from image_denoising_tpu_torch.models import ImprovedUNet, make_fused_forward

    torch.manual_seed(21)
    model = ImprovedUNet(1, 1, 48).eval()
    x = np.random.default_rng(21).random((*shape, 1), dtype=np.float32)
    fwd = make_fused_forward(model, device=cuda, dtype=dtype)
    before = fused_rdb_chain.launches
    got = denoise_whole_frame(fwd, x, device=cuda)
    assert fused_rdb_chain.launches == before + 9

    def levels(p):
        return np.clip(p * 255.0 + 0.5, 0, 255).astype(np.int16)

    for ref_dtype in {torch.float32, dtype}:
        module = copy.deepcopy(model).to(cuda, ref_dtype)
        want = denoise_whole_frame(lambda t, m=module, d=ref_dtype: m(t.to(d)), x,
                                   device=cuda)
        d = np.abs(levels(got) - levels(want))
        if dtype == torch.float32:
            assert d.max() <= 1 and (d > 0).mean() <= 1e-3
        else:
            assert d.max() <= 8 and d.mean() <= 1.0, (ref_dtype, d.max(), d.mean())


@pytest.mark.cuda
def test_subsample_pair_kernel_at_the_unet_n2n_shape(cuda):
    """N2N training of the UNet runs on 704² frames (its sub-images must
    divide by 32): 4 x 1 x 704 x 704 float32, bit-equal to the plain
    version."""
    from image_denoising_tpu_torch.ops.neighbor import subsample_pair, subsample_pair_fused

    img = torch.rand((4, 1, 704, 704), generator=torch.Generator().manual_seed(704)).to(cuda)
    want = subsample_pair(2 ** 35 + 7, img)
    before = subsample_pair_fused.launches
    got = subsample_pair_fused(2 ** 35 + 7, img)
    torch.cuda.synchronize()
    assert subsample_pair_fused.launches == before + 1
    assert got[0].shape == (4, 1, 352, 352) and got[2][0].shape == (4, 352, 352)
    for g, w in zip((got[0], got[1], *got[2]), (want[0], want[1], *want[2])):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("arch, blindspot", [("UNet", False), ("UNet", True),
                                             ("RESNET", False)])
def test_network_forward_on_card_matches_float64(cuda, arch, blindspot):
    """``make_forward`` of UNet-48, the blind-spot UNet-48 and RESNET-48 in
    float32 (cuDNN, TF32 off) on a 704² frame against the same module in
    float64 on the card, in uint8 levels: at most 1 level on at most 0.1 %
    of pixels (E2's float32 limit). No chain launch."""
    import copy

    import numpy as np

    from image_denoising_tpu_torch.eval.tiled import denoise_whole_frame
    from image_denoising_tpu_torch.models import build_model, make_forward

    from image_denoising_tpu_torch.models.init import initialize_weights

    torch.backends.cudnn.allow_tf32 = True  # make_forward turns it off itself
    torch.manual_seed(22)
    # He-normal (scale 1): at the reference's x 0.1 the untrained output sits
    # within 3e-6 of 0 (RESNET's of its input) and every level would agree
    model = initialize_weights(build_model(arch, 1, 48, blindspot=blindspot), 1.0).eval()
    x = np.random.default_rng(22).random((704, 704, 1), dtype=np.float32)
    before = fused_rdb_chain.launches
    got = denoise_whole_frame(make_forward(model, device=cuda), x, device=cuda)
    assert fused_rdb_chain.launches == before
    module = copy.deepcopy(model).to(cuda, torch.float64)
    with torch.no_grad():
        want = denoise_whole_frame(lambda t: module(t.double()), x, device=cuda)

    def levels(p):
        return np.clip(p * 255.0 + 0.5, 0, 255).astype(np.int16)

    d = np.abs(levels(got) - levels(want))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())


def _sharded_case(regime, device, b=5, n=1000, ps=8):
    """A bank of ``n`` 8×8 patches with row 700 a copy of row 300, as a
    ``MemoryBank`` on ``device``, and queries [B, 8, 8, 1] in [0, 1] (query
    0 that row): uint8-exact values, so the int8 regime's centered bytes
    are the same patches."""
    from image_denoising_tpu_torch.memory import MemoryBank

    g = torch.Generator().manual_seed(8)
    rows = torch.randint(0, 256, (n, ps * ps), generator=g).float() / 255
    rows[700] = rows[300]
    pick = torch.randint(0, n, (b,), generator=g)
    q = torch.clamp(rows[pick] + torch.randint(-3, 4, (b, ps * ps), generator=g) / 255, 0, 1)
    q[0] = rows[300]
    if regime == "int8":
        noise = (torch.round(rows * 255) - 128).to(torch.int8)
        sqn = (noise.int() ** 2).sum(1, dtype=torch.int32)
    else:
        noise = rows.to(getattr(torch, regime))
        sqn = (noise.float() ** 2).sum(1)
    clean = torch.rand((n, ps, ps, 1), generator=g)
    bank = MemoryBank(noise.to(device), clean.to(device), sqn.to(device), ps, 4)
    return q.reshape(b, ps, ps, 1).to(device), bank


@pytest.mark.cuda
@pytest.mark.parametrize("regime", ["float32", "bfloat16", "int8"])
def test_top1_l2_keys_kernel_matches_plain_version(cuda, regime):
    """The kernel's keys: the low words are the plain indices (the picks
    are decisive, as in test_top1_l2_retrieval_kernel_matches_plain_version),
    int8 keys equal the plain version's bit for bit (exact distances), and
    one launch a call."""
    from image_denoising_tpu_torch.memory.retrieval import (KEY_ROW_MASK, top1_l2_keys,
                                                            top1_l2_keys_reference)

    q, bank, sqn = _retrieval_case(regime, cuda, b=257)
    before = top1_l2_retrieval.launches
    keys = top1_l2_keys(q, bank, sqn)
    torch.cuda.synchronize()
    assert top1_l2_retrieval.launches == before + 1 and keys.dtype == torch.int64
    want = top1_l2_keys_reference(q, bank, sqn)
    torch.testing.assert_close(keys & KEY_ROW_MASK, want & KEY_ROW_MASK, atol=0, rtol=0)
    assert int(keys[0] & KEY_ROW_MASK) == 300
    if regime == "int8":
        torch.testing.assert_close(keys, want, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("regime", ["float32", "bfloat16", "int8"])
def test_sharded_retrieval_on_one_card(cuda, regime):
    """The bank sharded over ``[cuda:0] * 3`` (rows 300 and 700, copies of
    each other, on shards 0 and 2): three kernel launches a call, the
    patches of the unsharded kernel, and the duplicate's first row wins."""
    from image_denoising_tpu_torch.adapters import select_memory_patch
    from image_denoising_tpu_torch.memory import make_ring_retrieval, shard_bank
    from image_denoising_tpu_torch.parallel import make_mesh

    q, bank = _sharded_case(regime, cuda)
    mesh = make_mesh(devices=[cuda] * 3)
    sb = shard_bank(bank, mesh)
    assert 300 // sb.n_local == 0 and 700 // sb.n_local == 2
    want = select_memory_patch(q, bank.noise_flat, bank.clean, bank.sq_norms)
    before = top1_l2_retrieval.launches
    got = make_ring_retrieval(mesh)(q, sb.noise_flat, sb.clean, sb.sq_norms)
    torch.cuda.synchronize()
    assert top1_l2_retrieval.launches == before + 3
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    torch.testing.assert_close(got[0], bank.clean[300], atol=0, rtol=0)


def test_wrappers_launch_on_their_tensors_device_and_stream(monkeypatch):
    """Each kernel wrapper makes the tensor's own device current and
    launches on that device's current stream (no default device, no
    device-wide stream), as a launch on a card other than ``cuda:0`` needs.
    Run on the CPU with the CUDA runtime and the libraries mocked and
    tensors on the ``meta`` device, which stands for a second card."""
    import contextlib

    from image_denoising_tpu_torch.memory import retrieval
    from image_denoising_tpu_torch.ops import _build, fused_block, neighbor

    entered, asked = [], []

    @contextlib.contextmanager
    def device(d):
        entered.append(torch.device(d))
        yield

    class Stream:
        def __init__(self, d):
            asked.append(torch.device(d))
            self.cuda_stream = 7000 + len(str(d))

    streams = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: streams.append(args[-1].value) or 0

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    for loader in ("load_retrieval", "load_neighbor", "load_fused_block"):
        monkeypatch.setattr(_build, loader, lambda: Lib())
    meta = torch.device("meta")

    retrieval._top1_cuda(torch.empty(8, 64, device=meta), torch.empty(100, 64, device=meta),
                         torch.empty(100, device=meta))
    neighbor._subsample_cuda(3, torch.empty(2, 1, 16, 16, device=meta))
    wts = FusedChainWeights.from_modules(RDB(16), res=ResBlock(16), dtype=torch.float32,
                                         device=meta)
    fused_block._fused_rdb_chain_cuda(torch.empty(2, 8, 8, 16, device=meta), wts, 32, 4)
    assert entered and all(d == meta for d in entered)
    assert asked and all(d == meta for d in asked)
    assert streams and set(streams) == {7000 + len("meta")}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 352, 352), (4, 128, 128), (1, 704, 704)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_rdb_chain_kernel_at_the_rgb_lead(cuda, dtype, shape):
    """RGB mode's first level at n_feature 48: the lead conv takes in_nc + 1
    = 4 channels (the wrapper pads them to its chunk), at 8 tiles of 352²,
    the RGB finetune step's 4 patches of 128² and E1's whole 704² frame:
    within the chain tolerances of chip_smoke.py."""
    torch.manual_seed(13)
    nf, cin = 48, 4
    wts = FusedChainWeights.from_modules(RDB(nf), lead=torch.nn.Conv2d(cin, nf, 3, padding=1),
                                         res=ResBlock(nf), dtype=dtype, device=cuda)
    x = torch.randn(*shape, cin, device=cuda).to(dtype)
    before = fused_rdb_chain.launches
    got = fused_rdb_chain(x, wts)
    torch.cuda.synchronize()
    assert fused_rdb_chain.launches == before + 1
    want = fused_rdb_chain_reference(x, wts)
    for g, w in zip(got, want):
        assert g.shape == (*shape, nf)
        scale = w.float().abs().max().item()
        atol = 1e-4 * max(1.0, scale) if dtype == torch.float32 else 4 * 2.0 ** -7 * scale
        torch.testing.assert_close(g.float(), w.float(), atol=atol, rtol=0)


@pytest.mark.cuda
def test_top1_l2_retrieval_kernel_at_the_huge_frame_batch(cuda):
    """The hoisted retrieval of a 2816² frame's 1849 tiles of 128² in one
    pass over an int8 bank of 4,608 rows (padded): indices equal to the plain
    version's (exact integer distances)."""
    q, bank, sqn = _retrieval_case("int8", cuda, b=1849, n=4608, d=128 * 128)
    before = top1_l2_retrieval.launches
    got = top1_l2_retrieval(q, bank, sqn)
    torch.cuda.synchronize()
    assert top1_l2_retrieval.launches == before + 1
    torch.testing.assert_close(got, top1_l2_retrieval_reference(q, bank, sqn), atol=0, rtol=0)
    assert int(got[0]) == 300


@pytest.mark.cuda
def test_subsample_pair_kernel_at_the_convergence_shape(cuda):
    """The N2N convergence run's batch: 4 x 1 x 128 x 128 float32, bit-equal
    to the plain version."""
    from image_denoising_tpu_torch.ops.neighbor import subsample_pair, subsample_pair_fused

    img = torch.rand((4, 1, 128, 128), generator=torch.Generator().manual_seed(128)).to(cuda)
    want = subsample_pair(2 ** 33 + 5, img)
    before = subsample_pair_fused.launches
    got = subsample_pair_fused(2 ** 33 + 5, img)
    torch.cuda.synchronize()
    assert subsample_pair_fused.launches == before + 1
    assert got[0].shape == (4, 1, 64, 64) and got[2][0].shape == (4, 64, 64)
    for g, w in zip((got[0], got[1], *got[2]), (want[0], want[1], *want[2])):
        assert torch.equal(g, w)


def _chip_smoke():
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    return chip_smoke


@pytest.mark.cuda
def test_fused_rdb_chain_kernel_on_the_one_way_case_at_up0(cuda):
    """E2's up0 (8 tiles of 44², Cin 576: 1,944 instructions a conv on one
    accumulator without the per-stage sum) on inputs, weights and biases
    ≥ 0, where the tensor cores' truncation cannot cancel: within
    ONE_WAY_SHARE (0.1) of chain_tol of the plain version."""
    cs = _chip_smoke()
    (shape,) = [s for s in cs.chain_shapes(cs.TILE) if s[0] == "up0"]
    (_, x, wts), = cs.one_way_cases(0, [shape], device=cuda)
    before = fused_rdb_chain.launches
    got = fused_rdb_chain(x, wts)
    torch.cuda.synchronize()
    assert fused_rdb_chain.launches == before + 1
    check = cs.chain_verdict(got, fused_rdb_chain_reference(x, wts), "float32",
                             cs.ONE_WAY_SHARE)
    assert check.ok, check


@pytest.mark.cuda
def test_top1_l2_retrieval_kernel_picks_the_bf16_ties(cuda):
    """chip_smoke.retrieval_case's bf16 regime: its 6 ties exact in bf16,
    BF16_TIE_GAP float32 tolerances apart, go to the nearer row, and the
    whole check passes."""
    cs = _chip_smoke()
    bank, sqn, q = cs.retrieval_case(0)["bfloat16"]
    got = top1_l2_retrieval(q, bank, sqn)
    want = cs.top1_want("bfloat16", bank, sqn, q)
    ties = slice(cs.BF16_TIE_Q, cs.BF16_TIE_Q + cs.N_BF16_TIE)
    nearer = list(range(cs.BF16_TIE_ROW + 1, cs.BF16_TIE_ROW + 2 * cs.N_BF16_TIE, 2))
    assert want[2][ties].tolist() == nearer
    assert got[ties].tolist() == nearer
    assert cs.top1_verdict("bfloat16", got, want).ok


def _mutant(name):
    """scripts/cuda/mutants.py and chip_smoke.py as modules, and the mutant
    ``name`` built from its patched copy of csrc/ under build/mutants/."""
    from image_denoising_tpu_torch.ops import _build

    cs = _chip_smoke()
    mut = cs._script("mutants")
    m = next(m for m in mut.MUTANTS if m.name == name)
    return mut, cs, _build.open_library(m.source, mut.compile_mutant(mut.prepare(m))[0])


@pytest.mark.cuda
def test_chain_check_rejects_the_leaky_slope_mutant(cuda):
    """chip_smoke.py's chain check passes the kernel, rejects the mutant
    whose LeakyReLU slope is 0.25 for 0.2, and passes the kernel again once
    the loader is back."""
    mut, cs, lib = _mutant("leaky_slope")
    torch.manual_seed(3)
    wts = FusedChainWeights.from_modules(RDB(24), lead=torch.nn.Conv2d(2, 24, 3, padding=1),
                                         res=ResBlock(24), dtype=torch.float32, device=cuda)
    x = torch.randn(2, 40, 56, 2, device=cuda)
    want = fused_rdb_chain_reference(x, wts)
    assert cs.chain_verdict(fused_rdb_chain(x, wts), want, "float32").ok
    with mut.swapped_loader("chain", lib):
        assert not cs.chain_verdict(fused_rdb_chain(x, wts), want, "float32").ok
    assert cs.chain_verdict(fused_rdb_chain(x, wts), want, "float32").ok


@pytest.mark.cuda
@pytest.mark.parametrize("regime", ["float32", "int8"])
def test_retrieval_check_rejects_the_ties_last_mutant(cuda, regime):
    """The mutant whose keys send a tie to the last minimum picks row 700,
    the second copy of row 300, for query 0: the retrieval check rejects
    it, and passes the kernel before and after."""
    mut, cs, lib = _mutant("ties_last")
    q, bank, sqn = _retrieval_case(regime, cuda)
    want = cs.top1_want(regime, bank, sqn, q)
    assert cs.top1_verdict(regime, top1_l2_retrieval(q, bank, sqn), want, dup=300).ok
    with mut.swapped_loader("retrieval", lib):
        got = top1_l2_retrieval(q, bank, sqn)
    assert int(got[0]) == 700
    assert not cs.top1_verdict(regime, got, want, dup=300).ok
    assert cs.top1_verdict(regime, top1_l2_retrieval(q, bank, sqn), want, dup=300).ok


@pytest.mark.cuda
def test_subsample_check_rejects_the_pair_table_mutant(cuda):
    """The mutant with two draws of its pair table swapped (the same 8 pairs,
    each still drawn 1/8 of the time): bit-equality to the plain version
    rejects it."""
    from image_denoising_tpu_torch.ops.neighbor import subsample_pair, subsample_pair_fused

    mut, cs, lib = _mutant("pair_table")
    img = torch.rand((4, 1, 64, 64), generator=torch.Generator().manual_seed(64)).to(cuda)
    want = subsample_pair(2 ** 33 + 5, img)
    assert cs.subsample_bits_verdict(subsample_pair_fused(2 ** 33 + 5, img), want).ok
    with mut.swapped_loader("subsample", lib):
        got = cs.poisoned(lambda: subsample_pair_fused(2 ** 33 + 5, img))
    assert not cs.subsample_bits_verdict(got, want).ok
    assert cs.subsample_bits_verdict(subsample_pair_fused(2 ** 33 + 5, img), want).ok


# (N, H, W, C) of the ResBlock tails the forward runs: E2's 9 levels of an
# 8-tile chunk of 352², the finetuners' batch of 4 × 128², E1's whole 704²
# frame, a bottleneck whose blocks get fewer pixels than rows, a tiny width;
# then the one-value-a-thread kernels: widths that 16 bytes do not divide
# (C = 4 in bfloat16, the up3 level of an n_feature 8 network, and C = 6 in
# both dtypes) and tensors one element past a 16-byte boundary (GN_OFFSET)
GN_CASES = {
    "e2_down0": (8, 352, 352, 48), "e2_down1": (8, 176, 176, 96),
    "e2_down2": (8, 88, 88, 192), "e2_down3": (8, 44, 44, 384),
    "e2_bottle": (8, 22, 22, 384), "e2_up0": (8, 44, 44, 192),
    "e2_up1": (8, 88, 88, 96), "e2_up2": (8, 176, 176, 48),
    "e2_up3": (8, 352, 352, 24), "finetune_4x128": (4, 128, 128, 48),
    "e1_1x704": (1, 704, 704, 48), "ragged_1x44": (1, 44, 44, 384),
    "tiny_2x9x7": (2, 9, 7, 8),
    "width4_2x9x7": (2, 9, 7, 4), "width6_2x9x7": (2, 9, 7, 6),
    "unaligned_2x44x44x96": (2, 44, 44, 96),
}
GN_OFFSET = {"unaligned_2x44x44x96": 1}  # elements x and the residual start past a boundary


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(GN_CASES))
def test_group_norm_kernels_match_plain_version(cuda, case, dtype):
    """gn_stats, gn_apply(act) and gn_apply(residual) against their plain
    versions on the card, one launch each, NHWC (channels_last) out.
    Statistics: float32 sums of up to 1.2 M values in another order (1e-5 of
    the group's standard deviation for the mean, 1e-5 relative for rstd).
    Apply, from the plain statistics: float32 within 1e-5 of the largest
    value (FMA against a multiply and an add); bfloat16 within one unit in
    the last place of the largest value (2^-7 of it), on at most 0.1 % of
    elements (a float32 difference that flips a rounding). The scalar
    cases must take the one-value-a-thread kernels, the others the 16-byte
    ones."""
    from image_denoising_tpu_torch.models.layers import gn_groups
    from image_denoising_tpu_torch.ops.group_norm import gn_plan

    n, h, w, c = GN_CASES[case]
    offset = GN_OFFSET.get(case, 0)
    groups = gn_groups(c)
    g = torch.Generator(device=cuda).manual_seed(n * h * w + c)
    shift = 2 * torch.randn(c, generator=g, device=cuda)
    x = (3 * torch.randn(n, h, w, c, generator=g, device=cuda) + shift).to(dtype)
    r = torch.randn(n, h, w, c, generator=g, device=cuda).to(dtype)
    if offset:
        x, r = (torch.empty(t.numel() + offset, dtype=dtype, device=cuda)[offset:]
                .view(t.shape).copy_(t) for t in (x, r))
        assert x.data_ptr() % 16 and r.data_ptr() % 16
    scalar = bool(offset or c % (16 // x.element_size()))
    assert (gn_plan(n, h * w, c, dtype, not offset).vec == 1) == scalar
    gamma = 1 + 0.3 * torch.randn(c, generator=g, device=cuda)
    beta = 0.2 * torch.randn(c, generator=g, device=cuda)
    before = (gn_stats.launches, gn_apply.launches)
    mean, rstd = gn_stats(x, groups)
    want_mean, want_rstd = gn_stats_reference(x, groups)
    act = gn_apply(x, want_mean, want_rstd, gamma, beta, act=True)
    res = gn_apply(x, want_mean, want_rstd, gamma, beta, residual=r)
    torch.cuda.synchronize()
    assert (gn_stats.launches, gn_apply.launches) == (before[0] + 1, before[1] + 2)
    assert mean.shape == rstd.shape == (n, groups) and mean.dtype == torch.float32
    assert ((mean - want_mean).abs() <= 1e-5 / want_rstd).all()
    torch.testing.assert_close(rstd, want_rstd, rtol=1e-5, atol=0)
    for got, want in ((act, gn_apply_reference(x, want_mean, want_rstd, gamma, beta, act=True)),
                      (res, gn_apply_reference(x, want_mean, want_rstd, gamma, beta,
                                               residual=r))):
        assert got.dtype == dtype and got.shape == x.shape and got.is_contiguous()
        assert got.permute(0, 3, 1, 2).is_contiguous(memory_format=torch.channels_last)
        err = (got.float() - want.float()).abs()
        top = want.float().abs().max()
        if dtype == torch.float32:
            assert err.max() <= 1e-5 * top
        else:
            assert err.max() <= 2.0 ** -7 * top
            assert (err > 0).float().mean() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_forward_runs_every_tail_on_the_group_norm_kernels(cuda, dtype):
    """One of E2's 8-tile chunks of 352² through ImprovedUNet-48's fused
    forward under a profiler: 9 tails on the ``forward.gn_tail`` counter, 18
    launches of each GroupNorm kernel, 9 chain launches, no
    ``F.group_norm`` kernel (``RowwiseMoments``) on the card, and a tail's
    output channels_last."""
    from image_denoising_tpu_torch.models import ImprovedUNet, make_fused_forward
    from image_denoising_tpu_torch.models.fused_forward import _res_tail
    from image_denoising_tpu_torch.utils import profiling

    torch.manual_seed(22)
    model = ImprovedUNet(1, 1, 48).eval()
    fwd = make_fused_forward(model, device=cuda, dtype=dtype)
    x = torch.rand(8, 1, 352, 352, device=cuda)
    fwd(x)
    torch.cuda.synchronize()
    before = (gn_stats.launches, gn_apply.launches, fused_rdb_chain.launches)
    profiling.reset()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        y = fwd(x)
        torch.cuda.synchronize()
    assert profiling.record()["counters"].get("forward.gn_tail") == 9
    assert (gn_stats.launches, gn_apply.launches, fused_rdb_chain.launches) == (
        before[0] + 18, before[1] + 18, before[2] + 9)
    names = [e.key for e in prof.key_averages()]
    assert any("gn_stats_kernel" in k for k in names)
    assert any("gn_apply_kernel" in k for k in names)
    assert not any("RowwiseMoments" in k for k in names)
    assert y.shape == x.shape and torch.isfinite(y).all()

    sd = {k: v.to(cuda, torch.float32 if ".block.1." in k or ".block.4." in k else dtype)
          for k, v in model.state_dict().items()}
    c0 = torch.randn(8, 44, 44, 384, device=cuda).to(dtype)
    tail = _res_tail(torch.randn_like(c0), c0, sd, "downs.3.3")
    assert tail.shape == (8, 384, 44, 44)
    assert tail.is_contiguous(memory_format=torch.channels_last)


# (N, H, W, C) of Restormer's add and norm calls in an E2 burst's 8-tile
# chunk of 352² (enc1, enc2, enc3 and dec3, latent, dec1 and refinement),
# then an odd pixel count (the last warp partly past the end), a width no 1
# to 4 vectors of a power-of-two group of lanes make (C = 40: five bf16
# vectors, ten float32 ones), and a tensor one element past a 16-byte
# boundary (ADD_LN_OFFSET): the last two take one value a lane
ADD_LN_CASES = {
    "enc1_8x352": (8, 352, 352, 48), "enc2_8x176": (8, 176, 176, 96),
    "enc3_8x88": (8, 88, 88, 192), "latent_8x44": (8, 44, 44, 384),
    "dec1_8x352": (8, 352, 352, 96), "odd_1x7x9": (1, 7, 9, 48),
    "width40_2x9x7": (2, 9, 7, 40), "unaligned_2x44x44x96": (2, 44, 44, 96),
}
ADD_LN_OFFSET = {"unaligned_2x44x44x96": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [True, False], ids=["residual", "alone"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(ADD_LN_CASES))
def test_add_ln_kernel_matches_plain_version(cuda, case, dtype, residual):
    """add_ln against its plain version on the card, one launch, NHWC out.
    The sum: equal bit for bit (both round the float32 sum once). The norm:
    the variance is summed in another order (two passes over registers
    against PyTorch's Welford), so float32 within 1e-5 relative of each
    value; bfloat16 within one unit in the last place of each value (2^-7
    of it), on at most 1 % of elements (a float32 difference that flips a
    rounding). The scalar cases must take the one-value-a-thread kernel, the
    others the 16-byte one."""
    n, h, w, c = ADD_LN_CASES[case]
    offset = ADD_LN_OFFSET.get(case, 0)
    g = torch.Generator(device=cuda).manual_seed(n * h * w + c)
    shift = torch.randn(c, generator=g, device=cuda)
    x = (2 * torch.randn(n, h, w, c, generator=g, device=cuda) + shift).to(dtype)
    r = torch.randn(n, h, w, c, generator=g, device=cuda).to(dtype) if residual else None
    if offset:
        x = torch.empty(x.numel() + offset, dtype=dtype, device=cuda)[offset:].view(
            x.shape).copy_(x)
        assert x.data_ptr() % 16
    scalar = bool(offset or case.startswith("width"))
    assert (add_ln_plan(n * h * w, c, dtype, not offset).vectors == 0) == scalar
    wt = 1 + 0.3 * torch.randn(c, generator=g, device=cuda)
    before = add_ln.launches
    s, y = add_ln(x, wt, r)
    torch.cuda.synchronize()
    assert add_ln.launches == before + 1
    want_s, want_y = add_ln_reference(x, wt, r)
    assert torch.equal(s, want_s) and (residual or s is x)
    assert y.dtype == dtype and y.shape == x.shape and y.is_contiguous()
    err = (y.float() - want_y.float()).abs()
    if dtype == torch.float32:
        assert (err <= 1e-5 * want_y.abs()).all()
    else:
        assert (err <= 2.0 ** -7 * want_y.float().abs()).all()
        assert (err > 0).float().mean() <= 0.01


RESTORMER_CFG = dict(inp_channels=1, out_channels=1, dim=48, num_blocks=[4, 6, 6, 8],
                     num_refinement_blocks=4, heads=[1, 2, 4, 8], ffn_expansion_factor=2.66)


def _published_restormer_chunk(cuda):
    """The published grayscale Restormer on the benchmark reference's
    weights (on the host), its state dict, and an E2 chunk of 8 tiles of
    352² on the card."""
    from gpubench.reference import restormer as ref
    from image_denoising_tpu_torch.models import restormer as port

    sd = ref.make_weights(RESTORMER_CFG, 2 ** 31 + 7, "cpu")
    model = port.Restormer()
    model.load_state_dict(sd, strict=True)
    x = torch.rand(8, 1, 352, 352, generator=torch.Generator().manual_seed(8)).to(cuda)
    return model, sd, x


@pytest.mark.cuda
def test_served_restormer_runs_every_add_and_norm_on_the_kernel(cuda):
    """One of E2's 8-tile chunks of 352² through the published Restormer's
    bf16 serving copy under a profiler: 88 launches of the kernel (44 blocks,
    two norms each), ``restormer.add_ln`` 88 and the kernel in the trace. A
    forward under autograd (the same weights, each conv casting to bf16,
    the blocks' plain ops) launches it 0 times. Both forwards round to bf16
    in their own places, and a rounding that flips early is carried through
    44 blocks, so they are held to the float32 reference (TF32 off) and not
    to each other: the kernel's mean distance from it at most 1.1 times the
    plain ops' (a mean over 1 M pixels; the same rounding sizes)."""
    from gpubench.reference import restormer as ref
    from image_denoising_tpu_torch.models.fused_forward import make_forward
    from image_denoising_tpu_torch.utils import profiling

    model, sd, x = _published_restormer_chunk(cuda)
    fwd = make_forward(model, device=cuda, dtype=torch.bfloat16)
    fwd(x)
    torch.cuda.synchronize()
    before = add_ln.launches
    profiling.reset()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        y = fwd(x)
        torch.cuda.synchronize()
    assert add_ln.launches == before + 88
    assert profiling.record()["counters"].get("restormer.add_ln") == 88
    assert any("add_ln_vec_kernel" in e.key for e in prof.key_averages())
    profiling.reset()

    model = model.to(cuda, memory_format=torch.channels_last).requires_grad_(False)
    model.dtype = torch.bfloat16  # each conv casts to bf16, the norms' weights stay float32
    before = add_ln.launches
    with torch.enable_grad():
        plain = model(x.contiguous(memory_format=torch.channels_last))
    torch.cuda.synchronize()
    assert add_ln.launches == before
    with torch.no_grad():
        want = ref.forward({k: v.to(cuda) for k, v in sd.items()}, x, RESTORMER_CFG)
    kernel_err = float((y.float() - want).abs().mean())
    plain_err = float((plain.float() - want).abs().mean())
    apart = float((y.float() - plain.float()).abs().mean())
    print(f"restormer chunk: kernel {kernel_err:.6g}, plain {plain_err:.6g} from the "
          f"float32 reference; {apart:.6g} apart")
    assert kernel_err <= 1.1 * plain_err, (kernel_err, plain_err, apart)


@pytest.mark.cuda
def test_served_float32_restormer_matches_its_plain_ops(cuda):
    """The same chunk through the float32 serving copy (TF32 off): 88
    launches of the kernel, against the module's plain ops under autograd
    (0 launches). In float32 both paths round where the other does, and only
    the order in which each pixel's variance is summed differs (the kernel's
    two passes over registers against PyTorch's Welford), so they are held to
    each other directly: a mean distance of at most 1e-5 and a largest of at
    most 1e-3 (a quarter of a 1/255 level). In bf16 the two paths are 1.8e-3
    apart on average; a norm computed below float32 would be as far."""
    from image_denoising_tpu_torch.models.fused_forward import make_forward

    model, _, x = _published_restormer_chunk(cuda)
    fwd = make_forward(model, device=cuda, dtype=torch.float32)
    fwd(x)
    torch.cuda.synchronize()
    before = add_ln.launches
    y = fwd(x)
    torch.cuda.synchronize()
    assert add_ln.launches == before + 88
    assert y.dtype == torch.float32

    model = model.to(cuda, memory_format=torch.channels_last).requires_grad_(False)
    before = add_ln.launches
    with torch.enable_grad():
        plain = model(x.contiguous(memory_format=torch.channels_last))
    torch.cuda.synchronize()
    assert add_ln.launches == before
    diff = (y - plain).abs()
    mean, top = float(diff.mean()), float(diff.max())
    print(f"float32 restormer chunk: kernel path {mean:.6g} from the plain ops on "
          f"average, {top:.6g} at most")
    assert mean <= 1e-5 and top <= 1e-3, (mean, top)
