"""The GroupNorm kernel pair's plain version (``ops/group_norm.py``, the
CPU path of the serving forward's ResBlock tail) against the composition the
tail ran before it: ``F.group_norm`` in float32, LeakyReLU and the residual
add on the working dtype. Also the launch plan both kernels share."""
import pytest
import torch
import torch.nn.functional as F

from image_denoising_tpu_torch.models.fused_forward import _res_tail
from image_denoising_tpu_torch.models.layers import gn_groups
from image_denoising_tpu_torch.ops.group_norm import (
    GRID_BLOCKS,
    gn_apply,
    gn_plan,
    gn_stats,
)


def _old_tail(rdb_out, c0, sd, prefix):
    """The tail as plain PyTorch ops on NCHW tensors (before the kernels)."""
    def gn(x, name):
        return F.group_norm(x.float(), gn_groups(x.shape[1]), sd[f"{name}.weight"],
                            sd[f"{name}.bias"], 1e-5).to(x.dtype)

    h = F.leaky_relu(gn(c0, f"{prefix}.block.1"), 0.2)
    w = sd[f"{prefix}.block.3.weight"]
    h = gn(F.conv2d(h, w, sd[f"{prefix}.block.3.bias"], padding=1), f"{prefix}.block.4")
    return rdb_out + h


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c, groups", [(8, 8), (24, 24), (48, 24), (96, 32), (192, 32),
                                       (384, 32)])
def test_plain_tail_matches_the_plain_ops(c, groups, dtype):
    """NHWC in (the chain's results), NCHW channels_last out. Inputs far from
    zero mean and unit scale, as conv outputs are. float32: the statistics'
    and conv1's summation order (1e-5 of the largest); bfloat16: the same
    order flips the rounding of a normalised value to bfloat16 now and then,
    which the LeakyReLU, conv1 and the residual add carry on: at most one
    unit in the last place of the largest value (2^-7 of it), on at most 1 %
    of elements."""
    assert gn_groups(c) == groups
    g = torch.Generator().manual_seed(c)
    n, h, w = 2, 12, 10
    sd = {"r.block.1.weight": 1 + 0.3 * torch.randn(c, generator=g),
          "r.block.1.bias": 0.2 * torch.randn(c, generator=g),
          "r.block.3.weight": (torch.randn(c, c, 3, 3, generator=g) / (3 * c ** 0.5)).to(dtype),
          "r.block.3.bias": (0.1 * torch.randn(c, generator=g)).to(dtype),
          "r.block.4.weight": 1 + 0.3 * torch.randn(c, generator=g),
          "r.block.4.bias": 0.2 * torch.randn(c, generator=g)}
    c0 = (3 * torch.randn(n, h, w, c, generator=g) + 1.5).to(dtype)
    rdb = torch.randn(n, h, w, c, generator=g).to(dtype)

    got = _res_tail(rdb, c0, sd, "r")
    want = _old_tail(rdb.permute(0, 3, 1, 2), c0.permute(0, 3, 1, 2).contiguous(), sd, "r")
    assert got.shape == want.shape and got.dtype == dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert err.max() <= 1e-5 * want.abs().max()
    else:
        assert err.max() <= 2.0 ** -7 * want.float().abs().max()
        assert (err > 0).float().mean() <= 0.01


def test_plain_stats_are_biased_and_float32():
    """mean and 1/sqrt(var + eps) per sample and group, var biased, in
    float32 from bfloat16 input."""
    x = torch.arange(2 * 3 * 4 * 8, dtype=torch.float32).reshape(2, 3, 4, 8)
    mean, rstd = gn_stats(x.to(torch.bfloat16), 4)
    v = x.reshape(2, 12, 4, 2)
    assert mean.dtype == rstd.dtype == torch.float32 and mean.shape == (2, 4)
    torch.testing.assert_close(mean, v.mean((1, 3)))
    torch.testing.assert_close(rstd, (v.var((1, 3), unbiased=False) + 1e-5).rsqrt())


def test_apply_takes_one_epilogue():
    x = torch.randn(1, 2, 2, 4)
    mean, rstd = gn_stats(x, 2)
    ones, zeros = torch.ones(4), torch.zeros(4)
    for kw in ({}, {"act": True, "residual": x}):
        with pytest.raises(ValueError, match="one epilogue"):
            gn_apply(x, mean, rstd, ones, zeros, **kw)
    with pytest.raises(ValueError, match="groups"):
        gn_stats(x, 3)
    with pytest.raises(TypeError):
        gn_stats(x.double(), 2)


# (N, H·W, C) of every ResBlock tail the forward runs: E2's 8-tile chunks of
# 352² (9 levels), E6's of 128², E1's whole 704² frame, the finetuners' batch
# of 4 × 128²
def _levels(n, hw, nf=48):
    down = [(n, (hw >> i) ** 2, nf << i) for i in range(4)]
    up = [(n, (hw >> (3 - i)) ** 2, (nf << 3) >> (i + 1)) for i in range(4)]
    return down + [(n, (hw >> 4) ** 2, nf << 3)] + up


FORWARD_SHAPES = _levels(8, 352) + _levels(8, 128) + _levels(1, 704) + _levels(4, 128)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n, p, c", sorted(set(FORWARD_SHAPES)))
def test_plan_fills_the_card_at_forward_shapes(n, p, c, dtype):
    """16-byte vectors; one wave of at most four blocks per SM of an H100
    and at least one per SM; 16 pixels a block row where that fits; every
    pixel covered by exactly one block and no block empty."""
    plan = gn_plan(n, p, c, dtype)
    assert plan.vec == 16 // torch.empty((), dtype=dtype).element_size()
    assert 132 <= plan.blocks <= GRID_BLOCKS
    if 132 * plan.rows * 16 <= n * p <= GRID_BLOCKS * plan.rows * 16:
        assert plan.pixels == plan.rows * 16
    s, k = plan.per_sample, plan.pixels
    assert (s - 1) * k < p <= s * k and plan.blocks == n * s
    assert plan.rows * (c // plan.vec) <= 256


def test_plan_falls_back_to_scalars():
    """Unaligned tensors or widths that 16 bytes do not divide take one
    channel a thread; past 256 such channels the kernels refuse."""
    assert gn_plan(8, 100, 48, torch.bfloat16, aligned=False).vec == 1
    assert gn_plan(8, 100, 12, torch.bfloat16).vec == 1
    assert gn_plan(8, 100, 4, torch.float32).vec == 4
    with pytest.raises(ValueError, match="at most"):
        gn_plan(8, 100, 384, torch.bfloat16, aligned=False)
