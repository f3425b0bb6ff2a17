"""The port's fused level-block chain (image_denoising_tpu_torch/ops/fused_block.py)
against the JAX Pallas kernel run in interpret mode, as
tests/test_fused_block_pallas.py runs it.

On the CPU the port's wrapper takes its plain PyTorch version; the CUDA
kernel is held against that plain version on the card in
tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as nn

from image_denoising_tpu.models.improved_unet import RDB as JaxRDB
from image_denoising_tpu.models.layers import Conv, leaky_relu
from image_denoising_tpu.ops.fused_block_pallas import (
    FusedChainWeights as JaxChainWeights,
    fused_rdb_chain as jax_fused_rdb_chain,
)
from image_denoising_tpu_torch.ckpt.pth_export import _conv_out, _rdb_out
from image_denoising_tpu_torch.models.improved_unet import RDB, ResBlock
from image_denoising_tpu_torch.ops.fused_block import (
    FusedChainWeights,
    fused_rdb_chain,
)

from _torch_port_helpers import one_torch_thread  # noqa: F401


class _LevelHead(nn.Module):
    """lead conv → LReLU → RDB → ResBlock-conv0 (the fused chain's scope)."""

    nf: int

    @nn.compact
    def __call__(self, x):
        x = leaky_relu(Conv(self.nf, init="torch", name="lead")(x))
        x = JaxRDB(self.nf, name="rdb")(x)
        c0 = Conv(self.nf, use_bias=False, init="torch", name="res_c0")(x)
        return x, c0


class _Bottle(nn.Module):
    nf: int

    @nn.compact
    def __call__(self, x):
        return JaxRDB(self.nf, name="rdb")(x)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _state_dict(params, lead: bool, res0: bool):
    sd = {}
    if lead:
        _conv_out(sd, "lead", params["lead"])
    _rdb_out(sd, "rdb", params["rdb"])
    if res0:
        _conv_out(sd, "res.block.0", params["res_c0"])
    return sd


@pytest.fixture(scope="module")
def head_cases():
    """lead Cin → (x, JAX params, the port's state dict): Cin 2 is the
    grayscale network's first level (in_nc 1 and the noise estimate), 4 RGB
    mode's (in_nc 3)."""
    made = {}

    def case_of(cin):
        if cin not in made:
            rng = np.random.default_rng(11)
            x = rng.standard_normal((2, 16, 24, cin)).astype(np.float32)
            m = _LevelHead(nf=16)
            params = _np_tree(jax.jit(m.init)(jax.random.PRNGKey(0), x)["params"])
            jp = dict(params)
            jp["res_fake"] = {"conv0": {"conv": {"kernel": params["res_c0"]["conv"]["kernel"]}}}
            made[cin] = x, jp, _state_dict(params, lead=True, res0=True)
        return made[cin]

    return case_of


@pytest.mark.parametrize("cin", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chain_with_lead_and_res0_matches_pallas(head_cases, dtype, cin):
    x, jp, sd = head_cases(cin)
    jdt = getattr(jnp, dtype)
    jwts = JaxChainWeights(jp, lead="lead", rdb="rdb", res="res_fake", dtype=jdt)
    ref_rdb, ref_c0 = jax_fused_rdb_chain(jnp.asarray(x, jdt), jwts,
                                          compute_dtype=jdt, interpret=True)
    tdt = getattr(torch, dtype)
    wts = FusedChainWeights.from_state_dict(sd, lead="lead", rdb="rdb",
                                            res="res", dtype=tdt)
    out_rdb, out_c0 = fused_rdb_chain(torch.from_numpy(x).to(tdt), wts)
    assert out_rdb.dtype == tdt and out_rdb.shape == (2, 16, 24, 16)
    for out, ref in ((out_rdb, ref_rdb), (out_c0, ref_c0)):
        ref = np.asarray(ref, np.float32)
        # f32: summation order only. bf16: each stored value is rounded
        # once, as in the Pallas kernel; a rounding flip from another
        # summation order is one bf16 ulp (2^-8 relative) and can carry
        # through the chain: 4 ulps of the largest output
        atol = 2e-6 if dtype == "float32" else 4 * 2.0 ** -8 * np.abs(ref).max()
        np.testing.assert_allclose(out.float().numpy(), ref, atol=atol)


def test_bottleneck_chain_without_lead_matches_pallas():
    rng = np.random.default_rng(12)
    nf = 16
    x = rng.standard_normal((2, 16, 16, nf)).astype(np.float32)
    m = _Bottle(nf=nf)
    params = _np_tree(jax.jit(m.init)(jax.random.PRNGKey(1), x)["params"])
    jwts = JaxChainWeights(params, lead=None, rdb="rdb", res=None)
    ref = jax_fused_rdb_chain(jnp.asarray(x), jwts, s_rows=8, interpret=True)
    wts = FusedChainWeights.from_state_dict(
        _state_dict(params, lead=False, res0=False), lead=None, rdb="rdb")
    out = fused_rdb_chain(torch.from_numpy(x), wts)
    assert isinstance(out, torch.Tensor)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-6)


def test_weights_from_modules_equal_from_state_dict():
    torch.manual_seed(0)
    lead, rdb, res = torch.nn.Conv2d(3, 8, 3, padding=1), RDB(8), ResBlock(8)
    a = FusedChainWeights.from_modules(rdb, lead=lead, res=res)
    sd = {f"l.{k}": v for k, v in lead.state_dict().items()}
    sd.update({f"r.{k}": v for k, v in rdb.state_dict().items()})
    sd.update({f"s.{k}": v for k, v in res.state_dict().items()})
    b = FusedChainWeights.from_state_dict(sd, lead="l", rdb="r", res="s")
    for ta, tb in zip(a._tensors(), b._tensors()):
        assert torch.equal(ta, tb)
    assert a.lead_w.shape == (3, 3, 3, 8) and a.lff_w.shape == (8 + 128, 8)


def test_chain_matches_module_composition():
    """lead → LReLU → RDB → ResBlock conv0, as the port's modules run it."""
    torch.manual_seed(1)
    lead, rdb, res = torch.nn.Conv2d(2, 8, 3, padding=1), RDB(8), ResBlock(8)
    x = torch.rand(2, 2, 16, 16)
    with torch.no_grad():
        want_rdb = rdb(torch.nn.functional.leaky_relu(lead(x), 0.2))
        want_c0 = res.block[0](want_rdb)
        wts = FusedChainWeights.from_modules(rdb, lead=lead, res=res)
        got_rdb, got_c0 = fused_rdb_chain(x.permute(0, 2, 3, 1).contiguous(), wts)
    np.testing.assert_allclose(got_rdb.permute(0, 3, 1, 2).numpy(),
                               want_rdb.numpy(), atol=2e-6)
    np.testing.assert_allclose(got_c0.permute(0, 3, 1, 2).numpy(),
                               want_c0.numpy(), atol=2e-6)


def test_wrapper_rejects_bad_input_and_counts_no_cpu_launch():
    torch.manual_seed(2)
    wts = FusedChainWeights.from_modules(RDB(8))
    x = torch.rand(1, 8, 8, 8)
    before = fused_rdb_chain.launches
    fused_rdb_chain(x, wts)
    assert fused_rdb_chain.launches == before  # the plain path is no launch
    with pytest.raises(TypeError):
        fused_rdb_chain(x.half(), wts)
    with pytest.raises(ValueError):
        fused_rdb_chain(x[..., :4].contiguous(), wts)  # wrong channel count
    with pytest.raises(ValueError):
        fused_rdb_chain(x.to(torch.bfloat16), wts)  # weights are float32

