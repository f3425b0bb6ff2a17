"""The port's ImprovedUNet (image_denoising_tpu_torch/models) against the JAX
ImprovedUNet on the same weights: the state-dict mapping, the per-conv module
forward, and the fused forward (plain chain on the CPU)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_denoising_tpu.ckpt.pth_export import (
    params_to_state_dict as jax_params_to_state_dict,
)
from image_denoising_tpu_torch.ckpt import load_jax_params, params_to_state_dict
from image_denoising_tpu_torch.models import ImprovedUNet, make_fused_forward

from _torch_port_helpers import one_torch_thread, seeded_improved_unet_params  # noqa: F401

NF = 8


@pytest.fixture(scope="module")
def case():
    """JAX params (numpy) and the JAX output on a seeded [2, 32, 32, 1] batch."""
    x = np.random.default_rng(5).random((2, 32, 32, 1)).astype(np.float32)
    jm, params = seeded_improved_unet_params(NF, seed=0)
    ref = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    model = load_jax_params(ImprovedUNet(in_nc=1, out_nc=1, n_feature=NF), params)
    return x, params, ref, model.eval()


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def test_state_dict_matches_jax_export_and_loads_strict(case):
    _, params, _, model = case
    ours = params_to_state_dict(params)
    theirs = jax_params_to_state_dict(params, "UNetImproved")
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    assert sorted(model.state_dict()) == sorted(theirs)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), theirs[k], err_msg=k)


def test_module_widths():
    m = ImprovedUNet(in_nc=1, out_nc=1, n_feature=48)
    assert [d[0].out_channels for d in m.downs] == [48, 96, 192, 384]
    assert m.bottle[0].lff.out_channels == 384
    assert [u.fuse.in_channels for u in m.ups] == [576, 288, 144, 72]
    assert [u.fuse.out_channels for u in m.ups] == [192, 96, 48, 24]
    assert m.final.in_channels == 25


@pytest.mark.parametrize("forward", ["module", "fused"])
def test_forward_matches_jax_apply(case, forward):
    x, _, ref, model = case
    if forward == "module":
        with torch.no_grad():
            out = model(_nchw(x))
    else:
        out = make_fused_forward(model, device="cpu")(_nchw(x))
    assert out.shape == (2, 1, 32, 32)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, atol=1e-5)


def test_indivisible_frame_raises(case):
    model = case[3]
    with pytest.raises(ValueError, match="divisible by 16"):
        model(torch.zeros(1, 1, 24, 32))


def test_other_arch_not_ported():
    """The other networks' layouts, refused until they were ported, now map
    as the JAX package's export does (tests/test_torch_networks.py holds
    them to it in full); an unknown arch raises."""
    from _torch_port_helpers import seeded_network_params

    for arch in ("UNet", "RESNET"):
        _, params = seeded_network_params(arch, NF, seed=6)
        want = jax_params_to_state_dict(params, arch)
        got = params_to_state_dict(params, arch=arch)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="unknown arch"):
        params_to_state_dict({}, arch="UNET")
