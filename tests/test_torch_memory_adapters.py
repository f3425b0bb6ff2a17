"""The port's adapters (adapters/{memory_adapters,output_adapter,wrappers}.py)
against the JAX package: state dicts through ``pth_export``, outputs of all
five memory variants and the output adapter, and the memory wrapper over an
ImprovedUNet base."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from image_denoising_tpu.adapters import (DenoiserWithMemoryAdapter as JaxMemWrapper,
                                          OutputAdapter as JaxOutputAdapter,
                                          build_memory_adapter as jax_build)
from image_denoising_tpu.ckpt.pth_export import params_to_state_dict as jax_sd
from image_denoising_tpu_torch.adapters import (DenoiserWithAdapter,
                                                DenoiserWithMemoryAdapter,
                                                OutputAdapter, build_memory_adapter)
from image_denoising_tpu_torch.ckpt import load_jax_params, params_to_state_dict
from image_denoising_tpu_torch.models import ImprovedUNet, make_fused_forward

from _torch_port_helpers import (one_torch_thread, seeded_improved_unet_params,  # noqa: F401
                                 seeded_params)

VARIANTS = ["memory_residual", "lowfreq_blend", "tone_curve", "hyper_gated",
            "hyper_gated_fft"]
HIDDEN = 8


def _inputs(seed, n=3, ps=24):
    """(noisy, base_out, mem_clean) NHWC in [0, 1]; base_out reaches a little
    past 1 so the clamps and the tone curve's edge are exercised."""
    rng = np.random.default_rng(seed)
    noisy = rng.random((n, ps, ps, 1), dtype=np.float32)
    base = np.clip(noisy + rng.normal(0, 0.1, noisy.shape), -0.05, 1.05).astype(np.float32)
    mem = rng.random((n, ps, ps, 1), dtype=np.float32)
    return noisy, base, mem


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _port_adapter(arch, params):
    mod = (OutputAdapter(1, HIDDEN) if arch == "output_adapter"
           else build_memory_adapter(arch, 1, HIDDEN))
    return load_jax_params(mod, params, arch=arch)


@pytest.mark.parametrize("arch", VARIANTS + ["output_adapter"])
def test_adapter_state_dict_and_output_match_jax(arch):
    noisy, base, mem = _inputs(1)
    if arch == "output_adapter":
        jmod, args = JaxOutputAdapter(in_channels=1, hidden_channels=HIDDEN), (noisy, base)
    else:
        jmod, args = jax_build(arch, 1, HIDDEN), (noisy, base, mem)
    params = seeded_params(jmod, *map(jnp.asarray, args), seed=2)
    want_sd = jax_sd(params, arch)
    got_sd = params_to_state_dict(params, arch)
    assert sorted(got_sd) == sorted(want_sd)
    for k in want_sd:
        np.testing.assert_array_equal(got_sd[k], want_sd[k], err_msg=k)
    mod = _port_adapter(arch, params)  # strict load
    assert sorted(mod.state_dict()) == sorted(want_sd)

    want = np.asarray(jmod.apply({"params": params}, *map(jnp.asarray, args)))
    with torch.no_grad():
        got = mod(*map(_nchw, args)).numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-3)


def _wrapper_setup(variant, seed=4):
    """JAX memory wrapper over an n_feature-8 ImprovedUNet, its seeded
    params, a float32 bank of 6 rows and 3 query tiles (2 of them bank rows)."""
    rng = np.random.default_rng(seed)
    ps, n_bank = 32, 6
    bank_noise = rng.random((n_bank, ps * ps), dtype=np.float32)
    bank_clean = rng.random((n_bank, ps, ps, 1), dtype=np.float32)
    sqn = np.sum(bank_noise ** 2, axis=1)
    tiles = np.concatenate([bank_noise[[4, 1]].reshape(2, ps, ps, 1),
                            rng.random((1, ps, ps, 1), dtype=np.float32)])
    unet, base_params = seeded_improved_unet_params(8, seed=seed)
    jwrap = JaxMemWrapper(base=unet, in_channels=1, hidden_channels=HIDDEN,
                          variant=variant)
    adapter_params = seeded_params(jax_build(variant, 1, HIDDEN),
                                   *[jnp.asarray(tiles)] * 3, seed=seed + 1)
    params = {"base": base_params, "adapter": adapter_params}
    bank = (bank_noise, bank_clean, sqn)
    return jwrap, params, bank, tiles


def _port_base(base_params, dtype=torch.float32):
    model = load_jax_params(ImprovedUNet(1, 1, 8), base_params).eval()
    return make_fused_forward(model, device="cpu", dtype=dtype)


@pytest.mark.parametrize("variant", ["hyper_gated_fft", "lowfreq_blend"])
def test_memory_wrapper_matches_jax(variant):
    jwrap, params, bank, tiles = _wrapper_setup(variant)
    want = np.asarray(jwrap.apply({"params": params}, jnp.asarray(tiles),
                                  *map(jnp.asarray, bank)))
    port = DenoiserWithMemoryAdapter(
        _port_base(params["base"]), _port_adapter(variant, params["adapter"]))
    tb = [torch.from_numpy(a) for a in bank]
    with torch.no_grad():
        got = port(_nchw(tiles), *tb).numpy().transpose(0, 2, 3, 1)
        # retrieval hoisted out: the same patches passed in (uint8 decoded)
        mem = _nchw(bank[1][[4, 1, 4]])
        hoisted = port(_nchw(tiles), mem_clean=mem).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # tiles 0 and 1 are bank rows 4 and 1: the hoisted call sees their
    # patches; tile 2 is random, and its nearest row is 4 in this draw
    np.testing.assert_array_equal(hoisted, got)


def test_output_wrapper_and_bf16_base():
    """DenoiserWithAdapter runs the output adapter on the detached base;
    with a bfloat16 base the memory adapter computes in float32."""
    jwrap, params, bank, tiles = _wrapper_setup("hyper_gated_fft")
    x = _nchw(tiles)
    out_adapter = OutputAdapter(1, HIDDEN)
    base = _port_base(params["base"])
    with torch.no_grad():
        got = DenoiserWithAdapter(base, out_adapter)(x)
        np.testing.assert_allclose(got.numpy(), out_adapter(x, base(x)).numpy(),
                                   atol=0)
        port = DenoiserWithMemoryAdapter(
            _port_base(params["base"], torch.bfloat16),
            _port_adapter("hyper_gated_fft", params["adapter"]))
        out = port(x, *[torch.from_numpy(a) for a in bank])
    assert out.dtype == torch.float32 and out.shape == x.shape
    assert torch.isfinite(out).all()
