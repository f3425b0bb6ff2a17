"""The port's finetune steps (train/finetune_steps.py) against the JAX
package's: three steps of ``make_memory_finetune_step`` for each of the five
memory-adapter variants with a float32 and an int8/uint8 bank, and of
``make_adapter_finetune_step`` with and without IQSL, from the same seeded
weights on the same three batches of 3 (the size of a tail batch of the
CLIs' batch 4). Each step's four losses agree within 1e-4 relative, the
adapter's parameters after the three steps within 1e-5·max(1, |p|), and the
base is left as it was.

Both packages run float32 here. The adapters' gradients pass no LeakyReLU or
max-pool kink of the base (the base is frozen), so the float64 comparison of
``tests/test_torch_structure_train.py`` is not needed."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from image_denoising_tpu.adapters import (DenoiserWithAdapter as JaxAdapterWrapper,
                                          DenoiserWithMemoryAdapter as JaxMemWrapper,
                                          OutputAdapter as JaxOutputAdapter,
                                          build_memory_adapter as jax_build)
from image_denoising_tpu.ckpt.pth_export import params_to_state_dict as jax_sd
from image_denoising_tpu.memory import build_memory_bank as jax_bank
from image_denoising_tpu.train import create_train_state as jax_state
from image_denoising_tpu.train.finetune_steps import (
    make_adapter_finetune_step as jax_adapter_step,
    make_memory_finetune_step as jax_memory_step)
from image_denoising_tpu_torch.adapters import (DenoiserWithAdapter,
                                                DenoiserWithMemoryAdapter,
                                                OutputAdapter, build_memory_adapter)
from image_denoising_tpu_torch.ckpt import load_jax_params
from image_denoising_tpu_torch.memory import build_memory_bank
from image_denoising_tpu_torch.models import ImprovedUNet, make_fused_forward
from image_denoising_tpu_torch.train import (create_train_state,
                                             make_adapter_finetune_step,
                                             make_memory_finetune_step)

from _torch_port_helpers import (one_torch_thread, seeded_improved_unet_params,  # noqa: F401
                                 seeded_params)

VARIANTS = ["memory_residual", "lowfreq_blend", "tone_curve", "hyper_gated",
            "hyper_gated_fft"]
PS, HIDDEN, LR = 64, 16, 1e-4
BATCHES = (3, 3, 3)  # a tail batch size of the CLIs' batch 4; one JAX compile
IQSL = {"t1": 0.35, "t2": 0.65, "tau": 0.1, "margin": 0.0, "ce_factor": 0.5}
LOSS_RTOL = 1e-4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """3 seeded 96² uint8 pairs on disk (the bank: stride 16, 9 patches
    each), the frozen base (ImprovedUNet-8, seeded) in both packages, and 3
    batches of 64² crops in [0,1]: batch 0 holds two bank patches."""
    from PIL import Image

    root = tmp_path_factory.mktemp("ftdata")
    rng = np.random.default_rng(21)
    yy, xx = np.mgrid[0:96, 0:96]
    paths = {"clean": [], "noise": []}
    frames = []
    for i in range(3):
        clean = np.clip(120 + 60 * np.sin(xx / (7.0 + i)) + 40 * np.cos(yy / 9.0),
                        0, 255).astype(np.uint8)
        noisy = np.clip(clean + rng.normal(0, 20, clean.shape), 0, 255).astype(np.uint8)
        frames.append((clean, noisy))
        for sub, a in (("clean", clean), ("noise", noisy)):
            (root / sub).mkdir(exist_ok=True)
            p = str(root / sub / f"s{i}.png")
            Image.fromarray(a).save(p)
            paths[sub].append(p)
    batches = []
    for b in BATCHES:
        idx = rng.integers(0, 3, b)
        tops, lefts = rng.integers(0, 33, b), rng.integers(0, 33, b)
        if not batches:
            tops[:2], lefts[:2] = (16, 32), (32, 0)  # on the stride-16 grid
        crop = [(frames[i][0][t:t + PS, l:l + PS], frames[i][1][t:t + PS, l:l + PS])
                for i, t, l in zip(idx, tops, lefts)]
        batches.append(tuple(np.stack([c[k] for c in crop])[..., None].astype(np.float32)
                             / np.float32(255.0) for k in (0, 1)))
    unet, base_params = seeded_improved_unet_params(8, seed=23)
    base = load_jax_params(ImprovedUNet(1, 1, 8), base_params).eval()
    return dict(paths=paths, batches=batches, unet=unet, base_params=base_params,
                base=base, base_fwd=make_fused_forward(base, device="cpu"))


def _run_both(jax_step, jstate, jargs, port_step, pargs, batches):
    """Three steps in each package: [(port losses, JAX losses)] per step and
    the JAX adapter params after them."""
    out = []
    for clean, noisy in batches:
        jstate, jm = jax_step(jstate, *jargs[:1], jnp.asarray(clean), jnp.asarray(noisy),
                              *jargs[1:])
        pm = port_step(clean, noisy, *pargs)
        keys = ("loss", "l1", "grad", "iqsl")
        out.append(([float(pm[k]) for k in keys], [float(jm[k]) for k in keys]))
    return out, jstate.params


def _check(out, jparams, adapter, arch, base, base_before):
    for i, (got, want) in enumerate(out):
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, err_msg=f"step {i + 1}")
    want_sd = jax_sd(jparams, arch)
    for k, v in adapter.state_dict().items():
        w = np.asarray(want_sd[k])
        np.testing.assert_allclose(v.numpy(), w, rtol=0,
                                   atol=1e-5 * max(1.0, float(np.abs(w).max())), err_msg=k)
    for k, v in base.state_dict().items():
        assert torch.equal(v, base_before[k]), k
    assert all(p.grad is None for p in base.parameters())


@pytest.mark.parametrize("bank_dtype", ["float32", "int8"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_memory_finetune_step_matches_jax(setup, variant, bank_dtype):
    """Losses (L1, gradient, IQSL at λ 0.1, total) of each step and the
    adapter after 3 steps; the int8 bank with a uint8 clean store, the
    production preset."""
    clean_dtype = "uint8" if bank_dtype == "int8" else "float32"
    kw = dict(patch_size=PS, stride=16, bank_dtype=bank_dtype, clean_dtype=clean_dtype)
    jb = jax_bank(setup["paths"]["clean"], setup["paths"]["noise"], **kw)
    pb = build_memory_bank(setup["paths"]["clean"], setup["paths"]["noise"], **kw,
                           device="cpu")
    np.testing.assert_array_equal(pb.noise_flat.numpy(), np.asarray(jb.noise_flat))
    x = jnp.zeros((2, PS, PS, 1), jnp.float32)
    adapter_params = seeded_params(jax_build(variant, 1, HIDDEN), x, x, x, seed=24)
    jwrap = JaxMemWrapper(base=setup["unet"], in_channels=1, hidden_channels=HIDDEN,
                          variant=variant)
    jstep = jax_memory_step(jwrap.apply, lambda_grad=0.1, lambda_iqsl=0.1, iqsl_cfg=IQSL)
    adapter = load_jax_params(build_memory_adapter(variant, 1, HIDDEN), adapter_params,
                              arch=variant)
    state = create_train_state(adapter, lr=LR)
    step = make_memory_finetune_step(DenoiserWithMemoryAdapter(setup["base_fwd"], adapter),
                                     state, lambda_grad=0.1, lambda_iqsl=0.1, iqsl_cfg=IQSL)
    before = {k: v.clone() for k, v in setup["base"].state_dict().items()}
    out, jparams = _run_both(
        jstep, jax_state(adapter_params, lr=LR),
        (setup["base_params"], jb.noise_flat, jb.clean, jb.sq_norms),
        step, (pb.noise_flat, pb.clean, pb.sq_norms), setup["batches"])
    assert int(state.step) == 3
    _check(out, jparams, adapter, variant, setup["base"], before)


@pytest.mark.parametrize("lambda_iqsl", [0.0, 0.1])
def test_adapter_finetune_step_matches_jax(setup, lambda_iqsl):
    """The output adapter over the frozen base: plain (finetune.py) and with
    IQSL (finetune_iqsl.py)."""
    x = jnp.zeros((2, PS, PS, 1), jnp.float32)
    adapter_params = seeded_params(JaxOutputAdapter(in_channels=1, hidden_channels=HIDDEN),
                                   x, x, seed=25)
    jwrap = JaxAdapterWrapper(base=setup["unet"], in_channels=1, hidden_channels=HIDDEN)
    jstep = jax_adapter_step(jwrap.apply, lambda_grad=0.1, lambda_iqsl=lambda_iqsl,
                             iqsl_cfg=IQSL)
    adapter = load_jax_params(OutputAdapter(1, HIDDEN), adapter_params, arch="output_adapter")
    state = create_train_state(adapter, lr=LR)
    step = make_adapter_finetune_step(DenoiserWithAdapter(setup["base_fwd"], adapter), state,
                                      lambda_grad=0.1, lambda_iqsl=lambda_iqsl,
                                      iqsl_cfg=IQSL)
    before = {k: v.clone() for k, v in setup["base"].state_dict().items()}
    out, jparams = _run_both(jstep, jax_state(adapter_params, lr=LR), (setup["base_params"],),
                             step, (), setup["batches"])
    if lambda_iqsl == 0.0:
        assert all(got[3] == want[3] == 0.0 for got, want in out)
    _check(out, jparams, adapter, "output_adapter", setup["base"], before)
