"""Training steps of the port's UNet against the JAX package: the N2N step
of the UNet (128² frames, so that the 64² sub-images divide by 32) and the
structure step of the blind-spot UNet (32² frames: XLA's float64
convolutions on the CPU take seconds a step at 64²), n_feature 8, from the
same weights on the same batches.

As in ``test_torch_structure_train.py``, the port's float32 structure step
is held to JAX's computed in float64; the N2N step is handed the selector
maps JAX draws, as in ``test_torch_n2n_train.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from image_denoising_tpu import train as jax_train
from image_denoising_tpu.models import UNet as JaxUNet
from image_denoising_tpu.ops.neighbor import generate_mask_pair as jax_mask_pair
from image_denoising_tpu_torch.ckpt import load_jax_params
from image_denoising_tpu_torch.models import UNet
from image_denoising_tpu_torch.ops.neighbor import generate_subimages
from image_denoising_tpu_torch.train import (create_train_state, make_n2n_train_step,
                                             make_structure_train_step)

from _torch_port_helpers import one_torch_thread, seeded_network_params  # noqa: F401

NF, LR = 8, 3e-4


def _batches(frame, n, seed):
    """``n`` (clean, noisy) batches of two frame² frames in [0, 255]."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        clean = rng.integers(0, 256, (2, frame, frame, 1)).astype(np.float32)
        noisy = np.clip(clean + rng.normal(0, 25, clean.shape), 0, 255).round()
        out.append((clean, noisy.astype(np.float32)))
    return out


def test_unet_n2n_step_matches_jax():
    """Two N2N steps (epochs 1-2) of UNet-8 on 128² frames from the same
    weights, no synthetic noise, the maps JAX draws: loss, loss_rec and
    loss_reg within rtol 1e-5 (float32 sums in another order), every
    parameter updated."""
    jm, params = seeded_network_params("UNet", NF, seed=50, size=128)
    state_j = jax_train.create_train_state(params, lr=LR)
    step_j = jax_train.make_n2n_train_step(jm.apply, noise_fn=None, increase_ratio=2.0,
                                           n_epoch=10, subsampler="xla")
    model = load_jax_params(UNet(1, 1, NF), params, arch="UNet")
    start = {k: v.clone() for k, v in model.state_dict().items()}
    state_t = create_train_state(model, lr=LR)

    def jax_selectors(seed, img):
        n, c, h, w = img.shape
        sels = [torch.from_numpy(np.array(s))
                for s in jax_mask_pair(jax.random.PRNGKey(seed), (n, h, w, c))]
        return (generate_subimages(img, sels[0]), generate_subimages(img, sels[1]),
                tuple(sels))

    step_t = make_n2n_train_step(model, state_t, noise_fn=None, increase_ratio=2.0,
                                 n_epoch=10, subsample=jax_selectors)
    for epoch, (clean, noisy) in enumerate(_batches(128, 2, seed=51), start=1):
        state_j, m_j = step_j(state_j, jnp.asarray(clean), jnp.asarray(noisy),
                              jax.random.PRNGKey(epoch), jnp.asarray(epoch, jnp.int32))
        m_t = step_t(clean, noisy, epoch, epoch)
        for k in ("loss", "loss_rec", "loss_reg"):
            np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-5, err_msg=k)
    assert int(state_t.step) == int(state_j.step) == 2
    for k, v in model.state_dict().items():
        assert not torch.equal(v, start[k]), k


def test_blindspot_unet_structure_step_matches_jax():
    """Two structure steps of the blind-spot UNet-8 (batch 2 of 32², one
    fused batch-4 forward of 16 rotated frames) in float32 against JAX's in
    float64: loss and l1 within rtol 1e-5 at every step; the
    topology is the blind-spot one (``nin_a`` takes 96·4 channels)."""
    jm, params = seeded_network_params("UNet", NF, seed=52, blindspot=True, size=32)
    model = load_jax_params(UNet(1, 1, NF, blindspot=True), params, arch="UNet")
    assert model.nin_a.weight.shape == (384, 384, 1, 1)
    state_t = create_train_state(model, lr=LR)
    step_t = make_structure_train_step(model, state_t)
    batches = _batches(32, 2, seed=53)
    got = [step_t(c, n) for c, n in batches]
    got = np.array([[float(m["loss"]), float(m["l1"])] for m in got])
    with jax.enable_x64():
        p64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), params)
        state_j = jax_train.create_train_state(p64, lr=LR)
        step_j = jax_train.make_structure_train_step(jm.apply)
        want = []
        for clean, noisy in batches:
            state_j, m_j = step_j(state_j, jnp.asarray(clean), jnp.asarray(noisy))
            want.append([float(m_j["loss"]), float(m_j["l1"])])
    np.testing.assert_allclose(got, np.array(want), rtol=1e-5)
    assert int(state_t.step) == 2 and np.all(got[:, 1] < got[:, 0])
