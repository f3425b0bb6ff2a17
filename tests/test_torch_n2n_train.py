"""The port's N2N training modules against the JAX package: loss, noise,
schedules, dataset batching, Adam, and the whole step.

The step runs both packages from the same weights and batches, with the
selector maps that JAX draws from the step key: the port's sub-sampler draws
with Philox, JAX with ``jax.random``, so the step is handed JAX's maps."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_denoising_tpu import train as jax_train
from image_denoising_tpu.data.pairs import DenoiseDataset as JaxDenoiseDataset
from image_denoising_tpu.losses import l1_loss as jax_l1, l2_loss as jax_l2
from image_denoising_tpu.losses import n2n_regularized_loss as jax_n2n_loss
from image_denoising_tpu.ops import AugmentNoise as JaxAugmentNoise
from image_denoising_tpu.ops.neighbor import generate_mask_pair as jax_mask_pair
from image_denoising_tpu_torch.ckpt import load_jax_params, params_to_state_dict
from image_denoising_tpu_torch.data import DenoiseDataset
from image_denoising_tpu_torch.losses import l1_loss, l2_loss, n2n_regularized_loss
from image_denoising_tpu_torch.models import ImprovedUNet
from image_denoising_tpu_torch.ops import AugmentNoise
from image_denoising_tpu_torch.ops.neighbor import generate_subimages
from image_denoising_tpu_torch.train import (
    create_train_state,
    hpo_milestones,
    make_n2n_train_step,
    multistep_lr,
    reference_milestones,
    set_learning_rate,
)

from _torch_port_helpers import one_torch_thread, seeded_improved_unet_params  # noqa: F401

STYLES = ["gauss25", "gauss5_50", "poisson30", "poisson5_50"]


@pytest.mark.parametrize("lam,l1,l2", [(0.0, 1.0, 1.0), (0.6, 1.0, 1.0), (1.5, 0.7, 2.0)])
def test_n2n_loss_equals_jax(lam, l1, l2):
    rng = np.random.default_rng(1)
    args = [rng.random((2, 8, 8, 1), dtype=np.float32) for _ in range(4)]
    want, (w1, w2) = jax_n2n_loss(*map(jnp.asarray, args), lam, lambda1=l1, lambda2=l2)
    got, (g1, g2) = n2n_regularized_loss(*map(torch.from_numpy, args), lam,
                                         lambda1=l1, lambda2=l2)
    for g, w in ((got, want), (g1, w1), (g2, w2)):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)


def test_n2n_loss_detaches_the_denoised_difference():
    x = torch.rand(1, 1, 4, 4, requires_grad=True)
    d1 = torch.rand(1, 1, 4, 4, requires_grad=True)
    d2 = torch.rand(1, 1, 4, 4, requires_grad=True)
    total, _ = n2n_regularized_loss(x, torch.rand(1, 1, 4, 4), d1, d2, 1.0)
    total.backward()
    assert x.grad is not None and d1.grad is None and d2.grad is None


def test_pixel_losses_equal_jax():
    rng = np.random.default_rng(2)
    a, b = (rng.random((2, 6, 6, 1), dtype=np.float32) for _ in range(2))
    for ours, theirs in ((l1_loss, jax_l1), (l2_loss, jax_l2)):
        np.testing.assert_allclose(float(ours(torch.from_numpy(a), torch.from_numpy(b))),
                                   float(theirs(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)


def _noise_stats(style, noisy, x0):
    """Check one batch of train noise against the style's distribution; the
    clean frame is the constant x0. Returns per-sample (mean, std)."""
    b = noisy.shape[0]
    per = noisy.reshape(b, -1)
    mean, std = per.mean(1), per.std(1)
    kind = "gauss" if style.startswith("gauss") else "poisson"
    params = [float(p) for p in style[len(kind):].split("_")]
    if kind == "gauss":
        sig = np.array(params) / 255.0
        assert np.all(np.abs(mean - x0) < 4 * sig.max() / np.sqrt(per.shape[1]))
        if len(sig) == 1:
            np.testing.assert_allclose(std, sig[0], rtol=0.05)
        else:
            assert np.all((std > 0.95 * sig[0]) & (std < 1.05 * sig[1]))
    else:
        lam = np.array(params)
        np.testing.assert_allclose(mean, x0, rtol=0.02)
        if len(lam) == 1:   # Poisson(λx)/λ: variance x/λ
            np.testing.assert_allclose(std ** 2, x0 / lam[0], rtol=0.1)
        else:
            assert np.all((std ** 2 > 0.9 * x0 / lam[1]) & (std ** 2 < 1.1 * x0 / lam[0]))
    if len(params) == 2:  # one parameter per sample: the samples differ
        assert std.max() > 1.2 * std.min()
    return mean, std


@pytest.mark.parametrize("style", STYLES)
def test_train_noise_statistics(style):
    """The port's and JAX's train noise both follow the style: mean and
    standard deviation of 8 samples of 64² around x = 0.5."""
    x0 = 0.5
    x = np.full((8, 64, 64, 1), x0, np.float32)
    gen = torch.Generator().manual_seed(3)
    ours = AugmentNoise(style).add_train_noise(
        gen, torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert ours.dtype == np.float32 and ours.shape == (8, 1, 64, 64)
    theirs = np.asarray(JaxAugmentNoise(style).add_train_noise(jax.random.PRNGKey(3),
                                                               jnp.asarray(x)))
    _noise_stats(style, ours, x0)
    _noise_stats(style, theirs, x0)


@pytest.mark.parametrize("style", STYLES)
def test_valid_noise_bit_equal_to_jax(style):
    x = np.random.default_rng(4).random((16, 16, 1), dtype=np.float32)
    np.random.seed(11)
    want = JaxAugmentNoise(style).add_valid_noise(x)
    np.random.seed(11)
    got = AugmentNoise(style).add_valid_noise(x)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_unknown_noise_style_raises():
    with pytest.raises(ValueError, match="unknown noise style"):
        AugmentNoise("speckle10")


def test_schedules_equal_jax():
    for n_epoch in range(1, 201):
        ms = reference_milestones(n_epoch)
        assert ms == jax_train.reference_milestones(n_epoch)
        assert hpo_milestones(n_epoch) == jax_train.hpo_milestones(n_epoch)
        for epoch in range(1, n_epoch + 1):
            assert (multistep_lr(3e-4, ms, 0.5, epoch)
                    == jax_train.multistep_lr(3e-4, ms, 0.5, epoch))


@pytest.fixture(scope="module")
def pair_dir(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("pairs")
    rng = np.random.default_rng(6)
    for sub in ("clean", "noise"):
        (root / sub).mkdir()
    for i in range(7):
        for sub in ("clean", "noise"):
            Image.fromarray(rng.integers(0, 256, (16, 12)).astype(np.uint8)).save(
                root / sub / f"f{i:02d}.png")
    return str(root)


@pytest.mark.parametrize("drop_last", [True, False])
def test_dataset_batches_equal_jax(pair_dir, drop_last):
    ours, theirs = DenoiseDataset(pair_dir), JaxDenoiseDataset(pair_dir)
    assert len(ours) == len(theirs) == 7
    got = list(ours.batches(3, np.random.default_rng(5), drop_last=drop_last))
    want = list(theirs.batches(3, np.random.default_rng(5), drop_last=drop_last))
    assert len(got) == len(want) == (2 if drop_last else 3)
    for (gc, gn), (wc, wn) in zip(got, want):
        assert gc.dtype == np.float32 and gc.shape[1:] == (16, 12, 1)
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gn, wn)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adam_equals_optax(weight_decay):
    """torch Adam = optax adam (and the coupled L2 chain), learning rate set
    between steps as the trainer does per epoch."""
    rng = np.random.default_rng(7)
    w0 = rng.standard_normal((5, 3)).astype(np.float32)
    grads = [rng.standard_normal((5, 3)).astype(np.float32) for _ in range(3)]
    module = torch.nn.Module()
    module.w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    ours = create_train_state(module, lr=1e-2, weight_decay=weight_decay)
    theirs = jax_train.create_train_state({"w": jnp.asarray(w0)}, lr=1e-2,
                                          weight_decay=weight_decay)
    for i, g in enumerate(grads):
        lr = 1e-2 * 0.5 ** i
        set_learning_rate(ours, lr)
        theirs = jax_train.set_learning_rate(theirs, lr)
        module.w.grad = torch.from_numpy(g)
        ours.optimizer.step()
        theirs = theirs.apply_gradients({"w": jnp.asarray(g)})
        np.testing.assert_allclose(module.w.detach().numpy(), np.asarray(theirs.params["w"]),
                                   rtol=0, atol=1e-6)


FRAME = 64  # 32² sub-images: a 2×2 bottleneck (see _n2n_setup)


def _n2n_setup(n_epoch=10, lr=3e-4):
    """JAX and port N2N steps from one seeded ImprovedUNet-8 and batches of two
    64² frames. At 32² frames the 16² sub-images reach the bottleneck as
    1×1 maps, where each GroupNorm group holds 2 values and its gradient is
    ill-conditioned: float32 rounding alone moved the bottleneck gradients by
    3e-3 relative there, 7e-6 at 64²."""
    model_j, params = seeded_improved_unet_params(8, seed=12)
    state_j = jax_train.create_train_state(params, lr=lr)
    step_j = jax_train.make_n2n_train_step(model_j.apply, noise_fn=None,
                                           increase_ratio=2.0, n_epoch=n_epoch,
                                           subsampler="xla")
    model_t = load_jax_params(ImprovedUNet(1, 1, 8), params)
    state_t = create_train_state(model_t, lr=lr)

    def jax_selectors(seed, img):
        # without noise_fn the JAX step's mask key is the step key
        n, c, h, w = img.shape
        sels = [torch.from_numpy(np.array(s))
                for s in jax_mask_pair(jax.random.PRNGKey(seed), (n, h, w, c))]
        return (generate_subimages(img, sels[0]), generate_subimages(img, sels[1]),
                tuple(sels))

    step_t = make_n2n_train_step(model_t, state_t, noise_fn=None, increase_ratio=2.0,
                                 n_epoch=n_epoch, subsample=jax_selectors)
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(3):
        clean = rng.integers(0, 256, (2, FRAME, FRAME, 1)).astype(np.float32)
        noisy = np.clip(clean + rng.normal(0, 25, clean.shape), 0, 255).round()
        batches.append((clean, noisy.astype(np.float32)))
    return model_j, params, state_j, step_j, model_t, state_t, step_t, batches


def _state_dict_np(tree):
    return params_to_state_dict(jax.tree_util.tree_map(np.asarray, tree))


def test_n2n_step_matches_jax():
    """Three steps (epochs 1-3, Λ = 0.2, 0.4, 0.6) from the same weights, no
    synthetic noise, the maps JAX draws.

    Tolerances, with the readings of this seed:
    - losses rtol 1e-5 at every step (readings ≤ 1.8e-6): float32 sums in
      another order;
    - after step 1 every weight within atol 1e-6 of JAX's, except where the
      port's gradient is below 1e-6 in magnitude (118 of 1,178,975 weights):
      there Adam's g/(√v̂ + 1e-8) turns a rounding-level gradient difference
      into an update difference of up to 2·lr;
    - after step 3 each tensor's change from the start within 5 % of JAX's,
      in norm (readings ≤ 2.4 %). Through those weights and through units
      that sit within rounding of a LeakyReLU or max-pool kink, float32
      rounding gives the two packages gradients a few percent apart at
      later steps, and Adam's normalisation passes that on to the update;
      elementwise, 59 % of the weights differ by more than 1e-6 after 3
      steps while the losses agree to 2e-6."""
    lr = 3e-4
    _, params, state_j, step_j, model_t, state_t, step_t, batches = _n2n_setup(lr=lr)
    start = _state_dict_np(params)
    for epoch, (clean, noisy) in enumerate(batches, start=1):
        state_j, m_j = step_j(state_j, jnp.asarray(clean), jnp.asarray(noisy),
                              jax.random.PRNGKey(epoch), jnp.asarray(epoch, jnp.int32))
        m_t = step_t(clean, noisy, epoch, epoch)
        for k in ("loss", "loss_rec", "loss_reg"):
            np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-5, err_msg=k)
        assert float(m_t["loss_reg"]) > 0
        want = _state_dict_np(state_j.params)
        got = {k: v.numpy() for k, v in model_t.state_dict().items()}
        assert sorted(got) == sorted(want)
        for k, p in model_t.named_parameters():
            diff = np.abs(got[k] - want[k])
            if epoch == 1:
                off = diff > 1e-6
                assert np.all(np.abs(p.grad.numpy()[off]) < 1e-6), (k, diff.max())
                assert np.all(diff <= 2 * lr), (k, diff.max())
            elif epoch == 3:
                moved = np.linalg.norm(want[k] - start[k])
                assert np.linalg.norm(got[k] - want[k]) <= 0.05 * moved, k
    assert state_t.step == 3 and int(state_j.step) == 3


def test_n2n_gradients_match_jax():
    """The port's backward against jax.grad of the JAX step's loss
    (steps.py:165-175) at the same weights, batch, maps and Λ: every
    parameter's gradient within 1e-4 of JAX's, relative to its norm
    (readings up to 7.3e-6)."""
    from image_denoising_tpu.ops.neighbor import generate_subimages as jgs

    model_j, params, _, _, model_t, _, step_t, batches = _n2n_setup()
    clean, noisy = batches[0]
    lam = 0.2  # epoch 1 of 10, increase_ratio 2
    x = jnp.asarray(noisy) / 255.0
    s1, s2 = jax_mask_pair(jax.random.PRNGKey(1), x.shape)

    def loss_fn(p):
        den = jax.lax.stop_gradient(model_j.apply({"params": p}, x))
        pred = model_j.apply({"params": p}, jgs(x, s1))
        return jax_n2n_loss(pred, jgs(x, s2), jgs(den, s1), jgs(den, s2), lam)[0]

    want = _state_dict_np(jax.jit(jax.grad(loss_fn))(params))
    step_t(clean, noisy, 1, 1)  # the gradients stay on the parameters
    for k, p in model_t.named_parameters():
        g = p.grad.numpy()
        assert np.linalg.norm(g - want[k]) <= 1e-4 * np.linalg.norm(want[k]), k


def test_n2n_step_with_noise_learns_and_uses_the_kernel_wrapper():
    """With synthetic noise (the CLI's form) the default sub-sampler is the
    kernel's wrapper; on CPU tensors it runs the plain version and launches
    nothing. The same seed gives the same loss, and on one batch with one
    seed (the same noise and maps every step) the loss falls."""
    from image_denoising_tpu_torch.ops.neighbor import subsample_pair_fused

    clean = np.random.default_rng(8).integers(0, 256, (2, 32, 32, 1)).astype(np.float32)

    def losses(n):
        torch.manual_seed(0)
        model = ImprovedUNet(1, 1, 8)
        state = create_train_state(model, lr=1e-3)
        step = make_n2n_train_step(model, state, noise_fn=AugmentNoise("gauss25").add_train_noise)
        return [float(step(clean, None, 100, 1)["loss"]) for _ in range(n)]

    before = subsample_pair_fused.launches
    first = losses(5)
    assert subsample_pair_fused.launches == before
    assert losses(2) == first[:2]
    assert np.all(np.isfinite(first)) and first[-1] < first[0]
