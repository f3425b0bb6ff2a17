"""The port's structure-loss trainer against the JAX package: the pixel
losses, the f32 and bf16 steps, the fused forward, remat, the bad-batch
guard and the resumable train state.

ImprovedUNet-8 at batch 2 of 64² frames (at 32² the 2×2 bottleneck's
GroupNorm groups make gradients ill-conditioned, ROADMAP.md §3), JAX
weights from ``seeded_improved_unet_params``. The file compiles three JAX
step programs (the structure step in float64 and with bf16 compute, the
guarded L1 step) and one gradient.

The port's float32 step is held to the JAX package's step computed in
float64 (``jax.enable_x64``): at this width JAX's own float32 gradient
reads 6e-3 to 3.3e-2 away from its float64 one in a few RDB convs, a unit
within its float32 rounding of a LeakyReLU or max-pool kink (the L1 terms
send every pixel a gradient of the same size, so one such unit moves a
bias's sum), while the two packages' float64 gradients agree to 2e-14."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_denoising_tpu import train as jax_train
from image_denoising_tpu.losses import gradient_loss as jax_gradient_loss
from image_denoising_tpu.losses import l1fft_loss as jax_l1fft_loss
from image_denoising_tpu.losses import structure_loss as jax_structure_loss
from image_denoising_tpu.models import ImprovedUNet as JaxImprovedUNet
from image_denoising_tpu_torch.ckpt import (load_jax_params, params_to_state_dict,
                                            restore_train_state, save_train_state)
from image_denoising_tpu_torch.losses import gradient_loss, l1fft_loss, structure_loss
from image_denoising_tpu_torch.models import ImprovedUNet
from image_denoising_tpu_torch.train import (create_train_state, make_l1_train_step,
                                             make_structure_train_step)

from _torch_port_helpers import one_torch_thread, seeded_improved_unet_params  # noqa: F401

FRAME, NF, LR = 64, 8, 3e-4
# a batch at which the port's float32 gradients meet no kink
# (test_structure_gradients_match_jax)
GRAD_SEED = 41


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("name", ["structure", "l1fft", "gradient"])
def test_pixel_losses_equal_jax(name):
    rng = np.random.default_rng(31)
    a, b, c = (rng.random((2, 12, 10, 1), dtype=np.float32) for _ in range(3))
    if name == "structure":
        args, kw = (a, b, c), dict(alpha=0.7, beta=0.3, gamma=1.5)
        ours, theirs = structure_loss, jax_structure_loss
    elif name == "l1fft":
        args, kw = (a, b), dict(alpha=0.6, beta=0.2)
        ours, theirs = l1fft_loss, jax_l1fft_loss
    else:
        args, kw = (a, b), {}
        ours, theirs = gradient_loss, jax_gradient_loss
    want = float(theirs(*map(jnp.asarray, args), **kw))
    got = float(ours(*map(_nchw, args), **kw))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _batches(n=3, seed=36):
    """``n`` (clean, noisy) batches of two 64² frames of uniform random
    levels, noisy = clean + N(0, 25), clipped, [0,255] floats. On smooth
    frames neighbouring features come within float32 rounding of each
    other, and a max-pool window then routes its gradient to another pixel
    in each package (gradients 6e-3 apart at this width)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        clean = rng.integers(0, 256, (2, FRAME, FRAME, 1)).astype(np.float32)
        noisy = np.clip(clean + rng.normal(0, 25, clean.shape), 0, 255).round()
        out.append((clean, noisy.astype(np.float32)))
    return out


@pytest.fixture(scope="module")
def setup():
    """(JAX params, the 3 batches)."""
    _, params = seeded_improved_unet_params(NF, seed=32)
    return params, _batches()


def _port(params, **flags):
    model = load_jax_params(ImprovedUNet(1, 1, NF, **flags), params)
    return model, create_train_state(model, lr=LR)


def _state_dict_np(tree):
    return params_to_state_dict(jax.tree_util.tree_map(np.asarray, tree))


def _run(setup, bf16: bool):
    """Three structure steps of the port (float32, or bf16 compute) and of
    the JAX package (float64, or bf16 compute): the per-step (loss, l1) of
    each, and the port's model."""
    params, batches = setup
    model_t, state_t = _port(params, dtype=torch.bfloat16 if bf16 else None)
    step_t = make_structure_train_step(model_t, state_t)
    got = [step_t(clean, noisy) for clean, noisy in batches]
    got = np.array([[float(m["loss"]), float(m["l1"])] for m in got])
    with jax.enable_x64(not bf16):
        if not bf16:
            params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), params)
        model_j = JaxImprovedUNet(1, 1, NF, dtype=jnp.bfloat16 if bf16 else None)
        state_j = jax_train.create_train_state(params, lr=LR)
        step_j = jax_train.make_structure_train_step(model_j.apply)
        want = []
        for clean, noisy in batches:
            state_j, m_j = step_j(state_j, jnp.asarray(clean), jnp.asarray(noisy))
            want.append([float(m_j["loss"]), float(m_j["l1"])])
    assert int(state_j.step) == int(state_t.step) == 3 and int(state_t.skipped) == 0
    return got, np.array(want), model_t


@pytest.fixture(scope="module")
def f32_run(setup):
    return _run(setup, bf16=False)


def test_structure_step_matches_jax(f32_run):
    """Three float32 steps from the same weights on the same batches
    against JAX's step in float64: loss and l1 within rtol 1e-5 at every
    step (readings at most 3.2e-6)."""
    got, want, _ = f32_run
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert np.all(got[:, 1] < got[:, 0])


def test_structure_gradients_match_jax(setup):
    """The port's backward against jax.grad of the JAX step's fused loss
    (steps.py:80-92) at the same weights and batch, with JAX in float64:
    the port's float64 gradients equal JAX's within 1e-10 of each norm
    (readings 2e-14), its float32 ones within 1e-4 (readings 3.8e-6).

    The float32 reading depends on the batch: of 30 seeded batches, 6 read
    below 1e-4 and the rest 2.4e-4 to 1.4e-2, in a few biases and weights:
    a float32 forward carries ~1e-6 relative error through some 2.6 million
    units, so a few of them land on the other side of a LeakyReLU or
    max-pool kink than in float64, and the L1 terms give every pixel a
    gradient of the same size, which such a unit moves. JAX's float32
    gradient does the same (6e-3 to 3.3e-2 from its float64 one at the
    batches of the other tests). This test takes batch seed 41, one of the
    six."""
    params, _ = setup
    clean, noisy = _batches(1, seed=GRAD_SEED)[0]
    model_j = JaxImprovedUNet(1, 1, NF)

    def loss_fn(p, c, n):
        both = model_j.apply({"params": p}, jnp.concatenate([n / 255.0, c / 255.0], 0))
        return jax_structure_loss(both[:2], both[2:], c / 255.0)

    with jax.enable_x64():
        p64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), params)
        want = _state_dict_np(jax.jit(jax.grad(loss_fn))(
            p64, clean.astype(np.float64), noisy.astype(np.float64)))
    model_t, state_t = _port(params)
    make_structure_train_step(model_t, state_t)(clean, noisy)  # grads stay on the params
    model64 = load_jax_params(ImprovedUNet(1, 1, NF), params).double()
    c, n = (_nchw(a).double() / 255.0 for a in (clean, noisy))
    both = model64(torch.cat([n, c], 0))
    structure_loss(both[:2], both[2:], c).backward()
    for (k, p), p64_ in zip(model_t.named_parameters(), model64.parameters()):
        norm = np.linalg.norm(want[k])
        assert np.linalg.norm(p64_.grad.numpy() - want[k]) <= 1e-10 * norm, k
        assert np.linalg.norm(p.grad.numpy() - want[k]) <= 1e-4 * norm, k


def test_fused_forward_equals_two_forwards(setup):
    """One concatenated batch-4 forward against the literal two batch-2
    forwards (the reference's form): loss within 1e-6 and every gradient
    within atol 1e-6 (conv sums at another batch size); after the step
    every parameter within atol 1e-6, except where the gradient is below
    1e-6 in magnitude, where Adam's first step g/(|g| + 1e-8) can turn a
    rounding-level difference into up to 2·lr."""
    params, batches = setup
    clean, noisy = batches[1]
    runs = []
    for fused in (True, False):
        model, state = _port(params)
        m = make_structure_train_step(model, state, fused=fused)(clean, noisy)
        runs.append((float(m["loss"]), float(m["l1"]), dict(model.named_parameters())))
    (loss_f, l1_f, pf), (loss_s, l1_s, ps) = runs
    assert abs(loss_f - loss_s) < 1e-6 and abs(l1_f - l1_s) < 1e-6
    for k, p in pf.items():
        g, gs = p.grad.numpy(), ps[k].grad.numpy()
        np.testing.assert_allclose(g, gs, atol=1e-6, rtol=0, err_msg=k)
        diff = np.abs(p.detach().numpy() - ps[k].detach().numpy())
        assert np.all(np.abs(g[diff > 1e-6]) < 1e-6), (k, diff.max())
        assert np.all(diff <= 2 * LR), k


def test_bf16_structure_step_matches_jax(setup, f32_run):
    """Three steps with bfloat16 compute (float32 parameters) in both
    packages: loss and l1 within one bfloat16 rounding unit (2⁻⁸, relative)
    at every step. Each package rounds every conv output and activation to
    bfloat16, in its own order of sums; readings at most 1.1e-3. The bf16
    losses stay
    within the JAX package's own envelope of its f32 ones
    (tests/test_bf16_compute.py): 5e-3 at step 1, 0.15 relative after."""
    got, want, model = _run(setup, bf16=True)
    np.testing.assert_allclose(got, want, rtol=2.0 ** -8)
    assert model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    f32 = f32_run[0]
    assert abs(got[0, 0] - f32[0, 0]) < 5e-3
    assert np.all(np.abs(got[:, 0] - f32[:, 0]) / f32[:, 0] < 0.15)


def _jax_remat_blocks(remat, remat_depth):
    """The top-level JAX modules whose parameters enter a remat (jax.checkpoint)
    equation of the forward's jaxpr: what ``_blocks`` chose."""
    model = JaxImprovedUNet(1, 1, NF, remat=remat, remat_depth=remat_depth)
    x = jax.ShapeDtypeStruct((1, 32, 32, 1), np.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x)["params"]
    leaves, tree = jax.tree_util.tree_flatten_with_path(shapes)
    jaxpr = jax.make_jaxpr(lambda ls, x: model.apply(
        {"params": jax.tree_util.tree_unflatten(tree, ls)}, x))([v for _, v in leaves], x).jaxpr
    owner = {v: path[0].key for v, (path, _) in zip(jaxpr.invars, leaves)}
    return {owner[v] for e in jaxpr.eqns if e.primitive.name.startswith("remat")
            for v in e.invars if v in owner}


def _torch_name(jax_name):
    """JAX block name → the port's module name (reference layout)."""
    for kind, idx in (("rdb", 2), ("res", 3)):
        if jax_name.startswith("down") and jax_name.endswith(kind):
            return f"downs.{jax_name[4:-4]}.{idx}"
    return {"bottle_rdb": "bottle.0", "bottle_res": "bottle.1"}.get(
        jax_name, f"ups.{jax_name[2:]}")


@pytest.mark.parametrize("remat_depth", [None, 2])
def test_remat_recomputes_jax_blocks_with_equal_results(setup, remat_depth):
    """``remat=True`` (all levels, or the two highest-resolution ones):
    the blocks whose forward runs twice in forward+backward are the ones
    JAX's ``_blocks`` wraps in ``nn.remat``; loss and gradients equal those
    without remat (the same ops run again: atol 1e-7), and the state-dict
    keys do not change."""
    params, batches = setup
    clean, noisy = batches[2]
    runs = []
    for remat in (False, True):
        model, state = _port(params, remat=remat, remat_depth=remat_depth)
        blocks = {n: m for n, m in model.named_modules()
                  if n in {f"downs.{i}.{j}" for i in range(4) for j in (2, 3)}
                  | {"bottle.0", "bottle.1"} | {f"ups.{i}" for i in range(4)}}
        calls = dict.fromkeys(blocks, 0)
        for n, m in blocks.items():
            # a pre-hook: the recomputation stops once it has what backward needs
            m.register_forward_pre_hook(lambda *_, n=n: calls.__setitem__(n, calls[n] + 1))
        m_t = make_structure_train_step(model, state)(clean, noisy)
        runs.append((float(m_t["loss"]), model, {n for n, c in calls.items() if c == 2}))
        assert set(calls.values()) <= {1, 2}
    (loss0, model0, twice0), (loss1, model1, twice1) = runs
    assert twice0 == set() and _jax_remat_blocks(False, None) == set()
    want = {_torch_name(n) for n in _jax_remat_blocks(True, remat_depth)}
    assert twice1 == want and len(want) == (14 if remat_depth is None else 6)
    assert abs(loss0 - loss1) <= 1e-7
    assert list(model0.state_dict()) == list(model1.state_dict())
    for (k, p0), (_, p1) in zip(model0.named_parameters(), model1.named_parameters()):
        np.testing.assert_allclose(p1.grad.numpy(), p0.grad.numpy(), atol=1e-7, rtol=0,
                                   err_msg=k)
    fresh = ImprovedUNet(1, 1, NF)
    fresh.load_state_dict(model1.state_dict(), strict=True)


# below the gradient norm of these batches at this width (0.47), so the clip acts
GRAD_CLIP = 0.25


@pytest.fixture(scope="module")
def jax_l1_step():
    return jax_train.make_l1_train_step(JaxImprovedUNet(1, 1, NF).apply, guards=True,
                                        grad_clip=GRAD_CLIP)


def _adam_np(state_t):
    """The port's Adam moments and step counts as numpy, by parameter name."""
    names = {id(p): k for k, p in state_t.model.named_parameters()}
    return {(names[id(p)], key): v.numpy().copy()
            for p, s in state_t.optimizer.state.items() for key, v in s.items()}


@pytest.mark.parametrize("bad", ["nan", "loss_over_5"])
def test_guard_skips_bad_batches_as_jax(setup, jax_l1_step, bad):
    """``make_l1_train_step(guards=True, grad_clip=GRAD_CLIP)`` on a batch
    it takes, then a bad one (a NaN pixel, or targets of 10 that put the L1
    loss over 5), against JAX's step in float64. The good step: loss and
    grad_norm within rtol 1e-5 of JAX's, the norm above the clip so it
    acts, and the Adam moments, which hold the clipped gradients, within
    1e-4 of JAX's relative to their norm. The bad step: not ok in both packages, ``skipped`` = 1 and
    ``step`` = 1, and every parameter, moment and Adam step count bit-equal
    across it."""
    params, _ = setup
    clean, noisy = (b / 255.0 for b in _batches(1, seed=GRAD_SEED)[0])
    bad_clean = clean.copy()
    if bad == "nan":
        bad_clean[1, 5, 7, 0] = np.nan
    else:
        bad_clean[:] = 10.0
    model_t, state_t = _port(params)
    step_t = make_l1_train_step(model_t, state_t, guards=True, grad_clip=GRAD_CLIP)
    with jax.enable_x64():
        state_j = jax_train.create_train_state(
            jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), params), lr=LR)
        state_j, m_j = jax_l1_step(state_j, jnp.asarray(clean), jnp.asarray(noisy))
        m_j = {k: np.asarray(v) for k, v in m_j.items()}
    m_t = step_t(clean, noisy)
    assert bool(m_j["ok"]) and bool(m_t["ok"])
    np.testing.assert_allclose([float(m_t["loss"]), float(m_t["grad_norm"])],
                               [float(m_j["loss"]), float(m_j["grad_norm"])], rtol=1e-5)
    assert float(m_t["grad_norm"]) > GRAD_CLIP
    adam = state_j.opt_state.inner_state[0]
    for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        want = _state_dict_np(tree)
        for k, p in model_t.named_parameters():
            got = state_t.optimizer.state[p][key].numpy()
            assert np.linalg.norm(got - want[k]) <= 1e-4 * np.linalg.norm(want[k]), (key, k)

    before = ({k: p.detach().numpy().copy() for k, p in model_t.named_parameters()},
              _adam_np(state_t))
    with jax.enable_x64():
        state_j, m_j = jax_l1_step(state_j, jnp.asarray(bad_clean), jnp.asarray(noisy))
        m_j = {k: np.asarray(v) for k, v in m_j.items()}
    m_t = step_t(bad_clean, noisy)
    assert not bool(m_j["ok"]) and not bool(m_t["ok"])
    assert int(state_j.skipped) == int(state_t.skipped) == 1
    assert int(state_j.step) == int(state_t.step) == 1
    after = ({k: p.detach().numpy() for k, p in model_t.named_parameters()},
             _adam_np(state_t))
    for b, a in zip(before, after):
        assert b.keys() == a.keys()
        for k in b:
            np.testing.assert_array_equal(a[k].view(np.int32), b[k].view(np.int32),
                                          err_msg=str(k))


@pytest.mark.parametrize("guards", [False, True])
def test_resumed_step_equals_uninterrupted(setup, tmp_path, guards):
    """Two structure steps, ``save_train_state``, then a third: a fresh state
    restored from the file takes the same third step, bit for bit (loss,
    parameters, Adam state, counters). With guards, a skipped NaN batch is
    among the saved steps. The file is restored as one saved on the card
    would read (a ``capturable`` Adam): the CPU state keeps its own."""
    params, batches = setup

    def fresh():
        model, state = _port(params)
        return model, state, make_structure_train_step(model, state, guards=guards)

    model, state, step = fresh()
    step(*batches[0])
    if guards:
        bad = batches[1][0].copy()
        bad[0, 0, 0, 0] = np.nan
        step(bad, batches[1][1])
    step(*batches[1])
    path = save_train_state(state, str(tmp_path), 2)
    want = step(*batches[2])
    saved = torch.load(path, weights_only=True)
    for group in saved["optimizer"]["param_groups"]:
        group["capturable"] = True
    torch.save(saved, path)

    model2, state2, step2 = fresh()
    restore_train_state(state2, path)
    got = step2(*batches[2])
    assert torch.equal(got["loss"], want["loss"]) and torch.equal(got["l1"], want["l1"])
    for (k, p), p2 in zip(model.named_parameters(), model2.parameters()):
        assert torch.equal(p, p2), k
    assert _adam_np(state).keys() == _adam_np(state2).keys()
    for k, v in _adam_np(state).items():
        np.testing.assert_array_equal(_adam_np(state2)[k], v, err_msg=str(k))
    assert (int(state2.step), int(state2.skipped)) == (3, int(guards))
