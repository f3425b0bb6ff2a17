"""The port's tile-parallel engines (eval/tiled.py with ``mesh=``) against
the single-device runners and the JAX package's mesh runners on its 8
virtual CPU devices. Mirrors tests/test_tile_parallel.py.

The port splits each tile stack over ``make_mesh(devices=["cpu"] * k)``:
the stack padded with zero tiles to a device multiple, each device's share
run in the runner's chunk size, gathered back. With a per-tile model the
split cannot change a tile: the frames are equal bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_denoising_tpu.eval import tiled as jax_tiled
from image_denoising_tpu.models import ImprovedUNet as JaxImprovedUNet
from image_denoising_tpu.parallel import make_mesh as jax_make_mesh
from image_denoising_tpu_torch.ckpt import load_jax_params
from image_denoising_tpu_torch.eval import tiled
from image_denoising_tpu_torch.models import ImprovedUNet, make_forward
from image_denoising_tpu_torch.parallel import make_mesh

from _torch_port_helpers import one_torch_thread, seeded_improved_unet_params  # noqa: F401


def _affine(t):
    return t * 0.8 + 0.05


def _frames(f, h, w, seed=2):
    return np.random.default_rng(seed).integers(0, 256, (f, h, w)).astype(np.uint8)


def cpus(k):
    return make_mesh(devices=["cpu"] * k)


@pytest.mark.parametrize("k,batch", [(8, 0), (3, -2), (5, 4)])
def test_pyramid_tile_split_matches_single_and_jax(k, batch):
    """96² frames in 64-px tiles (16 tiles, 2 frames): 8, 3 and 5 devices,
    one forward per share or chunks of 2 or 4 (padded), bit-equal to the
    single-device runner and within 1e-6 of JAX's runner on its 8-device
    mesh."""
    frames = _frames(2, 96, 96)
    single = tiled.make_tiled_pyramid_runner_frames(_affine, 2, 96, 96, ps=64, overlap=32,
                                                    batch=batch, device="cpu")(frames)
    split = tiled.make_tiled_pyramid_runner_frames(_affine, 2, 96, 96, ps=64, overlap=32,
                                                   batch=batch, mesh=cpus(k))(frames)
    for a, b in zip(split, single):
        assert torch.equal(a, b)
    want = jax_tiled.make_tiled_pyramid_runner(
        lambda t: t * 0.8 + 0.05, 96, 96, ps=64, overlap=32,
        mesh=jax_make_mesh(8))(jnp.asarray(frames[0]))
    np.testing.assert_allclose(split[0][0].numpy(), np.asarray(want[0]), atol=1e-6)
    assert abs(float(split[1][0]) - float(want[1])) < 1e-6


@pytest.mark.parametrize("k,batch", [(8, 0), (3, -4)])
def test_hann_tile_split_matches_single_and_jax(k, batch):
    """96×130 frames in 64-px Hann tiles, with a ``pre_tile_fn`` run once
    on the whole stack before the split (the hoisted retrieval's place):
    bit-equal to the single-device runner, within 1e-6 of JAX's runner on
    its 8-device mesh."""
    frame = _frames(1, 96, 130)[0]

    def pre(t):
        return torch.cat([t, (1.0 - t) ** 2], 1)

    def call(t):
        return 1.4 * t[:, :1] + 0.6 * t[:, 1:] - 0.3

    single = tiled.make_tiled_hann_runner(call, 96, 130, ps=64, overlap=32, batch=batch,
                                          pre_tile_fn=pre, device="cpu")(frame)
    split = tiled.make_tiled_hann_runner(call, 96, 130, ps=64, overlap=32, batch=batch,
                                         pre_tile_fn=pre, mesh=cpus(k))(frame)
    assert torch.equal(split, single)
    want = jax_tiled.make_tiled_hann_runner(
        lambda t: 1.4 * t[..., :1] + 0.6 * t[..., 1:] - 0.3, 96, 130, ps=64, overlap=32,
        pre_tile_fn=lambda t: jnp.concatenate([t, (1.0 - t) ** 2], -1),
        mesh=jax_make_mesh(8))(jnp.asarray(frame))
    np.testing.assert_allclose(split.numpy(), np.asarray(want), atol=1e-6)


def test_split_model_forward_matches_single_and_jax():
    """ImprovedUNet-8 through ``make_forward(mesh=)`` (one copy per
    distinct device, each share on its device's copy) in the pyramid
    runner and the uint8 Hann runner: at 1-tile chunks bit-equal to the
    single-device runner (uint8 frames equal), and within 1e-5 of JAX's
    model on its 8-device mesh (tests/test_tile_parallel.py's limit)."""
    _, params = seeded_improved_unet_params(8, seed=57)
    model = load_jax_params(ImprovedUNet(1, 1, 8), params).eval()
    mesh = cpus(4)
    frame = _frames(1, 96, 96)[0]
    fwd1, fwd4 = make_forward(model, "cpu"), make_forward(model, "cpu", mesh=mesh)
    one, _ = tiled.make_tiled_pyramid_runner(fwd1, 96, 96, ps=64, overlap=32, batch=-1,
                                             device="cpu")(frame)
    four, _ = tiled.make_tiled_pyramid_runner(fwd4, 96, 96, ps=64, overlap=32, batch=-1,
                                              mesh=mesh)(frame)
    assert torch.equal(one, four)
    jmodel = JaxImprovedUNet(1, 1, 8)
    want, _ = jax_tiled.make_tiled_pyramid_runner(
        jax.jit(lambda t, p: jmodel.apply({"params": p}, t)), 96, 96, ps=64, overlap=32,
        mesh=jax_make_mesh(8))(jnp.asarray(frame), params)
    np.testing.assert_allclose(four.numpy(), np.asarray(want), atol=1e-5)
    h1 = tiled.make_tiled_hann_runner_frames(fwd1, 2, 96, 96, ps=32, overlap=16, batch=-1,
                                             out_dtype="uint8_round", device="cpu")
    h4 = tiled.make_tiled_hann_runner_frames(fwd4, 2, 96, 96, ps=32, overlap=16, batch=-1,
                                             out_dtype="uint8_round", mesh=mesh)
    frames = _frames(2, 96, 96, seed=3)
    assert torch.equal(h1(frames), h4(frames))
