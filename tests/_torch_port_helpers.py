"""Shared pieces of the port's parity tests.

``seeded_improved_unet_params``: the tree is the one ``ImprovedUNet.init`` builds (its structure and shapes
from ``jax.eval_shape``); the values are drawn with numpy from a seed, on
torch's default-init scale. Compiling the real init on the CPU costs about
25 s per test process, and the parity tests need only some fixed weights.
"""
import jax
import numpy as np
import pytest
import torch

from image_denoising_tpu.models import ImprovedUNet


def seeded_improved_unet_params(n_feature: int, seed: int, in_nc: int = 1):
    model = ImprovedUNet(in_nc=in_nc, out_nc=in_nc, n_feature=n_feature)
    shapes = jax.eval_shape(
        model.init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, 32, 32, in_nc), np.float32))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "'scale'" in name:  # GroupNorm scale around 1
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 else 9 * n_feature
        bound = fan_in ** -0.5
        return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)

    return model, jax.tree_util.tree_map_with_path(draw, shapes)


def seeded_params(module, *example_inputs, seed: int):
    """Every leaf of ``module.init``'s tree (from ``jax.eval_shape``) drawn
    with numpy from a seed, uniform on ±fan_in^-½: zero-initialised tails
    (the adapters' last convs and hyper-networks) get non-zero values too,
    so the parity tests see every weight at work."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *example_inputs)["params"]
    rng = np.random.default_rng(seed)

    def draw(leaf):
        fan_in = int(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 else 16
        bound = fan_in ** -0.5
        return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map(draw, shapes)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while a module's tests run: the suite runs in
    several worker processes, and each one's full-width thread pool
    oversubscribes the cores (the CLI parity test ran 3x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_network_params(arch: str, n_feature: int, seed: int, blindspot: bool = False,
                          size: int = 64, in_nc: int = 1):
    """(JAX UNet or RESNET, its params tree drawn by ``seeded_params``)."""
    from image_denoising_tpu.models import RESNET, UNet

    model = {"UNet": UNet, "RESNET": RESNET}[arch](
        in_nc=in_nc, out_nc=in_nc, n_feature=n_feature, blindspot=blindspot)
    x = jax.ShapeDtypeStruct((1, size, size, in_nc), np.float32)
    return model, seeded_params(model, x, seed=seed)


def patch_cpu_mesh(monkeypatch, k: int = 4):
    """Send the port's ``make_mesh()`` (what the CLIs' ``--parallel`` and
    ``--bank_sharded`` build) to k CPU devices, as the JAX tests run on 8
    virtual CPU devices. Returns that mesh."""
    from image_denoising_tpu_torch.parallel import mesh as pmesh

    mesh = pmesh.Mesh(["cpu"] * k)
    monkeypatch.setattr(pmesh, "make_mesh", lambda n_devices=None, devices=None: mesh)
    return mesh


def same_files(dir_a, dir_b):
    """Both directories hold the same file names with the same bytes."""
    import os

    names = sorted(os.listdir(dir_a))
    assert names == sorted(os.listdir(dir_b))
    for f in names:
        with open(os.path.join(dir_a, f), "rb") as fa, open(os.path.join(dir_b, f), "rb") as fb:
            assert fa.read() == fb.read(), f
