"""The port's ``.ckpt`` files (ckpt/{msgpack,pth_import,io}.py) against the
JAX package's: byte-equal files for each role's tree, JAX-written files
loading strict into the port with JAX's forward, port-written files read
back by JAX to bit-equal trees, the state dict → tree → state dict
identity, ``.pth`` still loading, and the refusals outside the subset."""
import json
import os

import msgpack as msgpack_ref
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from image_denoising_tpu.adapters import (DenoiserWithAdapter as JaxAdapterWrapper,
                                          OutputAdapter as JaxOutputAdapter,
                                          build_memory_adapter as jax_build)
from image_denoising_tpu.ckpt import load_checkpoint as jax_load_checkpoint
from image_denoising_tpu.ckpt import save_checkpoint as jax_save_checkpoint
from image_denoising_tpu.ckpt.pth_export import export_pth
from image_denoising_tpu_torch.adapters import OutputAdapter, build_memory_adapter
from image_denoising_tpu_torch.ckpt import (load_checkpoint, load_jax_params,
                                            params_to_state_dict, save_checkpoint,
                                            state_dict_to_params, to_params)
from image_denoising_tpu_torch.ckpt import msgpack
from image_denoising_tpu_torch.models import ImprovedUNet

from _torch_port_helpers import (one_torch_thread, seeded_improved_unet_params,  # noqa: F401
                                 seeded_params)

VARIANTS = ["memory_residual", "lowfreq_blend", "tone_curve", "hyper_gated",
            "hyper_gated_fft"]
HIDDEN = 16
ROLES = ["UNetImproved", "output_adapter"] + VARIANTS + ["base_and_adapter"]


def _adapter_params(arch, seed):
    x = jnp.zeros((2, 32, 32, 1), jnp.float32)
    if arch == "output_adapter":
        return seeded_params(JaxOutputAdapter(in_channels=1, hidden_channels=HIDDEN),
                             x, x, seed=seed)
    return seeded_params(jax_build(arch, 1, HIDDEN), x, x, x, seed=seed)


def _port_module(arch, params):
    mod = {"UNetImproved": lambda: ImprovedUNet(1, 1, 8),
           "output_adapter": lambda: OutputAdapter(1, HIDDEN)}.get(
        arch, lambda: build_memory_adapter(arch, 1, HIDDEN))()
    return load_jax_params(mod, params, arch=arch)


@pytest.fixture(scope="module")
def trees():
    """Each role's JAX tree (seeded numpy leaves) and the port's module(s)
    holding the same weights."""
    _, unet = seeded_improved_unet_params(8, seed=11)
    out = {"UNetImproved": (unet, _port_module("UNetImproved", unet))}
    for k, arch in enumerate(["output_adapter"] + VARIANTS):
        p = _adapter_params(arch, seed=12 + k)
        out[arch] = (p, _port_module(arch, p))
    out["base_and_adapter"] = (
        {"base": unet, "adapter": out["output_adapter"][0]},
        {"base": out["UNetImproved"][1], "adapter": out["output_adapter"][1]})
    return out


@pytest.mark.parametrize("role", ROLES)
def test_ckpt_bytes_equal_flax(trees, role, tmp_path):
    """The port's codec writes flax's bytes for the JAX tree, and the port's
    ``save_checkpoint`` of its modules writes the file JAX's
    ``save_checkpoint`` writes for that tree."""
    tree, module = trees[role]
    want = serialization.msgpack_serialize(tree)
    assert msgpack.pack(tree) == want
    jax_path = jax_save_checkpoint(tree, str(tmp_path / "jax"), "adapter", 3)
    port_path = save_checkpoint(module, str(tmp_path / "port"), "adapter", 3)
    assert os.path.basename(port_path) == os.path.basename(jax_path) == "epoch_adapter_003.ckpt"
    with open(jax_path, "rb") as f, open(port_path, "rb") as g:
        assert f.read() == g.read() == want


def test_jax_written_files_load_strict_with_jax_forward(trees, tmp_path):
    """``epoch_model`` and ``epoch_adapter`` files (meta ``.json`` beside
    them) from JAX's writer load strict into the port; the forward equals
    JAX's (float32 sums in another order: atol 1e-5)."""
    unet_tree, _ = trees["UNetImproved"]
    meta = {"arch": "UNetImproved", "n_feature": 8, "epoch": 2}
    path = jax_save_checkpoint(unet_tree, str(tmp_path), "model", 2, meta=meta)
    with open(path + ".json") as f:
        assert json.load(f) == meta
    model = ImprovedUNet(1, 1, 8)
    model.load_state_dict(load_checkpoint(path, arch="UNetImproved"), strict=True)
    x = np.random.default_rng(0).random((2, 64, 64, 1), dtype=np.float32)
    from image_denoising_tpu.models import ImprovedUNet as JaxImprovedUNet

    want = np.asarray(JaxImprovedUNet(in_nc=1, out_nc=1, n_feature=8).apply(
        {"params": unet_tree}, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)

    wrapper_tree, _ = trees["base_and_adapter"]
    wpath = jax_save_checkpoint(wrapper_tree, str(tmp_path), "adapter", 2)
    adapter = OutputAdapter(1, HIDDEN)
    adapter.load_state_dict(load_checkpoint(wpath, arch="output_adapter", prefix="adapter"),
                            strict=True)
    base = ImprovedUNet(1, 1, 8)
    base.load_state_dict(load_checkpoint(wpath, arch="UNetImproved", prefix="base"),
                         strict=True)
    jwrap = JaxAdapterWrapper(base=JaxImprovedUNet(in_nc=1, out_nc=1, n_feature=8),
                              in_channels=1, hidden_channels=HIDDEN)
    want = np.asarray(jwrap.apply({"params": wrapper_tree}, jnp.asarray(x)))
    with torch.no_grad():
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        got = adapter(xt, base(xt)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="prefix"):
        load_checkpoint(wpath, arch="UNetImproved")


@pytest.mark.parametrize("role", ["UNetImproved", "hyper_gated_fft", "base_and_adapter"])
def test_port_written_files_read_back_in_jax(trees, role, tmp_path):
    """JAX's ``load_checkpoint`` reads the port's file (and its meta) back
    to the JAX tree, bit for bit."""
    tree, module = trees[role]
    meta = {"role": role, "lr": 1e-4}
    path = save_checkpoint(module, str(tmp_path), "adapter_only", 1, meta=meta)
    got = jax_load_checkpoint(path)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    jax_path = jax_save_checkpoint(tree, str(tmp_path / "jax"), "adapter_only", 1, meta=meta)
    with open(path + ".json") as f, open(jax_path + ".json") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("arch", ["UNetImproved", "output_adapter"] + VARIANTS)
def test_state_dict_tree_state_dict_is_identity(trees, arch):
    """state dict → tree → state dict gives the module's tensors bit for
    bit, and tree → state dict → tree the JAX tree."""
    tree, module = trees[arch]
    sd = module.state_dict()
    back = params_to_state_dict(state_dict_to_params(sd, arch), arch)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v.numpy(), err_msg=k)
    again = to_params(module)
    for a, b in zip(jax.tree_util.tree_leaves(again), jax.tree_util.tree_leaves(tree)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_pth_still_loads(trees, tmp_path):
    """A reference-layout ``.pth`` (JAX's ``export_pth``, a DataParallel
    ``module.`` prefix too) loads without ``arch``."""
    tree, module = trees["hyper_gated_fft"]
    path = export_pth(tree, "hyper_gated_fft", str(tmp_path / "a.pth"))
    sd = load_checkpoint(path)
    for k, v in module.state_dict().items():
        assert torch.equal(sd[k], v), k
    torch.save({f"module.{k}": v for k, v in module.state_dict().items()}, tmp_path / "dp.pth")
    assert sorted(load_checkpoint(str(tmp_path / "dp.pth"))) == sorted(sd)
    with pytest.raises(ValueError, match="arch="):
        load_checkpoint(str(tmp_path / "x.ckpt"))


@pytest.mark.parametrize("case", ["ext2_complex", "ext3_scalar", "chunked", "float",
                                  "bfloat16", "truncated"])
def test_outside_the_subset_raises(case, tmp_path):
    data = {
        "ext2_complex": msgpack_ref.packb({"a": msgpack_ref.ExtType(2, b"\x92\x01\x02")}),
        "ext3_scalar": serialization.msgpack_serialize({"a": np.float32(1.5)}),
        "chunked": msgpack_ref.packb({"a": {"__msgpack_chunked_array__": True}}),
        "float": serialization.msgpack_serialize({"a": 0.5}),
        "bfloat16": serialization.msgpack_serialize(
            {"a": np.asarray(jnp.ones((2,), jnp.bfloat16))}),
        "truncated": serialization.msgpack_serialize({"a": np.ones(3, np.float32)})[:-2],
    }[case]
    path = tmp_path / "bad.ckpt"
    path.write_bytes(data)
    with pytest.raises(ValueError):
        load_checkpoint(str(path), arch="UNetImproved")
    with pytest.raises(ValueError):
        msgpack.pack({"a": np.float32(1.0)} if case == "ext3_scalar"
                     else {"a": {1: np.ones(2)}})
