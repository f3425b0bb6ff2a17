"""The port's UNet (blind spot off and on) and RESNET against the JAX
package: the reference state-dict layout both ways, the float32 and
bfloat16 forwards from one exported ``.pth``, the layer helpers bit for
bit, the init regime, the registry, ``.ckpt`` files byte-equal both ways
and the blind spot itself. n_feature 8, 64² frames."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_denoising_tpu.ckpt import load_checkpoint as jax_load_checkpoint
from image_denoising_tpu.ckpt import save_checkpoint as jax_save_checkpoint
from image_denoising_tpu.ckpt.pth_export import export_pth
from image_denoising_tpu.ckpt.pth_export import params_to_state_dict as jax_to_sd
from image_denoising_tpu.ckpt.pth_import import import_pth as jax_import_pth
from image_denoising_tpu.models import layers as jax_layers
from image_denoising_tpu.models import RESNET as JaxRESNET, UNet as JaxUNet
from image_denoising_tpu.ops.space_to_depth import depth_to_space as jax_d2s
from image_denoising_tpu.ops.space_to_depth import space_to_depth as jax_s2d
from image_denoising_tpu_torch.ckpt import (load_checkpoint, params_to_state_dict,
                                            save_checkpoint, state_dict_to_params)
from image_denoising_tpu_torch.ckpt.io import load_params_tree
from image_denoising_tpu_torch.models import (RESNET, ImprovedUNet, UNet, build_model,
                                              build_model_from_log_name, layers)
from image_denoising_tpu_torch.ops import depth_to_space, space_to_depth

from _torch_port_helpers import one_torch_thread, seeded_network_params  # noqa: F401

NF, FRAME = 8, 64
CASES = [("UNet", False), ("UNet", True), ("RESNET", False), ("RESNET", True)]
IDS = ["unet", "unet_blindspot", "resnet", "resnet_blindspot"]


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    """Per case: the JAX params, the port module loaded strict from the JAX
    package's exported ``.pth``, the input batch and JAX's float32 and
    bfloat16 outputs on it."""
    root = tmp_path_factory.mktemp("nets")
    x = np.random.default_rng(1).random((2, FRAME, FRAME, 1), dtype=np.float32)
    out = {}
    for i, (arch, bs) in enumerate(CASES):
        jm, params = seeded_network_params(arch, NF, seed=40 + i, blindspot=bs)
        pth = export_pth(params, arch, str(root / f"{IDS[i]}.pth"))
        model = build_model(arch, 1, NF, blindspot=bs)
        model.load_state_dict(load_checkpoint(pth), strict=True)
        jm16 = type(jm)(1, 1, NF, blindspot=bs, dtype=jnp.bfloat16)
        out[(arch, bs)] = dict(
            params=params, pth=pth, model=model.eval(), x=x,
            f32=np.asarray(jax.jit(jm.apply)({"params": params}, x)),
            bf16=np.asarray(jax.jit(jm16.apply)({"params": params}, x)).astype(np.float32))
    return out


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_state_dict_is_the_reference_layout(nets, case):
    """The port's ``params_to_state_dict`` gives JAX's export key for key and
    bit for bit (RESNET's made-up ``up5`` included), which is the port
    module's own state dict; ``state_dict_to_params`` gives JAX's
    ``import_pth`` tree (RESNET: with ``up5``)."""
    arch, _ = case
    n = nets[case]
    want = jax_to_sd(n["params"], arch)
    got = params_to_state_dict(n["params"], arch)
    own = n["model"].state_dict()
    assert sorted(got) == sorted(want) == sorted(own)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(own[k].numpy(), want[k], err_msg=k)
    tree = state_dict_to_params(own, arch)
    want_tree = jax_import_pth({k: v.numpy() for k, v in own.items()}, arch)
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(want_tree)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(want_tree)):
        np.testing.assert_array_equal(a, b)
    assert ("up5" in tree) and ("up5" in n["params"]) == (arch == "UNet")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_forward_matches_jax(nets, case):
    """float32: within 1e-5 relative (and 1e-5 of the output's scale) of
    JAX's apply; readings at most 2.1e-6 of the scale."""
    n = nets[case]
    with torch.no_grad():
        got = _nhwc(n["model"](_nchw(n["x"])))
    want = n["f32"]
    assert got.shape == want.shape == (2, FRAME, FRAME, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bf16_forward_within_the_jax_envelope(nets, case):
    """bfloat16 compute (float32 parameters): the port's distance from JAX's
    float32 output is at most twice JAX's own bfloat16 distance from it
    (readings: 0.7 to 1.5 times), and its parameters stay float32."""
    n = nets[case]
    model = n["model"]
    model.dtype = torch.bfloat16
    try:
        with torch.no_grad():
            got = _nhwc(model(_nchw(n["x"])))
    finally:
        model.dtype = None
    assert all(p.dtype == torch.float32 for p in model.parameters())
    own = np.abs(n["bf16"] - n["f32"]).max()
    assert 0 < np.abs(got - n["f32"]).max() <= 2 * own


def _ints(rng, shape):
    """Small integers as float32: every sum of their products is exact, so
    any order of summation gives the same bits."""
    return rng.integers(-4, 5, shape).astype(np.float32)


@pytest.mark.parametrize("helper", ["deconv", "rotate", "blindspot_conv",
                                    "blindspot_pool", "blindspot_output_shift",
                                    "space_to_depth"])
def test_layer_helpers_bit_equal_to_jax(helper):
    rng = np.random.default_rng(2)
    x = _ints(rng, (2, 8, 6, 3))  # NHWC, H != W
    xt = _nchw(x)
    if helper == "deconv":
        w, b = _ints(rng, (3, 5, 2, 2)), _ints(rng, (5,))
        mod = layers.Deconv2x2(3, 5)
        mod.load_state_dict({"weight": torch.from_numpy(w), "bias": torch.from_numpy(b)})
        with torch.no_grad():
            got = [_nhwc(mod(xt))]
        want = [np.asarray(jax_layers.Deconv2x2(5).apply(
            {"params": {"kernel": w, "bias": b}}, x))]
    elif helper == "rotate":
        sq = _ints(rng, (2, 6, 6, 3))
        got = [_nhwc(layers.rotate(_nchw(sq), a)) for a in (0, 90, 180, 270)]
        want = [np.asarray(jax_layers.rotate(sq, a)) for a in (0, 90, 180, 270)]
    elif helper == "blindspot_conv":
        w, b = _ints(rng, (3, 3, 3, 4)), _ints(rng, (4,))
        conv = layers.Conv2d(3, 4, 3)
        conv.load_state_dict({"weight": torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                              "bias": torch.from_numpy(b)})
        jconv = jax_layers.Conv(4, kernel=3)
        jp = {"params": {"conv": {"kernel": w, "bias": b}}}
        with torch.no_grad():
            got = [_nhwc(layers.blindspot_conv(xt, conv, 3, bs)) for bs in (False, True)]
        want = [np.asarray(jax_layers.blindspot_conv(
            x, lambda h: jconv.apply(jp, h), 3, bs)) for bs in (False, True)]
    elif helper == "blindspot_pool":
        got = [_nhwc(layers.blindspot_pool(xt, bs)) for bs in (False, True)]
        want = [np.asarray(jax_layers.blindspot_pool(x, bs)) for bs in (False, True)]
    elif helper == "blindspot_output_shift":
        got = [_nhwc(layers.blindspot_output_shift(xt))]
        want = [np.asarray(jax_layers.blindspot_output_shift(x))]
    else:
        s2d = space_to_depth(xt)
        got = [_nhwc(s2d), _nhwc(depth_to_space(s2d))]
        want = [np.asarray(jax_s2d(x)), np.asarray(jax_d2s(jax_s2d(x)))]
        np.testing.assert_array_equal(got[1], x)
    assert len(got) == len(want)
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape
        np.testing.assert_array_equal(g, w_)


@pytest.mark.parametrize("arch", ["UNet", "RESNET"])
def test_init_is_kaiming_times_a_tenth(arch):
    """Every conv weight's std within 6 standard errors of 0.1·√(2/fan_in)
    (deconvs: fan_in = out-channels·4, torch's quirk), every bias zero; with
    ``zero_last`` the ``nin_c`` head keeps torch's default U(±1/√fan_in)."""
    torch.manual_seed(0)
    cls = {"UNet": UNet, "RESNET": RESNET}[arch]
    model = cls(1, 1, 48, blindspot=True)
    for name, mod in model.named_modules():
        if not isinstance(mod, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            continue
        w = mod.weight.detach().double()
        fan_in = w.shape[1] * w.shape[2] * w.shape[3]  # torch's fan: size(1)·k·k
        want = 0.1 * np.sqrt(2.0 / fan_in)
        assert abs(float(w.std()) / want - 1) < 6 / np.sqrt(2 * w.numel()), name
        assert float(w.mean().abs()) < 6 * want / np.sqrt(w.numel()), name
        assert torch.count_nonzero(mod.bias) == 0, name
    assert model.up5.deconv.weight.shape == (48, 48, 2, 2)
    assert model.nin_a.weight.shape == (384, 384, 1, 1)
    last = cls(1, 1, 48, zero_last=True).nin_c
    bound = 1 / np.sqrt(96)
    for t in (last.weight, last.bias):
        assert 0 < float(t.detach().abs().max()) <= bound
    assert abs(float(last.weight.std()) * np.sqrt(3 * 96) - 1) < 0.25


def test_registry_dispatch():
    """As the JAX package's ``test_registry_dispatch``; ``UNET`` is the
    log-name spelling only and as an ``arch`` raises ``ValueError``."""
    assert isinstance(build_model("UNet", 1, 16), UNet)
    assert isinstance(build_model("RESNET", 1, 16), RESNET)
    assert isinstance(build_model("UNetImproved", 1, 16), ImprovedUNet)
    with pytest.raises(ValueError):
        build_model("nope")
    with pytest.raises(ValueError, match="Unknown arch"):
        build_model("UNET", 1, 16)
    m = build_model_from_log_name("UNET_blindspot_run", 1, 16)
    assert isinstance(m, UNet) and m.blindspot
    m = build_model_from_log_name("UNET_gauss25", 1, 16, dtype=torch.bfloat16)
    assert isinstance(m, UNet) and not m.blindspot and m.dtype == torch.bfloat16
    m = build_model("RESNET", 1, 16, blindspot=True, dtype=torch.bfloat16)
    assert m.blindspot and m.enc_conv3.compute_dtype == torch.bfloat16
    m = build_model_from_log_name("RESNET_x", 1, 16)
    assert isinstance(m, RESNET) and not m.blindspot
    m = build_model_from_log_name("my_UNetImproved_x", 1, 16)
    assert isinstance(m, ImprovedUNet)
    with pytest.raises(ValueError):
        build_model_from_log_name("garbage")


def test_unet_needs_frames_divisible_by_32():
    with pytest.raises(ValueError, match="divisible by 32"):
        UNet(1, 1, 8)(torch.zeros(1, 1, 48, 64))
    assert RESNET(1, 1, 8)(torch.zeros(1, 1, 20, 24)).shape == (1, 1, 20, 24)


@pytest.mark.parametrize("case", [CASES[0], CASES[1], CASES[2]], ids=IDS[:3])
def test_ckpt_files_byte_equal_both_ways(nets, case, tmp_path):
    """A JAX-written ``.ckpt`` loads strict into the port (RESNET's
    ``up5`` made up) and the port writes it back byte for byte; a
    port-written ``.ckpt`` reads in JAX to the same tree, which JAX writes
    back byte for byte."""
    arch, bs = case
    params = nets[case]["params"]
    want = jax_save_checkpoint(params, str(tmp_path / "jax"), "model", 1)
    model = build_model(arch, 1, NF, blindspot=bs)
    model.load_state_dict(load_checkpoint(want, arch=arch), strict=True)
    got = save_checkpoint(model, str(tmp_path / "port"), "model", 1)
    assert open(got, "rb").read() == open(want, "rb").read()
    back = jax_save_checkpoint(jax_load_checkpoint(got), str(tmp_path / "back"), "model", 1)
    assert open(back, "rb").read() == open(got, "rb").read()
    assert ("up5" in load_params_tree(got)) == (arch == "UNet")


@pytest.mark.parametrize("arch", ["UNet", "RESNET"])
def test_blind_spot_never_sees_its_own_pixel(arch):
    """Independent of JAX: in the blind-spot UNet ∂out[p]/∂in[p] = 0 at 10
    sampled pixels p (corners, edges, interior) while other pixels reach
    out[p]; without the blind spot p reaches it too. The RESNET's global
    residual (``+ input``) passes p on with gradient exactly 1, so its
    network part too leaves p out. A gradient that no path carries is an
    exact zero in any dtype."""
    torch.manual_seed(3)
    cls = {"UNet": UNet, "RESNET": RESNET}[arch]
    rng = np.random.default_rng(4)
    pixels = [(0, 0), (63, 63), (0, 40), (40, 0)] + [
        tuple(int(v) for v in rng.integers(0, FRAME, 2)) for _ in range(6)]
    x = torch.rand(1, 1, FRAME, FRAME)
    own = 1.0 if arch == "RESNET" else 0.0
    for bs in (True, False):
        model = cls(1, 1, NF, blindspot=bs)
        for y, x0 in pixels:
            inp = x.clone().requires_grad_(True)
            model(inp)[0, 0, y, x0].backward()
            g = inp.grad[0, 0]
            assert (g[y, x0] == own) == bs, (bs, y, x0, float(g[y, x0]))
            assert torch.count_nonzero(g) > 1


@pytest.mark.parametrize("arch", ["UNet", "RESNET"])
def test_make_forward_serves_the_module_in_its_dtype(arch):
    """``make_forward`` (the CLIs' forward) on a UNet or RESNET: a frozen
    copy of the module on the device, float32 within 1e-6 of the module's
    own forward, bfloat16 equal to the module computing in bfloat16 within
    one bfloat16 unit of its output, the caller's module untouched; on an
    ImprovedUNet it is ``make_fused_forward``."""
    from image_denoising_tpu_torch.models import make_forward, make_fused_forward

    torch.manual_seed(5)
    model = build_model(arch, 1, NF, blindspot=arch == "UNet")
    x = torch.rand(2, 1, FRAME, FRAME)
    with torch.no_grad():
        want = model(x)
        model.dtype = torch.bfloat16
        want16 = model(x).float()
        model.dtype = None
    got = make_forward(model, device="cpu")(x)
    got16 = make_forward(model, device="cpu", dtype=torch.bfloat16)(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
    assert got16.dtype == (torch.float32 if arch == "RESNET" else torch.bfloat16)
    np.testing.assert_allclose(got16.float().numpy(), want16.numpy(),
                               atol=2 ** -8 * float(want16.abs().max()), rtol=0)
    assert model.dtype is None and all(p.dtype == torch.float32 and p.requires_grad
                                       for p in model.parameters())
    improved = ImprovedUNet(1, 1, NF)
    xi = torch.rand(1, 1, 32, 32)
    assert torch.equal(make_forward(improved, device="cpu")(xi),
                       make_fused_forward(improved, device="cpu")(xi))


@pytest.mark.parametrize("arch, blindspot", [("UNet", False), ("UNet", True),
                                             ("RESNET", False)], ids=IDS[:3])
def test_bf16_levels_of_the_jax_package(arch, blindspot):
    """The bfloat16 limit ``chip_smoke.py``'s [networks] holds each network
    to, from the JAX package's own bfloat16 forward against its float32 one:
    n_feature 48 with the smoke's seeded He-normal weights, on two 256²
    crops of its serving frames, in E2's floor levels. Where JAX reads
    within E2's limits (8 levels, mean 1.0; readings: UNet 6 / 0.587,
    blind-spot UNet 6 / 0.647) the smoke keeps them; RESNET reads 12 /
    1.583 and the smoke holds it to 1.5 times that (``NET_BF16_LIMITS``),
    which the port's own bfloat16 forward here meets too."""
    import importlib.util
    from pathlib import Path

    from image_denoising_tpu_torch.models.init import initialize_weights

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    _, noise = cs.serving_frames(0, 2)
    x = np.stack([noise[0][:256, :256], noise[1][-256:, -256:]])[..., None] / np.float32(255)
    torch.manual_seed(0)
    model = initialize_weights(build_model(arch, 1, 48, blindspot=blindspot), 1.0).eval()
    params = state_dict_to_params(model.state_dict(), arch)
    if arch == "RESNET":
        params.pop("up5")
    jcls = {"UNet": JaxUNet, "RESNET": JaxRESNET}[arch]

    def levels(p):
        return np.clip(np.asarray(p, np.float32) * 255.0, 0, 255).astype(np.int16)

    f32, b16 = (levels(jax.jit(jcls(1, 1, 48, blindspot=blindspot, dtype=dt).apply)(
        {"params": params}, x)) for dt in (None, jnp.bfloat16))
    d = np.abs(b16 - f32)
    e2 = (cs.BF16_MAX_LEVELS, cs.BF16_MEAN_LEVELS)
    limit = cs.NET_BF16_LIMITS.get(arch, e2)
    if limit == e2:
        assert d.max() <= e2[0] and d.mean() <= e2[1], (d.max(), d.mean())
    else:
        assert d.max() > e2[0] or d.mean() > e2[1]
        assert 1.5 * d.max() <= limit[0] and 1.5 * d.mean() <= limit[1], (d.max(), d.mean())
    if limit != e2:  # the widened limit holds the port's own bf16 too
        with torch.no_grad():
            xt = _nchw(x)
            ours32 = levels(_nhwc(model(xt)))
            model.dtype = torch.bfloat16
            ours16 = levels(_nhwc(model(xt)))
        dp = np.abs(ours16 - ours32)
        assert dp.max() <= limit[0] and dp.mean() <= limit[1], (dp.max(), dp.mean())
