"""Restormer's fused residual add and BiasFree LayerNorm (``ops/layer_norm.py``,
the CPU path of the kernel in ``csrc/add_layer_norm.cu``) against the
composition the blocks ran before it: the add on the working dtype, then
``BiasFreeLayerNorm``; the stages that thread their residuals through it
against the per-block forward; the launch plan. Bit for bit throughout: the
plain version runs the same ops in the same order. No JAX."""
import pytest
import torch

from gpubench.reference import restormer as ref
from image_denoising_tpu_torch.models import restormer as port
from image_denoising_tpu_torch.ops.layer_norm import add_ln, add_ln_plan

PUBLISHED = dict(inp_channels=1, out_channels=1, dim=48, num_blocks=[4, 6, 6, 8],
                 num_refinement_blocks=4, heads=[1, 2, 4, 8], ffn_expansion_factor=2.66)
STAGES = ["encoder_level1", "encoder_level2", "encoder_level3", "latent", "decoder_level3",
          "decoder_level2", "decoder_level1", "refinement"]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _old_norm(z, w):
    """The BiasFree LayerNorm as the blocks ran it, on NCHW."""
    v = z.float()
    var = v.var(1, keepdim=True, unbiased=False)
    return (v / torch.sqrt(var + 1e-5) * w.float().view(1, -1, 1, 1)).to(z.dtype)


def _old(x, w, residual):
    """The blocks' plain ops on NCHW: ``x + residual``, then the norm."""
    s = x if residual is None else x + residual
    return s, _old_norm(s, w)


def _old_stage(stage, z):
    """A stage as its blocks ran before: each add a plain op, each norm the
    six plain ops."""
    for b in stage:
        z = z + b.attn(_old_norm(z, b.norm1.body.weight))
        z = z + b.ffn(_old_norm(z, b.norm2.body.weight))
    return z


def _nchw(g, shape, dtype, shift, layout):
    x = (torch.randn(*shape, generator=g) + shift).to(dtype)
    return x.contiguous(memory_format=layout)


@pytest.mark.parametrize("layout", [torch.contiguous_format, torch.channels_last],
                         ids=["nchw", "channels_last"])
@pytest.mark.parametrize("residual", [True, False], ids=["residual", "alone"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [48, 96, 192, 384])
def test_plain_add_ln_is_the_old_composition(c, dtype, residual, layout):
    """NHWC views of the module's NCHW tensors in, NHWC out: equal bit for
    bit to the add and the norm on NCHW, at Restormer's widths. Inputs off
    zero mean, as the blocks' are, so a centred numerator would differ."""
    g = torch.Generator().manual_seed(c)
    shape = (2, c, 7, 5)
    shift = 0.5 * torch.randn(1, c, 1, 1, generator=g)
    x = _nchw(g, shape, dtype, shift, layout)
    r = _nchw(g, shape, dtype, 0.0, layout) if residual else None
    w = 1 + 0.3 * torch.randn(c, generator=g)
    want_s, want_y = _old(x, w, r)
    s, y = add_ln(x.permute(0, 2, 3, 1), w, None if r is None else r.permute(0, 2, 3, 1))
    assert s.dtype == y.dtype == dtype and y.shape == (2, 7, 5, c)
    assert torch.equal(s.permute(0, 3, 1, 2), want_s)
    assert torch.equal(y.permute(0, 3, 1, 2), want_y)
    if not residual:
        assert s.data_ptr() == x.data_ptr()
    z = s.float()
    centred = (z - z.mean(-1, keepdim=True)) / torch.sqrt(
        z.var(-1, keepdim=True, unbiased=False) + 1e-5) * w
    assert not torch.equal(centred.to(dtype), y)


def _tiny(dtype, seed=11):
    """Every stage two blocks, so each threads a residual from block to block."""
    cfg = dict(PUBLISHED, dim=8, num_blocks=[2, 2, 2, 2], num_refinement_blocks=2)
    net = port.Restormer(dim=8, num_blocks=[2, 2, 2, 2], num_refinement_blocks=2, dtype=dtype)
    net.load_state_dict(ref.make_weights(cfg, seed, "cpu"), strict=True)
    return net.eval().requires_grad_(False)


@pytest.mark.parametrize("layout", [torch.contiguous_format, torch.channels_last],
                         ids=["nchw", "channels_last"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_threaded_forward_is_the_per_block_forward(dtype, layout, monkeypatch):
    """A tiny Restormer whose stages thread their residuals through
    ``add_ln``, without autograd and with it, against the same network with
    each stage's blocks running the old plain ops: equal bit for bit. Under
    autograd the norms' weights get their gradients."""
    net = _tiny(dtype)
    x = torch.rand(2, 1, 32, 32, generator=torch.Generator().manual_seed(4))
    x = x.contiguous(memory_format=layout)
    with torch.no_grad():
        threaded = net(x)
    with torch.enable_grad():
        net.requires_grad_(True)
        graded = net(x)
        graded.float().sum().backward()
    assert net.latent[1].norm2.body.weight.grad.abs().sum() > 0
    monkeypatch.setattr(port.Stage, "forward", _old_stage)
    with torch.no_grad():
        old = net(x)
    assert torch.equal(threaded, old) and torch.equal(graded.detach(), old)


@pytest.fixture(scope="module")
def published():
    """Restormer at its published widths in bf16, its norm weights off 1."""
    torch.manual_seed(23)
    net = port.Restormer(dtype=torch.bfloat16).eval().requires_grad_(False)
    for name, p in net.named_parameters():
        if name.endswith((".norm1.body.weight", ".norm2.body.weight")):
            p.data = 1 + 0.3 * torch.randn_like(p)
    return net


@pytest.mark.parametrize("stage", STAGES)
def test_published_stage_threads_bit_for_bit(published, stage):
    """Each published stage (4 to 8 blocks at 48 to 384 channels) on a
    bf16 channels_last 8 × 8 tile: the threaded forward equals the old
    per-block ops bit for bit, and so does one block's own forward."""
    blocks = getattr(published, stage)
    assert isinstance(blocks, port.Stage)
    c = blocks[0].norm1.body.weight.shape[0]
    z = torch.randn(1, c, 8, 8, generator=torch.Generator().manual_seed(c)).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        assert torch.equal(blocks(z), _old_stage(blocks, z))
        assert torch.equal(blocks[0](z), _old_stage(blocks[:1], z))


def test_a_forward_makes_88_calls_80_with_a_residual(published, monkeypatch):
    """44 blocks, two norms each: every add but each stage's last goes into
    a norm; under autograd none does."""
    calls = []
    real = port.add_ln

    def spy(x, w, residual=None, eps=1e-5):
        calls.append(residual is not None)
        return real(x, w, residual, eps)

    monkeypatch.setattr(port, "add_ln", spy)
    x = torch.rand(1, 1, 16, 16, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        published(x)
    assert len(calls) == 88 and sum(calls) == 80
    calls.clear()
    with torch.enable_grad():
        published(x)
    assert calls == []


def test_published_upstream_names_load_strictly():
    """The stages are ``nn.Sequential`` subclasses: the state dict keeps the
    upstream names, and the released layout loads with ``strict=True``."""
    with torch.device("meta"):
        net = port.Restormer()
    assert all(isinstance(getattr(net, s), torch.nn.Sequential) for s in STAGES)
    assert "encoder_level1.3.norm2.body.weight" in net.state_dict()
    assert sorted(net.state_dict()) == sorted(k for k, _ in ref.param_specs(PUBLISHED))
    net = port.Restormer()
    sd = ref.make_weights(PUBLISHED, 8, "cpu")
    net.load_state_dict(sd, strict=True)
    assert torch.equal(net.latent[7].norm2.body.weight, sd["latent.7.norm2.body.weight"])


@pytest.mark.parametrize("dtype, vectors, lanes", [
    (torch.bfloat16, 3, [2, 4, 8, 16]), (torch.float32, 3, [4, 8, 16, 32])])
def test_plan_at_restormer_widths(dtype, vectors, lanes):
    """48 to 384 channels: three 16-byte vectors a lane, a power-of-two
    group of lanes within a warp; 256 // lanes pixels a block."""
    for c, g, hw in zip([48, 96, 192, 384], lanes, [352, 176, 88, 44]):
        plan = add_ln_plan(8 * hw * hw, c, dtype)
        assert (plan.vectors, plan.lanes) == (vectors, g)
        assert plan.vectors * plan.lanes * 16 == c * dtype.itemsize
        assert plan.blocks == -(-8 * hw * hw // (256 // g))


def test_plan_falls_back_to_one_value_a_lane():
    """Unaligned tensors, or widths that no 1 to 4 vectors of a power-of-two
    group of at most 32 lanes make, take a warp a pixel."""
    assert add_ln_plan(100, 48, torch.bfloat16, aligned=False)[:2] == (0, 32)
    assert add_ln_plan(100, 6, torch.bfloat16)[:2] == (0, 32)
    assert add_ln_plan(100, 40, torch.bfloat16)[:2] == (0, 32)  # 5 vectors
    assert add_ln_plan(100, 8, torch.bfloat16)[:2] == (1, 1)
    assert add_ln_plan(100, 2048, torch.bfloat16)[:2] == (0, 32)  # 256 vectors
    assert add_ln_plan(10 ** 6, 6, torch.float32).blocks == 10 ** 6 // 8


def test_wrapper_checks_and_counts_no_cpu_launch():
    x = torch.randn(1, 2, 2, 8)
    before = add_ln.launches
    add_ln(x, torch.ones(8), x)
    assert add_ln.launches == before
    with pytest.raises(ValueError, match="w must be"):
        add_ln(x, torch.ones(4))
    with pytest.raises(ValueError, match="residual"):
        add_ln(x, torch.ones(8), x.to(torch.bfloat16))
    with pytest.raises(TypeError):
        add_ln(x.double(), torch.ones(8))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        add_ln(torch.zeros(1, 2, 2, 8, device="meta"), torch.ones(8, device="meta"))
