"""What the port's tensor-core kernels take from the host, on the CPU: the
chain's weight repacking (ops/fused_block.py::pack_conv_weight), the TF32
hi/lo split both kernels use for float32 (split_tf32), the chain's launch
plan (against csrc/fused_block.cu's own tables), the generated wgmma
header, and a plain emulation of 3xTF32 products that shows the float32
tolerances of chip_smoke.py hold with that split and fail with one TF32
product."""
import functools
import importlib.util
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import image_denoising_tpu_torch.ops.fused_block as fb
from image_denoising_tpu_torch.models.improved_unet import RDB, ResBlock
from image_denoising_tpu_torch.ops.fused_block import (
    MIN_BLOCKS,
    FusedChainWeights,
    chain_conv_plans,
    conv_plan,
    fused_rdb_chain_reference,
    pack_conv_weight,
    split_tf32,
    unpack_conv_weight,
)

from _torch_port_helpers import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
CONVS = ["lead", "growth0", "growth1", "growth2", "growth3", "lff", "res0"]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _weights(dtype, nf=24):
    torch.manual_seed(0)
    return FusedChainWeights.from_modules(
        RDB(nf), lead=torch.nn.Conv2d(2, nf, 3, padding=1), res=ResBlock(nf),
        dtype=dtype)


def _trunc_tf32(x):
    """What the tensor cores read of a float32 operand: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("conv", CONVS)
def test_pack_conv_weight_is_a_permutation(conv, dtype):
    """Packing moves every HWIO value once and adds only zeros; unpacking
    gives the HWIO tensor back exactly."""
    w = dict((n, wt) for n, wt, _ in _weights(dtype).convs())[conv]
    kh, kw, cin, cout = w.shape
    np_ = conv_plan(1, 1, 1, cin, cout, dtype)["np"]
    p = pack_conv_weight(w, np_)
    chunk = 16 // w.element_size()
    n_tiles, chunks, taps, width, c = p.shape
    assert (taps, width, c) == (kh * kw, np_, chunk)
    assert chunks % 2 == 0 and chunks * chunk >= cin and n_tiles * np_ >= cout
    assert torch.equal(unpack_conv_weight(p, kh, kw, cin, cout), w)
    pad = p.numel() - w.numel()
    want = torch.cat([w.flatten(), w.new_zeros(pad)]).float().sort().values
    assert torch.equal(p.flatten().float().sort().values, want)


def test_packed_weights_are_computed_once():
    for dtype in (torch.float32, torch.bfloat16):
        wts = _weights(dtype)
        packed = wts.packed()
        assert wts.packed() is packed and list(packed) == CONVS
        for name, (hi, lo, np_) in packed.items():
            assert hi.is_contiguous() and hi.shape[3] == np_
            if dtype == torch.float32:
                assert torch.equal(hi + lo, pack_conv_weight(
                    dict((n, w) for n, w, _ in wts.convs())[name], np_))
            else:
                assert lo is None


def test_split_tf32_hi_has_10_mantissa_bits_and_hi_plus_lo_is_x():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(np.concatenate([
        rng.standard_normal(4096), rng.standard_normal(64) * 1e-30,
        rng.standard_normal(64) * 1e30, [0.0, -0.0, 1.0, -3.5]]).astype(np.float32))
    hi, lo = split_tf32(x)
    assert hi.dtype == lo.dtype == torch.float32
    assert int((hi.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert torch.equal(hi + lo, x)
    nz = x != 0
    assert float((lo[nz] / x[nz]).abs().max()) <= 2.0 ** -11
    # hi is the nearest TF32 value: no other neighbour is closer
    ulp = torch.ldexp(torch.ones_like(x), torch.frexp(x)[1] - 11)
    assert bool(((hi - x).abs() <= 0.5 * ulp).all())


def test_split_tf32_rounds_ties_away_from_zero():
    # 1 + 2^-11 lies halfway between the TF32 values 1 and 1 + 2^-10
    x = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12])
    hi, lo = split_tf32(x)
    assert hi.tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0]
    assert torch.equal(hi + lo, x)


@pytest.mark.parametrize("tile", [352, 128])
def test_chain_plans_fill_the_card_or_use_all_of_k(tile):
    """At the main paths' 9 chain shapes (batch 8) every launch has at least
    MIN_BLOCKS blocks, or K is split into single stages; the channel tile
    covers Cout with no more than one partial tile."""
    levels = [(1, 2, 48, True), (2, 48, 96, True), (4, 96, 192, True),
              (8, 192, 384, True), (16, 384, 384, False), (8, 576, 192, True),
              (4, 288, 96, True), (2, 144, 48, True), (1, 72, 24, True)]
    for dtype in (torch.float32, torch.bfloat16):
        for div, cin, nf, lead in levels:
            torch.manual_seed(0)
            wts = FusedChainWeights.from_modules(
                RDB(nf), lead=torch.nn.Conv2d(cin, nf, 3, padding=1) if lead else None,
                res=ResBlock(nf), dtype=dtype)
            h = tile // div
            for name, p in chain_conv_plans(8, h, h, cin, wts):
                assert p["blocks"] >= MIN_BLOCKS or p["splits"] == p["k_stages"], name
                assert p["np"] % 8 == 0 and p["np"] <= (96 if dtype == torch.float32 else 192)
                assert p["splits"] == 1 or (p["splits"] - 1) * -(-p["k_stages"] // p["splits"]) < p["k_stages"]


def test_conv_plan_tiles_and_splits():
    # 4 M-tiles side by side: 8 x 32 pixels per block
    assert conv_plan(8, 352, 352, 8, 48, torch.bfloat16) == dict(
        np=48, mt=4, n_tiles=1, k_stages=1, splits=1, blocks=44 * 11 * 8)
    assert conv_plan(8, 44, 44, 192, 384, torch.bfloat16)["mt"] == 1
    p = conv_plan(8, 8, 8, 384, 32, torch.bfloat16)  # E6 bottleneck growth
    assert (p["np"], p["k_stages"], p["splits"], p["blocks"]) == (32, 24, 24, 192)
    p = conv_plan(8, 8, 8, 512, 384, torch.float32)  # E6 bottleneck LFF
    assert (p["np"], p["n_tiles"], p["k_stages"]) == (96, 4, 64)
    assert p["blocks"] >= MIN_BLOCKS
    assert conv_plan(1, 1, 1, 1, 24, torch.float32)["np"] == 32


def test_conv_plan_matches_the_kernels_tables():
    """conv_plan's tile widths, M-tiles and tile rows are the ones
    csrc/fused_block.cu compiles (dispatch, m_tiles, kTile)."""
    src = (REPO / "image_denoising_tpu_torch" / "csrc" / "fused_block.cu").read_text()
    # m_tiles(np) = np <= a ? b : (np <= c ? d : e)
    a, b, c, d, e = map(int, re.search(
        r"m_tiles\(int np\) \{ return np <= (\d+) \? (\d+) : "
        r"\(np <= (\d+) \? (\d+) : (\d+)\); \}", src).groups())
    body = src[src.index("cudaError_t dispatch("):src.index("}  // namespace")]
    both, bf16_only = body.split("if constexpr (sizeof(T) == 2)")
    case = r"case (\d+): return launch<T, \1>"
    widths = {torch.float32: [int(v) for v in re.findall(case, both)]}
    widths[torch.bfloat16] = widths[torch.float32] + [
        int(v) for v in re.findall(case, bf16_only)]
    assert int(re.search(r"constexpr int kTile = (\d+);", src).group(1)) == fb.TILE
    assert tuple(widths[torch.bfloat16]) == fb._WIDTHS
    for dtype, compiled in widths.items():
        assert fb._MAX_WIDTH[dtype] == max(compiled)
        for np_ in compiled:
            p = conv_plan(8, 352, 352, 64, np_, dtype)
            assert p["np"] == np_
            assert p["mt"] == (b if np_ <= a else (d if np_ <= c else e))


def test_wgmma_header_is_up_to_date():
    gen = _load("gen_wgmma", REPO / "scripts" / "gen_wgmma.py")
    assert gen.OUT.read_text() == gen.render()


# ---------------------------------------------------------------- 3xTF32


def _x3_matmul(a, b):
    """a @ b.T as the kernels compute it in float32: hi.hi + hi.lo + lo.hi,
    each TF32 product exact, lo truncated to TF32 as the tensor cores read it,
    float32 sums."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    al, bl = _trunc_tf32(al), _trunc_tf32(bl)
    return ah @ bh.T + (ah @ bl.T + al @ bh.T)


def _x1_matmul(a, b):
    """One TF32 product of the float32 operands, as the tensor cores read
    them (truncated): a kernel that skips the split."""
    return _trunc_tf32(a) @ _trunc_tf32(b).T


def _hi(x):
    """x rounded to TF32: ``split_tf32``'s hi."""
    return split_tf32(x)[0]


def _hi_matmul(a, b):
    """One TF32 product of the rounded hi parts: a kernel that splits and
    then drops the hi·lo and lo·hi products."""
    return _hi(a) @ _hi(b).T


@pytest.mark.parametrize("d", [256, 4096])
def test_3xtf32_retrieval_meets_the_f64_excess_tolerance(d):
    """chip_smoke.py's float32 retrieval check, on its kind of data at a
    smaller size: a duplicated row, queries near no row, and near ties
    (chip_smoke.near_tie_rows) twice the tolerance apart. 3xTF32 products
    pick within the tolerance of the float64 best and get every near tie
    right; one truncated TF32 product picks the wrong row of every near tie,
    an excess of twice the tolerance."""
    cs = _load("chip_smoke", REPO / "chip_smoke.py")
    g = torch.Generator().manual_seed(d)
    n, b = 600, 24
    bank = torch.rand((n, d), generator=g)
    bank[500] = bank[100]
    q = bank[torch.randint(0, n, (b,), generator=g)] + 0.1 * torch.randn((b, d), generator=g)
    q[0] = bank[100]
    q[1:4] = torch.rand((3, d), generator=g)  # far from every row
    tie = slice(4, 4 + cs.N_TIE)
    q[tie] = torch.rand((cs.N_TIE, d), generator=g)
    bn = max(float(bank.norm(dim=1).max()), (1 + cs.TIE_S) * float(q[tie].norm(dim=1).max()))
    gap = 2 * cs.f32_pick_tol(d, float(q.norm(dim=1).max()), bn)
    a_rows, b_rows = cs.near_tie_rows(q[tie], gap)
    bank[200:200 + 2 * cs.N_TIE:2] = a_rows
    bank[201:201 + 2 * cs.N_TIE:2] = b_rows
    sqn = (bank ** 2).sum(1)
    exact = (bank.double() ** 2).sum(1)[None] - 2.0 * (q.double() @ bank.double().T)
    best = exact.min(1).values
    tol = cs.f32_pick_tol(d, float(q.norm(dim=1).max()), float(bank.norm(dim=1).max()))

    def excess(matmul):
        pick = (sqn[None] - 2.0 * matmul(q, bank)).argmin(1)
        return exact.gather(1, pick[:, None])[:, 0] - best, pick

    x3, pick = excess(_x3_matmul)
    assert float(x3.max()) <= tol
    assert int(pick[0]) == 100
    assert pick[tie].tolist() == list(range(201, 201 + 2 * cs.N_TIE, 2))
    x1, pick = excess(_x1_matmul)
    assert pick[tie].tolist() == list(range(200, 200 + 2 * cs.N_TIE, 2))
    assert float(x1[tie].min()) > 1.9 * tol
    # the products' own error: below 2^-19 of sum |q b| for 3xTF32, above
    # it for one TF32 product
    scale = q.abs().double() @ bank.abs().double().T
    for matmul, below in ((_x3_matmul, True), (_x1_matmul, False), (_hi_matmul, False)):
        err = (matmul(q, bank).double() - q.double() @ bank.double().T).abs()
        assert (float((err / scale).max()) < 2.0 ** -19) == below
    # a kernel that rounds to TF32 and keeps only hi·hi errs in the distance
    # by more than the tolerance at D = 256, by less at D = 4096 (the limit
    # grows with D faster than that error): the limit cannot see it there
    hi_err = float(((sqn[None] - 2.0 * _hi_matmul(q, bank)).double() - exact).abs().max())
    assert (hi_err > tol) == (d == 256)


def _x3_conv2d(x, w, b=None, padding=0, **kw):
    xh, xl = split_tf32(x)
    wh, wl = split_tf32(w)
    xl, wl = _trunc_tf32(xl), _trunc_tf32(wl)
    out = F.conv2d(xh, wh, None, padding=padding) + (
        F.conv2d(xh, wl, None, padding=padding) + F.conv2d(xl, wh, None, padding=padding))
    return out if b is None else out + b[None, :, None, None]


def _one_conv2d(read, x, w, b=None, padding=0, **kw):
    """A conv through one TF32 product of ``read(x)`` and ``read(w)``:
    truncated (``_trunc_tf32``) or rounded (``_hi``)."""
    out = F.conv2d(read(x), read(w), None, padding=padding)
    return out if b is None else out + b[None, :, None, None]


@pytest.mark.parametrize("lead,nf,shape", [(True, 24, (2, 10, 14)),
                                           (False, 96, (1, 8, 8))])
def test_3xtf32_chain_meets_the_f32_tolerance(monkeypatch, lead, nf, shape):
    """Every conv of the chain through emulated 3xTF32 products stays within
    the float32 chain tolerance 1e-4·max(1, max|ref|) of the plain version;
    through one TF32 product, truncated or rounded, it does not."""
    torch.manual_seed(nf)
    wts = FusedChainWeights.from_modules(
        RDB(nf), lead=torch.nn.Conv2d(2, nf, 3, padding=1) if lead else None,
        res=ResBlock(nf))
    x = torch.randn(*shape, 2 if lead else nf)
    want = fused_rdb_chain_reference(x, wts)
    monkeypatch.setattr(fb, "F", types.SimpleNamespace(
        conv2d=_x3_conv2d, leaky_relu=F.leaky_relu, pad=F.pad))
    got = fused_rdb_chain_reference(x, wts)
    for g, w in zip(got, want):
        tol = 1e-4 * max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= tol
        assert not torch.equal(g, w)  # the emulation did run
    # one TF32 product, truncated or rounded, exceeds that tolerance
    for read in (_trunc_tf32, _hi):
        monkeypatch.setattr(fb, "F", types.SimpleNamespace(
            conv2d=functools.partial(_one_conv2d, read), leaky_relu=F.leaky_relu, pad=F.pad))
        got = fused_rdb_chain_reference(x, wts)
        assert max(float((g - w).abs().max()) / (1e-4 * max(1.0, float(w.abs().max())))
                   for g, w in zip(got, want)) > 1.0, read.__name__
