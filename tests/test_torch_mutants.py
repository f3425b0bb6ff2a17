"""The mutant run (scripts/cuda/mutants.py) and the checks it holds the
kernels' mutants to (chip_smoke.py's decision functions), on the CPU.

Each mutant's patch applies exactly once to today's csrc/ and its library
would build under build/mutants/; a patch that does not apply fails the run
before any build; the loader swap always restores the real loaders. Each
check function accepts the plain versions' outputs and rejects a plain
emulation of the faults the card's mutants carry. The mutants themselves
build and run only on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py's [mutants])."""
import functools
import math
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import image_denoising_tpu_torch.ops.fused_block as fb
from image_denoising_tpu_torch.memory.retrieval import top1_l2_retrieval_reference
from image_denoising_tpu_torch.models.improved_unet import RDB, ResBlock
from image_denoising_tpu_torch.ops import _build, neighbor
from image_denoising_tpu_torch.ops.rng import MASK32, philox4x32_10

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_port_helpers import load_script  # noqa: E402
from test_torch_tf32x3 import _hi, _hi_matmul, _one_conv2d, _x3_conv2d, _x3_matmul  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
cs = load_script(REPO / "chip_smoke.py", "chip_smoke")
mut = load_script(REPO / "scripts" / "cuda" / "mutants.py", "cuda_mutants")
NAMES = [m.name for m in mut.MUTANTS]


# ------------------------------------------------------------ the table


@pytest.mark.parametrize("name", NAMES)
def test_each_patch_applies_once_and_changes_the_source(name):
    m = next(m for m in mut.MUTANTS if m.name == name)
    text = (_build.CSRC_DIR / m.source).read_text()
    for old, new in m.hunks:
        assert text.count(old) == 1 and old != new
    out = mut.patched(m, text)
    assert out != text
    assert all(new in out for _, new in m.hunks if new)
    assert set(m.expect) <= set(mut.KERNELS[m.kernel][2])


def test_every_kernel_has_at_least_three_mutants():
    assert {k: sum(m.kernel == k for m in mut.MUTANTS) for k in mut.KERNELS} == dict(
        chain=6, retrieval=4, subsample=3)
    assert len(set(NAMES)) == len(NAMES)


@pytest.mark.parametrize("hunk", ["missing", "twice"])
def test_a_snippet_not_found_exactly_once_is_refused(hunk):
    m = mut.MUTANTS[0]
    text = (_build.CSRC_DIR / m.source).read_text()
    if hunk == "twice":
        text += m.hunks[0][0]
    else:
        text = text.replace(m.hunks[0][0], "")
    with pytest.raises(mut.PatchError, match="not once"):
        mut.patched(m, text)


def test_a_broken_patch_fails_the_run_before_any_build(monkeypatch, tmp_path):
    built = []
    broken = mut.Mutant("broken", "chain", (("no such line;", "x;"),), ("kernel_f32",))
    monkeypatch.setattr(mut, "MUTANT_ROOT", tmp_path)
    monkeypatch.setattr(mut, "MUTANTS", mut.MUTANTS + (broken,))
    monkeypatch.setattr(mut, "compile_mutant", lambda src: built.append(src))
    with pytest.raises(mut.PatchError, match="broken"):
        mut.run(0)
    assert built == []
    # and the script as a whole exits non-zero here (no card)
    assert mut.main([]) == 1


def test_mutant_libraries_build_under_build_mutants(monkeypatch, tmp_path):
    """A mutant's patched copy of csrc/ and its library lie in
    build/mutants/<name>/, never in the real libraries' build/kernels/, and
    it is compiled with ops/_build.py's own flags."""
    assert mut.MUTANT_ROOT == REPO / "build" / "mutants"
    assert not mut.MUTANT_ROOT.is_relative_to(_build.BUILD_DIR)
    assert not _build.BUILD_DIR.is_relative_to(mut.MUTANT_ROOT)
    calls = []

    def compile_(src, compiler, flags, salt, out_dir):
        calls.append((src, compiler, flags, salt, out_dir))
        return out_dir / f"lib{src.stem}_0.so", ""

    monkeypatch.setattr(mut, "MUTANT_ROOT", tmp_path / "build" / "mutants")
    monkeypatch.setattr(_build, "_compile", compile_)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    libs = mut.build_all()
    assert sorted(libs) == sorted(NAMES)
    for src, compiler, flags, salt, out_dir in calls:
        m = next(m for m in mut.MUTANTS if m.name == out_dir.name)
        assert out_dir == mut.MUTANT_ROOT / m.name and src == out_dir / m.source
        assert (compiler, flags) == ("nvcc", _build.NVCC_FLAGS)
        assert salt == _build.cuda_headers(_build.CSRC_DIR)
        assert {p.name for p in out_dir.iterdir()} >= {
            p.name for p in _build.CSRC_DIR.glob("*.cu*")}
        assert src.read_text() == mut.patched(m, (_build.CSRC_DIR / m.source).read_text())
        assert libs[m.name].parent == out_dir


@pytest.mark.parametrize("kernel", sorted(mut.KERNELS))
def test_loader_swap_restores_the_loader_and_clears_its_cache(monkeypatch, kernel):
    source, loader, _ = mut.KERNELS[kernel]
    real = getattr(_build, loader)
    fake_real, fake_mutant = object(), object()
    monkeypatch.setattr(_build, "build", lambda *a: (Path("lib.so"), ""))
    monkeypatch.setattr(_build, "open_library", lambda src, path: fake_real)
    real.cache_clear()
    assert real() is fake_real and real.cache_info().currsize == 1
    with pytest.raises(KeyError):
        with mut.swapped_loader(kernel, fake_mutant):
            assert getattr(_build, loader)() is fake_mutant
            raise KeyError("the body fails")
    assert getattr(_build, loader) is real
    assert real.cache_info().currsize == 0


# ------------------------------------------------------------ the chain


def _chain(dtype, nf=48, lead=True, shape=(2, 24, 24), seed=0):
    torch.manual_seed(seed)
    wts = fb.FusedChainWeights.from_modules(
        RDB(nf), lead=torch.nn.Conv2d(2, nf, 3, padding=1) if lead else None,
        res=ResBlock(nf), dtype=dtype)
    x = torch.randn(*shape, 2 if lead else nf).to(dtype)
    return x, wts


def _with_conv(monkeypatch, conv2d):
    monkeypatch.setattr(fb, "F", types.SimpleNamespace(
        conv2d=conv2d, leaky_relu=F.leaky_relu, pad=F.pad))


def _f64_conv2d(x, w, b=None, padding=0, **kw):
    """A conv whose sums run in float64: float32 sums in another order, as
    the kernel's are."""
    out = F.conv2d(x.double(), w.double(), None if b is None else b.double(),
                   padding=padding)
    return out.float()


def _low_row_conv2d(x, w, b=None, padding=0, **kw):
    """``halo_row``: every conv reads its input one row low."""
    return F.conv2d(F.pad(x[:, :, 1:], (0, 0, 0, 1)), w, b, padding=padding)


def _lff_unrounded(x, weights):
    """``residual_bf16_round``: fused_rdb_chain_reference with the LFF term
    added to the residual without its own rounding to the working type."""
    dt = x.dtype

    def conv(inp, w_hwio, b, pad):
        return F.conv2d(inp.float(), w_hwio.permute(3, 2, 0, 1).float(),
                        None if b is None else b.float(), padding=pad)

    h = fb._leaky(conv(x.permute(0, 3, 1, 2), weights.lead_w, weights.lead_b, 1)).to(dt)
    feats = [h]
    for w, b in zip(weights.growth_w, weights.growth_b):
        feats.append(fb._leaky(conv(torch.cat(feats, 1), w, b, 1)).to(dt))
    lff = conv(torch.cat(feats, 1), weights.lff_w[None, None], weights.lff_b, 0)
    rdb = (h.float() + lff).to(dt)
    c0 = conv(rdb, weights.res0_w, None, 1).to(dt)
    return rdb.permute(0, 2, 3, 1), c0.permute(0, 2, 3, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chain_checks_accept_the_plain_version_and_reordered_sums(monkeypatch, dtype):
    dname = str(dtype).split(".")[1]
    x, wts = _chain(dtype)
    want = fb.fused_rdb_chain_reference(x, wts)
    assert cs.chain_verdict(want, want, dname) == cs.Verdict(True, 0.0, 0.0, cs.chain_tol(
        dname, max(float(w.float().abs().max()) for w in want)), "max_abs_err")
    _with_conv(monkeypatch, _x3_conv2d if dtype == torch.float32 else _f64_conv2d)
    got = fb.fused_rdb_chain_reference(x, wts)
    check = cs.chain_verdict(got, want, dname)
    assert check.ok and check.margin < 0.5
    if dtype == torch.bfloat16:
        flips = cs.chain_flip_verdict(got, want)
        assert flips.ok and flips.reading < 0.2 * cs.CHAIN_BF16_FLIP_SHARE


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chain_check_rejects_the_slope_and_the_halo_row(monkeypatch, dtype):
    """``leaky_slope`` (0.25 for 0.2) and ``halo_row``: outside the limits in
    both types (bf16's slope by a margin of 1.74 at this small chain)."""
    dname = str(dtype).split(".")[1]
    x, wts = _chain(dtype)
    want = fb.fused_rdb_chain_reference(x, wts)
    monkeypatch.setattr(fb, "LEAKY_SLOPE", 0.25)
    assert cs.chain_verdict(fb.fused_rdb_chain_reference(x, wts), want, dname).margin > (
        10 if dtype == torch.float32 else 1.5)
    monkeypatch.setattr(fb, "LEAKY_SLOPE", 0.2)
    _with_conv(monkeypatch, _low_row_conv2d)
    assert cs.chain_verdict(fb.fused_rdb_chain_reference(x, wts), want, dname).margin > 10


def test_chain_f32_check_rejects_one_rounded_tf32_product(monkeypatch):
    """``one_tf32``: the f32 path without the two correction products is one
    product of the TF32-rounded operands."""
    x, wts = _chain(torch.float32)
    want = fb.fused_rdb_chain_reference(x, wts)
    _with_conv(monkeypatch, functools.partial(_one_conv2d, _hi))
    assert not cs.chain_verdict(fb.fused_rdb_chain_reference(x, wts), want, "float32").ok


def test_bf16_lff_rounded_once_less_passes_the_limit_but_not_the_unequal_share():
    """``residual_bf16_round``: one rounding dropped moves each RDB output by
    at most an ulp, inside the 4-ulp limit, but a fifth or more of them; a
    kernel that rounds where the plain version does moves a few in a
    thousand (the float64-sum test above)."""
    x, wts = _chain(torch.bfloat16)
    want = fb.fused_rdb_chain_reference(x, wts)
    got = _lff_unrounded(x, wts)
    assert cs.chain_verdict(got, want, "bfloat16").ok
    flips = cs.chain_flip_verdict(got, want)
    assert not flips.ok and flips.reading > 0.2


def test_chain_check_rejects_a_dropped_split_k_partial_sum(monkeypatch):
    """``splitk_last``: at the E6 bottleneck (batch 8 of 8², nf 384) every
    growth conv splits K; the finish kernel then adds all splits but the
    last, the input channels of its K-stages."""
    dtype = torch.float32
    x, wts = _chain(dtype, nf=384, lead=False, shape=(8, 8, 8), seed=1)
    want = fb.fused_rdb_chain_reference(x, wts)
    chunk = 16 // x.element_size()
    dropped = []

    def conv2d(inp, w, b=None, padding=0, **kw):
        p = fb.conv_plan(inp.shape[0], inp.shape[2], inp.shape[3], inp.shape[1],
                         w.shape[0], dtype)
        if p["splits"] > 1:
            keep = (p["splits"] - 1) * -(-p["k_stages"] // p["splits"]) * 2 * chunk
            dropped.append(inp.shape[1] - keep)
            inp = torch.cat([inp[:, :keep], torch.zeros_like(inp[:, keep:])], 1)
        return F.conv2d(inp, w, b, padding=padding)

    _with_conv(monkeypatch, conv2d)
    got = fb.fused_rdb_chain_reference(x, wts)
    assert dropped and all(d > 0 for d in dropped)
    assert cs.chain_verdict(got, want, "float32").margin > 10


# ------------------------------------------------------------ retrieval


def _retrieval_case(d=256, n=600, b=32, seed=1):
    """chip_smoke.retrieval_case's kinds of rows and queries at a CPU size:
    rows 100 and 500 equal (query 0 copies them), queries near no row, near
    ties (rows 200-211), TF32-edge ties (rows 300-311) and a copy of the
    last row (query 16)."""
    g = torch.Generator().manual_seed(seed)
    bank = torch.rand((n, d), generator=g)
    bank[500] = bank[100]
    q = bank[torch.randint(0, n, (b,), generator=g)] + 0.1 * torch.randn((b, d), generator=g)
    q[0] = bank[100]
    q[1:4] = torch.rand((3, d), generator=g)
    tie, lo = slice(4, 4 + cs.N_TIE), slice(10, 10 + cs.N_LO_TIE)
    q[tie] = torch.rand((cs.N_TIE, d), generator=g)
    q[lo] = cs.above_tf32(torch.rand((cs.N_LO_TIE, d), generator=g))
    q[16] = bank[n - 1]
    ties = torch.cat([q[tie], q[lo]])
    bn = max(float(bank.norm(dim=1).max()), (1 + cs.TIE_S) * float(ties.norm(dim=1).max()))
    tol = cs.f32_pick_tol(d, float(q.norm(dim=1).max()), bn)
    a_rows, b_rows = cs.near_tie_rows(q[tie], 2 * tol)
    bank[200:212:2], bank[201:212:2] = a_rows, b_rows
    a_rows, b_rows = cs.lo_tie_rows(q[lo], cs.LO_TIE_GAP * tol)
    bank[300:312:2], bank[301:312:2] = a_rows, b_rows
    return bank, q, lo


def _picks(scores, last_tie=False, skip_last=False):
    """argmin of each row of ``scores``: the first minimum, or the last
    (``ties_last``); without the last column (``tail_row``)."""
    if skip_last:
        scores = scores[:, :-1]
    if last_tie:
        return (scores.shape[1] - 1 - scores.flip(1).argmin(1)).int()
    return scores.argmin(1).int()


def _regime(dname, bank, q):
    if dname == "int8":
        b8 = torch.clamp(torch.round(bank * 255.0) - 128.0, -128, 127).to(torch.int8)
        q8 = torch.clamp(torch.round(q * 255.0) - 128.0, -128, 127).to(torch.int8)
        sqn = (b8.int() ** 2).sum(1, dtype=torch.int32)
        scores = sqn.long()[None] - 2 * (q8.long() @ b8.long().T)
        return b8, sqn, q8, scores
    sqn = (bank ** 2).sum(1)
    return bank, sqn, q, sqn[None] - 2.0 * _x3_matmul(q, bank)


@pytest.mark.parametrize("dname", ["float32", "int8"])
def test_retrieval_check_accepts_the_plain_version_and_3xtf32(dname):
    bank, q, lo = _retrieval_case()
    b_, sqn, qk, scores = _regime(dname, bank, q)
    want = cs.top1_want(dname, b_, sqn, qk)
    plain = top1_l2_retrieval_reference(qk, b_, sqn)
    small = [(b, plain[:b]) for b in cs.FT_QUERY_COUNTS]
    assert cs.top1_verdict(dname, plain, want, small, plain, dup=100).ok
    picks = _picks(scores)
    assert cs.top1_verdict(dname, picks, want, dup=100).ok
    if dname == "float32":  # the TF32-edge ties go to the nearer row
        assert picks[lo].tolist() == list(range(301, 312, 2))
        assert int(picks[16]) == bank.shape[0] - 1


@pytest.mark.parametrize("dname", ["float32", "int8"])
@pytest.mark.parametrize("fault", ["ties_last", "tail_row"])
def test_retrieval_check_rejects_the_last_tie_and_the_missing_last_row(dname, fault):
    bank, q, _ = _retrieval_case()
    b_, sqn, qk, scores = _regime(dname, bank, q)
    want = cs.top1_want(dname, b_, sqn, qk)
    picks = _picks(scores, last_tie=fault == "ties_last", skip_last=fault == "tail_row")
    check = cs.top1_verdict(dname, picks, want, dup=100)
    assert not check.ok and math.isinf(check.margin)
    if fault == "ties_last":
        assert int(picks[0]) == 500 and "duplicated" in check.what
    else:
        assert int(picks[16]) != bank.shape[0] - 1


def test_retrieval_f32_check_sees_hi_hi_only_at_the_production_d():
    """``hi_hi_only`` at D = 16,384: the products of the TF32-rounded hi
    parts alone err by less than the float32 tolerance on rows of random
    values, so they pass the old check, but the TF32-edge ties
    (``lo_tie_rows``) flip to the farther row, LO_TIE_GAP tolerances off."""
    bank, q, lo = _retrieval_case(d=cs.PATCH_D)
    want = cs.top1_want("float32", bank, (bank ** 2).sum(1), q)
    sqn = (bank ** 2).sum(1)
    hi = _picks(sqn[None] - 2.0 * _hi_matmul(q, bank))
    assert hi[lo].tolist() == list(range(300, 311, 2))
    check = cs.top1_verdict("float32", hi, want, dup=100)
    assert not check.ok
    readings = cs.top1_readings("float32", hi, want)
    assert readings["off_best"] == cs.N_LO_TIE
    assert readings["excess"] > 0.99 * cs.LO_TIE_GAP * readings["tol"]
    others = torch.ones(len(q), dtype=torch.bool)
    others[lo] = False
    assert all(hi[others] == _picks(sqn[None] - 2.0 * _x3_matmul(q, bank))[others])
    assert cs.top1_verdict("float32", _picks(sqn[None] - 2.0 * _x3_matmul(q, bank)),
                           want, dup=100).ok


def test_e6_index_check():
    from image_denoising_tpu_torch.eval import tiled

    grid = tiled.edge_aligned_grid(cs.FRAME, cs.FRAME, cs.E6_TILE, cs.OVERLAP)
    own = torch.tensor([f * cs.E6_GRID ** 2 + (r // cs.E6_STRIDE) * cs.E6_GRID
                        + c // cs.E6_STRIDE for f in range(cs.E6_BURST) for r, c in grid])
    other = torch.randint(0, cs.E6_BANK_ROWS, (cs.E6_TILES,))
    assert len(own) == cs.E6_TILES
    assert cs.e6_index_verdict([own, other], [own, other]).ok
    moved = other.clone()
    moved[3] += 1
    assert cs.e6_index_verdict([own, moved], [own, other]).reading == 1
    assert not cs.e6_index_verdict([other, other], [other, other]).ok


# ------------------------------------------------------------ sub-sampler


def _maps(seed, shape, quad=False):
    """The plain draw, or ``quad_draw``'s: every cell of a quad (4 cells of
    a cell row, from a multiple of 4) takes its first cell's draw."""
    n, h2, w2 = shape[0], shape[2] // 2, shape[3] // 2
    cell = torch.arange(h2 * w2, dtype=torch.int64)
    if quad:
        cell = cell - (cell % w2) % 4
    r = philox4x32_10(cell[None], torch.arange(n)[:, None], 0, 0, seed & MASK32,
                      seed >> 32)[0] & 7
    pair = neighbor._IDX_PAIR[r].reshape(n, h2, w2, 2)
    return pair[..., 0], pair[..., 1]


def _result(img, sel):
    return (neighbor.generate_subimages(img, sel[0]), neighbor.generate_subimages(img, sel[1]),
            sel)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_subsample_checks_reject_the_emulated_mutants(monkeypatch, dtype):
    seed = 0x1234_5678_9ABC
    img = torch.from_numpy(np.random.default_rng(2).random((2, 3, 16, 24), dtype=np.float32)
                           ).to(dtype)
    want = neighbor.subsample_pair(seed, img)
    assert cs.subsample_bits_verdict(want, want).ok
    assert cs.subsample_bits_verdict(_result(img, _maps(seed, img.shape)), want).ok
    quad = _result(img, _maps(seed, img.shape, quad=True))
    assert not cs.subsample_bits_verdict(quad, want).ok
    swapped = neighbor._IDX_PAIR[[0, 2, 1, 3, 4, 5, 6, 7]]
    monkeypatch.setattr(neighbor, "_IDX_PAIR", swapped)
    check = cs.subsample_bits_verdict(neighbor.subsample_pair(seed, img), want)
    assert not check.ok and check.reading > 0


def test_subsample_bits_check_rejects_a_skipped_partial_quad():
    """``scalar_tail``: W/2 = 7, the last quad of each cell row has 3 cells;
    a kernel that skips them leaves the poisoned outputs (0xFF) there."""
    seed = 77
    img = torch.rand((2, 1, 8, 14))
    want = neighbor.subsample_pair(seed, img)
    got = [t.clone() for t in (want[0], want[1], *want[2])]
    for t in got:
        t[..., 4:] = -1 if t.dtype == torch.int32 else float("nan")
    assert not cs.subsample_bits_verdict((got[0], got[1], (got[2], got[3])), want).ok
    assert not cs.subsample_pairs_verdict(got[2], got[3]).ok


def _stand_in(buffers):
    """A stand-in for the sub-sampler: call k returns its four outputs in
    ``buffers[k % len(buffers)]`` and writes them on the first call only."""
    calls = []

    def fn():
        buf = buffers[len(calls) % len(buffers)]
        if not calls:
            buf.fill_(0.5)
        calls.append(1)
        sel = buf[8:].view(torch.int32)
        return buf[:4].view(1, 1, 2, 2), buf[4:8].view(1, 1, 2, 2), (sel[:4].view(1, 2, 2),
                                                                     sel[4:].view(1, 2, 2))

    return fn


@pytest.mark.parametrize("places", ["the same memory", "other memory"])
def test_poisoned_outputs_must_lie_in_the_poisoned_memory(places):
    """``poisoned`` fills a first call's outputs with 0xFF and calls again:
    a second call that writes nothing reads NaN and selector -1 where it
    lands in that memory; one whose outputs land elsewhere raises."""
    buffers = [torch.zeros(16) for _ in range(1 if places == "the same memory" else 2)]
    if len(buffers) == 2:
        with pytest.raises(AssertionError, match="outside the poisoned memory"):
            cs.poisoned(_stand_in(buffers))
        return
    got = cs.poisoned(_stand_in(buffers))
    assert torch.isnan(got[0]).all() and torch.isnan(got[1]).all()
    assert all((s == -1).all() for s in got[2])


def test_subsample_pairs_check_sees_the_frequencies_not_the_table(monkeypatch):
    """The pair check holds the 8 pairs at 1/8 each at the N2N shape: a
    table with two draws swapped (``pair_table``) keeps both, so only
    bit-equality catches it; a pair outside the 8, or one drawn too often,
    fails it."""
    img = torch.rand((4, 1, 352, 352))
    sel1, sel2 = neighbor.subsample_pair(5, img)[2]
    check = cs.subsample_pairs_verdict(sel1, sel2)
    assert check.ok and check.limit == cs.PAIR_FREQ_TOL
    monkeypatch.setattr(neighbor, "_IDX_PAIR", neighbor._IDX_PAIR[[0, 2, 1, 3, 4, 5, 6, 7]])
    assert cs.subsample_pairs_verdict(*neighbor.subsample_pair(5, img)[2]).ok
    bad = sel2.clone()
    bad[0, 0, 0] = sel1[0, 0, 0]  # (p, p): no pair
    assert cs.subsample_pairs_verdict(sel1, bad).reading == 1
    often1, often2 = sel1.clone(), sel2.clone()
    often1[:, :10], often2[:, :10] = 0, 1  # pair (0, 1) on 10 of 176 rows
    assert not cs.subsample_pairs_verdict(often1, often2).ok


# ------------------------------------------------------------ end to end


def test_levels_and_loss_checks():
    ok32 = dict(max_level_diff=1, mean_level_diff=0.001, frac_pixels_diff=1e-3)
    assert cs.levels_verdict("float32", ok32, ok32).ok
    assert not cs.levels_verdict("float32", dict(ok32, max_level_diff=2), ok32).ok
    assert not cs.levels_verdict("float32", dict(ok32, frac_pixels_diff=2e-3), ok32).ok
    ok16 = dict(max_level_diff=8, mean_level_diff=1.0, frac_pixels_diff=0.5)
    assert cs.levels_verdict("bfloat16", ok16, ok16).ok
    check = cs.levels_verdict("bfloat16", ok16, dict(ok16, mean_level_diff=1.5))
    assert not check.ok and check.margin == 1.5 and "bfloat16" in check.what
    losses = [0.5, 0.4, 0.3]
    assert cs.loss_verdict(losses, losses) == cs.Verdict(True, 0.0, 0.0, cs.TRAIN_LOSS_RTOL,
                                                         "largest relative loss difference")
    assert not cs.loss_verdict([0.5, 0.4, 0.3 * 1.002], losses).ok
    nan = cs.loss_verdict([0.5, float("nan"), 0.3], losses)
    assert not nan.ok and math.isinf(nan.margin)


def test_verdict_margins():
    assert cs.verdict(0, 0, "x") == cs.Verdict(True, 0.0, 0.0, 0.0, "x")
    assert cs.verdict(2, 0, "x").margin == math.inf
    assert cs.verdict(3.0, 2.0, "x") == cs.Verdict(False, 1.5, 3.0, 2.0, "x")
    both = cs.worst(cs.verdict(1.0, 2.0, "a"), cs.verdict(0, 0, "b"), cs.verdict(3.0, 2.0, "c"))
    assert both == cs.Verdict(False, 1.5, 3.0, 2.0, "c")
