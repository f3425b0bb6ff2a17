"""The tensor cores' truncating float32 accumulator, on the CPU: the numpy
model of it (scripts/cuda/accumulator_model.py) against chip_smoke.py's
chain limit, the one-way chain case that exposes it (chip_smoke.py's
``one_way_cases``) through the JAX package and the port, the bf16-exact
retrieval ties (``bf16_tie_rows``), and the ptxas report that shows a
second accumulator fits in registers. The kernels run on the card only
(chip_smoke.py's [kernels] and [mutants], tests/test_torch_kernels_cuda.py).
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_denoising_tpu.ops.fused_block_pallas import (
    FusedChainWeights as JaxChainWeights,
    fused_rdb_chain as jax_fused_rdb_chain,
)
from image_denoising_tpu_torch.ops.fused_block import (
    FusedChainWeights,
    conv_plan,
    fused_rdb_chain,
    fused_rdb_chain_reference,
)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_port_helpers import load_script, one_torch_thread  # noqa: E402,F401
from test_torch_fused_block import _LevelHead, _np_tree, _state_dict  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
cs = load_script(REPO / "chip_smoke.py", "chip_smoke")
model = load_script(REPO / "scripts" / "cuda" / "accumulator_model.py", "accumulator_model")


# ------------------------------------------------------------ the model


def test_model_truncates_toward_zero_and_splits_exactly():
    x = np.array([1.0 + 2.0 ** -30, -(1.0 + 2.0 ** -30), 3.0], np.float64)
    assert model.truncate(x).tolist() == [1.0, -1.0, 3.0]
    v = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    hi, lo = model.split_tf32(v)
    assert np.all(hi.view(np.int32) & 0x1FFF == 0)
    assert np.all(np.abs(v.astype(np.float64) - hi - lo) <= 2.0 ** -21 * np.abs(v))


def test_one_accumulator_over_up0_reads_a_third_of_the_limit_and_a_stage_sum_none():
    """up0's lead conv (K = 5,184, 1,944 instructions) on inputs of one
    sign: the truncations add up to 0.3 or more of chain_tol on one
    accumulator, and to at most 0.05 when each K-stage's 27 instructions
    start from zero."""
    one = model.chain_reading(576, one_way=True, per_stage=False)
    staged = model.chain_reading(576, one_way=True, per_stage=True)
    assert one >= 0.3
    assert staged <= 0.05
    assert one > 3 * cs.ONE_WAY_SHARE  # that conv alone: past the one-way limit


@pytest.mark.parametrize("cin", [192, 384])
def test_one_accumulator_error_grows_with_the_instructions(cin):
    """The one-accumulator error grows with the conv's K; the per-stage
    sum's does not."""
    assert model.chain_reading(cin, True, False) < model.chain_reading(576, True, False)
    assert model.chain_reading(cin, True, True) <= 0.05


def test_the_bf16_retrieval_tie_shift_is_a_fraction_of_a_tolerance():
    """One accumulator over D = 16,384 in bf16 (1,024 instructions) moves a
    near tie's gap by well under one f32_pick_tol: ties at BF16_TIE_GAP
    hold."""
    shift = model.bf16_tie_shift(ties=2)
    assert 0.0 < shift < cs.BF16_TIE_GAP - 1.0


# ------------------------------------------------------------ the one-way case


def test_one_way_shapes_hold_the_most_instructions_on_one_accumulator():
    """E2's up0 lead conv puts 1,944 instructions on one accumulator (72
    K-stages of 27, no split); no float32 conv of E2's chain puts more; E6's
    up0 splits K across blocks."""
    def per_block(b, h, cin, cout):
        p = conv_plan(b, h, h, cin, cout, torch.float32)
        return 27 * -(-p["k_stages"] // p["splits"]), p["splits"]

    worst = max(per_block(cs.B, h, c, nf)[0] for _, h, cin, nf, lead in cs.chain_shapes(cs.TILE)
                for c in ([cin] if lead else []) + [nf + 32 * i for i in range(4)] + [nf])
    assert per_block(cs.B, cs.TILE // 8, 576, 192) == (1944, 1) == (worst, 1)
    assert [s[0] for s in cs.one_way_shapes("E2", cs.TILE)] == ["bottle", "up0"]
    (name, h, cin, nf, _), = cs.one_way_shapes("E6", cs.E6_TILE)
    assert name == "up0" and per_block(cs.B, h, cin, nf)[1] > 1


def test_one_way_case_is_non_negative_and_its_scale_relative():
    """On the CPU at a small width: inputs, weights and biases ≥ 0, not all
    zero, and the plain version's largest output ≥ 1 (chain_tol relative)."""
    (_, x, wts), = cs.one_way_cases(0, [("t", 8, 16, 16, True)], batch=2, device="cpu")
    assert x.shape == (2, 8, 8, 16) and x.dtype == torch.float32
    tensors = [x, wts.lead_w, wts.lead_b, *wts.growth_w, *wts.growth_b, wts.lff_w,
               wts.lff_b, wts.res0_w]
    assert all(bool((t >= 0).all()) and float(t.max()) > 0 for t in tensors)
    want = fused_rdb_chain_reference(x, wts)
    assert all(bool((w >= 0).all()) for w in want)
    assert max(float(w.max()) for w in want) >= 1.0
    again = next(cs.one_way_cases(0, [("t", 8, 16, 16, True)], batch=2, device="cpu"))
    assert torch.equal(again[1], x)


def test_one_way_case_through_jax_and_the_port_agrees_within_its_limit():
    """The one-way case's inputs (uniform in [0, 1), weights and biases in
    [0, fan_in^-½)) through the JAX package's chain (the Pallas kernel in
    interpret mode) and the port's: within ONE_WAY_SHARE of chain_tol."""
    rng = np.random.default_rng(5)
    nf = 16
    x = rng.uniform(0.0, 1.0, (2, 16, 24, 8)).astype(np.float32)
    params = _np_tree(jax.jit(_LevelHead(nf=nf).init)(jax.random.PRNGKey(0), x)["params"])

    def one_way(leaf):
        fan_in = int(np.prod(leaf.shape[:-1])) if leaf.ndim > 1 else 9 * nf
        return rng.uniform(0.0, fan_in ** -0.5, leaf.shape).astype(np.float32)

    params = jax.tree_util.tree_map(one_way, params)
    jp = dict(params, res_fake={"conv0": {"conv": {
        "kernel": params["res_c0"]["conv"]["kernel"]}}})
    jwts = JaxChainWeights(jp, lead="lead", rdb="rdb", res="res_fake", dtype=jnp.float32)
    want = [np.array(r) for r in jax_fused_rdb_chain(jnp.asarray(x), jwts, interpret=True)]
    wts = FusedChainWeights.from_state_dict(_state_dict(params, lead=True, res0=True),
                                            lead="lead", rdb="rdb", res="res")
    got = fused_rdb_chain(torch.from_numpy(x), wts)
    assert min(float(w.min()) for w in want) >= 0.0
    check = cs.chain_verdict(got, [torch.from_numpy(w) for w in want], "float32",
                             cs.ONE_WAY_SHARE)
    assert check.ok and check.margin < 0.5


# ------------------------------------------------------------ bf16 ties


@pytest.mark.parametrize("gap", [1.0, cs.BF16_TIE_GAP, 8.0])
def test_bf16_tie_rows_are_exact_in_bf16_and_the_gap_asked_for(gap):
    g = torch.Generator().manual_seed(3)
    q = torch.rand((3, cs.PATCH_D), generator=g).to(torch.bfloat16).float()
    qn = float(q.norm(dim=1).max())
    tol = cs.f32_pick_tol(cs.PATCH_D, qn, (1 + cs.TIE_S) * qn)
    a, b = cs.bf16_tie_rows(q, gap * tol)
    for t in (q, a, b):
        assert torch.equal(t, t.to(torch.bfloat16).float())
    qd = q.double()

    def dist(rows):
        return (rows.double() ** 2).sum(1) - 2.0 * (qd * rows.double()).sum(1)

    got = dist(a) - dist(b)
    assert bool(((got - gap * tol).abs() <= 0.01 * gap * tol).all())


def test_retrieval_case_keeps_bf16_ties_in_slots_of_their_own():
    """The bf16 ties' queries and rows sit apart from the other planted
    cases."""
    used_q = {0, *range(1, 1 + cs.N_FAR + cs.N_TIE), cs.LAST_Q,
              *range(cs.LO_TIE_Q, cs.LO_TIE_Q + cs.N_LO_TIE)}
    bf16_q = set(range(cs.BF16_TIE_Q, cs.BF16_TIE_Q + cs.N_BF16_TIE))
    assert not used_q & bf16_q and max(bf16_q) < cs.E6_TILES
    rows = set(range(cs.BF16_TIE_ROW, cs.BF16_TIE_ROW + 2 * cs.N_BF16_TIE))
    for start, count in ((cs.TIE_ROW, cs.N_TIE), (cs.LO_TIE_ROW, cs.N_LO_TIE)):
        assert not rows & set(range(start, start + 2 * count))
    assert not rows & {cs.DUP_LO, cs.DUP_HI} and max(rows) < cs.E6_BANK_ROWS - 1


# ------------------------------------------------------------ ptxas


_PTXAS = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__bf9523be_14_fused_block_cu_8ec96f3317chain_conv_kernelIfLi96EEEv14CUtensorMap_stNS_8ConvArgsE' for 'sm_90a'
ptxas info    : (C7519) warpgroup.arrive is injected in around line 18005 by compiler to allow use of registers in GMMA in function '_ZN47_GLOBAL__N__bf9523be_14_fused_block_cu_8ec96f3317chain_conv_kernelIfLi96EEEv14CUtensorMap_stNS_8ConvArgsE'
ptxas info    : Function properties for _ZN47_GLOBAL__N__bf9523be_14_fused_block_cu_8ec96f3317chain_conv_kernelIfLi96EEEv14CUtensorMap_stNS_8ConvArgsE
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 912 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__bf9523be_14_fused_block_cu_8ec96f3319chain_finish_kernelI13__nv_bfloat16EEv8ConvArgsi' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__bf9523be_14_fused_block_cu_8ec96f3319chain_finish_kernelI13__nv_bfloat16EEv8ConvArgsi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers, 488 bytes cmem[0]
"""


def test_ptxas_report_names_each_kernel_with_its_registers_and_spills():
    assert cs.ptxas_usage(_PTXAS) == {
        "chain_conv_kernel<float, 96>": dict(injected_arrives=1, stack=0, spill_stores=8,
                                             spill_loads=4, registers=255),
        "chain_finish_kernel<__nv_bfloat16>": dict(injected_arrives=0, stack=0,
                                                   spill_stores=0, spill_loads=0,
                                                   registers=32)}
    assert cs.ptxas_usage("") == {}


@pytest.mark.parametrize("mangled, name", [
    ("_ZN12_GLOBAL__N_111top1_kernelILi0ELi128EEEv14CUtensorMap_stS1_PKviiiiiPy",
     "top1_kernel<0, 128>"),
    ("_ZN12_GLOBAL__N_113keys_to_indexEPKyPii", "keys_to_index"),
    ("_Z12empty_kernelv", "empty_kernel"),
    ("not_mangled", "not_mangled"),
])
def test_kernel_names(mangled, name):
    assert cs.kernel_name(mangled) == name
