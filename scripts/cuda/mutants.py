#!/usr/bin/env python3
"""Seeded faults in the port's three Hopper kernels, each held to the
checks that stand on its path, on the card.

    python3 scripts/cuda/mutants.py        # on a machine with an NVIDIA GPU

A mutant is one kernel source of ``image_denoising_tpu_torch/csrc/`` with
one seeded fault (``MUTANTS``: its name, kernel, source, the exact snippets
it replaces and the checks expected to catch it). The shipped sources carry
no switch for a fault: a mutant is a patched copy of ``csrc/`` under
``build/mutants/<name>/`` (each snippet must occur exactly once in today's
source, so a rewrite that removes a site fails the run instead of testing
nothing), built by ``ops/_build.py``'s ``_compile`` with its own
``NVCC_FLAGS`` into that directory, never ``build/kernels/``, all at once.
While a mutant runs, the kernel's loader in ``ops/_build.py`` returns the
mutant's library; the real loader comes back, its cache cleared, when the
mutant's checks end, whatever they raise.

Each kernel's mutants run in a child process of their own, so a sticky CUDA
error cannot reach anything else; a child that dies fails the run and
catches nothing. A child runs its checks on the real kernel, then on each
mutant, then on the real kernel again. The checks are ``chip_smoke.py``'s
own decision functions on its own inputs:

* chain — ``kernel_f32``, ``kernel_bf16``: ``phase_chain``'s limits
  (``chain_verdict``) at E2's and E6's 9 chain shapes each (E6's split K),
  and ``kernel_f32`` also on the one-way case (``one_way_cases``: inputs,
  weights and biases ≥ 0; ``ONE_WAY_SHARE`` of the limit) at E2's up0 and
  bottleneck and E6's up0;
  ``unequal_bf16``: the share of bf16 values unequal to the plain
  version's (``chain_flip_verdict``); ``E2_f32``, ``E2_bf16``: one E2 burst
  of 8 704² frames through the pyramid runner against the same runner over
  the per-conv module (``levels_verdict``).
* retrieval — ``kernel_f32``, ``kernel_bf16``, ``kernel_int8``:
  ``phase_retrieval``'s check at the production bank shape
  (``top1_verdict``: N = 105,125, D = 16,384, B = 400, 1-4 and the padded
  bank); ``E6_int8``: the three E6 bursts' indices over the production int8
  bank against the plain retrieval (``e6_index_verdict``). Beside them, a
  reading and no check: a scan of near ties over gaps of 1 to 8 float32
  tolerances (``tie_scan``), float32 and bf16, which says how close to its
  limit the retrieval orders such ties.
* subsample — ``kernel_bits``, ``kernel_pairs``: ``phase_subsample``'s
  bit-equality and pair frequencies at its shapes, the outputs' memory
  poisoned first (``poisoned``); ``N2N_loss``: the N2N step's 12 losses
  against the plain sub-sampler's (``loss_verdict``).

It prints one ``[mutants]`` line per mutant (each check caught or passed,
its margin: reading over limit) and a summary, and exits 1 when a mutant
passes every check on its path, a snippet does not occur exactly once, a
mutant does not build, a child dies, or a real kernel fails a check before
or after its mutants.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

REPO = Path(__file__).resolve().parents[2]
MUTANT_ROOT = REPO / "build" / "mutants"
CHILD_TIMEOUT = 900  # seconds a kernel's child may take
# kernel: (its source under csrc/, its loader in ops/_build.py, its checks)
KERNELS = {
    "chain": ("fused_block.cu", "load_fused_block",
              ("kernel_f32", "kernel_bf16", "unequal_bf16", "E2_f32", "E2_bf16")),
    "retrieval": ("retrieval.cu", "load_retrieval",
                  ("kernel_f32", "kernel_bf16", "kernel_int8", "E6_int8")),
    "subsample": ("neighbor.cu", "load_neighbor",
                  ("kernel_bits", "kernel_pairs", "N2N_loss")),
}
END_TO_END = ("E2_f32", "E2_bf16", "E6_int8", "N2N_loss")
# the retrieval child's tie scan: SCAN_TIES ties a gap, from row SCAN_ROW of
# SCAN_ROWS seeded rows of D = 16,384, at SCAN_GAPS float32 tolerances
# (chip_smoke.f32_pick_tol): near_tie_rows, lo_tie_rows with random queries,
# and lo_tie_rows with queries at TF32 edges (above_tf32), on a float32 bank;
# bf16_tie_rows (queries and rows exact in bf16) on the bank in bf16
SCAN_GAPS = (1.0, 1.25, 1.5, 2.0, 2.5, 3.5, 5.0, 8.0)
SCAN_ROWS, SCAN_TIES, SCAN_ROW = 20000, 6, 100
SCAN_KINDS = ("near_tie_rows", "lo_tie_rows", "lo_tie_rows, edge queries", "bf16")


class Mutant(NamedTuple):
    """One seeded fault: ``hunks`` are (snippet, replacement) pairs of one
    source, each snippet found exactly once; ``expect`` the checks predicted
    to catch it."""
    name: str
    kernel: str
    hunks: tuple
    expect: tuple

    @property
    def source(self) -> str:
        return KERNELS[self.kernel][0]


_ONE_TF32 = """            wgmma_ss<NP, kTF32>(acc[m], da, db);
            wgmma_ss<NP, kTF32>(acc[m], da, make_desc(b_lo + b_off, lbo_b, 128, 0));
            wgmma_ss<NP, kTF32>(acc[m], make_desc(a_lo + a_off, kPlane, box_w * 16, 0),
                                db);
"""
_HI_LO = """          wgmma_ss<BN, R::kKind>(acc, da, make_desc(b_lo + 32 * kk, 16, 1024, 1));
          wgmma_ss<BN, R::kKind>(acc, make_desc(a_lo + 32 * kk, 16, 1024, 1), db);
"""
_EDGE = """        if (r0 < N) k = make_key(s0, acc[4 * i + c], r0);
        if (r1 < N) k = kmin(k, make_key(s1, acc[4 * i + 2 + c], r1));
"""
_FLOAT_KEY = """  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) | static_cast<unsigned>(n);
"""
_INT_KEY = """  const unsigned u = static_cast<unsigned>(static_cast<int>(d)) ^ 0x80000000u;
  return (static_cast<unsigned long long>(u) << 32) | static_cast<unsigned>(n);
"""
_STAGE_SUM = (("            total[m][i] += acc[m][i];\n            acc[m][i] = 0.f;\n", ""),
              ("acc[m][i] = total[m][i];", ";"))
_TABLES = """constexpr uint32_t kPos1 = pack_positions(0, 0, 1, 2, 1, 2, 3, 3);  // _POS1
constexpr uint32_t kPos2 = pack_positions(1, 2, 3, 3, 0, 0, 1, 2);  // _POS2
"""

MUTANTS = (
    # chain (csrc/fused_block.cu)
    Mutant("one_tf32", "chain",
           ((_ONE_TF32, _ONE_TF32.splitlines(keepends=True)[0]),),
           ("kernel_f32", "E2_f32")),
    Mutant("leaky_slope", "chain",
           (("v = fmaxf(v, 0.2f * v);", "v = fmaxf(v, 0.25f * v);"),),
           ("kernel_f32", "kernel_bf16", "E2_f32", "E2_bf16")),
    # the LFF term no longer rounded to the working type before the residual
    # add: bf16 only (float32's rounding is the identity)
    Mutant("residual_bf16_round", "chain",
           (("const float lff = to_f32(from_f32<T>(v + to_f32(bias[n])));",
             "const float lff = v + to_f32(bias[n]);"),),
           ("unequal_bf16",)),
    # the split-K finish adds all partial sums but the last: E6's levels and
    # E2's 44² and 22² ones split K
    Mutant("splitk_last", "chain",
           (("for (int z = 0; z < splits; ++z) v +=",
             "for (int z = 0; z < splits - 1; ++z) v +="),),
           ("kernel_f32", "kernel_bf16", "E2_f32", "E2_bf16")),
    Mutant("halo_row", "chain",
           (("y0 - a.halo, img);", "y0 - a.halo + 1, img);"),),
           ("kernel_f32", "kernel_bf16", "E2_f32", "E2_bf16")),
    # float32 carries one accumulator over the whole conv (up to 1,944
    # truncating instructions), no per-stage sum
    Mutant("stage_sum", "chain", _STAGE_SUM, ("kernel_f32",)),
    # retrieval (csrc/retrieval.cu)
    # float32 keeps only the product of the TF32-rounded hi parts
    Mutant("hi_hi_only", "retrieval", ((_HI_LO, ""),), ("kernel_f32",)),
    # the keys order equal distances by descending row, decoded back: a tie
    # goes to the last minimum
    Mutant("ties_last", "retrieval",
           ((_FLOAT_KEY, _FLOAT_KEY.replace("static_cast<unsigned>(n)",
                                            "~static_cast<unsigned>(n)")),
            (_INT_KEY, _INT_KEY.replace("static_cast<unsigned>(n)",
                                        "~static_cast<unsigned>(n)")),
            ("out[m] = static_cast<int>(keys[m] & 0xffffffffull);",
             "out[m] = static_cast<int>(~keys[m] & 0xffffffffull);")),
           ("kernel_f32", "kernel_bf16", "kernel_int8")),
    # the bank's last row is never keyed, on either of a thread's two rows
    # (at N = 105,125 it is a first row, r0; at the padded 105,472 a second)
    Mutant("tail_row", "retrieval", ((_EDGE, _EDGE.replace("< N)", "< N - 1)")),),
           ("kernel_f32", "kernel_bf16", "kernel_int8")),
    # float32 carries one accumulator over D = 16,384 (6,144 truncating
    # instructions), no per-stage sum: the TF32-edge ties at 1.5 go wrong
    Mutant("one_accumulator", "retrieval",
           (("          total[i] += acc[i];\n          acc[i] = 0.0f;\n", ""),
            ("acc[i] = total[i];", ";")),
           ("kernel_f32",)),
    # sub-sampler (csrc/neighbor.cu)
    # draws 1 and 2 swapped in both tables: the same 8 pairs, each still 1/8
    Mutant("pair_table", "subsample",
           ((_TABLES, _TABLES.replace("(0, 0, 1, 2, 1,", "(0, 1, 0, 2, 1,")
             .replace("(1, 2, 3, 3, 0,", "(1, 3, 2, 3, 0,")),),
           ("kernel_bits", "N2N_loss")),
    # the vector path's 4 cells of a quad share the first cell's draw
    Mutant("quad_draw", "subsample",
           (("philox_word0(static_cast<uint32_t>(cell0 + k),",
             "philox_word0(static_cast<uint32_t>(cell0),"),),
           ("kernel_bits", "N2N_loss")),
    # the scalar path skips a row's partial last quad: W/2 not a multiple of 4
    Mutant("scalar_tail", "subsample",
           (("const int count = min(kQuad, g.w2 - ww0);",
             "const int count = g.w2 - ww0 < kQuad ? 0 : kQuad;"),),
           ("kernel_bits",)),
)


class PatchError(RuntimeError):
    """A mutant's snippet does not occur exactly once in today's source."""


def log(msg: str) -> None:
    print(msg, flush=True)


def patched(m: Mutant, text: str) -> str:
    """``text`` (``m.source``) with each of ``m``'s snippets replaced."""
    for old, new in m.hunks:
        count = text.count(old)
        if count != 1:
            raise PatchError(f"mutant {m.name}: a snippet occurs {count} times in "
                             f"csrc/{m.source}, not once: {old!r}")
        text = text.replace(old, new)
    return text


def mutant_dir(name: str) -> Path:
    return MUTANT_ROOT / name


def prepare(m: Mutant) -> Path:
    """``csrc/``'s CUDA sources and headers copied to ``mutant_dir``, the
    mutant's source patched; its path."""
    from image_denoising_tpu_torch.ops import _build

    text = patched(m, (_build.CSRC_DIR / m.source).read_text())
    out = mutant_dir(m.name)
    out.mkdir(parents=True, exist_ok=True)
    for f in sorted(_build.CSRC_DIR.glob("*.cu")) + sorted(_build.CSRC_DIR.glob("*.cuh")):
        shutil.copyfile(f, out / f.name)
    (out / m.source).write_text(text)
    return out / m.source


def compile_mutant(src: Path) -> tuple[Path, str]:
    """nvcc on a prepared source, with ``ops/_build.py``'s flags, into its
    own directory: (library, nvcc's output)."""
    from image_denoising_tpu_torch.ops import _build

    return _build._compile(src, _build._nvcc(), _build.NVCC_FLAGS,
                           _build.cuda_headers(src.parent), src.parent)


def build_all(mutants=None) -> dict:
    """Every mutant's library, {name: path}: every patch first (a snippet
    that does not occur once fails before any build), then one nvcc each,
    all at once."""
    mutants = MUTANTS if mutants is None else mutants
    sources = {m.name: prepare(m) for m in mutants}
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(compile_mutant, sources.values())))
    return {name: so for name, (so, _) in built.items()}


@contextlib.contextmanager
def swapped_loader(kernel: str, lib):
    """While the body runs, ``ops/_build.py``'s loader of ``kernel`` returns
    ``lib``; after it, the real loader, its cache cleared, whatever the body
    raised."""
    from image_denoising_tpu_torch.ops import _build

    name = KERNELS[kernel][1]
    real = getattr(_build, name)
    real.cache_clear()
    setattr(_build, name, lambda *args: lib)
    try:
        yield
    finally:
        setattr(_build, name, real)
        real.cache_clear()


# ------------------------------------------------------------ the checks


def _chain_checks(seed: int):
    """The chain's checks, set up once: a callable giving {check: Verdict}."""
    import torch

    import chip_smoke as cs
    from image_denoising_tpu_torch.models import make_fused_forward
    from image_denoising_tpu_torch.ops.fused_block import (fused_rdb_chain,
                                                           fused_rdb_chain_reference)

    cases = [case for tile, s in ((cs.TILE, seed), (cs.E6_TILE, seed + 1))
             for case in cs.chain_cases(s, cs.chain_shapes(tile))]
    wants = [fused_rdb_chain_reference(x, wts) for _, _, x, wts in cases]
    one_way = [(x, wts, fused_rdb_chain_reference(x, wts))
               for label, tile, s in (("E2", cs.TILE, seed), ("E6", cs.E6_TILE, seed + 1))
               for _, x, wts in cs.one_way_cases(s, cs.one_way_shapes(label, tile))]
    model, bursts = cs.e2_setup(seed)
    burst = bursts[:1]
    dtypes = {"f32": "float32", "bf16": "bfloat16"}
    module = {k: cs.run_bursts(cs.e2_runner(cs.module_call(model, getattr(torch, d))),
                               burst)[0] for k, d in dtypes.items()}
    runners = {k: cs.e2_runner(make_fused_forward(model, dtype=getattr(torch, d)))
               for k, d in dtypes.items()}

    def run():
        kernel = {"float32": [], "bfloat16": []}
        unequal = []
        for (dname, _, x, wts), want in zip(cases, wants):
            got = fused_rdb_chain(x, wts)
            kernel[dname].append(cs.chain_verdict(got, want, dname))
            if dname == "bfloat16":
                unequal.append(cs.chain_flip_verdict(got, want))
            del got
        kernel["float32"] += [cs.chain_verdict(fused_rdb_chain(x, wts), want, "float32",
                                               cs.ONE_WAY_SHARE) for x, wts, want in one_way]
        out = dict(kernel_f32=cs.worst(*kernel["float32"]),
                   kernel_bf16=cs.worst(*kernel["bfloat16"]),
                   unequal_bf16=cs.worst(*unequal))
        for k, dname in dtypes.items():
            preds = cs.run_bursts(runners[k], burst)[0]
            out[f"E2_{k}"] = cs.levels_verdict(dname, cs.level_diff(preds, module["f32"]),
                                               cs.level_diff(preds, module[k]))
        return out

    return run


def _retrieval_checks(seed: int):
    import chip_smoke as cs
    from image_denoising_tpu_torch.memory import build_memory_bank_from_frames
    from image_denoising_tpu_torch.memory.retrieval import (
        pad_bank_for_retrieval, top1_l2_retrieval, top1_l2_retrieval_reference)

    regimes = cs.retrieval_case(seed)
    wants = {d: cs.top1_want(d, *regimes[d]) for d in regimes}
    clean, noise, bursts = cs.e6_frames(seed)
    bank = build_memory_bank_from_frames(
        clean, noise, cs.E6_TILE, cs.E6_STRIDE, bank_dtype="int8", pad_to=512,
        clean_dtype="uint8", device="cuda")
    queries = [cs.e6_queries(frames) for frames in bursts]
    refs = [top1_l2_retrieval_reference(q, bank.noise_flat, bank.sq_norms) for q in queries]
    short = {"float32": "f32", "bfloat16": "bf16", "int8": "int8"}

    def run():
        out = {}
        for dname in ("float32", "bfloat16", "int8"):
            b_, sqn, q = regimes[dname]
            idx = top1_l2_retrieval(q, b_, sqn)
            small = [(b, top1_l2_retrieval(q[:b].contiguous(), b_, sqn))
                     for b in cs.FT_QUERY_COUNTS]
            bp, sp = pad_bank_for_retrieval(b_, sqn, 512)
            padded = top1_l2_retrieval(q, bp, sp)
            del bp, sp
            out[f"kernel_{short[dname]}"] = cs.top1_verdict(dname, idx, wants[dname], small,
                                                            padded)
        out["E6_int8"] = cs.e6_index_verdict(
            [top1_l2_retrieval(q, bank.noise_flat, bank.sq_norms) for q in queries], refs)
        return out

    return run


def _subsample_checks(seed: int):
    import chip_smoke as cs
    from image_denoising_tpu_torch.ops.neighbor import subsample_pair, subsample_pair_fused

    cases = list(cs.subsample_cases(seed))
    wants = [subsample_pair(s, img) for _, img, s, _ in cases]
    setup = cs.n2n_setup(seed)
    plain_losses = cs.n2n_run(setup, seed, subsample_pair)[3]

    def run():
        bits, pairs = [], []
        for (_, img, s, _), want in zip(cases, wants):
            got = cs.poisoned(lambda: subsample_pair_fused(s, img))
            bits.append(cs.subsample_bits_verdict(got, want))
            pairs.append(cs.subsample_pairs_verdict(*got[2]))
        losses = cs.n2n_run(setup, seed, subsample_pair_fused)[3]
        return dict(kernel_bits=cs.worst(*bits), kernel_pairs=cs.worst(*pairs),
                    N2N_loss=cs.loss_verdict(losses, plain_losses))

    return run


def tie_scan(seed: int):
    """The retrieval on near ties over a scan of gaps, set up once: a
    callable giving {kind: {gap: how many of the SCAN_TIES ties pick the
    nearer row}} (the odd row of each pair); the bf16 kind on the bank, its
    ties and queries in bf16, the others in float32."""
    import torch

    import chip_smoke as cs
    from image_denoising_tpu_torch.memory.retrieval import top1_l2_retrieval

    g = torch.Generator(device="cuda").manual_seed(seed + 5)
    bank = torch.rand((SCAN_ROWS, cs.PATCH_D), generator=g, device="cuda")
    banks = {torch.float32: bank, torch.bfloat16: bank.to(torch.bfloat16)}
    sqns = {dt: (b.float() ** 2).sum(1) for dt, b in banks.items()}
    pairs = slice(SCAN_ROW, SCAN_ROW + 2 * SCAN_TIES)
    nearer = torch.arange(SCAN_ROW + 1, SCAN_ROW + 2 * SCAN_TIES, 2, device="cuda")
    makes = {"near_tie_rows": cs.near_tie_rows, "bf16": cs.bf16_tie_rows}
    cases = []
    for kind in SCAN_KINDS:
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        bank_norm = float(banks[dt].float().norm(dim=1).max())
        for gap in SCAN_GAPS:
            q = torch.rand((SCAN_TIES, cs.PATCH_D), generator=g, device="cuda")
            if kind.endswith("edge queries"):
                q = cs.above_tf32(q)
            q = q.to(dt).float()
            qn = float(q.norm(dim=1).max())
            tol = cs.f32_pick_tol(cs.PATCH_D, qn, max(bank_norm, (1 + cs.TIE_S) * qn))
            rows = torch.stack(makes.get(kind, cs.lo_tie_rows)(q, gap * tol), 1)
            cases.append((kind, dt, gap, q, rows.reshape(2 * SCAN_TIES, -1)))

    def run():
        out = {kind: {} for kind in SCAN_KINDS}
        for kind, dt, gap, q, rows in cases:
            banks[dt][pairs] = rows.to(dt)
            sqns[dt][pairs] = (rows ** 2).sum(1)
            idx = top1_l2_retrieval(q, banks[dt], sqns[dt])
            out[kind][str(gap)] = int((idx.long() == nearer).sum())
        return out

    return run


CHECK_SETUPS = {"chain": _chain_checks, "retrieval": _retrieval_checks,
                "subsample": _subsample_checks}
SCANS = {"retrieval": tie_scan}  # readings beside the checks, not checks


def child(kernel: str, out: str, seed: int) -> int:
    """One kernel's run, in a process of its own: its checks on the real
    kernel, on each of its mutants (built by ``build_all``), and on the real
    kernel again; the verdicts written to ``out`` as JSON."""
    sys.path.insert(0, str(REPO))
    import torch

    from image_denoising_tpu_torch.ops import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    checks = CHECK_SETUPS[kernel](seed)
    scan = SCANS[kernel](seed) if kernel in SCANS else dict
    torch.cuda.synchronize()
    result = dict(setup_seconds=time.perf_counter() - t0, mutants={})

    def timed():
        t = time.perf_counter()
        verdicts = checks()
        torch.cuda.synchronize()
        return dict(checks={k: v._asdict() for k, v in verdicts.items()},
                    seconds=time.perf_counter() - t, scan=scan())

    result["real"] = timed()
    for m in MUTANTS:
        if m.kernel != kernel:
            continue
        src = mutant_dir(m.name) / m.source
        lib = _build.open_library(m.source, compile_mutant(src)[0])
        with swapped_loader(kernel, lib):
            result["mutants"][m.name] = timed()
    result["real_after"] = timed()
    Path(out).write_text(json.dumps(result))
    return 0


_CHILD = ("import sys\n"
          "sys.path.insert(0, sys.argv[1])\n"
          "import chip_smoke\n"
          "sys.exit(chip_smoke._script('mutants').child(sys.argv[2], sys.argv[3], "
          "int(sys.argv[4])))\n")


def run_children(seed: int) -> dict:
    """The three kernels' children at once; {kernel: result}. A child that
    exits non-zero, outlives CHILD_TIMEOUT or writes no result fails."""
    procs = {}
    for kernel in KERNELS:
        out = MUTANT_ROOT / f"{kernel}.json"
        out.unlink(missing_ok=True)
        logf = open(MUTANT_ROOT / f"{kernel}.log", "w")
        procs[kernel] = (subprocess.Popen(
            [sys.executable, "-c", _CHILD, str(REPO), kernel,
             str(out), str(seed)], cwd=REPO, stdout=logf, stderr=subprocess.STDOUT), logf, out)
    failed, results = [], {}
    deadline = time.monotonic() + CHILD_TIMEOUT
    for kernel, (proc, logf, out) in procs.items():
        try:
            rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
        logf.close()
        if rc != 0 or not out.exists():
            tail = (MUTANT_ROOT / f"{kernel}.log").read_text()[-3000:]
            failed.append(f"the {kernel} child exited {rc}:\n{tail}")
        else:
            results[kernel] = json.loads(out.read_text())
    if failed:
        raise AssertionError("\n".join(failed))
    return results


def _fmt(v: dict) -> str:
    state = "passed" if v["ok"] else "caught"
    return (f"{state} {v['margin']:.3g} ({v['what']} {v['reading']:.4g}, "
            f"limit {v['limit']:.4g})")


def _line(label: str, kernel: str, res: dict) -> str:
    return (f"[mutants] {label} ({kernel}): "
            + " | ".join(f"{k} {_fmt(v)}" for k, v in res["checks"].items())
            + f"; {res['seconds']:.2f} s")


def run(seed: int = 0) -> dict:
    """Build every mutant, run the three children, print the lines; raise
    AssertionError when the run fails. Returns the children's results."""
    t0 = time.perf_counter()
    build_all()
    build_s = time.perf_counter() - t0
    results = run_children(seed)
    failures, survivors, caught_kernel, caught_e2e = [], [], [], []
    for kernel, res in results.items():
        for label in ("real", "real_after"):
            log(_line(f"real kernel ({label})", kernel, res[label]))
            bad = [k for k, v in res[label]["checks"].items() if not v["ok"]]
            if bad:
                failures.append(f"the real {kernel} kernel failed {bad} ({label})")
        runs = {"real": res["real"], "real_after": res["real_after"], **res["mutants"]}
        for kind in res["real"]["scan"]:
            log(f"[mutants] tie scan ({kernel}, {kind}): the nearer row of "
                f"{SCAN_TIES} at {'/'.join(res['real']['scan'][kind])} tolerances apart: "
                + "; ".join(f"{label} " + "/".join(map(str, r["scan"][kind].values()))
                            for label, r in runs.items()))
    for m in MUTANTS:
        res = results[m.kernel]["mutants"][m.name]
        caught = [k for k, v in res["checks"].items() if not v["ok"]]
        unexpected = sorted(set(m.expect) - set(caught))
        log(_line(m.name, m.kernel, res) + f"; caught by {caught or 'nothing'}"
            + (f"; expected also {unexpected}" if unexpected else ""))
        if not caught:
            survivors.append(m.name)
            failures.append(f"mutant {m.name} passed every check on its path")
        if any(k not in END_TO_END for k in caught):
            caught_kernel.append(m.name)
        if any(k in END_TO_END for k in caught):
            caught_e2e.append(m.name)
    seconds = time.perf_counter() - t0
    log(f"[mutants] {len(MUTANTS)} mutants of {len(KERNELS)} kernels: "
        f"{len(MUTANTS) - len(survivors)} caught, "
        f"{len(caught_kernel)} by a kernel check, {len(caught_e2e)} by an end-to-end "
        f"check ({', '.join(caught_e2e) or 'none'}); builds {build_s:.2f} s, the phase "
        f"{seconds:.2f} s")
    if failures:
        raise AssertionError("; ".join(failures))
    return dict(results=results, build_seconds=build_s, seconds=seconds,
                caught_by_kernel_check=caught_kernel, caught_end_to_end=caught_e2e)


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("mutants: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       check=True).stdout.strip().splitlines()[0])
    try:
        run(0)
    except (AssertionError, PatchError, RuntimeError) as e:
        print(f"mutants: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
