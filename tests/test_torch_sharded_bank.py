"""The port's sharded memory bank (memory/sharded.py) and retrieval keys
(memory/retrieval.py::top1_l2_keys) against the JAX package's ring
(``make_ring_retrieval``) on its 8 virtual CPU devices (tests/conftest.py)
and against the unsharded retrieval. Mirrors tests/test_sharded_bank.py.

The port's mesh is 8 × ``cpu``; each shard runs the plain version of the
retrieval kernel's keys, as the kernel does on a card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_denoising_tpu.memory import MemoryBank as JaxBank
from image_denoising_tpu.memory import make_ring_retrieval as jax_ring
from image_denoising_tpu.memory import shard_bank as jax_shard_bank
from image_denoising_tpu.parallel import make_mesh as jax_make_mesh
from image_denoising_tpu_torch.adapters import (DenoiserWithMemoryAdapter,
                                                batched_select_memory_patch,
                                                build_memory_adapter, select_memory_patch)
from image_denoising_tpu_torch.memory import (KEY_ROW_MASK, MemoryBank,
                                              make_ring_retrieval, shard_bank,
                                              top1_l2_keys, top1_l2_keys_reference,
                                              top1_l2_retrieval_reference)
from image_denoising_tpu_torch.memory.retrieval import _encode_keys
from image_denoising_tpu_torch.parallel import make_mesh

from _torch_port_helpers import one_torch_thread  # noqa: F401


def cpus(k):
    return make_mesh(devices=["cpu"] * k)


def _banks(rng, n, ps=8, int8=False, dup=None):
    """(the port's bank, JAX's bank) over the same patches: float32 in
    [0, 1], or centered int8 from uint8 bytes with exact int32 norms.
    ``dup=(i, j)`` copies row i over row j."""
    if int8:
        u8 = rng.integers(0, 256, (n, ps * ps)).astype(np.uint8)
        if dup:
            u8[dup[1]] = u8[dup[0]]
        c = u8.astype(np.int32) - 128
        noise, norms = c.astype(np.int8), (c * c).sum(1).astype(np.int32)
    else:
        noise = rng.random((n, ps * ps)).astype(np.float32)
        if dup:
            noise[dup[1]] = noise[dup[0]]
        norms = (noise.astype(np.float32) ** 2).sum(1).astype(np.float32)
    clean = rng.random((n, ps, ps, 1)).astype(np.float32)
    port = MemoryBank(torch.from_numpy(noise), torch.from_numpy(clean),
                      torch.from_numpy(norms), ps, 4)
    jax_bank = JaxBank(noise_flat=jnp.asarray(noise), clean=jnp.asarray(clean),
                       sq_norms=jnp.asarray(norms), patch_size=ps, stride=4)
    return port, jax_bank


def _queries(rng, b, ps=8):
    return rng.integers(0, 256, (b, ps, ps, 1)).astype(np.float32) / 255.0


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("queries_sharded,b", [(True, 16), (False, 5)],
                         ids=["queries_split", "queries_whole"])
def test_ring_matches_jax_ring(int8, queries_sharded, b):
    """44 rows (padded to 48 in both packages) over 8 devices: the port's
    patches equal JAX's ring's and the unsharded retrieval's exactly."""
    rng = np.random.default_rng(3)
    bank, jbank = _banks(rng, 44, int8=int8)
    q = _queries(rng, b)
    mesh, jmesh = cpus(8), jax_make_mesh(8)
    sb = shard_bank(bank, mesh)
    assert sb.n_rows == 44 and sb.size == 64 and sb.n_local == 8
    got = make_ring_retrieval(mesh, queries_sharded=queries_sharded)(
        torch.from_numpy(q), sb.noise_flat, sb.clean, sb.sq_norms)
    jsb = jax_shard_bank(jbank, jmesh, "data")
    want = jax.jit(jax_ring(jmesh, "data", queries_sharded=queries_sharded))(
        jnp.asarray(q), jsb.noise_flat, jsb.clean, jsb.sq_norms)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    plain = select_memory_patch(torch.from_numpy(q), bank.noise_flat, bank.clean,
                                bank.sq_norms)
    assert torch.equal(got, plain)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("k", [8, 3])
def test_ring_tie_breaks_to_the_first_row(int8, k):
    """Row 2 duplicated at row 13, on another shard: the query equal to
    both gets row 2's clean patch, as in JAX's ring and ``torch.argmin``."""
    rng = np.random.default_rng(4)
    bank, jbank = _banks(rng, 16, ps=4, int8=int8, dup=(2, 13))
    mesh = cpus(k)
    sb = shard_bank(bank, mesh)
    assert 2 // sb.n_local != 13 // sb.n_local
    noise = bank.noise_flat[13].float()
    q = ((noise + 128) / 255.0 if int8 else noise).reshape(1, 4, 4, 1)
    got = make_ring_retrieval(mesh, queries_sharded=False)(q, sb.noise_flat, sb.clean,
                                                           sb.sq_norms)
    assert torch.equal(got[0], bank.clean[2])
    jmesh = jax_make_mesh(8)
    jsb = jax_shard_bank(jbank, jmesh, "data")
    want = jax.jit(jax_ring(jmesh, "data", queries_sharded=False))(
        jnp.asarray(q.numpy()), jsb.noise_flat, jsb.clean, jsb.sq_norms)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_padded_rows_never_win(int8):
    """5 rows over 8 devices: 27 padded rows, whose zero noise would sit
    nearest a black query if their norms did not carry the worst distance
    (+inf, INT32_MAX): the black query gets the real nearest row."""
    rng = np.random.default_rng(5)
    bank, _ = _banks(rng, 5, int8=int8)
    mesh = cpus(8)
    sb = shard_bank(bank, mesh)
    norms = torch.cat(sb.sq_norms)
    worst = torch.iinfo(torch.int32).max if int8 else float("inf")
    assert torch.all(norms[5:] == worst) and torch.equal(norms[:5], bank.sq_norms)
    assert not torch.cat(sb.clean)[5:].any()
    q = torch.zeros(3, 8, 8, 1) if not int8 else torch.full((3, 8, 8, 1), 128 / 255.0)
    got = make_ring_retrieval(mesh)(q, sb.noise_flat, sb.clean, sb.sq_norms)
    assert torch.equal(got, select_memory_patch(q, bank.noise_flat, bank.clean,
                                                bank.sq_norms))


def test_shard_bank_layout():
    """On a mesh of one repeated device the shards inside the bank are
    views of it (one bank's memory) and only the last is a padded copy;
    every shard has a multiple of 4 rows, so each norms shard starts
    16-byte aligned. The JAX signature's ``axis_name`` is taken."""
    rng = np.random.default_rng(6)
    bank, _ = _banks(rng, 45)
    sb = shard_bank(bank, cpus(4), "data")
    assert sb.n_local == 12 and sb.n_local % 4 == 0
    base = bank.noise_flat.data_ptr()
    row = bank.noise_flat.stride(0) * bank.noise_flat.element_size()
    for i in range(3):
        assert sb.noise_flat[i].data_ptr() == base + i * 12 * row
        assert sb.sq_norms[i].data_ptr() % 16 == bank.sq_norms.data_ptr() % 16
    assert sb.noise_flat[3].data_ptr() not in range(base, base + 45 * row)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8],
                         ids=["f32", "bf16", "int8"])
def test_keys_plain_version(dtype):
    """``top1_l2_keys`` on the CPU: its low word is the replicated index of
    ``top1_l2_retrieval_reference``, its high word the winner's distance in
    order, so keys of one query against two banks pick the nearer bank's
    row (negative distances ‖b‖² − 2q·b included), and equal distances the
    lower row."""
    rng = np.random.default_rng(7)
    if dtype == torch.int8:
        bank = torch.from_numpy(rng.integers(-128, 128, (40, 32)).astype(np.int8))
        q = torch.from_numpy(rng.integers(-128, 128, (6, 32)).astype(np.int8))
        norms = (bank.int() ** 2).sum(1, dtype=torch.int32)
    else:
        bank = torch.from_numpy(rng.random((40, 32), dtype=np.float32)).to(dtype)
        q = torch.from_numpy(rng.random((6, 32), dtype=np.float32))
        norms = (bank.float() ** 2).sum(1)
    keys = top1_l2_keys(q, bank, norms)
    assert keys.dtype == torch.int64
    idx = top1_l2_retrieval_reference(q, bank, norms)
    assert torch.equal(keys & KEY_ROW_MASK, idx.long())
    assert torch.equal(keys, top1_l2_keys_reference(q, bank, norms))
    a, b = top1_l2_keys(q, bank[:20], norms[:20]), top1_l2_keys(q, bank[20:], norms[20:])
    a_wins = torch.minimum(a, b + 20) == a
    assert torch.equal(torch.where(a_wins, a, b + 20) & KEY_ROW_MASK, idx.long())


def test_key_order_of_distances():
    """The float key orders negative, zero (either sign) and positive
    distances, and +inf last; the int key orders int32 distances."""
    d = torch.tensor([-3.5, -1e-30, -0.0, 0.0, 1e-30, 2.0, float("inf")])
    rows = torch.tensor([5, 4, 2, 3, 1, 0, 0])
    keys = _encode_keys(d, rows)
    assert torch.all(keys[:-1] < keys[1:])
    assert (keys[2] >> 32) == (keys[3] >> 32)  # -0 and +0: one distance
    di = torch.tensor([-(2 ** 31), -7, 0, 7, 2 ** 31 - 1], dtype=torch.int32)
    ki = _encode_keys(di, torch.zeros(5, dtype=torch.int64))
    assert torch.all(ki[:-1] < ki[1:])


def test_memory_wrapper_and_hoisted_pass_with_the_ring():
    """``DenoiserWithMemoryAdapter(retrieval_fn=ring)`` and the hoisted
    ``batched_select_memory_patch(retrieval_fn=ring)`` in chunks of 3 equal
    the unsharded wrapper and pass exactly (tests/test_sharded_bank.py:79,
    :305)."""
    rng = np.random.default_rng(8)
    bank, _ = _banks(rng, 19, ps=32)
    mesh = cpus(8)
    sb = shard_bank(bank, mesh)
    ring = make_ring_retrieval(mesh, queries_sharded=True)
    torch.manual_seed(0)
    adapter = build_memory_adapter("hyper_gated_fft", 1, 8).eval()
    base = torch.nn.Conv2d(1, 1, 3, padding=1).eval()
    tiles = torch.from_numpy(rng.random((7, 1, 32, 32), dtype=np.float32))
    with torch.no_grad():
        want = DenoiserWithMemoryAdapter(base, adapter)(
            tiles, bank.noise_flat, bank.clean, bank.sq_norms)
        got = DenoiserWithMemoryAdapter(base, adapter, ring)(
            tiles, sb.noise_flat, sb.clean, sb.sq_norms)
    assert torch.equal(got, want)
    nhwc = tiles.permute(0, 2, 3, 1)
    hoisted = batched_select_memory_patch(nhwc, sb.noise_flat, sb.clean, sb.sq_norms,
                                          chunk=3, retrieval_fn=ring)
    assert torch.equal(hoisted, select_memory_patch(nhwc, bank.noise_flat, bank.clean,
                                                    bank.sq_norms))
