"""The port's device mesh (parallel/mesh.py) and its data-parallel steps
against the single-device steps and the JAX package's on its 8 virtual CPU
devices (tests/conftest.py).

ImprovedUNet-8 on 64² frames (gradient comparisons need the 4×4
bottleneck, ROADMAP.md §3). The port's meshes repeat the CPU device
(``make_mesh(devices=["cpu"] * 8)``): every split, per-device forward and
gather runs, and the copies between devices are no-ops. Gradients are held
to 1e-5 and parameters after a step to 1e-5 (``tests/test_train.py:194-200``'s
bound) except where the gradient lies within rounding of 0 (no more than
ten times the two runs' difference there, plus 1e-7): Adam's first update
g/(|g| + 1e-8) is ±lr wherever |g| is well above 1e-8, so a gradient that
rounds to the other sign moves its parameter by up to 2·lr (as
``tests/test_torch_structure_train.py`` holds the fused forward)."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_denoising_tpu import train as jax_train
from image_denoising_tpu.losses import structure_loss as jax_structure_loss
from image_denoising_tpu.models import ImprovedUNet as JaxImprovedUNet
from image_denoising_tpu.parallel import make_mesh as jax_make_mesh
from image_denoising_tpu.parallel import replicate as jax_replicate
from image_denoising_tpu.parallel import shard_batch as jax_shard_batch
from image_denoising_tpu_torch.adapters import (DenoiserWithAdapter,
                                                DenoiserWithMemoryAdapter, OutputAdapter,
                                                build_memory_adapter)
from image_denoising_tpu_torch.ckpt import load_jax_params, params_to_state_dict
from image_denoising_tpu_torch.losses import structure_loss
from image_denoising_tpu_torch.memory import MemoryBank, make_ring_retrieval, shard_bank
from image_denoising_tpu_torch.models import ImprovedUNet, make_forward
from image_denoising_tpu_torch.ops import AugmentNoise
from image_denoising_tpu_torch.parallel import (Mesh, PerDevice, forward_over_mesh,
                                                grad_replica, make_mesh, module_on,
                                                replicate, shard_batch)
from image_denoising_tpu_torch.parallel.dryrun import dryrun_multidevice
from image_denoising_tpu_torch.train import (create_train_state,
                                             make_adapter_finetune_step,
                                             make_l1_train_step,
                                             make_memory_finetune_step,
                                             make_n2n_train_step,
                                             make_structure_train_step)
from image_denoising_tpu_torch.train.steps import _apply

from _torch_port_helpers import one_torch_thread, seeded_improved_unet_params  # noqa: F401

NF, FRAME, LR = 8, 64, 1e-3


def cpus(k):
    return make_mesh(devices=["cpu"] * k)


def _frames(rng, b, size=FRAME):
    clean = (rng.random((b, size, size, 1)) * 255).astype(np.float32)
    noisy = np.clip(clean + rng.normal(0, 20, clean.shape), 0, 255).astype(np.float32)
    return clean, noisy


def _same_step(model_a, model_b, atol=1e-5):
    """Gradients within ``atol``; parameters within ``atol`` except where
    the gradient is within rounding of 0 (module docstring), and within
    2·lr everywhere."""
    for (k, a), b in zip(model_a.named_parameters(), model_b.parameters()):
        g, ga = b.grad.numpy(), a.grad.numpy()
        np.testing.assert_allclose(ga, g, atol=atol, rtol=0, err_msg=k)
        far = np.abs(a.detach().numpy() - b.detach().numpy()) > atol
        assert np.all(np.abs(g[far]) <= 10 * np.abs(ga - g)[far] + 1e-7), k
        assert np.all(np.abs(a.detach().numpy() - b.detach().numpy()) <= 2 * LR), k


@pytest.mark.parametrize("b,k,sizes", [(8, 8, [1] * 8), (4, 8, [1] * 4),
                                       (10, 4, [3, 3, 2, 2]), (3, 1, [3])])
def test_shard_batch_splits_in_batch_order(b, k, sizes):
    x = torch.arange(b * 2.0).reshape(b, 2)
    y = -x
    chunks = shard_batch(cpus(k), (x, y))
    assert [c[0].shape[0] for c in chunks] == sizes
    assert torch.equal(torch.cat([c[0] for c in chunks]), x)
    assert torch.equal(torch.cat([c[1] for c in chunks]), y)
    single = shard_batch(cpus(k), x)
    assert all(isinstance(c, torch.Tensor) for c in single)
    with pytest.raises(ValueError, match="disagree"):
        shard_batch(cpus(k), (x, y[:-1]))


def test_mesh_and_replicate(monkeypatch):
    mesh = make_mesh(devices=["cpu", "cpu", "meta"])
    assert mesh.size == 3 and mesh.primary == torch.device("cpu")
    assert mesh.distinct() == [torch.device("cpu"), torch.device("meta")]
    assert make_mesh(2, devices=["cpu"] * 8).size == 2
    lin = torch.nn.Linear(3, 2)
    reps = replicate(mesh, lin)
    assert reps[0] is lin and reps[1] is lin and reps[2].weight.device.type == "meta"
    t = torch.ones(4)
    copies = replicate(mesh, (t, t))
    assert copies[0][0] is t and copies[2][1].device.type == "meta"
    built = []
    PerDevice(mesh, lambda d: built.append(d))
    assert built == mesh.distinct()
    per = PerDevice(cpus(4), lambda d: (lambda x: x * 2))
    assert torch.equal(per(torch.arange(6.0)), torch.arange(6.0) * 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        make_mesh()


@pytest.mark.parametrize("remat", [False, True])
def test_grad_replica_accumulates_into_the_module(remat):
    """A replica's forward equals the module's, and its backward lands on
    the module's own ``.grad``, also through blocks recomputed under
    ``torch.utils.checkpoint`` (remat). ``module_on`` gives the module
    itself on its own device."""
    torch.manual_seed(0)
    model = ImprovedUNet(1, 1, NF, remat=remat)
    x = torch.rand(2, 1, FRAME, FRAME)
    assert module_on(model, "cpu") is model
    model(x).square().mean().backward()
    want = [p.grad.clone() for p in model.parameters()]
    model.zero_grad(set_to_none=True)
    rep = grad_replica(model, "cpu")
    assert rep is not model
    out = rep(x)
    torch.testing.assert_close(out, model(x), rtol=0, atol=0)
    out.square().mean().backward()
    for p, g in zip(model.parameters(), want):
        torch.testing.assert_close(p.grad, g, rtol=0, atol=0)


@pytest.fixture(scope="module")
def params():
    return seeded_improved_unet_params(NF, seed=51)[1]


def _port(params):
    model = load_jax_params(ImprovedUNet(1, 1, NF), params)
    return model, create_train_state(model, lr=LR)


@pytest.mark.parametrize("b", [8, 4])
def test_structure_step_on_8_devices_matches_single_device(params, b):
    """Batch 8 and the reference's batch 4 (which 8 devices do not divide)
    over 8 devices: the loss within 1e-5 of the single-device step and the
    step's gradient and parameters as ``_same_step`` holds them."""
    clean, noisy = _frames(np.random.default_rng(b), b)
    runs = []
    for mesh in (None, cpus(8)):
        model, state = _port(params)
        m = make_structure_train_step(model, state, mesh=mesh)(clean, noisy)
        runs.append((float(m["loss"]), float(m["l1"]), model))
    (loss1, l1_1, m1), (loss8, l1_8, m8) = runs
    assert abs(loss8 - loss1) < 1e-5 and abs(l1_8 - l1_1) < 1e-5
    _same_step(m8, m1)


def test_structure_step_on_8_devices_matches_jax_8_devices(params):
    """The port's data-parallel structure step on 8 devices against the
    JAX package's on its 8 devices (``shard_batch``, at batch 4 its gcd
    regrouping), both from one set of weights: the port's float32 loss
    within rtol 1e-5 of JAX's float64 one, and the port's float64 gradient
    through the same per-device path (``_apply``) within 1e-10 of each
    norm of JAX's (tests/test_torch_structure_train.py's limits; later
    steps part at float32 kinks in a single-device run too)."""
    rng = np.random.default_rng(52)
    batches = [_frames(rng, 4)]
    model_j = JaxImprovedUNet(1, 1, NF)
    jmesh = jax_make_mesh(8)
    model_t, state_t = _port(params)
    step_t = make_structure_train_step(model_t, state_t, mesh=cpus(8))
    got = [float(step_t(c, n)["loss"]) for c, n in batches]

    def loss_fn(p, c, n):
        both = model_j.apply({"params": p}, jnp.concatenate([n / 255.0, c / 255.0], 0))
        return jax_structure_loss(both[:4], both[4:], c / 255.0)

    clean0, noisy0 = batches[0]
    with jax.enable_x64():
        p64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), params)
        state_j = jax_train.create_train_state(jax_replicate(jmesh, p64), lr=LR)
        step_j = jax_train.make_structure_train_step(model_j.apply)
        want = []
        for c, n in batches:
            cb, nb = jax_shard_batch(jmesh, (c.astype(np.float64), n.astype(np.float64)))
            state_j, m = step_j(state_j, cb, nb)
            want.append(float(m["loss"]))
        cb, nb = jax_shard_batch(jmesh, (clean0.astype(np.float64),
                                         noisy0.astype(np.float64)))
        grads = jax.jit(jax.grad(loss_fn))(jax_replicate(jmesh, p64), cb, nb)
        grads = params_to_state_dict(jax.tree_util.tree_map(np.asarray, grads))
    np.testing.assert_allclose(got, want, rtol=1e-5)

    model64 = load_jax_params(ImprovedUNet(1, 1, NF), params).double()
    c, n = (torch.from_numpy(a).permute(0, 3, 1, 2).double() / 255.0
            for a in (clean0, noisy0))

    def forward(net, n_, c_):
        both = net(torch.cat([n_, c_], 0))
        return both[: n_.shape[0]], both[n_.shape[0]:]

    pred_n, pred_c = _apply(model64, cpus(8), forward, n, c)
    structure_loss(pred_n, pred_c, c).backward()
    for k, p in model64.named_parameters():
        norm = np.linalg.norm(grads[k])
        assert np.linalg.norm(p.grad.numpy() - grads[k]) <= 1e-10 * norm, k


def test_l1_step_on_a_mesh_matches_single_device(params):
    clean, noisy = _frames(np.random.default_rng(53), 5)
    runs = []
    for mesh in (None, cpus(3)):
        model, state = _port(params)
        m = make_l1_train_step(model, state, inputs_01=False, mesh=mesh)(clean, noisy)
        assert bool(m["ok"])
        runs.append((float(m["loss"]), model))
    assert abs(runs[0][0] - runs[1][0]) < 1e-5
    _same_step(runs[1][1], runs[0][1])


def test_n2n_step_on_a_mesh_matches_single_device(params):
    """The N2N step over 8 devices at batch 4: the noise and the
    sub-sampler run once on the first device, so the draws are the
    single-device step's; loss terms within 1e-5 and the step as
    ``_same_step`` holds it."""
    clean, _ = _frames(np.random.default_rng(54), 4)
    runs = []
    for mesh in (None, cpus(8)):
        model, state = _port(params)
        step = make_n2n_train_step(model, state,
                                   noise_fn=AugmentNoise("gauss25").add_train_noise,
                                   n_epoch=10, mesh=mesh)
        m = step(clean, clean, 12345, 3)
        runs.append(([float(m[k]) for k in ("loss", "loss_rec", "loss_reg")], model))
    np.testing.assert_allclose(runs[1][0], runs[0][0], atol=1e-5, rtol=0)
    _same_step(runs[1][1], runs[0][1])


def _bank(rng, n, ps, int8=False):
    """A float32 bank, or a centered-int8 one with uint8 clean patches."""
    if int8:
        c = torch.from_numpy(rng.integers(0, 256, (n, ps * ps)).astype(np.int32) - 128)
        clean = torch.from_numpy(rng.integers(0, 256, (n, ps, ps, 1)).astype(np.uint8))
        return MemoryBank(noise_flat=c.to(torch.int8), clean=clean,
                          sq_norms=(c * c).sum(1, dtype=torch.int32), patch_size=ps,
                          stride=4)
    noise = torch.from_numpy(rng.random((n, ps * ps), dtype=np.float32))
    return MemoryBank(noise_flat=noise,
                      clean=torch.from_numpy(rng.random((n, ps, ps, 1), dtype=np.float32)),
                      sq_norms=(noise ** 2).sum(1), patch_size=ps, stride=4)


@pytest.mark.parametrize("kind", ["adapter", "memory"])
def test_finetune_steps_on_a_mesh_match_single_device(params, kind):
    """The adapter and memory finetune steps with the IQSL term (whose Dice
    sums over the whole batch, so the loss must be taken on the gathered
    batch) over 4 devices at batch 6: the frozen base per device through
    ``make_forward(mesh=)``, the adapter per device through
    ``wrapper.replica``; loss parts within 1e-5, the adapter's gradient and
    update as ``_same_step`` holds them."""
    rng = np.random.default_rng(55)
    base = load_jax_params(ImprovedUNet(1, 1, NF), params).eval()
    clean = rng.random((6, 32, 32, 1), dtype=np.float32)
    noisy = np.clip(clean + rng.normal(0, 0.1, clean.shape), 0, 1).astype(np.float32)
    bank = _bank(rng, 19, 32)
    cfg = {"t1": 0.3, "t2": 0.7}
    runs = []
    for mesh in (None, cpus(4)):
        torch.manual_seed(0)
        fwd = make_forward(base, device="cpu", mesh=mesh)
        if kind == "adapter":
            adapter = OutputAdapter(1, 8)
            wrapper = DenoiserWithAdapter(fwd, adapter)
            step = make_adapter_finetune_step(wrapper, create_train_state(adapter, LR),
                                              lambda_iqsl=0.5, iqsl_cfg=cfg, mesh=mesh)
            m = step(clean, noisy)
        else:
            adapter = build_memory_adapter("hyper_gated_fft", 1, 8)
            wrapper = DenoiserWithMemoryAdapter(fwd, adapter)
            step = make_memory_finetune_step(wrapper, create_train_state(adapter, LR),
                                             lambda_iqsl=0.5, iqsl_cfg=cfg, mesh=mesh)
            m = step(clean, noisy, bank.noise_flat, bank.clean, bank.sq_norms)
        runs.append(({k: float(v) for k, v in m.items()}, adapter))
    for k, v in runs[0][0].items():
        assert abs(runs[1][0][k] - v) < 1e-5, k
    assert runs[0][0]["iqsl"] > 0
    _same_step(runs[1][1], runs[0][1])


def test_forward_over_mesh_gathers_in_order():
    mesh = cpus(3)
    seen = []

    def fn(d, a, b):
        seen.append(a.shape[0])
        return a + b, a - b

    a, b = torch.arange(7.0), torch.ones(7)
    s, d = forward_over_mesh(mesh, fn, a, b)
    assert seen == [3, 2, 2] and torch.equal(s, a + 1) and torch.equal(d, a - 1)
    model = ImprovedUNet(1, 1, NF).eval()
    x = torch.rand(5, 1, 32, 32)
    with torch.no_grad():
        torch.testing.assert_close(make_forward(model, "cpu", mesh=mesh)(x),
                                   make_forward(model, "cpu")(x), rtol=0, atol=1e-6)


def test_dryrun_multidevice_on_8_cpus():
    out = dryrun_multidevice(cpus(8))
    assert out["int8_sharded_exact"] and out["pyramid_shape"] == (96, 96)
    for k in ("dp_loss", "dp_batch4_loss", "n2n_loss", "finetune_loss"):
        assert np.isfinite(out[k]), k


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_sharded_memory_finetune_step_keeps_the_batch_whole(params, int8):
    """With a sharded bank (float32, or int8 with uint8 clean patches) the
    finetune step keeps its batch whole (JAX's ``queries_sharded=False``)
    and retrieves through the key merge: two steps equal the unsharded-bank
    steps bit for bit (tests/test_sharded_bank.py:109, :269)."""
    rng = np.random.default_rng(56)
    base = load_jax_params(ImprovedUNet(1, 1, NF), params).eval()
    bank = _bank(rng, 21, 32, int8=int8)
    mesh = cpus(8)
    clean = rng.random((4, 32, 32, 1), dtype=np.float32)
    noisy = rng.random((4, 32, 32, 1), dtype=np.float32)
    runs = []
    for sharded in (False, True):
        torch.manual_seed(0)
        adapter = build_memory_adapter("hyper_gated_fft", 1, 8)
        banks, fn = (bank, None)
        if sharded:
            banks, fn = shard_bank(bank, mesh), make_ring_retrieval(mesh, queries_sharded=False)
        wrapper = DenoiserWithMemoryAdapter(make_forward(base, "cpu"), adapter, fn)
        step = make_memory_finetune_step(wrapper, create_train_state(adapter, LR))
        for _ in range(2):
            m = step(clean, noisy, banks.noise_flat, banks.clean, banks.sq_norms)
        runs.append((float(m["loss"]), copy.deepcopy(adapter.state_dict())))
    assert runs[0][0] == runs[1][0]
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k


def test_cli_mesh_and_device(monkeypatch):
    """``cli_mesh``: the cards a ``--gpu_devices`` list names, every
    visible card for one index, one CPU device for ``--device cpu``;
    ``cli_device``: the mesh's first device, else the list's first card."""
    import argparse

    from image_denoising_tpu_torch.cli.common import cli_device, cli_mesh

    def opt(**kw):
        return argparse.Namespace(**{"device": "cuda", "gpu_devices": "0", **kw})

    assert cli_mesh(opt(device="cpu")).devices == (torch.device("cpu"),)
    assert cli_device(opt(device="cpu")) == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert [str(d) for d in cli_mesh(opt(gpu_devices="2,1")).devices] == ["cuda:2", "cuda:1"]
    assert cli_mesh(opt()).size == 3
    assert cli_device(opt(gpu_devices="1,0")) == "cuda:1"
    assert cli_device(opt(), Mesh(["cuda:2", "cuda:0"])) == "cuda:2"
    with pytest.raises(RuntimeError, match="only 3 cards"):
        cli_mesh(opt(gpu_devices="0,5"))


def test_multidevice_cards_needs_four_cards(monkeypatch, capsys):
    """``chip_smoke.py --multidevice-cards`` ([multidevice] on distinct
    cards) returns 1 with its reason where there are fewer than 4 cards,
    before it builds anything."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert cs.multidevice_cards(0) == 1
    assert "needs 4 CUDA cards, found 1" in capsys.readouterr().err
