"""The Neighbor2Neighbor training step, driven as ``cli/train.py --loss n2n``
drives it.

One step object (``train/steps.py::make_n2n_train_step`` over the module
and its Adam state, with ``AugmentNoise("gauss<σ>")``'s noise drawn in the
step, as ``cli/train.py:160-165`` builds it) is built in set-up and takes
every step: the first steps in set-up, which the reference follows, then
the window. Each step gets the run's next ``OperationSeed`` and the
traffic's epoch; in it the noise is drawn, the sub-sampler runs once over
the batch, f(noisy) runs without gradient and f(sub₁) with it. Batches of
clean frames come from the seeded pool, reshuffled each epoch; after
queueing step i the harness fetches step i − 1's loss (lag-1), and that
fetch is step i − 1's completion. The configuration states whether cuDNN
may use TF32 (``cudnn_tf32``); a run that ends the window under another
setting exits non-zero.

Its cell, ``n2n_f32_b4`` (configuration ``improved_unet48_f32_tf32``,
traffic ``n2n_b4_352``), is held back from ``BENCHMARK.json``: the step
launches about 2,550 kernels, the host's launch rate sets its time, and
runs spread by more than half of ``train_step_ms``'s bound.

``CONTROLS``: the reference put in the program's place in bf16, with its
mask drawn one Philox counter off, with its noise from another seed, and
with half of each batch left out.
"""
from __future__ import annotations

import time

import torch

from image_denoising_tpu_torch.models.improved_unet import ImprovedUNet
from image_denoising_tpu_torch.ops import AugmentNoise, OperationSeed
from image_denoising_tpu_torch.train.state import create_train_state
from image_denoising_tpu_torch.train.steps import make_n2n_train_step

from .. import check, record
from ..harness import Outcome
from ..reference import n2n as ref_n2n
from ..reference.net import make_weights
from ..reference.precision import conv_fn, exact_float32
from ..tracing import Capture, spans
from ..traffic import epoch_batches, pair_pool
from . import (UnitClock, build_module, device_ms, event_pair, free, memory_peak,
               quartiles)
from .structure_step import BETA1, FOLLOWED, first_batches

HOST_SPANS = ("batch", "step", "fetch")
CONTROLS = {"bfloat16": {"conv": conv_fn("bfloat16")}, "mask_shift": {"counter_offset": 1},
            "noise_seed": {"noise_offset": 1}, "half_batch": {}}


def reference(cell, seed: int, batches, device, **variant):
    """(losses, first-gradient norms, change norms) of the reference's steps,
    leaves in ``make_weights`` order; ``variant``: a control's."""
    with exact_float32():
        return ref_n2n.steps(cell.cfg, seed, batches, device, cell.traffic, **variant)


def controls(cell):
    return sorted(CONTROLS)


def control_readings(cell, seed: int, control: str, device) -> dict:
    """The comparison's readings with control ``control`` in the program's
    place."""
    clean, noisy = pair_pool(seed, cell.traffic["pairs"])
    batches = first_batches(cell, seed, clean, noisy)
    fed = batches
    if control == "half_batch":
        fed = [(c[: len(c) // 2], n[: len(n) // 2]) for c, n in batches]
    return check.train_readings(reference(cell, seed, fed, device, **CONTROLS[control]),
                                reference(cell, seed, batches, device))


def run(cell, seed, seconds, trace, device, t_start) -> Outcome:
    cfg, tr = cell.cfg, cell.traffic
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    span = spans(trace)
    t0 = time.time()
    phases = {"start_s": t0 - t_start}
    clean, noisy = pair_pool(seed, tr["pairs"])
    phases["pairs_s"] = time.time() - t0
    net = build_module(ImprovedUNet, cfg, seed, dev)
    state = create_train_state(net, lr=tr["lr"])
    step_fn = make_n2n_train_step(
        net, state, noise_fn=AugmentNoise(f"gauss{tr['sigma']:g}").add_train_noise,
        increase_ratio=tr["increase_ratio"], n_epoch=tr["n_epoch"],
        lambda1=tr["lambda1"], lambda2=tr["lambda2"])
    phases["model_s"] = time.time() - t0 - phases["pairs_s"]
    params = dict(net.named_parameters())
    order = epoch_batches(seed, tr["pairs"]["pool"], tr["batch"])
    opseeds = OperationSeed(seed)

    clock = UnitClock(tr["warmup_units"], seconds, t_start)
    capture, card_before, pending, pairs = None, None, None, []
    losses, first_grad, after = [], None, None
    trace_at = tr["warmup_units"] + tr["trace_skip"]
    k = 0
    while True:
        if trace and k == trace_at:
            capture = Capture(record.RECORD_DIR / f"{cell.name}.trace.json",
                              HOST_SPANS, cuda, 1, tr["trace_units"])
            capture.start()
        with span("batch"):
            idx = next(order)
            c, n = clean[idx], noisy[idx]
        pair = event_pair(cuda)
        with span("step"):
            metrics = step_fn(c, n, opseeds.next(), tr["epoch"])
        if pair:
            pair[1].record()
        pairs.append(pair)
        if k == 0:  # Adam's first moment after one step is (1 − β1)·g
            first_grad = {name: state.optimizer.state[p]["exp_avg"].clone()
                          for name, p in params.items()}
        if k == FOLLOWED - 1:
            after = {name: p.detach().clone() for name, p in params.items()}
        if pending is not None:
            with span("fetch"):
                loss = float(pending["loss"])
            going = clock.complete()
            if capture:
                capture.step()
            done = len(clock.done) - 1
            if done < FOLLOWED:
                losses.append(loss)
            if done == 0:
                card_before = record.card_state()
            if not going:
                break
        pending = metrics
        k += 1
    if capture:
        capture.stop()
    if cuda:
        torch.cuda.synchronize()
    if torch.backends.cudnn.allow_tf32 != cfg["cudnn_tf32"]:
        raise SystemExit(f"gpubench: the step ran with cuDNN TF32 "
                         f"{torch.backends.cudnn.allow_tf32}; {cell.cfg['name']} "
                         f"states {cfg['cudnn_tf32']}")
    units = clock.units
    phases["warmup_s"] = clock.setup_s - sum(phases.values())
    peak = memory_peak(cuda, dev)
    card_after = record.card_state()
    unit_ms = device_ms(pairs[u] for u in units)
    e2e = {"train_step_ms": clock.window_s / len(units) * 1e3, "setup_s": clock.setup_s}
    summary = capture.summary() if capture else None

    start = make_weights(cfg, seed, dev)
    prog = (losses,
            [float(first_grad[k_].norm()) / (1 - BETA1) for k_ in start],
            [float((after[k_] - start[k_]).norm()) for k_ in start])
    leaves = list(start)
    del net, state, step_fn, params, first_grad, after, start, pending, metrics
    free(cuda)
    ref = reference(cell, seed, first_batches(cell, seed, clean, noisy), dev)
    readings = check.train_readings(prog, ref)
    rec = {"workload": cell.name, "seed": seed, "setup_s": clock.setup_s,
           "window_s": clock.window_s, "units": len(units),
           "setup_phases": phases, "card_before": card_before, "card_after": card_after,
           "unit_ms_quartiles": quartiles(unit_ms), "unit_device_ms": unit_ms,
           "warmup_device_ms": device_ms(pairs[:tr["warmup_units"]]),
           "kernel_counts": summary["kernel_counts"] if summary else None,
           "trace_units_read": summary["n_units"] if summary else None,
           "first_losses": {"program": prog[0], "reference": ref[0]},
           "leaves_left_out": [leaves[i] for i in check.rounding_leaves(ref[1])],
           "end_to_end": e2e}
    return Outcome(end_to_end=e2e, attempted=len(units), failed=0,
                   memory_peak_bytes=peak, summary=summary, readings=readings,
                   record=rec)
