"""Closed-loop burst serving through the port's E2 path.

Bursts of ``burst`` frames from the seeded pool, cycled, go through
``cli/common.py::iter_bursts`` (at most ``max_inflight`` queued on the
card) over ``eval/tiled.py::make_tiled_pyramid_runner_frames`` over
``models/fused_forward.py::make_forward``, as the ``denoise`` CLI drives
them; a burst completes when its frames are in host memory. Every burst
of the window is compared with the reference's frames of its inputs.
"""
from __future__ import annotations

import time

import torch

from image_denoising_tpu_torch.cli.common import iter_bursts
from image_denoising_tpu_torch.eval.tiled import make_tiled_pyramid_runner_frames
from image_denoising_tpu_torch.models.fused_forward import make_forward
from image_denoising_tpu_torch.models.improved_unet import ImprovedUNet
from image_denoising_tpu_torch.ops.fused_block import fused_rdb_chain

from .. import check, record
from ..harness import Outcome, nearest_rank
from ..reference import net as ref_net
from ..reference.precision import conv_fn, exact_float32
from ..reference.tiling import denoise_frames, tile_grid
from ..tracing import Capture, spans
from ..traffic import frame_pool
from . import (UnitClock, build_module, device_ms, event_pair, free, memory_peak,
               quartiles)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
HOST_SPANS = ("frames", "submit", "fetch")
# bursts a stream could take: far more than any window completes
MAX_BURSTS = 1 << 20


def reference_frames(cell, seed: int, pool, device, precision: str = "float32"):
    """The reference's uint8 frames of every pool frame, in ``precision``."""
    tr = cell.traffic
    sd = ref_net.make_weights(cell.cfg, seed, device)
    conv = conv_fn(precision)
    with exact_float32():
        return denoise_frames(pool, lambda x: ref_net.forward(sd, x, cell.cfg, conv),
                              tr["tile"], tr["overlap"], abs(tr["tile_batch"]), device)


def run(cell, seed, seconds, trace, device, t_start) -> Outcome:
    cfg, tr = cell.cfg, cell.traffic
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    span = spans(trace)
    t0 = time.time()
    phases = {"start_s": t0 - t_start}
    pool = frame_pool(seed, tr["frames"])
    phases["frames_s"] = time.time() - t0
    net = build_module(ImprovedUNet, cfg, seed, dev)
    fwd = make_forward(net, device=dev, dtype=DTYPES[cfg["dtype"]])
    del net
    phases["weights_s"] = time.time() - t0 - phases["frames_s"]
    fb, hw, n_pool = tr["burst"], tr["frames"]["hw"], tr["frames"]["pool"]
    submits, pairs = [], []

    def make_runner(h, w):
        runner = make_tiled_pyramid_runner_frames(
            fwd, fb, h, w, tr["tile"], tr["overlap"], batch=tr["tile_batch"],
            out_dtype=tr["out_dtype"], device=dev)

        def timed(frames):
            submits.append(time.perf_counter())
            pair = event_pair(cuda)
            with span("submit"):
                out = runner(frames)
            if pair:
                pair[1].record()
            pairs.append(pair)
            return out
        return timed

    def get_frame(j):
        with span("frames"):
            return pool[j % n_pool]

    clock = UnitClock(tr["warmup_units"], seconds, t_start)
    stream = iter_bursts({(hw, hw): range(fb * MAX_BURSTS)}, get_frame, fb, make_runner,
                         max_inflight=tr["max_inflight"])
    capture, card_before, outputs = None, None, []
    launches0 = None
    trace_at = tr["warmup_units"] + tr["trace_skip"]
    for k, (chunk, (out_dev, _l1), _) in enumerate(stream):
        if trace and k == trace_at:
            capture = Capture(record.RECORD_DIR / f"{cell.name}.trace.json",
                              HOST_SPANS, cuda, tr["max_inflight"], tr["trace_units"])
            capture.start()
        with span("fetch"):
            out = out_dev.cpu().numpy()
        going = clock.complete()
        if capture:
            capture.step()
        if k == 0:
            card_before = record.card_state()
        if k == tr["warmup_units"] - 1:
            launches0 = fused_rdb_chain.launches
        if k >= tr["warmup_units"]:
            outputs.append((chunk.start // fb, out))
        if not going:
            break
    stream.close()
    if capture:
        capture.stop()
    units = clock.units
    phases["warmup_s"] = clock.setup_s - sum(phases.values())
    launches = fused_rdb_chain.launches - launches0
    if cuda:
        torch.cuda.synchronize()
    peak = memory_peak(cuda, dev)
    card_after = record.card_state()
    unit_ms = device_ms(pairs[u] for u in units)
    latency = [(clock.done[u] - submits[u]) * 1e3 for u in units]
    e2e = {"serve_mps": len(units) * fb * hw * hw / 1e6 / clock.window_s,
           "burst_ms_p95": nearest_rank(latency, 95),
           "setup_s": clock.setup_s}
    summary = capture.summary() if capture else None
    del fwd, stream, pairs
    free(cuda)
    ref = reference_frames(cell, seed, pool, dev)
    readings = check.frame_readings(outputs, ref, fb, n_pool,
                                    tile_grid(hw, hw, tr["tile"], tr["overlap"]))
    rec = {"workload": cell.name, "seed": seed, "setup_s": clock.setup_s,
           "window_s": clock.window_s, "units": len(units),
           "setup_phases": phases, "card_before": card_before, "card_after": card_after,
           "unit_ms_quartiles": quartiles(unit_ms), "unit_device_ms": unit_ms,
           "unit_latency_ms": latency, "chain_launches_per_unit":
               launches / len(units),
           "kernel_counts": summary["kernel_counts"] if summary else None,
           "trace_units_read": summary["n_units"] if summary else None,
           "end_to_end": e2e}
    return Outcome(end_to_end=e2e, attempted=len(units), failed=0,
                   memory_peak_bytes=peak, summary=summary, readings=readings,
                   record=rec)
