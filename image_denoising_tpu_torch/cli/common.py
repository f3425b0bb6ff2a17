"""Shared CLI plumbing of the evaluators, the ``denoise`` serving CLI, the
trainer and the finetuners (counterpart of
``image_denoising_tpu/cli/common.py``).

Model construction, ``.ckpt`` and ``.pth`` loading, PNG writing, the
per-image metrics file, the lazy burst stream of ``--frame_burst`` with its
on-device scoring hook, the whole-frame forward of the adapter evaluators,
the ``--host_workers`` pool of the per-frame host pass, the ``--dtype``
and ``--blindspot`` flags, and the devices of ``--device``,
``--gpu_devices``, ``--parallel`` and ``--bank_sharded``.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..ckpt.io import load_checkpoint, module_arch
from ..models.registry import build_model, build_model_from_log_name

__all__ = [
    "add_blindspot_flag",
    "add_dtype_flag",
    "resolve_dtype",
    "build_network",
    "load_params",
    "save_png",
    "MetricsWriter",
    "iter_bursts",
    "make_clean_post",
    "drain_burst",
    "batched_frame_forward",
    "add_host_workers_flag",
    "HostWorkPool",
    "make_metrics_finalize",
    "cli_mesh",
    "cli_device",
    "load_frozen_base",
    "iqsl_config",
    "run_epoch",
]


def add_blindspot_flag(parser) -> None:
    """--blindspot: 4-rotation blindspot UNet/RESNET with the explicit --arch
    path (the log_name 'blindspot' substring dispatch needs no flag)."""
    parser.add_argument(
        "--blindspot", action="store_true",
        help="build the blindspot variant (4-rotation stack, shifted "
             "convs/pools) when --arch is given; with log_name dispatch "
             "use a 'blindspot' substring instead (reference "
             "train.py:298-302)",
    )


def add_dtype_flag(parser, default: str = "float32") -> None:
    """--dtype: compute dtype for the model (params always stay float32)."""
    parser.add_argument(
        "--dtype", type=str, default=default,
        choices=["float32", "bfloat16"],
        help="compute dtype; params stay float32",
    )


def resolve_dtype(name: Optional[str]):
    """'bfloat16' → torch.bfloat16; 'float32'/None → None (f32 compute)."""
    return torch.bfloat16 if name == "bfloat16" else None


def build_network(arch: Optional[str], log_name: Optional[str],
                  n_channel: int, n_feature: int, dtype: Optional[torch.dtype] = None,
                  remat: bool = False, remat_depth: Optional[int] = None,
                  blindspot: bool = False) -> torch.nn.Module:
    """Explicit ``--arch`` wins; otherwise the reference ``--log_name``
    substring dispatch (``models/registry.py``). ``dtype`` is the compute
    dtype (parameters stay float32); ``remat`` and ``remat_depth`` recompute
    ImprovedUNet's blocks in backward. ``blindspot`` applies to the explicit
    ``--arch`` path (UNet/RESNET); the log-name path carries it through the
    reference's ``blindspot`` substring on its own."""
    if arch:
        return build_model(arch, n_channel, n_feature, dtype=dtype, remat=remat,
                           remat_depth=remat_depth, blindspot=blindspot)
    if log_name:
        return build_model_from_log_name(log_name, n_channel, n_feature, dtype=dtype,
                                         remat=remat, remat_depth=remat_depth)
    raise ValueError("need --arch or --log_name to select an architecture")


def load_params(ckpt_path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a ``.ckpt`` params tree or a reference-layout ``.pth`` into
    ``model`` with ``strict=True``."""
    model.load_state_dict(load_checkpoint(ckpt_path, arch=module_arch(model)),
                          strict=True)
    return model


def save_png(arr: np.ndarray, path: str, mode: Optional[str] = "RGB") -> None:
    """uint8 array → PNG with PIL convert semantics (compress_level=1 is
    lossless, like the default, and faster to encode)."""
    from PIL import Image

    img = Image.fromarray(arr)
    if mode:
        img = img.convert(mode)
    img.save(path, compress_level=1)


def iter_bursts(by_shape, get_frame, fb, make_runner, extra=(), post=None,
                max_inflight=3):
    """Lazy burst stream for ``--frame_burst``.

    One runner per frame-shape bucket ({(h, w): [frame indices]}); frames
    are loaded per chunk via ``get_frame(j)`` (2-D uint8), the tail chunk is
    padded by repeating its last frame, and at most ``max_inflight`` bursts
    are queued on the device so host work on drained frames overlaps device
    work on later ones. ``extra`` is passed to every runner call after the
    frames. Yields ``(chunk, runner_out, post_out)``, where ``post(chunk,
    runner_out)`` (optional) queues more device work on the outputs while
    they are still on the device (the ``--device_metrics`` scorer).
    """
    for (h, w), idxs in sorted(by_shape.items()):
        runner = make_runner(h, w)
        inflight = []
        for s in range(0, len(idxs), fb):
            chunk = idxs[s : s + fb]
            batchf = np.stack([get_frame(j) for j in chunk])
            if len(chunk) < fb:
                batchf = np.concatenate(
                    [batchf, np.repeat(batchf[-1:], fb - len(chunk), 0)]
                )
            out = runner(torch.from_numpy(batchf), *extra)
            inflight.append((chunk, out, post(chunk, out) if post else None))
            if len(inflight) >= max_inflight:
                yield inflight.pop(0)
        while inflight:
            yield inflight.pop(0)


def make_clean_post(get_clean, fb, metrics_fn, pick_pred=lambda out: out):
    """The ``--device_metrics`` ``post()`` of :func:`iter_bursts`.

    Stacks the chunk's clean frames via ``get_clean(j)`` (2-D uint8), pads
    the tail chunk by repeating its last frame (the padding ``iter_bursts``
    gives the noisy batch), and scores the predictions that ``pick_pred``
    selects from the runner output (``out[0]`` for the pyramid engine's
    ``(preds, l1)``) with ``metrics_fn``, on their device.
    """

    def post(chunk, out):
        cleanf = np.stack([get_clean(j) for j in chunk])
        if len(chunk) < fb:
            cleanf = np.concatenate(
                [cleanf, np.repeat(cleanf[-1:], fb - len(chunk), 0)]
            )
        pred = pick_pred(out)
        clean = torch.from_numpy(cleanf)
        if pred.device.type == "cuda":  # a pinned copy waits for no queued work
            clean = clean.pin_memory().to(pred.device, non_blocking=True)
        with torch.inference_mode():
            return metrics_fn(pred, clean)

    return post


def drain_burst(item, cache, fetch_pred=True, pick=lambda out: (out, ())):
    """Fetch one in-flight burst of :func:`iter_bursts` to a host cache.

    ``pick(runner_out) -> (pred_dev, extras_dev)`` splits the runner output
    into the prediction batch and per-frame extras (the pyramid engine's
    L1). Cache entries are ``(pred_or_None, *extras_j,
    device_metrics_or_None)``; with ``fetch_pred=False`` (``--device_metrics
    --save_images none``) the predictions never leave the device: only the
    per-frame scalars are copied. Returns the drained chunk of frame indices.
    """
    chunk, out, m_dev = item
    pred_dev, extras_dev = pick(out)
    pred = pred_dev.cpu().numpy() if fetch_pred else None
    extras = [e.cpu().numpy() for e in extras_dev]
    m = [x.cpu().numpy() for x in m_dev] if m_dev is not None else None
    for k, j in enumerate(chunk):
        p = pred[k] if pred is not None else None
        dm = tuple(x[k] for x in m) if m is not None else None
        cache[j] = (p, *(e[k] for e in extras), dm)
    return chunk


def batched_frame_forward(fwd, frames, parallel: bool = False, device="cuda",
                          mesh=None):
    """Whole-frame inference over a list of [H, W, C] float01 frames.

    ``fwd`` takes and returns NCHW tensors. Frames are grouped by shape and
    run at batch 1, as the reference's single-GPU path does; the result is
    the per-frame [H, W, C] float32 predictions, in input order.
    ``parallel=True`` is the ``--parallel`` wiring (the reference's
    ``nn.DataParallel``, ``evaluation_adapter.py:114-115``): frames of one
    shape go in groups of the mesh's size (``mesh``, default every card),
    one frame per device, each run by the device's forward (``fwd.on`` of a
    ``parallel.PerDevice``); a ragged tail is padded by repeating its last
    frame and cropped after.
    """
    from ..parallel.mesh import forward_over_mesh

    group = 1
    if parallel:
        if mesh is None:
            from ..parallel import mesh as pmesh

            mesh = pmesh.make_mesh()
        group = mesh.size
        device = mesh.primary
        print(f"frame-parallel inference over {group} devices")
    on = getattr(fwd, "on", None)
    by_shape: dict = {}
    for i, f in enumerate(frames):
        by_shape.setdefault(np.shape(f), []).append(i)
    preds = [None] * len(frames)
    with torch.inference_mode():
        for _, idxs in sorted(by_shape.items()):
            for s in range(0, len(idxs), group):
                chunk = idxs[s : s + group]
                batch = np.stack([np.asarray(frames[i], np.float32) for i in chunk])
                if len(chunk) < group:
                    batch = np.concatenate(
                        [batch, np.repeat(batch[-1:], group - len(chunk), 0)])
                x = torch.from_numpy(batch).to(device).permute(0, 3, 1, 2)
                if parallel:
                    out = forward_over_mesh(
                        mesh, lambda d, c: (on(d) if on else fwd)(c), x)
                else:
                    out = fwd(x)
                out = out[: len(chunk)].permute(0, 2, 3, 1).float().cpu().numpy()
                for j, i in enumerate(chunk):
                    preds[i] = out[j]
    return preds


def add_host_workers_flag(parser) -> None:
    parser.add_argument(
        "--host_workers", type=int, default=0,
        help="thread-pool size for the per-frame host pass (PSNR/SSIM/IoU + "
             "PNG encode). The native SSIM and PIL's PNG encoder release the "
             "GIL, so frames score in parallel while the main thread keeps "
             "the device fed. Results finalize in frame order: the output is "
             "identical to the default inline pass (0). -1 = one worker per "
             "host CPU.",
    )


class HostWorkPool:
    """Optional thread pool for the CLIs' per-frame host pass.

    ``submit(fn, *args)`` queues one frame's host work; ``finalize(result)``
    runs **in submission order** on the main thread (inside submit/close),
    so stdout lines, ``MetricsWriter`` contents and metrics.txt are
    byte-identical to the inline path. The pending window is bounded
    (2·workers+2) so host memory holds only a few frames. ``workers=0``
    calls ``fn`` inline; ``-1`` means one worker per CPU. Both hot host ops
    release the GIL: the native SSIM (a ctypes call into ``csrc/ssim.cpp``)
    and PIL's PNG encoder.
    """

    def __init__(self, workers: int, finalize=None):
        self.finalize = finalize if finalize is not None else (lambda r: None)
        self._pool = None
        if workers and workers < 0:
            workers = os.cpu_count() or 1
        if workers and workers > 0:
            from collections import deque
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=workers)
            self._pending = deque()
            self._bound = 2 * workers + 2

    def submit(self, fn, *args):
        if self._pool is None:
            self.finalize(fn(*args))
            return
        self._pending.append(self._pool.submit(fn, *args))
        # finalize every finished leading frame without blocking; block on
        # the oldest only when the window is full
        while self._pending and (
            self._pending[0].done() or len(self._pending) > self._bound
        ):
            self.finalize(self._pending.popleft().result())

    def close(self):
        """Drain the remaining frames (in order) and shut the pool down."""
        if self._pool is None:
            return
        try:
            while self._pending:
                self.finalize(self._pending.popleft().result())
        finally:
            self._pool.shutdown(wait=True)
            self._pool = None

    def abort(self):
        """Shut down without finalizing: cancel queued frames, wait for the
        running ones and drop their results, so a failing CLI writes no PNG
        behind its traceback and leaves no thread behind."""
        if self._pool is None:
            return
        self._pending.clear()
        self._pool.shutdown(wait=True, cancel_futures=True)
        self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        else:
            self.abort()
        return False


def make_metrics_finalize(writer, skip_none: bool = False):
    """Per-frame finalize: record ``(msg, writer_kwargs)`` and print ``msg``.
    ``skip_none`` ignores frames with no ground truth (adapter eval)."""

    def _finalize(res):
        if res is None:
            if skip_none:
                return
            raise ValueError("host pass returned None")
        msg, add_kw = res
        writer.add(**add_kw)
        print(msg)

    return _finalize


class MetricsWriter:
    """Accumulates per-image metrics and writes the reference metrics.txt."""

    def __init__(self):
        self.psnr, self.ssim, self.l1 = [], [], []
        self.iou_dark, self.iou_mid, self.iou_bright = [], [], []

    def add(self, psnr=None, ssim=None, l1=None, ious=None):
        if psnr is not None:
            self.psnr.append(psnr)
        if ssim is not None:
            self.ssim.append(ssim)
        if l1 is not None:
            self.l1.append(l1)
        if ious is not None:
            self.iou_dark.append(ious[0])
            self.iou_mid.append(ious[1])
            self.iou_bright.append(ious[2])

    def averages(self):
        out = {}
        if self.psnr:
            out["psnr"] = float(np.mean(self.psnr))
        if self.ssim:
            out["ssim"] = float(np.mean(self.ssim))
        if self.l1:
            out["l1"] = float(np.mean(self.l1))
        if self.iou_dark:
            out["iou_dark"] = float(np.nanmean(self.iou_dark))
            out["iou_mid"] = float(np.nanmean(self.iou_mid))
            out["iou_bright"] = float(np.nanmean(self.iou_bright))
        return out

    def write(self, save_dir: str) -> str:
        avg = self.averages()
        path = os.path.join(save_dir, "metrics.txt")
        with open(path, "w") as f:
            if "psnr" in avg:
                f.write(f"Average PSNR: {avg['psnr']:.2f}\n")
            if "ssim" in avg:
                f.write(f"Average SSIM: {avg['ssim']:.4f}\n")
            if "l1" in avg:
                f.write(f"Average L1 Loss: {avg['l1']:.6f}\n")
            if "iou_dark" in avg:
                f.write(
                    "Average 3-class IoU (dark/mid/bright): "
                    f"{avg['iou_dark']:.4f}, {avg['iou_mid']:.4f}, {avg['iou_bright']:.4f}\n"
                )
        print(f"Saved metrics to {path}")
        return path


# the finetuners (cli/finetune.py, finetune_iqsl.py, finetune_memory.py)

def _gpu_ids(opt):
    """The card indices ``--gpu_devices`` names ("0", or a list "0,1")."""
    return [int(i) for i in str(getattr(opt, "gpu_devices", "0")).split(",") if i.strip()]


def cli_mesh(opt):
    """The device mesh of ``--parallel`` / ``--bank_sharded``: the cards
    ``--gpu_devices`` names where it names more than one, else every
    visible card (the JAX package's ``make_mesh()``); ``--device cpu``
    gives a mesh of one CPU device."""
    from ..parallel import mesh as pmesh

    if opt.device == "cpu":
        devices = ["cpu"]
    else:
        ids = _gpu_ids(opt)
        devices = [f"cuda:{i}" for i in ids] if len(ids) > 1 else None
    mesh = pmesh.make_mesh(devices=devices)
    for d in mesh.distinct():
        if d.type == "cuda" and d.index is not None and d.index >= torch.cuda.device_count():
            raise RuntimeError(f"--gpu_devices names {d}, but only "
                               f"{torch.cuda.device_count()} cards are visible")
    return mesh


def cli_device(opt, mesh=None) -> str:
    """The device a CLI runs on: the first device of ``mesh`` where it has
    one (``--parallel``), else ``cpu`` for ``--device cpu``, else the first
    card ``--gpu_devices`` names (``cuda:N``), as the reference's
    ``CUDA_VISIBLE_DEVICES`` + ``.cuda()`` does. Raises where there is no
    card."""
    from ..utils.device import resolve_device

    if mesh is not None:
        device = str(mesh.primary)
    elif opt.device == "cpu":
        device = "cpu"
    else:
        device = f"cuda:{_gpu_ids(opt)[0]}"
    resolve_device(device)  # fail before any loading when there is no GPU
    return device


def load_frozen_base(opt, device, mesh=None):
    """(base module, its frozen forward on ``device``): the ``--arch``
    network with ``--pretrained_ckpt``'s weights, run by ``make_forward``
    (the chain kernel for an ImprovedUNet) in the ``--dtype`` compute dtype;
    with a ``mesh``, one copy per device (``parallel.PerDevice``)."""
    from ..models.fused_forward import make_forward

    base = load_params(opt.pretrained_ckpt,
                       build_model(opt.arch, opt.n_channel, opt.n_feature))
    print(f"Loaded base weights from {opt.pretrained_ckpt}")
    dtype = torch.bfloat16 if opt.dtype == "bfloat16" else torch.float32
    return base, make_forward(base, device=device, dtype=dtype, mesh=mesh)


def iqsl_config(opt):
    """The IQSL settings, thresholds estimated from clean/ when λ_iqsl > 0."""
    from ..losses import estimate_intensity_thresholds

    if opt.lambda_iqsl > 0.0:
        t1, t2 = estimate_intensity_thresholds(
            opt.data_dir, q1=opt.iqsl_q1, q2=opt.iqsl_q2, max_images=opt.iqsl_max_images)
        print(f"[IQSL] Estimated thresholds from clean/: t1={t1:.6f}, t2={t2:.6f}")
    else:
        t1 = t2 = 0.0
        print("[IQSL] lambda_iqsl=0 → IQSL disabled.")
    return {"t1": t1, "t2": t2, "tau": opt.iqsl_tau, "margin": opt.iqsl_margin,
            "ce_factor": opt.iqsl_ce_factor}


def run_epoch(step, batches, epoch, n_epoch, *bank, iqsl: bool = True):
    """One epoch of ``step`` over ``batches`` with the CLIs' lag-1 metric
    fetch (step i's metrics are read after step i+1 is queued) and their
    log lines; returns the per-step L1 and IQSL values."""
    losses_l1, losses_iqsl = [], []
    pending = None

    def flush(p):
        i, m = p
        losses_l1.append(float(m["l1"]))
        losses_iqsl.append(float(m["iqsl"]))
        if i % 10 == 0:
            print(f"Epoch [{epoch}/{n_epoch}] Iter [{i}] L1={float(m['l1']):.6f} "
                  f"Grad={float(m['grad']):.6f} "
                  + (f"IQSL={float(m['iqsl']):.6f} " if iqsl else "")
                  + f"Total={float(m['loss']):.6f}")

    for i, (clean, noisy) in enumerate(batches, start=1):
        metrics = step(clean, noisy, *bank)
        if pending is not None:
            flush(pending)
        pending = (i, metrics)
    if pending is not None:
        flush(pending)
    return losses_l1, losses_iqsl
