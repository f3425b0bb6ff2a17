"""Closed-loop burst serving through the port's E2 path, for the network the
configuration names.

The configuration gives the port's ``arch`` with its published widths
(``inp_channels`` and ``dim``, which ``denoise``'s ``--n_channel`` and
``--n_feature`` set) and its plain reference,
``gpubench/reference/<reference>.py``, with ``make_weights(cfg, seed,
device)``, ``forward(sd, x, cfg, **variant)`` and ``CONTROLS`` (name: the
``variant`` of each control). The loop, the window, its completions, the
fetch and the comparison are ``tiled_burst.run``'s own: it runs with its
``build_module`` and ``reference_frames`` bound to this module's, which
build the port's module as ``cli/common.py::build_network`` builds it for
``denoise --arch``, load the reference's seeded weights into it with
``strict=True``, and judge the bursts against the reference's frames.
"""
from __future__ import annotations

import importlib
from unittest import mock

import torch

from image_denoising_tpu_torch.cli.common import build_network
from image_denoising_tpu_torch.models.registry import ARCHS

from .. import check
from ..reference.precision import exact_float32
from ..reference.tiling import denoise_frames, tile_grid
from ..traffic import frame_pool
from . import tiled_burst


def reference_of(cfg):
    return importlib.import_module(f"gpubench.reference.{cfg['reference']}")


def build_module(_model_cls, cfg, seed: int, device):
    """The port's module for ``cfg["arch"]`` with the reference's weights,
    made on ``device`` without a host-side init."""
    with torch.device("meta"):
        net = build_network(cfg["arch"], None, cfg["inp_channels"], cfg["dim"])
    net = net.to_empty(device=device)
    net.load_state_dict(reference_of(cfg).make_weights(cfg, seed, device), strict=True)
    return net


def reference_frames(cell, seed: int, pool, device, **variant):
    """The reference's uint8 frames of every pool frame (``variant``: a
    control's)."""
    tr, ref = cell.traffic, reference_of(cell.cfg)
    sd = ref.make_weights(cell.cfg, seed, device)
    with exact_float32():
        return denoise_frames(pool, lambda x: ref.forward(sd, x, cell.cfg, **variant),
                              tr["tile"], tr["overlap"], abs(tr["tile_batch"]), device)


def controls(cell):
    """The names of the reference's controls."""
    return sorted(reference_of(cell.cfg).CONTROLS)


def control_readings(cell, seed: int, control: str, device) -> dict:
    """The comparison's readings with control ``control``'s frames in the
    program's place."""
    tr = cell.traffic
    fb, hw = tr["burst"], tr["frames"]["hw"]
    pool = frame_pool(seed, tr["frames"])
    ref = reference_frames(cell, seed, pool, device)
    ctl = reference_frames(cell, seed, pool, device,
                           **reference_of(cell.cfg).CONTROLS[control])
    outs = [(b, ctl[b * fb:(b + 1) * fb]) for b in range(len(pool) // fb)]
    return check.frame_readings(outs, ref, fb, len(pool),
                                tile_grid(hw, hw, tr["tile"], tr["overlap"]))


def run(cell, seed, seconds, trace, device, t_start):
    if cell.cfg["arch"] not in ARCHS:
        raise SystemExit(f"gpubench: the program has no arch {cell.cfg['arch']!r} "
                         f"(it has {ARCHS})")
    with mock.patch.multiple(tiled_burst, build_module=build_module,
                             reference_frames=reference_frames):
        return tiled_burst.run(cell, seed, seconds, trace, device, t_start)
