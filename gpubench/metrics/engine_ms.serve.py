"""Device milliseconds a burst spends in the tiled engine's own phases: the
frames to the device and to float, the gather, the predictions' cast and
tile L1, the blend and the quantise (the program's device-timed
``tiled.*`` spans, ``eval/tiled.py::_run_frames``), over the fully recorded
bursts; the forward's span is left out."""
from gpubench.metrics._program import per_unit

SPANS = ("tiled.frames", "tiled.gather", "tiled.l1", "tiled.blend", "tiled.quantize")


def read(cell, summary):
    return per_unit(SPANS, "device_ms")
