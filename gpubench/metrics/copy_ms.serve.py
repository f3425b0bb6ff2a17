"""Device milliseconds a burst spends in copies and fills: the frames in,
the outputs out (``gpu_memcpy`` and ``gpu_memset`` records)."""


def read(cell, summary):
    t = summary["copy_s"]
    return 1e3 * t / summary["n_units"] if t else None
