"""What the Restormer readers share: the program's stage spans
(``models/restormer.py``: ``restormer.<stage>``, device-timed, one around
each stage's transformer blocks in every forward) and ``restormer.tiles``
counter, as the traced stretch left them in the record."""
import statistics

from gpubench.metrics._program import program_record

STAGES = ("enc1", "enc2", "enc3", "latent", "dec3", "dec2", "dec1", "refine")
SPANS = tuple(f"restormer.{s}" for s in STAGES)


def blocks_ms():
    """Mean over the wholly recorded bursts of the device ms in the stage
    spans; None where no burst is. A burst is whole where each stage's span
    is recorded equally often in it, each with a device time."""
    rec = program_record()
    if not rec:
        return None
    units = {}
    for s in rec["spans"]:
        if s["name"] in SPANS and s["unit"] is not None:
            units.setdefault(s["unit"], []).append(s)
    sums = []
    for spans in units.values():
        counts = {name: sum(s["name"] == name for s in spans) for name in SPANS}
        if len(set(counts.values())) == 1 and all(s["device_ms"] is not None for s in spans):
            sums.append(sum(s["device_ms"] for s in spans))
    return statistics.fmean(sums) if sums else None


def tiles_per_burst():
    """``restormer.tiles`` over the ``burst`` spans recorded beside it (both
    count while the profiler records); None without the counter, or where
    the record is full and may have dropped a burst's span."""
    from image_denoising_tpu_torch.utils import profiling

    rec = program_record()
    tiles = rec["counters"].get("restormer.tiles") if rec else None
    bursts = sum(s["name"] == "burst" for s in rec["spans"]) if rec else 0
    if not tiles or not bursts or len(rec["spans"]) >= profiling.KEEP:
        return None
    return tiles / bursts
