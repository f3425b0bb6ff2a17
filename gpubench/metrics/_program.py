"""The program's own record of spans and counters
(``image_denoising_tpu_torch/utils/profiling.py``), as the traced stretch
of the run left it in this process. A program that keeps no such record
gives None, and so does every reader that finds nothing in it."""
import statistics


def program_record():
    """``profiling.record()``, or None where the program has none."""
    from image_denoising_tpu_torch.utils import profiling

    read = getattr(profiling, "record", None)
    return read() if read is not None else None


def _ms(span, key):
    if key == "wall_ms":
        return (span["end_ns"] - span["start_ns"]) / 1e6
    return span["device_ms"]


def per_unit(names, key):
    """Mean over the recorded units (bursts or steps) of the sum of ``key``
    ("wall_ms", the host clock, or "device_ms") over the spans ``names``,
    where each of them is recorded once in the unit with a value; None
    where no unit is."""
    rec = program_record()
    if not rec:
        return None
    units = {}
    for s in rec["spans"]:
        if s["name"] in names and s["unit"] is not None:
            units.setdefault(s["unit"], []).append((s["name"], _ms(s, key)))
    sums = [sum(v for _, v in got) for got in units.values()
            if sorted(n for n, _ in got) == sorted(names)
            and all(v is not None for _, v in got)]
    return statistics.fmean(sums) if sums else None


def mean_queued(loop):
    """``<loop>.queued`` over ``<loop>.sampled``: the mean number of earlier
    units still queued on the device at a unit's start; None unsampled."""
    rec = program_record()
    counters = rec["counters"] if rec else {}
    n = counters.get(f"{loop}.sampled", 0)
    return counters.get(f"{loop}.queued", 0) / n if n else None
