"""Wall milliseconds a burst's submit holds the host: the program's
``burst.load`` and ``burst.submit`` spans (``cli/common.py::iter_bursts``),
host clock, over the recorded bursts. The time includes the host's waits
for the device inside the submit (a full launch queue, the pageable copy
of the frames), so it is not the host's own work alone."""
from gpubench.metrics._program import per_unit


def read(cell, summary):
    return per_unit(("burst.load", "burst.submit"), "wall_ms")
