"""Bursts still queued on the device when the host submits the next one:
the mean of the program's ``burst.queued`` counter
(``cli/common.py::iter_bursts``). A queue of 3 that held would read 2."""
from gpubench.metrics._program import mean_queued


def read(cell, summary):
    return mean_queued("burst")
