"""Wall milliseconds a step call holds the host: the program's
``train.step`` span (``train/steps.py::make_structure_train_step``), host
clock, over the recorded steps. The time includes the host's waits for
the device inside the call (a full launch queue, copies that wait for the
stream), so it is not the host's own work alone."""
from gpubench.metrics._program import per_unit


def read(cell, summary):
    return per_unit(("train.step",), "wall_ms")
