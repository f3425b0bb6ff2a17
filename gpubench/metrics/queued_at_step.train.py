"""Steps still queued on the device when the host starts the next one: the
mean of the program's ``train.step.queued`` counter
(``train/steps.py::make_structure_train_step``). A lag-1 loop whose queue
held would read 1."""
from gpubench.metrics._program import mean_queued


def read(cell, summary):
    return mean_queued("train.step")
