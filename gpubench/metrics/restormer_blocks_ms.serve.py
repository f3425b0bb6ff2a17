"""Device milliseconds a burst spends in Restormer's transformer blocks: the
sum of the program's eight device-timed stage spans (``restormer.enc1`` …
``restormer.refine``, ``models/restormer.py``) over the wholly recorded
bursts. The patch embed, the samplers, the reduce convs, the
concatenations and the output conv fall outside them."""
from gpubench.metrics._restormer import blocks_ms


def read(cell, summary):
    return blocks_ms()
