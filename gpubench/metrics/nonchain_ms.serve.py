"""Device milliseconds a burst spends outside the chain kernel and the
copies: the forward's plain operations and the engine's gather, blend and
quantise."""

KERNELS = ("chain_conv_kernel<", "chain_finish_kernel<")


def read(cell, summary):
    t = sum(s for name, s in summary["ops"].items() if not any(k in name for k in KERNELS))
    return 1e3 * t / summary["n_units"] if t else None
