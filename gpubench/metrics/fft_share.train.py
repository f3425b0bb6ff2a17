"""Share of the card's busy time in cuDNN's FFT convolution path: its FFT
kernels and the complex GEMM between them (names holding ``fft``,
``cf32`` or ``cgemm``)."""

NAMES = ("fft", "cf32", "cgemm")


def read(cell, summary):
    if not summary["busy_s"]:
        return None
    t = sum(s for name, s in summary["ops"].items() if any(n in name.lower() for n in NAMES))
    return 100.0 * t / summary["busy_s"]
