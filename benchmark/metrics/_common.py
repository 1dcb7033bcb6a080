"""Arithmetic shared by the per-layer readers of ``metrics/``."""

#: device operations by layer, told by their kernel names (cuDNN and
#: CUTLASS convolutions; ATen's and cuDNN's BatchNorm)
BATCHNORM = ("batch_norm", "batchnorm", "bn_fw", "bn_bw")
CONVOLUTION = ("conv", "xmma", "cutlass", "gemm", "implicit", "dgrad",
               "wgrad", "fprop")


def unit_seconds(window):
    """The unprofiled window's seconds per step or request."""
    return window.seconds / window.units


def idle_percent(m):
    """Device idle share of the unprofiled window's time per unit, with
    the profiled stretch's busy time per unit."""
    busy = m.trace.busy_s / m.trace.units
    return 100.0 * (1.0 - busy / unit_seconds(m.window))


def mfu_percent(m):
    """The window's analytic flops over its time, over the peak of the
    chips used; None where the card is not in the table of peaks."""
    if m.peak_flops is None:
        return None
    return 100.0 * m.window.flops / m.window.seconds / (m.peak_flops
                                                        * m.chips)
