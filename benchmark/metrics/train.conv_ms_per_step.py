"""Device milliseconds of convolution kernels per training step."""
from benchmark.metrics._common import BATCHNORM, CONVOLUTION


def read(m):
    return m.trace.device_s(*CONVOLUTION, exclude=BATCHNORM) \
        / m.trace.units * 1e3
