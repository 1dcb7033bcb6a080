"""Device milliseconds of BatchNorm kernels per training step."""
from benchmark.metrics._common import BATCHNORM


def read(m):
    return m.trace.device_s(*BATCHNORM) / m.trace.units * 1e3
