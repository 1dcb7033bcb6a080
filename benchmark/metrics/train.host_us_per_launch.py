"""Host microseconds per device launch: the unprofiled window's time per
step over the launches per step of the profiled stretch."""
from benchmark.metrics._common import unit_seconds


def read(m):
    launches = m.trace.launches() / m.trace.units
    return unit_seconds(m.window) / launches * 1e6 if launches else None
