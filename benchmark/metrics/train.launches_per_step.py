"""Device operations (kernels, copies, memsets) per training step, from
the profiled stretch: each is one launch the host has to issue."""


def read(m):
    return m.trace.launches() / m.trace.units
