"""NCCL kernels per training step on rank 0's card, from the profiled
stretch: the collectives that the step issues there.  None where the
stretch ran none."""


def read(m):
    n = m.trace.count("nccl")
    return n / m.trace.units if n else None
