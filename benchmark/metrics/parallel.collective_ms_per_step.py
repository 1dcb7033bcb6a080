"""Device milliseconds of NCCL kernels per training step on rank 0's
card, from the profiled stretch (a collective's kernel runs from its
launch until its peers have sent their share, so this holds the wait for
them as well as the transfer).  None where the stretch ran none."""


def read(m):
    if not m.trace.count("nccl"):
        return None
    return m.trace.device_s("nccl") / m.trace.units * 1e3
