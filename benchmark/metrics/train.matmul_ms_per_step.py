"""Device milliseconds of GEMM kernels per training step (cuBLAS's
``nvjet`` and ``sm90_xmma_gemm`` kernels, CUTLASS's), leaving out the
convolution families and the attention kernels, whose names may carry
"gemm" or "cutlass" too.  None where the stretch ran none."""
GEMM = ("nvjet", "gemm", "cutlass")
NOT_GEMM = ("implicit", "fprop", "dgrad", "wgrad", "conv", "flash", "fmha",
            "sdpa")


def read(m):
    if not m.trace.count(*GEMM):
        return None
    return m.trace.device_s(*GEMM, exclude=NOT_GEMM) / m.trace.units * 1e3
