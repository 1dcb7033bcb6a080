"""Percent of the chips' peak that the training window reached with the
flops the algorithm needs (``flops.teacher_student_step_flops``)."""
from benchmark.metrics._common import mfu_percent


def read(m):
    return mfu_percent(m)
