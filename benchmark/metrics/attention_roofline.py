"""Percent of the card's bf16 peak that the attention kernels reach on
the products they must compute: the declared products' flops per step
(``attention_flops.step_flops``: teachers' forward, students' forward and
both operands' gradients) over the attention kernels' device time per
step.  None where the stretch ran no attention kernel, the process is not
a run of a cell, or the card is not in the table of peaks."""
from benchmark import attention_flops

ATTENTION = ("flash", "fmha", "sdpa")


def read(m):
    cell = attention_flops.current_cell()
    if not m.trace.count(*ATTENTION) or cell is None or m.peak_flops is None:
        return None
    seconds = m.trace.device_s(*ATTENTION) / m.trace.units
    return 100.0 * attention_flops.step_flops(cell) / seconds / m.peak_flops
