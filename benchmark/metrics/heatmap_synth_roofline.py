"""Percent of its roofline that the heatmap kernel reaches: the time its
bytes take at the card's bandwidth (``flops.heatmap_bytes``) over its
device time per launch.  None where it did not run or the card is not in
the table of peaks."""


def read(m):
    n = m.trace.count("heatmap_synth")
    nbytes = m.kernel_bytes.get("heatmap_synth")
    if not n or nbytes is None or m.peak_bytes_per_s is None:
        return None
    per_launch = m.trace.device_s("heatmap_synth") / n
    return 100.0 * nbytes / m.peak_bytes_per_s / per_launch
