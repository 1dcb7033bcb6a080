"""Percent of the card's peak that the serving window reached with the
forward flops of the requested frames (the chunks' padding not counted)."""
from benchmark.metrics._common import mfu_percent


def read(m):
    return mfu_percent(m)
