"""Percent of a request's time in which the device runs nothing."""
from benchmark.metrics._common import idle_percent


def read(m):
    return idle_percent(m)
