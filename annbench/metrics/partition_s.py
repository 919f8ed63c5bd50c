"""Seconds a build spends partitioning: the mean of the window's
``build.partition`` spans (``core/builder.py``)."""

from annbench.metrics_common import span_mean


def read(r: dict):
    return span_mean(r, "build.partition")
