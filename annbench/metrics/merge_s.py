"""Seconds a build spends in the host merge of its shard graphs: the mean
of the window's ``build.merge`` spans."""

from annbench.metrics_common import span_mean


def read(r: dict):
    return span_mean(r, "build.merge")
