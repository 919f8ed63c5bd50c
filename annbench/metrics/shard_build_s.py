"""Seconds a build spends in its shard builds (CAGRA kNN graph by K4 and
``optimize_graph``): the mean of the window's ``build.shards`` spans."""

from annbench.metrics_common import span_mean


def read(r: dict):
    return span_mean(r, "build.shards")
