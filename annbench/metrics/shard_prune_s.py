"""Seconds a build's shard builds spend pruning their kNN graphs
(``optimize_graph``: the detour counts, the forward selection and reverse
fill, the row dedup): the window's ``shard.prune`` spans over its
``build.shards`` spans."""

from annbench.metrics_spans import per_parent


def read(r: dict):
    return per_parent(r, ("shard.prune",), "build.shards")
