"""Seconds a build's shard builds spend on their exact kNN graphs (the
upload, K4 and the read-backs): the window's ``shard.knn`` spans over its
``build.shards`` spans."""

from annbench.metrics_spans import per_parent


def read(r: dict):
    return per_parent(r, ("shard.knn",), "build.shards")
