"""Seconds a build's host merge spends on the distances of its unique
edges (``_segment_distances``): the window's ``merge.distances`` spans over
its ``build.merge`` spans."""

from annbench.metrics_spans import per_parent


def read(r: dict):
    return per_parent(r, ("merge.distances",), "build.merge")
