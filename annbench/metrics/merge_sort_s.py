"""Seconds a build's host merge spends in its two global sorts (the
``(gid, neighbor)`` dedup sort and the ``(gid, distance)`` cap sort): the
window's ``merge.dedup_sort`` and ``merge.cap_sort`` spans over its
``build.merge`` spans."""

from annbench.metrics_spans import per_parent


def read(r: dict):
    return per_parent(r, ("merge.dedup_sort", "merge.cap_sort"),
                      "build.merge")
