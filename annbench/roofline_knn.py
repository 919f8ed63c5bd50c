"""Frozen roofline arithmetic of K4, the program's exact kNN kernel: the
least time its work could take on one H100, at ``annbench/roofline.py``'s
peaks."""

from __future__ import annotations

from annbench.roofline import least_s


def knn_work(*, m: int, n: int, d: int, k: int) -> tuple:
    """``(bytes, operations)`` of an exact float32 kNN of ``m`` queries
    among ``n`` points of ``d`` elements, returning ``k`` float32
    distances and ``k`` int32 ids a query.  Bytes: each input read once,
    each output written once.  Operations: 2·d float32 operations a
    distance, m·n distances."""
    return (m + n) * d * 4 + m * k * 8, 2 * m * n * d


def knn_least_s(**shape) -> float:
    """The least seconds of :func:`knn_work` on one H100."""
    return least_s(*knn_work(**shape))[0]
