"""Frozen roofline arithmetic of the benchmark: one NVIDIA H100's published
peaks and the least time a search's work could take on it.

Peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit, dense
rates: 67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s of HBM3.
"""

from __future__ import annotations

H100_FP32_FLOPS = 67e12
H100_HBM_BYTES = 3.35e12


def least_s(n_bytes: float, n_ops: float,
            peak_ops: float = H100_FP32_FLOPS) -> tuple:
    """``(seconds, "bytes" | "operations")``: the larger of the two bounds."""
    t_bytes = n_bytes / H100_HBM_BYTES
    t_ops = n_ops / peak_ops
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def search_work(*, q: int, d: int, n: int, r: int, k: int, nd: int,
                hops: int) -> tuple:
    """``(bytes, operations)`` of one float32 beam search of ``q`` queries
    over ``n`` points of ``d`` float32 elements and a graph of ``r`` int32
    slots a row, which scored ``nd`` distances and expanded ``hops`` rows
    in all, returning ``k`` int32 ids and ``k`` float32 distances a query
    and three int32 counters a query.

    Bytes: each input read once, and a gathered input (point rows, graph
    rows) no more than the gathers touch and no more than it holds: a store
    that the search sweeps many times counts once, the least it must move
    from HBM; each output written once.  Operations: 2·d float32 operations
    a distance."""
    n_bytes = (min(nd * d, n * d) * 4
               + min(hops * r, n * r) * 4
               + q * d * 4
               + q * k * (4 + 4) + 3 * q * 4)
    return n_bytes, 2 * nd * d


def search_least_s(**shape) -> float:
    """The least seconds of :func:`search_work` on one H100."""
    return least_s(*search_work(**shape))[0]
