"""Share of its roofline that K4 reaches in the window, in %: the least
time of the window's K4 calls on one H100 (``annbench/roofline_knn.py``,
from each call's shape) over their seconds.  The program records each call
while a tracer is enabled (``repro_torch.kernels.knn_launches``: CUDA
events around the launches on the card), and the harness clears the
record at the window's start (``reset_counts``).  The window's K4 calls
are its shard builds' kNN graphs: nothing without a ``shard.knn`` span,
nor from a program that keeps no such record."""

from annbench.roofline_knn import knn_least_s


def read(r: dict):
    if not any(s[0] == "shard.knn" for s in r.get("spans", [])):
        return None
    from repro_torch import kernels

    launches = getattr(kernels, "knn_launches", None)
    calls = launches() if launches is not None else []
    secs = sum(c[4] for c in calls)
    if not calls or secs <= 0:
        return None
    least = sum(knn_least_s(m=m, n=n, d=d, k=k) for m, n, d, k, _ in calls)
    return 100.0 * least / secs
