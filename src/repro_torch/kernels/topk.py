"""Exact kNN on the card (counterpart of ``repro/kernels/topk.py``): the
wrapper of the CUDA kernel in ``csrc/knn.cu`` (K4) and its plain version.
Callers go through :func:`repro_torch.kernels.ops.knn`.

K4 splits the N columns into spans across blocks; each block keeps a sorted
(distance, index) top-k of its span, and a second kernel merges a row's
span lists.  :func:`knn_plan` asks the kernel's library for a block's
shape at D and k; the wrapper allocates the scratch: the span lists and,
for L2, the column norms."""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import knn as knn_plain
from repro_torch.telemetry.trace import current_tracer

__all__ = ["KNN_MAX_K", "KnnPlan", "knn_cuda", "knn_plain", "knn_plan"]

KNN_MAX_K = 256
_P = ctypes.c_void_p
_I = ctypes.c_int


@dataclasses.dataclass(frozen=True)
class KnnPlan:
    """A K4 block's shape: ``rows`` queries a block (64 or 32) and whether
    their Q panel stays in shared memory (``"resident"``) or streams
    through the ring beside x, one 32-deep chunk at a time
    (``"streamed"``)."""

    rows: int
    panel: str


def knn_plan(d: int, k: int) -> KnnPlan:
    """The block shape K4 takes at this D and k (``repro_knn_plan``): the
    resident panel at 64 rows, then 32 (every D up to 864 at k = 129),
    then the streamed panel at 64 rows, then 32 (any D); the first whose
    shared memory fits a block."""
    rows, streamed = _I(), _I()
    limit = _lib().repro_knn_plan(d, k, ctypes.byref(rows),
                                  ctypes.byref(streamed))
    if rows.value == 0:
        raise ValueError(f"D={d} with k={k} exceeds the {limit} bytes of "
                         "shared memory a block may take")
    return KnnPlan(rows.value, "streamed" if streamed.value else "resident")


@functools.cache
def _lib():
    lib = _build.library("knn")
    lib.repro_knn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _I, _I, _I, _I, _P]
    lib.repro_knn.restype = _I
    lib.repro_knn_splits.argtypes = [_I, _I, _I, _I, _I, _I]
    lib.repro_knn_splits.restype = _I
    lib.repro_knn_plan.argtypes = [_I, _I, _P, _P]
    lib.repro_knn_plan.restype = ctypes.c_longlong
    return lib


def knn_cuda(q: torch.Tensor, x: torch.Tensor, k: int, metric: str = "l2"):
    """K4: exact kNN of [M, D] f32 queries among [N, D] f32 points ->
    ([M, k] f32 ascending, [M, k] int32), ties by index, (inf, -1) padding.
    While a tracer is enabled, the block shape goes on the caller's open
    span (``block_rows``, ``panel``) and CUDA events around the launches
    record the call (:func:`repro_torch.kernels.knn_launches`)."""
    if q.device.type != "cuda" or x.device != q.device:
        raise ValueError("both operands must be CUDA tensors on one device")
    if q.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"knn takes float32, got {q.dtype} and {x.dtype}")
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"need [M, D] x [N, D], got {tuple(q.shape)} and "
                         f"{tuple(x.shape)}")
    if not (q.is_contiguous() and x.is_contiguous()):
        raise ValueError("operands must be contiguous")
    if not 1 <= k <= KNN_MAX_K:
        raise ValueError(f"knn supports 1 <= k <= {KNN_MAX_K}, got {k}")
    if metric not in ("l2", "ip"):
        raise ValueError(f"unknown metric {metric!r}")
    if x.shape[0] >= 2**31:
        raise ValueError("too many points for int32 ids")
    return _launch(q, x, k, metric, knn_plan(q.shape[1], k))


def _launch(q, x, k, metric, plan: KnnPlan):
    """K4 on checked operands in the given block shape (every shape that
    fits gives the same bits)."""
    m, d = q.shape
    n = x.shape[0]
    streamed = int(plan.panel == "streamed")
    lib = _lib()
    splits = lib.repro_knn_splits(m, n, d, k, plan.rows, streamed)
    if splits == 0:
        raise ValueError(f"{plan} at D={d}, k={k} does not fit a block")
    out_d = torch.empty((m, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((m, k), dtype=torch.int32, device=q.device)
    if m == 0:
        return out_d, out_i
    xn = torch.empty(n if metric == "l2" else 0, dtype=torch.float32,
                     device=q.device)
    parts = (splits, m, k) if splits > 1 else (0,)
    part_d = torch.empty(parts, dtype=torch.float32, device=q.device)
    part_i = torch.empty(parts, dtype=torch.int32, device=q.device)
    stream = torch.cuda.current_stream(q.device)
    tr = current_tracer()
    if tr.enabled:  # the launches' seconds, read once the record is read
        tr.annotate(block_rows=plan.rows, panel=plan.panel)
        ev = tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev[0].record(stream)
    _build.count("knn")
    rc = lib.repro_knn(q.data_ptr(), x.data_ptr(), xn.data_ptr(),
                       part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(),
                       out_i.data_ptr(), m, n, d, k, int(metric == "ip"),
                       plan.rows, streamed, splits, stream.cuda_stream)
    _build.check(rc, "knn")
    if tr.enabled:
        ev[1].record(stream)
        _build.record_knn(m, n, d, k, ev)
    return out_d, out_i
