"""The shard-graph merge on the card: the wrapper of the CUDA kernel in
``csrc/merge.cu`` and its plain version.  It has no TPU counterpart: the
reference merges on the host (``repro/core/merge.py``).
:func:`repro_torch.core.merge.merge_shard_indexes` builds its inputs.

One block builds one global id's merged row from its shard rows: the
candidates in first-seen order (shard, then slot), the first occurrence of
each id, squared L2 to the id's own point in FP32, ranked by (distance,
first-seen position), the first ``degree`` kept.  The wrapper reads the
largest candidate count of any row from ``row_ptr`` (one small read-back)
and sizes the block's shared memory from it."""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import merge_rows_plain

__all__ = ["merge_rows", "merge_rows_cuda", "merge_rows_plain"]

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib():
    lib = _build.library("merge")
    lib.repro_merge_rows.argtypes = [_P, _I, _P, _I, _P, _P, _I, _I, _I, _I,
                                     _P, _P, _P]
    lib.repro_merge_rows.restype = _I
    lib.repro_merge_rows_cap.argtypes = [_I]
    lib.repro_merge_rows_cap.restype = _I
    return lib


def merge_rows(x, nbr, row_ptr, row_of, degree: int):
    """Merged rows (graph [N, degree] int32, unique candidates a row [N]
    int32) from ``nbr`` [S, W] int32 shard rows in global ids (-1 pads), the
    CSR table ``row_ptr`` [N + 1] / ``row_of`` (int32: id ``g``'s rows of
    ``nbr`` in shard order) and ``x`` [N, D] f32 points or None (rank by
    first-seen position alone).  CPU tensors take
    :func:`merge_rows_plain`; CUDA tensors launch the kernel."""
    if nbr.device.type == "cpu":
        return merge_rows_plain(x, nbr, row_ptr, row_of, degree)
    return merge_rows_cuda(x, nbr, row_ptr, row_of, degree)


def merge_rows_cuda(x, nbr, row_ptr, row_of, degree: int):
    """The merge kernel; same contract as :func:`merge_rows`.  Raises where
    a row's candidates (entries x W) exceed one block's shared memory
    (25,656 at D = 128; ``repro_merge_rows_cap``)."""
    dev = nbr.device
    ops = [t for t in (x, nbr, row_ptr, row_of) if t is not None]
    if dev.type != "cuda" or any(t.device != dev for t in ops):
        raise ValueError("every operand must be a CUDA tensor on one device")
    if any(t.dtype != torch.int32 for t in (nbr, row_ptr, row_of)):
        raise TypeError("nbr, row_ptr and row_of must be int32")
    if nbr.dim() != 2 or row_ptr.dim() != 1 or row_of.dim() != 1:
        raise ValueError(f"need nbr [S, W], row_ptr [N + 1], row_of [S]; got "
                         f"{tuple(nbr.shape)}, {tuple(row_ptr.shape)}, "
                         f"{tuple(row_of.shape)}")
    n = row_ptr.shape[0] - 1
    if x is not None:
        if x.dtype != torch.float32 or x.dim() != 2 or x.shape[0] < n:
            raise ValueError(f"x must be [>= {n}, D] float32, got "
                             f"{tuple(x.shape)} {x.dtype}")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("operands must be contiguous")
    if degree < 1:
        raise ValueError(f"degree must be >= 1, got {degree}")
    w = nbr.shape[1]
    d = 0 if x is None else x.shape[1]
    graph = torch.empty((n, degree), dtype=torch.int32, device=dev)
    n_unique = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return graph, n_unique
    cap = int((row_ptr[1:] - row_ptr[:-1]).max()) * w
    lib = _lib()
    most = lib.repro_merge_rows_cap(d)
    if cap > most:
        raise ValueError(f"a row of {cap} candidates ({cap // w} shard rows "
                         f"of width {w}) exceeds the block's shared memory: "
                         f"at D={d} at most {most} fit")
    vec = x is not None and d % 4 == 0 and x.data_ptr() % 16 == 0
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.count("merge_rows")
    rc = lib.repro_merge_rows(None if x is None else x.data_ptr(), d,
                              nbr.data_ptr(), w, row_ptr.data_ptr(),
                              row_of.data_ptr(), n, degree, cap, int(vec),
                              graph.data_ptr(), n_unique.data_ptr(), stream)
    _build.check(rc, "merge_rows")
    return graph, n_unique
