"""Exact kNN on the card (counterpart of ``repro/kernels/topk.py``): the
wrapper of the CUDA kernel in ``csrc/knn.cu`` (K4) and its plain version.
Callers go through :func:`repro_torch.kernels.ops.knn`."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import knn as knn_plain

__all__ = ["KNN_MAX_K", "knn_cuda", "knn_plain"]

KNN_MAX_K = 256
_SMEM_LIMIT = 232448  # bytes of shared memory one block may take on Hopper
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = _build.library("knn")
    lib.repro_knn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    lib.repro_knn.restype = _I
    lib.repro_knn_smem.argtypes = [_I, _I]
    lib.repro_knn_smem.restype = ctypes.c_size_t
    return lib


def knn_cuda(q: torch.Tensor, x: torch.Tensor, k: int, metric: str = "l2"):
    """K4: exact kNN of [M, D] f32 queries among [N, D] f32 points ->
    ([M, k] f32 ascending, [M, k] int32), ties by index, (inf, -1) padding."""
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
    m, d = q.shape
    n = x.shape[0]
    if n >= 2**31:
        raise ValueError("too many points for int32 ids")
    lib = _lib()
    if lib.repro_knn_smem(d, k) > _SMEM_LIMIT:
        raise ValueError(f"D={d} with k={k} exceeds the block's shared memory")
    out_d = torch.empty((m, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((m, k), dtype=torch.int32, device=q.device)
    if m == 0:
        return out_d, out_i
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.count("knn")
    rc = lib.repro_knn(q.data_ptr(), x.data_ptr(), out_d.data_ptr(),
                       out_i.data_ptr(), m, n, d, k, int(metric == "ip"),
                       stream)
    _build.check(rc, "knn")
    return out_d, out_i
