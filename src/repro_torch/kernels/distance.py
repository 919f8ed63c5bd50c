"""Pairwise distance tiles on the card (counterpart of
``repro/kernels/distance.py``): the wrappers of the CUDA kernels in
``csrc/distance.cu`` (K1: f32/bf16, K2: uint8 codes) and their plain
versions.  Callers go through :mod:`repro_torch.kernels.ops`, which picks
the plain version for a CPU tensor."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import pairwise_distance as pairwise_distance_plain
from repro_torch.kernels.ref import \
    pairwise_distance_u8 as pairwise_distance_u8_plain

__all__ = ["pairwise_distance_cuda", "pairwise_distance_plain",
           "pairwise_distance_u8_cuda", "pairwise_distance_u8_plain"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_MAX_ROWS = 65535 * 64  # grid.y limit of the 64-row tiles


def _lib():
    lib = _build.library("distance")
    lib.repro_pairwise_distance.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _P]
    lib.repro_pairwise_distance.restype = _I
    lib.repro_pairwise_distance_u8.argtypes = [_P, _P, _P, _I, _I, _I, _I,
                                               _F, _F, _I, _P]
    lib.repro_pairwise_distance_u8.restype = _I
    return lib


def _check_pair(q: torch.Tensor, x: torch.Tensor, dtypes) -> None:
    if q.device.type != "cuda" or x.device != q.device:
        raise ValueError("both operands must be CUDA tensors on one device")
    if q.dtype not in dtypes or x.dtype != q.dtype:
        raise TypeError(f"operands must share one dtype of {dtypes}, "
                        f"got {q.dtype} and {x.dtype}")
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"need [M, D] x [N, D], got {tuple(q.shape)} and "
                         f"{tuple(x.shape)}")
    if not (q.is_contiguous() and x.is_contiguous()):
        raise ValueError("operands must be contiguous")
    if q.shape[0] > _MAX_ROWS or q.shape[0] * x.shape[0] >= 2**40:
        raise ValueError("tile too large for one launch")


def _metric_ip(metric: str) -> int:
    if metric not in ("l2", "ip"):
        raise ValueError(f"unknown metric {metric!r}")
    return int(metric == "ip")


def pairwise_distance_cuda(q: torch.Tensor, x: torch.Tensor,
                           metric: str = "l2") -> torch.Tensor:
    """K1: [M, D] x [N, D] f32 or bf16 -> [M, N] f32 on the card."""
    _check_pair(q, x, (torch.float32, torch.bfloat16))
    ip = _metric_ip(metric)
    m, d = q.shape
    n = x.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=q.device)
    if m == 0 or n == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.count("pairwise_distance")
    rc = lib.repro_pairwise_distance(
        q.data_ptr(), x.data_ptr(), out.data_ptr(), m, n, d,
        int(q.dtype == torch.bfloat16), ip, stream)
    _build.check(rc, "pairwise_distance")
    return out


def pairwise_distance_u8_cuda(cq: torch.Tensor, cx: torch.Tensor, scale: float,
                              zero_point: float, metric: str = "l2",
                              d_real: int | None = None) -> torch.Tensor:
    """K2: [M, D] x [N, D] uint8 codes -> [M, N] f32 on the card."""
    _check_pair(cq, cx, (torch.uint8,))
    ip = _metric_ip(metric)
    m, d = cq.shape
    n = cx.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=cq.device)
    if m == 0 or n == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(cq.device).cuda_stream
    _build.count("pairwise_distance_u8")
    rc = lib.repro_pairwise_distance_u8(
        cq.data_ptr(), cx.data_ptr(), out.data_ptr(), m, n, d,
        d if d_real is None else int(d_real), float(scale), float(zero_point),
        ip, stream)
    _build.check(rc, "pairwise_distance_u8")
    return out
