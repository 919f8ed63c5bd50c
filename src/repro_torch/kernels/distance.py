"""Pairwise distance tiles on the card (counterpart of
``repro/kernels/distance.py``): the wrappers of the CUDA kernels in
``csrc/distance.cu`` (K1: f32/bf16, K2: uint8 codes) and their plain
versions.  Callers go through :mod:`repro_torch.kernels.ops`, which picks
the plain version for a CPU tensor.

Each call takes one of two kernels, by :func:`distance_plan`: the skinny
kernel, which keeps N <= 16 centroid rows in shared memory and streams
the M rows through in 16-byte loads (every call of the main path is
[M, 128] x [16, 128]), or the tiled kernel for larger N.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import pairwise_distance as pairwise_distance_plain
from repro_torch.kernels.ref import \
    pairwise_distance_u8 as pairwise_distance_u8_plain

__all__ = ["DistancePlan", "distance_plan", "launch_noop", "plan_for",
           "pairwise_distance_cuda", "pairwise_distance_plain",
           "pairwise_distance_u8_cuda", "pairwise_distance_u8_plain"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_MAX_ROWS = 65535 * 64  # grid.y limit of the tiled kernel's 64-row tiles
_SKINNY_MAX_N = 16  # the most centroids any IndexConfig has
_SKINNY_SMEM = 48 * 1024  # bytes of shared memory the centroids may take


class DistancePlan(NamedTuple):
    kernel: str  # "skinny" or "tiled"
    vec: int     # elements a 16-byte load carries; 1: element loads


def distance_plan(m: int, n: int, d: int, dtype: torch.dtype,
                  aligned: bool) -> DistancePlan:
    """Which kernel an [m, d] x [n, d] call of ``dtype`` takes.

    Skinny when n <= 16 and the 16 centroid rows it keeps (as f32, or as
    codes for uint8; zero-padded to whole 16-byte chunks of the input) fit
    48 KB of shared memory; with 16-byte loads when a row is a whole number
    of 16-byte chunks and both operands start 16-byte aligned, else element
    loads.  Otherwise the tiled kernel, whose grid takes at most 65535
    tiles of 64 rows."""
    size = dtype.itemsize
    per_chunk = 16 // size
    chunks = -(-d // per_chunk)
    if dtype == torch.uint8:  # codes, code norms and code sums
        smem = _SKINNY_MAX_N * (chunks * 16 + 8)
    else:  # f32 rows and norms
        smem = _SKINNY_MAX_N * (chunks * per_chunk * 4 + 4)
    if n <= _SKINNY_MAX_N and smem <= _SKINNY_SMEM:
        vec = per_chunk if aligned and (d * size) % 16 == 0 else 1
        return DistancePlan("skinny", vec)
    if m > _MAX_ROWS:
        raise ValueError(f"{m} rows against {n} is too large for one launch")
    return DistancePlan("tiled", 1)


@functools.cache
def _lib():
    lib = _build.library("distance")
    lib.repro_pairwise_distance.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _P]
    lib.repro_pairwise_distance_u8.argtypes = [_P, _P, _P, _I, _I, _I, _I,
                                               _F, _F, _I, _P]
    lib.repro_distance_skinny.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I,
                                          _P]
    lib.repro_distance_u8_skinny.argtypes = [_P, _P, _P, _I, _I, _I, _I, _F,
                                             _F, _I, _I, _P]
    lib.repro_noop.argtypes = [_P]
    for fn in (lib.repro_pairwise_distance, lib.repro_pairwise_distance_u8,
               lib.repro_distance_skinny, lib.repro_distance_u8_skinny,
               lib.repro_noop):
        fn.restype = _I
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
    if q.shape[0] >= 2**31 or q.shape[0] * x.shape[0] >= 2**40:
        raise ValueError("tile too large for one launch")


def _metric_ip(metric: str) -> int:
    if metric not in ("l2", "ip"):
        raise ValueError(f"unknown metric {metric!r}")
    return int(metric == "ip")


def plan_for(q: torch.Tensor, x: torch.Tensor) -> DistancePlan:
    """:func:`distance_plan` of a call on these operands."""
    aligned = q.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0
    return distance_plan(q.shape[0], x.shape[0], q.shape[1], q.dtype, aligned)


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
    plan = plan_for(q, x)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    bf16 = int(q.dtype == torch.bfloat16)
    _build.count("pairwise_distance")
    if plan.kernel == "skinny":
        rc = lib.repro_distance_skinny(
            q.data_ptr(), x.data_ptr(), out.data_ptr(), m, n, d, bf16, ip,
            int(plan.vec > 1), stream)
    else:
        rc = lib.repro_pairwise_distance(
            q.data_ptr(), x.data_ptr(), out.data_ptr(), m, n, d, bf16, ip,
            stream)
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
    plan = plan_for(cq, cx)
    lib = _lib()
    stream = torch.cuda.current_stream(cq.device).cuda_stream
    d_real = d if d_real is None else int(d_real)
    _build.count("pairwise_distance_u8")
    if plan.kernel == "skinny":
        rc = lib.repro_distance_u8_skinny(
            cq.data_ptr(), cx.data_ptr(), out.data_ptr(), m, n, d, d_real,
            float(scale), float(zero_point), ip, int(plan.vec > 1), stream)
    else:
        rc = lib.repro_pairwise_distance_u8(
            cq.data_ptr(), cx.data_ptr(), out.data_ptr(), m, n, d, d_real,
            float(scale), float(zero_point), ip, stream)
    _build.check(rc, "pairwise_distance_u8")
    return out


def launch_noop() -> None:
    """Launch an empty kernel on the current stream, counted nowhere: the
    launch floor that a kernel timed from a CUDA graph is read against."""
    _build.check(_lib().repro_noop(torch.cuda.current_stream().cuda_stream),
                 "noop")
