"""Flash attention (prefill) and flash decode on the card (counterpart of
``repro/kernels/flash_attention.py``): the wrappers of the CUDA kernels in
``csrc/attention.cu`` (K5: GQA attention over a sequence, K6: one query
token per row against a KV cache) and their plain versions.  Callers go
through :mod:`repro_torch.kernels.ops`, which picks the plain version for a
CPU tensor.

Both kernels take f32 or bf16, keep scores, probabilities and sums in f32,
and mask their own ragged edges: no sequence length has to be a multiple
of a tile.  Head dims 16, 32, 64 and 128 are built.  K5 in bf16 runs its
products on the tensor cores (bf16 x bf16 -> f32, exact products) and
multiplies V by P split into a bf16 hi + lo pair, so P keeps 16
significant bits; K5 in f32 and K6 use FP32 FMAs only (no tensor cores, no
TF32).  K6 splits each row's cache over blocks (:func:`decode_plan`, from
the cache's shape, so the lengths stay on the card) and combines the
splits in the same launch through scratch kept for each (device, stream),
which the launch leaves ready for the next one.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import decode_attention as flash_decode_plain
from repro_torch.kernels.ref import mha_attention as flash_attention_plain

__all__ = ["decode_plan", "flash_attention_cuda", "flash_attention_plain",
           "flash_attention_single_p_cuda", "flash_decode_cuda",
           "flash_decode_plain"]

HEAD_DIMS = (16, 32, 64, 128)
_SMEM_LIMIT = 232448  # bytes of shared memory one block may take on Hopper
_SMS = 132  # streaming multiprocessors of an H100 SXM
_TILE = 64  # keys per K6 tile
_CHUNK_BYTES = 65536  # most bytes of K + V one K6 block holds
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.cache
def _lib():
    lib = _build.library("attention")
    lib.repro_flash_attention.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                          _I, _F, _I, _I, _I, _P]
    lib.repro_flash_attention.restype = _I
    lib.repro_flash_decode.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                       _I, _I, _I, _I, _F, _I, _P]
    lib.repro_flash_decode.restype = _I
    lib.repro_flash_decode_smem.argtypes = [_I, _I, _I, _I]
    lib.repro_flash_decode_smem.restype = ctypes.c_size_t
    return lib


@functools.cache
def decode_plan(b: int, hkv: int, t: int, dh: int,
                itemsize: int) -> tuple[int, int]:
    """K6's split of the cache, from its shape alone (never from the
    lengths, which live on the card): ``(chunk, n_split)``, where block
    ``s`` of a (row, KV head) owns keys ``[s * chunk, (s + 1) * chunk)``.
    ``chunk`` is a multiple of the 64-key tile, as small as gives at least
    four blocks per SM when every row is full, and no larger than keeps the
    chunk's K and V within 64 KB of shared memory."""
    tiles = -(-t // _TILE)
    want = -(-4 * _SMS // (b * hkv))
    most = max(1, _CHUNK_BYTES // (2 * _TILE * dh * itemsize))
    chunk = _TILE * min(max(1, -(-tiles // want)), most)
    return chunk, max(1, -(-t // chunk))


@functools.cache
def _decode_fits(group: int, dh: int, chunk: int, bf16: bool) -> bool:
    """Whether K6's block for a GQA group of ``group`` heads at ``dh`` and
    ``chunk`` keys fits one block's shared memory."""
    return _lib().repro_flash_decode_smem(group, dh, chunk,
                                          int(bf16)) <= _SMEM_LIMIT


# K6's scratch for each (device, stream): the splits' partials (grown as
# needed) and one ticket per (row, KV head), zeroed once here and left zero
# by every launch, so a decode step adds no memset.  Launches on one stream
# run in order, so they can share it; another stream gets its own.
_WORKSPACE: dict[tuple[torch.device, int],
                 tuple[torch.Tensor, torch.Tensor]] = {}


def _decode_workspace(dev: torch.device, stream: int, n_part: int,
                      n_tickets: int):
    part, tickets = _WORKSPACE.get((dev, stream), (None, None))
    if part is not None and part.numel() >= n_part and \
            tickets.numel() >= n_tickets:
        return part, tickets
    if torch.cuda.is_current_stream_capturing():
        # memory made now would belong to the graph, and its zeros would
        # be written only when the graph replays
        raise RuntimeError(
            "flash_decode_cuda needs new scratch while a CUDA graph is "
            "being captured: call it once at this size on the capturing "
            "stream before the capture")
    if part is None or part.numel() < n_part:
        part = torch.empty(n_part, dtype=torch.float32, device=dev)
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(n_tickets, dtype=torch.int32, device=dev)
    _WORKSPACE[(dev, stream)] = (part, tickets)
    return part, tickets


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_dims: int) -> tuple[int, int, int]:
    """Validate [B,H,(S,)Dh] q against [B,Hkv,T,Dh] k/v on one card, one
    dtype, contiguous; returns (H, Hkv, Dh)."""
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be CUDA tensors on one device")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != q_dims or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    h, dh = q.shape[1], q.shape[-1]
    hkv = k.shape[1]
    if q.shape[0] != k.shape[0] or k.shape[3] != dh or hkv == 0 or h % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not match k/v "
                         f"{tuple(k.shape)} (H must be a multiple of Hkv)")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {dh} not built (one of {HEAD_DIMS})")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    return h, hkv, dh


def _prefill(q, k, v, causal, scale, split_p: bool) -> torch.Tensor:
    h, hkv, dh = _check(q, k, v, 4)
    b, s, t = q.shape[0], q.shape[2], k.shape[2]
    if b > 65535 or h > 65535:
        raise ValueError("batch or heads too large for one launch")
    scale = scale if scale is not None else dh**-0.5
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.count("flash_attention")
    rc = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, hkv,
        s, t, dh, float(scale), int(causal), int(q.dtype == torch.bfloat16),
        int(split_p), stream)
    _build.check(rc, "flash_attention")
    return out


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         scale: float | None = None) -> torch.Tensor:
    """K5: q [B,H,S,Dh], k/v [B,Hkv,T,Dh] -> [B,H,S,Dh] in q's dtype."""
    return _prefill(q, k, v, causal, scale, True)


def flash_attention_single_p_cuda(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, *, causal: bool = True,
                                  scale: float | None = None) -> torch.Tensor:
    """K5 in bf16 with P rounded once to bf16 (no P_lo product): a timing
    yardstick for the price of the 16-bit P, never called by the port."""
    if q.dtype != torch.bfloat16:
        raise TypeError("the single-P variant exists for bfloat16 only")
    return _prefill(q, k, v, causal, scale, False)


def flash_decode_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                      scale: float | None = None) -> torch.Tensor:
    """K6: q [B,H,Dh] against k/v cache [B,Hkv,T,Dh] with the first
    ``cache_len[b]`` positions valid (clamped to [0, T]) -> [B,H,Dh]."""
    h, hkv, dh = _check(q, k_cache, v_cache, 3)
    b, t = q.shape[0], k_cache.shape[2]
    lens = torch.as_tensor(cache_len, device=q.device).to(torch.int32)
    if lens.shape != (b,):
        raise ValueError(f"cache_len must be [{b}], got {tuple(lens.shape)}")
    lens = lens.contiguous()
    if b > 65535 or hkv > 65535:
        raise ValueError("batch or KV heads too large for one launch")
    scale = scale if scale is not None else dh**-0.5
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _lib()
    bf16 = q.dtype == torch.bfloat16
    group = h // hkv
    chunk, n_split = decode_plan(b, hkv, t, dh, q.element_size())
    if not _decode_fits(group, dh, chunk, bf16):
        raise ValueError(f"a GQA group of {group} heads at head_dim {dh} "
                         "exceeds the block's shared memory")
    # floats of one split's partial (acc, m, l), padded to 16 bytes
    stride = -(-group * (dh + 2) // 4) * 4
    stream = torch.cuda.current_stream(q.device).cuda_stream
    part, tickets = _decode_workspace(q.device, stream,
                                      b * hkv * n_split * stride, b * hkv)
    _build.count("flash_decode")
    rc = lib.repro_flash_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(),
        out.data_ptr(), part.data_ptr(), tickets.data_ptr(), b, h, hkv, t, dh,
        chunk, n_split, float(scale), int(bf16), stream)
    _build.check(rc, "flash_decode")
    return out
