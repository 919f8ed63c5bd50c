"""Fused beam-search engine (counterpart of ``repro/kernels/beam.py``).

:func:`fused_beam` runs the whole batched graph traversal, and optionally
the exact-f32 re-rank, in one dispatch.  On a CUDA tensor it launches the
hand-written kernel in ``csrc/beam.cu`` (K3): one block per query, the
candidate list and an exact visited hash in shared memory, rows gathered
straight from device memory.  On a CPU tensor it runs
:func:`fused_beam_plain`, a PyTorch port of the reference's flat-batch
lowering ``_fused_beam_xla`` (``beam.py:90-294``, without its precomputed
dot tile), which the card also holds the kernel against.

Semantics (shared by both): seed with E <= width entries; each trip expand
the ``expand`` best unexpanded candidates by (distance, position); drop -1
neighbours and visited ids; duplicates within a wavefront resolve to their
last occurrence; keep the best ``width`` of candidates + fresh neighbours by
(distance, position); halt when nothing is live or ``hops >= n_iters``.
"""

from __future__ import annotations

import ctypes
import functools
import threading
import weakref

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import lane_sum, topk_smallest

__all__ = ["DEFAULT_EXPAND", "beam_aux", "default_n_iters", "fused_beam",
           "fused_beam_cuda", "fused_beam_occupancy", "fused_beam_plain"]

DEFAULT_EXPAND = 8
_I32_MAX = 2**31 - 1
# dynamic shared memory one block may take on Hopper (232448 bytes), less
# the kernel's static shared variables
_SMEM_LIMIT = 232448 - 1024
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def default_n_iters(width: int) -> int:
    """Total node-expansion budget matched to the candidate-list size."""
    return width + width // 2


def _lexsort2(primary: torch.Tensor, secondary: torch.Tensor) -> torch.Tensor:
    """Row-wise order by (primary, secondary, position)."""
    o1 = torch.sort(secondary, dim=1, stable=True).indices
    o2 = torch.sort(primary.gather(1, o1), dim=1, stable=True).indices
    return o1.gather(1, o2)


def _rerank(out_ids, x_exact, q_exact, rerank_k: int, metric: str):
    """Exact-f32 re-score of the candidates in K3's summation order
    (:func:`~repro_torch.kernels.ref.lane_sum`), sorted by (distance, id)."""
    n = x_exact.shape[0]
    valid = out_ids >= 0
    rows = x_exact[out_ids.long().clamp(0, n - 1)]  # [Q, k, Dx]
    if metric == "ip":
        dex = -lane_sum(rows * q_exact[:, None, :])
    else:
        diff = rows - q_exact[:, None, :]
        dex = lane_sum(diff * diff)
    ids_key = torch.where(valid, out_ids.long(), _I32_MAX)
    d_key = torch.where(valid, dex, torch.inf)
    order = _lexsort2(d_key, ids_key)[:, :rerank_k]
    r_ids = ids_key.gather(1, order)
    r_d = d_key.gather(1, order)
    r_ids = torch.where(r_ids == _I32_MAX, -1, r_ids)
    return r_ids.int(), r_d, valid.sum(dim=1).int()


def fused_beam_plain(x, graph, entries, queries, k: int, *, width: int,
                     n_iters: int, expand: int, metric: str, scale: float,
                     zp: float, x_exact=None, q_exact=None,
                     rerank_k: int | None = None):
    """PyTorch port of ``_fused_beam_xla``; same contract as
    :func:`fused_beam`."""
    n, d_real = x.shape
    r = graph.shape[1]
    nq = queries.shape[0]
    ne = entries.shape[0]
    n_new = expand * r
    dev = x.device
    sentinel = n
    graph = graph.long()
    entries = entries.long()
    rows_q = torch.arange(nq, device=dev)
    if x.dtype == torch.uint8:
        qi = queries.long()
        xi = x.long()
        xi_n = (xi * xi).sum(dim=1)
        xi_s = xi.sum(dim=1)
        cqn = (qi * qi).sum(dim=1, keepdim=True)
        cqs = qi.sum(dim=1, keepdim=True)
        s = torch.tensor(scale, dtype=torch.float32, device=dev)
        z = torch.tensor(zp, dtype=torch.float32, device=dev)

        def score(ids2d):
            safe = ids2d.clamp(0, n - 1)
            dots = torch.bmm(x[safe].double(), qi.double()[:, :, None])
            dots = dots[..., 0].round().long()  # exact integers
            if metric == "ip":
                return -(s * s * dots.float()
                         + s * z * (cqs + xi_s[safe]).float()
                         + d_real * z * z)
            d_codes = (xi_n[safe] + cqn - 2 * dots).float()
            return d_codes.clamp_min(0.0) * (s * s)
    else:
        qf = queries.float()
        xf = x.float()
        xn = (xf * xf).sum(dim=1)

        def score(ids2d):
            safe = ids2d.clamp(0, n - 1)
            dots = torch.bmm(xf[safe], qf[:, :, None])[..., 0]
            if metric == "ip":
                return -dots
            return xn[safe] - 2.0 * dots

    pad = width - ne
    seed_ids = entries[None, :].expand(nq, ne)
    ids = torch.cat([seed_ids, seed_ids.new_full((nq, pad), sentinel)], 1)
    ds = torch.cat([score(seed_ids),
                    torch.full((nq, pad), torch.inf, device=dev)], 1)
    exp = torch.cat([torch.zeros((nq, ne), dtype=torch.bool, device=dev),
                     torch.ones((nq, pad), dtype=torch.bool, device=dev)], 1)
    visited = torch.zeros((nq, n + 1), dtype=torch.bool, device=dev)
    visited[:, entries] = True
    n_dist = torch.full((nq,), ne, dtype=torch.long, device=dev)
    hops = torch.zeros((nq,), dtype=torch.long, device=dev)
    done = torch.zeros((nq,), dtype=torch.bool, device=dev)
    while bool(((~done) & (hops < n_iters)).any()):
        masked = torch.where(exp, torch.inf, ds)
        sel_v, sel = topk_smallest(masked, expand)
        live = torch.isfinite(sel_v)
        converged = ~live[:, 0]
        halt = done | converged | (hops >= n_iters)
        live = live & ~halt[:, None]
        exp_u = torch.where(halt[:, None], exp, exp.scatter(1, sel, True))
        v = ids.gather(1, sel)
        nbrs = graph[v.clamp(0, n - 1)].reshape(nq, n_new)
        valid = live.repeat_interleave(r, dim=1) & (nbrs >= 0)
        safe = torch.where(valid, nbrs, sentinel)
        cand = valid & ~visited.gather(1, safe)
        # duplicates within a wavefront: only the last occurrence is fresh
        key = torch.where(cand, nbrs, -1)
        order = torch.sort(key, dim=1, stable=True).indices
        skey = key.gather(1, order)
        last = torch.ones_like(cand)
        last[:, :-1] = skey[:, 1:] != skey[:, :-1]
        is_last = torch.zeros_like(cand).scatter(1, order, last)
        fresh = cand & is_last
        visited[rows_q[:, None].expand(nq, n_new)[fresh], nbrs[fresh]] = True
        nd = torch.where(fresh, score(torch.where(fresh, nbrs, 0)), torch.inf)
        all_ids = torch.cat([ids, torch.where(fresh, nbrs, sentinel)], 1)
        all_d = torch.cat([ds, nd], 1)
        all_exp = torch.cat([exp_u, torch.zeros_like(fresh)], 1)
        keep_v, keep = topk_smallest(all_d, width)
        new_ids = torch.where(torch.isfinite(keep_v), all_ids.gather(1, keep),
                              sentinel)
        h = halt[:, None]
        ids = torch.where(h, ids, new_ids)
        ds = torch.where(h, ds, keep_v)
        exp = torch.where(h, exp, all_exp.gather(1, keep))
        n_dist = n_dist + torch.where(halt, 0, fresh.sum(dim=1))
        hops = hops + torch.where(halt, 0, live.sum(dim=1))
        done = done | converged
    top_v, top = topk_smallest(ds, k)
    top_ids = ids.gather(1, top)
    out_ids = torch.where(torch.isfinite(top_v) & (top_ids != sentinel),
                          top_ids, -1).int()
    out_d = top_v
    if metric != "ip" and x.dtype != torch.uint8:
        qf = queries.float()
        out_d = out_d + (qf * qf).sum(dim=1, keepdim=True)
    n_dist, hops = n_dist.int(), hops.int()
    if rerank_k is None:
        return out_ids, out_d, n_dist, hops, torch.zeros_like(n_dist)
    r_ids, r_d, n_rerank = _rerank(out_ids, x_exact.float(), q_exact.float(),
                                   rerank_k, metric)
    return r_ids, r_d, n_dist, hops, n_rerank


def beam_aux(x: torch.Tensor):
    """Per-row constants the kernel reads: ``(|x|^2 f32, code norms int32,
    code sums int32)`` — the first for f32/bf16 storage, the other two for
    uint8 codes; the unused ones are empty."""
    empty_f = torch.empty(0, dtype=torch.float32, device=x.device)
    empty_i = torch.empty(0, dtype=torch.int32, device=x.device)
    if x.dtype == torch.uint8:
        xi = x.int()
        return (empty_f, (xi * xi).sum(dim=1, dtype=torch.int32),
                xi.sum(dim=1, dtype=torch.int32))
    xf = x.float()
    return (xf * xf).sum(dim=1), empty_i, empty_i


@functools.cache
def _lib():
    lib = _build.library("beam")
    lib.repro_fused_beam.argtypes = (
        [_P] * 14 + [_I] * 13 + [_F, _F] + [_I] * 3 + [_P])
    lib.repro_fused_beam.restype = _I
    lib.repro_beam_smem.argtypes = [_I] * 6
    lib.repro_beam_smem.restype = ctypes.c_size_t
    lib.repro_beam_occupancy.argtypes = [_I, _I, _I, _I, ctypes.c_size_t]
    lib.repro_beam_occupancy.restype = _I
    return lib


def _layout(d: int, width: int, r: int, ne: int, n_iters: int,
            expand: int) -> tuple[int, int, int, int]:
    """(hash_log2, wave_log2, slots, shared-memory bytes) of one block."""
    nn_ = expand * r
    # The visited hash is exact as long as it never fills: a query inserts
    # at most E + (n_iters + expand) * R ids, so the power of two above
    # that always keeps an empty slot (8192 slots for 6720 ids at width 64,
    # R 64, expand 8: four queries resident per SM).
    hash_log2 = max(1, (ne + (n_iters + expand) * r).bit_length())
    wave_log2 = max(1, (2 * nn_ - 1).bit_length())
    slots = max(nn_, width)  # a trip's survivors, or the re-rank keys
    smem = _lib().repro_beam_smem(d, width, nn_, slots, hash_log2,
                                  wave_log2)
    return hash_log2, wave_log2, slots, smem


def fused_beam_occupancy(x: torch.Tensor, r: int, ne: int, *, nq: int,
                         width: int, n_iters: int, expand: int,
                         metric: str) -> dict:
    """K3's shared memory per block and the resident blocks (queries) per
    SM of the kernel a launch of ``nq`` queries takes, from
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``."""
    stage = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}[x.dtype]
    d = x.shape[1]
    *_, smem = _layout(d, width, r, ne, n_iters, expand)
    vec = (d * x.element_size()) % 16 == 0 and x.data_ptr() % 16 == 0
    blocks = _lib().repro_beam_occupancy(stage, int(metric == "ip"),
                                         int(vec), nq, smem)
    _build.check(min(blocks, 0), "fused_beam occupancy")
    return {"smem_bytes": int(smem), "blocks_per_sm": int(blocks)}


# tensors whose ids were found in range: id -> (weak ref, version, lo, n).
# Threads launch K3 at once (the fleet's workers, a server beside a live
# index's writer), so the table changes under a lock; an RLock, because a
# tensor collected while the lock is held runs its callback in that thread
_CHECKED: dict[int, tuple] = {}
_CHECKED_LOCK = threading.RLock()


def _forget(key: int, ref: weakref.ref) -> None:
    with _CHECKED_LOCK:
        if _CHECKED.get(key, (None,))[0] is ref:
            del _CHECKED[key]


def _ids_in_range(t: torch.Tensor, lo: int, n: int) -> bool:
    """Whether every id of ``t`` lies in [lo, n).  A check reads the whole
    tensor and waits for the card, so a tensor found in range is not read
    again until it changes in place (its version moves).  The version is
    taken before the read: a write that lands during it moves the version
    past the cached one, so the next call checks again."""
    key = id(t)
    version = t._version
    with _CHECKED_LOCK:
        hit = _CHECKED.get(key)
    if hit is not None and hit[0]() is t and hit[1:] == (version, lo, n):
        return True
    if t.numel() and (int(t.min()) < lo or int(t.max()) >= n):
        return False
    ref = weakref.ref(t, functools.partial(_forget, key))
    with _CHECKED_LOCK:
        _CHECKED[key] = (ref, version, lo, n)
    return True


def _contig(t: torch.Tensor, dtype, dev, name: str) -> None:
    if t.device != dev or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor on {dev}")


def fused_beam_cuda(x, graph, entries, queries, k: int, *, width: int,
                    n_iters: int, expand: int, metric: str, scale: float,
                    zp: float, x_exact=None, q_exact=None,
                    rerank_k: int | None = None, aux=None):
    """K3 on the card; same contract as :func:`fused_beam`.  ``aux`` is
    :func:`beam_aux` of ``x``, computed here when not given."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError("fused_beam_cuda needs CUDA tensors")
    stage = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}.get(x.dtype)
    if stage is None or x.dim() != 2 or not x.is_contiguous():
        raise TypeError(f"x must be a contiguous [N, D] f32/bf16/uint8 "
                        f"tensor, got {x.dtype} {tuple(x.shape)}")
    n, d = x.shape
    _contig(graph, torch.int32, dev, "graph")
    _contig(entries, torch.int32, dev, "entries")
    _contig(queries, x.dtype, dev, "queries")
    if graph.dim() != 2 or graph.shape[0] != n or queries.dim() != 2 \
            or queries.shape[1] != d or entries.dim() != 1:
        raise ValueError("shape mismatch between x, graph, entries, queries")
    r = graph.shape[1]
    ne = entries.shape[0]
    nq = queries.shape[0]
    if metric not in ("l2", "ip"):
        raise ValueError(f"unknown metric {metric!r}")
    if not (1 <= ne <= width and 1 <= k <= width and 1 <= expand <= 32):
        raise ValueError(f"need 1 <= E, k <= width and expand <= 32; got "
                         f"E={ne}, k={k}, width={width}, expand={expand}")
    if n == 0 or n >= 2**31 - 1:
        raise ValueError(f"unsupported point count {n}")
    if not (_ids_in_range(graph, -1, n) and _ids_in_range(entries, 0, n)):
        raise ValueError("graph or entry ids out of range")
    lib = _lib()
    hash_log2, wave_log2, slots, smem = _layout(d, width, r, ne, n_iters,
                                                   expand)
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"the exact visited set needs {smem} bytes of shared memory "
            f"(width={width}, R={r}, n_iters={n_iters}), over {_SMEM_LIMIT}")
    if aux is None:
        aux = beam_aux(x)
    xnorm, xcnorm, xcsum = aux
    k_out = rerank_k if rerank_k is not None else k
    if rerank_k is not None:
        if x_exact is None or q_exact is None:
            raise ValueError("rerank_k requires x_exact and q_exact")
        _contig(x_exact, torch.float32, dev, "x_exact")
        _contig(q_exact, torch.float32, dev, "q_exact")
        if x_exact.shape[0] != n or q_exact.shape != (nq, x_exact.shape[1]) \
                or not 1 <= rerank_k <= k:
            raise ValueError("re-rank operands do not match the index")
        dx, xe, qe = x_exact.shape[1], x_exact.data_ptr(), q_exact.data_ptr()
    else:
        dx, xe, qe = 0, None, None
    out_ids = torch.empty((nq, k_out), dtype=torch.int32, device=dev)
    out_d = torch.empty((nq, k_out), dtype=torch.float32, device=dev)
    counters = torch.empty((3, nq), dtype=torch.int32, device=dev)
    if nq == 0:
        return out_ids, out_d, counters[0], counters[1], counters[2]
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.count("fused_beam")
    rc = lib.repro_fused_beam(
        x.data_ptr(), graph.data_ptr(), entries.data_ptr(), queries.data_ptr(),
        xnorm.data_ptr(), xcnorm.data_ptr(), xcsum.data_ptr(), xe, qe,
        out_ids.data_ptr(), out_d.data_ptr(), counters[0].data_ptr(),
        counters[1].data_ptr(), counters[2].data_ptr(),
        n, d, r, ne, nq, width, k, 0 if rerank_k is None else rerank_k,
        n_iters, expand, dx, int(metric == "ip"), stage,
        float(scale), float(zp), hash_log2, wave_log2, slots, stream)
    _build.check(rc, "fused_beam")
    return out_ids, out_d, counters[0], counters[1], counters[2]


def fused_beam(x, graph, entries, queries, k: int, *, width: int = 64,
               n_iters: int | None = None, expand: int = DEFAULT_EXPAND,
               metric: str = "l2", scale: float = 0.0, zp: float = 0.0,
               x_exact=None, q_exact=None, rerank_k: int | None = None,
               aux=None):
    """The fused traversal (+ re-rank) op: one dispatch per batch.

    ``x`` [N, D] f32 / bf16 / uint8 codes, ``graph`` [N, R] int32,
    ``entries`` [E] int32 (E <= width), ``queries`` [Q, D] in x's dtype
    (uint8 codes for the uint8 stage).  Returns ``(ids [Q, k_out] int32
    with -1 padding, dists [Q, k_out] f32, n_dist [Q], hops [Q],
    n_rerank [Q])`` with ``k_out = rerank_k or k``.
    """
    if n_iters is None:
        n_iters = default_n_iters(width)
    if rerank_k is not None and (x_exact is None or q_exact is None):
        raise ValueError("rerank_k requires x_exact and q_exact")
    kw = dict(width=width, n_iters=n_iters, expand=expand, metric=metric,
              scale=scale, zp=zp, x_exact=x_exact, q_exact=q_exact,
              rerank_k=rerank_k)
    if x.device.type == "cuda":
        return fused_beam_cuda(x, graph, entries, queries, k, aux=aux, **kw)
    return fused_beam_plain(x, graph, entries, queries, k, **kw)
