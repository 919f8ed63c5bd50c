"""ANN-retrieval attention for long-context decode (counterpart of
``repro/serve/retrieval_attention.py``; a beyond-paper feature).

Long-context decode spends its time scoring a query against a long KV
cache, but the softmax is dominated by a few high-inner-product keys: a
top-k ANN query (RetrievalAttention, the paper's ref. [7]).  A ScaleGANN
graph index is built over each (batch row, KV head)'s cached keys with
the inner-product metric (:func:`repro_torch.core.build_scalegann`: K1 in
k-means and the partition, K4 for each shard's CAGRA kNN graph on the
card), and each decode step queries it through :func:`repro_torch.search.
search` (``fused``, the default: K3 at one query; ``torch``; ``numpy``,
the host reference, the reference package's default) instead of scoring
every key:

    full attention:   O(T·dh) per head per token
    retrieval:        O(width·R·dh) graph search + O((top_t+window)·dh) softmax

Exactness: the softmax runs over the union of {retrieved top_t} ∪ {last
``window`` keys} ∪ {attention sinks: the first ``n_sink`` keys}; with
top_t → T it is exact, and at top_t ≪ T the error tracks the softmax mass
of the dropped tail.  The selection and the softmax over a few hundred
keys a head stay in numpy on the host, as in the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import IndexConfig
from repro_torch.core.builder import build_scalegann
from repro_torch.core.merge import GlobalIndex
from repro_torch.device import resolve_device
from repro_torch.search import MergedTopology, search


@dataclasses.dataclass
class KeyIndex:
    """Per-(batch, kv-head) graph index over cached keys."""

    keys: np.ndarray  # [T, dh] f32
    values: np.ndarray  # [T, dh] f32
    index: GlobalIndex

    def topology(self) -> MergedTopology:
        return MergedTopology(data=self.keys, index=self.index, metric="ip")


def build_key_indexes(
    k_cache: np.ndarray,  # [B, Hkv, T, dh]
    v_cache: np.ndarray,
    *,
    cfg: IndexConfig | None = None,
    device=None,
) -> list[list[KeyIndex]]:
    """One ScaleGANN index per (batch, kv-head), built on ``device`` (the
    card unless ``"cpu"`` is given) on the builder's two workers."""
    b, hkv, t, dh = k_cache.shape
    cfg = cfg or IndexConfig(
        n_clusters=max(2, min(8, t // 512)), degree=16, build_degree=32,
        block_size=max(256, t // 4), metric="ip",
    )
    dev = resolve_device(device)
    out = []
    for bi in range(b):
        row = []
        for h in range(hkv):
            keys = np.asarray(k_cache[bi, h], np.float32)
            res = build_scalegann(keys, cfg, n_workers=2, device=dev)
            row.append(
                KeyIndex(keys=keys,
                         values=np.asarray(v_cache[bi, h], np.float32),
                         index=res.index)
            )
        out.append(row)
    return out


def retrieval_decode_attention(
    q: np.ndarray,  # [B, H, dh]
    indexes: list[list[KeyIndex]],
    *,
    top_t: int = 64,
    window: int = 32,
    n_sink: int = 4,
    width: int = 64,
    scale: float | None = None,
    exact_search: bool = False,  # brute-force top-k (tests/upper bound)
    backend: str = "fused",
    n_entries: int = 8,
    device=None,
) -> tuple[np.ndarray, dict]:
    """One-token attention approximated by ANN retrieval over the key cache,
    each search on ``device`` (the card unless ``"cpu"`` is given).

    Returns ([B, H, dh], stats with distance-computation counts — the
    paper's latency proxy)."""
    dev = resolve_device(device)
    b, h, dh = q.shape
    hkv = len(indexes[0])
    group = h // hkv
    scale = scale if scale is not None else dh ** -0.5
    out = np.zeros((b, h, dh), np.float32)
    n_dist = 0
    for bi in range(b):
        for hi in range(h):
            ki = indexes[bi][hi // group]
            t = len(ki.keys)
            qv = np.asarray(q[bi, hi], np.float32)
            if exact_search:
                sc = ki.keys @ qv
                ids = np.argsort(-sc)[: min(top_t, t)]
                n_dist += t
            else:
                # inner-product metric (larger = closer); the candidate
                # list must cover top_t (the engine's width >= k)
                kk = min(top_t, t)
                ids_row, st = search(
                    ki.topology(), qv[None, :], kk,
                    backend=backend, width=max(width, kk),
                    n_entries=n_entries, device=dev,
                )
                ids = ids_row[0]
                ids = ids[ids >= 0]
                n_dist += st.n_distance_computations
            recent = np.arange(max(0, t - window), t)
            sinks = np.arange(min(n_sink, t))
            sel = np.unique(np.concatenate([ids, recent, sinks]))
            logits = (ki.keys[sel] @ qv) * scale
            w = np.exp(logits - logits.max())
            w /= w.sum()
            out[bi, hi] = w @ ki.values[sel]
    return out, {"n_distance_computations": n_dist}


def full_decode_attention_ref(q, k_cache, v_cache, scale=None):
    """Dense reference for tests."""
    b, h, dh = q.shape
    hkv = k_cache.shape[1]
    group = h // hkv
    scale = scale if scale is not None else dh ** -0.5
    out = np.zeros((b, h, dh), np.float32)
    for bi in range(b):
        for hi in range(h):
            keys = np.asarray(k_cache[bi, hi // group], np.float32)
            vals = np.asarray(v_cache[bi, hi // group], np.float32)
            logits = (keys @ np.asarray(q[bi, hi], np.float32)) * scale
            w = np.exp(logits - logits.max())
            w /= w.sum()
            out[bi, hi] = w @ vals
    return out
