"""Checks of a built index: the partition, the merged graph's shape, and
how far the build's graphs lie from the reference's."""

from __future__ import annotations

import numpy as np
import torch


def partition_violations(shard_ids: list, n: int, omega: int) -> int:
    """Points held by no shard or by more than ``omega``, plus shard
    entries that name no point or repeat a point within their shard."""
    counts = np.zeros(n, np.int64)
    bad = 0
    for ids in shard_ids:
        ids = np.asarray(ids, np.int64)
        inside = (ids >= 0) & (ids < n)
        bad += int((~inside).sum())
        u = np.unique(ids[inside])
        bad += int(inside.sum()) - len(u)
        counts[u] += 1
    return bad + int(((counts < 1) | (counts > omega)).sum())


def graph_violations(graph: np.ndarray, n: int, degree: int) -> int:
    """Rows of a merged graph that break its shape: every entry a point id
    or -1 (padding), no self-edge, no edge twice in a row, at least one
    edge a row, and ``degree`` slots a row at most."""
    g = np.asarray(graph, np.int64)
    if g.ndim != 2 or g.shape[0] != n or g.shape[1] > degree:
        return n
    bad = (g < -1) | (g >= n) | (g == np.arange(n)[:, None])
    srt = np.sort(g, axis=1)
    dup = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
    empty = (g < 0).all(axis=1)
    return int(bad.sum() + dup.sum() + empty.sum())


def _first_seen(values, skip: int, cap: int) -> list:
    """The first ``cap`` distinct ids of ``values`` in order, leaving out
    -1 and ``skip``."""
    out, seen = [], {-1, skip}
    for v in values:
        v = int(v)
        if v not in seen:
            seen.add(v)
            out.append(v)
            if len(out) == cap:
                break
    return out


def _differ(program, reference) -> int:
    """Slots by which a row of the program's and the reference's differ as
    sets (-1 padding left out)."""
    a = {int(v) for v in program} - {-1}
    b = {int(v) for v in reference} - {-1}
    return max(len(a - b), len(b - a))


def _shard_rows(x: torch.Tensor, rows: torch.Tensor, graph: np.ndarray,
                build_degree: int, degree: int) -> tuple:
    """The reference's forward edges and whole row of each of ``rows`` of a
    CAGRA shard graph over ``x`` (float64): the exact ``build_degree``
    nearest neighbours within the shard, ranked by the detour rule, the
    ``degree - degree // 2`` with the fewest detours kept (ties by
    distance), then the reverse edges of the program's own forward halves,
    then the rest of the neighbour list.  The rule is the system's: edge
    (u, v_j) is detoured through a nearer neighbour v_i when the distance
    |v_i - v_j| lies below the squared distance |u - v_j|^2."""
    n, m = x.shape[0], len(rows)
    L, fk = build_degree, degree - degree // 2
    q = x[rows]
    d2 = ((q * q).sum(1)[:, None] + (x * x).sum(1)[None, :]
          - 2.0 * (q @ x.T))
    d2[torch.arange(m), rows] = torch.inf
    c = min(L + 8, n - 1)
    cand = torch.topk(d2, c, dim=1, largest=False).indices
    exact = ((x[cand] - q[:, None, :]) ** 2).sum(2)  # squared, directly
    o1 = torch.argsort(cand, dim=1, stable=True)
    o2 = torch.argsort(exact.gather(1, o1), dim=1, stable=True)
    order = o1.gather(1, o2)[:, :L]
    nb, du2 = cand.gather(1, order), exact.gather(1, order)
    if nb.shape[1] < L:  # a shard of L points or fewer: padded
        pad = L - nb.shape[1]
        nb = torch.cat([nb, nb.new_full((m, pad), -1)], 1)
        du2 = torch.cat([du2, du2.new_full((m, pad), torch.inf)], 1)
    v = x[nb.clamp_min(0)]
    nn = (v * v).sum(2)
    dij = (nn[:, :, None] + nn[:, None, :]
           - 2.0 * (v @ v.transpose(1, 2))).clamp_min(0.0).sqrt()
    ar = torch.arange(L, device=x.device)
    detour = (dij < du2[:, None, :]) & (ar[:, None] < ar[None, :])[None]
    counts = detour.sum(1) + torch.where(torch.isfinite(du2), 0, 10**6)
    rank = torch.argsort(counts, dim=1, stable=True)
    ranked = nb.gather(1, rank).cpu().numpy()
    rows_np = rows.cpu().numpy()
    # reverse edges: the sources u, ascending, whose forward half names r
    dst = np.asarray(graph[:, :fk], np.int64).reshape(-1)
    src = np.repeat(np.arange(len(graph)), fk)
    hit = np.isin(dst, rows_np)
    dst, src = dst[hit], src[hit]
    fwd_miss = row_miss = 0
    for j, r in enumerate(rows_np):
        fwd = ranked[j, :fk]
        rev = src[dst == r][: degree // 2]
        row = _first_seen(np.concatenate([fwd, rev, ranked[j, fk:]]),
                          int(r), degree)
        fwd_miss += _differ(graph[r, :fk], fwd)
        row_miss += _differ(graph[r], row)
    return fwd_miss, row_miss


def build_gap(data: np.ndarray, shard_ids: list, shard_graphs: list,
              merged: np.ndarray, rows: np.ndarray, *, build_degree: int,
              degree: int, device, block: int = 64) -> dict:
    """How far a ScaleGANN build's graphs lie from the reference's, over
    the sampled global ``rows``: in every shard holding a row, its forward
    edges (from the points alone) and its whole shard row (from the
    program's forward halves); then its merged row, the ``degree`` nearest
    of the union of its shard rows (from the program's shard graphs).
    Distances in float64.  Returns the slots that differ and the slots
    judged, in all and by stage."""
    dev = torch.device(device)
    n = len(data)
    sampled = np.zeros(n, bool)
    sampled[rows] = True
    fk = degree - degree // 2
    out = {"forward": 0, "shard_row": 0, "merge": 0,
           "forward_slots": 0, "row_slots": 0}
    where = []  # per shard, the global id -> local row map
    for ids, g in zip(shard_ids, shard_graphs):
        ids = np.asarray(ids, np.int64)
        loc = np.full(n, -1, np.int64)
        loc[ids] = np.arange(len(ids))
        where.append(loc)
        local = np.nonzero(sampled[ids])[0]
        if len(local) == 0:
            continue
        x = torch.from_numpy(np.asarray(data[ids], np.float64)).to(dev)
        g = np.asarray(g)
        for s in range(0, len(local), block):
            r = torch.from_numpy(local[s:s + block]).to(dev)
            f, w = _shard_rows(x, r, g, build_degree, degree)
            out["forward"] += f
            out["shard_row"] += w
        out["forward_slots"] += fk * len(local)
        out["row_slots"] += degree * len(local)
    for u in rows:
        cand = np.concatenate([
            np.asarray(ids, np.int64)[np.asarray(g)[loc[u]]][
                np.asarray(g)[loc[u]] >= 0]
            for ids, g, loc in zip(shard_ids, shard_graphs, where)
            if loc[u] >= 0] or [np.empty(0, np.int64)])
        cand = np.asarray(_first_seen(cand, int(u), len(cand)), np.int64)
        if len(cand) > degree:
            diff = (np.asarray(data[cand], np.float64)
                    - np.asarray(data[u], np.float64))
            cand = cand[np.argsort((diff * diff).sum(1),
                                   kind="stable")[:degree]]
        out["merge"] += _differ(merged[u], cand)
    out["merge_slots"] = degree * len(rows)
    out["slots"] = out["forward_slots"] + out["row_slots"] + \
        out["merge_slots"]
    out["differ"] = out["forward"] + out["shard_row"] + out["merge"]
    return out
