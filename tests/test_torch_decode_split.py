"""The decompositions of K6 and K3 (``csrc/attention.cu``, ``csrc/beam.cu``)
run in torch ops on the CPU against the JAX package and the port's plain
versions, so the argument of each kernel is checked where no card is.

* K6 splits each row's cache into chunks of ``chunk`` keys
  (``decode_plan``), takes a softmax partial (max, sum, P.V) per chunk and
  combines the partials in split order, a batch at a time (all at once,
  or two at a time as when they do not fit the block's memory).  Held to
  ``repro.kernels.ref.decode_attention`` and ``repro.kernels.ops.
  flash_decode`` at lengths on and around the chunk edges and GQA groups 1,
  4 and 8: 1e-5 in f32 (rounding of another summation order), 8e-3 in bf16
  (the output's rounding, twice).  A row of length 0 gives 0, the port's
  documented difference (the reference's softmax over no key is NaN).
* K3 keeps a sorted candidate list and, once the list holds ``width``
  finite entries, drops every fresh neighbour at or above its last
  distance before sorting and merging the rest.  Held to
  ``fused_beam_plain`` (which keeps the unfiltered top ``width``) and to
  ``repro.kernels.beam.fused_beam(lowering="xla")`` on integer points with
  many equal distances: the same ids in the same order, the same
  distances and the same ``n_dist`` / ``hops`` counters.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import beam as kb
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.search import jax_backend as jb
from repro_torch.kernels import beam as tbeam
from repro_torch.kernels.flash_attention import decode_plan

# ---------------------------------------------------------------------------
# K6: split-KV flash decode
# ---------------------------------------------------------------------------


def _split_decode(q, k, v, lens, chunk: int, batch: int):
    """K6's split and combine: per (row, KV head) the first
    ceil(len / chunk) chunks each give (m, l, acc) in f32.  A lone chunk is
    the output; several are folded in split order, ``batch`` at a time as
    the combining block stages them: per batch the new running max, the
    old sums' rescale and each split's weight, then acc / max(l, 1e-30)."""
    b, h, dh = q.shape
    hkv, t = k.shape[1], k.shape[2]
    group = h // hkv
    qf = (q.float() * dh**-0.5).reshape(b, hkv, group, dh)
    out = torch.zeros(b, hkv, group, dh)
    for row in range(b):
        n = min(max(int(lens[row]), 0), t)
        parts = []
        for k0 in range(0, n, chunk):
            kk = k[row, :, k0:min(n, k0 + chunk)].float()
            vv = v[row, :, k0:min(n, k0 + chunk)].float()
            s = qf[row] @ kk.transpose(-1, -2)  # [hkv, group, keys]
            m = s.amax(dim=-1, keepdim=True)
            p = torch.exp(s - m)
            parts.append((m, p.sum(dim=-1, keepdim=True), p @ vv))
        if not parts:
            continue
        if len(parts) == 1:
            m, l_all, acc = parts[0]
        else:
            m_all = torch.full_like(parts[0][0], -1e30)
            l_all = torch.zeros_like(m_all)
            acc = torch.zeros(hkv, group, dh)
            for s0 in range(0, len(parts), batch):
                some = parts[s0:s0 + batch]
                m_new = torch.stack([m_all] + [m for m, _, _ in some]).amax(0)
                r = torch.exp(m_all - m_new)
                l_all, acc = l_all * r, acc * r
                for m, l_s, a in some:
                    w = torch.exp(m - m_new)
                    l_all = l_all + w * l_s
                    acc = acc + w * a
                m_all = m_new
        out[row] = acc / l_all.clamp_min(1e-30)
    return out.reshape(b, h, dh).to(q.dtype)


@pytest.mark.parametrize("batch", [2, 64])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("chunk", [64, 128, 192])
@pytest.mark.parametrize("group", [1, 4, 8])
def test_split_decode_matches_reference(group, chunk, dtype, batch):
    rng = np.random.default_rng(21)
    hkv, t, dh = 2, 320, 32
    h = hkv * group
    lens = np.array([0, 1, 63, 64, 65, chunk - 1, chunk, chunk + 1, t],
                    np.int32)
    b = len(lens)
    q = rng.standard_normal((b, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, hkv, t, dh)).astype(np.float32)
    v = rng.standard_normal((b, hkv, t, dh)).astype(np.float32)
    if dtype == "bf16":
        jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
        tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
        tol = 8e-3
    else:
        jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
        tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
        tol = 1e-5
    got = _split_decode(tq, tk, tv, lens, chunk, batch).float().numpy()
    live = lens > 0
    assert np.all(got[~live] == 0.0)
    for want in (jref.decode_attention(jq, jk, jv, jnp.asarray(lens)),
                 jops.flash_decode(jq, jk, jv, jnp.asarray(lens))):
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got[live], want[live], rtol=tol, atol=tol)


def test_decode_plan_splits_from_the_shape_alone():
    """The LM path's shape (8 rows x 4 KV heads, T 2048, Dh 64, bf16)
    splits into 16 chunks of 128 keys: 512 blocks; every plan covers T in
    64-key tiles and keeps a chunk's K and V within 64 KB."""
    assert decode_plan(8, 4, 2048, 64, 2) == (128, 16)
    for b, hkv, t, dh, size in [(8, 4, 2048, 64, 4), (1, 1, 5, 16, 2),
                                (64, 8, 4096, 128, 2), (2, 1, 100000, 128, 4),
                                (1, 1, 0, 64, 2)]:
        chunk, n_split = decode_plan(b, hkv, t, dh, size)
        assert chunk % 64 == 0 and n_split >= 1
        assert chunk * n_split >= t > chunk * (n_split - 1) or t == 0
        assert chunk == 64 or 2 * chunk * dh * size <= 65536


# ---------------------------------------------------------------------------
# K3: the threshold-filtered keep step
# ---------------------------------------------------------------------------


def _beam_prefiltered(x, graph, entries, queries, k: int, width: int,
                      n_iters: int, expand: int, metric: str, run: int):
    """K3's traversal, one query at a time: a sorted list with its finite
    entries first; the survivors of the threshold filter, in a shuffled
    arrival order, sorted in runs of ``run`` by (distance, position); each
    list entry and survivor put at its rank (list first on ties), as the
    kernel's merge does.  Returns (ids, dists, n_dist, hops, dropped)."""
    n, r = graph.shape
    shuffle = np.random.default_rng(5)
    sentinel = n
    xf = x.float()
    xn = (xf * xf).sum(dim=1)
    out_ids, out_d, nds, hopss, dropped = [], [], [], [], 0
    for qv in queries.float():
        def score(ids):
            dots = xf[ids] @ qv
            return -dots if metric == "ip" else xn[ids] - 2.0 * dots

        ne = len(entries)
        sd = score(entries)
        order = sorted(range(ne), key=lambda j: (float(sd[j]), j))
        cd = torch.full((width,), float("inf"))
        ci = torch.full((width,), sentinel, dtype=torch.long)
        ce = torch.ones(width, dtype=torch.bool)
        cd[:ne], ci[:ne], ce[:ne] = sd[order], entries[order], False
        n_fin = int(torch.isfinite(cd).sum())
        visited = set(entries.tolist())
        n_dist, hops = ne, 0
        while hops < n_iters:
            sel = [i for i in range(n_fin) if not ce[i]][:expand]
            if not sel:
                break
            ce[sel] = True
            nb = graph[ci[sel]].reshape(-1)
            last = {}
            for pos, nid in enumerate(nb.tolist()):
                if nid >= 0 and nid not in visited:
                    last[nid] = pos
            fresh_pos = torch.tensor(sorted(last.values()), dtype=torch.long)
            visited.update(last)
            nf = len(fresh_pos)
            fd = score(nb[fresh_pos]) if nf else torch.zeros(0)
            thr = cd[width - 1] if n_fin == width else float("inf")
            keep = torch.isfinite(fd) & (fd < thr)
            dropped += int((~keep).sum())
            # survivors arrive in any order (the kernel appends them with
            # atomics): sort them in runs, then rank against every run
            arrive = torch.from_numpy(shuffle.permutation(int(keep.sum())))
            sdist, spos = fd[keep][arrive], fresh_pos[keep][arrive]
            runs = []
            for r0 in range(0, len(sdist), run):
                o = sorted(range(r0, min(len(sdist), r0 + run)),
                           key=lambda j: (float(sdist[j]), int(spos[j])))
                runs.append((sdist[o], spos[o]))
            nd = torch.full((width,), float("inf"))
            ni = torch.full((width,), sentinel, dtype=torch.long)
            nexp = torch.ones(width, dtype=torch.bool)
            listed = cd[:n_fin].contiguous()
            at_list = torch.arange(n_fin) + sum(
                (torch.searchsorted(rd, listed, right=False)
                 for rd, _ in runs), torch.zeros(n_fin, dtype=torch.long))
            fresh = []  # (distance, position, rank in the merged list)
            for own, (rd, rp) in enumerate(runs):
                for j in range(len(rd)):
                    key = (float(rd[j]), int(rp[j]))
                    at = j + sum(sum(1 for d_, p_ in zip(od.tolist(),
                                                          op.tolist())
                                     if (d_, p_) < key)
                                 for r, (od, op) in enumerate(runs)
                                 if r != own)
                    at += int(torch.searchsorted(listed, rd[j:j + 1],
                                                 right=True))
                    fresh.append((rd[j], rp[j], at))
            ns = len(fresh)
            for i, at in enumerate(at_list.tolist()):
                if at < width:
                    nd[at], ni[at], nexp[at] = cd[i], ci[i], ce[i]
            for dj, pj, at in fresh:
                if at < width:
                    nd[at], ni[at], nexp[at] = dj, nb[pj], False
            cd, ci, ce = nd, ni, nexp
            n_fin = min(width, n_fin + ns)
            n_dist += nf
            hops += len(sel)
        ok = torch.isfinite(cd[:k]) & (ci[:k] != sentinel)
        out_ids.append(torch.where(ok, ci[:k], -1))
        out_d.append(cd[:k] + (0.0 if metric == "ip" else float(qv @ qv)))
        nds.append(n_dist)
        hopss.append(hops)
    return (torch.stack(out_ids).int(), torch.stack(out_d),
            torch.tensor(nds).int(), torch.tensor(hopss).int(), dropped)


@pytest.mark.parametrize("run", [64, 5])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_prefiltered_keep_matches_plain_beam(metric, run):
    """Integer coordinates in {0, 1, 2}: every f32 distance is an exact
    integer and most of them tie, so the list-first tie rule decides.  Runs
    of 64 are the kernel's; runs of 5 make many runs on this small
    fixture."""
    rng = np.random.default_rng(31)
    n, d, r, nq, width, k = 400, 6, 8, 12, 16, 10
    x = rng.integers(0, 3, (n, d)).astype(np.float32)
    graph = rng.integers(0, n, (n, r)).astype(np.int32)
    graph[rng.random((n, r)) < 0.1] = -1
    graph[:, 1] = graph[:, 0]  # duplicates within a wavefront
    queries = rng.integers(0, 3, (nq, d)).astype(np.float32)
    entries = jb._prep_entries(np.array([5, 99, 250, 311]), width)
    kw = dict(width=width, n_iters=tbeam.default_n_iters(width), expand=4,
              metric=metric)
    tx, tg = torch.from_numpy(x), torch.from_numpy(graph)
    te, tq = torch.from_numpy(np.asarray(entries)), torch.from_numpy(queries)
    ids, dists, n_dist, hops, dropped = _beam_prefiltered(
        tx, tg.long(), te.long(), tq, k, run=run, **kw)
    assert dropped > 0  # the filter had work to do
    want = tbeam.fused_beam_plain(tx, tg, te, tq, k, scale=0.0, zp=0.0, **kw)
    assert torch.equal(ids, want[0])
    assert torch.equal(dists, want[1])
    assert torch.equal(n_dist, want[2]) and torch.equal(hops, want[3])
    ref = kb.fused_beam(x, graph, entries, queries, k, lowering="xla", **kw)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(n_dist.numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(hops.numpy(), np.asarray(ref[3]))
