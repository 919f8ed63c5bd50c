// Fused batched beam search for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel repro/kernels/beam.py _fused_beam_pallas
// (_beam_kernel, with topk.bitonic_sort_lex): the whole best-first graph
// traversal of a query batch, plus the optional exact-f32 re-rank, in one
// launch.  Its semantics are _fused_beam_xla (beam.py:90-294):
//   * seed with E <= width entries (padding: sentinel id N, expanded, inf);
//   * each trip expands the `expand` best unexpanded candidates by
//     (distance, position); neighbours that are -1 are dropped;
//   * a neighbour already visited is skipped; duplicates within one
//     wavefront resolve to their last occurrence;
//   * the beam keeps the best `width` of candidates + fresh neighbours by
//     (distance, position); the loop halts when no candidate is live or
//     hops >= n_iters; n_dist counts seeds + fresh, hops counts expansions;
//   * f32/bf16 L2 scores rank on |x|^2 - 2 q.x and add |q|^2 at the end;
//     uint8 scores are absolute and integer-exact;
//   * the epilogue re-scores the top k in exact f32, sorts by (distance,
//     id), and counts n_rerank as the valid candidates.
//
// The TPU layout is not carried over: its dense [1, N] score row, one-hot
// matmul gathers and whole-shard VMEM residency exist only because Mosaic
// has no gather.  Here one block of 256 threads runs one query, with the
// candidate list (distances, ids, expanded flags) in shared memory, and
// gathers graph rows and vector rows straight from device memory, one warp
// per scored row.  The visited set is an exact open-addressing hash in
// shared memory whose capacity is at least 2 * (E + (n_iters + expand) * R),
// the most ids a query can ever insert, so it never forgets and never
// fills; a second small hash, cleared every trip, resolves duplicates in a
// wavefront to their last position.  The candidate list is kept sorted by
// distance (the seeds are sorted once, stably, which preserves the
// (distance, position) order), so selecting the wavefront is a scan for the
// first unexpanded entries, and the keep step is a merge of the list with
// the trip's fresh neighbours, sorted by a bitonic network on (distance,
// position).
//
// What bounds it on an H100: the bytes it gathers, n_dist vector rows and
// hops graph rows per query, each row a dependent read behind the previous
// trip's selection; the kernel is bound by the latency of those gathers
// long before the 3.35 TB/s of HBM.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int EMPTY = -1;

enum Stage { F32 = 0, BF16 = 1, U8 = 2 };

struct Params {
  const void* x;          // [N, D] f32 | bf16 | uint8 codes
  const int* graph;       // [N, R]
  const int* entries;     // [E]
  const void* queries;    // [Q, D] f32 | bf16 | uint8 codes
  const float* xnorm;     // [N] f32 |x|^2 (f32/bf16 L2)
  const int* xcnorm;      // [N] int32 code norms (uint8 L2)
  const int* xcsum;       // [N] int32 code sums (uint8 IP)
  const float* x_exact;   // [N, DX] f32 (re-rank) or null
  const float* q_exact;   // [Q, DX] f32 (re-rank) or null
  int* out_ids;           // [Q, k_out]
  float* out_d;           // [Q, k_out]
  int* out_nd;            // [Q]
  int* out_hops;          // [Q]
  int* out_nrr;           // [Q]
  int n, d, r, e, width, k, rerank_k, n_iters, expand, dx;
  float scale, zp;
  int hash_log2, wave_log2, pad_pow2;
};

__device__ __forceinline__ unsigned hash_slot(int key, int log2cap) {
  return ((unsigned)key * 0x9E3779B1u) >> (32 - log2cap);
}

__device__ __forceinline__ bool hash_contains(const int* tab, int log2cap, int key) {
  const unsigned mask = (1u << log2cap) - 1u;
  for (unsigned s = hash_slot(key, log2cap);; s = (s + 1u) & mask) {
    const int v = tab[s];
    if (v == key) return true;
    if (v == EMPTY) return false;
  }
}

__device__ __forceinline__ unsigned hash_insert(int* tab, int log2cap, int key) {
  const unsigned mask = (1u << log2cap) - 1u;
  for (unsigned s = hash_slot(key, log2cap);; s = (s + 1u) & mask) {
    const int prev = atomicCAS(&tab[s], EMPTY, key);
    if (prev == EMPTY || prev == key) return s;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum_i(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Score of vector row `id` against the query held in shared memory, on all
// lanes of the calling warp.
template <int STAGE, bool L2>
__device__ float score_row(const Params& p, const float* qf, const int* qi,
                           int cqn, int cqs, int id, int lane) {
  const size_t base = (size_t)id * p.d;
  if (STAGE == U8) {
    const uint8_t* x = (const uint8_t*)p.x + base;
    int acc = 0;
    for (int i = lane; i < p.d; i += 32) acc += qi[i] * (int)x[i];
    acc = warp_sum_i(acc);
    const float ss = __fmul_rn(p.scale, p.scale);
    if (L2) {
      const int dc = p.xcnorm[id] + cqn - 2 * acc;
      return __fmul_rn(fmaxf(__int2float_rn(dc), 0.f), ss);
    }
    const float t1 = __fmul_rn(ss, __int2float_rn(acc));
    const float t2 = __fmul_rn(__fmul_rn(p.scale, p.zp),
                               __int2float_rn(cqs + p.xcsum[id]));
    const float t3 = __fmul_rn(__fmul_rn((float)p.d, p.zp), p.zp);
    return -__fadd_rn(__fadd_rn(t1, t2), t3);
  }
  float acc = 0.f;
  if (STAGE == BF16) {
    const __nv_bfloat16* x = (const __nv_bfloat16*)p.x + base;
    for (int i = lane; i < p.d; i += 32) acc = fmaf(qf[i], __bfloat162float(x[i]), acc);
  } else {
    const float* x = (const float*)p.x + base;
    for (int i = lane; i < p.d; i += 32) acc = fmaf(qf[i], x[i], acc);
  }
  acc = warp_sum(acc);
  return L2 ? p.xnorm[id] - 2.f * acc : -acc;
}

// (value, position) lexicographic order
__device__ __forceinline__ bool lex_gt(float a, int ia, float b, int ib) {
  return a > b || (a == b && ia > ib);
}

template <int STAGE, bool L2>
__global__ void __launch_bounds__(THREADS) beam_kernel(Params p) {
  extern __shared__ int smem[];
  const int W = p.width, NN = p.expand * p.r, P2 = p.pad_pow2;
  const int HC = 1 << p.hash_log2, WC = 1 << p.wave_log2;
  float* qf = (float*)smem;                  // [D] query (f32/bf16 upcast)
  int* qi = smem;                            // [D] query codes (uint8)
  float* cd = (float*)(smem + p.d);          // [W] candidate distances
  int* ci = (int*)(cd + W);                  // [W] candidate ids
  int* ce = ci + W;                          // [W] expanded flags
  float* cd2 = (float*)(ce + W);             // next list (double buffer)
  int* ci2 = (int*)(cd2 + W);
  int* ce2 = ci2 + W;
  int* nb = ce2 + W;                         // [NN] wavefront candidate ids
  int* wslot = nb + NN;                      // [NN] wavefront hash slot
  float* fd = (float*)(wslot + NN);          // [P2] fresh distances
  int* fp = (int*)(fd + P2);                 // [P2] fresh positions
  int* vis = fp + P2;                        // [HC] visited hash
  int* wkey = vis + HC;                      // [WC] wavefront hash keys
  int* wval = wkey + WC;                     // [WC] last position per key
  __shared__ int sel[32];
  __shared__ int s_nlive, s_nfresh, s_cqn, s_cqs;
  __shared__ float s_qn;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int qrow = blockIdx.x;
  const int n = p.n, sentinel = p.n;

  for (int i = tid; i < p.d; i += THREADS) {
    const size_t at = (size_t)qrow * p.d + i;
    if (STAGE == U8) qi[i] = (int)((const uint8_t*)p.queries)[at];
    else if (STAGE == BF16) qf[i] = __bfloat162float(((const __nv_bfloat16*)p.queries)[at]);
    else qf[i] = ((const float*)p.queries)[at];
  }
  for (int i = tid; i < HC; i += THREADS) vis[i] = EMPTY;
  __syncthreads();
  if (warp == 0) {
    if (STAGE == U8) {
      int sq = 0, s1 = 0;
      for (int i = lane; i < p.d; i += 32) { sq += qi[i] * qi[i]; s1 += qi[i]; }
      sq = warp_sum_i(sq);
      s1 = warp_sum_i(s1);
      if (lane == 0) { s_cqn = sq; s_cqs = s1; }
    } else {
      float s = 0.f;
      for (int i = lane; i < p.d; i += 32) s = fmaf(qf[i], qf[i], s);
      s = warp_sum(s);
      if (lane == 0) s_qn = s;
    }
  }
  __syncthreads();
  const int cqn = STAGE == U8 ? s_cqn : 0, cqs = STAGE == U8 ? s_cqs : 0;

  // ---- seeding: score the entries, mark them visited, sort them stably ----
  for (int j = warp; j < p.e; j += WARPS) {
    const int id = p.entries[j];
    const float v = score_row<STAGE, L2>(p, qf, qi, cqn, cqs, id, lane);
    if (lane == 0) { cd2[j] = v; ci2[j] = id; }
  }
  for (int j = tid; j < p.e; j += THREADS) hash_insert(vis, p.hash_log2, p.entries[j]);
  __syncthreads();
  for (int j = tid; j < W; j += THREADS) {
    if (j < p.e) {
      int rank = 0;
      for (int i = 0; i < p.e; ++i) rank += lex_gt(cd2[j], j, cd2[i], i) ? 1 : 0;
      cd[rank] = cd2[j];
      ci[rank] = ci2[j];
      ce[rank] = 0;
    } else {
      cd[j] = CUDART_INF_F;
      ci[j] = sentinel;
      ce[j] = 1;
    }
  }
  __syncthreads();

  int n_dist = p.e, hops = 0;
  while (hops < p.n_iters) {
    // ---- wavefront: the first `expand` unexpanded finite entries ----
    if (warp == 0) {
      int found = 0;
      for (int base = 0; base < W && found < p.expand; base += 32) {
        const int i = base + lane;
        const bool ok = i < W && ce[i] == 0 && isfinite(cd[i]);
        unsigned m = __ballot_sync(FULL, ok);
        while (m && found < p.expand) {
          const int b = __ffs(m) - 1;
          m &= m - 1;
          if (lane == 0) sel[found] = base + b;
          ++found;
        }
      }
      if (lane == 0) { s_nlive = found; s_nfresh = 0; }
    }
    for (int i = tid; i < WC; i += THREADS) { wkey[i] = EMPTY; wval[i] = -1; }
    __syncthreads();
    const int nl = s_nlive;
    if (nl == 0) break;  // converged: nothing live to expand
    if (tid < nl) ce[sel[tid]] = 1;

    // ---- gather neighbours; drop -1 and already-visited ids ----
    for (int q = tid; q < NN; q += THREADS) {
      const int j = q / p.r, rr = q % p.r;
      int id = -1;
      if (j < nl) {
        const int v = ci[sel[j]];
        id = p.graph[(size_t)min(max(v, 0), n - 1) * p.r + rr];
        if (id >= 0 && hash_contains(vis, p.hash_log2, id)) id = -1;
      }
      nb[q] = id;
    }
    __syncthreads();
    // ---- duplicates within the wavefront: the last position wins ----
    for (int q = tid; q < NN; q += THREADS) {
      if (nb[q] >= 0) {
        const unsigned s = hash_insert(wkey, p.wave_log2, nb[q]);
        wslot[q] = (int)s;
        atomicMax(&wval[s], q);
      }
    }
    __syncthreads();
    for (int q = tid; q < NN; q += THREADS) {
      if (nb[q] >= 0 && wval[wslot[q]] == q) {
        hash_insert(vis, p.hash_log2, nb[q]);
        fp[atomicAdd(&s_nfresh, 1)] = q;
      }
    }
    __syncthreads();
    const int nf = s_nfresh;
    int f2 = 1;
    while (f2 < nf) f2 <<= 1;
    // ---- score the fresh neighbours, one warp per row ----
    for (int j = warp; j < nf; j += WARPS) {
      const float v = score_row<STAGE, L2>(p, qf, qi, cqn, cqs, nb[fp[j]], lane);
      if (lane == 0) fd[j] = v;
    }
    for (int j = nf + tid; j < f2; j += THREADS) { fd[j] = CUDART_INF_F; fp[j] = 0x7fffffff; }
    __syncthreads();
    // ---- bitonic sort of the fresh (distance, position) pairs ----
    for (int size = 2; size <= f2; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int i = tid; i < f2; i += THREADS) {
          const int j = i ^ stride;
          if (j > i) {
            const bool up = (i & size) == 0;
            if (lex_gt(fd[i], fp[i], fd[j], fp[j]) == up) {
              const float tv = fd[i]; fd[i] = fd[j]; fd[j] = tv;
              const int tp = fp[i]; fp[i] = fp[j]; fp[j] = tp;
            }
          }
        }
        __syncthreads();
      }
    }
    // ---- keep the best `width` of list + fresh (list first on ties) ----
    int n_fin = 0;
    for (int i = 0; i < W; ++i) n_fin += isfinite(cd[i]) ? 1 : 0;  // sorted: finite prefix
    for (int i = tid; i < n_fin; i += THREADS) {
      int lo = 0, hi = nf;  // fresh entries strictly closer
      while (lo < hi) { const int mid = (lo + hi) >> 1; if (fd[mid] < cd[i]) lo = mid + 1; else hi = mid; }
      const int at = i + lo;
      if (at < W) { cd2[at] = cd[i]; ci2[at] = ci[i]; ce2[at] = ce[i]; }
    }
    for (int j = tid; j < nf; j += THREADS) {
      int lo = 0, hi = n_fin;  // list entries at or below
      while (lo < hi) { const int mid = (lo + hi) >> 1; if (cd[mid] <= fd[j]) lo = mid + 1; else hi = mid; }
      const int at = j + lo;
      if (at < W) { cd2[at] = fd[j]; ci2[at] = nb[fp[j]]; ce2[at] = 0; }
    }
    for (int i = n_fin + nf + tid; i < W; i += THREADS) {
      cd2[i] = CUDART_INF_F; ci2[i] = sentinel; ce2[i] = 1;
    }
    __syncthreads();
    for (int i = tid; i < W; i += THREADS) { cd[i] = cd2[i]; ci[i] = ci2[i]; ce[i] = ce2[i]; }
    __syncthreads();
    n_dist += nf;
    hops += nl;
  }

  // ---- final top-k: the list is sorted, so it is its first k entries ----
  const int k = p.k;
  const float qn_add = (L2 && STAGE != U8) ? s_qn : 0.f;
  if (p.rerank_k == 0) {
    for (int j = tid; j < k; j += THREADS) {
      const bool ok = isfinite(cd[j]) && ci[j] != sentinel;
      p.out_ids[(size_t)qrow * k + j] = ok ? ci[j] : -1;
      p.out_d[(size_t)qrow * k + j] = cd[j] + qn_add;
    }
    if (tid == 0) { p.out_nd[qrow] = n_dist; p.out_hops[qrow] = hops; p.out_nrr[qrow] = 0; }
    return;
  }

  // ---- exact-f32 re-rank of the top k, sorted by (distance, id) ----
  const float* qx = p.q_exact + (size_t)qrow * p.dx;
  for (int j = warp; j < k; j += WARPS) {
    const bool ok = isfinite(cd[j]) && ci[j] != sentinel;
    float v = CUDART_INF_F;
    if (ok) {
      const float* row = p.x_exact + (size_t)ci[j] * p.dx;
      float acc = 0.f;
      for (int i = lane; i < p.dx; i += 32) {
        if (L2) { const float df = row[i] - qx[i]; acc = fmaf(df, df, acc); }
        else acc = fmaf(row[i], qx[i], acc);
      }
      acc = warp_sum(acc);
      v = L2 ? acc : -acc;
    }
    if (lane == 0) { fd[j] = v; fp[j] = ok ? ci[j] : 0x7fffffff; }
  }
  __syncthreads();
  const int rk = p.rerank_k;
  for (int j = tid; j < k; j += THREADS) {
    int rank = 0;
    for (int i = 0; i < k; ++i) {
      const bool before = fd[i] < fd[j] || (fd[i] == fd[j] && (fp[i] < fp[j] || (fp[i] == fp[j] && i < j)));
      rank += before ? 1 : 0;
    }
    if (rank < rk) {
      p.out_ids[(size_t)qrow * rk + rank] = fp[j] == 0x7fffffff ? -1 : fp[j];
      p.out_d[(size_t)qrow * rk + rank] = fd[j];
    }
  }
  if (warp == 0) {
    int nv = 0;
    for (int j = lane; j < k; j += 32) nv += fp[j] != 0x7fffffff ? 1 : 0;
    nv = warp_sum_i(nv);
    if (lane == 0) { p.out_nd[qrow] = n_dist; p.out_hops[qrow] = hops; p.out_nrr[qrow] = nv; }
  }
}

template <int STAGE, bool L2>
int launch(const Params& p, int nq, size_t smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      beam_kernel<STAGE, L2>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  beam_kernel<STAGE, L2><<<nq, THREADS, smem, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" size_t repro_beam_smem(int d, int width, int nn, int pad_pow2,
                                  int hash_log2, int wave_log2) {
  return sizeof(int) * ((size_t)d + 6 * (size_t)width + 2 * (size_t)nn + 2 * (size_t)pad_pow2
                        + ((size_t)1 << hash_log2) + 2 * ((size_t)1 << wave_log2));
}

extern "C" int repro_fused_beam(
    const void* x, const int* graph, const int* entries, const void* queries,
    const float* xnorm, const int* xcnorm, const int* xcsum,
    const float* x_exact, const float* q_exact,
    int* out_ids, float* out_d, int* out_nd, int* out_hops, int* out_nrr,
    int n, int d, int r, int e, int nq, int width, int k, int rerank_k,
    int n_iters, int expand, int dx, int metric_ip, int stage,
    float scale, float zp, int hash_log2, int wave_log2, int pad_pow2,
    void* stream) {
  if (expand > 32 || width < 1 || k > width || hash_log2 < 1 || hash_log2 > 30)
    return (int)cudaErrorInvalidValue;
  Params p{x, graph, entries, queries, xnorm, xcnorm, xcsum, x_exact, q_exact,
           out_ids, out_d, out_nd, out_hops, out_nrr,
           n, d, r, e, width, k, rerank_k, n_iters, expand, dx,
           scale, zp, hash_log2, wave_log2, pad_pow2};
  const size_t smem = repro_beam_smem(d, width, expand * r, pad_pow2, hash_log2, wave_log2);
  cudaStream_t s = (cudaStream_t)stream;
  if (nq == 0) return 0;
  switch (stage * 2 + metric_ip) {
    case 0: return launch<F32, true>(p, nq, smem, s);
    case 1: return launch<F32, false>(p, nq, smem, s);
    case 2: return launch<BF16, true>(p, nq, smem, s);
    case 3: return launch<BF16, false>(p, nq, smem, s);
    case 4: return launch<U8, true>(p, nq, smem, s);
    case 5: return launch<U8, false>(p, nq, smem, s);
  }
  return (int)cudaErrorInvalidValue;
}
