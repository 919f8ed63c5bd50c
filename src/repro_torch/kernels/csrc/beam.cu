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
//     id), and counts n_rerank as the valid candidates.  Each exact
//     distance is summed in one fixed order, lane sums then an xor
//     butterfly with every operation rounded once, which the plain version
//     (ref.py lane_sum) writes in elementwise torch ops: the two agree
//     bit for bit.
//
// The TPU layout is not carried over: its dense [1, N] score row, one-hot
// matmul gathers and whole-shard VMEM residency exist only because Mosaic
// has no gather.  Here one block of 256 threads runs one query and gathers
// graph rows and vector rows straight from device memory.
//
// Layout.  Shared memory holds the query, two candidate lists (distances,
// ids, expanded flags) used in turn, the trip's wavefront, its survivors,
// and two hashes.  The visited set is an exact open-addressing hash whose
// capacity is the power of two above E + (n_iters + expand) * R, the most
// ids a query can ever insert (each trip inserts at most expand * R fresh
// ids, and the trips expand at most n_iters + expand - 1 nodes in all), so
// it never forgets and never fills: one slot at least stays empty, and a
// probe ends there.  Its load factor stays under 0.82 (6720 ids in 8192
// slots at width 64, R 64, expand 8), far lower in a typical search.  At
// that configuration a block takes 53 KB, so four queries are resident on
// an SM (registers are held to 64 for it).  A second small hash, cleared
// every trip, resolves duplicates in a wavefront to their last position.
//
// A trip.  The list is kept sorted by (distance, position) with its finite
// entries first and their count tracked, so the wavefront is the first
// `expand` unexpanded entries.  Graph rows are gathered, visited ids
// dropped and each remaining id's last position registered in one pass.
// Fresh rows are scored in 16-byte loads (a D = 128 f32 row is one float4
// per lane, bf16 half a warp, uint8 a quarter warp, with __dp4a), each warp
// issuing the loads of four rounds of rows before it reduces any (for f32
// rows, eight at 128 registers and two queries an SM when a launch has at
// most two queries per SM: an f32 round is one row a warp, and a small
// batch has an SM per query to fill), with a scalar path for rows that are not 16-byte multiples.  Once the list holds
// W finite entries, a fresh score >= its last never enters it (ties go to
// the list), so only the survivors are compacted, sorted in runs of 64
// (one warp a run, by shuffles, no barrier) and put at their ranks in the
// other list buffer (binary searches in the runs and the list); the
// counters count every fresh row as before.  Six barriers a trip.
//
// What bounds it on an H100: the bytes it gathers, n_dist vector rows and
// hops graph rows per query, each row a dependent read behind the previous
// trip's selection, so latency: more queries resident and more rows in
// flight per query are the levers, not the 3.35 TB/s of HBM.

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
  int hash_log2, wave_log2, slots;
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

// (value, position) lexicographic order
__device__ __forceinline__ bool lex_gt(float a, int ia, float b, int ib) {
  return a > b || (a == b && ia > ib);
}

template <int STAGE> struct Elem;
template <> struct Elem<F32> { using T = float; using Acc = float; };
template <> struct Elem<BF16> { using T = __nv_bfloat16; using Acc = float; };
template <> struct Elem<U8> { using T = uint8_t; using Acc = int; };

// Query of the block in shared memory: f32 (f32/bf16 stages) or int codes,
// plus the codes packed four to a word (uint8, for __dp4a).
struct Query {
  const float* qf;
  const int* qi;
  const uint32_t* qw;
  int cqn, cqs;
};

// acc += x . q over one 16-byte unit (VEC) or one element of row `row`.
template <int STAGE, bool VEC>
__device__ __forceinline__ void dot_unit(typename Elem<STAGE>::Acc& acc, const void* row,
                                         const Query& qr, int c) {
  if constexpr (VEC) {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(row) + c);
    if constexpr (STAGE == U8) {
      const uint32_t* qw = qr.qw + 4 * c;
      acc = (int)__dp4a(w.x, qw[0], (unsigned)acc);
      acc = (int)__dp4a(w.y, qw[1], (unsigned)acc);
      acc = (int)__dp4a(w.z, qw[2], (unsigned)acc);
      acc = (int)__dp4a(w.w, qw[3], (unsigned)acc);
    } else if constexpr (STAGE == BF16) {
      const float4 qa = reinterpret_cast<const float4*>(qr.qf)[2 * c];
      const float4 qb = reinterpret_cast<const float4*>(qr.qf)[2 * c + 1];
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
      const float qs[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 xf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ws[i]));
        acc = fmaf(qs[2 * i], xf.x, acc);
        acc = fmaf(qs[2 * i + 1], xf.y, acc);
      }
    } else {
      const float4 q4 = reinterpret_cast<const float4*>(qr.qf)[c];
      const float4 x4 = *reinterpret_cast<const float4*>(&w);
      acc = fmaf(q4.x, x4.x, acc);
      acc = fmaf(q4.y, x4.y, acc);
      acc = fmaf(q4.z, x4.z, acc);
      acc = fmaf(q4.w, x4.w, acc);
    }
  } else {
    if constexpr (STAGE == U8) acc += qr.qi[c] * (int)((const uint8_t*)row)[c];
    else if constexpr (STAGE == BF16)
      acc = fmaf(qr.qf[c], __bfloat162float(((const __nv_bfloat16*)row)[c]), acc);
    else acc = fmaf(qr.qf[c], ((const float*)row)[c], acc);
  }
}

// The per-row constant a score needs (|x|^2, code norm or code sum),
// loaded beside the row so its latency overlaps the row's.
template <int STAGE, bool L2>
__device__ __forceinline__ typename Elem<STAGE>::Acc row_aux(const Params& p, int id) {
  if constexpr (STAGE == U8) return L2 ? __ldg(p.xcnorm + id) : __ldg(p.xcsum + id);
  else return L2 ? __ldg(p.xnorm + id) : 0.f;
}

// The score of a row from its dot product with the query and its row_aux
// (the reference's arithmetic: uint8 integer-exact with the _rn epilogue).
template <int STAGE, bool L2>
__device__ __forceinline__ float finish(const Params& p, const Query& qr,
                                        typename Elem<STAGE>::Acc acc,
                                        typename Elem<STAGE>::Acc aux) {
  if constexpr (STAGE == U8) {
    const float ss = __fmul_rn(p.scale, p.scale);
    if (L2) {
      const int dc = aux + qr.cqn - 2 * acc;
      return __fmul_rn(fmaxf(__int2float_rn(dc), 0.f), ss);
    }
    const float t1 = __fmul_rn(ss, __int2float_rn(acc));
    const float t2 = __fmul_rn(__fmul_rn(p.scale, p.zp), __int2float_rn(qr.cqs + aux));
    const float t3 = __fmul_rn(__fmul_rn((float)p.d, p.zp), p.zp);
    return -__fadd_rn(__fadd_rn(t1, t2), t3);
  } else {
    return L2 ? aux - 2.f * acc : -acc;
  }
}

// Score rows 0..count-1 (ids from id_of) on the whole block and hand each
// (row, score) to emit on one lane.  A row is `nu` units (16-byte vectors,
// or elements without VEC) read by `lpr` lanes (a power of two <= 32), so
// a warp holds 32 / lpr rows per round; each warp issues ROUNDS rounds of
// loads before any reduction, so 8 * ROUNDS * 32 / lpr rows are in flight
// per block (at ROUNDS 4: 32 for f32 at D = 128, 64 for bf16, 128 for
// uint8).
template <int STAGE, bool L2, bool VEC, int ROUNDS, typename IdOf, typename Emit>
__device__ __forceinline__ void score_rows(const Params& p, const Query& qr, int nu, int lpr,
                                           int count, IdOf id_of, Emit emit) {
  using T = typename Elem<STAGE>::T;
  using Acc = typename Elem<STAGE>::Acc;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int sub = lane % lpr, rpw = 32 / lpr, rsel = lane / lpr;
  const int per_warp = ROUNDS * rpw;
  for (int base = warp * per_warp; base < count; base += WARPS * per_warp) {
    int id[ROUNDS];
    Acc acc[ROUNDS], aux[ROUNDS];
#pragma unroll
    for (int u = 0; u < ROUNDS; ++u) {
      const int j = base + u * rpw + rsel;
      id[u] = j < count ? id_of(j) : -1;
      acc[u] = 0;
      aux[u] = sub == 0 && id[u] >= 0 ? row_aux<STAGE, L2>(p, id[u]) : 0;
    }
    for (int c = sub; c < nu; c += lpr) {
#pragma unroll
      for (int u = 0; u < ROUNDS; ++u)
        if (id[u] >= 0)
          dot_unit<STAGE, VEC>(acc[u], (const T*)p.x + (size_t)id[u] * p.d, qr, c);
    }
#pragma unroll
    for (int u = 0; u < ROUNDS; ++u)
      for (int o = lpr >> 1; o > 0; o >>= 1) acc[u] += __shfl_xor_sync(FULL, acc[u], o);
    if (sub == 0) {
#pragma unroll
      for (int u = 0; u < ROUNDS; ++u)
        if (id[u] >= 0) emit(base + u * rpw + rsel, finish<STAGE, L2>(p, qr, acc[u], aux[u]));
    }
  }
}

// Entries of a sorted run of n distances below v.
__device__ __forceinline__ int count_below(const float* d, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) { const int mid = (lo + hi) >> 1; if (d[mid] < v) lo = mid + 1; else hi = mid; }
  return lo;
}

// Entries of a run sorted by (distance, position) that come before (v, pv).
__device__ __forceinline__ int count_lex_below(const float* d, const int* pos, int n, float v,
                                               int pv) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (lex_gt(v, pv, d[mid], pos[mid])) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Sort n <= 64 (distance, position) pairs by (distance, position) on one
// warp: a bitonic network over two elements per lane, no barrier.
__device__ __forceinline__ void warp_sort64(float* d, int* pos, int n, int lane) {
  float v[2];
  int ix[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = lane + 32 * r;
    v[r] = i < n ? d[i] : CUDART_INF_F;
    ix[r] = i < n ? pos[i] : 0x7fffffff;
  }
  for (int size = 2; size <= 64; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride == 32) {  // size 64: elements lane and lane + 32, ascending
        if (lex_gt(v[0], ix[0], v[1], ix[1])) {
          const float tv = v[0]; v[0] = v[1]; v[1] = tv;
          const int ti = ix[0]; ix[0] = ix[1]; ix[1] = ti;
        }
        continue;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = lane + 32 * r;
        const float ov = __shfl_xor_sync(FULL, v[r], stride);
        const int oi = __shfl_xor_sync(FULL, ix[r], stride);
        const bool keep_min = ((i & stride) == 0) == ((i & size) == 0);
        const bool other_smaller = lex_gt(v[r], ix[r], ov, oi);
        if (keep_min == other_smaller) { v[r] = ov; ix[r] = oi; }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = lane + 32 * r;
    if (i < n) { d[i] = v[r]; pos[i] = ix[r]; }
  }
}

// ROUNDS 4 holds a thread to 64 registers, so four blocks (queries) share
// an SM; ROUNDS 8 doubles the rows in flight at 128 registers and two
// blocks an SM, for f32 launches of at most two queries per SM.
template <int STAGE, bool L2, bool VEC, int ROUNDS>
__global__ void __launch_bounds__(THREADS, ROUNDS == 4 ? 4 : 2) beam_kernel(Params p) {
  extern __shared__ int4 smem4[];
  int* smem = reinterpret_cast<int*>(smem4);
  const int W = p.width, NN = p.expand * p.r, NS = p.slots;
  const int HC = 1 << p.hash_log2, WC = 1 << p.wave_log2;
  const int QW = p.d + (p.d + 3) / 4;
  float* qf = (float*)smem;                  // [D] query (f32/bf16 upcast)
  int* qi = smem;                            // [D] query codes (uint8)
  uint32_t* qw = (uint32_t*)(smem + p.d);    // [D/4] codes packed (uint8)
  float* cd = (float*)(smem + QW);           // [W] list distances
  int* ci = (int*)(cd + W);                  // [W] list ids
  int* ce = ci + W;                          // [W] expanded flags
  float* cd2 = (float*)(ce + W);             // the other list (ping-pong)
  int* ci2 = (int*)(cd2 + W);
  int* ce2 = ci2 + W;
  int* nb = ce2 + W;                         // [NN] wavefront candidate ids
  int* wslot = nb + NN;                      // [NN] wavefront hash slot
  int* fp = wslot + NN;                      // [NN] fresh positions
  float* sd = (float*)(fp + NN);             // [NS] survivor distances
  int* sp = (int*)(sd + NS);                 // [NS] survivor positions
  int* vis = sp + NS;                        // [HC] visited hash
  int* wkey = vis + HC;                      // [WC] wavefront hash keys
  int* wval = wkey + WC;                     // [WC] last position per key
  __shared__ int sel[32];
  __shared__ int s_nlive, s_nfresh, s_nsurv, s_nfin, s_cqn, s_cqs;
  __shared__ float s_qn;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int qrow = blockIdx.x;
  const int n = p.n, sentinel = p.n;
  constexpr int VW = VEC ? 16 / (int)sizeof(typename Elem<STAGE>::T) : 1;
  const int nu = p.d / VW;
  int lpr = 1;
  while (lpr < 32 && lpr < nu) lpr <<= 1;

  for (int i = tid; i < p.d; i += THREADS) {
    const size_t at = (size_t)qrow * p.d + i;
    if (STAGE == U8) qi[i] = (int)((const uint8_t*)p.queries)[at];
    else if (STAGE == BF16) qf[i] = __bfloat162float(((const __nv_bfloat16*)p.queries)[at]);
    else qf[i] = ((const float*)p.queries)[at];
  }
  if (STAGE == U8 && VEC)
    for (int i = tid; i < p.d / 4; i += THREADS)
      qw[i] = *reinterpret_cast<const uint32_t*>((const uint8_t*)p.queries + (size_t)qrow * p.d + 4 * i);
  for (int i = tid; i < HC; i += THREADS) vis[i] = EMPTY;
  for (int i = tid; i < WC; i += THREADS) { wkey[i] = EMPTY; wval[i] = -1; }
  if (tid == 0) s_nfin = 0;
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
  const Query qr{qf, qi, qw, STAGE == U8 ? s_cqn : 0, STAGE == U8 ? s_cqs : 0};

  // ---- seeding: score the entries, mark them visited, sort them stably ----
  score_rows<STAGE, L2, VEC, ROUNDS>(
      p, qr, nu, lpr, p.e, [&](int j) { return p.entries[j]; },
      [&](int j, float v) { cd2[j] = v; ci2[j] = p.entries[j]; });
  for (int j = tid; j < p.e; j += THREADS) hash_insert(vis, p.hash_log2, p.entries[j]);
  __syncthreads();
  for (int j = tid; j < W; j += THREADS) {
    if (j < p.e) {
      int rank = 0;
      for (int i = 0; i < p.e; ++i) rank += lex_gt(cd2[j], j, cd2[i], i) ? 1 : 0;
      cd[rank] = cd2[j];
      ci[rank] = ci2[j];
      ce[rank] = 0;
      if (isfinite(cd2[j])) atomicAdd(&s_nfin, 1);
    } else {
      cd[j] = CUDART_INF_F;
      ci[j] = sentinel;
      ce[j] = 1;
    }
  }
  __syncthreads();

  // the list is sorted with its finite entries first; n_fin counts them
  int n_fin = s_nfin, n_dist = p.e, hops = 0;
  while (hops < p.n_iters) {
    // ---- wavefront: the first `expand` unexpanded finite entries ----
    if (warp == 0) {
      int found = 0;
      for (int base = 0; base < n_fin && found < p.expand; base += 32) {
        const int i = base + lane;
        unsigned m = __ballot_sync(FULL, i < n_fin && ce[i] == 0);
        while (m && found < p.expand) {
          const int b = __ffs(m) - 1;
          m &= m - 1;
          if (lane == 0) sel[found] = base + b;
          ++found;
        }
      }
      if (lane == 0) { s_nlive = found; s_nfresh = 0; s_nsurv = 0; }
    }
    __syncthreads();
    const int nl = s_nlive;
    if (nl == 0) break;  // converged: nothing live to expand
    if (tid < nl) ce[sel[tid]] = 1;

    // ---- gather neighbours, drop -1 and visited ids, and register each
    //      remaining id's last position in the wavefront hash ----
    for (int q = tid; q < NN; q += THREADS) {
      const int j = q / p.r, rr = q % p.r;
      int id = -1;
      if (j < nl) {
        const int v = ci[sel[j]];
        id = __ldg(p.graph + (size_t)min(max(v, 0), n - 1) * p.r + rr);
        if (id >= 0 && hash_contains(vis, p.hash_log2, id)) id = -1;
      }
      nb[q] = id;
      if (id >= 0) {
        const unsigned s = hash_insert(wkey, p.wave_log2, id);
        wslot[q] = (int)s;
        atomicMax(&wval[s], q);
      }
    }
    __syncthreads();
    // ---- the last occurrence of each id is fresh: mark it visited, and
    //      append it with one atomic per warp ----
    for (int qb = tid - lane; qb < NN; qb += THREADS) {
      const int q = qb + lane;
      const bool win = q < NN && nb[q] >= 0 && wval[wslot[q]] == q;
      const unsigned m = __ballot_sync(FULL, win);
      int at = 0;
      if (lane == 0 && m) at = atomicAdd(&s_nfresh, __popc(m));
      at = __shfl_sync(FULL, at, 0) + __popc(m & ((1u << lane) - 1u));
      if (win) {
        hash_insert(vis, p.hash_log2, nb[q]);
        fp[at] = q;
      }
    }
    __syncthreads();
    const int nf = s_nfresh;
    // ---- score the fresh rows; keep only those that can enter the list:
    //      once it holds W finite entries, fd >= cd[W-1] never can (ties
    //      go to the list) ----
    const float thr = n_fin == W ? cd[W - 1] : CUDART_INF_F;
    score_rows<STAGE, L2, VEC, ROUNDS>(
        p, qr, nu, lpr, nf, [&](int j) { return nb[fp[j]]; },
        [&](int j, float v) {
          if (v < thr) {
            const int at = atomicAdd(&s_nsurv, 1);
            sd[at] = v;
            sp[at] = fp[j];
          }
        });
    for (int i = tid; i < WC; i += THREADS) { wkey[i] = EMPTY; wval[i] = -1; }
    __syncthreads();
    const int ns = s_nsurv;
    // ---- sort the survivors in runs of 64, one warp a run, then put
    //      every list entry and survivor at its rank in the other list
    //      (list first on ties) and swap the two ----
    const int n_runs = (ns + 63) / 64;
    for (int r = warp; r < n_runs; r += WARPS)
      warp_sort64(sd + 64 * r, sp + 64 * r, min(64, ns - 64 * r), lane);
    __syncthreads();
    for (int i = tid; i < n_fin; i += THREADS) {
      int at = i;  // + survivors strictly closer
      for (int r = 0; r < n_runs; ++r)
        at += count_below(sd + 64 * r, min(64, ns - 64 * r), cd[i]);
      if (at < W) { cd2[at] = cd[i]; ci2[at] = ci[i]; ce2[at] = ce[i]; }
    }
    for (int j = tid; j < ns; j += THREADS) {
      const int own = j / 64;
      const float dj = sd[j];
      int at = j - 64 * own;  // + survivors before it in the other runs
      for (int r = 0; r < n_runs; ++r)
        if (r != own) at += count_lex_below(sd + 64 * r, sp + 64 * r, min(64, ns - 64 * r), dj, sp[j]);
      int lo = 0, hi = n_fin;  // + list entries at or below
      while (lo < hi) { const int mid = (lo + hi) >> 1; if (cd[mid] <= dj) lo = mid + 1; else hi = mid; }
      at += lo;
      if (at < W) { cd2[at] = dj; ci2[at] = nb[sp[j]]; ce2[at] = 0; }
    }
    for (int i = n_fin + ns + tid; i < W; i += THREADS) {
      cd2[i] = CUDART_INF_F; ci2[i] = sentinel; ce2[i] = 1;
    }
    __syncthreads();
    float* td = cd; cd = cd2; cd2 = td;
    int* ti = ci; ci = ci2; ci2 = ti;
    int* te = ce; ce = ce2; ce2 = te;
    n_fin = min(W, n_fin + ns);
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
      // one summation order, kernel and plain version alike (ref.py
      // lane_sum): lane l adds t[l], t[l+32], ... in turn, each term and
      // sum rounded once (no FMA), then an xor butterfly over 16..1
      float acc = 0.f;
      for (int i = lane; i < p.dx; i += 32) {
        float t;
        if (L2) { const float df = __fsub_rn(row[i], qx[i]); t = __fmul_rn(df, df); }
        else t = __fmul_rn(row[i], qx[i]);
        acc = __fadd_rn(acc, t);
      }
      for (int o = 16; o > 0; o >>= 1) acc = __fadd_rn(acc, __shfl_xor_sync(FULL, acc, o));
      v = L2 ? acc : -acc;
    }
    if (lane == 0) { sd[j] = v; sp[j] = ok ? ci[j] : 0x7fffffff; }
  }
  __syncthreads();
  const int rk = p.rerank_k;
  for (int j = tid; j < k; j += THREADS) {
    int rank = 0;
    for (int i = 0; i < k; ++i) {
      const bool before = sd[i] < sd[j] || (sd[i] == sd[j] && (sp[i] < sp[j] || (sp[i] == sp[j] && i < j)));
      rank += before ? 1 : 0;
    }
    if (rank < rk) {
      p.out_ids[(size_t)qrow * rk + rank] = sp[j] == 0x7fffffff ? -1 : sp[j];
      p.out_d[(size_t)qrow * rk + rank] = sd[j];
    }
  }
  if (warp == 0) {
    int nv = 0;
    for (int j = lane; j < k; j += 32) nv += sp[j] != 0x7fffffff ? 1 : 0;
    nv = warp_sum_i(nv);
    if (lane == 0) { p.out_nd[qrow] = n_dist; p.out_hops[qrow] = hops; p.out_nrr[qrow] = nv; }
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// The kernel a launch of nq queries takes: for f32 rows, more rows in
// flight per query when all of them fit two to an SM; more queries per SM
// otherwise.  bf16 and uint8 rounds already hold 2 and 4 rows a warp, and
// eight rounds did not make them faster.
bool wide(int nq) { return nq <= 2 * sm_count(); }

template <int STAGE, bool L2, bool VEC, int ROUNDS>
int launch_rounds(const Params& p, int nq, size_t smem, cudaStream_t s) {
  static size_t smem_set = 48 * 1024;  // dynamic shared memory allowed so far
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(beam_kernel<STAGE, L2, VEC, ROUNDS>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  beam_kernel<STAGE, L2, VEC, ROUNDS><<<nq, THREADS, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <int STAGE, bool L2, bool VEC>
int launch(const Params& p, int nq, size_t smem, cudaStream_t s) {
  if constexpr (STAGE == F32)
    if (wide(nq)) return launch_rounds<STAGE, L2, VEC, 8>(p, nq, smem, s);
  return launch_rounds<STAGE, L2, VEC, 4>(p, nq, smem, s);
}

template <int STAGE, bool L2, bool VEC, int ROUNDS>
int occupancy_rounds(size_t smem) {
  int blocks = 0;
  cudaError_t err = cudaFuncSetAttribute(beam_kernel<STAGE, L2, VEC, ROUNDS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, beam_kernel<STAGE, L2, VEC, ROUNDS>,
                                                        THREADS, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

template <int STAGE, bool L2, bool VEC>
int occupancy(int nq, size_t smem) {
  if constexpr (STAGE == F32)
    if (wide(nq)) return occupancy_rounds<STAGE, L2, VEC, 8>(smem);
  return occupancy_rounds<STAGE, L2, VEC, 4>(smem);
}

// Rows of `d` elements of the stage's type can be read in 16-byte units.
bool use_vec(int stage, int d, const void* x) {
  const int size = stage == F32 ? 4 : stage == BF16 ? 2 : 1;
  return (d * size) % 16 == 0 && (uintptr_t)x % 16 == 0;
}

// one case per (stage, metric, vector loads)
#define REPRO_BEAM_CASES(FN, ...)                                                     \
  switch ((stage * 2 + metric_ip) * 2 + (vec ? 1 : 0)) {                              \
    case 0: return FN<F32, true, false>(__VA_ARGS__);                                 \
    case 1: return FN<F32, true, true>(__VA_ARGS__);                                  \
    case 2: return FN<F32, false, false>(__VA_ARGS__);                                \
    case 3: return FN<F32, false, true>(__VA_ARGS__);                                 \
    case 4: return FN<BF16, true, false>(__VA_ARGS__);                                \
    case 5: return FN<BF16, true, true>(__VA_ARGS__);                                 \
    case 6: return FN<BF16, false, false>(__VA_ARGS__);                               \
    case 7: return FN<BF16, false, true>(__VA_ARGS__);                                \
    case 8: return FN<U8, true, false>(__VA_ARGS__);                                  \
    case 9: return FN<U8, true, true>(__VA_ARGS__);                                   \
    case 10: return FN<U8, false, false>(__VA_ARGS__);                                \
    case 11: return FN<U8, false, true>(__VA_ARGS__);                                 \
  }

}  // namespace

// slots: max(expand * R, width), the most survivors of a trip or re-rank keys
extern "C" size_t repro_beam_smem(int d, int width, int nn, int slots,
                                  int hash_log2, int wave_log2) {
  return sizeof(int) * ((size_t)d + ((size_t)d + 3) / 4 + 6 * (size_t)width
                        + 3 * (size_t)nn + 2 * (size_t)slots
                        + ((size_t)1 << hash_log2) + 2 * ((size_t)1 << wave_log2));
}

// Resident blocks (queries) per SM of the kernel a launch of nq queries
// takes, at `smem` bytes, for rows that are 16-byte aligned when `vec` is
// set.
extern "C" int repro_beam_occupancy(int stage, int metric_ip, int vec, int nq, size_t smem) {
  REPRO_BEAM_CASES(occupancy, nq, smem)
  return -(int)cudaErrorInvalidValue;
}

extern "C" int repro_fused_beam(
    const void* x, const int* graph, const int* entries, const void* queries,
    const float* xnorm, const int* xcnorm, const int* xcsum,
    const float* x_exact, const float* q_exact,
    int* out_ids, float* out_d, int* out_nd, int* out_hops, int* out_nrr,
    int n, int d, int r, int e, int nq, int width, int k, int rerank_k,
    int n_iters, int expand, int dx, int metric_ip, int stage,
    float scale, float zp, int hash_log2, int wave_log2, int slots,
    void* stream) {
  if (expand > 32 || width < 1 || k > width || hash_log2 < 1 || hash_log2 > 30)
    return (int)cudaErrorInvalidValue;
  Params p{x, graph, entries, queries, xnorm, xcnorm, xcsum, x_exact, q_exact,
           out_ids, out_d, out_nd, out_hops, out_nrr,
           n, d, r, e, width, k, rerank_k, n_iters, expand, dx,
           scale, zp, hash_log2, wave_log2, slots};
  const size_t smem = repro_beam_smem(d, width, expand * r, slots, hash_log2, wave_log2);
  cudaStream_t s = (cudaStream_t)stream;
  if (nq == 0) return 0;
  const bool vec = use_vec(stage, d, x);
  REPRO_BEAM_CASES(launch, p, nq, smem, s)
  return (int)cudaErrorInvalidValue;
}
