// Exact kNN (distance tiles + threshold-filtered top-k, split over N) for
// Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel repro/kernels/topk.py knn_pallas (_knn_kernel,
// merge_topk): [M,D] queries x [N,D] points, f32 -> the k smallest
// distances per query, ascending, as ([M,k] f32, [M,k] int32).  L2 is
// max(|q|^2 + |x|^2 - 2 q.x, 0) and IP is -q.x, both in FP32 FMAs (no TF32,
// no tensor cores: the reference is exact f32).  Ties break by (distance,
// index); columns at or beyond n are never candidates; when k > n the tail
// pads with (inf, -1).  1 <= k <= 256.
//
// What bounds it on an H100: 2*M*N*D FLOPs against (M+N)*D inputs and
// 2*M*k outputs, so FP32 operations (67 TFLOP/s outside the tensor cores):
// 2.4 ms at M=4096, N=156250, D=128.  The distance loop reaches about half
// of that rate with one block of 8 warps per SM; the filter and merges add
// about half again at k = 129 (PERF.md).
//
// Design.
//   * Split N across blocks so the card fills: the grid is (row blocks of
//     BM = 8*RW queries, S column spans).  repro_knn_splits picks the fewest
//     spans that give every SM a block and fill the last wave to 90%: a
//     span's top-k lists warm up from empty, so once the card is full more
//     spans only cost time.  Each block writes the sorted top-k of its span
//     to scratch, and knn_merge merges the S sorted lists of a row by rank
//     (each entry's rank is its index plus the count of lexicographically
//     smaller entries in the other lists).  With S = 1 the block writes the
//     output directly.
//   * Register-tiled distance tile: 256 threads, warp w owns query rows
//     RW*w .. RW*w+RW-1, lane l owns columns l, l+32, l+64, l+96 of a
//     128-column tile, so a thread holds an RW x 4 patch (8 x 4 at BM = 64).
//     The Q panel stays in shared memory for the whole block (broadcast
//     float4 reads); x streams through a 3-stage ring of [128][32+4]-float
//     chunks filled by cp.async, one barrier a chunk (the 4-float pad puts
//     a quarter-warp's float4 reads on distinct banks).  Row norms come from
//     the Q panel; column norms from one pass of sq_norms over x first.
//   * Threshold filter instead of per-column insertion: each row keeps tau,
//     its current k-th distance (+inf until it holds k), in the registers
//     of the warp that owns it.  After each tile one vote per row finds the
//     rows with a column d <= tau, and their passes append to the row's
//     candidate buffer in shared memory (ballot + popc, no atomics).  A
//     merge sorts a buffer (bitonic, in registers) and merges it with the
//     row's sorted list by rank, keeping k and updating tau.  Merges are
//     block-wide events: when any row would overflow its buffer, every row
//     at least half full merges at the same barrier, so the warps merge
//     side by side rather than each stalling the block at another tile.
//     After the first tiles almost nothing passes.
//   * Why the tie rule is exact whatever the order of arrival: every sort and
//     merge orders by (distance, index) lexicographically, and all indices
//     are distinct, so the list after a merge is the exact (distance, index)
//     top-k of everything admitted so far.  A column is refused only when
//     d > tau, i.e. when k admitted entries are lexicographically smaller;
//     a column is dropped at a merge only when k entries are smaller.  Such
//     a column cannot be in the top-k of the span, nor of the row, since the
//     span lists and the final merge use the same order.  Admitting d == tau
//     keeps a column of equal distance but smaller index in the running
//     (across spans, and inside a buffer, arrival order says nothing).
//   * Shared memory, 4 bytes each: Q panel BM*(Dp+4) (Dp = D rounded up to
//     32), x ring 3*128*36, lists 2*BM*k, buffers 2*BM*128.  At D = 128,
//     k = 129, BM = 64: 33 + 55 + 66 + 66 KB = 221 KB, one block per SM;
//     where that exceeds the 227 KB a block may take (k = 256), BM drops to
//     32.  The wrapper raises when neither fits.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

extern __shared__ float4 smem4[];  // every kernel's dynamic shared memory

namespace {

constexpr int BN = 128;       // columns per tile
constexpr int KC = 32;        // depth per x chunk
constexpr int XS = KC + 4;    // padded x chunk row, floats
constexpr int STAGES = 3;     // x chunks in flight
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CAP = 128;      // candidate buffer per row (one tile's worth)
constexpr int KMAX = 256;
constexpr int MAX_SPLITS = 32;
constexpr size_t SMEM_LIMIT = 232448;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// (d, i) < (e, j) lexicographically; indices compare unsigned, so the
// padding index -1 sorts after every real index.
__device__ __forceinline__ bool lex_less(float d, unsigned i, float e, unsigned j) {
  return d < e || (d == e && i < j);
}

// Entries of the sorted [0, len) array (ad, ai) lexicographically below
// (d, i), len <= MAXLEN (a power of two): a fixed number of halving steps, so
// a lane's independent searches overlap.
template <int MAXLEN>
__device__ __forceinline__ int lower_bound(const float* ad, const int* ai, int len,
                                           float d, unsigned i) {
  int pos = 0;
#pragma unroll
  for (int step = MAXLEN; step > 0; step >>= 1) {
    const int p = pos + step;
    if (p <= len && lex_less(ad[p - 1], (unsigned)ai[p - 1], d, i)) pos = p;
  }
  return pos;
}

// The block's shared memory: Q panel [bm][dp+4], x ring [STAGES][BN][XS],
// sorted lists [bm][k] (distances, then ids), candidate buffers [bm][CAP]
// (distances, then ids), list lengths [bm].
struct Layout {
  float* qs;
  float* xs;
  float* ld;
  int* li;
  float* bd;
  int* bi;
  int* n_list;
  __device__ __forceinline__ Layout(int bm, int qstride, int k) {
    qs = reinterpret_cast<float*>(smem4);
    xs = qs + bm * qstride;
    ld = xs + STAGES * BN * XS;
    li = reinterpret_cast<int*>(ld + bm * k);
    bd = reinterpret_cast<float*>(li + bm * k);
    bi = reinterpret_cast<int*>(bd + bm * CAP);
    n_list = bi + bm * CAP;
  }
};

// Sort row r's `cnt` buffered candidates and merge them into the row's
// sorted list, keeping the k smallest by (distance, index); returns the new
// tau.  Called by a whole warp.
__device__ __noinline__ float merge_row(int r, int cnt, int bm, int qstride, int k) {
  const Layout L(bm, qstride, k);
  float* bd = L.bd + r * CAP;
  int* bi = L.bi + r * CAP;
  float* ld = L.ld + r * k;
  int* li = L.li + r * k;
  const int lane = threadIdx.x % 32;
  const int lc = L.n_list[r];
  float kd[CAP / 32];
  unsigned ki[CAP / 32];
#pragma unroll
  for (int u = 0; u < CAP / 32; ++u) {
    const int e = lane + 32 * u;
    kd[u] = e < cnt ? bd[e] : CUDART_INF_F;
    ki[u] = e < cnt ? (unsigned)bi[e] : 0xffffffffu;
  }
  // bitonic sort of CAP entries; entry e = lane + 32u
#pragma unroll
  for (int size = 2; size <= CAP; size <<= 1) {
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) {
      if (j >= 32) {
#pragma unroll
        for (int u = 0; u < CAP / 32; ++u) {
          const int w = u ^ (j >> 5);
          if (w <= u) continue;
          const bool asc = ((lane + 32 * u) & size) == 0;
          const bool swap = asc ? lex_less(kd[w], ki[w], kd[u], ki[u])
                                : lex_less(kd[u], ki[u], kd[w], ki[w]);
          if (swap) {
            const float td = kd[u]; kd[u] = kd[w]; kd[w] = td;
            const unsigned ti = ki[u]; ki[u] = ki[w]; ki[w] = ti;
          }
        }
      } else {
#pragma unroll
        for (int u = 0; u < CAP / 32; ++u) {
          const int e = lane + 32 * u;
          const float pd = __shfl_xor_sync(FULL, kd[u], j);
          const unsigned pi = __shfl_xor_sync(FULL, ki[u], j);
          const bool lower = (e & j) == 0, asc = (e & size) == 0;
          // the lower position of an ascending pair keeps the smaller entry
          const bool take = (lower == asc) ? lex_less(pd, pi, kd[u], ki[u])
                                           : lex_less(kd[u], ki[u], pd, pi);
          if (take) { kd[u] = pd; ki[u] = pi; }
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < CAP / 32; ++u) {
    bd[lane + 32 * u] = kd[u];
    bi[lane + 32 * u] = (int)ki[u];
  }
  __syncwarp();
  // ranks in the merged order; all (d, idx) are distinct
  float hd[KMAX / 32];
  unsigned hi[KMAX / 32];
  int hr[KMAX / 32];
#pragma unroll
  for (int u = 0; u < KMAX / 32; ++u) {
    const int i = lane + 32 * u;
    hd[u] = 0.f;
    hi[u] = 0u;
    hr[u] = k;
    if (i < lc) {
      hd[u] = ld[i];
      hi[u] = (unsigned)li[i];
      hr[u] = i + lower_bound<CAP>(bd, bi, cnt, hd[u], hi[u]);
    }
  }
  int br[CAP / 32];
#pragma unroll
  for (int u = 0; u < CAP / 32; ++u) {
    const int e = lane + 32 * u;
    br[u] = e < cnt ? e + lower_bound<KMAX>(ld, li, lc, kd[u], ki[u]) : k;
  }
  __syncwarp();
#pragma unroll
  for (int u = 0; u < KMAX / 32; ++u)
    if (hr[u] < k) { ld[hr[u]] = hd[u]; li[hr[u]] = (int)hi[u]; }
#pragma unroll
  for (int u = 0; u < CAP / 32; ++u)
    if (br[u] < k) { ld[br[u]] = kd[u]; li[br[u]] = (int)ki[u]; }
  __syncwarp();
  const int n_new = min(k, lc + cnt);
  const float tau = n_new == k ? ld[k - 1] : CUDART_INF_F;
  if (lane == 0) L.n_list[r] = n_new;
  __syncwarp();
  return tau;
}

size_t split_smem(int rw, int d, int k) {
  const size_t bm = 8 * (size_t)rw, dp = (size_t)(d + KC - 1) / KC * KC;
  return sizeof(float) * (bm * (dp + 4) + STAGES * BN * XS + 2 * bm * k + 2 * bm * CAP)
         + sizeof(int) * bm;
}

// |x_c|^2 for every row c of x: one warp per row.
__global__ void __launch_bounds__(THREADS)
sq_norms(const float* __restrict__ x, float* __restrict__ xn, int n, int d) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= n) return;
  const float* xr = x + (size_t)row * d;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s = fmaf(xr[c], xr[c], s);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  if (lane == 0) xn[row] = s;
}

template <int RW, bool L2>
__global__ void __launch_bounds__(THREADS)
knn_split(const float* __restrict__ q, const float* __restrict__ x,
          const float* __restrict__ xn, float* __restrict__ part_d,
          int* __restrict__ part_i, int m, int n, int d, int k, int span, int vec) {
  constexpr int BM = 8 * RW;
  const int dp = (d + KC - 1) / KC * KC, qstride = dp + 4;
  const Layout L(BM, qstride, k);
  float* qs = L.qs;
  float* xs = L.xs;
  float* bd = L.bd;
  int* bi = L.bi;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row0 = blockIdx.x * BM;
  const int c_lo = blockIdx.y * span, c_hi = min(n, c_lo + span);
  const int n_chunks = dp / KC;
  const int n_steps = c_hi > c_lo ? (c_hi - c_lo + BN - 1) / BN * n_chunks : 0;

  for (int i = tid; i < BM * dp; i += THREADS) {
    const int r = i / dp, c = i % dp;
    qs[r * qstride + c] = (row0 + r < m && c < d) ? q[(size_t)(row0 + r) * d + c] : 0.f;
  }
  for (int r = tid; r < BM; r += THREADS) L.n_list[r] = 0;

  auto issue = [&](int step) {
    const int col0 = c_lo + step / n_chunks * BN, k0 = step % n_chunks * KC;
    float* dst = xs + step % STAGES * BN * XS;
    if (vec) {
      for (int i = tid; i < BN * KC / 4; i += THREADS) {
        const int r = i / (KC / 4), p = i % (KC / 4), gc = col0 + r, gk = k0 + 4 * p;
        const bool ok = gc < c_hi && gk < d;
        cp_async16(dst + r * XS + 4 * p, ok ? x + (size_t)gc * d + gk : x, ok);
      }
    } else {
      for (int i = tid; i < BN * KC; i += THREADS) {
        const int r = i / KC, p = i % KC, gc = col0 + r, gk = k0 + p;
        const bool ok = gc < c_hi && gk < d;
        cp_async4(dst + r * XS + p, ok ? x + (size_t)gc * d + gk : x, ok);
      }
    }
  };

  for (int pre = 0; pre < STAGES - 1; ++pre) {
    if (pre < n_steps) issue(pre);
    cp_async_commit();
  }
  __syncthreads();
  float qn[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const float* qr = qs + (warp * RW + i) * qstride;
    float s = 0.f;
    for (int c = lane; c < dp; c += 32) s = fmaf(qr[c], qr[c], s);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
    qn[i] = s;
  }

  float acc[RW][4], xnv[4];
  float tau[RW];  // the warp's rows' thresholds and buffer fills
  int n_buf[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    tau[i] = CUDART_INF_F;
    n_buf[i] = 0;
  }
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk `step` landed; chunk step-1's stage is free
    if (step + STAGES - 1 < n_steps) issue(step + STAGES - 1);
    cp_async_commit();
    const int ch = step % n_chunks;
    const int col0 = c_lo + step / n_chunks * BN;
    if (ch == 0) {
#pragma unroll
      for (int i = 0; i < RW; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // read now, used after the tile's last chunk
        const int c = col0 + lane + 32 * j;
        xnv[j] = (L2 && c < c_hi) ? xn[c] : 0.f;
      }
    }
    const float* xt = xs + step % STAGES * BN * XS;
    const float* qb = qs + warp * RW * qstride + ch * KC;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 4) {
      float4 b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const float4*>(xt + (lane + 32 * j) * XS + kk);
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(qb + i * qstride + kk);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(a.x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a.y, b[j].y, acc[i][j]);
          acc[i][j] = fmaf(a.z, b[j].z, acc[i][j]);
          acc[i][j] = fmaf(a.w, b[j].w, acc[i][j]);
        }
      }
    }
    if (ch != n_chunks - 1) continue;

    // Epilogue of one column tile.  Each warp checks its rows against tau
    // (tau and the buffer fill live in registers): one vote on the lane's
    // nearest column first, the per-column count only for a row that has a
    // pass.  If any row of the block would overflow its buffer, every row at
    // least half full merges now, so the warps merge side by side at one
    // barrier instead of each stalling the block at a different tile.  Then
    // the passes append.
    float dv[RW][4];
    int passed[RW];
    bool overflow = false;
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const bool live = row0 + warp * RW + i < m;
      float nearest = CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dv[i][j] = L2 ? fmaxf(qn[i] + xnv[j] - 2.f * acc[i][j], 0.f) : -acc[i][j];
        if (col0 + lane + 32 * j >= c_hi) dv[i][j] = CUDART_NAN_F;  // never passes
        nearest = fminf(nearest, dv[i][j]);
      }
      passed[i] = 0;
      if (__any_sync(FULL, live && nearest <= tau[i])) {
#pragma unroll
        for (int j = 0; j < 4; ++j) passed[i] += __popc(__ballot_sync(FULL, dv[i][j] <= tau[i]));
      }
      overflow |= n_buf[i] + passed[i] > CAP;
    }
    if (__syncthreads_or(overflow)) {
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        if (n_buf[i] + passed[i] <= CAP && n_buf[i] < CAP / 2) continue;
        tau[i] = merge_row(warp * RW + i, n_buf[i], BM, qstride, k);
        n_buf[i] = 0;
      }
    }
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      if (passed[i] == 0) continue;
      const int r = warp * RW + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = col0 + lane + 32 * j;
        const bool pass = dv[i][j] <= tau[i];
        const unsigned msk = __ballot_sync(FULL, pass);
        if (pass) {
          const int pos = n_buf[i] + __popc(msk & below);
          bd[r * CAP + pos] = dv[i][j];
          bi[r * CAP + pos] = c;
        }
        n_buf[i] += __popc(msk);
      }
    }
  }

  // flush the buffers, then write each row's sorted span list, padded
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int r = warp * RW + i, gr = row0 + r;
    if (gr >= m) continue;
    if (n_buf[i] > 0) merge_row(r, n_buf[i], BM, qstride, k);
    const int nl = L.n_list[r];
    const size_t base = ((size_t)blockIdx.y * m + gr) * k;
    for (int j = lane; j < k; j += 32) {
      part_d[base + j] = j < nl ? L.ld[r * k + j] : CUDART_INF_F;
      part_i[base + j] = j < nl ? L.li[r * k + j] : -1;
    }
  }
}

// Merge the S sorted span lists of one row (blockIdx.x) into its top k.
__global__ void __launch_bounds__(128)
knn_merge(const float* __restrict__ part_d, const int* __restrict__ part_i,
          float* __restrict__ out_d, int* __restrict__ out_i, int m, int k, int splits) {
  float* sd = reinterpret_cast<float*>(smem4);  // [splits][k]
  int* si = reinterpret_cast<int*>(sd + splits * k);
  const int row = blockIdx.x, total = splits * k;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const size_t g = ((size_t)(e / k) * m + row) * k + e % k;
    sd[e] = part_d[g];
    si[e] = part_i[g];
  }
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    out_d[(size_t)row * k + j] = CUDART_INF_F;
    out_i[(size_t)row * k + j] = -1;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int idx = si[e];
    if (idx < 0) continue;  // padding: ranks only real entries
    const int s = e / k, i = e % k;
    const float dv = sd[e];
    int rank = i;
    for (int o = 0; o < splits && rank < k; ++o)
      if (o != s) rank += lower_bound<KMAX>(sd + o * k, si + o * k, k, dv, (unsigned)idx);
    if (rank < k) {
      out_d[(size_t)row * k + rank] = dv;
      out_i[(size_t)row * k + rank] = idx;
    }
  }
}

template <int RW, bool L2>
int launch_split(const float* q, const float* x, const float* xn, float* pd, int* pi,
                 int m, int n, int d, int k, int splits, int vec, cudaStream_t st) {
  const size_t smem = split_smem(RW, d, k);
  cudaError_t err = cudaFuncSetAttribute(
      knn_split<RW, L2>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int span = (n + splits - 1) / splits;
  dim3 grid((m + 8 * RW - 1) / (8 * RW), splits);
  knn_split<RW, L2><<<grid, THREADS, smem, st>>>(q, x, xn, pd, pi, m, n, d, k, span, vec);
  return (int)cudaGetLastError();
}

int pick_rw(int d, int k) {
  if (split_smem(8, d, k) <= SMEM_LIMIT) return 8;
  if (split_smem(4, d, k) <= SMEM_LIMIT) return 4;
  return 0;
}

}  // namespace

// Column spans per row block for an [m,d] x [n,d] search with this k: the
// fewest spans that give at least one block per resident slot on the card
// and fill the last wave to 90% (else the best-filled count up to twice
// that); 0 when D and k do not fit one block's shared memory.  Each span
// costs its own warm-up of the top-k lists, so fewer spans are faster once
// the card is full.
extern "C" int repro_knn_splits(int m, int n, int d, int k) {
  const int rw = pick_rw(d, k);
  if (rw == 0 || k < 1 || k > KMAX) return 0;
  int dev = 0, sms = 132, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t smem = split_smem(rw, d, k);
  if (rw == 8) {
    cudaFuncSetAttribute(knn_split<8, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, knn_split<8, true>, THREADS, smem);
  } else {
    cudaFuncSetAttribute(knn_split<4, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, knn_split<4, true>, THREADS, smem);
  }
  const long slots = (long)sms * (per_sm > 0 ? per_sm : 1);
  const long row_blocks = std::max(1L, (m + 8L * rw - 1) / (8L * rw));
  // a span keeps at least 4 tiles and k columns; at most MAX_SPLITS spans
  const long most = std::min<long>(MAX_SPLITS, std::max<long>(1, n / std::max(4 * BN, k)));
  const long least = std::min<long>(most, (slots + row_blocks - 1) / row_blocks);
  long best = least;
  double best_fill = 0.0;
  for (long s = least; s <= std::min(most, 2 * least); ++s) {
    const long blocks = row_blocks * s, waves = (blocks + slots - 1) / slots;
    const double fill = (double)blocks / (double)(waves * slots);
    if (fill >= 0.9) return (int)s;
    if (fill > best_fill) { best_fill = fill; best = s; }
  }
  return (int)best;
}

// part_d/part_i: [splits, m, k] scratch (unused when splits == 1); xn: [n]
// scratch for L2.  Launches sq_norms (L2), knn_split, and knn_merge when
// splits > 1; returns the first launch error.
extern "C" int repro_knn(const float* q, const float* x, float* xn, float* part_d,
                         int* part_i, float* out_d, int* out_i, int m, int n, int d,
                         int k, int metric_ip, int splits, void* stream) {
  if (k < 1 || k > KMAX || splits < 1) return (int)cudaErrorInvalidValue;
  const int rw = pick_rw(d, k);
  if (rw == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool l2 = !metric_ip;
  if (l2 && n > 0) {
    sq_norms<<<(n + WARPS - 1) / WARPS, THREADS, 0, st>>>(x, xn, n, d);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  float* pd = splits > 1 ? part_d : out_d;
  int* pi = splits > 1 ? part_i : out_i;
  const int vec = d % 4 == 0 && (uintptr_t)x % 16 == 0;
  int rc;
  if (rw == 8)
    rc = l2 ? launch_split<8, true>(q, x, xn, pd, pi, m, n, d, k, splits, vec, st)
            : launch_split<8, false>(q, x, xn, pd, pi, m, n, d, k, splits, vec, st);
  else
    rc = l2 ? launch_split<4, true>(q, x, xn, pd, pi, m, n, d, k, splits, vec, st)
            : launch_split<4, false>(q, x, xn, pd, pi, m, n, d, k, splits, vec, st);
  if (rc != 0 || splits == 1) return rc;
  const size_t smem = (size_t)splits * k * (sizeof(float) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(knn_merge, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  knn_merge<<<m, 128, smem, st>>>(part_d, part_i, out_d, out_i, m, k, splits);
  return (int)cudaGetLastError();
}
