// Exact kNN (distance tile + running top-k) for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces the TPU kernel repro/kernels/topk.py knn_pallas (_knn_kernel,
// merge_topk): [M,D] queries x [N,D] points, f32 -> the k smallest
// distances per query, ascending, as ([M,k] f32, [M,k] int32).  Ties break
// by (distance, index); columns at or beyond n are never candidates; when
// k > n the tail pads with (inf, -1).
//
// What bounds it on an H100: 2*M*N*D FLOPs of f32 distance work against
// (M+N)*D inputs and 2*M*k outputs, so FP32 operations (67 TFLOP/s outside
// the tensor cores; no TF32).  Design: a block owns BM=32 query rows, keeps
// them resident in shared memory, and walks x in column tiles of BN=64,
// streaming D through shared memory in chunks of 32.  Each tile's
// distances land in shared memory, and one warp per row merges them into
// that row's sorted top-k list, also in shared memory (k <= 256).  Columns
// arrive in increasing index order, so a new column beats an incumbent of
// equal distance never: it enters only when strictly below the current
// k-th distance, at the position after every incumbent of distance <= its
// own, which is exactly the (distance, index) order.  A warp ballot
// rejects most columns of a tile at once; an accepted one is placed by a
// binary search and a one-slot shift of the tail across the warp's lanes.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;
constexpr int BN = 64;
constexpr int KC = 32;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KMAX = 256;
constexpr unsigned FULL = 0xffffffffu;

template <bool L2>
__global__ void __launch_bounds__(THREADS)
knn_kernel(const float* __restrict__ q, const float* __restrict__ x,
           float* __restrict__ out_d, int* __restrict__ out_i,
           int m, int n, int d, int k) {
  extern __shared__ float smem[];
  const int qstride = d + 1;
  float* qsh = smem;                          // [BM][d+1]
  float* xs = qsh + BM * qstride;             // [KC][BN+1]
  float* dt = xs + KC * (BN + 1);             // [BM][BN+1] tile distances
  float* qn = dt + BM * (BN + 1);             // [BM]
  float* tk_d = qn + BM;                      // [BM][k]
  int* tk_i = (int*)(tk_d + BM * k);          // [BM][k]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tx = tid % 16, ty = tid / 16;     // 2 rows x 4 cols per thread
  const int row0 = blockIdx.x * BM;

  for (int i = tid; i < BM * d; i += THREADS) {
    const int r = i / d, c = i % d, gr = row0 + r;
    qsh[r * qstride + c] = gr < m ? q[(size_t)gr * d + c] : 0.f;
  }
  __syncthreads();
  if (L2) {
    for (int r = warp; r < BM; r += WARPS) {
      float s = 0.f;
      for (int c = lane; c < d; c += 32) s = fmaf(qsh[r * qstride + c], qsh[r * qstride + c], s);
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
      if (lane == 0) qn[r] = s;
    }
  }
  int cnt[BM / WARPS];                        // filled length of each owned row
  for (int t = 0; t < BM / WARPS; ++t) cnt[t] = 0;
  __syncthreads();

  for (int col0 = 0; col0 < n; col0 += BN) {
    float acc[2][4] = {};
    float xn[4] = {};
    for (int k0 = 0; k0 < d; k0 += KC) {
      for (int i = tid; i < BN * KC; i += THREADS) {
        const int c = i / KC, kk = i % KC, gc = col0 + c, gk = k0 + kk;
        xs[kk * (BN + 1) + c] = (gc < n && gk < d) ? x[(size_t)gc * d + gk] : 0.f;
      }
      __syncthreads();
      const int kend = min(KC, d - k0);
      for (int kk = 0; kk < kend; ++kk) {
        const float a0 = qsh[ty * qstride + k0 + kk];
        const float a1 = qsh[(ty + 16) * qstride + k0 + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float b = xs[kk * (BN + 1) + tx + 16 * j];
          acc[0][j] = fmaf(a0, b, acc[0][j]);
          acc[1][j] = fmaf(a1, b, acc[1][j]);
          if (L2) xn[j] = fmaf(b, b, xn[j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float v = L2 ? fmaxf(qn[r] + xn[j] - 2.f * acc[i][j], 0.f) : -acc[i][j];
        dt[r * (BN + 1) + c] = (col0 + c < n) ? v : CUDART_INF_F;
      }
    }
    __syncthreads();

    // one warp per row: merge this tile's columns into the row's top-k
    for (int t = 0; t < BM / WARPS; ++t) {
      const int r = warp * (BM / WARPS) + t;
      float* rd = tk_d + r * k;
      int* ri = tk_i + r * k;
      int c_len = cnt[t];
      for (int base = 0; base < BN; base += 32) {
        const int c = base + lane;
        const float v = dt[r * (BN + 1) + c];
        const bool ok = (col0 + c < n) && (c_len < k || v < rd[k - 1]);
        unsigned mask = __ballot_sync(FULL, ok);
        while (mask) {
          const int src = __ffs(mask) - 1;
          mask &= mask - 1;
          const float dv = __shfl_sync(FULL, v, src);
          if (!(c_len < k || dv < rd[k - 1])) continue;
          int lo = 0, hi = c_len;             // first incumbent with rd > dv
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (rd[mid] <= dv) lo = mid + 1; else hi = mid;
          }
          const int last = min(c_len, k - 1);  // [lo, last) shifts right by one
          float sv[KMAX / 32];
          int si[KMAX / 32];
#pragma unroll
          for (int u = 0; u < KMAX / 32; ++u) {
            const int idx = lo + lane + 32 * u;
            if (idx < last) { sv[u] = rd[idx]; si[u] = ri[idx]; }
          }
          __syncwarp();
#pragma unroll
          for (int u = 0; u < KMAX / 32; ++u) {
            const int idx = lo + lane + 32 * u;
            if (idx < last) { rd[idx + 1] = sv[u]; ri[idx + 1] = si[u]; }
          }
          if (lane == 0) { rd[lo] = dv; ri[lo] = col0 + base + src; }
          __syncwarp();
          c_len = min(c_len + 1, k);
        }
      }
      cnt[t] = c_len;
    }
    __syncthreads();
  }

  for (int t = 0; t < BM / WARPS; ++t) {
    const int r = warp * (BM / WARPS) + t, gr = row0 + r;
    if (gr >= m) continue;
    for (int j = lane; j < k; j += 32) {
      const bool have = j < cnt[t];
      out_d[(size_t)gr * k + j] = have ? tk_d[r * k + j] : CUDART_INF_F;
      out_i[(size_t)gr * k + j] = have ? tk_i[r * k + j] : -1;
    }
  }
}

}  // namespace

extern "C" size_t repro_knn_smem(int d, int k) {
  return sizeof(float) * ((size_t)BM * (d + 1) + KC * (BN + 1) + BM * (BN + 1) + BM)
       + (sizeof(float) + sizeof(int)) * (size_t)BM * k;
}

extern "C" int repro_knn(const float* q, const float* x, float* out_d, int* out_i,
                         int m, int n, int d, int k, int metric_ip, void* stream) {
  if (k < 1 || k > KMAX) return (int)cudaErrorInvalidValue;
  const size_t smem = repro_knn_smem(d, k);
  cudaError_t err;
  if (metric_ip) {
    err = cudaFuncSetAttribute(knn_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    knn_kernel<false><<<(m + BM - 1) / BM, THREADS, smem, (cudaStream_t)stream>>>(
        q, x, out_d, out_i, m, n, d, k);
  } else {
    err = cudaFuncSetAttribute(knn_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    knn_kernel<true><<<(m + BM - 1) / BM, THREADS, smem, (cudaStream_t)stream>>>(
        q, x, out_d, out_i, m, n, d, k);
  }
  return (int)cudaGetLastError();
}
