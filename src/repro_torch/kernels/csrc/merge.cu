// Merge of shard graphs into the global graph, one block a global id, for
// Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces no TPU kernel: the reference merges on the host in numpy
// (repro/core/merge.py _union_dedup_cap: one global (gid, neighbour) sort
// for the dedup, one (gid, distance, first-seen) sort for the degree cap).
// That sort ignores the structure of the work: a vector lies in at most
// omega shards, so its merged row comes from at most omega * W candidates,
// its own shard rows in shard order.  Here each row is its own small problem.
//
// Per global id g (one block of 128 threads):
//   1. gather the candidates in first-seen order, shard order then slot
//      order: the rows row_of[row_ptr[g] .. row_ptr[g+1]) of nbr, with -1
//      pads and g itself dropped;
//   2. keep the first occurrence of each id (each slot compares itself with
//      the slots before it), then compact in order (one warp, ballots);
//   3. squared L2 of each unique candidate to x[g], one warp a candidate, the
//      row read as float4 (element loads where D % 4 != 0 or rows are not
//      16-byte aligned), summed in FP32 on the CUDA cores in one fixed
//      order: lane l takes float4 units l, l+32, ... and adds each unit's
//      four squares in turn, then an xor butterfly over 16..1, every
//      operation rounded once (no FMA, no TF32, no norm expansion).
//      ref.py merge_rows_plain sums the same way (lane_sum, vec=4): kernel
//      and plain version agree bit for bit.  NaN ranks as +inf;
//   4. rank each unique candidate by (distance, position) by counting, and
//      write ranks < degree to the output row, -1 after the last.
//   Without x (null) the rank is the position: first-seen order.
//
// What bounds it on an H100: per row, ~90 unique candidates of 512 bytes at
// D = 128 (ScaleGANN at omega = 2, R = 64), ~4.6 GB of row reads for 100,000
// rows, most of them hits in the 50 MB L2 (the points are 51 MB); a few
// milliseconds, against the host merge's seconds.
//
// Shared memory, per block: the row's own vector (D rounded up to 4 floats),
// then for each of `cap` candidate slots an id, a distance and a flag:
// 4 * Dp + 9 * cap bytes.  cap is the largest entries x W of any row; the
// wrapper raises where a block's 227 KB do not hold it (at D = 128, cap up to
// 25,656: omega <= 8 at W = 64 needs 512).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
// dynamic shared memory one block may take on Hopper, less the static s_u
constexpr size_t SMEM_LIMIT = 232448 - 1024;

size_t smem_bytes(int cap, int d) {
  const size_t dp = ((size_t)d + 3) & ~(size_t)3;
  return 4 * dp + 9 * (size_t)cap;
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    merge_rows_kernel(const float* __restrict__ x, int d, const int* __restrict__ nbr,
                      int w, const int* __restrict__ row_ptr,
                      const int* __restrict__ row_of, int degree, int cap,
                      int* __restrict__ out, int* __restrict__ n_unique) {
  extern __shared__ float4 smem4[];
  __shared__ int s_u;
  const int dp = (d + 3) & ~3;
  float* xs = reinterpret_cast<float*>(smem4);
  float* dist = xs + dp;
  int* cand = reinterpret_cast<int*>(dist + cap);
  unsigned char* keep = reinterpret_cast<unsigned char*>(cand + cap);

  const int g = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int e0 = row_ptr[g];
  const int c = (row_ptr[g + 1] - e0) * w;

  // 1. candidates in first-seen order
  for (int t = tid; t < c; t += THREADS) {
    const int e = t / w;
    const int v = nbr[(size_t)row_of[e0 + e] * w + (t - e * w)];
    cand[t] = v == g ? -1 : v;
  }
  if (x != nullptr)
    for (int i = tid; i < dp; i += THREADS) xs[i] = i < d ? x[(size_t)g * d + i] : 0.f;
  __syncthreads();

  // 2. first occurrences, compacted in order in place
  for (int t = tid; t < c; t += THREADS) {
    const int v = cand[t];
    bool k = v >= 0;
    for (int i = 0; k && i < t; ++i) k = cand[i] != v;
    keep[t] = k;
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int base = 0; base < c; base += 32) {
      const int t = base + lane;
      const bool k = t < c && keep[t];
      const int v = k ? cand[t] : -1;
      const unsigned m = __ballot_sync(FULL, k);
      __syncwarp();  // every lane has read its slot before any is written
      // a write lands at or before its own slot, never on a later chunk
      if (k) cand[n + __popc(m & ((1u << lane) - 1))] = v;
      n += __popc(m);
      __syncwarp();
    }
    if (lane == 0) s_u = n;
  }
  __syncthreads();
  const int u = s_u;
  if (tid == 0) n_unique[g] = u;

  // 3. distances, one warp a candidate
  if (x != nullptr) {
    for (int j = warp; j < u; j += WARPS) {
      const float* y = x + (size_t)cand[j] * d;
      float acc = 0.f;
      for (int base = 4 * lane; base < dp; base += 128) {
        const float4 a = *reinterpret_cast<const float4*>(xs + base);
        float4 b;
        if (VEC) {
          b = __ldg(reinterpret_cast<const float4*>(y + base));
        } else {
          b.x = base < d ? __ldg(y + base) : 0.f;
          b.y = base + 1 < d ? __ldg(y + base + 1) : 0.f;
          b.z = base + 2 < d ? __ldg(y + base + 2) : 0.f;
          b.w = base + 3 < d ? __ldg(y + base + 3) : 0.f;
        }
        float t = __fsub_rn(b.x, a.x);
        acc = __fadd_rn(acc, __fmul_rn(t, t));
        t = __fsub_rn(b.y, a.y);
        acc = __fadd_rn(acc, __fmul_rn(t, t));
        t = __fsub_rn(b.z, a.z);
        acc = __fadd_rn(acc, __fmul_rn(t, t));
        t = __fsub_rn(b.w, a.w);
        acc = __fadd_rn(acc, __fmul_rn(t, t));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc = __fadd_rn(acc, __shfl_xor_sync(FULL, acc, off));
      if (lane == 0) dist[j] = isnan(acc) ? CUDART_INF_F : acc;
    }
    __syncthreads();
  }

  // 4. rank by (distance, position); every output slot written once
  int* row = out + (size_t)g * degree;
  for (int j = tid; j < u; j += THREADS) {
    int r = j;
    if (x != nullptr) {
      const float dj = dist[j];
      r = 0;
      for (int i = 0; i < u; ++i) {
        const float di = dist[i];
        r += di < dj || (di == dj && i < j);
      }
    }
    if (r < degree) row[r] = cand[j];
  }
  for (int r = u + tid; r < degree; r += THREADS) row[r] = -1;
}

template <bool VEC>
int launch(const float* x, int d, const int* nbr, int w, const int* row_ptr,
           const int* row_of, int n, int degree, int cap, int* out, int* n_unique,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(cap, d);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        merge_rows_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  merge_rows_kernel<VEC><<<n, THREADS, smem, stream>>>(x, d, nbr, w, row_ptr, row_of,
                                                         degree, cap, out, n_unique);
  return (int)cudaGetLastError();
}

}  // namespace

// The most candidates a row may have at width D (0 without points), given
// the block's shared memory.
extern "C" int repro_merge_rows_cap(int d) {
  return (int)((SMEM_LIMIT - smem_bytes(0, d)) / 9);
}

// x: [n, d] f32 or null; nbr: [S, w] int32 global ids (-1 pads); row_ptr:
// [n + 1] int32; row_of: int32 rows of nbr; out: [n, degree] int32;
// n_unique: [n] int32.  vec: rows are float4-aligned (d % 4 == 0 and x
// 16-byte aligned).  cap: the largest (row_ptr[g+1] - row_ptr[g]) * w.
extern "C" int repro_merge_rows(const float* x, int d, const int* nbr, int w,
                                const int* row_ptr, const int* row_of, int n,
                                int degree, int cap, int vec, int* out,
                                int* n_unique, cudaStream_t stream) {
  if (n == 0) return 0;
  return vec ? launch<true>(x, d, nbr, w, row_ptr, row_of, n, degree, cap, out,
                            n_unique, stream)
             : launch<false>(x, d, nbr, w, row_ptr, row_of, n, degree, cap, out,
                             n_unique, stream);
}
