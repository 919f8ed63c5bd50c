// Pairwise distance tiles for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces two TPU kernels of the JAX package:
//   * repro/kernels/distance.py  pairwise_distance_pallas  (_distance_kernel)
//     -> repro_pairwise_distance: [M,D] x [N,D] f32 or bf16 -> [M,N] f32,
//        L2 = max(|q|^2 + |x|^2 - 2 q.x, 0), IP = -q.x.
//   * repro/kernels/distance.py  pairwise_distance_u8_pallas
//     (_distance_kernel_u8, _u8_code_dots)
//     -> repro_pairwise_distance_u8: [M,D] x [N,D] uint8 affine codes -> f32.
//
// What bounds it on an H100: the f32 tile does 2*M*N*D FLOPs against
// (M+N)*D inputs and M*N outputs, so at the main path's shapes it is
// bounded by FP32 operations (67 TFLOP/s outside the tensor cores; TF32 is
// not allowed, the reference is exact f32).  The uint8 tile at the routing
// shape [Q, 16] is bounded by the bytes it moves.  Design: a 64x64 output
// tile per block of 256 threads, each thread owning a 4x4 register tile;
// the D axis streams through shared memory in chunks of 16, and the norm
// epilogue is fused (row and column norms accumulate from the same shared
// chunks, so no second pass reads the inputs).  bf16 panels are upcast with
// __bfloat162float on the way into shared memory, as the TPU kernel upcasts
// at the VMEM->VREG boundary.  The uint8 tile accumulates exact int32 code
// products; its f32 epilogue is written in the operation order of
// distance.py:98-109 with _rn intrinsics (no FMA contraction), so L2 is
// bit-identical to the plain PyTorch version.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;
constexpr int KC = 16;
constexpr int THREADS = 256;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, bool L2>
__global__ void __launch_bounds__(THREADS)
distance_tile(const T* __restrict__ q, const T* __restrict__ x,
              float* __restrict__ out, int m, int n, int d) {
  __shared__ float qs[KC][TILE + 1];
  __shared__ float xs[KC][TILE + 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * TILE, col0 = blockIdx.x * TILE;
  float acc[4][4] = {};
  float qn[4] = {}, xn[4] = {};
  for (int k0 = 0; k0 < d; k0 += KC) {
    for (int i = threadIdx.x; i < TILE * KC; i += THREADS) {
      const int r = i / KC, kk = i % KC, gk = k0 + kk;
      const int gq = row0 + r, gx = col0 + r;
      qs[kk][r] = (gq < m && gk < d) ? to_f32(q[(size_t)gq * d + gk]) : 0.f;
      xs[kk][r] = (gx < n && gk < d) ? to_f32(x[(size_t)gx * d + gk]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = qs[kk][ty + 16 * i];
        b[i] = xs[kk][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        if (L2) {
          qn[i] = fmaf(a[i], a[i], qn[i]);
          xn[i] = fmaf(b[i], b[i], xn[i]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c >= n) continue;
      out[(size_t)r * n + c] =
          L2 ? fmaxf(qn[i] + xn[j] - 2.f * acc[i][j], 0.f) : -acc[i][j];
    }
  }
}

template <bool L2>
__global__ void __launch_bounds__(THREADS)
distance_tile_u8(const uint8_t* __restrict__ q, const uint8_t* __restrict__ x,
                 float* __restrict__ out, int m, int n, int d, int d_real,
                 float scale, float zp) {
  __shared__ int qs[KC][TILE + 1];
  __shared__ int xs[KC][TILE + 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * TILE, col0 = blockIdx.x * TILE;
  int acc[4][4] = {};
  int qn[4] = {}, xn[4] = {}, qsum[4] = {}, xsum[4] = {};
  for (int k0 = 0; k0 < d; k0 += KC) {
    for (int i = threadIdx.x; i < TILE * KC; i += THREADS) {
      const int r = i / KC, kk = i % KC, gk = k0 + kk;
      const int gq = row0 + r, gx = col0 + r;
      qs[kk][r] = (gq < m && gk < d) ? (int)q[(size_t)gq * d + gk] : 0;
      xs[kk][r] = (gx < n && gk < d) ? (int)x[(size_t)gx * d + gk] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = qs[kk][ty + 16 * i];
        b[i] = xs[kk][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
        qn[i] += a[i] * a[i];
        xn[i] += b[i] * b[i];
        qsum[i] += a[i];
        xsum[i] += b[i];
      }
    }
    __syncthreads();
  }
  const float ss = __fmul_rn(scale, scale);
  const float szp = __fmul_rn(scale, zp);
  const float dzz = __fmul_rn(__fmul_rn((float)d_real, zp), zp);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c >= n) continue;
      float v;
      if (L2) {
        const int dc = qn[i] + xn[j] - 2 * acc[i][j];
        v = __fmul_rn(fmaxf(__int2float_rn(dc), 0.f), ss);
      } else {
        const float sums = __fadd_rn(__int2float_rn(qsum[i]),
                                     __int2float_rn(xsum[j]));
        v = -__fadd_rn(__fadd_rn(__fmul_rn(ss, __int2float_rn(acc[i][j])),
                                 __fmul_rn(szp, sums)),
                       dzz);
      }
      out[(size_t)r * n + c] = v;
    }
  }
}

dim3 grid_for(int m, int n) {
  return dim3((n + TILE - 1) / TILE, (m + TILE - 1) / TILE);
}

}  // namespace

extern "C" int repro_pairwise_distance(const void* q, const void* x, float* out,
                                       int m, int n, int d, int bf16,
                                       int metric_ip, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid = grid_for(m, n);
  if (bf16) {
    auto qp = (const __nv_bfloat16*)q;
    auto xp = (const __nv_bfloat16*)x;
    if (metric_ip)
      distance_tile<__nv_bfloat16, false><<<grid, THREADS, 0, s>>>(qp, xp, out, m, n, d);
    else
      distance_tile<__nv_bfloat16, true><<<grid, THREADS, 0, s>>>(qp, xp, out, m, n, d);
  } else {
    auto qp = (const float*)q;
    auto xp = (const float*)x;
    if (metric_ip)
      distance_tile<float, false><<<grid, THREADS, 0, s>>>(qp, xp, out, m, n, d);
    else
      distance_tile<float, true><<<grid, THREADS, 0, s>>>(qp, xp, out, m, n, d);
  }
  return (int)cudaGetLastError();
}

extern "C" int repro_pairwise_distance_u8(const uint8_t* q, const uint8_t* x,
                                          float* out, int m, int n, int d,
                                          int d_real, float scale, float zp,
                                          int metric_ip, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid = grid_for(m, n);
  if (metric_ip)
    distance_tile_u8<false><<<grid, THREADS, 0, s>>>(q, x, out, m, n, d, d_real, scale, zp);
  else
    distance_tile_u8<true><<<grid, THREADS, 0, s>>>(q, x, out, m, n, d, d_real, scale, zp);
  return (int)cudaGetLastError();
}
