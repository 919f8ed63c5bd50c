// Pairwise distance tiles for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces two TPU kernels of the JAX package:
//   * repro/kernels/distance.py  pairwise_distance_pallas  (_distance_kernel)
//     -> K1: [M,D] x [N,D] f32 or bf16 -> [M,N] f32,
//        L2 = max(|q|^2 + |x|^2 - 2 q.x, 0), IP = -q.x.
//   * repro/kernels/distance.py  pairwise_distance_u8_pallas
//     (_distance_kernel_u8, _u8_code_dots)
//     -> K2: [M,D] x [N,D] uint8 affine codes -> f32.
//
// Two kernels each, chosen by the wrapper (distance.py distance_plan):
//
// Skinny (N <= 16, the most centroids any IndexConfig of the repo has,
// and the centroids fit 48 KB of shared memory).  Every call of the main
// path is [M,128] x [16,128]: k-means and partition blocks (M = 8192,
// 65536) and the search's routing tile (M = Q).  There the work is bound
// by the bytes of the M rows (33.5 MFLOP against 4.7 MB at M = 8192), so
// the design streams them once: the 16 centroid rows sit in shared memory
// for the whole block (f32, or the raw codes), and each row of q is read
// by a group of 8 lanes in 16-byte loads, 16 elements a lane a round (a
// D = 128 f32 row: four float4 a lane; 128 uint8 codes: one), RR rows a
// group, four groups a warp, so a warp has 16 loads of 16 bytes in flight
// for the pass it computes and as many for the next.  The grid is at most
// the blocks that are resident at once and walks the rows in grid strides,
// so an M = 8192 call has every row in flight in one round.  A lane's
// partial dot products with all the centroids are combined over its group
// by a reduce-scatter of shuffles (each step halves the sums a lane keeps;
// the centroids are laid out per lane so that no step selects), so each
// lane ends with whole sums for its own two centroids: no output column is
// padding, and the norm epilogue is fused.  Why 8 lanes a row and not 32:
// the reduce-scatter then serves four rows at once, and a lane's FMAs on
// four chunks reuse each centroid chunk it reads from shared memory; 32
// lanes a row took 152 instructions a row against about 100.  A row that
// is not 16-byte aligned (or D not a multiple of 16 bytes) takes the same
// kernel with element loads.  f32 accumulates with FP32 FMAs (no TF32);
// bf16 is upcast exactly on load; uint8 accumulates code products, norms
// and sums exactly with __dp4a.
//
// Tiled (any N): a 64x64 output tile per block of 256 threads, each thread
// owning a 4x4 register tile; the D axis streams through shared memory in
// chunks of 16, the norm epilogue fused.  Large N is bound by FP32
// operations (2*M*N*D FLOPs at 67 TFLOP/s).  No main-path call takes it;
// N in 17..64 takes it too (no caller sends such N, and no run has timed
// the skinny kernel against it there).
//
// uint8, both kernels: the products are exact integers, and the f32
// epilogue is written in the operation order of distance.py:98-109 with
// _rn intrinsics (no FMA contraction), so L2 is bit-identical to the plain
// PyTorch version.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
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

// ---------------------------------------------------------------------------
// Skinny kernels: few centroids resident in shared memory, rows streamed
// ---------------------------------------------------------------------------

constexpr int SK_THREADS = 256;
constexpr int SK_WARPS = SK_THREADS / 32;

template <int ES> struct Raw;
template <> struct Raw<4> { using T = uint32_t; };
template <> struct Raw<2> { using T = uint16_t; };
template <> struct Raw<1> { using T = uint8_t; };

// Chunk c (16 bytes) of a row of d elements: one 16-byte load, or (vec ==
// 0) element loads with the row's tail zero-filled.
template <int ES>
__device__ __forceinline__ uint4 load_chunk(const typename Raw<ES>::T* __restrict__ row,
                                            int c, int d, int vec) {
  using R = typename Raw<ES>::T;
  constexpr int EV = 16 / ES;
  if (vec) return __ldg(reinterpret_cast<const uint4*>(row) + c);
  union { uint4 u; R e[EV]; } r;
#pragma unroll
  for (int i = 0; i < EV; ++i) {
    const int k = c * EV + i;
    r.e[i] = k < d ? row[k] : R(0);
  }
  return r.u;
}

// The 16 / ES values of a chunk as f32 (bf16: the exact upcast).
template <int ES>
__device__ __forceinline__ void unpack(const uint4 u, float (&f)[16 / ES]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (ES == 4) {
      f[i] = __uint_as_float(w[i]);
    } else {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// Reduce-scatter of CNT partial sums over the lanes of a group, offsets
// OFF, OFF/2, ..., 1.  Lane l holds in v[i] its partial sum for centroid
// i ^ M(l), where M(l) = scatter_base(l) sets bit CNT/2 iff lane bit OFF is
// set, bit CNT/4 iff lane bit OFF/2 is set, and so on, so that partners
// across OFF hold the same centroids in opposite halves: every step a lane
// keeps v[0, H) and adds its partner's v[H, 2H), with no select.  After it
// v[i], i < CNT / G, is the group's whole sum for centroid M(l) + i (CNT is
// a multiple of G).
template <int OFF, int CNT, int NC, typename A>
__device__ __forceinline__ void scatter(A (&v)[NC]) {
  if constexpr (OFF > 0) {
    constexpr int H = CNT / 2;
#pragma unroll
    for (int i = 0; i < H; ++i) v[i] += __shfl_xor_sync(FULL, v[i + H], OFF);
    scatter<OFF / 2, H>(v);
  }
}

template <int G, int NC>
__device__ __forceinline__ int scatter_base(int lane) {
  int base = 0, cnt = NC;
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    cnt >>= 1;
    if (lane & off) base += cnt;
  }
  return base;
}

template <int G, typename A>
__device__ __forceinline__ A group_sum(A v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// How a warp walks its rows: four groups of G = 8 lanes side by side, a
// group RR rows at a time, each lane CPL = ES 16-byte chunks of each row a
// round, 16 elements: a group takes 128 elements of a row a round (a D = 128
// row in one round, whatever its type).  RR is what a budget of 96
// registers a lane holds: NC partial sums a row, the row's chunks twice
// (this pass and the next, in flight), and for bf16 their f32 unpacking.
// Every warp of the grid takes a pass of 4 * RR rows, then a grid stride.
constexpr int SK_G = 8;
constexpr int SK_NC = 16;  // centroid rows a block keeps: n <= 16

template <int ES>
struct Walk {
  static constexpr int CPL = ES, NC = SK_NC;
  static constexpr int GPW = 32 / SK_G;
  static constexpr int PER_ROW = NC + 8 * CPL + (ES == 2 ? 8 * CPL : 0);
  static constexpr int RR = 96 / PER_ROW < 1 ? 1 : (96 / PER_ROW > 4 ? 4 : 96 / PER_ROW);
  static constexpr int ROWS = SK_WARPS * GPW * RR;      // a block's rows a pass
  static constexpr int NV = NC / SK_G;                  // sums a lane ends with
};

// Chunks lg + G * (u + CPL * t), u < CPL, of the group's RR rows of a pass.
template <int ES>
__device__ __forceinline__ void load_rows(uint4 (&qc)[Walk<ES>::RR][ES],
                                          const typename Raw<ES>::T* __restrict__ q,
                                          long long row0, int grp, int c0, int m,
                                          int d, int chunks, int vec) {
  using W = Walk<ES>;
#pragma unroll
  for (int r = 0; r < W::RR; ++r) {
    const long long row = row0 + r * W::GPW + grp;
#pragma unroll
    for (int u = 0; u < W::CPL; ++u) {
      const int c = c0 + SK_G * u;
      qc[r][u] = (row < m && c < chunks) ? load_chunk<ES>(q + row * d, c, d, vec)
                                         : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Copy the n centroid rows (zero rows up to SK_NC, zero columns up to
// whole chunks) into shared memory, four chunks a thread in flight at once:
// f32 (bf16 upcast) for K1, the codes for K2.
template <int ES, typename S>
__device__ __forceinline__ void stage_centroids(S* xs, const typename Raw<ES>::T* __restrict__ x,
                                                int n, int d, int chunks, int vec) {
  constexpr int EV = 16 / ES;
  const int total = SK_NC * chunks;
  for (int base = threadIdx.x; base < total; base += 4 * SK_THREADS) {
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + u * SK_THREADS;
      const int j = i / chunks;
      v[u] = (i < total && j < n) ? load_chunk<ES>(x + (size_t)j * d, i - j * chunks, d, vec)
                                  : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + u * SK_THREADS;
      if (i >= total) continue;
      if constexpr (ES == 1) {
        reinterpret_cast<uint4*>(xs)[i] = v[u];
      } else {
        float f[EV];
        unpack<ES>(v[u], f);
        float4* dst = reinterpret_cast<float4*>(xs) + i * (EV / 4);
#pragma unroll
        for (int h = 0; h < EV / 4; ++h)
          dst[h] = make_float4(f[4 * h], f[4 * h + 1], f[4 * h + 2], f[4 * h + 3]);
      }
    }
  }
}

// K1 skinny: ES = 4 (f32) or 2 (bf16).
template <int ES>
__global__ void __launch_bounds__(SK_THREADS, 2)
distance_skinny(const void* __restrict__ qv, const void* __restrict__ xv,
                float* __restrict__ out, int m, int n, int d, int ip, int vec) {
  using R = typename Raw<ES>::T;
  using W = Walk<ES>;
  constexpr int EV = 16 / ES, CPL = W::CPL, NC = W::NC;
  extern __shared__ float4 smem_f4[];
  const int chunks = (d + EV - 1) / EV;
  const int dp = chunks * EV;
  float* xs = reinterpret_cast<float*>(smem_f4);  // [NC][dp], zero-padded
  float* xn = xs + NC * dp;                        // [NC]
  const R* q = static_cast<const R*>(qv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane / SK_G, lg = lane % SK_G;
  const int rounds = (chunks + SK_G * CPL - 1) / (SK_G * CPL);
  const long long stride = (long long)gridDim.x * W::ROWS;
  long long row0 = (long long)blockIdx.x * W::ROWS + warp * W::GPW * W::RR;
  int t = 0;
  uint4 qc[W::RR][CPL];
  load_rows<ES>(qc, q, row0, grp, lg, m, d, chunks, vec);  // before staging

  stage_centroids<ES>(xs, static_cast<const R*>(xv), n, d, chunks, vec);
  __syncthreads();
  for (int j = warp; j < NC; j += SK_WARPS) {
    float s = 0.f;
    for (int k = lane; k < dp; k += 32) s = fmaf(xs[j * dp + k], xs[j * dp + k], s);
    s = group_sum<32>(s);
    if (lane == 0) xn[j] = s;
  }
  __syncthreads();

  const int perm = scatter_base<SK_G, NC>(lg);  // v[i] holds centroid i ^ perm
  float acc[W::RR][NC];
  float qn[W::RR];
#pragma unroll
  for (int r = 0; r < W::RR; ++r) {
    qn[r] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[r][j] = 0.f;
  }
  while (row0 < m) {
    long long next = row0;
    int tn = t + 1;
    if (tn == rounds) { tn = 0; next += stride; }
    uint4 qx[W::RR][CPL];  // the next round's rows, in flight while this one computes
    load_rows<ES>(qx, q, next, grp, lg + SK_G * CPL * tn, m, d, chunks, vec);
#pragma unroll
    for (int u = 0; u < CPL; ++u) {
      const int c = lg + SK_G * (u + CPL * t);
      if (c >= chunks) continue;
      float qf[W::RR][EV];
#pragma unroll
      for (int r = 0; r < W::RR; ++r) {
        unpack<ES>(qc[r][u], qf[r]);
#pragma unroll
        for (int e = 0; e < EV; ++e) qn[r] = fmaf(qf[r][e], qf[r][e], qn[r]);
      }
      const float4* xc = reinterpret_cast<const float4*>(xs + c * EV);
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float4* xj = xc + (size_t)(j ^ perm) * (dp / 4);
        float xf[EV];
#pragma unroll
        for (int h = 0; h < EV / 4; ++h) {
          const float4 v = xj[h];
          xf[4 * h] = v.x; xf[4 * h + 1] = v.y; xf[4 * h + 2] = v.z; xf[4 * h + 3] = v.w;
        }
#pragma unroll
        for (int r = 0; r < W::RR; ++r)
#pragma unroll
          for (int e = 0; e < EV; ++e) acc[r][j] = fmaf(qf[r][e], xf[e], acc[r][j]);
      }
    }
    if (tn == 0) {
#pragma unroll
      for (int r = 0; r < W::RR; ++r) {
        scatter<SK_G / 2, NC>(acc[r]);
        const float qq = group_sum<SK_G>(qn[r]);
        const long long row = row0 + r * W::GPW + grp;
        if (row < m) {
#pragma unroll
          for (int i = 0; i < W::NV; ++i) {
            const int j = perm + i;
            if (j < n)
              out[row * n + j] = ip ? -acc[r][i] : fmaxf(qq + xn[j] - 2.f * acc[r][i], 0.f);
          }
        }
        qn[r] = 0.f;
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[r][j] = 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < W::RR; ++r)
#pragma unroll
      for (int u = 0; u < CPL; ++u) qc[r][u] = qx[r][u];
    row0 = next;
    t = tn;
  }
}

// K2 skinny: uint8 codes, exact unsigned __dp4a sums, the _rn epilogue.
__global__ void __launch_bounds__(SK_THREADS, 2)
distance_skinny_u8(const uint8_t* __restrict__ q, const uint8_t* __restrict__ x,
                   float* __restrict__ out, int m, int n, int d, int d_real,
                   float scale, float zp, int ip, int vec) {
  using W = Walk<1>;
  constexpr int CPL = W::CPL, NC = W::NC;
  extern __shared__ uint4 smem_u4[];
  const int chunks = (d + 15) / 16;
  const int dp = chunks * 16;
  uint8_t* xs = reinterpret_cast<uint8_t*>(smem_u4);  // [NC][dp], zero-padded
  unsigned* xn = reinterpret_cast<unsigned*>(xs + NC * dp);  // [NC] code norms
  unsigned* xsum = xn + NC;                                    // [NC] code sums
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane / SK_G, lg = lane % SK_G;
  const int rounds = (chunks + SK_G * CPL - 1) / (SK_G * CPL);
  const long long stride = (long long)gridDim.x * W::ROWS;
  long long row0 = (long long)blockIdx.x * W::ROWS + warp * W::GPW * W::RR;
  int t = 0;
  uint4 qc[W::RR][CPL];
  load_rows<1>(qc, q, row0, grp, lg, m, d, chunks, vec);  // before staging

  stage_centroids<1>(xs, x, n, d, chunks, vec);
  __syncthreads();
  for (int j = warp; j < NC; j += SK_WARPS) {
    unsigned s2 = 0, s1 = 0;
    for (int k = lane; k < dp; k += 32) {
      const unsigned v = xs[j * dp + k];
      s2 += v * v;
      s1 += v;
    }
    s2 = group_sum<32>(s2);
    s1 = group_sum<32>(s1);
    if (lane == 0) { xn[j] = s2; xsum[j] = s1; }
  }
  __syncthreads();

  const float ss = __fmul_rn(scale, scale);
  const float szp = __fmul_rn(scale, zp);
  const float dzz = __fmul_rn(__fmul_rn((float)d_real, zp), zp);
  const int perm = scatter_base<SK_G, NC>(lg);  // v[i] holds centroid i ^ perm
  unsigned acc[W::RR][NC];
  unsigned qn[W::RR], qs[W::RR];
#pragma unroll
  for (int r = 0; r < W::RR; ++r) {
    qn[r] = qs[r] = 0u;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[r][j] = 0u;
  }
  while (row0 < m) {
    long long next = row0;
    int tn = t + 1;
    if (tn == rounds) { tn = 0; next += stride; }
    uint4 qx[W::RR][CPL];
    load_rows<1>(qx, q, next, grp, lg + SK_G * CPL * tn, m, d, chunks, vec);
#pragma unroll
    for (int u = 0; u < CPL; ++u) {
      const int c = lg + SK_G * (u + CPL * t);
      if (c >= chunks) continue;
#pragma unroll
      for (int r = 0; r < W::RR; ++r) {
        const uint32_t w[4] = {qc[r][u].x, qc[r][u].y, qc[r][u].z, qc[r][u].w};
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          qn[r] = __dp4a(w[h], w[h], qn[r]);
          qs[r] = __dp4a(w[h], 0x01010101u, qs[r]);
        }
      }
      const uint4* xc = reinterpret_cast<const uint4*>(xs + c * 16);
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const uint4 xw = xc[(size_t)(j ^ perm) * (dp / 16)];
#pragma unroll
        for (int r = 0; r < W::RR; ++r) {
          unsigned a = acc[r][j];
          a = __dp4a(qc[r][u].x, xw.x, a);
          a = __dp4a(qc[r][u].y, xw.y, a);
          a = __dp4a(qc[r][u].z, xw.z, a);
          a = __dp4a(qc[r][u].w, xw.w, a);
          acc[r][j] = a;
        }
      }
    }
    if (tn == 0) {
#pragma unroll
      for (int r = 0; r < W::RR; ++r) {
        scatter<SK_G / 2, NC>(acc[r]);
        const unsigned qq = group_sum<SK_G>(qn[r]);
        const unsigned qsum = group_sum<SK_G>(qs[r]);
        const long long row = row0 + r * W::GPW + grp;
        if (row < m) {
#pragma unroll
          for (int i = 0; i < W::NV; ++i) {
            const int j = perm + i;
            if (j >= n) continue;
            float v;
            if (!ip) {
              const int dc = (int)(qq + xn[j] - 2u * acc[r][i]);
              v = __fmul_rn(fmaxf(__int2float_rn(dc), 0.f), ss);
            } else {
              const float sums = __fadd_rn(__int2float_rn((int)qsum),
                                           __int2float_rn((int)xsum[j]));
              v = -__fadd_rn(__fadd_rn(__fmul_rn(ss, __int2float_rn((int)acc[r][i])),
                                       __fmul_rn(szp, sums)),
                             dzz);
            }
            out[row * n + j] = v;
          }
        }
        qn[r] = qs[r] = 0u;
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[r][j] = 0u;
      }
    }
#pragma unroll
    for (int r = 0; r < W::RR; ++r)
#pragma unroll
      for (int u = 0; u < CPL; ++u) qc[r][u] = qx[r][u];
    row0 = next;
    t = tn;
  }
}

__global__ void noop_kernel() {}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// Blocks of `kernel` that are resident on the card at once with `smem`
// bytes of dynamic shared memory (cached per kernel and size).
int resident_blocks(const void* kernel, size_t smem) {
  struct Entry { const void* k; size_t smem; int blocks; };
  static Entry cache[64];
  static int used = 0;
  for (int i = 0; i < used; ++i)
    if (cache[i].k == kernel && cache[i].smem == smem) return cache[i].blocks;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, SK_THREADS, smem) !=
          cudaSuccess || per_sm < 1)
    per_sm = 1;
  const int blocks = per_sm * sm_count();
  if (used < 64) cache[used++] = Entry{kernel, smem, blocks};
  return blocks;
}

// One block a pass of rows, but no more blocks than are resident at once:
// the rest of M is walked in grid strides.
dim3 skinny_grid(const void* kernel, int rows_per_block, size_t smem, int m) {
  const long long need = ((long long)m + rows_per_block - 1) / rows_per_block;
  const int cap = resident_blocks(kernel, smem);
  return dim3((unsigned)(need < cap ? need : cap));
}

template <int ES>
int run_skinny(const void* q, const void* x, float* out, int m, int n, int d, int ip,
               int vec, cudaStream_t s) {
  constexpr int EV = 16 / ES;
  const int dp = (d + EV - 1) / EV * EV;
  const size_t smem = (size_t)SK_NC * dp * 4 + SK_NC * 4;
  auto kernel = distance_skinny<ES>;
  const dim3 grid = skinny_grid((const void*)kernel, Walk<ES>::ROWS, smem, m);
  kernel<<<grid, SK_THREADS, smem, s>>>(q, x, out, m, n, d, ip, vec);
  return (int)cudaGetLastError();
}

int run_skinny_u8(const uint8_t* q, const uint8_t* x, float* out, int m, int n, int d,
                  int d_real, float scale, float zp, int ip, int vec, cudaStream_t s) {
  const int dp = (d + 15) / 16 * 16;
  const size_t smem = (size_t)SK_NC * dp + SK_NC * 8;
  auto kernel = distance_skinny_u8;
  const dim3 grid = skinny_grid((const void*)kernel, Walk<1>::ROWS, smem, m);
  kernel<<<grid, SK_THREADS, smem, s>>>(q, x, out, m, n, d, d_real, scale, zp, ip, vec);
  return (int)cudaGetLastError();
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

// Skinny K1 and K2: n <= 16 centroid rows; vec = 1 for 16-byte loads.
// The wrapper's distance_plan picks them and checks the shared-memory fit.
extern "C" int repro_distance_skinny(const void* q, const void* x, float* out, int m,
                                     int n, int d, int bf16, int metric_ip, int vec,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > SK_NC) return (int)cudaErrorInvalidValue;
  return bf16 ? run_skinny<2>(q, x, out, m, n, d, metric_ip, vec, s)
              : run_skinny<4>(q, x, out, m, n, d, metric_ip, vec, s);
}

extern "C" int repro_distance_u8_skinny(const uint8_t* q, const uint8_t* x, float* out,
                                        int m, int n, int d, int d_real, float scale,
                                        float zp, int metric_ip, int vec, void* stream) {
  if (n > SK_NC) return (int)cudaErrorInvalidValue;
  return run_skinny_u8(q, x, out, m, n, d, d_real, scale, zp, metric_ip, vec,
                       (cudaStream_t)stream);
}

// An empty kernel: the launch floor a graph-timed kernel is read against.
extern "C" int repro_noop(void* stream) {
  noop_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
