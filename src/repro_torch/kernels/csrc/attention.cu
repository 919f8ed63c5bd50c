// Flash attention (prefill) and flash decode for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces two TPU kernels of the JAX package:
//   * repro/kernels/flash_attention.py  flash_attention_pallas (_flash_kernel)
//     -> repro_flash_attention (K5): q [B,H,S,Dh], k/v [B,Hkv,T,Dh] ->
//        [B,H,S,Dh], GQA (head h reads KV head h / (H/Hkv)), optionally
//        causal with query i attending keys <= i + (T - S).
//   * repro/kernels/flash_attention.py  flash_decode_pallas (_decode_kernel)
//     -> repro_flash_decode (K6): one query token per row, q [B,H,Dh]
//        against a cache [B,Hkv,T,Dh] of which the first cache_len[b]
//        positions are valid -> [B,H,Dh].
//
// Semantics kept from the TPU kernels by every path: scores, probabilities
// and the P.V sums are f32; an online softmax keeps a running (max,
// denominator, accumulator) per query row; masked scores are -1e30 and
// contribute exactly 0 (so a row with no valid key gives 0, not the TPU
// kernel's uniform average over masked keys, which no caller reaches); the
// denominator is clamped at 1e-30; tiles above the causal diagonal are never
// loaded; the ragged last Q and K tiles are masked here; the output is
// rounded once to q's type.
//
// K5, bf16 (flash_prefill_mma; the LM path's type).  What bounds it: 4*B*H*
// Dh*S(S+1)/2 FLOPs causal against a few MB of inputs, so operations.  The
// products run on the tensor cores as bf16 x bf16 -> f32 mma.sync.m16n8k16
// (FA2's layout: 4 warps x 16 query rows = one 64-query tile per block of
// 128 threads, K/V in 64-key tiles).  Why mma.sync and not wgmma:
// mma.sync's register fragments come straight from ldmatrix on padded rows
// and the QK^T accumulator is already P's A fragment; a first wgmma version
// (unswizzled shared-memory tiles, a wait after each product) was right but
// slower.  Swizzled TMA tiles with wgmma overlapped with the softmax are
// the next step (see PERF.md).
//   * QK^T: q and k are bf16 already, so every product is exact in f32 and
//     only the summation order differs from the reference.
//   * Scale: the reference scales q in f32 before the product.  Here the f32
//     score is multiplied by scale*log2(e) after the MMA and fed to the
//     SFU's exp2 (ex2.approx, ~2^-22 relative).  For Dh 16 and 64 the
//     default scale is a power of two, so score*scale equals the
//     reference's pre-scaled product exactly; for Dh 32 and 128 and any
//     caller's scale it differs by one f32 rounding.  Folding log2(e) adds
//     ~2^-23 relative to the exponent's argument in every case.
//   * Masks run only on edge tiles (past T, or across the causal diagonal);
//     a masked score is NEG and exp2(NEG - m) is 0 exactly.
//   * P keeps 16 significant bits: each f32 probability is split into
//     P_hi = bf16(P) and P_lo = bf16(P - P_hi), and acc += P_hi.V + P_lo.V
//     runs as two bf16 MMAs accumulating in f32.  The split's error is about
//     2^-17 relative to P (P_lo may underflow, below that), far under the
//     output's bf16 rounding, so the argument for the bf16 tolerance is the
//     f32-P kernel's.  The row sum is taken over the f32 P.
//   * K/V tiles stream through a 2-stage ring of shared memory filled by
//     cp.async (zero-filled past T), so tile j+1 loads while tile j runs.
//     Rows are padded by 16 bytes, so ldmatrix's 8 row reads hit distinct
//     banks.  Row max and sum reduce across the 4 lanes of a quad with
//     shuffles; the running sum stays per lane until the end.  Query tiles
//     run heaviest (last) first so the causal tail does not idle SMs, and
//     at Dh <= 64 registers are held to 128 so four blocks share an SM.
//
// K5, f32 (flash_prefill<float>): FP32 FMAs (no TF32, which the parity
// contract bars for f32), bound by FP32 issue and shared-memory reads.  One
// block of 256 threads per (64-query tile, head, batch row); each thread
// owns a 4x4 patch of the 64x64 score tile and a 4 x Dh/16 patch of the
// output, so the row statistics reduce across a half-warp with shuffles.
// Shared rows are padded by 4 floats so the float4 reads hit distinct banks.
//
// K6: bound by the bytes of K and V up to cache_len (3.35 TB/s).  One block
// per (batch row, KV head) serves that head's whole GQA group, so each
// cached K/V row is read from device memory once for the group; the block
// walks the cache in 64-key tiles up to cache_len[b] (clamped to T), one
// warp per query head keeps that head's softmax state.  With B*Hkv blocks
// (32 at B=8, Hkv=4 on 132 SMs) K6 is latency-bound; splitting the cache
// across blocks with a combining pass is the later redesign.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TQ = 64;       // queries per K5 block
constexpr int TK = 64;       // keys per shared-memory tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PAD = 4;       // floats of padding per shared row
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Stage rows [r0, r0 + TK) of one [T, DH] head into shared memory as f32,
// zero past `valid` rows.  K goes to a padded [TK][DH+PAD] tile, V (when
// given) to a dense [TK][DH] tile.
template <typename T, int DH>
__device__ __forceinline__ void load_kv(const T* __restrict__ k, const T* __restrict__ v,
                                        float* ks, float* vs, int r0, int valid) {
  for (int i = threadIdx.x; i < TK * DH; i += THREADS) {
    const int r = i / DH, d = i % DH;
    const bool in = r0 + r < valid;
    const size_t g = (size_t)(r0 + r) * DH + d;
    ks[r * (DH + PAD) + d] = in ? to_f32(k[g]) : 0.f;
    vs[i] = in ? to_f32(v[g]) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// K5: causal / full GQA attention over a whole sequence
// ---------------------------------------------------------------------------

template <int DH>
constexpr size_t prefill_smem_floats() {
  return (size_t)TQ * (DH + PAD) + TK * (DH + PAD) + TK * DH + TQ * (TK + PAD);
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_prefill(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out,
              int h, int hkv, int s, int t, float scale, int causal) {
  constexpr int QS = DH + PAD, PS = TK + PAD;
  constexpr int CW = DH / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [TQ][DH+PAD]
  float* ks = qs + TQ * QS;                     // [TK][DH+PAD]
  float* vs = ks + TK * QS;                     // [TK][DH]
  float* ps = vs + TK * DH;                     // [TQ][TK+PAD]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * TQ, head = blockIdx.y, b = blockIdx.z;
  const int kv_head = head / (h / hkv);
  const T* qh = q + ((size_t)b * h + head) * s * DH;
  const T* kh = k + ((size_t)b * hkv + kv_head) * t * DH;
  const T* vh = v + ((size_t)b * hkv + kv_head) * t * DH;
  T* oh = out + ((size_t)b * h + head) * s * DH;
  const int offset = t - s;

  for (int i = threadIdx.x; i < TQ * DH; i += THREADS) {
    const int r = i / DH, d = i % DH;
    qs[r * QS + d] = q0 + r < s ? to_f32(qh[(size_t)(q0 + r) * DH + d]) * scale : 0.f;
  }

  float acc[4][CW];
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = NEG;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.f;
  }

  // keys [0, k_end) can be attended by some query of this tile
  const int q_last = min(q0 + TQ, s) - 1;
  const int k_end = causal ? min(t, q_last + offset + 1) : t;
  for (int k0 = 0; k0 < k_end; k0 += TK) {
    __syncthreads();  // Q staged / previous tile's K, V and P consumed
    load_kv<T, DH>(kh, vh, ks, vs, k0, t);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * QS + d);
        bk[i] = *reinterpret_cast<const float4*>(ks + (tx + 16 * i) * QS + d);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(a[i].x, bk[j].x, sc[i][j]);
          sc[i][j] = fmaf(a[i].y, bk[j].y, sc[i][j]);
          sc[i][j] = fmaf(a[i].z, bk[j].z, sc[i][j]);
          sc[i][j] = fmaf(a[i].w, bk[j].w, sc[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      bool ok[4];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        ok[j] = kj < t && (!causal || kj <= qi + offset);
        sc[i][j] = ok[j] ? sc[i][j] : NEG;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m_run[i], half_warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        ps[(ty + 16 * i) * PS + tx + 16 * j] = p;
        sum += p;
      }
      const float alpha = expf(m_run[i] - m_new);
      l_run[i] = alpha * l_run[i] + half_warp_sum(sum);
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < TK; kk += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * PS + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = vs + (kk + u) * DH + tx * CW;
        float vv[CW];
        if constexpr (CW % 4 == 0) {
#pragma unroll
          for (int c = 0; c < CW; c += 4) {
            const float4 v4 = *reinterpret_cast<const float4*>(vrow + c);
            vv[c] = v4.x;
            vv[c + 1] = v4.y;
            vv[c + 2] = v4.z;
            vv[c + 3] = v4.w;
          }
        } else {
#pragma unroll
          for (int c = 0; c < CW; ++c) vv[c] = vrow[c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = u == 0 ? p4[i].x : u == 1 ? p4[i].y : u == 2 ? p4[i].z : p4[i].w;
#pragma unroll
          for (int c = 0; c < CW; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= s) continue;
    const float denom = fmaxf(l_run[i], 1e-30f);
    T* orow = oh + (size_t)qi * DH + tx * CW;
#pragma unroll
    for (int c = 0; c < CW; ++c) orow[c] = from_f32<T>(acc[i][c] / denom);
  }
}

// ---------------------------------------------------------------------------
// K5, bf16: tensor-core tiles (mma.sync m16n8k16, f32 accumulation)
// ---------------------------------------------------------------------------

constexpr int MMA_WARPS = 4;              // 16 query rows each
constexpr int MMA_THREADS = MMA_WARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, zero-filled when !pred (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c[4] += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the SFU (ex2.approx, ~2^-22 relative, denormals flushed to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Split two f32 probabilities into bf16 pairs hi = bf16(p), lo = bf16(p - hi).
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(x - __low2float(h), y - __high2float(h));
}

template <int DH>
constexpr size_t mma_smem_bytes() {
  return (size_t)(1 + 2 * 2) * TQ * (DH + 8) * sizeof(__nv_bfloat16);
}

// Copy rows [r0, r0 + 64) of one [rows, DH] bf16 head into a padded
// [64][DH+8] tile, zero past `valid` rows.
template <int DH>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int r0, int valid) {
  constexpr int CH = DH / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < TQ * CH; i += MMA_THREADS) {
    const int r = i / CH, c = i % CH;
    const bool in = r0 + r < valid;
    cp_async16(dst + r * (DH + 8) + c * 8, in ? src + (size_t)(r0 + r) * DH + c * 8 : src, in);
  }
}

// One block per (64-query tile, head, batch row); warp w owns query rows
// 16w..16w+15.  Fragment layouts are mma.m16n8k16's: lane = 4g + tq holds
// rows g and g+8, columns 2tq and 2tq+1 of each 8-wide accumulator tile.
// At Dh <= 64 the registers are held to 128 so four blocks share an SM.
template <int DH, bool SPLIT_P>
__global__ void __launch_bounds__(MMA_THREADS, DH <= 64 ? 4 : 2)
flash_prefill_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                  int h, int hkv, int s, int t, float scale_log2, int causal) {
  constexpr int RS = DH + 8;         // padded row, bf16 elements
  constexpr int KD = DH / 16;        // k16 steps over the head dim
  constexpr int NT = TK / 8;         // 8-key score tiles
  constexpr int ND = DH / 8;         // 8-wide output tiles
  extern __shared__ float4 smem4[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem4);  // [TQ][RS]
  __nv_bfloat16* ks = qs + TQ * RS;                              // [2][TK][RS]
  __nv_bfloat16* vs = ks + 2 * TK * RS;                          // [2][TK][RS]

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tq = lane % 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TQ;  // heaviest causal tiles first
  const int head = blockIdx.y, b = blockIdx.z;
  const int kv_head = head / (h / hkv);
  const __nv_bfloat16* qh = q + ((size_t)b * h + head) * s * DH;
  const __nv_bfloat16* kh = k + ((size_t)b * hkv + kv_head) * t * DH;
  const __nv_bfloat16* vh = v + ((size_t)b * hkv + kv_head) * t * DH;
  __nv_bfloat16* oh = out + ((size_t)b * h + head) * s * DH;
  const int offset = t - s;
  const int q_last = min(q0 + TQ, s) - 1;
  const int k_end = causal ? min(t, q_last + offset + 1) : t;
  const int n_tiles = k_end > 0 ? (k_end + TK - 1) / TK : 0;

  stage_rows<DH>(qs, qh, q0, s);
  if (n_tiles > 0) {
    stage_rows<DH>(ks, kh, 0, t);
    stage_rows<DH>(vs, vh, 0, t);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // ldmatrix x4: lane supplies row (lane % 8) of matrix (lane / 8)
  const int lrow = lane % 8, lmat = lane / 8;
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    ldsm_x4(qf[kk], qs + (warp * 16 + lrow + (lmat & 1) * 8) * RS + kk * 16 + (lmat >> 1) * 8);

  float oacc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  // running max (log2 domain) and this lane's partial sum of rows g, g+8
  float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + g;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * TK;
    if (j > 0) {
      cp_async_wait_all();
      __syncthreads();  // tile j landed; tile j-1's stage is free
    }
    if (j + 1 < n_tiles) {
      const int nxt = (j + 1) & 1;
      stage_rows<DH>(ks + nxt * TK * RS, kh, k0 + TK, t);
      stage_rows<DH>(vs + nxt * TK * RS, vh, k0 + TK, t);
    }
    cp_async_commit();
    const __nv_bfloat16* kt = ks + (j & 1) * TK * RS;
    const __nv_bfloat16* vt = vs + (j & 1) * TK * RS;

    // S = Q K^T, 16 rows x 64 keys per warp
    float sacc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, kt + (np * 16 + lrow + (lmat >> 1) * 8) * RS + kk * 16 + (lmat & 1) * 8);
        mma_bf16(sacc[2 * np], qf[kk], bk[0], bk[1]);
        mma_bf16(sacc[2 * np + 1], qf[kk], bk[2], bk[3]);
      }

    // online softmax in the log2 domain; masked entries are NEG and P = 0
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] *= scale_log2;
    if (k0 + TK > t || (causal && k0 + TK - 1 > q0 + offset)) {  // edge tile
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + n * 8 + 2 * tq + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          if (key >= t || (causal && key > row + offset)) sacc[n][e] = NEG;
        }
    }
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sacc[n][e]);
    // A masked score (NEG) gives exp2(NEG - m) = 0 exactly; a row with no
    // valid key yet (m = NEG) subtracts 0 instead, for the same 0.
    float alpha[2], m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = fast_exp2(m_run[r] - m_new);
      m_run[r] = m_new;
      m_use[r] = m_new == NEG ? 0.f : m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(sacc[n][e] - m_use[e >> 1]);
        sacc[n][e] = p;
        l_run[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      oacc[n][0] *= alpha[0];
      oacc[n][1] *= alpha[0];
      oacc[n][2] *= alpha[1];
      oacc[n][3] *= alpha[1];
    }

    // O += P V: P's A fragment for keys 16kk.. is score tiles 2kk, 2kk+1
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_pair(sacc[2 * kk][0], sacc[2 * kk][1], ph[0], pl[0]);
      split_pair(sacc[2 * kk][2], sacc[2 * kk][3], ph[1], pl[1]);
      split_pair(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1], ph[2], pl[2]);
      split_pair(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, vt + (kk * 16 + lrow + (lmat & 1) * 8) * RS + dp * 16 + (lmat >> 1) * 8);
        mma_bf16(oacc[2 * dp], ph, bv[0], bv[1]);
        mma_bf16(oacc[2 * dp + 1], ph, bv[2], bv[3]);
        if constexpr (SPLIT_P) {
          mma_bf16(oacc[2 * dp], pl, bv[0], bv[1]);
          mma_bf16(oacc[2 * dp + 1], pl, bv[2], bv[3]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(FULL, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(FULL, l_run[r], 2);
    const int row = row0 + r * 8;
    if (row >= s) continue;
    const float denom = fmaxf(l_run[r], 1e-30f);
    __nv_bfloat16* orow = oh + (size_t)row * DH + 2 * tq;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(oacc[n][2 * r] / denom, oacc[n][2 * r + 1] / denom);
  }
}

// ---------------------------------------------------------------------------
// K6: one query token per row against a KV cache
// ---------------------------------------------------------------------------

template <int DH>
size_t decode_smem_floats(int group) {
  return (size_t)group * (DH + PAD) + TK * (DH + PAD) + TK * DH + group * TK
         + group * DH + 3 * group;
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_decode(const T* __restrict__ q, const T* __restrict__ kc,
             const T* __restrict__ vc, const int* __restrict__ lens,
             T* __restrict__ out, int h, int hkv, int t, float scale) {
  constexpr int QS = DH + PAD;
  const int group = h / hkv;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [group][DH+PAD]
  float* ks = qs + group * QS;                  // [TK][DH+PAD]
  float* vs = ks + TK * QS;                     // [TK][DH]
  float* ps = vs + TK * DH;                     // [group][TK]
  float* acc = ps + group * TK;                 // [group][DH]
  float* m_run = acc + group * DH;              // [group]
  float* l_run = m_run + group;                 // [group]
  float* alpha = l_run + group;                 // [group]

  const int kv_head = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int len = min(max(lens[b], 0), t);
  const size_t qoff = ((size_t)b * h + (size_t)kv_head * group) * DH;
  const T* kh = kc + ((size_t)b * hkv + kv_head) * t * DH;
  const T* vh = vc + ((size_t)b * hkv + kv_head) * t * DH;

  for (int i = threadIdx.x; i < group * DH; i += THREADS) {
    qs[(i / DH) * QS + i % DH] = to_f32(q[qoff + i]) * scale;
    acc[i] = 0.f;
  }
  for (int g = threadIdx.x; g < group; g += THREADS) {
    m_run[g] = NEG;
    l_run[g] = 0.f;
  }

  for (int k0 = 0; k0 < len; k0 += TK) {
    __syncthreads();  // previous tile consumed
    load_kv<T, DH>(kh, vh, ks, vs, k0, len);
    __syncthreads();
    for (int i = threadIdx.x; i < group * TK; i += THREADS) {
      const int g = i / TK, j = i % TK;
      const float* qr = qs + g * QS;
      const float* kr = ks + j * QS;
      float sc = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) sc = fmaf(qr[d], kr[d], sc);
      ps[i] = sc;
    }
    __syncthreads();
    for (int g = warp; g < group; g += WARPS) {
      const bool ok0 = k0 + lane < len, ok1 = k0 + lane + 32 < len;
      const float s0 = ok0 ? ps[g * TK + lane] : NEG;
      const float s1 = ok1 ? ps[g * TK + lane + 32] : NEG;
      const float m_old = m_run[g];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = ok0 ? expf(s0 - m_new) : 0.f;
      const float p1 = ok1 ? expf(s1 - m_new) : 0.f;
      ps[g * TK + lane] = p0;
      ps[g * TK + lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        alpha[g] = a;
        l_run[g] = a * l_run[g] + sum;
        m_run[g] = m_new;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < group * DH; i += THREADS) {
      const int g = i / DH, d = i % DH;
      const float* pr = ps + g * TK;
      float a = acc[i] * alpha[g];
#pragma unroll 8
      for (int j = 0; j < TK; ++j) a = fmaf(pr[j], vs[j * DH + d], a);
      acc[i] = a;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < group * DH; i += THREADS)
    out[qoff + i] = from_f32<T>(acc[i] / fmaxf(l_run[i / DH], 1e-30f));
}

template <typename T, int DH>
int launch_prefill(const void* q, const void* k, const void* v, void* out, int b,
                   int h, int hkv, int s, int t, float scale, int causal,
                   cudaStream_t stream) {
  const int smem = (int)(prefill_smem_floats<DH>() * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((s + TQ - 1) / TQ, h, b);
  flash_prefill<T, DH><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, h, hkv, s, t, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch_decode(const void* q, const void* kc, const void* vc, const int* lens,
                  void* out, int b, int h, int hkv, int t, float scale,
                  cudaStream_t stream) {
  const int smem = (int)(decode_smem_floats<DH>(h / hkv) * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(hkv, b);
  flash_decode<T, DH><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)kc, (const T*)vc, lens, (T*)out, h, hkv, t, scale);
  return (int)cudaGetLastError();
}

template <int DH, bool SPLIT_P>
int launch_prefill_mma(const void* q, const void* k, const void* v, void* out, int b,
                       int h, int hkv, int s, int t, float scale, int causal,
                       cudaStream_t stream) {
  const int smem = (int)mma_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_mma<DH, SPLIT_P>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((s + TQ - 1) / TQ, h, b);
  flash_prefill_mma<DH, SPLIT_P><<<grid, MMA_THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)out, h, hkv, s, t, scale * LOG2E, causal);
  return (int)cudaGetLastError();
}

// f32: the FP32 kernel; bf16: the tensor-core kernel (split P unless
// `split_p` is 0, which only the timing of a single-bf16 P asks for)
int prefill_dh(int dh, const void* q, const void* k, const void* v, void* out,
               int b, int h, int hkv, int s, int t, float scale, int causal,
               int bf16, int split_p, cudaStream_t st) {
#define REPRO_PREFILL_CASE(DH)                                                        \
  case DH:                                                                            \
    if (!bf16)                                                                        \
      return launch_prefill<float, DH>(q, k, v, out, b, h, hkv, s, t, scale, causal, st); \
    if (split_p)                                                                      \
      return launch_prefill_mma<DH, true>(q, k, v, out, b, h, hkv, s, t, scale, causal, st); \
    return launch_prefill_mma<DH, false>(q, k, v, out, b, h, hkv, s, t, scale, causal, st);
  switch (dh) {
    REPRO_PREFILL_CASE(16)
    REPRO_PREFILL_CASE(32)
    REPRO_PREFILL_CASE(64)
    REPRO_PREFILL_CASE(128)
  }
#undef REPRO_PREFILL_CASE
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int decode_dh(int dh, const void* q, const void* kc, const void* vc, const int* lens,
              void* out, int b, int h, int hkv, int t, float scale, cudaStream_t st) {
  switch (dh) {
    case 16: return launch_decode<T, 16>(q, kc, vc, lens, out, b, h, hkv, t, scale, st);
    case 32: return launch_decode<T, 32>(q, kc, vc, lens, out, b, h, hkv, t, scale, st);
    case 64: return launch_decode<T, 64>(q, kc, vc, lens, out, b, h, hkv, t, scale, st);
    case 128: return launch_decode<T, 128>(q, kc, vc, lens, out, b, h, hkv, t, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" size_t repro_flash_decode_smem(int group, int dh) {
  switch (dh) {
    case 16: return decode_smem_floats<16>(group) * sizeof(float);
    case 32: return decode_smem_floats<32>(group) * sizeof(float);
    case 64: return decode_smem_floats<64>(group) * sizeof(float);
    case 128: return decode_smem_floats<128>(group) * sizeof(float);
  }
  return 0;
}

extern "C" int repro_flash_attention(const void* q, const void* k, const void* v,
                                     void* out, int b, int h, int hkv, int s, int t,
                                     int dh, float scale, int causal, int bf16,
                                     int split_p, void* stream) {
  return prefill_dh(dh, q, k, v, out, b, h, hkv, s, t, scale, causal, bf16, split_p,
                    (cudaStream_t)stream);
}

extern "C" int repro_flash_decode(const void* q, const void* kc, const void* vc,
                                  const int* lens, void* out, int b, int h, int hkv,
                                  int t, int dh, float scale, int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return decode_dh<__nv_bfloat16>(dh, q, kc, vc, lens, out, b, h, hkv, t, scale, st);
  return decode_dh<float>(dh, q, kc, vc, lens, out, b, h, hkv, t, scale, st);
}
