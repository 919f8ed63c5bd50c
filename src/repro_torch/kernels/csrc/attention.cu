// Flash attention (prefill) and flash decode for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces two TPU kernels of the JAX package:
//   * repro/kernels/flash_attention.py  flash_attention_pallas (_flash_kernel)
//     -> repro_flash_attention (K5): q [B,H,S,Dh], k/v [B,Hkv,T,Dh] ->
//        [B,H,S,Dh], GQA (head h reads KV head h / (H/Hkv)), optionally
//        causal with query i attending keys <= i + (T - S); on request also
//        each row's log-sum-exp [B,H,S] f32 (m + log l of its running max
//        and sum, one store a row), the training backward's residual.
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
//     reference's pre-scaled product exactly; for Dh 32, 96 and 128 and any
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
// Head dims 16, 32, 64, 96 and 128 are built (phi3-mini's is 96).  Every path
// steps Dh in 16s (the k16 MMA steps, DH/16 output columns a thread in the
// f32 kernel, DH/16 ldmatrix.x4 pairs of 8-wide tiles, 16-byte copies), so
// 96 needs no power of two: its padded rows (208 bytes in bf16, 400 in f32)
// keep 16-byte alignment and ldmatrix's 8 rows on distinct banks.  At Dh 96
// the MMA kernel keeps the 2-blocks-an-SM register cap of Dh 128.
//
// K6 (flash_decode_split): bound by the bytes of K and V up to cache_len
// (3.35 TB/s); about one FLOP a byte at GQA group 8, so FP32 FMAs, not the
// tensor cores.  One block per (KV head, batch row, split) serves the whole
// GQA group, so each cached K/V row is read from device memory once per
// group.  The splits cut the cache into chunks of `chunk` keys (a multiple
// of 64) chosen by the host from T alone, never from cache_len, which stays
// on the card: at 8 rows x 4 KV heads x T 2048, 16 chunks of 128 keys, 512
// blocks, of which those whose chunk starts below cache_len[b] work and the
// rest return at once.  A block of 256 threads stages its chunk's K and V
// in shared memory with 16-byte cp.async copies (V lands while the scores
// are computed; rows padded by 16 bytes so the per-key row reads hit
// distinct banks), scores each key on 256 / chunk threads that split its
// group's heads, takes the chunk's softmax one warp per head with
// shuffles, and forms P.V one (head, column pair) per thread: three
// barriers a chunk.  A lone active chunk writes the output; otherwise every
// active block writes (m, l, acc) in f32 to scratch, and the last to
// finish, by an atomic ticket per (row, KV head) after a __threadfence,
// stages all the partials into its shared memory in one round of 16-byte
// copies (in batches, should they not fit) and combines them in split
// order: the new max, each split's weight, then acc and l; it clamps the
// denominator at 1e-30 once and rounds once.  It then puts the ticket back
// to 0, so a launch needs no memset and the scratch stays valid under a
// CUDA graph; launches that share scratch must run in order (the wrapper
// keeps one per stream).  cache_len 0 gives 0 (split 0 writes it).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TQ = 64;       // queries per K5 block
constexpr int TK = 64;       // keys per shared-memory tile
constexpr int THREADS = 256;
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
              const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
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
    // the half-warp shares the row's statistics: one store per row
    if (lse != nullptr && tx == 0)
      lse[((size_t)b * h + head) * s + qi] = m_run[i] + logf(denom);
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
constexpr float LN2 = 0.6931471805599453f;

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
                  float* __restrict__ lse, int h, int hkv, int s, int t, float scale_log2,
                  int causal) {
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
    // natural log: the running max is in the log2 domain; the quad shares it
    if (lse != nullptr && tq == 0)
      lse[((size_t)b * h + head) * s + row] =
          (m_run[r] == NEG ? NEG : m_run[r] * LN2) + logf(denom);
    __nv_bfloat16* orow = oh + (size_t)row * DH + 2 * tq;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(oacc[n][2 * r] / denom, oacc[n][2 * r + 1] / denom);
  }
}

// ---------------------------------------------------------------------------
// K6: one query token per row against a KV cache, split over the cache
// ---------------------------------------------------------------------------

constexpr int DEC_THREADS = 256;
constexpr int DEC_HB = 8;  // heads one thread scores per pass over a key

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// 16 bytes of a K row in shared memory -> f32
__device__ __forceinline__ void load16_f32(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load16_f32(const __nv_bfloat16* p, float (&o)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    o[2 * i] = __low2float(h);
    o[2 * i + 1] = __high2float(h);
  }
}
// two neighbouring elements of a V row in shared memory -> f32
__device__ __forceinline__ float2 load2_f32(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2_f32(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Floats of one split's partial: acc [group][DH], then m [group] and
// l [group], padded to 16 bytes so the partials copy in 16-byte units.
__host__ __device__ constexpr int dec_stride(int group, int dh) {
  return (group * (dh + 2) + 3) / 4 * 4;
}

// Bytes of the K/V region: K and V of a chunk (rows padded by 16 bytes),
// which the combining block reuses for the partials, so at least one.
template <typename T, int DH>
__host__ __device__ constexpr int dec_kv_bytes(int group, int chunk) {
  return 2 * chunk * (DH + 16 / (int)sizeof(T)) * (int)sizeof(T) > 4 * dec_stride(group, DH)
             ? 2 * chunk * (DH + 16 / (int)sizeof(T)) * (int)sizeof(T)
             : 4 * dec_stride(group, DH);
}

// Shared memory of one K6 block: the K/V region, the scaled queries of the
// group, the chunk's probabilities, and the chunk's (m, l) per head.
template <typename T, int DH>
size_t decode_smem_bytes(int group, int chunk) {
  return dec_kv_bytes<T, DH>(group, chunk)
         + sizeof(float) * ((size_t)group * DH + (size_t)group * chunk + 2 * group);
}

// Block (kv_head, b, split) owns keys [split * chunk, (split + 1) * chunk)
// of row b's cache.  Of the splits, the first n_active = ceil(len / chunk)
// hold valid keys; the rest return at once.  A lone active split writes the
// output itself; otherwise each writes its partial (m, l, acc) and the last
// to finish, by an atomic ticket, combines them in split order.
template <typename T, int DH>
__global__ void __launch_bounds__(DEC_THREADS)
flash_decode_split(const T* __restrict__ q, const T* __restrict__ kc,
                   const T* __restrict__ vc, const int* __restrict__ lens,
                   T* __restrict__ out, float* __restrict__ part,
                   int* __restrict__ tickets, int h, int hkv, int t, int chunk,
                   float scale) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int CH = DH / VEC;         // 16-byte copies per row
  constexpr int RS = DH + VEC;         // padded row, elements
  const int group = h / hkv;
  extern __shared__ float4 smem4[];
  T* ks = reinterpret_cast<T*>(smem4);                    // [chunk][RS]
  T* vs = ks + (size_t)chunk * RS;                        // [chunk][RS]
  const int kv_bytes = dec_kv_bytes<T, DH>(group, chunk);
  float* qs = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) + kv_bytes);  // [group][DH]
  float* ps = qs + group * DH;                            // [group][chunk]
  float* ml = ps + group * chunk;                         // m[group], l[group]
  __shared__ int s_last;

  const int kv_head = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int len = min(max(lens[b], 0), t);
  const int n_active = (len + chunk - 1) / chunk;
  const size_t bh = (size_t)b * hkv + kv_head;
  const size_t qoff = ((size_t)b * h + (size_t)kv_head * group) * DH;
  if (split >= n_active) {
    if (split == 0)  // len 0: nothing is attended and the row is 0
      for (int i = tid; i < group * DH; i += DEC_THREADS) out[qoff + i] = from_f32<T>(0.f);
    return;
  }
  const int k0 = split * chunk;
  const int nk = min(chunk, len - k0);      // valid keys, >= 1
  const int nk4 = min(chunk, (nk + 3) & ~3);  // rows staged (zero past nk)
  const T* kh = kc + (bh * t + k0) * DH;
  const T* vh = vc + (bh * t + k0) * DH;

  // K, then V, in 16-byte copies; V lands while the scores are computed
  for (int i = tid; i < nk4 * CH; i += DEC_THREADS) {
    const int r = i / CH, c = i % CH;
    cp_async16(ks + r * RS + c * VEC, r < nk ? kh + (size_t)r * DH + c * VEC : kh, r < nk);
  }
  cp_async_commit();
  for (int i = tid; i < nk4 * CH; i += DEC_THREADS) {
    const int r = i / CH, c = i % CH;
    cp_async16(vs + r * RS + c * VEC, r < nk ? vh + (size_t)r * DH + c * VEC : vh, r < nk);
  }
  cp_async_commit();
  for (int i = tid; i < group * DH; i += DEC_THREADS) qs[i] = to_f32(q[qoff + i]) * scale;
  cp_async_wait_one();
  __syncthreads();  // [1] q and K staged

  // scores: tpk threads per key (one when the chunk has a key per thread),
  // each taking every tpk-th head, DEC_HB heads per pass over the key's row
  const int tpk = max(1, DEC_THREADS / chunk);
  for (int jj = tid; jj < nk * tpk; jj += DEC_THREADS) {
    const int j = jj / tpk;
    const T* kr = ks + j * RS;
    for (int g0 = jj % tpk; g0 < group; g0 += tpk * DEC_HB) {
      float sc[DEC_HB];
#pragma unroll
      for (int u = 0; u < DEC_HB; ++u) sc[u] = 0.f;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        float kf[VEC];
        load16_f32(kr + c * VEC, kf);
#pragma unroll
        for (int u = 0; u < DEC_HB; ++u) {
          if (g0 + u * tpk < group) {
            const float* qr = qs + (g0 + u * tpk) * DH + c * VEC;
#pragma unroll
            for (int e = 0; e < VEC; e += 4) {
              const float4 q4 = *reinterpret_cast<const float4*>(qr + e);
              sc[u] = fmaf(q4.x, kf[e], sc[u]);
              sc[u] = fmaf(q4.y, kf[e + 1], sc[u]);
              sc[u] = fmaf(q4.z, kf[e + 2], sc[u]);
              sc[u] = fmaf(q4.w, kf[e + 3], sc[u]);
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < DEC_HB; ++u)
        if (g0 + u * tpk < group) ps[(g0 + u * tpk) * chunk + j] = sc[u];
    }
  }
  __syncthreads();  // [2] scores written

  // softmax of the chunk: one warp per head, max and sum by shuffles
  for (int g = warp; g < group; g += DEC_THREADS / 32) {
    float* pr = ps + g * chunk;
    float mx = NEG;
    for (int j = lane; j < nk; j += 32) mx = fmaxf(mx, pr[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < nk4; j += 32) {
      const float p = j < nk ? expf(pr[j] - mx) : 0.f;
      pr[j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      ml[g] = mx;
      ml[group + g] = sum;
    }
  }
  cp_async_wait_all();
  __syncthreads();  // [3] probabilities written, V staged

  // P.V: one (head, column pair) per thread
  const int stride = dec_stride(group, DH);
  float* mine = part + (bh * gridDim.z + split) * stride;
  for (int o = tid; o < group * DH / 2; o += DEC_THREADS) {
    const int g = 2 * o / DH, d = 2 * o % DH;
    const float* pr = ps + g * chunk;
    float a0 = 0.f, a1 = 0.f;
    for (int j = 0; j < nk4; j += 4) {
      const float4 p4 = *reinterpret_cast<const float4*>(pr + j);
      const float2 v0 = load2_f32(vs + j * RS + d), v1 = load2_f32(vs + (j + 1) * RS + d);
      const float2 v2 = load2_f32(vs + (j + 2) * RS + d), v3 = load2_f32(vs + (j + 3) * RS + d);
      a0 = fmaf(p4.x, v0.x, a0); a1 = fmaf(p4.x, v0.y, a1);
      a0 = fmaf(p4.y, v1.x, a0); a1 = fmaf(p4.y, v1.y, a1);
      a0 = fmaf(p4.z, v2.x, a0); a1 = fmaf(p4.z, v2.y, a1);
      a0 = fmaf(p4.w, v3.x, a0); a1 = fmaf(p4.w, v3.y, a1);
    }
    if (n_active == 1) {
      const float denom = fmaxf(ml[group + g], 1e-30f);
      out[qoff + g * DH + d] = from_f32<T>(a0 / denom);
      out[qoff + g * DH + d + 1] = from_f32<T>(a1 / denom);
    } else {
      *reinterpret_cast<float2*>(mine + g * DH + d) = make_float2(a0, a1);
    }
  }
  if (n_active == 1) return;
  for (int g = tid; g < 2 * group; g += DEC_THREADS) mine[group * DH + g] = ml[g];

  // the last split of (b, kv_head) to finish combines all of them
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&tickets[bh], 1) == n_active - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // Stage the partials into the K/V region with 16-byte copies, in
  // batches that fit (one at the LM path's shapes), and fold each batch
  // into a running (max, sum, acc) kept in the freed q and score regions:
  // per head the new max, the old sums' rescale and each split's weight,
  // then every output in split order.
  const int cap = kv_bytes / (4 * stride);
  float* buf = reinterpret_cast<float*>(smem4);  // [cap][stride]
  float* run_acc = qs;                           // [group][DH]
  float* run_m = ps;                             // [group]
  float* run_l = ps + group;                     // [group]
  float* rescale = ps + 2 * group;               // [group]
  for (int i = tid; i < group * DH; i += DEC_THREADS) run_acc[i] = 0.f;
  for (int g = tid; g < group; g += DEC_THREADS) {
    run_m[g] = NEG;
    run_l[g] = 0.f;
  }
  const float* first = part + bh * gridDim.z * stride;
  for (int s0 = 0; s0 < n_active; s0 += cap) {
    const int nb = min(cap, n_active - s0);
    for (int i = tid; i < nb * stride / 4; i += DEC_THREADS)
      cp_async16(buf + 4 * i, first + (size_t)s0 * stride + 4 * i, true);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    for (int g = tid; g < group; g += DEC_THREADS) {
      float m_new = run_m[g];
      for (int sp = 0; sp < nb; ++sp) m_new = fmaxf(m_new, buf[sp * stride + group * DH + g]);
      const float r = expf(run_m[g] - m_new);
      float l = run_l[g] * r;
      for (int sp = 0; sp < nb; ++sp) {
        float* ml_sp = buf + sp * stride + group * DH;
        const float w = expf(ml_sp[g] - m_new);
        l = fmaf(w, ml_sp[group + g], l);
        ml_sp[g] = w;  // the split's weight, in place of its max
      }
      run_m[g] = m_new;
      run_l[g] = l;
      rescale[g] = r;
    }
    __syncthreads();
    for (int o = tid; o < group * DH; o += DEC_THREADS) {
      const int g = o / DH;
      float acc = run_acc[o] * rescale[g];
      for (int sp = 0; sp < nb; ++sp)
        acc = fmaf(buf[sp * stride + group * DH + g], buf[sp * stride + o], acc);
      run_acc[o] = acc;
    }
    __syncthreads();
  }
  for (int o = tid; o < group * DH; o += DEC_THREADS)
    out[qoff + o] = from_f32<T>(run_acc[o] / fmaxf(run_l[o / DH], 1e-30f));
  if (tid == 0) tickets[bh] = 0;  // ready for the next launch, no memset
}

template <typename T, int DH>
int launch_prefill(const void* q, const void* k, const void* v, void* out, float* lse,
                   int b, int h, int hkv, int s, int t, float scale, int causal,
                   cudaStream_t stream) {
  const int smem = (int)(prefill_smem_floats<DH>() * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((s + TQ - 1) / TQ, h, b);
  flash_prefill<T, DH><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, h, hkv, s, t, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch_decode(const void* q, const void* kc, const void* vc, const int* lens,
                  void* out, float* part, int* tickets, int b, int h, int hkv, int t,
                  int chunk, int n_split, float scale, cudaStream_t stream) {
  static int smem_set = 48 * 1024;  // dynamic shared memory allowed so far
  const int smem = (int)decode_smem_bytes<T, DH>(h / hkv, chunk);
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_decode_split<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  dim3 grid(hkv, b, n_split);
  flash_decode_split<T, DH><<<grid, DEC_THREADS, smem, stream>>>(
      (const T*)q, (const T*)kc, (const T*)vc, lens, (T*)out, part, tickets, h, hkv, t,
      chunk, scale);
  return (int)cudaGetLastError();
}

template <int DH, bool SPLIT_P>
int launch_prefill_mma(const void* q, const void* k, const void* v, void* out, float* lse,
                       int b, int h, int hkv, int s, int t, float scale, int causal,
                       cudaStream_t stream) {
  const int smem = (int)mma_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_mma<DH, SPLIT_P>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((s + TQ - 1) / TQ, h, b);
  flash_prefill_mma<DH, SPLIT_P><<<grid, MMA_THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)out, lse, h, hkv, s, t, scale * LOG2E, causal);
  return (int)cudaGetLastError();
}

// f32: the FP32 kernel; bf16: the tensor-core kernel (split P unless
// `split_p` is 0, which only the timing of a single-bf16 P asks for)
int prefill_dh(int dh, const void* q, const void* k, const void* v, void* out,
               float* lse, int b, int h, int hkv, int s, int t, float scale, int causal,
               int bf16, int split_p, cudaStream_t st) {
#define REPRO_PREFILL_CASE(DH)                                                        \
  case DH:                                                                            \
    if (!bf16)                                                                        \
      return launch_prefill<float, DH>(q, k, v, out, lse, b, h, hkv, s, t, scale,     \
                                       causal, st);                                   \
    if (split_p)                                                                      \
      return launch_prefill_mma<DH, true>(q, k, v, out, lse, b, h, hkv, s, t, scale,  \
                                          causal, st);                                \
    return launch_prefill_mma<DH, false>(q, k, v, out, lse, b, h, hkv, s, t, scale,   \
                                         causal, st);
  switch (dh) {
    REPRO_PREFILL_CASE(16)
    REPRO_PREFILL_CASE(32)
    REPRO_PREFILL_CASE(64)
    REPRO_PREFILL_CASE(96)
    REPRO_PREFILL_CASE(128)
  }
#undef REPRO_PREFILL_CASE
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int decode_dh(int dh, const void* q, const void* kc, const void* vc, const int* lens,
              void* out, float* part, int* tickets, int b, int h, int hkv, int t,
              int chunk, int n_split, float scale, cudaStream_t st) {
#define REPRO_DECODE_CASE(DH)                                                     \
  case DH:                                                                        \
    return launch_decode<T, DH>(q, kc, vc, lens, out, part, tickets, b, h, hkv, t, \
                                chunk, n_split, scale, st);
  switch (dh) {
    REPRO_DECODE_CASE(16)
    REPRO_DECODE_CASE(32)
    REPRO_DECODE_CASE(64)
    REPRO_DECODE_CASE(96)
    REPRO_DECODE_CASE(128)
  }
#undef REPRO_DECODE_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" size_t repro_flash_decode_smem(int group, int dh, int chunk, int bf16) {
  switch (dh * 2 + (bf16 != 0)) {
    case 32: return decode_smem_bytes<float, 16>(group, chunk);
    case 33: return decode_smem_bytes<__nv_bfloat16, 16>(group, chunk);
    case 64: return decode_smem_bytes<float, 32>(group, chunk);
    case 65: return decode_smem_bytes<__nv_bfloat16, 32>(group, chunk);
    case 128: return decode_smem_bytes<float, 64>(group, chunk);
    case 129: return decode_smem_bytes<__nv_bfloat16, 64>(group, chunk);
    case 192: return decode_smem_bytes<float, 96>(group, chunk);
    case 193: return decode_smem_bytes<__nv_bfloat16, 96>(group, chunk);
    case 256: return decode_smem_bytes<float, 128>(group, chunk);
    case 257: return decode_smem_bytes<__nv_bfloat16, 128>(group, chunk);
  }
  return 0;
}

// lse: [B, H, S] f32, each row's natural log-sum-exp of its scaled scores
// (the backward's residual), or null to write none.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v,
                                     void* out, void* lse, int b, int h, int hkv, int s,
                                     int t, int dh, float scale, int causal, int bf16,
                                     int split_p, void* stream) {
  return prefill_dh(dh, q, k, v, out, (float*)lse, b, h, hkv, s, t, scale, causal, bf16,
                    split_p, (cudaStream_t)stream);
}

// part: [B * Hkv * n_split * dec_stride(group, Dh)] f32 scratch; tickets: [B * Hkv]
// int32, zero before the first launch and left zero by every launch.
extern "C" int repro_flash_decode(const void* q, const void* kc, const void* vc,
                                  const int* lens, void* out, float* part, int* tickets,
                                  int b, int h, int hkv, int t, int dh, int chunk,
                                  int n_split, float scale, int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (chunk < 4 || chunk % 4 || n_split < 1 || (long long)chunk * n_split < t)
    return (int)cudaErrorInvalidValue;
  if (bf16)
    return decode_dh<__nv_bfloat16>(dh, q, kc, vc, lens, out, part, tickets, b, h, hkv, t,
                                    chunk, n_split, scale, st);
  return decode_dh<float>(dh, q, kc, vc, lens, out, part, tickets, b, h, hkv, t, chunk,
                          n_split, scale, st);
}
