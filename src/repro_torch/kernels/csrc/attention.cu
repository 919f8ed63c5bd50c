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
// Arithmetic, as in the TPU kernels: q is scaled in f32 before the
// product; scores, probabilities and the P.V sums stay f32 (FP32 FMAs, no
// tensor cores, no TF32, no bf16 P); an online softmax keeps a running
// (max, denominator, accumulator) per query row; masked scores are -1e30
// and contribute exactly 0 (so a row with no valid key gives 0, not the
// TPU kernel's uniform average over masked keys, which no caller reaches);
// the denominator is clamped at 1e-30; the output is rounded once to q's
// type.
//
// What bounds them on an H100.  K5 does 4*B*H*Dh*S(S+1)/2 FLOPs causal
// against a few bytes per FLOP's worth of inputs, so FP32 operations (67
// TFLOP/s outside the tensor cores) bound it: 0.51 ms at B=8, H=32, S=1024,
// Dh=64.  K6 does 4 FLOPs per cached byte pair and is bound by the bytes of
// K and V up to cache_len (3.35 TB/s).
//
// Design.  K5: one block of 256 threads per (64-query tile, head, batch
// row).  The scaled Q tile sits in shared memory for the whole block; K and
// V stream through shared memory in 64-key tiles, only up to the causal
// limit of the tile's last query, so tiles above the diagonal are never
// loaded.  Each thread owns a 4x4 patch of the 64x64 score tile (rows
// ty+16i, keys tx+16j) and a 4-row by Dh/16-column patch of the output
// (columns tx*Dh/16 ...), so the row statistics reduce across the 16 lanes
// of a half-warp with shuffles and never touch shared memory.  Shared rows
// are padded by 4 floats so the float4 reads of Q, K and P hit distinct
// banks.  K6: one block per (batch row, KV head) serves that head's whole
// GQA group, so each cached K/V row is read from device memory once for
// the group; the block walks the cache in 64-key tiles up to cache_len[b]
// (clamped to T), one warp per query head keeps that head's softmax state.
// With B*Hkv blocks (32 at B=8, Hkv=4 on 132 SMs) K6 is latency-bound;
// splitting the cache across blocks with a combining pass is the later
// redesign.

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

template <typename T>
int prefill_dh(int dh, const void* q, const void* k, const void* v, void* out,
               int b, int h, int hkv, int s, int t, float scale, int causal,
               cudaStream_t st) {
  switch (dh) {
    case 16: return launch_prefill<T, 16>(q, k, v, out, b, h, hkv, s, t, scale, causal, st);
    case 32: return launch_prefill<T, 32>(q, k, v, out, b, h, hkv, s, t, scale, causal, st);
    case 64: return launch_prefill<T, 64>(q, k, v, out, b, h, hkv, s, t, scale, causal, st);
    case 128: return launch_prefill<T, 128>(q, k, v, out, b, h, hkv, s, t, scale, causal, st);
  }
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

// Bytes of dynamic shared memory one block takes (0: head_dim not built).
extern "C" size_t repro_flash_attention_smem(int dh) {
  switch (dh) {
    case 16: return prefill_smem_floats<16>() * sizeof(float);
    case 32: return prefill_smem_floats<32>() * sizeof(float);
    case 64: return prefill_smem_floats<64>() * sizeof(float);
    case 128: return prefill_smem_floats<128>() * sizeof(float);
  }
  return 0;
}

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
                                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return prefill_dh<__nv_bfloat16>(dh, q, k, v, out, b, h, hkv, s, t, scale, causal, st);
  return prefill_dh<float>(dh, q, k, v, out, b, h, hkv, s, t, scale, causal, st);
}

extern "C" int repro_flash_decode(const void* q, const void* kc, const void* vc,
                                  const int* lens, void* out, int b, int h, int hkv,
                                  int t, int dh, float scale, int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return decode_dh<__nv_bfloat16>(dh, q, kc, vc, lens, out, b, h, hkv, t, scale, st);
  return decode_dh<float>(dh, q, kc, vc, lens, out, b, h, hkv, t, scale, st);
}
