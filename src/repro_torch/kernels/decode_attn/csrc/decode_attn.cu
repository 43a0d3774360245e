// Decode attention for Hopper (sm_90a): one query token per (batch, q-head)
// against a (B, S, Hkv, D) KV cache whose first lengths[b] slots are valid.
//
// Replaces the TPU kernel src/repro/kernels/decode_attn/kernel.py
// (_decode_kernel / decode_attention_kernel): online softmax in f32 with an
// optional tanh softcap, applied in the order scale, softcap, mask, masked
// scores filled with -1e30 (never -inf, so no inf - inf).
//
// Bound: bytes. A step reads each valid K and V row once and does 4*D
// operations per row and query head, far below the card's ~295 operations
// per byte. The design keeps many loads in flight and reads nothing twice:
//  * split-KV (flash-decoding): grid (splits, Hkv, B); a block streams one
//    chunk of one KV head's cache, so B*Hkv*splits blocks fill the card
//    even at batch 4;
//  * GQA by index: a block serves all G = Hq/Hkv query heads of its KV
//    head, so each K/V row is read once for G heads, never through a
//    repeated copy;
//  * a warp takes kKeys keys per step, issues all their loads before the
//    math, and its lanes split D (16-byte loads for bf16 at D = 256);
//  * the loop stops at lengths[b], so slots past it are never read; a
//    second pass merges the splits' (max, sum, acc) partials in f32.
// A length of 0 reproduces the TPU kernel's all-masked row: every score
// is -1e30, so the softmax is uniform over the S slots.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kKeys = 4;  // keys a warp loads per step

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// E contiguous elements starting at p, as f32.
template <int E>
__device__ __forceinline__ void load_row(const float* __restrict__ p, float (&o)[E]) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int i = 0; i < E / 4; ++i) {
      const float4 t = reinterpret_cast<const float4*>(p)[i];
      o[4 * i] = t.x; o[4 * i + 1] = t.y; o[4 * i + 2] = t.z; o[4 * i + 3] = t.w;
    }
  } else if constexpr (E == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    o[0] = t.x; o[1] = t.y;
  } else {
    o[0] = p[0];
  }
}

template <int E>
__device__ __forceinline__ void load_row(const __nv_bfloat16* __restrict__ p, float (&o)[E]) {
  if constexpr (E % 8 == 0) {
#pragma unroll
    for (int i = 0; i < E / 8; ++i) {
      const uint4 t = reinterpret_cast<const uint4*>(p)[i];
      o[8 * i + 0] = bf16_lo(t.x); o[8 * i + 1] = bf16_hi(t.x);
      o[8 * i + 2] = bf16_lo(t.y); o[8 * i + 3] = bf16_hi(t.y);
      o[8 * i + 4] = bf16_lo(t.z); o[8 * i + 5] = bf16_hi(t.z);
      o[8 * i + 6] = bf16_lo(t.w); o[8 * i + 7] = bf16_hi(t.w);
    }
  } else if constexpr (E == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    o[0] = bf16_lo(t.x); o[1] = bf16_hi(t.x); o[2] = bf16_lo(t.y); o[3] = bf16_hi(t.y);
  } else if constexpr (E == 2) {
    const uint32_t t = *reinterpret_cast<const uint32_t*>(p);
    o[0] = bf16_lo(t); o[1] = bf16_hi(t);
  } else {
    o[0] = __bfloat162float(p[0]);
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Pass 1: one block per (split, kv head, batch row). Writes, for each of
// the G query heads, the split's running max m, sum l (part_ml) and
// unnormalised accumulator (part_acc), all relative to m.
template <typename TQ, typename TKV, int D, int G>
__global__ void __launch_bounds__(kWarps * 32)
decode_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                    const TKV* __restrict__ v, const int* __restrict__ lengths,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int S, int Hkv, int chunk, float scale, float softcap) {
  constexpr int E = D / 32;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int Hq = Hkv * G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  int len = lengths[b];
  const bool all_masked = len <= 0;
  len = all_masked ? S : min(len, S);
  const int start = split * chunk;
  const int end = min(start + chunk, len);

  float qf[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load_row<E>(q + ((size_t)b * Hq + (size_t)kvh * G + g) * D + lane * E, qf[g]);
  }
  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  const size_t row_stride = (size_t)Hkv * D;
  const TKV* kb = k + ((size_t)b * S * Hkv + kvh) * D + lane * E;
  const TKV* vb = v + ((size_t)b * S * Hkv + kvh) * D + lane * E;

  for (int base = start + warp * kKeys; base < end; base += kWarps * kKeys) {
    float kr[kKeys][E], vr[kKeys][E];
#pragma unroll
    for (int u = 0; u < kKeys; ++u) {
      if (base + u < end) {
        load_row<E>(kb + (size_t)(base + u) * row_stride, kr[u]);
        load_row<E>(vb + (size_t)(base + u) * row_stride, vr[u]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) { kr[u][e] = 0.f; vr[u][e] = 0.f; }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s[kKeys];
#pragma unroll
      for (int u = 0; u < kKeys; ++u) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(qf[g][e], kr[u][e], d);
        s[u] = d;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int u = 0; u < kKeys; ++u) s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
      }
      float smax = m[g];
#pragma unroll
      for (int u = 0; u < kKeys; ++u) {
        float x = s[u] * scale;
        if (softcap != 0.f) x = tanhf(x / softcap) * softcap;
        if (all_masked) x = kNegInf;
        s[u] = x;
        if (base + u < end) smax = fmaxf(smax, x);
      }
      const float corr = expf(m[g] - smax);
      float p[kKeys], psum = 0.f;
#pragma unroll
      for (int u = 0; u < kKeys; ++u) {
        p[u] = (base + u < end) ? expf(s[u] - smax) : 0.f;
        psum += p[u];
      }
      l[g] = l[g] * corr + psum;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float a = acc[g][e] * corr;
#pragma unroll
        for (int u = 0; u < kKeys; ++u) a = fmaf(p[u], vr[u][e], a);
        acc[g][e] = a;
      }
      m[g] = smax;
    }
  }

  // Merge the block's warps, then write this split's partial.
  extern __shared__ float smem[];
  float* s_acc = smem;                      // [kWarps][G][D]
  float* s_m = s_acc + kWarps * G * D;      // [kWarps][G]
  float* s_l = s_m + kWarps * G;            // [kWarps][G]
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < E; ++e) s_acc[(warp * G + g) * D + lane * E + e] = acc[g][e];
    if (lane == 0) {
      s_m[warp * G + g] = m[g];
      s_l[warp * G + g] = l[g];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int g = idx / D, d = idx % D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, s_m[w * G + g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(s_m[w * G + g] - M);
      L += s_l[w * G + g] * c;
      A += s_acc[(w * G + g) * D + d] * c;
    }
    const size_t row = ((size_t)b * Hq + (size_t)kvh * G + g) * nsplit + split;
    part_acc[row * D + d] = A;
    if (d == 0) {
      part_ml[row * 2] = M;
      part_ml[row * 2 + 1] = L;
    }
  }
}

// Pass 2: one block per (batch row, q head) merges the splits.
template <typename TO>
__global__ void decode_combine_kernel(const float* __restrict__ part_acc,
                                      const float* __restrict__ part_ml,
                                      TO* __restrict__ out, int nsplit, int D) {
  const size_t row = blockIdx.x;
  const float* ml = part_ml + row * nsplit * 2;
  float M = kNegInf;
  for (int s = 0; s < nsplit; ++s) M = fmaxf(M, ml[2 * s]);
  float L = 0.f;
  for (int s = 0; s < nsplit; ++s) L += ml[2 * s + 1] * expf(ml[2 * s] - M);
  const float inv = 1.f / fmaxf(L, 1e-30f);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float A = 0.f;
    for (int s = 0; s < nsplit; ++s)
      A += part_acc[(row * nsplit + s) * D + d] * expf(ml[2 * s] - M);
    store(out + row * D + d, A * inv);
  }
}

template <typename TQ, typename TKV, int D, int G>
cudaError_t launch_typed(const void* q, const void* k, const void* v, const int* lengths,
                         void* out, float* part_acc, float* part_ml, int B, int S, int Hkv,
                         int nsplit, int chunk, float scale, float softcap, cudaStream_t st) {
  const dim3 grid(nsplit, Hkv, B);
  const size_t smem = (size_t)kWarps * G * (D + 2) * sizeof(float);
  decode_split_kernel<TQ, TKV, D, G><<<grid, kWarps * 32, smem, st>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      lengths, part_acc, part_ml, S, Hkv, chunk, scale, softcap);
  decode_combine_kernel<TQ><<<B * Hkv * G, D < 32 ? 32 : D, 0, st>>>(
      part_acc, part_ml, static_cast<TQ*>(out), nsplit, D);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int D>
cudaError_t launch_d(int G, const void* q, const void* k, const void* v, const int* lengths,
                     void* out, float* pa, float* pm, int B, int S, int Hkv, int nsplit,
                     int chunk, float scale, float softcap, cudaStream_t st) {
  switch (G) {
    case 1: return launch_typed<TQ, TKV, D, 1>(q, k, v, lengths, out, pa, pm, B, S, Hkv, nsplit, chunk, scale, softcap, st);
    case 2: return launch_typed<TQ, TKV, D, 2>(q, k, v, lengths, out, pa, pm, B, S, Hkv, nsplit, chunk, scale, softcap, st);
    case 4: return launch_typed<TQ, TKV, D, 4>(q, k, v, lengths, out, pa, pm, B, S, Hkv, nsplit, chunk, scale, softcap, st);
    case 8: return launch_typed<TQ, TKV, D, 8>(q, k, v, lengths, out, pa, pm, B, S, Hkv, nsplit, chunk, scale, softcap, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TQ, typename TKV>
cudaError_t launch_t(int D, int G, const void* q, const void* k, const void* v,
                     const int* lengths, void* out, float* pa, float* pm, int B, int S,
                     int Hkv, int nsplit, int chunk, float scale, float softcap,
                     cudaStream_t st) {
  switch (D) {
    case 32: return launch_d<TQ, TKV, 32>(G, q, k, v, lengths, out, pa, pm, B, S, Hkv, nsplit, chunk, scale, softcap, st);
    case 64: return launch_d<TQ, TKV, 64>(G, q, k, v, lengths, out, pa, pm, B, S, Hkv, nsplit, chunk, scale, softcap, st);
    case 128: return launch_d<TQ, TKV, 128>(G, q, k, v, lengths, out, pa, pm, B, S, Hkv, nsplit, chunk, scale, softcap, st);
    case 256: return launch_d<TQ, TKV, 256>(G, q, k, v, lengths, out, pa, pm, B, S, Hkv, nsplit, chunk, scale, softcap, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16. q and out share q_dtype; the
// cache may be bf16 under f32 queries (the reference keeps its KV cache in
// bf16 for f32 parameters). Returns cudaGetLastError() after the launches,
// or cudaErrorInvalidValue for a shape or type the kernel does not take.
int decode_attn_launch(const void* q, const void* k, const void* v, const void* lengths,
                       void* out, void* part_acc, void* part_ml, int B, int S, int Hq,
                       int Hkv, int D, int nsplit, int chunk, float scale, float softcap,
                       int q_dtype, int kv_dtype, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || nsplit <= 0 || chunk <= 0) return cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  const int* len = static_cast<const int*>(lengths);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0)
    return launch_t<float, float>(D, G, q, k, v, len, out, pa, pm, B, S, Hkv, nsplit, chunk, scale, softcap, st);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch_t<__nv_bfloat16, __nv_bfloat16>(D, G, q, k, v, len, out, pa, pm, B, S, Hkv, nsplit, chunk, scale, softcap, st);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch_t<float, __nv_bfloat16>(D, G, q, k, v, len, out, pa, pm, B, S, Hkv, nsplit, chunk, scale, softcap, st);
  return cudaErrorInvalidValue;
}

const char* decode_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
