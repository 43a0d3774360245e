// Flash attention forward for Hopper (sm_90a): q (B, Sq, Hq, D) against
// k, v (B, Skv, Hkv, D), causal or not, with an optional local window (only
// when causal) and an optional tanh softcap.
//
// Replaces the TPU kernel src/repro/kernels/flash_attn/kernel.py
// (_attn_kernel / flash_attention_kernel): tiled online softmax in f32,
// scale then softcap then mask, masked scores -1e30 (never -inf), keys past
// Skv masked. Where the TPU kernel skips tiles wholly above the diagonal or
// outside the window, a block here runs its KV loop only over [lo, hi).
// GQA is an index map (q head h reads kv head h / (Hq/Hkv)); no repeated
// copy of K or V is built, and no padded copy either: rows past Sq or Skv
// are zero-filled in shared memory.
//
// Bound: operations. At gemma2-2b's prefill (S = 4608, D = 256) a (q, k)
// pair costs 4*D operations against a few bytes of input, so the tensor
// cores are the ceiling. Two kernels:
//  * bf16: flash_mma_kernel runs both products on the tensor cores with
//    mma.sync m16n8k16 (bf16 in, f32 accumulate). A block of 4 warps owns
//    64 query rows (16 a warp) and streams 64-key K/V tiles through shared
//    memory; rows are padded by 8 elements so the fragment loads are free
//    of bank conflicts. P is rounded to bf16 for the PV product, as the
//    reference's attention_core rounds p to V's dtype. The running max and
//    sum stay in f32 registers; the (16 x D) f32 accumulator is D/2
//    registers a thread (128 at D = 256), which is why a warp owns only 16
//    rows and the block is launched with one block's registers per SM in
//    mind (__launch_bounds__(128, 1)).
//  * f32: flash_f32_kernel keeps f32 end to end (TF32 would miss the f32
//    tolerance of 2e-5). A lane scores one key of a 32-key tile against 8
//    query rows with float4 reads of shared memory, and the PV product
//    broadcasts p across the warp with shuffles. It runs on the CUDA
//    cores, far from the tensor-core bound; it serves f32 checks, not the
//    bf16 serving path.
// Simple and synchronous: no cp.async or TMA pipelining and no wgmma yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;  // 4 warps

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Score of one (query, key) pair after scale, softcap and mask.
__device__ __forceinline__ float masked_score(float dot, float scale, float softcap, int qpos,
                                              int kpos, int Skv, int causal, int window) {
  float x = dot * scale;
  if (softcap != 0.f) x = tanhf(x / softcap) * softcap;
  bool valid = kpos < Skv;
  if (causal) {
    valid = valid && kpos <= qpos;
    if (window > 0) valid = valid && (qpos - kpos) < window;
  }
  return valid ? x : kNegInf;
}

// KV range [lo, hi) that a block of query rows [q_start, q_end) needs,
// lo rounded down to a tile boundary.
__device__ __forceinline__ void kv_range(int q_start, int q_end, int Skv, int causal, int window,
                                         int tile, int& lo, int& hi) {
  lo = 0;
  hi = Skv;
  if (causal) {
    hi = min(Skv, q_end);
    if (window > 0) lo = max(0, q_start - window + 1);
  }
  lo -= lo % tile;
}

// ---------------------------------------------------------------- f32 path
constexpr int kF32Rows = 8;                   // query rows a warp owns
constexpr int kF32BQ = 4 * kF32Rows;          // 32 query rows a block
constexpr int kF32BK = 32;                    // keys a tile (one a lane)

template <int D>
constexpr size_t f32_smem_bytes() {
  return (size_t)(kF32BQ * D + kF32BK * (D + 4) + kF32BK * D) * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int Sq, int Skv,
                 int Hq, int Hkv, float scale, float softcap, int causal, int window) {
  constexpr int E = D / 32;
  constexpr int KP = D + 4;  // K row pitch: float4 reads by 8 lanes hit distinct banks
  extern __shared__ float smem[];
  float* Qs = smem;                  // [BQ][D]
  float* Ks = Qs + kF32BQ * D;       // [BK][KP]
  float* Vs = Ks + kF32BK * KP;      // [BK][D]

  const int q_start = blockIdx.x * kF32BQ;
  const int b = blockIdx.y / Hq, h = blockIdx.y % Hq, kvh = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t q_row = (size_t)Hq * D, kv_row = (size_t)Hkv * D;
  const float* qb = q + ((size_t)b * Sq * Hq + h) * D;
  const float* kb = k + ((size_t)b * Skv * Hkv + kvh) * D;
  const float* vb = v + ((size_t)b * Skv * Hkv + kvh) * D;

  for (int i = threadIdx.x; i < kF32BQ * D / 4; i += kThreads) {
    const int r = i * 4 / D, c = i * 4 % D;
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q_start + r < Sq) t = *reinterpret_cast<const float4*>(qb + (q_start + r) * q_row + c);
    *reinterpret_cast<float4*>(Qs + r * D + c) = t;
  }
  const int q_end = min(q_start + kF32BQ, Sq);
  int lo, hi;
  kv_range(q_start, q_end, Skv, causal, window, kF32BK, lo, hi);

  float m[kF32Rows], l[kF32Rows], acc[kF32Rows][E];
#pragma unroll
  for (int i = 0; i < kF32Rows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
  }

  for (int kt = lo; kt < hi; kt += kF32BK) {
    __syncthreads();
    for (int i = threadIdx.x; i < kF32BK * D / 4; i += kThreads) {
      const int j = i * 4 / D, c = i * 4 % D;
      float4 tk = make_float4(0.f, 0.f, 0.f, 0.f), tv = tk;
      if (kt + j < Skv) {
        tk = *reinterpret_cast<const float4*>(kb + (kt + j) * kv_row + c);
        tv = *reinterpret_cast<const float4*>(vb + (kt + j) * kv_row + c);
      }
      *reinterpret_cast<float4*>(Ks + j * KP + c) = tk;
      *reinterpret_cast<float4*>(Vs + j * D + c) = tv;
    }
    __syncthreads();

    float s[kF32Rows];
#pragma unroll
    for (int i = 0; i < kF32Rows; ++i) s[i] = 0.f;
    for (int c = 0; c < D; c += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(Ks + lane * KP + c);
#pragma unroll
      for (int i = 0; i < kF32Rows; ++i) {
        const float4 qq = *reinterpret_cast<const float4*>(Qs + (warp * kF32Rows + i) * D + c);
        s[i] = fmaf(qq.x, kk.x, s[i]);
        s[i] = fmaf(qq.y, kk.y, s[i]);
        s[i] = fmaf(qq.z, kk.z, s[i]);
        s[i] = fmaf(qq.w, kk.w, s[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kF32Rows; ++i) {
      const int qpos = q_start + warp * kF32Rows + i;
      const float x = masked_score(s[i], scale, softcap, qpos, kt + lane, Skv, causal, window);
      const float m_new = fmaxf(m[i], warp_max(x));
      const float corr = expf(m[i] - m_new);
      const float p = expf(x - m_new);
      l[i] = l[i] * corr + warp_sum(p);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] *= corr;
      s[i] = p;
    }
    for (int j = 0; j < kF32BK; ++j) {
      float vj[E];
#pragma unroll
      for (int e = 0; e < E; ++e) vj[e] = Vs[j * D + lane + 32 * e];
#pragma unroll
      for (int i = 0; i < kF32Rows; ++i) {
        const float pj = __shfl_sync(0xffffffffu, s[i], j);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[i][e] = fmaf(pj, vj[e], acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kF32Rows; ++i) {
    const int qpos = q_start + warp * kF32Rows + i;
    if (qpos >= Sq) continue;
    const float L = fmaxf(l[i], 1e-30f);
    float* op = o + ((size_t)b * Sq + qpos) * q_row + (size_t)h * D;
#pragma unroll
    for (int e = 0; e < E; ++e) op[lane + 32 * e] = acc[i][e] / L;
  }
}

// --------------------------------------------------------------- bf16 path
constexpr int kMmaBQ = 64;  // query rows a block, 16 a warp
constexpr int kMmaBK = 64;  // keys a tile

template <int D>
constexpr size_t mma_smem_bytes() {
  return (size_t)3 * 64 * (D + 8) * sizeof(__nv_bfloat16);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}

// Copy `rows` rows of D bf16 from global (row stride `stride` elements,
// rows at or past `valid` zero-filled) into shared memory with pitch P.
template <int D, int P>
__device__ __forceinline__ void tile_to_smem(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                             size_t stride, int rows, int valid) {
  constexpr int VPR = D / 8;  // 16-byte vectors a row
  for (int i = threadIdx.x; i < rows * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 t = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) t = *reinterpret_cast<const uint4*>(src + r * stride + c);
    *reinterpret_cast<uint4*>(dst + r * P + c) = t;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int Sq,
                 int Skv, int Hq, int Hkv, float scale, float softcap, int causal, int window) {
  constexpr int P = D + 8;    // row pitch (elements): conflict-free fragment loads
  constexpr int ND = D / 8;   // n-tiles of the output
  constexpr int NK = kMmaBK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][P]
  __nv_bfloat16* Ks = Qs + kMmaBQ * P;                               // [64][P]
  __nv_bfloat16* Vs = Ks + kMmaBK * P;                               // [64][P]
  const uint16_t* Vraw = reinterpret_cast<const uint16_t*>(Vs);

  const int q_start = blockIdx.x * kMmaBQ;
  const int b = blockIdx.y / Hq, h = blockIdx.y % Hq, kvh = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const size_t q_row = (size_t)Hq * D, kv_row = (size_t)Hkv * D;
  const __nv_bfloat16* kb = k + ((size_t)b * Skv * Hkv + kvh) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * Skv * Hkv + kvh) * D;

  tile_to_smem<D, P>(Qs, q + (((size_t)b * Sq + q_start) * Hq + h) * D, q_row, kMmaBQ,
                     Sq - q_start);
  const int q_end = min(q_start + kMmaBQ, Sq);
  int lo, hi;
  kv_range(q_start, q_end, Skv, causal, window, kMmaBK, lo, hi);

  // This thread's rows: r0 = warp*16 + g and r1 = r0 + 8 of the tile.
  const int qpos0 = q_start + warp * 16 + g, qpos1 = qpos0 + 8;
  const __nv_bfloat16* qa0 = Qs + (warp * 16 + g) * P + t * 2;
  const __nv_bfloat16* qa1 = qa0 + 8 * P;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // l: this thread's partial sums
  float oacc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;

  for (int kt = lo; kt < hi; kt += kMmaBK) {
    __syncthreads();
    tile_to_smem<D, P>(Ks, kb + (size_t)kt * kv_row, kv_row, kMmaBK, Skv - kt);
    tile_to_smem<D, P>(Vs, vb + (size_t)kt * kv_row, kv_row, kMmaBK, Skv - kt);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys.
    float sc[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D; kk += 16) {
      const uint32_t a0 = *reinterpret_cast<const uint32_t*>(qa0 + kk);
      const uint32_t a1 = *reinterpret_cast<const uint32_t*>(qa1 + kk);
      const uint32_t a2 = *reinterpret_cast<const uint32_t*>(qa0 + kk + 8);
      const uint32_t a3 = *reinterpret_cast<const uint32_t*>(qa1 + kk + 8);
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const __nv_bfloat16* kp = Ks + (n * 8 + g) * P + kk + t * 2;
        mma_bf16(sc[n], a0, a1, a2, a3, *reinterpret_cast<const uint32_t*>(kp),
                 *reinterpret_cast<const uint32_t*>(kp + 8));
      }
    }

    // Scale, softcap, mask; online softmax on rows r0 (elements 0,1) and
    // r1 (elements 2,3). The 4 lanes of a quad share a row.
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      const int kpos = kt + n * 8 + t * 2;
      sc[n][0] = masked_score(sc[n][0], scale, softcap, qpos0, kpos, Skv, causal, window);
      sc[n][1] = masked_score(sc[n][1], scale, softcap, qpos0, kpos + 1, Skv, causal, window);
      sc[n][2] = masked_score(sc[n][2], scale, softcap, qpos1, kpos, Skv, causal, window);
      sc[n][3] = masked_score(sc[n][3], scale, softcap, qpos1, kpos + 1, Skv, causal, window);
      mx0 = fmaxf(mx0, fmaxf(sc[n][0], sc[n][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[n][2], sc[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float c0 = expf(m0 - mx0), c1 = expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      sc[n][0] = expf(sc[n][0] - m0);
      sc[n][1] = expf(sc[n][1] - m0);
      sc[n][2] = expf(sc[n][2] - m1);
      sc[n][3] = expf(sc[n][3] - m1);
      ps0 += sc[n][0] + sc[n][1];
      ps1 += sc[n][2] + sc[n][3];
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      oacc[n][0] *= c0;
      oacc[n][1] *= c0;
      oacc[n][2] *= c1;
      oacc[n][3] *= c1;
    }

    // O += P V. P's accumulator fragments are the A fragments of the next
    // product: keys ks*16 .. ks*16+15 are n-tiles 2ks and 2ks+1.
#pragma unroll
    for (int ks = 0; ks < kMmaBK / 16; ++ks) {
      const uint32_t a0 = pack_bf16(sc[2 * ks][0], sc[2 * ks][1]);
      const uint32_t a1 = pack_bf16(sc[2 * ks][2], sc[2 * ks][3]);
      const uint32_t a2 = pack_bf16(sc[2 * ks + 1][0], sc[2 * ks + 1][1]);
      const uint32_t a3 = pack_bf16(sc[2 * ks + 1][2], sc[2 * ks + 1][3]);
      const uint16_t* v0 = Vraw + (ks * 16 + t * 2) * P + g;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const uint16_t* vp = v0 + n * 8;
        const uint32_t b0 = (uint32_t)vp[0] | ((uint32_t)vp[P] << 16);
        const uint32_t b1 = (uint32_t)vp[8 * P] | ((uint32_t)vp[9 * P] << 16);
        mma_bf16(oacc[n], a0, a1, a2, a3, b0, b1);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float L0 = fmaxf(l0, 1e-30f), L1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* o0 = o + ((size_t)b * Sq + qpos0) * q_row + (size_t)h * D + t * 2;
  __nv_bfloat16* o1 = o0 + 8 * q_row;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    if (qpos0 < Sq)
      *reinterpret_cast<uint32_t*>(o0 + n * 8) = pack_bf16(oacc[n][0] / L0, oacc[n][1] / L0);
    if (qpos1 < Sq)
      *reinterpret_cast<uint32_t*>(o1 + n * 8) = pack_bf16(oacc[n][2] / L1, oacc[n][3] / L1);
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                       int Skv, int Hq, int Hkv, float scale, float softcap, int causal,
                       int window, cudaStream_t st) {
  constexpr size_t smem = f32_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_f32_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kF32BQ - 1) / kF32BQ, B * Hq);
  flash_f32_kernel<D><<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), Sq, Skv, Hq, Hkv, scale, softcap, causal, window);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                       int Skv, int Hq, int Hkv, float scale, float softcap, int causal,
                       int window, cudaStream_t st) {
  constexpr size_t smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_mma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kMmaBQ - 1) / kMmaBQ, B * Hq);
  flash_mma_kernel<D><<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Sq, Skv, Hq, Hkv,
      scale, softcap, causal, window);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16; q, k, v and o share one dtype.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a shape or type the kernel does not take.
int flash_attn_launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                      int Skv, int Hq, int Hkv, int D, float scale, float softcap, int causal,
                      int window, int dtype, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Skv <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_ARGS q, k, v, o, B, Sq, Skv, Hq, Hkv, scale, softcap, causal, window, st
  if (dtype == 0) {
    switch (D) {
      case 32: return launch_f32<32>(FLASH_ARGS);
      case 64: return launch_f32<64>(FLASH_ARGS);
      case 128: return launch_f32<128>(FLASH_ARGS);
      case 256: return launch_f32<256>(FLASH_ARGS);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 32: return launch_mma<32>(FLASH_ARGS);
      case 64: return launch_mma<64>(FLASH_ARGS);
      case 128: return launch_mma<128>(FLASH_ARGS);
      case 256: return launch_mma<256>(FLASH_ARGS);
    }
  }
#undef FLASH_ARGS
  return cudaErrorInvalidValue;
}

const char* flash_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
