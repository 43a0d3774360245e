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
// per byte. Every kernel here splits the cache (flash-decoding) and serves
// all G = Hq/Hkv query heads of a KV head from one read of each K/V row
// (GQA by index, never a repeated copy). Split `split` of nsplit takes the
// keys [split*n/nsplit, (split+1)*n/nsplit) of n = lengths[b] valid slots,
// so the splits of a row stream equal shares and slots past lengths[b] are
// never read (kernel.split_range writes the same ranges in Python). A
// length of 0 reproduces the TPU kernel's all-masked row: every score is
// -1e30, so the softmax is uniform over the S slots.
//
// Three kernels:
//  * bf16 q and cache at D = 64, 128 and 256, the serving path:
//    decode_ring_kernel, one launch a call. The grid is one wave
//    (kernel.split_plan: one block an SM). In a block, one producer warp
//    streams K and V tiles with TMA (one box a tile from 4-D tensor maps over
//    (D, H, S, B); a split's last, partial tile as cp.async.bulk copies of
//    one row at a time, several rows a lane where a tile has more than 32
//    keys) into a ring of 4 stages of 32 KB each (K rows, then V rows; so up
//    to 128 KB in flight an SM) behind full/empty mbarriers, and 8 consumer
//    warps compute while the next stages land. A stage holds 8192 / D keys
//    (RingShape: 128 at D 64, 64 at D 128, 32 at D 256), a consumer warp
//    1024 / D of them, walked in passes of 4 keys: for the scores 8 lanes a
//    key read whole 16-byte chunks of K from shared memory (D / 64 chunks a
//    lane; 3 shuffle levels instead of a 5-level butterfly per key), then
//    for PV each lane takes 8 columns of V, so a row spans D / 8 lanes and
//    the warp's 256 / D lane groups each take a key of the pass at once,
//    each group keeping its own partial accumulator until the block merge
//    sums them. It serves G = 1, 2 and 4 query rows a KV head at every
//    head dim, 8 at D 64 and 128, and 3, 6 and 7 at D 64 and 128
//    (granite-moe, nemotron, arctic). The softcap's tanh is 1 - 2/(e^{2y}+1): one ex2 and
//    one rcp, with scale*log2e folded in, and the softmax runs in base 2.
//    The block merges its warps in shared memory; the last block of a (b,
//    kv head) to finish (an atomic ticket after a __threadfence) merges the
//    splits' partials, which stay in L2, and writes the output. The ticket
//    is reset by that block, so the counters are zero between launches (one
//    set a stream: kernel._scratch). The host's work a launch is kept to the
//    launch itself: the tensor maps are encoded once a cache tensor and head
//    dim, and the shared-memory limit raised once a device. At D 256 with
//    G 8 and 16 (paligemma's and recurrentgemma's query heads on one KV
//    head) the same producer and ring feed decode_ring_mma_kernel instead,
//    whose consumer warps run S = Q K^T and O += P V on tensor cores
//    (mma.sync) and whose splits merge by thread-block cluster in
//    distributed shared memory (described at the kernel).
//  * f32 queries (with an f32 or a bf16 cache) at every head dim, and bf16
//    at D = 32 (the reduced models): decode_split_kernel, where a warp loads
//    4 keys of K and V into registers per step, and a second launch,
//    decode_combine_kernel, merges the splits. It serves G = 1, 2, 4, 8 and,
//    at D = 64 and 128, 3, 6 and 7: one instantiation a G, with the G query
//    rows' q and accumulators in registers (launch_d). Its grid aims at
//    several resident blocks an SM (kernel.plan_for), since a block keeps
//    only one step's loads in flight.
//
// Where the split merge ends, either kernel can also write each query row's
// log-sum-exp, lse = m + log(l) in scaled-score units (natural log; -1e30
// for an all-masked row), when the caller passes an lse buffer
// (decode_attn_launch_lse); the output is then f32, the value the q dtype
// would round. A sharded decode merges the per-rank outputs of its sequence
// shards with both (models/attention.merge_shards), so the merged output
// rounds once. Without the buffer nothing changes: the same launches write
// the same output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include <mutex>
#include <type_traits>

#include "hopper.cuh"   // mbarriers, TMA, ex2/rcp, the tensor-map encoder

namespace {

namespace cg = cooperative_groups;

constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.693147180559945f;
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

// The keys [start, end) of split `split`: an equal share of the row's valid
// slots (all S of them when lengths[b] <= 0, which masks every score).
__device__ __forceinline__ void split_range(int length, int S, int split, int nsplit, int& start,
                                            int& end, bool& all_masked) {
  all_masked = length <= 0;
  const int n = all_masked ? S : min(length, S);
  start = (int)((int64_t)split * n / nsplit);
  end = (int)((int64_t)(split + 1) * n / nsplit);
}

// ---------------------------------------------------------------- f32 path
// Pass 1: one block per (split, kv head, batch row). Writes, for each of
// the G query heads, the split's running max m, sum l (part_ml) and
// unnormalised accumulator (part_acc), all relative to m.
template <typename TQ, typename TKV, int D, int G>
__global__ void __launch_bounds__(kWarps * 32)
decode_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                    const TKV* __restrict__ v, const int* __restrict__ lengths,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int S, int Hkv, float scale, float softcap) {
  constexpr int E = D / 32;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int Hq = Hkv * G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  int start, end;
  bool all_masked;
  split_range(lengths[b], S, split, nsplit, start, end, all_masked);

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
                                      TO* __restrict__ out, float* __restrict__ lse,
                                      int nsplit, int D) {
  const size_t row = blockIdx.x;
  const float* ml = part_ml + row * nsplit * 2;
  float M = kNegInf;
  for (int s = 0; s < nsplit; ++s) M = fmaxf(M, ml[2 * s]);
  float L = 0.f;
  for (int s = 0; s < nsplit; ++s) L += ml[2 * s + 1] * expf(ml[2 * s] - M);
  const float inv = 1.f / fmaxf(L, 1e-30f);
  if (lse != nullptr && threadIdx.x == 0) lse[row] = M + logf(L);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float A = 0.f;
    for (int s = 0; s < nsplit; ++s)
      A += part_acc[(row * nsplit + s) * D + d] * expf(ml[2 * s] - M);
    store(out + row * D + d, A * inv);
  }
}

// --------------------------------------------------------------- bf16 path
constexpr int kStageB = 32 * 1024;                 // a stage: K rows, then V rows
constexpr int kStages = 4;
constexpr int kConsumers = 8;                      // consumer warps
constexpr int kRingThreads = (kConsumers + 1) * 32;
constexpr int kRingB = kStages * kStageB;
constexpr int kPassKeys = 4;                       // keys a warp scores at once, 8 lanes each

// The ring's shape at head dim D: a stage of a fixed byte size holds
// kTileKeys keys, whole TMA boxes of {D, 1, kTileKeys, 1}; for PV a lane
// takes 8 columns, so a row spans D / 8 lanes and a warp kLaneGroups rows
// at once (kernel.ring_plan writes the same schedule in Python).
template <int D>
struct RingShape {
  static constexpr int kRowB = D * 2;                        // bytes of one K or V row
  static constexpr int kTileKeys = kStageB / (2 * kRowB);    // 128, 64, 32 at D 64, 128, 256
  static constexpr int kLaneGroups = 256 / D;
  static_assert(D == 64 || D == 128 || D == 256, "the ring kernel's head dims");
  static_assert(kRowB % 16 == 0 && D <= 256 && kTileKeys <= 256,
                "a TMA box's inner extent is a multiple of 16 bytes, each dimension <= 256");
  static_assert(kTileKeys % (kConsumers * kPassKeys) == 0, "a stage's keys split evenly");
};

template <int D, int G>
constexpr size_t ring_smem_bytes() {
  // the ring, q as f32, 2 * kStages mbarriers, the last-block flag
  return (size_t)kRingB + (size_t)G * D * 4 + 16 * kStages + 16;
}

// bytes from global to shared memory, completing on the mbarrier `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void unpack8(const uint4 t, float (&f)[8]) {
  f[0] = bf16_lo(t.x); f[1] = bf16_hi(t.x); f[2] = bf16_lo(t.y); f[3] = bf16_hi(t.y);
  f[4] = bf16_lo(t.z); f[5] = bf16_hi(t.z); f[6] = bf16_lo(t.w); f[7] = bf16_hi(t.w);
}

// One merged element (query row qrow + g, column d) of a block's work:
// with one part the output (and, with an lse buffer, each row's lse at
// d 0), else part `part` of `nparts` partials (A, and M and L at d 0).
template <int D>
__device__ __forceinline__ void put_part(int g, int d, float M, float L, float A,
                                         bool all_masked, size_t qrow, int part, int nparts,
                                         __nv_bfloat16* __restrict__ out,
                                         float* __restrict__ lse, float* __restrict__ part_acc,
                                         float* __restrict__ part_ml) {
  if (nparts == 1) {
    const float o = A / fmaxf(L, 1e-30f);
    if (lse == nullptr) {
      out[(qrow + g) * D + d] = __float2bfloat16_rn(o);
    } else {
      reinterpret_cast<float*>(out)[(qrow + g) * D + d] = o;
      // M is in base 2 (log2e times the score); an all-masked row's is the
      // fill itself, which stays -1e30 as the f32 path's does
      if (d == 0) lse[qrow + g] = all_masked ? kNegInf : (M + log2f(L)) * kLn2;
    }
    return;
  }
  const size_t row = (qrow + g) * nparts + part;
  part_acc[row * D + d] = A;
  if (d == 0) {
    part_ml[row * 2] = M;
    part_ml[row * 2 + 1] = L;
  }
}

// After each of the (b, kv head)'s `nparts` blocks wrote its partial, the
// last of them to finish (an atomic ticket after a __threadfence) merges
// the partials and writes the output. The ticket is reset by that block, so
// the counters are zero between launches.
template <int D, int G>
__device__ __forceinline__ void merge_parts(unsigned char* smem, int* last_flag, bool all_masked,
                                            size_t qrow, int nparts,
                                            __nv_bfloat16* __restrict__ out,
                                            float* __restrict__ lse,
                                            float* __restrict__ part_acc,
                                            float* __restrict__ part_ml, int* ticket) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *last_flag = atomicAdd(ticket, 1) == nparts - 1;
  __syncthreads();
  if (!*last_flag) return;
  __threadfence();
  if (threadIdx.x == 0) *ticket = 0;   // ready for the next launch
  // Each query row's parts are weighted once, a warp a row: 2^(m_s - M) / L
  // into shared memory. Then each thread sums 4 columns' partial
  // accumulators over the parts with those weights, so the merge reads each
  // partial once (at G 16 and 32 parts, 512 KB; 16 loads in flight a thread
  // instead of 4 were slower on an H100, PERF.md).
  float* s_w = reinterpret_cast<float*>(smem);   // [G][nparts]
  for (int g = warp; g < G; g += blockDim.x / 32) {
    const float* ml = part_ml + (qrow + g) * nparts * 2;
    float M = kNegInf;
    for (int s = lane; s < nparts; s += 32) M = fmaxf(M, __ldcg(ml + 2 * s));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    float L = 0.f;
    for (int s = lane; s < nparts; s += 32) {
      const float c = ex2(__ldcg(ml + 2 * s) - M);
      s_w[g * nparts + s] = c;
      L += __ldcg(ml + 2 * s + 1) * c;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) L += __shfl_xor_sync(0xffffffffu, L, o);
    const float inv = 1.f / fmaxf(L, 1e-30f);
    if (lse != nullptr && lane == 0) lse[qrow + g] = all_masked ? kNegInf : (M + log2f(L)) * kLn2;
    for (int s = lane; s < nparts; s += 32) s_w[g * nparts + s] *= inv;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D / 4; idx += blockDim.x) {
    const int g = idx / (D / 4), c4 = idx % (D / 4);
    const float4* acc4 = reinterpret_cast<const float4*>(part_acc + (qrow + g) * nparts * D) + c4;
    const float* w = s_w + g * nparts;
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = 0; s < nparts; ++s) {
      const float4 a = __ldcg(acc4 + s * (D / 4));
      A.x = fmaf(a.x, w[s], A.x);
      A.y = fmaf(a.y, w[s], A.y);
      A.z = fmaf(a.z, w[s], A.z);
      A.w = fmaf(a.w, w[s], A.w);
    }
    if (lse != nullptr) {
      reinterpret_cast<float4*>(reinterpret_cast<float*>(out) + (qrow + g) * D)[c4] = A;
      continue;
    }
    __nv_bfloat16* o = out + (qrow + g) * D + 4 * c4;
    o[0] = __float2bfloat16_rn(A.x);
    o[1] = __float2bfloat16_rn(A.y);
    o[2] = __float2bfloat16_rn(A.z);
    o[3] = __float2bfloat16_rn(A.w);
  }
}

// The block's end, after its slots (the consumer warps of
// decode_ring_kernel) wrote their m, l and unnormalised accumulators of
// every query row to shared memory as [kSlots][G][D], [kSlots][G] and
// [kSlots][G]: the slots merged into the output (one split) or this
// split's partial, and the splits' merge.
template <int D, int G, int kSlots>
__device__ __forceinline__ void ring_epilogue(unsigned char* smem, int* last_flag, bool all_masked,
                                              size_t qrow, int split, int nsplit,
                                              __nv_bfloat16* __restrict__ out,
                                              float* __restrict__ lse,
                                              float* __restrict__ part_acc,
                                              float* __restrict__ part_ml, int* ticket) {
  const float* s_acc = reinterpret_cast<const float*>(smem);
  const float* s_m = s_acc + kSlots * G * D;
  const float* s_l = s_m + kSlots * G;
  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int g = idx / D, d = idx % D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kSlots; ++w) M = fmaxf(M, s_m[w * G + g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kSlots; ++w) {
      const float c = ex2(s_m[w * G + g] - M);
      L += s_l[w * G + g] * c;
      A += s_acc[(w * G + g) * D + d] * c;
    }
    put_part<D>(g, d, M, L, A, all_masked, qrow, split, nsplit, out, lse, part_acc, part_ml);
  }
  if (nsplit > 1)
    merge_parts<D, G>(smem, last_flag, all_masked, qrow, nsplit, out, lse, part_acc, part_ml,
                      ticket);
}

// One block per (split, kv head, batch row); warp kConsumers is the
// producer. Scores are kept in base 2: with the softcap,
// x = cap2 - 2 cap2 / (2^(dot*mul) + 1) with mul = 2 log2e scale / cap and
// cap2 = cap log2e (that is log2e * cap * tanh(dot * scale / cap));
// without it, x = dot * mul with mul = scale log2e.
template <int D, int G, bool CAP>
__global__ void __launch_bounds__(kRingThreads, 1)
decode_ring_kernel(const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
                   const int* __restrict__ lengths,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                   float* __restrict__ part_acc, float* __restrict__ part_ml,
                   int* __restrict__ tickets, int S, int Hkv,
                   float mul, float cap2) {
  constexpr int kRowB = RingShape<D>::kRowB, kTileKeys = RingShape<D>::kTileKeys;
  constexpr int NG = RingShape<D>::kLaneGroups;
  extern __shared__ __align__(128) unsigned char ring_smem[];
  float* sq = reinterpret_cast<float*>(ring_smem + kRingB);                 // [G][D]
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring_smem + kRingB + G * D * 4);
  int* last_flag = reinterpret_cast<int*>(bars + 2 * kStages);
  const uint32_t ring = smem_u32(ring_smem), full0 = smem_u32(bars), empty0 = full0 + 8 * kStages;

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z, nsplit = gridDim.x;
  const int Hq = Hkv * G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int start, end;
  bool all_masked;
  split_range(lengths[b], S, split, nsplit, start, end, all_masked);
  const int ntiles = (end - start + kTileKeys - 1) / kTileKeys;
  const size_t qrow = (size_t)b * Hq + (size_t)kvh * G;   // first of the G query rows

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers);   // one arrival from each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the producer's first loads go out while the consumers bring q into
  // shared memory and meet at named barrier 1 (0.5-2 us a call on an H100,
  // PERF.md)
  if (warp < kConsumers) {
    for (int e = threadIdx.x; e < G * D; e += kConsumers * 32)
      sq[e] = __bfloat162float(q[qrow * D + e]);
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers * 32) : "memory");
  }

  // Every consumer warp holds all G query rows: the 288-thread block is
  // allocated registers as 12 warps, which caps a thread at 168, and G 8
  // takes 164-167 of them (phase 1's -Xptxas -v); G 8 and 16 at D 256 take
  // decode_ring_mma_kernel instead.
  constexpr int R = G;
  // keys of a stage a consumer warp walks, in passes of kPassKeys; with at
  // most 4 rows a warp the passes are unrolled (granite-moe's G 3 at D 64:
  // 0.0262 -> 0.0208 ms on an H100), with more they are not (G 6-8 at D 128
  // lost 9-39% unrolled, PERF.md)
  constexpr int kWarpKeys = kTileKeys / kConsumers;
  constexpr int kPassUnroll = R <= 4 ? kWarpKeys / kPassKeys : 1;
  static_assert(G <= 8 && kWarpKeys % kPassKeys == 0, "keys must split evenly over the warps");
  float m[R], l[R], acc[R][8];
#pragma unroll
  for (int g = 0; g < R; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }

  if (warp == kConsumers) {
    // producer: a whole tile of K and of V is one TMA box each; the last,
    // partial tile of a split takes its rows one at a time, so no key past
    // the split is read
    const size_t row_stride = (size_t)Hkv * D;
    const __nv_bfloat16* kb = k + ((size_t)b * S * Hkv + kvh) * D;
    const __nv_bfloat16* vb = v + ((size_t)b * S * Hkv + kvh) * D;
    for (int i = 0; i < ntiles; ++i) {
      const int st = i % kStages, t0 = start + i * kTileKeys;
      const int n = min(kTileKeys, end - t0);
      mbar_wait(empty0 + 8 * st, ((i / kStages) & 1) ^ 1);
      if (n == kTileKeys) {
        if (lane == 0) {
          mbar_expect_tx(full0 + 8 * st, kStageB);
          tma_load(ring + st * kStageB, &tm_k, full0 + 8 * st, 0, kvh, t0, b);
          tma_load(ring + st * kStageB + kTileKeys * kRowB, &tm_v, full0 + 8 * st, 0, kvh, t0,
                   b);
        }
        continue;
      }
      if (lane == 0) mbar_expect_tx(full0 + 8 * st, 2 * n * kRowB);
      __syncwarp();
      for (int r = lane; r < n; r += 32) {
        const uint32_t dst = ring + st * kStageB + r * kRowB;
        bulk_load(dst, kb + (size_t)(t0 + r) * row_stride, kRowB, full0 + 8 * st);
        bulk_load(dst + kTileKeys * kRowB, vb + (size_t)(t0 + r) * row_stride, kRowB,
                  full0 + 8 * st);
      }
    }
  } else {
    // this warp's keys (key0 .. + kWarpKeys of a stage); for PV, this
    // lane's columns (8 col .. + 8) and lane group
    const int key0 = kWarpKeys * warp, sub = lane & 7;
    const int col = lane % (D / 8), group = lane / (D / 8);
    const float4* q4 = reinterpret_cast<const float4*>(sq);
    for (int i = 0; i < ntiles; ++i) {
      const int st = i % kStages;
      const int n = min(kTileKeys, end - (start + i * kTileKeys));
      mbar_wait(full0 + 8 * st, (i / kStages) & 1);
      const unsigned char* tile = ring_smem + st * kStageB;
#pragma unroll kPassUnroll
      for (int u = 0; u < kWarpKeys / kPassKeys; ++u) {
        const int base = key0 + kPassKeys * u;   // the pass's 4 keys
        if (base >= n) break;
        const int mine = base + (lane >> 3);    // this lane's key of the tile
        // scores: 8 lanes a key, each over D / 64 chunks of 8 columns
        const uint4* kr = reinterpret_cast<const uint4*>(tile + mine * kRowB);
        float s[R];
#pragma unroll
        for (int g = 0; g < R; ++g) s[g] = 0.f;
#pragma unroll
        for (int j = 0; j < D / 64; ++j) {
          const int c = sub + 8 * j;
          float kf[8];
          unpack8(kr[c], kf);
#pragma unroll
          for (int g = 0; g < R; ++g) {
            const float4 qa = q4[(g * D + 8 * c) / 4], qb = q4[(g * D + 8 * c) / 4 + 1];
            float d = s[g];
            d = fmaf(qa.x, kf[0], d); d = fmaf(qa.y, kf[1], d);
            d = fmaf(qa.z, kf[2], d); d = fmaf(qa.w, kf[3], d);
            d = fmaf(qb.x, kf[4], d); d = fmaf(qb.y, kf[5], d);
            d = fmaf(qb.z, kf[6], d); d = fmaf(qb.w, kf[7], d);
            s[g] = d;
          }
        }
        const bool valid = mine < n;
        float p[R];
#pragma unroll
        for (int g = 0; g < R; ++g) {
          float x = s[g];
          x += __shfl_xor_sync(0xffffffffu, x, 4);
          x += __shfl_xor_sync(0xffffffffu, x, 2);
          x += __shfl_xor_sync(0xffffffffu, x, 1);
          x = CAP ? fmaf(-2.f * cap2, rcp(ex2(x * mul) + 1.f), cap2) : x * mul;
          if (all_masked) x = kNegInf;
          x = valid ? x : kNegInf;
          float mx = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 8));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
          const float mnew = fmaxf(m[g], mx);
          const float corr = ex2(m[g] - mnew);
          p[g] = valid ? ex2(x - mnew) : 0.f;
          float ps = p[g] + __shfl_xor_sync(0xffffffffu, p[g], 8);
          ps += __shfl_xor_sync(0xffffffffu, ps, 16);
          l[g] = l[g] * corr + ps;
          m[g] = mnew;
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] *= corr;
        }
        // PV: lane group `group` takes the pass's keys group, group + NG, ..
        // (all 4 at D 256), this lane their columns 8 col .. + 8; a key
        // past the tile adds p = 0 times zeros
#pragma unroll
        for (int t = 0; t < kPassKeys / NG; ++t) {
          const int key = group + NG * t;
          const uint4 raw = base + key < n
              ? reinterpret_cast<const uint4*>(tile + (kTileKeys + base + key) * kRowB)[col]
              : make_uint4(0u, 0u, 0u, 0u);
          float vf[8];
          unpack8(raw, vf);
#pragma unroll
          for (int g = 0; g < R; ++g) {
            const float pu = __shfl_sync(0xffffffffu, p[g], 8 * key);
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(pu, vf[e], acc[g][e]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * st);
    }
    // the lane groups' partials (D < 256) into the first D / 8 lanes: m and
    // l are the warp's, so they add as they are
#pragma unroll
    for (int o = D / 8; o < 32; o <<= 1) {
#pragma unroll
      for (int g = 0; g < R; ++g) {
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
      }
    }
  }

  // Every copy has landed (the consumers waited on each), so the ring is
  // free: merge the consumer warps there.
  __syncthreads();
  float* s_acc = reinterpret_cast<float*>(ring_smem);   // [kConsumers][R][D]
  float* s_m = s_acc + kConsumers * R * D;          // [kConsumers][R]
  float* s_l = s_m + kConsumers * R;
  if (warp < kConsumers) {
#pragma unroll
    for (int g = 0; g < R; ++g) {
      if (lane < D / 8) {
        float4* dst = reinterpret_cast<float4*>(s_acc + (warp * R + g) * D + 8 * lane);
        dst[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
        dst[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
      }
      if (lane == 0) {
        s_m[warp * R + g] = m[g];
        s_l[warp * R + g] = l[g];
      }
    }
  }
  __syncthreads();
  ring_epilogue<D, G, kConsumers>(ring_smem, last_flag, all_masked, qrow, split, nsplit, out, lse,
                                  part_acc, part_ml, tickets + (size_t)b * Hkv + kvh);
}

// ------------------------------------------- bf16 at D 256 with G 8 and 16
// The G query rows of one KV head are the M = 16 tile of mma.sync.m16n8k16
// (G 8 pads it with zero rows, whose scores are never written): S = Q K^T
// and O += P V run on tensor cores, where decode_ring_kernel's consumer
// warps spend 16 x 64 x 256 FMAs a stage's key split on CUDA cores
// (PERF.md). The producer warp, the 4-stage ring and its mbarriers
// are decode_ring_kernel's; a stage holds 32 keys of K, then of V, each row
// as four 64-column TMA boxes swizzled by 128 bytes, so that ldmatrix's 8
// rows of one 16-byte column chunk fall in 8 different bank groups (rows
// of 512 bytes, unswizzled, would all fall in one). A split is whole tiles
// (split_range_tiles), so only a row's last tile is partial: its box reads
// up to 31 slots past the valid ones (zero past S), whose scores are masked
// and whose V rows the consumer zeroes before P V.
//
// Consumer warp w takes the keys 8 (w % 4) .. + 8 of each stage (its key
// group) and the output columns 128 (w / 4) .. + 128 (its column half):
// the two warps of a key group compute the same scores, 16 m16n8k16 steps
// over D with Q's A fragments in registers for the whole call, K's B
// fragments by ldmatrix; the online softmax runs in f32 and base 2 on the
// accumulator fragment (a lane holds rows lane / 4 and lane / 4 + 8, two
// keys each); P, as two bf16 terms in registers, is the A fragment of 2 x 16
// m16n8k8 steps against V's B fragments by ldmatrix.trans. The key groups
// merge in shared memory, then the (b, kv head)'s splits, one thread-block
// cluster, in distributed shared memory (no partials through global memory,
// no last-block merge), and write the output.
constexpr int kMmaKeyGroups = 4;             // a stage's keys over the consumer warps
constexpr int kMmaGroupKeys = 8;             // keys of a stage a key group takes
constexpr int kMmaBoxCols = 64;              // columns of one swizzled TMA box (128 bytes)
constexpr int kMmaMaxSplits = 16;            // a cluster's blocks, past the portable 8

template <int D, int G>
constexpr bool kMmaRing = D == 256 && (G == 8 || G == 16);

template <int D>
constexpr size_t ring_mma_smem_bytes() {
  // the ring (holding the key groups' merge at the end), 2 * kStages
  // mbarriers
  return (size_t)kRingB + 16 * kStages;
}

// The keys [start, end) of split `split`: an equal share of the row's
// tiles of `tile` keys (the last one partial), so every tile but a row's
// last is whole.
__device__ __forceinline__ void split_range_tiles(int length, int S, int split, int nsplit,
                                                  int tile, int& start, int& end,
                                                  bool& all_masked) {
  all_masked = length <= 0;
  const int n = all_masked ? S : min(length, S);
  const int tiles = (n + tile - 1) / tile;
  start = min(n, (int)((int64_t)split * tiles / nsplit) * tile);
  end = min(n, (int)((int64_t)(split + 1) * tiles / nsplit) * tile);
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_1688(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Byte offset of (row, 16-byte chunk `chunk` of column block `cb`) in a
// tile of `tile` rows stored as D / 64 swizzled boxes of 128-byte rows.
__device__ __forceinline__ uint32_t swizzled(int tile, int cb, int row, int chunk) {
  return (uint32_t)(cb * tile * 128 + row * 128 + ((chunk ^ (row & 7)) << 4));
}

template <int D, int G, bool CAP>
__global__ void __launch_bounds__(kRingThreads, 1)
decode_ring_mma_kernel(const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __nv_bfloat16* __restrict__ q, const int* __restrict__ lengths,
                       __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int S,
                       int Hkv, float mul, float cap2) {
  constexpr int kRowB = RingShape<D>::kRowB, T = RingShape<D>::kTileKeys;
  constexpr int kCols = D / (kConsumers / kMmaKeyGroups);    // a column half: 128
  static_assert(kMmaRing<D, G>, "the tensor-core consumer's shapes");
  static_assert(T == kMmaKeyGroups * kMmaGroupKeys, "a stage's keys split over the key groups");
  static_assert(D % kMmaBoxCols == 0 && kCols % 32 == 0, "whole boxes, whole ldmatrix.x4");
  extern __shared__ __align__(1024) unsigned char mma_smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(mma_smem + kRingB);
  const uint32_t ring = smem_u32(mma_smem), full0 = smem_u32(bars), empty0 = full0 + 8 * kStages;

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z, nsplit = gridDim.x;
  const int Hq = Hkv * G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int start, end;
  bool all_masked;
  split_range_tiles(lengths[b], S, split, nsplit, T, start, end, all_masked);
  const int ntiles = end > start ? (end - start + T - 1) / T : 0;
  const size_t qrow = (size_t)b * Hq + (size_t)kvh * G;   // first of the G query rows

  if (threadIdx.x == 0) {
    if (ring & 1023) __trap();   // the 128-byte swizzle repeats every 1024 bytes
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // this lane's rows of the accumulator fragments (gr, gr + 8) and keys
  // (2 tq, 2 tq + 1 of its key group)
  const int gr = lane >> 2, tq = lane & 3;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[kCols / 8][4];
#pragma unroll
  for (int j = 0; j < kCols / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  const int kg = warp % kMmaKeyGroups, ch = warp / kMmaKeyGroups;

  if (warp == kConsumers) {
    // producer: every tile, partial or whole, is D / 64 boxes of K and of
    // V; the box of a row's partial last tile reads past its valid slots
    for (int i = 0; i < ntiles; ++i) {
      const int st = i % kStages, t0 = start + i * T;
      mbar_wait(empty0 + 8 * st, ((i / kStages) & 1) ^ 1);
      if (lane == 0) {
        const uint32_t dst = ring + st * kStageB, bar = full0 + 8 * st;
        mbar_expect_tx(bar, kStageB);
#pragma unroll
        for (int cb = 0; cb < D / kMmaBoxCols; ++cb) {
          tma_load(dst + cb * T * 128, &tm_k, bar, cb * kMmaBoxCols, kvh, t0, b);
          tma_load(dst + T * kRowB + cb * T * 128, &tm_v, bar, cb * kMmaBoxCols, kvh, t0, b);
        }
      }
      __syncwarp();
    }
  } else {
    // Q's A fragments: k-step kk covers columns 16 kk .. + 16; rows past G
    // are zero
    uint32_t qa[D / 16][4];
    const __nv_bfloat16* q0 = q + qrow * D;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = 16 * kk + 2 * tq;
      qa[kk][0] = *reinterpret_cast<const uint32_t*>(q0 + gr * D + c);
      qa[kk][2] = *reinterpret_cast<const uint32_t*>(q0 + gr * D + c + 8);
      qa[kk][1] = gr + 8 < G ? *reinterpret_cast<const uint32_t*>(q0 + (gr + 8) * D + c) : 0u;
      qa[kk][3] = gr + 8 < G ? *reinterpret_cast<const uint32_t*>(q0 + (gr + 8) * D + c + 8) : 0u;
    }
    const int key0 = kMmaGroupKeys * kg;               // this key group's keys of a tile
    const int lrow = key0 + (lane & 7), lmat = lane >> 3;   // ldmatrix: this lane's row, matrix
    for (int i = 0; i < ntiles; ++i) {
      const int st = i % kStages;
      const int n = min(T, end - (start + i * T));
      mbar_wait(full0 + 8 * st, (i / kStages) & 1);
      const uint32_t kt = ring + st * kStageB, vt = kt + T * kRowB;
      if (key0 < n) {
        // S = Q K^T over this key group's 8 keys: each ldmatrix.x4 gives
        // the B fragments of two k-steps, summed in two chains
        float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < D / 32; ++kk) {
          const int c = 32 * kk + 8 * lmat;
          uint32_t b0, b1, b2, b3;
          ldsm_x4(kt + swizzled(T, c / kMmaBoxCols, lrow, (c % kMmaBoxCols) / 8), b0, b1, b2, b3);
          mma_16816(s0, qa[2 * kk], b0, b1);
          mma_16816(s1, qa[2 * kk + 1], b2, b3);
        }
        // the online softmax: x[j] is row gr (j < 2) or gr + 8, key 2 tq + (j & 1)
        float x[4], p[4];
        const int kbase = key0 + 2 * tq;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float v = s0[j] + s1[j];
          v = CAP ? fmaf(-2.f * cap2, rcp(ex2(v * mul) + 1.f), cap2) : v * mul;
          if (all_masked) v = kNegInf;
          x[j] = kbase + (j & 1) < n ? v : kNegInf;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mx = fmaxf(x[2 * h], x[2 * h + 1]);
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float mnew = fmaxf(m[h], mx);
          const float corr = ex2(m[h] - mnew);
          p[2 * h] = kbase < n ? ex2(x[2 * h] - mnew) : 0.f;
          p[2 * h + 1] = kbase + 1 < n ? ex2(x[2 * h + 1] - mnew) : 0.f;
          l[h] = l[h] * corr + p[2 * h] + p[2 * h + 1];   // this lane's keys; the quad sums at the end
          m[h] = mnew;
#pragma unroll
          for (int j = 0; j < kCols / 8; ++j) {
            o[j][2 * h] *= corr;
            o[j][2 * h + 1] *= corr;
          }
        }
        // a row's partial last tile: this warp's V rows past n (slots past
        // the valid ones, or zeros past S) zeroed in its own columns, so
        // that P = 0 meets no NaN there
        if (key0 + kMmaGroupKeys > n) {
          for (int e = lane; e < kMmaGroupKeys * (kCols / 8); e += 32) {
            const int row = key0 + e / (kCols / 8), c = ch * kCols + 8 * (e % (kCols / 8));
            if (row >= n) {
              uint4* dst = reinterpret_cast<uint4*>(
                  mma_smem + st * kStageB + T * kRowB +
                  swizzled(T, c / kMmaBoxCols, row, (c % kMmaBoxCols) / 8));
              *dst = make_uint4(0u, 0u, 0u, 0u);
            }
          }
          // these generic writes come before the stage's next TMA write
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          __syncwarp();
        }
        // O += P V: P's accumulator fragment is m16n8k8's A fragment, as
        // two bf16 terms (its rounding and the remainder, 2^-18 P apart from
        // P), since P rounded once moves the output by up to 2^-9 (|P| @
        // |V|), past TOL["bfloat16"]'s 2^-7 |out| where |out| is much
        // smaller than |P| @ |V| (PERF.md)
        const uint32_t a0 = pack_bf16(p[0], p[1]), a1 = pack_bf16(p[2], p[3]);
        const uint32_t e0 = pack_bf16(p[0] - bf16_lo(a0), p[1] - bf16_hi(a0));
        const uint32_t e1 = pack_bf16(p[2] - bf16_lo(a1), p[3] - bf16_hi(a1));
#pragma unroll
        for (int jj = 0; jj < kCols / 32; ++jj) {
          const int c = ch * kCols + 32 * jj + 8 * lmat;
          uint32_t v[4];
          ldsm_x4_t(vt + swizzled(T, c / kMmaBoxCols, lrow, (c % kMmaBoxCols) / 8), v[0], v[1],
                    v[2], v[3]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            mma_1688(o[4 * jj + j], a0, a1, v[j]);
            mma_1688(o[4 * jj + j], e0, e1, v[j]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * st);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
  }

  // Every copy has landed, so the ring is free: the key groups' slots
  // [kMmaKeyGroups][G][D] there, each warp writing its column half.
  __syncthreads();
  float* s_acc = reinterpret_cast<float*>(mma_smem);
  float* s_m = s_acc + kMmaKeyGroups * G * D;
  float* s_l = s_m + kMmaKeyGroups * G;
  if (warp < kConsumers) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = gr + 8 * h;
      if (row >= G) continue;
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j)
        *reinterpret_cast<float2*>(s_acc + (kg * G + row) * D + ch * kCols + 8 * j + 2 * tq) =
            make_float2(o[j][2 * h], o[j][2 * h + 1]);
      if (ch == 0 && tq == 0) {
        s_m[kg * G + row] = m[h];
        s_l[kg * G + row] = l[h];
      }
    }
  }
  __syncthreads();
  // The key groups merged into this split's (M, L, A) in shared memory, for
  // the cluster: [G][D], then M and L [G] each.
  float* c_acc = s_l + kMmaKeyGroups * G;
  float* c_m = c_acc + G * D;
  float* c_l = c_m + G;
  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int g = idx / D, d = idx % D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kMmaKeyGroups; ++w) M = fmaxf(M, s_m[w * G + g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kMmaKeyGroups; ++w) {
      const float c = ex2(s_m[w * G + g] - M);
      L += s_l[w * G + g] * c;
      A += s_acc[(w * G + g) * D + d] * c;
    }
    c_acc[idx] = A;
    if (d == 0) {
      c_m[g] = M;
      c_l[g] = L;
    }
  }
  // The (b, kv head)'s splits, one cluster, merge in distributed shared
  // memory, block `rank` taking every nsplit-th element, into the output.
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  cluster.sync();
  for (int idx = rank * blockDim.x + threadIdx.x; idx < G * D; idx += nsplit * blockDim.x) {
    const int g = idx / D, d = idx % D;
    float M = kNegInf;
    for (int r = 0; r < nsplit; ++r) M = fmaxf(M, *cluster.map_shared_rank(c_m + g, r));
    float L = 0.f, A = 0.f;
    for (int r = 0; r < nsplit; ++r) {
      const float c = ex2(*cluster.map_shared_rank(c_m + g, r) - M);
      L += *cluster.map_shared_rank(c_l + g, r) * c;
      A += *cluster.map_shared_rank(c_acc + idx, r) * c;
    }
    put_part<D>(g, d, M, L, A, all_masked, qrow, 0, 1, out, lse, nullptr, nullptr);
  }
  cluster.sync();   // no block leaves while another reads its shared memory
}

// A 4-D map over a (B, S, Hkv, D) bf16 cache, innermost first, with a box
// of a stage's 8192 / D rows (RingShape): for decode_ring_kernel
// (swizzled = false) of one head's D columns, unswizzled (row r of the box
// at r * 2 D bytes); for decode_ring_mma_kernel of 64 columns, swizzled by
// 128 bytes (row r at r * 128 bytes, its 16-byte chunk c at c ^ (r % 8)).
cudaError_t cache_map(CUtensorMap* map, EncodeTiledFn encode, const void* ptr, int B, int S,
                      int Hkv, int D, bool swizzled) {
  const cuuint64_t row = 2 * (cuuint64_t)D;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Hkv, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {row, Hkv * row, S * Hkv * row};
  const cuuint32_t box[4] = {(cuuint32_t)(swizzled ? kMmaBoxCols : D), 1,
                             (cuuint32_t)(kStageB / (2 * row)), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            swizzled ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The maps of the caches launched on so far, encoded once each: the serving
// path passes the same cache tensors at every step, and a map depends only
// on (pointer, B, S, Hkv, D, swizzled), the head dim and the layout setting
// its box too. 256 entries, direct-mapped by the pointer and the layout; a
// collision, or a pointer reused at another shape, head dim or layout,
// encodes again. ctypes drops the GIL, hence the lock.
struct MapEntry {
  CUtensorMap map;
  const void* ptr;
  int B, S, Hkv, D;
  bool swizzled;
};

cudaError_t cached_cache_map(CUtensorMap* map, const void* ptr, int B, int S, int Hkv, int D,
                             bool swizzled) {
  static std::mutex mu;
  static MapEntry table[256];
  const uint64_t h = ((reinterpret_cast<uintptr_t>(ptr) + swizzled) * 0x9E3779B97F4A7C15ull) >> 56;
  std::lock_guard<std::mutex> lock(mu);
  MapEntry& e = table[h];
  if (e.ptr != ptr || e.B != B || e.S != S || e.Hkv != Hkv || e.D != D ||
      e.swizzled != swizzled) {
    EncodeTiledFn encode;
    cudaError_t err = encode_tiled(&encode);
    if (err == cudaSuccess) err = cache_map(&e.map, encode, ptr, B, S, Hkv, D, swizzled);
    if (err != cudaSuccess) {
      e.ptr = nullptr;
      return err;
    }
    e.ptr = ptr;
    e.B = B;
    e.S = S;
    e.Hkv = Hkv;
    e.D = D;
    e.swizzled = swizzled;
  }
  *map = e.map;
  return cudaSuccess;
}

// cudaFuncAttributeNonPortableClusterSizeAllowed for `kernel`, once a
// device (as allow_smem): clusters of more than the portable 8 blocks.
template <typename Kernel>
cudaError_t allow_wide_clusters(Kernel kernel, std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

template <int D, int G, bool CAP>
cudaError_t launch_ring_cap(const void* q, const void* k, const void* v, const int* lengths,
                            void* out, float* lse, float* pa, float* pm, int* tickets, int B, int S,
                            int Hkv, int nsplit, float mul, float cap2, cudaStream_t st) {
  constexpr bool kMma = kMmaRing<D, G>;
  constexpr size_t smem = kMma ? ring_mma_smem_bytes<D>() : ring_smem_bytes<D, G>();
  static_assert(smem <= 232448, "the ring, q and the barriers fit a block's 227 KB");
  static std::atomic<uint64_t> smem_set{0};
  CUtensorMap tk, tv;
  cudaError_t err;
  if ((err = cached_cache_map(&tk, k, B, S, Hkv, D, kMma)) != cudaSuccess) return err;
  if ((err = cached_cache_map(&tv, v, B, S, Hkv, D, kMma)) != cudaSuccess) return err;
  if constexpr (kMma) {
    if ((err = allow_smem(decode_ring_mma_kernel<D, G, CAP>, (int)smem, smem_set)) != cudaSuccess)
      return err;
    // one cluster of all the (b, kv head)'s splits (kernel.mma_split_plan)
    if (nsplit > kMmaMaxSplits) return cudaErrorInvalidValue;
    static std::atomic<uint64_t> wide_set{0};
    if (nsplit > 8 && (err = allow_wide_clusters(decode_ring_mma_kernel<D, G, CAP>, wide_set)) !=
                          cudaSuccess)
      return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(nsplit, Hkv, B);
    cfg.blockDim = dim3(kRingThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = nsplit;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, decode_ring_mma_kernel<D, G, CAP>, tk, tv,
                             static_cast<const __nv_bfloat16*>(q), lengths,
                             static_cast<__nv_bfloat16*>(out), lse, S, Hkv, mul, cap2);
    return err != cudaSuccess ? err : cudaGetLastError();
  } else {
    if ((err = allow_smem(decode_ring_kernel<D, G, CAP>, (int)smem, smem_set)) != cudaSuccess)
      return err;
    decode_ring_kernel<D, G, CAP><<<dim3(nsplit, Hkv, B), kRingThreads, smem, st>>>(
        tk, tv, static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), lengths, static_cast<__nv_bfloat16*>(out), lse, pa,
        pm, tickets, S, Hkv, mul, cap2);
    return cudaGetLastError();
  }
}

template <int D, int G>
cudaError_t launch_ring(const void* q, const void* k, const void* v, const int* lengths,
                        void* out, float* lse, float* pa, float* pm, int* tickets, int B, int S, int Hkv,
                        int nsplit, float scale, float softcap, cudaStream_t st) {
  if (softcap != 0.f)
    return launch_ring_cap<D, G, true>(q, k, v, lengths, out, lse, pa, pm, tickets, B, S, Hkv,
                                       nsplit, 2.f * kLog2e * scale / softcap, softcap * kLog2e, st);
  return launch_ring_cap<D, G, false>(q, k, v, lengths, out, lse, pa, pm, tickets, B, S, Hkv,
                                      nsplit, scale * kLog2e, 0.f, st);
}

template <typename TQ, typename TKV, int D, int G>
cudaError_t launch_typed(const void* q, const void* k, const void* v, const int* lengths,
                         void* out, float* lse, float* part_acc, float* part_ml, int B, int S, int Hkv,
                         int nsplit, float scale, float softcap, cudaStream_t st) {
  const dim3 grid(nsplit, Hkv, B);
  const size_t smem = (size_t)kWarps * G * (D + 2) * sizeof(float);
  decode_split_kernel<TQ, TKV, D, G><<<grid, kWarps * 32, smem, st>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      lengths, part_acc, part_ml, S, Hkv, scale, softcap);
  if (lse != nullptr)
    decode_combine_kernel<float><<<B * Hkv * G, D < 32 ? 32 : D, 0, st>>>(
        part_acc, part_ml, static_cast<float*>(out), lse, nsplit, D);
  else
    decode_combine_kernel<TQ><<<B * Hkv * G, D < 32 ? 32 : D, 0, st>>>(
        part_acc, part_ml, static_cast<TQ*>(out), nullptr, nsplit, D);
  return cudaGetLastError();
}

// Groups of both kernels: 1, 2, 4 and 8 at every head dim; 3, 6 and 7
// (granite-moe, nemotron, arctic: Hq/Hkv = 24/8, 48/8, 56/8) at D = 64 and
// 128 only, the head dims of those archs, so the build instantiates no case
// that no configuration runs (kernel.check_supported holds the same table).
template <int D>
constexpr bool kOddGroups = D == 64 || D == 128;

template <typename TQ, typename TKV, int D>
cudaError_t launch_d(int G, const void* q, const void* k, const void* v, const int* lengths,
                     void* out, float* lse, float* pa, float* pm, int B, int S, int Hkv, int nsplit,
                     float scale, float softcap, cudaStream_t st) {
  switch (G) {
    case 1: return launch_typed<TQ, TKV, D, 1>(q, k, v, lengths, out, lse, pa, pm, B, S, Hkv, nsplit, scale, softcap, st);
    case 2: return launch_typed<TQ, TKV, D, 2>(q, k, v, lengths, out, lse, pa, pm, B, S, Hkv, nsplit, scale, softcap, st);
    case 4: return launch_typed<TQ, TKV, D, 4>(q, k, v, lengths, out, lse, pa, pm, B, S, Hkv, nsplit, scale, softcap, st);
    case 8: return launch_typed<TQ, TKV, D, 8>(q, k, v, lengths, out, lse, pa, pm, B, S, Hkv, nsplit, scale, softcap, st);
    case 3:
      if constexpr (kOddGroups<D>) return launch_typed<TQ, TKV, D, 3>(q, k, v, lengths, out, lse, pa, pm, B, S, Hkv, nsplit, scale, softcap, st);
      return cudaErrorInvalidValue;
    case 6:
      if constexpr (kOddGroups<D>) return launch_typed<TQ, TKV, D, 6>(q, k, v, lengths, out, lse, pa, pm, B, S, Hkv, nsplit, scale, softcap, st);
      return cudaErrorInvalidValue;
    case 7:
      if constexpr (kOddGroups<D>) return launch_typed<TQ, TKV, D, 7>(q, k, v, lengths, out, lse, pa, pm, B, S, Hkv, nsplit, scale, softcap, st);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

// The split kernel's head dims: all four for f32 queries; for bf16 q and
// cache only D = 32, since D 64, 128 and 256 go to decode_ring_kernel.
template <typename TQ, typename TKV>
cudaError_t launch_t(int D, int G, const void* q, const void* k, const void* v,
                     const int* lengths, void* out, float* lse, float* pa, float* pm, int B,
                     int S,
                     int Hkv, int nsplit, float scale, float softcap, cudaStream_t st) {
  constexpr bool kRingDtypes = std::is_same_v<TQ, __nv_bfloat16>;
  switch (D) {
    case 32: return launch_d<TQ, TKV, 32>(G, q, k, v, lengths, out, lse, pa, pm, B, S, Hkv, nsplit, scale, softcap, st);
    case 64:
      if constexpr (!kRingDtypes)
        return launch_d<TQ, TKV, 64>(G, q, k, v, lengths, out, lse, pa, pm, B, S, Hkv, nsplit, scale, softcap, st);
      return cudaErrorInvalidValue;
    case 128:
      if constexpr (!kRingDtypes)
        return launch_d<TQ, TKV, 128>(G, q, k, v, lengths, out, lse, pa, pm, B, S, Hkv, nsplit, scale, softcap, st);
      return cudaErrorInvalidValue;
    case 256:
      if constexpr (!kRingDtypes)
        return launch_d<TQ, TKV, 256>(G, q, k, v, lengths, out, lse, pa, pm, B, S, Hkv, nsplit, scale, softcap, st);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

// The ring kernel's groups at head dim D: kOddGroups' table, and G 16
// (recurrentgemma's MQA) at D = 256 only (kernel.RING_GROUPS).
template <int D>
cudaError_t launch_ring_d(int G, const void* q, const void* k, const void* v, const int* len,
                          void* out, float* ls, float* pa, float* pm, int* tk, int B, int S,
                          int Hkv, int nsplit, float scale, float softcap, cudaStream_t st) {
  switch (G) {
    case 1: return launch_ring<D, 1>(q, k, v, len, out, ls, pa, pm, tk, B, S, Hkv, nsplit, scale, softcap, st);
    case 2: return launch_ring<D, 2>(q, k, v, len, out, ls, pa, pm, tk, B, S, Hkv, nsplit, scale, softcap, st);
    case 4: return launch_ring<D, 4>(q, k, v, len, out, ls, pa, pm, tk, B, S, Hkv, nsplit, scale, softcap, st);
    case 8: return launch_ring<D, 8>(q, k, v, len, out, ls, pa, pm, tk, B, S, Hkv, nsplit, scale, softcap, st);
    case 3:
      if constexpr (kOddGroups<D>) return launch_ring<D, 3>(q, k, v, len, out, ls, pa, pm, tk, B, S, Hkv, nsplit, scale, softcap, st);
      return cudaErrorInvalidValue;
    case 6:
      if constexpr (kOddGroups<D>) return launch_ring<D, 6>(q, k, v, len, out, ls, pa, pm, tk, B, S, Hkv, nsplit, scale, softcap, st);
      return cudaErrorInvalidValue;
    case 7:
      if constexpr (kOddGroups<D>) return launch_ring<D, 7>(q, k, v, len, out, ls, pa, pm, tk, B, S, Hkv, nsplit, scale, softcap, st);
      return cudaErrorInvalidValue;
    case 16:
      if constexpr (D == 256) return launch_ring<D, 16>(q, k, v, len, out, ls, pa, pm, tk, B, S, Hkv, nsplit, scale, softcap, st);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16. q and out share q_dtype; the
// cache may be bf16 under f32 queries (the reference keeps its KV cache in
// bf16 for f32 parameters). Scratch from the caller: part_acc (B*Hq*nsplit*D
// f32), part_ml (B*Hq*nsplit*2 f32) and, for the bf16 kernel, tickets
// (B*Hkv int32, zero before the first launch; each launch leaves them zero).
// lse: B*Hq f32 for each query row's log-sum-exp, or null for none; with
// it, out is B*Hq*D f32 whatever q_dtype is.
// Returns cudaGetLastError() after the launches, or cudaErrorInvalidValue
// for a shape or type the kernel does not take.
int decode_attn_launch_lse(const void* q, const void* k, const void* v, const void* lengths,
                           void* out, void* lse, void* part_acc, void* part_ml, void* tickets,
                           int B, int S, int Hq, int Hkv, int D, int nsplit, float scale,
                           float softcap, int q_dtype, int kv_dtype, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || nsplit <= 0 || S <= 0) return cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  const int* len = static_cast<const int*>(lengths);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  int* tk = static_cast<int*>(tickets);
  float* ls = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 1 && kv_dtype == 1) {
    // bf16 q and cache: the ring kernel at D 64, 128 and 256 (kernel.RING_DIMS)
    switch (D) {
      case 64: return launch_ring_d<64>(G, q, k, v, len, out, ls, pa, pm, tk, B, S, Hkv, nsplit, scale, softcap, st);
      case 128: return launch_ring_d<128>(G, q, k, v, len, out, ls, pa, pm, tk, B, S, Hkv, nsplit, scale, softcap, st);
      case 256: return launch_ring_d<256>(G, q, k, v, len, out, ls, pa, pm, tk, B, S, Hkv, nsplit, scale, softcap, st);
      default:
        return launch_t<__nv_bfloat16, __nv_bfloat16>(D, G, q, k, v, len, out, ls, pa, pm, B, S, Hkv, nsplit, scale, softcap, st);
    }
  }
  if (q_dtype == 0 && kv_dtype == 0)
    return launch_t<float, float>(D, G, q, k, v, len, out, ls, pa, pm, B, S, Hkv, nsplit, scale, softcap, st);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch_t<float, __nv_bfloat16>(D, G, q, k, v, len, out, ls, pa, pm, B, S, Hkv, nsplit, scale, softcap, st);
  return cudaErrorInvalidValue;
}

// The same launches without the log-sum-exp.
int decode_attn_launch(const void* q, const void* k, const void* v, const void* lengths,
                       void* out, void* part_acc, void* part_ml, void* tickets, int B, int S,
                       int Hq, int Hkv, int D, int nsplit, float scale, float softcap,
                       int q_dtype, int kv_dtype, void* stream) {
  return decode_attn_launch_lse(q, k, v, lengths, out, nullptr, part_acc, part_ml, tickets, B, S,
                                Hq, Hkv, D, nsplit, scale, softcap, q_dtype, kv_dtype, stream);
}

const char* decode_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
