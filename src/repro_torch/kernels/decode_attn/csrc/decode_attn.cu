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
// Two kernels:
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
//    sums them. It serves G = 1, 2, 4 and 8 query rows a KV head at every
//    head dim, 3, 6 and 7 at D 64 and 128 (granite-moe, nemotron, arctic),
//    and 16 at D 256; at G 16 (recurrentgemma's MQA) a warp holds 8 of the
//    rows and owns 8 keys, walked 4 at a time (kRingRows), so its registers
//    stay those of G 8. The softcap's tanh is 1 - 2/(e^{2y}+1): one ex2 and
//    one rcp, with scale*log2e folded in, and the softmax runs in base 2.
//    The block merges its warps in shared memory; the last block of a (b,
//    kv head) to finish (an atomic ticket after a __threadfence) merges the
//    splits' partials, which stay in L2, and writes the output. The ticket
//    is reset by that block, so the counters are zero between launches (one
//    set a stream: kernel._scratch). The host's work a launch is kept to the
//    launch itself: the tensor maps are encoded once a cache tensor and head
//    dim, and the shared-memory limit raised once a device.
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

#include <mutex>
#include <type_traits>

#include "hopper.cuh"   // mbarriers, TMA, ex2/rcp, the tensor-map encoder

namespace {

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

// Query rows a consumer warp holds: all G up to 8. The 288-thread block is
// allocated registers as 12 warps, which caps a thread at 168, and G 8
// takes 164-167 of them (phase 1's -Xptxas -v), so at G 16 (recurrentgemma's
// MQA, 16 query heads on one KV head) the warps split the rows instead:
// warp w holds R = 8 rows, (w % H) * R .. + R of the H = G / R groups, and
// walks 4 H keys of each stage in H passes of 4 keys out of shared memory,
// reading each K and V row in H warps instead of one; a lane holds what it
// holds at G 8. The passes are not unrolled: unrolled, ptxas spills 1.3 KB
// a thread (4 rows a warp unrolled: 0.3-0.4 KB), which cost 0.0506 against
// 0.0335 ms at recurrentgemma's decode step on an H100 (PERF.md).
template <int G>
constexpr int kRingRows = G > 8 ? 8 : G;

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

  constexpr int R = kRingRows<G>, H = G / R;
  // keys of a stage a consumer warp walks, in passes of kPassKeys; with at
  // most 4 rows a warp the passes are unrolled (granite-moe's G 3 at D 64:
  // 0.0262 -> 0.0208 ms on an H100), with more they are not (G 6-8 at D 128
  // and G 16 lose 9-39%, PERF.md)
  constexpr int kWarpKeys = kTileKeys * H / kConsumers;
  constexpr int kPassUnroll = R <= 4 ? kWarpKeys / kPassKeys : 1;
  static_assert(G % R == 0 && kConsumers % H == 0 && kWarpKeys % kPassKeys == 0,
                "rows and keys must split evenly over the warps");
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
    // this warp's rows (half * R .. + R) and keys (key0 .. + kWarpKeys of a
    // stage); for PV, this lane's columns (8 col .. + 8) and lane group
    const int half = warp % H, key0 = kWarpKeys * (warp / H), sub = lane & 7;
    const int col = lane % (D / 8), group = lane / (D / 8);
    const float4* q4 = reinterpret_cast<const float4*>(sq + half * R * D);
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
  // query row (qrow + g) was held by the warps w = half, half + H, ... as
  // their row g % R (half = g / R)
  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int g = idx / D, d = idx % D, w0 = g / R, r = g % R;
    float M = kNegInf;
#pragma unroll
    for (int w = w0; w < kConsumers; w += H) M = fmaxf(M, s_m[w * R + r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = w0; w < kConsumers; w += H) {
      const float c = ex2(s_m[w * R + r] - M);
      L += s_l[w * R + r] * c;
      A += s_acc[(w * R + r) * D + d] * c;
    }
    if (nsplit == 1) {
      const float o = A / fmaxf(L, 1e-30f);
      if (lse == nullptr) {
        out[(qrow + g) * D + d] = __float2bfloat16_rn(o);
      } else {
        reinterpret_cast<float*>(out)[(qrow + g) * D + d] = o;
        // M is in base 2 (log2e times the score); an all-masked row's is
        // the fill itself, which stays -1e30 as the f32 path's does
        if (d == 0) lse[qrow + g] = all_masked ? kNegInf : (M + log2f(L)) * kLn2;
      }
    } else {
      const size_t row = (qrow + g) * nsplit + split;
      part_acc[row * D + d] = A;
      if (d == 0) {
        part_ml[row * 2] = M;
        part_ml[row * 2 + 1] = L;
      }
    }
  }
  if (nsplit == 1) return;

  // The last split of this (b, kv head) to finish merges all of them.
  __threadfence();
  __syncthreads();
  int* ticket = tickets + (size_t)b * Hkv + kvh;
  if (threadIdx.x == 0) *last_flag = atomicAdd(ticket, 1) == nsplit - 1;
  __syncthreads();
  if (!*last_flag) return;
  __threadfence();
  if (threadIdx.x == 0) *ticket = 0;   // ready for the next launch
  // Each query row's splits are weighted once, a warp a row: 2^(m_s - M) / L
  // into the ring, which is free again. Then each thread sums 4 columns'
  // partial accumulators over the splits with those weights, so the
  // merge reads each partial once (at G 16 and 32 splits, 512 KB).
  float* s_w = reinterpret_cast<float*>(ring_smem);   // [G][nsplit]
  for (int g = warp; g < G; g += kRingThreads / 32) {
    const float* ml = part_ml + (qrow + g) * nsplit * 2;
    float M = kNegInf;
    for (int s = lane; s < nsplit; s += 32) M = fmaxf(M, __ldcg(ml + 2 * s));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    float L = 0.f;
    for (int s = lane; s < nsplit; s += 32) {
      const float c = ex2(__ldcg(ml + 2 * s) - M);
      s_w[g * nsplit + s] = c;
      L += __ldcg(ml + 2 * s + 1) * c;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) L += __shfl_xor_sync(0xffffffffu, L, o);
    const float inv = 1.f / fmaxf(L, 1e-30f);
    if (lse != nullptr && lane == 0) lse[qrow + g] = all_masked ? kNegInf : (M + log2f(L)) * kLn2;
    for (int s = lane; s < nsplit; s += 32) s_w[g * nsplit + s] *= inv;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D / 4; idx += blockDim.x) {
    const int g = idx / (D / 4), c4 = idx % (D / 4);
    const float4* acc4 = reinterpret_cast<const float4*>(part_acc + (qrow + g) * nsplit * D) + c4;
    const float* w = s_w + g * nsplit;
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = 0; s < nsplit; ++s) {
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

// A 4-D map over a (B, S, Hkv, D) bf16 cache, innermost first, with a box
// of one head's D columns and a stage's 8192 / D rows (RingShape), unswizzled
// (row r of the box at r * 2 D bytes).
cudaError_t cache_map(CUtensorMap* map, EncodeTiledFn encode, const void* ptr, int B, int S,
                      int Hkv, int D) {
  const cuuint64_t row = 2 * (cuuint64_t)D;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Hkv, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {row, Hkv * row, S * Hkv * row};
  const cuuint32_t box[4] = {(cuuint32_t)D, 1, (cuuint32_t)(kStageB / (2 * row)), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The maps of the caches launched on so far, encoded once each: the serving
// path passes the same cache tensors at every step, and a map depends only
// on (pointer, B, S, Hkv, D), the head dim setting its box too. 256
// entries, direct-mapped by the pointer; a collision, or a pointer reused at
// another shape or head dim, encodes again. ctypes drops the GIL, hence the
// lock.
struct MapEntry {
  CUtensorMap map;
  const void* ptr;
  int B, S, Hkv, D;
};

cudaError_t cached_cache_map(CUtensorMap* map, const void* ptr, int B, int S, int Hkv, int D) {
  static std::mutex mu;
  static MapEntry table[256];
  const uint64_t h = (reinterpret_cast<uintptr_t>(ptr) * 0x9E3779B97F4A7C15ull) >> 56;
  std::lock_guard<std::mutex> lock(mu);
  MapEntry& e = table[h];
  if (e.ptr != ptr || e.B != B || e.S != S || e.Hkv != Hkv || e.D != D) {
    EncodeTiledFn encode;
    cudaError_t err = encode_tiled(&encode);
    if (err == cudaSuccess) err = cache_map(&e.map, encode, ptr, B, S, Hkv, D);
    if (err != cudaSuccess) {
      e.ptr = nullptr;
      return err;
    }
    e.ptr = ptr;
    e.B = B;
    e.S = S;
    e.Hkv = Hkv;
    e.D = D;
  }
  *map = e.map;
  return cudaSuccess;
}

template <int D, int G, bool CAP>
cudaError_t launch_ring_cap(const void* q, const void* k, const void* v, const int* lengths,
                            void* out, float* lse, float* pa, float* pm, int* tickets, int B, int S,
                            int Hkv, int nsplit, float mul, float cap2, cudaStream_t st) {
  constexpr size_t smem = ring_smem_bytes<D, G>();
  static_assert(smem <= 232448, "the ring, q and the barriers fit a block's 227 KB");
  static std::atomic<uint64_t> smem_set{0};
  CUtensorMap tk, tv;
  cudaError_t err;
  if ((err = cached_cache_map(&tk, k, B, S, Hkv, D)) != cudaSuccess) return err;
  if ((err = cached_cache_map(&tv, v, B, S, Hkv, D)) != cudaSuccess) return err;
  if ((err = allow_smem(decode_ring_kernel<D, G, CAP>, (int)smem, smem_set)) != cudaSuccess)
    return err;
  decode_ring_kernel<D, G, CAP><<<dim3(nsplit, Hkv, B), kRingThreads, smem, st>>>(
      tk, tv, static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), lengths, static_cast<__nv_bfloat16*>(out), lse, pa, pm,
      tickets, S, Hkv, mul, cap2);
  return cudaGetLastError();
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
