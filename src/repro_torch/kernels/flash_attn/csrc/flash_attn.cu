// Flash attention forward for Hopper (sm_90a): q (B, Sq, Hq, D) against
// k, v (B, Skv, Hkv, D), causal or not, with an optional local window or an
// optional prefix-LM prefix (only when causal, never both: keys before the
// prefix are visible to every query) and an optional tanh softcap.
//
// Replaces the TPU kernel src/repro/kernels/flash_attn/kernel.py
// (_attn_kernel / flash_attention_kernel): tiled online softmax in f32,
// scale then softcap then mask, masked scores -1e30 (never -inf), keys past
// Skv masked. The TPU kernel has no prefix; the reference computes its
// prefix-LM mask in jnp (models/attention.py attention_core), which this
// kernel serves. Where the TPU kernel skips tiles wholly above the diagonal or
// outside the window, a block here runs its KV loop only over [lo, hi),
// hi the end of its rows or of the prefix, whichever is later.
// GQA is an index map (q head h reads kv head h / (Hq/Hkv)); no repeated
// copy of K or V is built, and no padded copy either: rows past Sq or Skv
// arrive as zeros in shared memory.
//
// Two kernels, chosen by dtype:
//  * bf16: flash_wgmma_kernel, for the serving path: one design, with a
//    plan of tile and block sizes for each head dim (Plan<D>). Two bounds
//    at gemma2-2b's prefill (S = 4608, D = 256, softcap 50). The tensor
//    cores: a (q, k) pair costs 4*D operations against a few bytes of
//    input. And the special-function units under the softcap: a score
//    costs an ex2 and a rcp for the tanh (tanh.approx.f32 is too coarse at
//    a cap of 50) and an ex2 for the softmax, 3 of the SM's 16 a clock,
//    about 3/4 of the tensor-core time. So the softmax has to run beside
//    the products, not after them. The design:
//    - a block owns 64 NWG query rows of one (batch, q head); one producer
//      warp streams BK-key K and V tiles with TMA (4-D tensor maps over
//      (D, H, S, B), 128-byte swizzle, boxes of 64 columns) into a ring of
//      2 stages behind full/empty mbarriers, K of the next tile ahead of V
//      of this one;
//    - NWG consumer warpgroups (64 rows each; after setmaxnreg 240
//      registers a thread of two, 160 of three, the producer's warpgroup
//      24) run S = Q K^T as wgmma m64nBKk16 from shared memory and O += P V
//      as m64nDk16 with P from registers (the S accumulator is the A
//      fragment) and V MN-major;
//    - step i issues S_i and P_{i-1} V_{i-1} together and runs the softmax
//      of S_i while the PV product is in flight; the warpgroups take turns
//      to issue (named barriers), so one's softmax overlaps another's
//      products;
//    - scale*log2e is folded into the exponent (ex2), only tiles that
//      cross the diagonal (outside the prefix), the window's edge or Skv
//      apply the mask (each row's valid keys an interval [lo, hi]: two
//      compares a score), and O is rescaled only when a row's maximum
//      grows by more than 2^8;
//    - the blocks late in the sequence, which have the most tiles, launch
//      first;
//    - a warpgroup's O / l goes out through its Q buffer by TMA stores;
//    - at Sq <= 64 and D 64 (seamless's cross prefill) a block's keys are
//      split over both warpgroups (the launch modes, kPerBlock below).
//    P is rounded to bf16 for the PV product, as the reference's
//    attention_core rounds p to V's dtype. At D 256 (64-key tiles, two
//    warpgroups in ping-pong, 2 stages) the products alone run at ~89% of
//    the tensor-core rate; what holds the kernel near half its bound is
//    the softmax, which runs at about half speed beside the other
//    warpgroup's products (PERF.md).
//    At D 64 without a softcap (granite-moe's prefill, seamless's encoder)
//    the balance moves: a score's products cost 4*64 = 256 operations,
//    1/16 of an SM's clock at ~4,096 a clock, and its ex2 also 1/16 (16 a
//    clock), so the exponentials alone equal the products; and the costs of
//    a tile (mbarrier and named-barrier waits, wgmma fences, commits and
//    waits, the maxima's shuffles) weigh four times as much against a
//    quarter of the product work. D 256's plan reached 29-32% of the bound
//    there; without its softmax 45-51%, without its ex2 only 16-18%
//    faster, and without the bf16 packs of p no faster (they do not
//    compete with ex2). So what D 64 lacked was latency hidden, more than
//    special-function throughput. Its plan: 128-key tiles (half the costs a
//    key; S is 64 registers), three consumer warpgroups of 64 rows (192 a
//    block: three warps on each scheduler to hide the softmax's dependent
//    chains), and the row maximum taken on the raw scores, so an unmasked
//    tile's exponent is one FMA (x mul - m mul) and its maximum needs no
//    multiply. A query sequence that fits one block of two warpgroups (Sq
//    <= 128) runs two (short_block). D 128 takes the 128-key tiles and the
//    folded exponent with two warpgroups. Moving a share of the
//    exponentials to the FMA pipe (a polynomial 2^x), a deeper ring and
//    64-key tiles were timed and dropped (PERF.md; tools/flash_probe.py
//    keeps them as variants).
//  * f32: flash_f32_kernel keeps f32 end to end (TF32 would miss the f32
//    tolerance of 2e-5). A lane scores one key of a 32-key tile against 8
//    query rows with float4 reads of shared memory, and the PV product
//    broadcasts p across the warp with shuffles. It runs on the CUDA
//    cores, far from the tensor-core bound; it serves f32 checks, not the
//    bf16 serving path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "hopper.cuh"   // mbarriers, TMA, ex2/rcp, the tensor-map encoder

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;  // 4 warps

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
                                              int kpos, int Skv, int causal, int window,
                                              int prefix) {
  float x = dot * scale;
  if (softcap != 0.f) x = tanhf(x / softcap) * softcap;
  bool valid = kpos < Skv;
  if (causal) {
    valid = valid && (kpos <= qpos || kpos < prefix);
    if (window > 0) valid = valid && (qpos - kpos) < window;
  }
  return valid ? x : kNegInf;
}

// KV range [lo, hi) that a block of query rows [q_start, q_end) needs,
// lo rounded down to a tile boundary.
__device__ __forceinline__ void kv_range(int q_start, int q_end, int Skv, int causal, int window,
                                         int prefix, int tile, int& lo, int& hi) {
  lo = 0;
  hi = Skv;
  if (causal) {
    hi = min(Skv, max(q_end, prefix));
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
                 int Hq, int Hkv, float scale, float softcap, int causal, int window,
                 int prefix) {
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
  kv_range(q_start, q_end, Skv, causal, window, prefix, kF32BK, lo, hi);

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
      const float x =
          masked_score(s[i], scale, softcap, qpos, kt + lane, Skv, causal, window, prefix);
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
constexpr int kWgRows = 64;       // query rows a consumer warpgroup
constexpr int kStages = 2;        // K and V ring stages
constexpr float kRegrow = 8.f;    // log2 units a row maximum may grow before O is rescaled

// The bf16 kernel's plan at head dim D. BK: keys a tile; NWG: consumer
// warpgroups (64 query rows each, so a block takes 64 NWG rows; two for a
// short sequence, short_block); FOLD: the row maximum taken on the raw
// scores and the scale folded into the exponent's FMA (the masked tiles and
// the softcap keep the plain form); SPLIT: at Sq <= 64, key splits over
// both warpgroups (kSplit). D 32 and 256 keep the plan tuned at D 256; D 64
// and 128 have their own (PERF.md: each choice timed against its
// neighbours at the zoo's prefills).
template <int D>
struct Plan {
  static constexpr int BK = 64, NWG = 2;
  static constexpr bool FOLD = false, SPLIT = false;
};
template <>
struct Plan<64> {
  static constexpr int BK = 128, NWG = 3;
  static constexpr bool FOLD = true, SPLIT = true;
};
template <>
struct Plan<128> {
  static constexpr int BK = 128, NWG = 2;
  static constexpr bool FOLD = true, SPLIT = false;
};

// Launch modes of the bf16 kernel, chosen by shape in launch_wgmma_cap
// (kernel.launch_plan mirrors the choice, kernel.work_plan the schedule).
// Either way a block takes one item: 64 NWG query rows of one (batch, q
// head) (64 under kSplit); items are numbered longest first (the last
// q-block of every (batch, head), then the one before, and so on), and the
// card hands them out in that order as SMs free.
//  kPerBlock  the NWG consumer warpgroups take 64 rows each. Persistent
//             blocks walking static lists of items were timed at
//             paligemma's prefill and lost to this (PERF.md): once the
//             stores went out by TMA, little fixed cost was left to hide,
//             and the card's order balances items of unequal length better.
//  kSplit     (Sq <= 64) the two consumer warpgroups take alternate key
//             tiles of the same 64 rows (the second would otherwise compute
//             rows past Sq) with a ring of kSplitStages (two stages a
//             warpgroup); their partials (O unnormalised, m, l) merge in
//             shared memory into warpgroup 0's, which stores the rows. With
//             one tile (seamless's self prefill) the second has none, and
//             this still beat kPerBlock's second warpgroup computing rows
//             past Sq, in turns on an H100 (PERF.md, PR 29).
constexpr int kPerBlock = 0, kSplit = 1;
constexpr int kSplitStages = 4;

// Shared-memory images of the tiles, as the TMA boxes write them: D is cut
// into chunks of CW columns (64, or 32 at D = 32); a chunk holds a tile's
// rows (64 of Q a warpgroup, BK of K or V) of CW*2 bytes, swizzled at that
// width (128 or 64 bytes). That is the canonical swizzled layout of wgmma's
// operands: K-major for Q and K (the reduction dimension D runs along a
// row), MN-major for V in the PV product (its N dimension D runs along a
// row). NWG: the block's consumer warpgroups (the plan's, or two for a
// short query sequence: short_block). MODE: the launch mode.
template <int D, int NWG, int MODE = kPerBlock>
struct Tile {
  using P = Plan<D>;
  static constexpr int CW = D < 64 ? D : 64;
  static constexpr int NCH = D / CW;
  static constexpr int ROW_B = CW * 2;
  static constexpr int Q_CHUNK_B = kWgRows * ROW_B;
  static constexpr int Q_BYTES = NCH * Q_CHUNK_B;
  static constexpr int KV_CHUNK_B = P::BK * ROW_B;
  static constexpr int KV_BYTES = NCH * KV_CHUNK_B;
  static constexpr uint64_t LAYOUT = ROW_B == 128 ? 1 : 2;   // descriptor: B128 or B64
  static constexpr int BQ = MODE == kSplit ? kWgRows : NWG * kWgRows;   // query rows an item
  static constexpr int ST = MODE == kSplit ? kSplitStages : kStages;     // ring stages
  static constexpr int THREADS = 128 * (1 + NWG);             // producer warpgroup + consumers
  // Registers a thread after setmaxnreg: the producer's warpgroup gives up
  // all but 24, the consumers take what the SM's 64 K leave (240 of two,
  // 160 of three warpgroups).
  static_assert(NWG == 2 || NWG == 3, "two or three consumer warpgroups");
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS = NWG == 2 ? 240 : 160;
  // kSplit: warpgroup 1's partial in f32, O (D/2 a thread) then m and l
  // of a thread's two rows, at float (i * 128 + thread).
  static constexpr int PART_B = MODE == kSplit ? 128 * (D / 2 + 4) * 4 : 0;
  // mbarriers: Q full a warpgroup, K and V full and empty a stage.
  static constexpr int NBAR = NWG + 4 * ST;
  // Q (every warpgroup's rows), the K and V rings, the partial, the
  // mbarriers, and the slack to align the base to the swizzle pattern's
  // 1024 bytes.
  static constexpr size_t SMEM = 1024 + (size_t)NWG * Q_BYTES + (size_t)2 * ST * KV_BYTES +
                                 (size_t)PART_B + 8 * NBAR;
};

// A plan of three consumer warpgroups runs two when the query sequence fits
// one block of two (Sq <= 128: seamless's 64-token decoder prompt), which
// would otherwise leave two of three idle.
template <int D>
constexpr bool short_block(int Sq) {
  return Plan<D>::NWG == 3 && Sq <= 2 * kWgRows;
}

// Named barriers 1..NWG pass the right to issue wgmma from one consumer
// warpgroup to the next (256 threads: one side syncs, the other arrives).
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A TMA store of one box of a 4-D tensor map from shared memory, its
// commit, and the wait until every committed store has read its source.
// Threads that wrote the source first make their writes visible to the
// async proxy (fence.proxy.async) and meet at a barrier.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_store_commit_and_wait_read() {
  asm volatile("cp.async.bulk.commit_group;\ncp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// wgmma writes its accumulators and reads its register operand after the
// issuing instruction has retired. These empty statements pin each register
// after the wait, so the compiler neither reads an accumulator early nor
// reuses an operand's register while the product is in flight.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int K>
__device__ __forceinline__ void pin(uint32_t (&r)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle mode.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

// m64nNk16, bf16 in, f32 accumulate. wgmma_ss: A and B from shared memory,
// both K-major (N = 64 or 128 keys). wgmma_rs: A from registers, B from
// shared memory MN-major (the transpose bit), always accumulating.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S = Q K^T over D: D/16 k-steps of m64nBKk16, one commit group.
template <int D>
__device__ __forceinline__ void gemm_qk(float (&s)[Plan<D>::BK / 2], uint32_t q, uint32_t k) {
  using T = Tile<D, 2>;
  constexpr int KS = T::CW / 16;   // k-steps a chunk
  const uint64_t dq = smem_desc(q, 16, 8 * T::ROW_B, T::LAYOUT);
  const uint64_t dk = smem_desc(k, 16, 8 * T::ROW_B, T::LAYOUT);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t in = (kk % KS) * 32;
    wgmma_ss(s, dq + (((kk / KS) * T::Q_CHUNK_B + in) >> 4),
             dk + (((kk / KS) * T::KV_CHUNK_B + in) >> 4), kk > 0);
  }
  wgmma_commit();
}

// O += P V over the tile's BK keys: BK/16 k-steps of m64nDk16, P from
// registers, V MN-major (leading offset: the next chunk of D; stride
// offset: the next 8 keys), one commit group.
template <int D>
__device__ __forceinline__ void gemm_pv(float (&o)[D / 2], const uint32_t (&p)[Plan<D>::BK / 16][4],
                                        uint32_t v) {
  using T = Tile<D, 2>;
  const uint64_t dv = smem_desc(v, T::KV_CHUNK_B, 8 * T::ROW_B, T::LAYOUT);
#pragma unroll
  for (int ks = 0; ks < Plan<D>::BK / 16; ++ks)
    wgmma_rs(o, p[ks], dv + ((ks * 16 * T::ROW_B) >> 4));
  wgmma_commit();
}

// Scores of one tile, then the online softmax of this thread's two rows
// (ra and ra + 8; columns 8j + c0 + {0, 1} in s[4j..4j+3], N = BK/2 of them).
// Units: with FOLD and no softcap (RAW) the scores, m and the mask's -1e30
// stay raw dot products and u = mul = scale log2e takes a difference of
// them to log2 units. Otherwise the scores go to log2 units first and u = 1:
// x = dot * mul, or under CAP x = cap * tanh(dot * scale / cap) as
// cap - 2 cap / (e^{2 dot scale/cap} + 1), one ex2 and one rcp, with mul =
// 2 log2e scale / cap and cap2 = cap log2e. MASK: a row's valid keys are
// [lo, hi] (row_keys), the others' scores become -1e30; dl and dh are lo
// and hi less this thread's first key of the tile, kt + c0. A row keeps
// its reference maximum m until the tile's maximum exceeds it by more than
// kRegrow in log2 units (then corr takes the old sums to the new m; else
// corr = 1 and the O rescale is skipped): p = 2^((x - m) u) stays below
// 2^kRegrow, which f32 sums and bf16 p hold with the same relative
// precision, and O / l is unchanged. An unmasked RAW tile takes each
// exponent as one FMA, x u - m u (m is finite there: the tile has a valid
// key in every row); a masked tile as (x - m) u, which is 0 when x and m
// are both -1e30 (a row whose keys so far were all masked: p = 1 until the
// first valid key's corr = 0 wipes it) and far below the least float's
// exponent when only x is. The maxima and sums run in two chains at N = 64.
// On return s holds p and psum this thread's share of the row sums.
template <int N, bool CAP, bool MASK, bool FOLD>
__device__ __forceinline__ void softmax_tile(float (&s)[N], float mul, float cap2,
                                             const int (&dl)[2], const int (&dh)[2],
                                             float (&m)[2], float (&corr)[2], float (&psum)[2]) {
  constexpr bool RAW = FOLD && !CAP;
  constexpr int CH = N >= 64 ? 2 : 1;        // independent chains a row
  const float u = RAW ? mul : 1.f;
  float mx[CH][2], sum[CH][2];
#pragma unroll
  for (int c = 0; c < CH; ++c) mx[c][0] = m[0], mx[c][1] = m[1];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float x = s[i];
    if (CAP) {
      x = fmaf(-2.f * cap2, rcp(ex2(x * mul) + 1.f), cap2);
    } else if (!RAW) {
      x *= mul;
    }
    if (MASK) {
      const int key = (i / 4) * 8 + (i & 1), r = (i >> 1) & 1;
      x = key >= dl[r] && key <= dh[r] ? x : kNegInf;
    }
    s[i] = x;
    mx[(i >> 2) % CH][(i >> 1) & 1] = fmaxf(mx[(i >> 2) % CH][(i >> 1) & 1], x);
  }
  float nm[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float t = mx[0][r];
#pragma unroll
    for (int c = 1; c < CH; ++c) t = fmaxf(t, mx[c][r]);
    t = fmaxf(t, __shfl_xor_sync(0xffffffffu, t, 1));
    t = fmaxf(t, __shfl_xor_sync(0xffffffffu, t, 2));
    const bool grow = (t - m[r]) * u > kRegrow;
    corr[r] = grow ? ex2((m[r] - t) * u) : 1.f;
    m[r] = grow ? t : m[r];
    nm[r] = -m[r] * u;
#pragma unroll
    for (int c = 0; c < CH; ++c) sum[c][r] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int r = (i >> 1) & 1;
    const float e = MASK ? (s[i] - m[r]) * u : fmaf(s[i], u, nm[r]);
    s[i] = ex2(e);
    sum[(i >> 2) % CH][r] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    psum[r] = sum[0][r];
#pragma unroll
    for (int c = 1; c < CH; ++c) psum[r] += sum[c][r];
  }
}

template <int D, bool CAP>
__device__ __forceinline__ void softmax_step(bool mask, float (&s)[Plan<D>::BK / 2], float mul,
                                             float cap2, int k0, const int (&lo)[2],
                                             const int (&hi)[2], float (&m)[2], float (&corr)[2],
                                             float (&psum)[2]) {
  using P = Plan<D>;
  if (mask) {
    const int dl[2] = {lo[0] - k0, lo[1] - k0}, dh[2] = {hi[0] - k0, hi[1] - k0};
    softmax_tile<P::BK / 2, CAP, true, P::FOLD>(s, mul, cap2, dl, dh, m, corr, psum);
  } else {
    softmax_tile<P::BK / 2, CAP, false, P::FOLD>(s, mul, cap2, lo, hi, m, corr, psum);
  }
}

// The keys [lo, hi] that query row qpos may see: before Skv; when causal,
// at or below the diagonal or before the prefix, and inside the window.
__device__ __forceinline__ void row_keys(int qpos, int Skv, int causal, int window, int prefix,
                                         int& lo, int& hi) {
  lo = INT_MIN / 2;
  hi = Skv - 1;
  if (causal) {
    hi = min(hi, max(qpos, prefix - 1));
    if (window > 0) lo = qpos - window + 1;
  }
}

// p of the tile as the bf16 A operand of the PV product: the accumulator
// layout of S is the A fragment layout, keys 16ks.. in p[ks].
template <int N>
__device__ __forceinline__ void to_p(const float (&s)[N], uint32_t (&p)[N / 8][4]) {
#pragma unroll
  for (int ks = 0; ks < N / 8; ++ks)
#pragma unroll
    for (int j = 0; j < 4; ++j) p[ks][j] = pack_bf16(s[8 * ks + 2 * j], s[8 * ks + 2 * j + 1]);
}

// kSplit: a consumer thread's partial (its fragment's unnormalised O, and
// m and l of its two rows) in a shared-memory image of a warpgroup's, at
// float (i * 128 + tid): O[i] for i < N, then m[0..1], then l[0..1].
template <int N>
__device__ __forceinline__ void put_part(float* part, int tid, const float (&acc)[N],
                                         const float (&m)[2], const float (&l)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) part[i * 128 + tid] = acc[i];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    part[(N + r) * 128 + tid] = m[r];
    part[(N + 2 + r) * 128 + tid] = l[r];
  }
}

// The partial that put_part laid out at `part` merged into this thread's:
// each side scaled by 2^((m - M) u), M the larger m (u: the log2 units of
// m). A side whose m is -1e30 (no valid key yet) is wiped wherever the
// other has one.
template <int N>
__device__ __forceinline__ void merge_part(const float* part, int tid, float u, float (&acc)[N],
                                           float (&m)[2], float (&l)[2]) {
  float c1[2], c2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m2 = part[(N + r) * 128 + tid], mx = fmaxf(m[r], m2);
    c1[r] = ex2((m[r] - mx) * u);
    c2[r] = ex2((m2 - mx) * u);
    l[r] = l[r] * c1[r] + part[(N + 2 + r) * 128 + tid] * c2[r];
    m[r] = mx;
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    acc[i] = acc[i] * c1[(i >> 1) & 1] + part[i * 128 + tid] * c2[(i >> 1) & 1];
}

// Item t (longest first) of a launch: its (batch, head), first query row,
// and its KV tiles: nb tiles from key `last` down, BK apart.
struct Item {
  int b, h, q0, last, nb;
};

template <int D, int NWG, int MODE>
__device__ __forceinline__ Item work_item(int t, int Sq, int Skv, int Hq, int BH, int causal,
                                          int window, int prefix) {
  using T = Tile<D, NWG, MODE>;
  constexpr int kBK = Plan<D>::BK;
  const int nqb = (Sq + T::BQ - 1) / T::BQ, bh = t % BH;
  Item it;
  it.b = bh / Hq;
  it.h = bh % Hq;
  it.q0 = (nqb - 1 - t / BH) * T::BQ;
  int lo, hi;
  kv_range(it.q0, min(it.q0 + T::BQ, Sq), Skv, causal, window, prefix, kBK, lo, hi);
  it.nb = (hi - lo + kBK - 1) / kBK;
  it.last = lo + (it.nb - 1) * kBK;
  return it;
}

// One block: item blockIdx.x. Warpgroup 0 is the producer (one thread
// issues every TMA load); warpgroups 1..NWG are the consumers, 64 rows
// each (kSplit: the same 64 rows, alternate tiles). Tiles run from the
// item's last KV tile down to its first, so the tiles that cross the
// diagonal come first.
template <int D, bool CAP, int NWG, int MODE>
__global__ void __launch_bounds__(Tile<D, NWG, MODE>::THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_o, int B, int Sq, int Skv, int Hq,
                   int Hkv, float mul, float cap2, int causal, int window, int prefix) {
  using T = Tile<D, NWG, MODE>;
  constexpr int kBK = Plan<D>::BK, kNWG = NWG, kST = T::ST;
  constexpr bool kSplitMode = MODE == kSplit;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = sQ + kNWG * T::Q_BYTES, sV = sK + kST * T::KV_BYTES;
  const uint32_t sW = sV + kST * T::KV_BYTES;   // kSplit: warpgroup 1's partial
  const uint32_t bars = sW + T::PART_B;
  auto q_full = [&](int w) { return bars + 8u * w; };
  auto full_k = [&](int s) { return bars + 8u * (kNWG + s); };
  auto full_v = [&](int s) { return bars + 8u * (kNWG + kST + s); };
  auto empty_k = [&](int s) { return bars + 8u * (kNWG + 2 * kST + s); };
  auto empty_v = [&](int s) { return bars + 8u * (kNWG + 3 * kST + s); };
  const Item it = work_item<D, NWG, MODE>(blockIdx.x, Sq, Skv, Hq, B * Hq, causal, window,
                                          prefix);

  if (threadIdx.x == 0) {
    for (int w = 0; w < kNWG; ++w) mbar_init(q_full(w), 1);
    for (int s = 0; s < kST; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      // one arrival from each consumer warpgroup (kSplit: from the one
      // that takes the tile)
      mbar_init(empty_k(s), kSplitMode ? 1 : kNWG);
      mbar_init(empty_v(s), kSplitMode ? 1 : kNWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: each warpgroup's Q, then K of tile i+1 before V of
    // tile i, which the consumers need one step later.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(T::PRODUCER_REGS));
    if (threadIdx.x == 0) {
      for (int w = 0; w < kNWG; ++w) {
        mbar_expect_tx(q_full(w), T::Q_BYTES);
        for (int c = 0; c < T::NCH; ++c)
          tma_load(sQ + w * T::Q_BYTES + c * T::Q_CHUNK_B, &tm_q, q_full(w), c * T::CW, it.h,
                   it.q0 + (kSplitMode ? 0 : kWgRows * w), it.b);
      }
      auto load = [&](const CUtensorMap* map, uint32_t ring, bool is_k, int i) {
        const int st = i % kST;
        mbar_wait(is_k ? empty_k(st) : empty_v(st), ((i / kST) & 1) ^ 1);
        const uint32_t full = is_k ? full_k(st) : full_v(st);
        mbar_expect_tx(full, T::KV_BYTES);
        for (int c = 0; c < T::NCH; ++c)
          tma_load(ring + st * T::KV_BYTES + c * T::KV_CHUNK_B, map, full, c * T::CW,
                   it.h / (Hq / Hkv), it.last - i * kBK, it.b);
      };
      if (it.nb > 0) load(&tm_k, sK, true, 0);
      for (int i = 0; i < it.nb; ++i) {
        if (i + 1 < it.nb) load(&tm_k, sK, true, i + 1);
        load(&tm_v, sV, false, i);
      }
    }
  } else {
    // ---- consumers. Step v issues S_v = Q K_v^T and O += P_{v-1} V_{v-1}
    // together, then runs the softmax of S_v while the PV product is in
    // flight, then rescales O. The warpgroups take turns to issue (named
    // barrier 1 + cw waits for this one's turn, 1 + (cw + 1) % NWG passes it
    // on), so one's softmax overlaps the others' products; under kSplit
    // they run different tiles, without turns.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(T::CONSUMER_REGS));
    const int cw = wg - 1, tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int c0 = 2 * (lane % 4);
    const uint32_t sQw = sQ + cw * T::Q_BYTES;
    const int next = 1 + (cw + 1) % kNWG;
    const int i0 = kSplitMode ? cw : 0, di = kSplitMode ? 2 : 1;   // this warpgroup's tiles
    // log2 units of m: the raw scores' scale under FOLD without a softcap
    const float u = Plan<D>::FOLD && !CAP ? mul : 1.f;
    const int rmin = it.q0 + (kSplitMode ? 0 : kWgRows * cw), ra = rmin + 16 * warp + lane / 4;
    // this thread's rows' key bounds, less its first column c0
    int klo[2], khi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      row_keys(ra + 8 * r, Skv, causal, window, prefix, klo[r], khi[r]);
      klo[r] -= c0;
      khi[r] -= c0;
    }
    // Tiles that need no mask: every key before Skv, at or below the
    // diagonal of every row of this warpgroup or wholly inside the prefix,
    // and inside its window.
    auto masked = [&](int k0) {
      return k0 + kBK > Skv ||
             (causal && ((k0 + kBK - 1 > rmin && k0 + kBK > prefix) ||
                         (window > 0 && rmin + kWgRows - 1 - k0 >= window)));
    };
    const int cnt = it.nb > i0 ? (it.nb - i0 + di - 1) / di : 0;
    auto key = [&](int v) { return it.last - (i0 + v * di) * kBK; };   // its v-th tile's
    auto slot = [&](int v) { return i0 + v * di; };                    // and the item's count
    float acc[D / 2], s[kBK / 2], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2],
        psum[2];
    uint32_t p[kBK / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    mbar_wait(q_full(cw), 0);
    if (cnt > 0) {
      if (!kSplitMode && cw == kNWG - 1) named_arrive(1);   // warpgroup 0 issues first
      const int r0 = slot(0);
      mbar_wait(full_k(r0 % kST), (r0 / kST) & 1);
      if (!kSplitMode) named_sync(1 + cw);
      wgmma_fence();
      gemm_qk<D>(s, sQw, sK + (r0 % kST) * T::KV_BYTES);
      if (!kSplitMode) named_arrive(next);
      wgmma_wait<0>();
      pin(s);
      if (tid == 0) mbar_arrive(empty_k(r0 % kST));
      softmax_step<D, CAP>(masked(key(0)), s, mul, cap2, key(0), klo, khi, m, corr, psum);
      l[0] = psum[0];
      l[1] = psum[1];
      to_p(s, p);

      for (int v = 1; v < cnt; ++v) {
        const int rk = slot(v), rv = slot(v - 1), sk = rk % kST, sv = rv % kST;
        mbar_wait(full_k(sk), (rk / kST) & 1);
        mbar_wait(full_v(sv), (rv / kST) & 1);
        if (!kSplitMode) named_sync(1 + cw);
        wgmma_fence();
        gemm_qk<D>(s, sQw, sK + sk * T::KV_BYTES);
        gemm_pv<D>(acc, p, sV + sv * T::KV_BYTES);
        if (!kSplitMode) named_arrive(next);
        wgmma_wait<1>();
        pin(s);
        if (tid == 0) mbar_arrive(empty_k(sk));
        softmax_step<D, CAP>(masked(key(v)), s, mul, cap2, key(v), klo, khi, m, corr, psum);
        wgmma_wait<0>();
        pin(acc);
        pin(p);
        if (tid == 0) mbar_arrive(empty_v(sv));
        if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
          for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
        }
        l[0] = l[0] * corr[0] + psum[0];
        l[1] = l[1] * corr[1] + psum[1];
        to_p(s, p);
      }

      const int rv = slot(cnt - 1), sv = rv % kST;
      mbar_wait(full_v(sv), (rv / kST) & 1);
      if (!kSplitMode) named_sync(1 + cw);
      wgmma_fence();
      gemm_pv<D>(acc, p, sV + sv * T::KV_BYTES);
      // the last warpgroup's turn passes to no one
      if (!kSplitMode && cw != kNWG - 1) named_arrive(next);
      wgmma_wait<0>();
      pin(acc);
      pin(p);
    }

    if constexpr (kSplitMode) {
      // warpgroup 1's partial merges into warpgroup 0's, which stores
      float* wpart = reinterpret_cast<float*>(smem_raw + (sW - raw));
      if (cw == 1) {
        put_part(wpart, tid, acc, m, l);
        named_arrive(1);
        return;
      }
      named_sync(1);
      merge_part(wpart, tid, u, acc, m, l);
    }

    // Epilogue: the rows' sums over the quad; O / l rounded to bf16 into
    // this warpgroup's Q buffer (every QK product has read it) as the Q
    // map's boxes lay it out (chunks of CW columns, rows swizzled: the
    // 16-byte unit of a row XORed with the row's place in its 1024- or
    // 512-byte pattern), then one TMA store a chunk of its 64 rows, which
    // drops rows past Sq. Direct 4-byte stores, 8 rows a warp instruction,
    // took ~16 us of paligemma's prefill on an H100 (PERF.md).
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
    constexpr uint32_t kSwz = T::ROW_B == 128 ? 7 : 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint32_t row = 16 * warp + lane / 4 + 8 * r;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const int col = c0 + 8 * i;
        const uint32_t off = row * T::ROW_B + (col % T::CW) * 2;
        const uint32_t val = pack_bf16(acc[4 * i + 2 * r] * l[r], acc[4 * i + 2 * r + 1] * l[r]);
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(sQw + (col / T::CW) * T::Q_CHUNK_B +
                                                       (off ^ (((off >> 7) & kSwz) << 4))),
                     "r"(val)
                     : "memory");
      }
    }
    fence_proxy_async();
    bar_sync(5 + cw, 128);   // this warpgroup's rows are in shared memory
    if (tid == 0) {
      for (int c = 0; c < T::NCH; ++c)
        tma_store(&tm_o, sQw + c * T::Q_CHUNK_B, c * T::CW, it.h, rmin, it.b);
      tma_store_commit_and_wait_read();   // before the block's shared memory goes
    }
  }
}

// A 4-D map over a (B, S, H, D) bf16 tensor, innermost first, with a box of
// CW columns of one head and `rows` rows, swizzled as Tile<D, *> lays it
// out. Rows past S read as zeros and are dropped by a store; the next
// sequence is never read or written.
template <int D>
cudaError_t tensor_map(CUtensorMap* map, EncodeTiledFn encode, const void* ptr, int B, int S,
                       int H, int rows) {
  using T = Tile<D, 2>;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)T::CW, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      T::ROW_B == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                       int Skv, int Hq, int Hkv, float scale, float softcap, int causal,
                       int window, int prefix, cudaStream_t st) {
  constexpr size_t smem = f32_smem_bytes<D>();
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err = allow_smem(flash_f32_kernel<D>, (int)smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kF32BQ - 1) / kF32BQ, B * Hq);
  flash_f32_kernel<D><<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), Sq, Skv, Hq, Hkv, scale, softcap, causal, window, prefix);
  return cudaGetLastError();
}

template <int D, bool CAP, int NWG, int MODE>
cudaError_t launch_wgmma_mode(const CUtensorMap& tq, const CUtensorMap& tk,
                              const CUtensorMap& tv, const CUtensorMap& to, int B, int Sq, int Skv,
                              int Hq, int Hkv, float mul, float cap2, int causal, int window,
                              int prefix, cudaStream_t st) {
  using T = Tile<D, NWG, MODE>;
  static_assert(T::SMEM <= 232448, "Q, the ring, the partial and the barriers fit 227 KB");
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err = allow_smem(flash_wgmma_kernel<D, CAP, NWG, MODE>, (int)T::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const int items = B * Hq * ((Sq + T::BQ - 1) / T::BQ);
  flash_wgmma_kernel<D, CAP, NWG, MODE><<<items, T::THREADS, T::SMEM, st>>>(
      tq, tk, tv, to, B, Sq, Skv, Hq, Hkv, mul, cap2, causal, window, prefix);
  return cudaGetLastError();
}

// The launch mode by shape (kernel.launch_plan): kSplit at Sq <= 64 under a
// plan with SPLIT; else kPerBlock, with two warpgroups where a plan of three
// meets a short sequence (short_block).
template <int D, bool CAP>
cudaError_t launch_wgmma_cap(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                             const CUtensorMap& to, int B, int Sq, int Skv, int Hq, int Hkv,
                             float mul, float cap2, int causal, int window, int prefix,
                             cudaStream_t st) {
  using P = Plan<D>;
#define MODE_ARGS tq, tk, tv, to, B, Sq, Skv, Hq, Hkv, mul, cap2, causal, window, prefix, st
  if constexpr (P::SPLIT) {
    if (Sq <= kWgRows) return launch_wgmma_mode<D, CAP, 2, kSplit>(MODE_ARGS);
  }
  if constexpr (P::NWG == 3) {
    if (short_block<D>(Sq)) return launch_wgmma_mode<D, CAP, 2, kPerBlock>(MODE_ARGS);
  }
  return launch_wgmma_mode<D, CAP, P::NWG, kPerBlock>(MODE_ARGS);
#undef MODE_ARGS
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                         int Skv, int Hq, int Hkv, float scale, float softcap, int causal,
                         int window, int prefix, cudaStream_t st) {
  EncodeTiledFn encode;
  cudaError_t err = encode_tiled(&encode);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv, to;   // the output's map is the queries' (same shape and boxes)
  constexpr int kBK = Plan<D>::BK;
  if ((err = tensor_map<D>(&tq, encode, q, B, Sq, Hq, kWgRows)) != cudaSuccess) return err;
  if ((err = tensor_map<D>(&tk, encode, k, B, Skv, Hkv, kBK)) != cudaSuccess) return err;
  if ((err = tensor_map<D>(&tv, encode, v, B, Skv, Hkv, kBK)) != cudaSuccess) return err;
  if ((err = tensor_map<D>(&to, encode, o, B, Sq, Hq, kWgRows)) != cudaSuccess) return err;
  if (softcap != 0.f)
    return launch_wgmma_cap<D, true>(tq, tk, tv, to, B, Sq, Skv, Hq, Hkv,
                                     2.f * kLog2e * scale / softcap, softcap * kLog2e, causal,
                                     window, prefix, st);
  return launch_wgmma_cap<D, false>(tq, tk, tv, to, B, Sq, Skv, Hq, Hkv, scale * kLog2e, 0.f,
                                    causal, window, prefix, st);
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16; q, k, v and o share one dtype.
// prefix: keys before it are visible to every query when causal (0: none);
// a window and a prefix do not combine.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a shape, mask or type the kernel does not take.
int flash_attn_launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                      int Skv, int Hq, int Hkv, int D, float scale, float softcap, int causal,
                      int window, int prefix, int dtype, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Skv <= 0) return cudaErrorInvalidValue;
  if (causal && window > 0 && prefix > 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_ARGS q, k, v, o, B, Sq, Skv, Hq, Hkv, scale, softcap, causal, window, prefix, st
  if (dtype == 0) {
    switch (D) {
      case 32: return launch_f32<32>(FLASH_ARGS);
      case 64: return launch_f32<64>(FLASH_ARGS);
      case 128: return launch_f32<128>(FLASH_ARGS);
      case 256: return launch_f32<256>(FLASH_ARGS);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 32: return launch_wgmma<32>(FLASH_ARGS);
      case 64: return launch_wgmma<64>(FLASH_ARGS);
      case 128: return launch_wgmma<128>(FLASH_ARGS);
      case 256: return launch_wgmma<256>(FLASH_ARGS);
    }
  }
#undef FLASH_ARGS
  return cudaErrorInvalidValue;
}

const char* flash_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
