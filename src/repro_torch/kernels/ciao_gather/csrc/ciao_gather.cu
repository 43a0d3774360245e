// CIAO cached gather for Hopper (sm_90a): out[i] = table[indices[i]], each
// row served through a two-partition direct-mapped cache, with per-stream
// hit and miss counts.
//
// Replaces the TPU kernel src/repro/kernels/ciao_gather/kernel.py
// (_gather_kernel / ciao_gather_kernel). Slots [0, c_main) are the main
// partition ("L1D"), slots [c_main, c_main + max(c_iso, 1)) the isolated
// one ("unused shared memory"). A request of a stream whose iso_map bit is
// set maps to slot c_main + idx % max(c_iso, 1), any other to idx % c_main.
// It hits when the slot's tag equals idx; a miss loads the table row into
// the slot's data row and sets the tag. The cache starts empty (every tag
// -1) on each call, and stats[s] = [hits, misses] of stream s.
//
// Bound: bytes. The kernel writes T rows, reads each missed row and a few
// words of bookkeeping a request; it does no arithmetic on the data.
// A request's outcome depends on the earlier requests to its slot, but only
// through one fact: the tag any request leaves in its slot is its own idx
// (a miss sets it, a hit finds it). So request i hits exactly when the
// previous request to its slot, in request order, had the same idx, and the
// requests of a slot, in order, fall into residency runs (maximal stretches
// of one idx): one miss, then its hits. Runs are independent of one another,
// so the kernel works on runs, not on slot-serial chains. The design:
//  * Pre-pass, three kernels: a stable counting sort by slot, its work
//    linear in the requests and in slots x chunks. rank_kernel takes a
//    chunk of 32*W requests a block; a request's rank among the chunk's
//    requests to its slot comes from __match_any_sync within its warp plus
//    the counts of the earlier warps (W x (C+1) counters in shared memory),
//    and the block writes its per-slot counts, slot-major. chunk_scan_kernel
//    gives each slot a warp, which scans the slot's counts over the chunks
//    (the requests to it in earlier chunks) and writes its total.
//    scatter_kernel scans the totals in each block (C+1 entries) and writes
//    (i, idx, stream, slot) records, 16 bytes each, in slot order. Requests
//    out of range sort into an extra bucket C at the end. kernel.run_plan
//    writes the same order in Python.
//  * gather_kernel: a warp takes kBatch (2) consecutive records and serves
//    every run that starts among them (a record starts a run when its slot
//    or its idx differs from its predecessor's), reading on past the batch
//    while the run lasts. The run's row is read from the table once into the
//    lanes' registers (the slot's data row for that residency) and written
//    to out[i] for each request i of the run: the first counts as a miss,
//    the others as hits. Many runs are in flight on every SM, so the card
//    streams rows instead of waiting on one chain per slot.
//  * Rows move as raw bytes in the widest unit (16, 8, 4 or 2 bytes) that
//    divides the row and both base addresses, never through float, so f32
//    and bf16 share one kernel; row offsets are 64-bit.
//  * Per-stream counters live in shared memory and are added into stats
//    with integer atomics when the block ends; rank_kernel zeroes stats.
// A request whose index lies outside [0, N) or whose stream lies outside
// [0, S) touches no slot and no counter, and its row of out is zeros: the
// kernel never reads or writes outside table, out and stats.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnroll = 16;         // row units a lane keeps in flight
constexpr int kBatch = 2;           // records a gather warp starts runs in
constexpr int kGatherWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

// The slot of a request, or C for a request out of range.
__device__ __forceinline__ int bucket_of(int idx, int st, const int* __restrict__ iso_map, int N,
                                         int S, int c_main, int c_iso, int C) {
  if (idx < 0 || idx >= N || st < 0 || st >= S) return C;
  return iso_map[st] > 0 ? c_main + idx % c_iso : idx % c_main;
}

// ranks[i] = requests before i in its chunk with the same bucket;
// counts[b * chunks + chunk] = requests of the chunk in bucket b.
__global__ void rank_kernel(const int* __restrict__ indices, const int* __restrict__ streams,
                            const int* __restrict__ iso_map, int* __restrict__ counts,
                            int* __restrict__ ranks, int* __restrict__ stats, int T, int N, int S,
                            int c_main, int c_iso, int C) {
  extern __shared__ int wcount[];   // [warps][C + 1]
  const int C1 = C + 1, warps = blockDim.x >> 5, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int k = threadIdx.x; k < warps * C1; k += blockDim.x) wcount[k] = 0;
  if (blockIdx.x == 0)
    for (int k = threadIdx.x; k < 2 * S; k += blockDim.x) stats[k] = 0;
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = i < T ? bucket_of(indices[i], streams[i], iso_map, N, S, c_main, c_iso, C) : -1;
  const unsigned peers = __match_any_sync(kFull, b);
  const int wrank = __popc(peers & ((1u << lane) - 1u));
  if (b >= 0 && wrank == 0) wcount[w * C1 + b] = __popc(peers);
  __syncthreads();
  if (b >= 0) {
    int r = wrank;
    for (int u = 0; u < w; ++u) r += wcount[u * C1 + b];
    ranks[i] = r;
  }
  for (int s = threadIdx.x; s < C1; s += blockDim.x) {
    int tot = 0;
    for (int u = 0; u < warps; ++u) tot += wcount[u * C1 + s];
    counts[(size_t)s * gridDim.x + blockIdx.x] = tot;
  }
}

// One warp a bucket b: counts[b * nchunks + c] becomes the requests of
// bucket b in the chunks before c, and totals[b] its requests in all chunks.
__global__ void chunk_scan_kernel(int* __restrict__ counts, int* __restrict__ totals, int C1,
                                  int nchunks) {
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (b >= C1) return;
  int* row = counts + (size_t)b * nchunks;
  int carry = 0;
  for (int c0 = 0; c0 < nchunks; c0 += 32) {
    const int c = c0 + lane;
    const int v = c < nchunks ? row[c] : 0;
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    if (c < nchunks) row[c] = carry + incl - v;
    carry += __shfl_sync(kFull, incl, 31);
  }
  if (lane == 0) totals[b] = carry;
}

// Record (i, idx, stream, bucket) of every request at its place in the
// stable order by bucket.
__global__ void scatter_kernel(const int* __restrict__ indices, const int* __restrict__ streams,
                               const int* __restrict__ iso_map, const int* __restrict__ counts,
                               const int* __restrict__ totals, const int* __restrict__ ranks,
                               int4* __restrict__ records, int T, int N, int S, int c_main,
                               int c_iso, int C, int nchunks) {
  extern __shared__ int off[];      // [C + 1] bucket offsets of this chunk, then [32] warp sums
  __shared__ int carry;
  const int C1 = C + 1, warps = blockDim.x >> 5, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* wsum = off + C1;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int s0 = 0; s0 < C1; s0 += blockDim.x) {
    const int s = s0 + threadIdx.x;
    // the bucket's requests in all chunks, and in the chunks before this one
    const int tot = s < C1 ? totals[s] : 0;
    const int before = s < C1 ? counts[(size_t)s * nchunks + blockIdx.x] : 0;
    int incl = tot;   // inclusive scan of tot over the block
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) wsum[w] = incl;
    __syncthreads();
    if (w == 0) {
      const int x = lane < warps ? wsum[lane] : 0;
      int xi = x;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, xi, o);
        if (lane >= o) xi += y;
      }
      wsum[lane] = xi - x;
    }
    __syncthreads();
    const int excl = carry + wsum[w] + incl - tot;
    if (s < C1) off[s] = excl + before;
    __syncthreads();
    if (threadIdx.x == blockDim.x - 1) carry = excl + tot;
    __syncthreads();
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < T) {
    const int idx = indices[i], st = streams[i];
    const int b = bucket_of(idx, st, iso_map, N, S, c_main, c_iso, C);
    records[off[b] + ranks[i]] = make_int4(i, idx, st, b);
  }
}

// One warp serves the runs that start among kBatch records. Shared memory:
// the per-stream [hits, misses] counters.
template <typename U>
__global__ void __launch_bounds__(kGatherWarps * 32)
gather_kernel(const unsigned char* __restrict__ table, const int4* __restrict__ records,
              unsigned char* __restrict__ out, int* __restrict__ stats, int64_t row_bytes, int T,
              int S, int C) {
  extern __shared__ int cnt[];
  for (int k = threadIdx.x; k < 2 * S; k += blockDim.x) cnt[k] = 0;
  __syncthreads();
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = (blockIdx.x * kGatherWarps + w) * kBatch;
  const int n = (int)(row_bytes / (int64_t)sizeof(U));
  if (k0 < T) {
    const int kend = min(k0 + kBatch, T);
    const bool in = lane < kBatch && k0 + lane < T;
    const int4 rec = in ? records[k0 + lane] : make_int4(0, -1, 0, -1);
    int py = __shfl_up_sync(kFull, rec.y, 1), pb = __shfl_up_sync(kFull, rec.w, 1);
    if (lane == 0) {
      const int4 p = k0 > 0 ? records[k0 - 1] : make_int4(0, -1, 0, -1);
      py = p.y;
      pb = p.w;
    }
    const bool zero = in && rec.w == C;
    const bool start = in && rec.w < C && (rec.w != pb || rec.y != py);

    // requests out of range: zero rows
    for (unsigned zs = __ballot_sync(kFull, zero); zs; zs &= zs - 1) {
      const int i = __shfl_sync(kFull, rec.x, __ffs(zs) - 1);
      U* dst = reinterpret_cast<U*>(out + (int64_t)i * row_bytes);
      for (int u = lane; u < n; u += 32) dst[u] = U{};
    }

    const unsigned starts = __ballot_sync(kFull, start);
    const unsigned stops = __ballot_sync(kFull, start || zero);
    for (unsigned ss = starts; ss; ss &= ss - 1) {
      const int j = __ffs(ss) - 1, p = k0 + j;   // the run's first record
      const int ridx = __shfl_sync(kFull, rec.y, j), rb = __shfl_sync(kFull, rec.w, j);
      // one past its last record: the next start or zero row in the batch,
      // else read on past the batch while the slot and idx stay the same
      const unsigned later = stops & ~((2u << j) - 1u);
      int q = later ? k0 + __ffs(later) - 1 : kend;
      if (!later) {
        while (q < T) {
          const int4 r = q + lane < T ? records[q + lane] : make_int4(0, -1, 0, -1);
          const unsigned other = __ballot_sync(kFull, q + lane >= T || r.w != rb || r.y != ridx);
          if (other) {
            q += __ffs(other) - 1;
            break;
          }
          q += 32;
        }
        q = min(q, T);
      }
      // the row, read once, then written to every request of the run
      const U* src = reinterpret_cast<const U*>(table + (int64_t)ridx * row_bytes);
      for (int u0 = 0; u0 < n; u0 += 32 * kUnroll) {
        U v[kUnroll];
#pragma unroll
        for (int t = 0; t < kUnroll; ++t)
          if (u0 + lane + 32 * t < n) v[t] = src[u0 + lane + 32 * t];
        for (int r0 = p; r0 < q; r0 += 32) {
          const bool mine = r0 + lane < q;
          const int4 r = mine ? records[r0 + lane] : make_int4(0, 0, 0, 0);
          if (u0 == 0 && mine) atomicAdd(&cnt[2 * r.z + (r0 + lane == p ? 1 : 0)], 1);
          const int m = min(32, q - r0);
          for (int jj = 0; jj < m; ++jj) {
            U* dst = reinterpret_cast<U*>(out + (int64_t)__shfl_sync(kFull, r.x, jj) * row_bytes);
#pragma unroll
            for (int t = 0; t < kUnroll; ++t)
              if (u0 + lane + 32 * t < n) dst[u0 + lane + 32 * t] = v[t];
          }
        }
      }
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < 2 * S; k += blockDim.x)
    if (cnt[k]) atomicAdd(&stats[k], cnt[k]);
}

template <typename U>
cudaError_t launch_gather(const void* table, const int4* records, void* out, int* stats,
                          int64_t row_bytes, int T, int S, int C, cudaStream_t st) {
  const int per_block = kGatherWarps * kBatch;
  gather_kernel<U><<<(T + per_block - 1) / per_block, kGatherWarps * 32, (size_t)S * 8, st>>>(
      static_cast<const unsigned char*>(table), records, static_cast<unsigned char*>(out), stats,
      row_bytes, T, S, C);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// table (N, row_bytes) and out (T, row_bytes) as raw bytes; indices,
// streams (T,) and iso_map (S,) int32; stats (S, 2) int32. chunk_warps: W,
// the pre-pass's warps a block (32 W requests a chunk), with W * (C + 1)
// int32 counters in a block's shared memory, C = c_main + max(c_iso, 1).
// Scratch from the caller: counts, (ceil(T / (32 W)) + 1) * (C + 1) int32;
// ranks, T int32; records, T int4. Returns cudaGetLastError() after the launches,
// or cudaErrorInvalidValue for arguments the kernel does not take.
int ciao_gather_launch(const void* table, const void* indices, const void* streams,
                       const void* iso_map, void* out, void* stats, void* counts, void* ranks,
                       void* records, int N, int64_t row_bytes, int T, int S, int c_main,
                       int c_iso, int chunk_warps, void* stream) {
  if (N <= 0 || T <= 0 || S < 0 || c_main < 1 || c_iso < 0 || chunk_warps < 1 ||
      chunk_warps > 32 || row_bytes <= 0 || row_bytes % 2)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ci = c_iso > 0 ? c_iso : 1;
  const int C = c_main + ci, C1 = C + 1;
  const int chunk = 32 * chunk_warps;
  const int nchunks = (T + chunk - 1) / chunk;
  const int* idx = static_cast<const int*>(indices);
  const int* strm = static_cast<const int*>(streams);
  const int* iso = static_cast<const int*>(iso_map);
  int* cnt = static_cast<int*>(counts);
  int* totals = cnt + (size_t)nchunks * C1;
  int* rk = static_cast<int*>(ranks);
  int4* rec = static_cast<int4*>(records);
  int* stt = static_cast<int*>(stats);

  const size_t rank_smem = (size_t)chunk_warps * C1 * 4, scatter_smem = (size_t)C1 * 4 + 128;
  cudaError_t err = cudaFuncSetAttribute(rank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)rank_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)scatter_smem);
  if (err != cudaSuccess) return err;
  rank_kernel<<<nchunks, chunk, rank_smem, st>>>(idx, strm, iso, cnt, rk, stt, T, N, S, c_main,
                                                 ci, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  chunk_scan_kernel<<<(C1 + 7) / 8, 256, 0, st>>>(cnt, totals, C1, nchunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scatter_kernel<<<nchunks, chunk, scatter_smem, st>>>(idx, strm, iso, cnt, totals, rk, rec, T, N,
                                                       S, c_main, ci, C, nchunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // the widest unit that divides the row and both base addresses
  const uint64_t align = (uint64_t)row_bytes | reinterpret_cast<uintptr_t>(table) |
                         reinterpret_cast<uintptr_t>(out);
#define GATHER_ARGS table, rec, out, stt, row_bytes, T, S, C, st
  if (align % 16 == 0) return launch_gather<uint4>(GATHER_ARGS);
  if (align % 8 == 0) return launch_gather<uint2>(GATHER_ARGS);
  if (align % 4 == 0) return launch_gather<unsigned int>(GATHER_ARGS);
  return launch_gather<unsigned short>(GATHER_ARGS);
#undef GATHER_ARGS
}

const char* ciao_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
