// CIAO cached gather for Hopper (sm_90a): out[i] = table[indices[i]], each
// row served through a two-partition direct-mapped cache held in shared
// memory, with per-stream hit and miss counts.
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
// What holds it back is order: a request's outcome depends on the earlier
// requests to its slot. The design:
//  * Slots are independent of one another, so they are split across
//    warps: one warp owns one slot, keeps the slot's tag and data row in
//    shared memory and walks the slot's requests in request order. A
//    block holds a few slots; at gemma2-2b's table (rows of 4608 bytes) the
//    320 slots of c_main 256 and c_iso 64 take 1.41 MiB, far beyond one
//    SM's 227 KB, so the cache is spread over the card.
//  * A pre-pass of three kernels gathers each slot's requests, in order:
//    a count per (slot, chunk of kChunk requests), one exclusive scan in
//    (slot, chunk) order, and a scatter in which a request's rank inside
//    its chunk counts the earlier requests of the chunk with the same slot
//    (from the chunk's slots in shared memory). That is a stable counting
//    sort by slot; it writes (i, idx, stream) records, 16 bytes each.
//  * A hit copies the slot's shared-memory row to out[i]. A miss first
//    copies the table row into the slot's shared-memory row, then that row
//    to out[i] as for a hit. Rows move as raw bytes in the widest unit (16,
//    8, 4 or 2 bytes) that divides the row and both base addresses, never
//    through float, so f32 and bf16 share one kernel; row offsets are 64-bit.
//  * Per-stream counters live in shared memory and are added into stats
//    with integer atomics when the block ends.
// A request whose index lies outside [0, N) or whose stream lies outside
// [0, S) touches no slot and no counter, and its row of out is zeros: the
// kernel never reads or writes outside table, out and stats.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 1024;        // requests per pre-pass block, one a thread
constexpr int kScanThreads = 1024;
constexpr int kUnroll = 16;         // row units a lane keeps in flight
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int slot_of(int idx, int st, const int* __restrict__ iso_map,
                                       int N, int S, int c_main, int c_iso) {
  if (idx < 0 || idx >= N || st < 0 || st >= S) return -1;
  return iso_map[st] > 0 ? c_main + idx % c_iso : idx % c_main;
}

// counts[slot * nchunks + chunk] = requests of the chunk that map to slot.
__global__ void count_kernel(const int* __restrict__ indices, const int* __restrict__ streams,
                             const int* __restrict__ iso_map, int* __restrict__ counts, int T,
                             int N, int S, int c_main, int c_iso, int nchunks) {
  const int i = blockIdx.x * kChunk + threadIdx.x;
  if (i >= T) return;
  const int slot = slot_of(indices[i], streams[i], iso_map, N, S, c_main, c_iso);
  if (slot >= 0) atomicAdd(&counts[(int64_t)slot * nchunks + blockIdx.x], 1);
}

// In place, one block: a[k] becomes the sum of a[0..k), and a[M] the total.
__global__ void scan_kernel(int* __restrict__ a, int64_t M) {
  __shared__ int warp_sums[kScanThreads / 32];
  __shared__ int carry;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  if (t == 0) carry = 0;
  __syncthreads();
  for (int64_t base = 0; base < M; base += 4 * kScanThreads) {
    int v[4], sum = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int64_t k = base + 4 * t + q;
      v[q] = k < M ? a[k] : 0;
      sum += v[q];
    }
    int incl = sum;  // inclusive scan of the threads' sums within the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) warp_sums[w] = incl;
    __syncthreads();
    if (w == 0) {
      int ws = warp_sums[lane];
      int wincl = ws;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kFull, wincl, off);
        if (lane >= off) wincl += y;
      }
      warp_sums[lane] = wincl - ws;  // exclusive, per warp
    }
    __syncthreads();
    int run = carry + warp_sums[w] + incl - sum;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int64_t k = base + 4 * t + q;
      if (k < M) a[k] = run;
      run += v[q];
    }
    __syncthreads();
    if (t == kScanThreads - 1) carry = run;
    __syncthreads();
  }
  if (t == 0) a[M] = carry;
}

// Record (i, idx, stream) of every valid request at its slot's place; zero
// the out rows of the others.
__global__ void scatter_kernel(const int* __restrict__ indices, const int* __restrict__ streams,
                               const int* __restrict__ iso_map, const int* __restrict__ offsets,
                               int4* __restrict__ records, unsigned char* __restrict__ out,
                               int64_t row_bytes, int T, int N, int S, int c_main, int c_iso,
                               int nchunks) {
  __shared__ int slots[kChunk];
  const int i = blockIdx.x * kChunk + threadIdx.x;
  int idx = 0, st = 0, slot = -1;
  if (i < T) {
    idx = indices[i];
    st = streams[i];
    slot = slot_of(idx, st, iso_map, N, S, c_main, c_iso);
  }
  slots[threadIdx.x] = slot;
  __syncthreads();
  if (i >= T) return;
  if (slot < 0) {
    unsigned char* dst = out + (int64_t)i * row_bytes;
    for (int64_t b = 0; b < row_bytes; ++b) dst[b] = 0;
    return;
  }
  int rank = 0;  // earlier requests of this chunk in the same slot
  for (int j = 0; j < (int)threadIdx.x; ++j) rank += slots[j] == slot;
  const int pos = offsets[(int64_t)slot * nchunks + blockIdx.x] + rank;
  records[pos] = make_int4(i, idx, st, 0);
}

// dst[u] = src[u] for u = lane, lane + 32, ... < n: each lane issues up to
// kUnroll loads before it stores.
template <typename U>
__device__ __forceinline__ void copy_row(U* dst, const U* src, int n, int lane) {
  for (int u0 = lane; u0 < n; u0 += 32 * kUnroll) {
    U v[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q)
      if (u0 + 32 * q < n) v[q] = src[u0 + 32 * q];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q)
      if (u0 + 32 * q < n) dst[u0 + 32 * q] = v[q];
  }
}

// One warp per slot. Shared memory: the block's data rows (row_stride bytes
// each), then its tags, then the per-stream [hits, misses] counters.
template <typename U>
__global__ void gather_kernel(const unsigned char* __restrict__ table,
                              const int4* __restrict__ records,
                              const int* __restrict__ offsets, unsigned char* __restrict__ out,
                              int* __restrict__ stats, int64_t row_bytes, int row_stride, int C,
                              int S, int nchunks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x >> 5;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* tags = reinterpret_cast<int*>(smem + (size_t)warps * row_stride);
  int* cnt = tags + warps;
  for (int k = threadIdx.x; k < 2 * S; k += blockDim.x) cnt[k] = 0;
  if (lane == 0) tags[w] = -1;
  __syncthreads();

  const int slot = blockIdx.x * warps + w;
  if (slot < C) {
    U* row = reinterpret_cast<U*>(smem + (size_t)w * row_stride);
    const int n = (int)(row_bytes / (int64_t)sizeof(U));
    const int begin = offsets[(int64_t)slot * nchunks];
    const int end = offsets[(int64_t)(slot + 1) * nchunks];
    for (int k0 = begin; k0 < end; k0 += 32) {
      // 32 records at once, one a lane, handed round the warp in order
      const int4 rec = k0 + lane < end ? records[k0 + lane] : make_int4(0, 0, 0, 0);
      const int m = min(32, end - k0);
      for (int j = 0; j < m; ++j) {
        const int i = __shfl_sync(kFull, rec.x, j);
        const int idx = __shfl_sync(kFull, rec.y, j);
        const int st = __shfl_sync(kFull, rec.z, j);
        const bool hit = tags[w] == idx;
        __syncwarp();  // every lane has read the tag before lane 0 moves it
        if (!hit) {
          copy_row(row, reinterpret_cast<const U*>(table + (int64_t)idx * row_bytes), n, lane);
          if (lane == 0) tags[w] = idx;
        }
        // a lane reads back only the units it wrote, so no barrier here
        copy_row(reinterpret_cast<U*>(out + (int64_t)i * row_bytes), row, n, lane);
        if (lane == 0) atomicAdd(&cnt[2 * st + (hit ? 0 : 1)], 1);
        __syncwarp();  // the new tag is seen by the next request
      }
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < 2 * S; k += blockDim.x)
    if (cnt[k]) atomicAdd(&stats[k], cnt[k]);
}

template <typename U>
cudaError_t launch_gather(const void* table, const int4* records, const int* offsets, void* out,
                          int* stats, int64_t row_bytes, int row_stride, int C, int S,
                          int nchunks, int warps, cudaStream_t st) {
  const size_t smem = (size_t)warps * row_stride + (size_t)warps * 4 + (size_t)S * 8;
  cudaError_t err = cudaFuncSetAttribute(gather_kernel<U>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  gather_kernel<U><<<(C + warps - 1) / warps, 32 * warps, smem, st>>>(
      static_cast<const unsigned char*>(table), records, offsets,
      static_cast<unsigned char*>(out), stats, row_bytes, row_stride, C, S, nchunks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// table (N, row_bytes) and out (T, row_bytes) as raw bytes; indices,
// streams (T,) and iso_map (S,) int32; stats (S, 2) int32. Scratch from the
// caller: counts, (c_main + max(c_iso, 1)) * ceil(T / 1024) + 1 int32, and
// records, T int4. warps: slots (warps) a block of the gather kernel holds.
// Returns cudaGetLastError() after the launches, or cudaErrorInvalidValue
// for arguments the kernel does not take.
int ciao_gather_launch(const void* table, const void* indices, const void* streams,
                       const void* iso_map, void* out, void* stats, void* counts,
                       void* records, int N, int64_t row_bytes, int T, int S, int c_main,
                       int c_iso, int warps, void* stream) {
  if (N <= 0 || T <= 0 || S < 0 || c_main < 1 || c_iso < 0 || warps < 1 || warps > 32 ||
      row_bytes <= 0 || row_bytes % 2)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ci = c_iso > 0 ? c_iso : 1;
  const int C = c_main + ci;
  const int nchunks = (T + kChunk - 1) / kChunk;
  const int64_t M = (int64_t)C * nchunks;
  const int* idx = static_cast<const int*>(indices);
  const int* strm = static_cast<const int*>(streams);
  const int* iso = static_cast<const int*>(iso_map);
  int* cnt = static_cast<int*>(counts);
  int4* rec = static_cast<int4*>(records);
  int* stt = static_cast<int*>(stats);

  cudaError_t err = cudaMemsetAsync(cnt, 0, (size_t)(M + 1) * sizeof(int), st);
  if (err == cudaSuccess && S > 0) err = cudaMemsetAsync(stt, 0, (size_t)S * 8, st);
  if (err != cudaSuccess) return err;
  count_kernel<<<nchunks, kChunk, 0, st>>>(idx, strm, iso, cnt, T, N, S, c_main, ci, nchunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scan_kernel<<<1, kScanThreads, 0, st>>>(cnt, M);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scatter_kernel<<<nchunks, kChunk, 0, st>>>(idx, strm, iso, cnt, rec,
                                             static_cast<unsigned char*>(out), row_bytes, T, N,
                                             S, c_main, ci, nchunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // the widest unit that divides the row and both base addresses
  const uint64_t align = (uint64_t)row_bytes | reinterpret_cast<uintptr_t>(table) |
                         reinterpret_cast<uintptr_t>(out);
  const int row_stride = (int)((row_bytes + 15) / 16 * 16);
#define GATHER_ARGS table, rec, cnt, out, stt, row_bytes, row_stride, C, S, nchunks, warps, st
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
