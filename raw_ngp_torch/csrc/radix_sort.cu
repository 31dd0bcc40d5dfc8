// Stable radix sort of int32 keys over their low `bits` bits, for Hopper
// (sm_90a): the table gradient's sorts.
//
// Replaces torch.sort(keys, stable=True) where the port's table gradient
// sorted (raw_ngp_torch/kernels/hash_encode.py: table_grad's window levels,
// mm_grad_level's dense cells), which stood for JAX's jax.lax.sort at
// raw_ngp_tpu/kernels/hash_fused.py:659 / :669. That is not a Pallas
// kernel: the sort sits in front of the two that are (B2, the dense
// level), and gives them their streams. What it computes: with k = key -
// offset in [0, 2^bits) for every key, the keys k in ascending order and
// the int32 source index of each, equal keys in source order: exactly
// torch.sort(keys - offset, stable=True) with the indices narrowed to
// int32, so B2 and the dense level receive the same streams as before and
// give the same bits.
//
// Bound: bytes. The least any sort of the stream moves is 12 B a record:
// read the key, write the sorted key and its int32 index (262,144 dense
// cells: 3.1 MB, 0.94 us at 3.35 TB/s; a window level of 1,048,576
// records: 3.8 us). torch.sort moved about 120 B a record: some four 8-bit
// passes over all 32 bits of the key with 8-byte indices, the index fill,
// the narrowing to int32 and the key subtraction before it, some 14
// launches a call.
//
// Design: onesweep (Adinets and Merrill, 2022) over the bits that vary.
// Window keys lie in [0, rows) with rows <= 2^19, dense cells in [0,
// res^3], so 13-19 bits, not 32. The passes take ceil(bits / 10) digits of
// at most 10 bits, split evenly (19 bits: 10 + 9; 13: 7 + 6; 31: 8 + 8 +
// 8 + 7), and cost one launch each after the first kernel:
//  1. radix_histogram_kernel, a cooperative launch (grid.sync): zeroes the
//     tile tickets, the out-of-range count and the look-back status words
//     (no memset launch), counts every pass's digits of k in shared memory
//     and adds the block's counts into the global histograms (integer
//     atomics: any order gives the same totals), then block 0 turns each
//     pass's histogram into its exclusive scan over digits: the global
//     start of every digit. Keys outside [0, 2^bits) are counted into a
//     scratch word the tests and chip_smoke.py read; the main path never
//     reads it (the keys' range holds by construction).
//  2. radix_pass_kernel, once a pass, a tile of kTile = 8,192 keys a block
//     of 512 threads (one block an SM: 128 registers a thread, 72 KB of
//     dynamic shared memory). A block takes its tile by an atomic ticket,
//     not by blockIdx, so the tiles it waits on below were all taken
//     earlier by running blocks and the wait cannot deadlock. It loads its
//     keys (each warp 512 consecutive ones, 16 rounds of 32), counts the
//     tile's digits with shared-memory atomics and publishes the counts at
//     once (flag "aggregate"; tile 0 its inclusive prefixes, from the
//     global digit starts). Each warp then ranks its keys stably: per
//     round, one ballot a digit bit gives each lane the lanes of its digit
//     (the rounds' masks first, all independent); the lowest of them reads
//     and bumps the warp's count of the digit in shared memory, the others
//     take their lower peers' count on top. The warps' counts become
//     offsets in warp order, the tile's counts its exclusive scan over
//     digits, and the keys are staged in shared memory in digit order.
//     Then the tile looks back over its predecessors' words, one tile a
//     step, until one carries an inclusive prefix, publishes its own (the
//     decoupled look-back, over exact integer counts), and writes the
//     staged keys out in runs, coalesced where a digit's run is long. The
//     first pass reads the keys in place with the offset subtracted and
//     makes the index from the position; the last writes the caller's
//     int32 outputs; between, ping-pong buffers in the scratch, so an odd
//     number of passes ends where an even one does.
//     Chosen on an H100 (port_tools/radix_sort_probe.py, PERF.md):
//     publishing the counts before the ranking and looking back after it
//     keeps the walks short; ballots rank faster than __match_any_sync;
//     8,192-key tiles beat 4,096-key ones from 1 Mi keys on.
// Every count is an exact integer, so the result does not depend on the
// schedule: two runs give the same bits, and no float atomic is used
// anywhere, so training stays bit-reproducible. Bytes a record for two
// passes: 4 (histogram) + 12 (first pass: key in, key and index out) + 16
// (second pass), about 32 B against torch.sort's 120, plus the status
// words: 4 B a digit a tile (0.5 B a record a pass at 10 bits), zeroed
// once.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                        // keys a thread a tile
constexpr int kWarpTile = 32 * kItems;            // 512
constexpr int kTile = kThreads * kItems;          // 8,192
constexpr int kMaxDigitBits = 10;
constexpr int kMaxRadix = 1 << kMaxDigitBits;
constexpr int kDigitsPerThread = kMaxRadix / kThreads;   // 2
constexpr int kMaxPasses = 4;                     // 31 bits: 8 + 8 + 8 + 7
constexpr int kMaxHistWords = 3 * kMaxRadix;      // 21-30 bits: 3 x 10
constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr uint32_t kFlagAggregate = 1u << 30;
constexpr uint32_t kFlagPrefix = 2u << 30;
constexpr uint32_t kValueMask = (1u << 30) - 1;   // so M < 2^30

// Where each part of the scratch lies (int32 words) and the digit passes.
struct Plan {
  int passes;
  int shift[kMaxPasses];
  int width[kMaxPasses];
  int hist_at[kMaxPasses];      // the pass's histogram, then digit starts
  int64_t status_at[kMaxPasses];  // the pass's [tiles][radix] status words
  int hist_words;
  int ticket_at;                // kMaxPasses tickets
  int oor_at;                   // keys outside [0, 2^bits)
  int64_t zero_words;           // [0, zero_words) zeroed by kernel 1
  int64_t tmp_at;               // ping-pong keys, then perm (passes > 1)
  int64_t total_words;
};

Plan make_plan(int M, int bits) {
  Plan p = {};
  p.passes = (bits + kMaxDigitBits - 1) / kMaxDigitBits;
  const int base = bits / p.passes, extra = bits % p.passes;
  const int64_t tiles = (M + kTile - 1) / kTile;
  int shift = 0, hist = 0;
  for (int i = 0; i < p.passes; ++i) {
    p.width[i] = base + (i < extra ? 1 : 0);
    p.shift[i] = shift;
    p.hist_at[i] = hist;
    shift += p.width[i];
    hist += 1 << p.width[i];
  }
  p.hist_words = hist;
  p.ticket_at = hist;
  p.oor_at = hist + kMaxPasses;
  int64_t at = (p.oor_at + 1 + 3) / 4 * 4;        // 16-byte aligned
  for (int i = 0; i < p.passes; ++i) {
    p.status_at[i] = at;
    at += tiles << p.width[i];
  }
  p.zero_words = (at + 3) / 4 * 4;
  p.tmp_at = p.zero_words;
  p.total_words = p.tmp_at + (p.passes > 1 ? 2 * (int64_t)M : 0);
  return p;
}

__device__ __forceinline__ uint32_t load_status(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// The exclusive prefix of v over the block's threads in thread order;
// *total gets the block's sum. Every thread of the block calls it.
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t v,
                                                         uint32_t* warp_tmp,
                                                         uint32_t* total) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tmp[wid] = x;
  __syncthreads();
  uint32_t before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t t = warp_tmp[w];
    before += w < wid ? t : 0u;
    all += t;
  }
  __syncthreads();                                // warp_tmp may be reused
  *total = all;
  return before + x - v;
}

// Kernel 1 (see the note): zero, count every pass's digits, scan them.
__global__ void __launch_bounds__(kThreads)
radix_histogram_kernel(const int32_t* __restrict__ keys, int M,
                       uint32_t offset, int bits, Plan plan,
                       uint32_t* __restrict__ scratch) {
  __shared__ uint32_t hist[kMaxHistWords];
  __shared__ uint32_t warp_tmp[kWarps];
  cg::grid_group grid = cg::this_grid();
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;

  uint4* zero = reinterpret_cast<uint4*>(scratch);
  for (int64_t i = tid; i < plan.zero_words / 4; i += stride) {
    zero[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int i = threadIdx.x; i < plan.hist_words; i += kThreads) hist[i] = 0;
  __syncthreads();
  uint32_t oor = 0;
  for (int64_t i = tid; i < M; i += stride) {
    const uint32_t k = (uint32_t)keys[i] - offset;
    oor += (k >> bits) != 0 ? 1u : 0u;
#pragma unroll
    for (int p = 0; p < kMaxPasses; ++p) {
      if (p < plan.passes) {
        const uint32_t d = (k >> plan.shift[p]) & ((1u << plan.width[p]) - 1);
        atomicAdd(&hist[plan.hist_at[p] + d], 1u);
      }
    }
  }
  __syncthreads();
  grid.sync();                                    // the zeroing is done
  for (int i = threadIdx.x; i < plan.hist_words; i += kThreads) {
    if (hist[i] != 0) atomicAdd(&scratch[i], hist[i]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) oor += __shfl_down_sync(kFull, oor, o);
  if ((threadIdx.x & 31) == 0 && oor != 0) {
    atomicAdd(&scratch[plan.oor_at], oor);
  }
  grid.sync();                                    // the counts are whole
  if (blockIdx.x != 0) return;
#pragma unroll
  for (int p = 0; p < kMaxPasses; ++p) {     // constant indices: no stack
    if (p >= plan.passes) break;
    const int radix = 1 << plan.width[p];
    uint32_t* starts = scratch + plan.hist_at[p];
    uint32_t v[kDigitsPerThread];
    uint32_t sum = 0;
#pragma unroll
    for (int q = 0; q < kDigitsPerThread; ++q) {
      const int d = threadIdx.x * kDigitsPerThread + q;
      v[q] = d < radix ? __ldcg(starts + d) : 0u;
      sum += v[q];
    }
    uint32_t total;
    uint32_t run = block_exclusive_scan(sum, warp_tmp, &total);
#pragma unroll
    for (int q = 0; q < kDigitsPerThread; ++q) {
      const int d = threadIdx.x * kDigitsPerThread + q;
      if (d < radix) starts[d] = run;
      run += v[q];
    }
  }
}

// The pass kernel's shared memory (dynamic: more than 48 KB at the
// larger tiles).
struct PassSmem {
  union {                       // the warps' digit counts, then the tile
    uint32_t counts[kWarps][kMaxRadix];       // in digit order
    struct {
      uint32_t key[kTile];
      uint32_t perm[kTile];
    } sorted;
  } sm;
  uint32_t tile_digits[kMaxRadix];    // the tile's counts, then its starts
  uint32_t adj[kMaxRadix];            // global start - tile start, a digit
};

// One digit pass over a tile of kTile keys a block (see the note).
template <bool kFirst>
__global__ void __launch_bounds__(kThreads)
radix_pass_kernel(const int32_t* __restrict__ keys_in,
                  const int32_t* __restrict__ perm_in,
                  int32_t* __restrict__ keys_out,
                  int32_t* __restrict__ perm_out,
                  uint32_t* __restrict__ scratch, int M, uint32_t offset,
                  int shift, int width, int hist_at, int ticket,
                  int64_t status_at) {
  extern __shared__ __align__(16) unsigned char pass_smem[];
  PassSmem& smem = *reinterpret_cast<PassSmem*>(pass_smem);
  auto& sm = smem.sm;
  uint32_t* tile_digits = smem.tile_digits;
  uint32_t* adj = smem.adj;
  __shared__ uint32_t warp_tmp[kWarps];
  __shared__ uint32_t s_tile;

  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int radix = 1 << width;
  const uint32_t dmask = (uint32_t)radix - 1;
  if (threadIdx.x == 0) s_tile = atomicAdd(&scratch[ticket], 1u);
  for (int d = lane; d < radix; d += 32) sm.counts[wid][d] = 0;
  for (int d = threadIdx.x; d < radix; d += kThreads) tile_digits[d] = 0;
  __syncthreads();
  const uint32_t tile = s_tile;
  const int64_t w0 = (int64_t)tile * kTile + wid * kWarpTile;
  uint32_t* status = scratch + status_at;

  // this warp's 512 consecutive keys, 16 rounds of 32
  uint32_t key[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int64_t i = w0 + it * 32 + lane;
    key[it] = 0;
    if (i < M) {
      key[it] = kFirst ? (uint32_t)keys_in[i] - offset : (uint32_t)keys_in[i];
    }
  }
  // the tile's count of each digit (integer atomics: any order gives the
  // same counts), published at once so that the tiles after it can look
  // back over it while it ranks its keys; tile 0 publishes its inclusive
  // prefixes
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    if (w0 + it * 32 + lane < M) {
      atomicAdd(&tile_digits[(key[it] >> shift) & dmask], 1u);
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < radix; d += kThreads) {
    const uint32_t c = tile_digits[d];
    if (tile == 0) {
      store_status(status + d, kFlagPrefix | (scratch[hist_at + d] + c));
    } else {
      store_status(status + (int64_t)tile * radix + d, kFlagAggregate | c);
    }
  }
  // stable rank of each key among the warp's keys of its digit: the
  // rounds' peer masks first (the lanes of one digit, from one ballot a
  // digit bit: cheaper than __match_any_sync), then the counts
  uint32_t peers[kItems], rank[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const uint32_t d = (key[it] >> shift) & dmask;
    uint32_t same = __ballot_sync(kFull, w0 + it * 32 + lane < M);
#pragma unroll
    for (int b = 0; b < kMaxDigitBits; ++b) {
      if (b < width) {
        const uint32_t ones = __ballot_sync(kFull, (d >> b) & 1u);
        same &= (d >> b) & 1u ? ones : ~ones;
      }
    }
    peers[it] = same;
  }
  uint32_t* wc = sm.counts[wid];
  const uint32_t lower = (1u << lane) - 1u;
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const bool ok = w0 + it * 32 + lane < M;
    const int leader = __ffs(peers[it]) - 1;
    uint32_t before = 0;
    if (ok && lane == leader) {
      const uint32_t d = (key[it] >> shift) & dmask;
      before = wc[d];
      wc[d] = before + __popc(peers[it]);
    }
    before = __shfl_sync(kFull, before, leader);
    rank[it] = before + __popc(peers[it] & lower);
    __syncwarp();
  }
  __syncthreads();
  // per digit, the warps' counts to offsets in warp order (digits strided
  // over the threads: no bank conflicts)
  for (int d = threadIdx.x; d < radix; d += kThreads) {
    uint32_t c = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t t = sm.counts[w][d];
      sm.counts[w][d] = c;
      c += t;
    }
  }
  // the tile's exclusive scan over digits (this thread's digits
  // contiguous), into tile_digits
  uint32_t cnt[kDigitsPerThread], start[kDigitsPerThread];
  uint32_t sum = 0;
#pragma unroll
  for (int q = 0; q < kDigitsPerThread; ++q) {
    const int d = threadIdx.x * kDigitsPerThread + q;
    cnt[q] = d < radix ? tile_digits[d] : 0u;
    start[q] = sum;
    sum += cnt[q];
  }
  uint32_t total;
  const uint32_t before = block_exclusive_scan(sum, warp_tmp, &total);
#pragma unroll
  for (int q = 0; q < kDigitsPerThread; ++q) {
    const int d = threadIdx.x * kDigitsPerThread + q;
    start[q] += before;
    if (d < radix) tile_digits[d] = start[q];
  }
  __syncthreads();
  for (int d = threadIdx.x; d < radix; d += kThreads) {
    const uint32_t s = tile_digits[d];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sm.counts[w][d] += s;
  }
  __syncthreads();
  // each key's place in the tile's digit order; the tile staged there
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const bool ok = w0 + it * 32 + lane < M;
    rank[it] += ok ? sm.counts[wid][(key[it] >> shift) & dmask] : 0u;
  }
  __syncthreads();                       // the counts' room becomes the tile
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int64_t i = w0 + it * 32 + lane;
    if (i < M) {
      sm.sorted.key[rank[it]] = key[it];
      sm.sorted.perm[rank[it]] = kFirst ? (uint32_t)i : (uint32_t)perm_in[i];
    }
  }
  // look back over the tiles before this one, one at a time for every
  // digit of the thread at once: add their counts up to the nearest
  // inclusive prefix, waiting while one is not yet published. (Reading
  // two or four tiles a step was slower on an H100: the extra loads cost
  // more than the steps they save.)
  uint32_t excl[kDigitsPerThread];
  bool pending[kDigitsPerThread];
  int n_pending = 0;
#pragma unroll
  for (int q = 0; q < kDigitsPerThread; ++q) {
    const int d = threadIdx.x * kDigitsPerThread + q;
    excl[q] = tile == 0 && d < radix ? scratch[hist_at + d] : 0u;
    pending[q] = tile != 0 && d < radix;
    n_pending += pending[q] ? 1 : 0;
  }
  const uint32_t* col = status + threadIdx.x * kDigitsPerThread;
  for (int64_t j = (int64_t)tile - 1; n_pending > 0; --j) {
    uint32_t w[kDigitsPerThread];
    bool ready;
    do {
      ready = true;
#pragma unroll
      for (int q = 0; q < kDigitsPerThread; ++q) {
        w[q] = pending[q] ? load_status(col + j * radix + q) : 0u;
        ready = ready && (!pending[q] || (w[q] & ~kValueMask) != 0);
      }
    } while (!ready);
#pragma unroll
    for (int q = 0; q < kDigitsPerThread; ++q) {
      if (pending[q]) {
        excl[q] += w[q] & kValueMask;
        if ((w[q] & ~kValueMask) == kFlagPrefix) {
          pending[q] = false;
          --n_pending;
        }
      }
    }
  }
  // publish the inclusive prefixes; each digit's global start less its
  // start in the tile
#pragma unroll
  for (int q = 0; q < kDigitsPerThread; ++q) {
    const int d = threadIdx.x * kDigitsPerThread + q;
    if (d < radix) {
      if (tile != 0) {
        store_status(status + (int64_t)tile * radix + d,
                     kFlagPrefix | (excl[q] + cnt[q]));
      }
      adj[d] = excl[q] - start[q];
    }
  }
  __syncthreads();
  const int64_t t0 = (int64_t)tile * kTile;
  const int n_tile = (int)(M - t0 < kTile ? M - t0 : kTile);
  for (int i = threadIdx.x; i < n_tile; i += kThreads) {
    const uint32_t k = sm.sorted.key[i];
    const uint32_t dst = adj[(k >> shift) & dmask] + (uint32_t)i;
    keys_out[dst] = (int32_t)k;
    perm_out[dst] = (int32_t)sm.sorted.perm[i];
  }
}

int g_hist_blocks[64] = {0};   // co-resident blocks of kernel 1, a device

}  // namespace

// The scratch of radix_sort for M keys of `bits` bits: layout[0] its
// int32 words, layout[1] the word that counts keys outside [0, 2^bits).
extern "C" void radix_sort_layout(int M, int bits, int64_t* layout) {
  const Plan p = make_plan(M, bits);
  layout[0] = p.total_words;
  layout[1] = p.oor_at;
}

// keys [M] i32 -> keys_out [M] i32, the keys less `offset` in ascending
// order, and perm_out [M] i32, the source index of each, equal keys in
// source order, for keys - offset in [0, 2^bits) (others are counted into
// the scratch and sorted by their low `bits` bits). scratch: the words of
// radix_sort_layout, uninitialised. 0 < M < 2^30, 1 <= bits <= 31; returns
// cudaErrorInvalidValue otherwise, else the first launch error.
extern "C" int radix_sort(const int32_t* keys, int32_t* keys_out,
                          int32_t* perm_out, uint32_t* scratch, int M,
                          int bits, int offset, void* stream) {
  if (M <= 0 || M >= (1 << 30) || bits < 1 || bits > 31) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan plan = make_plan(M, bits);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (g_hist_blocks[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, radix_histogram_kernel, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    // at most 4 a multiprocessor: enough to stream the keys, few to sync
    per_sm = per_sm < 4 ? per_sm : 4;
    g_hist_blocks[dev] = per_sm * sms > 0 ? per_sm * sms : 1;
    const int smem = (int)sizeof(PassSmem);
    err = cudaFuncSetAttribute(radix_pass_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(radix_pass_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t want = (M + kTile - 1) / kTile;
  const int blocks = (int)(want < g_hist_blocks[dev] ? want
                                                    : g_hist_blocks[dev]);
  uint32_t off = (uint32_t)offset;
  Plan plan_arg = plan;
  void* args[] = {(void*)&keys, (void*)&M, (void*)&off, (void*)&bits,
                  (void*)&plan_arg, (void*)&scratch};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(radix_histogram_kernel), dim3(blocks),
      dim3(kThreads), args, 0, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned tiles = (unsigned)((M + kTile - 1) / kTile);
  int32_t* tmp_keys = reinterpret_cast<int32_t*>(scratch + plan.tmp_at);
  int32_t* tmp_perm = tmp_keys + M;
  const int32_t* in_keys = keys;
  const int32_t* in_perm = nullptr;
  for (int p = 0; p < plan.passes; ++p) {
    const bool last_parity = (plan.passes - 1 - p) % 2 == 0;
    int32_t* out_keys = last_parity ? keys_out : tmp_keys;
    int32_t* out_perm = last_parity ? perm_out : tmp_perm;
    if (p == 0) {
      radix_pass_kernel<true><<<tiles, kThreads, sizeof(PassSmem), s>>>(
          in_keys, in_perm, out_keys, out_perm, scratch, M, off,
          plan.shift[p], plan.width[p], plan.hist_at[p],
          plan.ticket_at + p, plan.status_at[p]);
    } else {
      radix_pass_kernel<false><<<tiles, kThreads, sizeof(PassSmem), s>>>(
          in_keys, in_perm, out_keys, out_perm, scratch, M, off,
          plan.shift[p], plan.width[p], plan.hist_at[p],
          plan.ticket_at + p, plan.status_at[p]);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    in_keys = out_keys;
    in_perm = out_perm;
  }
  return static_cast<int>(cudaSuccess);
}
