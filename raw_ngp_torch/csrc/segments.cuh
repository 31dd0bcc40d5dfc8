// Segment totals of a key-sorted stream in a fixed order, without float
// atomics: the chunk-edge mechanism shared by kernel B2 (csrc/segsum.cu)
// and the dense levels' table gradient (csrc/hash_grad.cu).
//
// A warp owns a chunk of kChunk consecutive sorted records and sums each
// segment (a run of one key) in record order. A segment inside the chunk
// is a finished row: the warp stores it with plain stores. Only the
// chunk's first and last segments can continue into a neighbouring chunk;
// the warp writes such a partial to the chunk's slot of an edge buffer
// instead:
//   head[w]: the first segment, when it continues from chunk w - 1 (a
//            chunk holding one key that continues on both sides writes
//            only this);
//   tail[w]: the last segment, when it continues into chunk w + 1.
// A second launch (fixup_chain, one warp per chunk) finds each row that
// starts in chunk w and crosses into w + 1, adds tail[w] + head[w + 1] +
// ... + head[w_end] in chunk order, and stores the row once.
//
// Why that is order-free: every sum runs in an order fixed by the sorted
// stream alone (records in order inside a chunk, chunks in order across
// them); no float atomic, so two calls give the same bits whatever the SM
// count or the block schedule.
//
// Cost of the fix-up, and the long rows: a warp reads two or three keys
// and leaves unless its chunk starts a crossing row. That warp walks the
// row's chunks in batches: one ballot over the next chunk starts finds
// where the row ends, every load of a batch is issued before the first
// add, and the adds run in chunk order. A row that fills thousands of
// chunks (a dense level's funnel, the skew test streams) would make that
// walk a serial chain of global loads longer than the kernel itself, so
// it is cut by a fixed-shape tree: before the fix-up, group_sum (one warp
// per aligned group of kGroup = 32 chunks) adds the heads of every group
// that lies wholly inside one row, in chunk order; the walker then adds
// the heads up to the next group boundary, the whole groups' sums, and
// the heads after the last whole group, each in order. A row of n chunks
// costs about n / (32 kGroup) + 2 round trips to L2, and the order of
// every addition still depends on the chunk indices alone.
//
// The edge buffer a stream of n chunks needs (the wrapper allocates it:
// raw_ngp_torch/kernels/segsum.py edge_buffer): head [n, width], tail
// [n, width] and the group sums [ceil(n / kGroup), width], in that order.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace segments {

constexpr int kChunk = 128;                 // sorted records per warp
constexpr int kGroup = 32;                  // chunks a group sum covers
constexpr unsigned kFull = 0xffffffffu;

enum Role { kPlain = 0, kHead = 1, kTail = 2 };

// Where chunk w of an M-record stream lies and which of its ends continue.
struct Chunk {
  int64_t w;
  int s0, end;
  bool first_shared, last_shared;
};

__device__ __forceinline__ Chunk chunk_of(const int32_t* __restrict__ keys,
                                          int M, int64_t w) {
  Chunk ch;
  ch.w = w;
  ch.s0 = (int)(w * kChunk);
  ch.end = min(ch.s0 + kChunk, M);
  ch.first_shared = ch.s0 > 0 && keys[ch.s0 - 1] == keys[ch.s0];
  ch.last_shared = ch.end < M && keys[ch.end] == keys[ch.end - 1];
  return ch;
}

// The store of a finished segment: head when it is the chunk's first and
// continues from the chunk before, tail when it is the last and continues
// into the next, else the row itself.
__device__ __forceinline__ int role(const Chunk& ch, bool is_first,
                                   bool is_last) {
  if (is_first && ch.first_shared) return kHead;
  if (is_last && ch.last_shared) return kTail;
  return kPlain;
}

// Stores a segment's `width` sums (lane holds channels lane + 32 s) by its
// role; a row outside [0, n_rows) is dropped.
template <int kPerLane>
__device__ __forceinline__ void store(float* __restrict__ out,
                                      float* __restrict__ head,
                                      float* __restrict__ tail,
                                      const Chunk& ch, int which, int row,
                                      int n_rows, int width, const float* acc,
                                      int lane) {
  float* dst;
  if (which == kHead) {
    dst = head + ch.w * width;
  } else if (which == kTail) {
    dst = tail + ch.w * width;
  } else {
    if (row < 0 || row >= n_rows) return;
    dst = out + (int64_t)row * width;
  }
#pragma unroll
  for (int s = 0; s < kPerLane; ++s) {
    const int c = lane + 32 * s;
    if (c < width) dst[c] = acc[s];
  }
}

// acc[s] += rows[first + k][lane + 32 s] for k = 0 .. n - 1 in order, the
// loads of each batch issued before its adds
template <int kPerLane>
__device__ __forceinline__ void add_rows(float* acc,
                                         const float* __restrict__ rows,
                                         int64_t first, int n, int width,
                                         int lane) {
  constexpr int kBatch = 64 / kPerLane < 32 ? 64 / kPerLane : 32;
  for (int k0 = 0; k0 < n; k0 += kBatch) {
    float v[kBatch][kPerLane];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
#pragma unroll
      for (int s = 0; s < kPerLane; ++s) {
        const int c = lane + 32 * s;
        v[k][s] = k0 + k < n && c < width
                      ? rows[(first + k0 + k) * width + c] : 0.0f;
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (k0 + k < n) {
#pragma unroll
        for (int s = 0; s < kPerLane; ++s) {
          acc[s] = __fadd_rn(acc[s], v[k][s]);
        }
      }
    }
  }
}

// The group sum of group g (see the note above): written only where the
// group's kGroup chunks all hold one row that continues on both sides.
// Warp-uniform.
template <int kPerLane>
__device__ __forceinline__ void group_sum(const int32_t* __restrict__ keys,
                                          int M,
                                          const float* __restrict__ head,
                                          float* __restrict__ group,
                                          int width, int64_t g, int lane) {
  const int64_t s0 = g * kGroup * kChunk, e = s0 + kGroup * kChunk;
  if (s0 == 0 || e >= M) return;
  const int r = keys[s0];
  if (keys[s0 - 1] != r || keys[e] != r) return;
  float acc[kPerLane];
#pragma unroll
  for (int s = 0; s < kPerLane; ++s) acc[s] = 0.0f;
  add_rows<kPerLane>(acc, head, g * kGroup, kGroup, width, lane);
#pragma unroll
  for (int s = 0; s < kPerLane; ++s) {
    const int c = lane + 32 * s;
    if (c < width) group[g * width + c] = acc[s];
  }
}

// The fix-up of chunk w (see the note above); the warp's lanes hold the
// row's channels lane + 32 s. Warp-uniform: every lane takes the same
// branches.
template <int kPerLane>
__device__ __forceinline__ void fixup_chain(const int32_t* __restrict__ keys,
                                            int M,
                                            const float* __restrict__ head,
                                            const float* __restrict__ tail,
                                            const float* __restrict__ group,
                                            float* __restrict__ out,
                                            int n_rows, int width, int64_t w,
                                            int lane) {
  constexpr int kBatch = 64 / kPerLane < 32 ? 64 / kPerLane : 32;
  const int64_t s0 = w * kChunk;
  if (s0 >= M) return;
  const int64_t end = s0 + kChunk < M ? s0 + kChunk : M;
  if (end >= M) return;
  const int r = keys[end - 1];
  if (keys[end] != r) return;                           // nothing continues
  if (keys[s0] == r && s0 > 0 && keys[s0 - 1] == r) return;   // a middle
  if (r < 0 || r >= n_rows) return;                     // dropped
  float acc[kPerLane];
#pragma unroll
  for (int s = 0; s < kPerLane; ++s) {
    const int c = lane + 32 * s;
    acc[s] = c < width ? tail[w * width + c] : 0.0f;
  }
  // chunk q holds the row's next partial
  for (int64_t q = w + 1;;) {
    if (q % kGroup == 0) {
      // whole groups: group q / kGroup + j lies inside the row if the
      // chunk after it starts with r
      const int64_t next = (q + (int64_t)(lane + 1) * kGroup) * kChunk;
      const unsigned mask = __ballot_sync(kFull, next < M && keys[next] == r);
      const int n = ~mask ? __ffs(~mask) - 1 : 32;
      add_rows<kPerLane>(acc, group, q / kGroup, n, width, lane);
      q += (int64_t)n * kGroup;
      if (n == 32) continue;
    }
    // single chunks up to the next group boundary: chunk q + j belongs to
    // the row if chunks q .. q + j - 1 all hold r alone, i.e. if the chunk
    // after each of them starts with r
    const int limit = kGroup - (int)(q % kGroup) < kBatch
                          ? kGroup - (int)(q % kGroup) : kBatch;
    const int64_t next = (q + lane + 1) * kChunk;
    const bool more = lane < limit && next < M && keys[next] == r;
    const unsigned mask = __ballot_sync(kFull, more);
    const int stop = ~mask ? __ffs(~mask) - 1 : 32;  // the row's last chunk
    add_rows<kPerLane>(acc, head, q, stop + 1 < limit ? stop + 1 : limit,
                       width, lane);
    if (stop < limit) break;
    q += limit;
  }
  float* dst = out + (int64_t)r * width;
#pragma unroll
  for (int s = 0; s < kPerLane; ++s) {
    const int c = lane + 32 * s;
    if (c < width) dst[c] = acc[s];
  }
}

}  // namespace segments
