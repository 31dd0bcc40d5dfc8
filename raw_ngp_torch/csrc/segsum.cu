// Sorted segment totals of an outer-product record stream, for Hopper
// (sm_90a): kernel B2 of the port.
//
// Replaces the TPU kernel raw_ngp_tpu/kernels/segsum_pallas.py
// (_segment_totals_impl / _kernel, outer mode, reached by
// segment_totals_outer_pallas from the hash-table gradient), which placed
// each 1024-record tile with a one-hot MXU contraction over a sequential
// grid of 512-row blocks. What it computes carries over, not its blocks:
//   out[r, c]     = sum over records i with key i == r of bf16(w0_i * g_i[c])
//   out[r, C + c] = sum over the same records of          bf16(w1_i * g_i[c])
// where w0, w1 and g are bf16 truncations of f32 (the top 16 bits of each
// half of a packed word), each product is exact in f32 and rounded once
// to bf16 (__float2bfloat16_rn, as the TPU kernel's astype(bfloat16)),
// and the totals are f32. Rows without records stay 0 (the wrapper zeroes
// `out`). Only the order of the f32 additions differs from the plain
// version (index_add_ in raw_ngp_torch/kernels/segsum.py), and that order
// is fixed: two calls on the same stream give the same bits.
//
// Records arrive sorted by key (torch.sort, outside the kernel, as JAX
// sorts outside Pallas) with the permutation `perm`; the kernel reads the
// (w0, w1) word of record perm[i] and the g channels of point perm[i] % B,
// so the sort moves one key column instead of the C/2 g-words per record.
// It reads g in place, the level's C channels at column g_col of the
// encode's cotangent g [B, g_stride] (bf16 or f32), and forms each payload
// word there (payload_word): channel g_col + 2p in the high half and
// g_col + 2p + 1 in the low, each truncated to bf16, the word JAX's
// _pack_bf16_pairs gives (hash_fused.py:661-664). For bf16 g that is one
// u32 load with its halves swapped; for f32 g, the top halves of two f32.
// So no packed copy of g exists, and the words, and every sum, are the
// bits of a packed copy.
//
// Design (the 2C mode, and the flat mode at C = 32; below that the flat
// mode's walk, further down). One warp owns a chunk of segments::kChunk
// (128) consecutive sorted records; its lanes are output channels (2C of
// them, two per lane when 2C = 64). The warp walks its records in order
// and keeps each lane's running total in a register; when the key changes
// it stores the finished row with a plain 128-byte store. So a segment
// that holds most of the stream (a dense level funnels ~1M records into
// 4,096 rows) costs each warp it spans one register sum, not a serial
// chain on one thread. Only a chunk's first and last segment can continue
// into a neighbouring chunk: those partials go to the chunk's head / tail
// slot of an edge buffer, and a second launch adds each crossing row's
// partials in chunk order and stores it once (csrc/segments.cuh; no float
// atomic). Per 32 records, the lanes load the keys, permutation and
// w-words in one coalesced pass, then stage the 32 points' g words in
// shared memory (8 lanes read one point's 32 bytes of bf16 g at C = 16),
// so every global load of a sub-chunk is issued before any is consumed.
//
// Bound: bytes. Per record the kernel reads the key, the permutation and
// one w-word (12 B) and one point's C g-channels (2C B in bf16; cached, at
// most B distinct points); it writes each touched row of 2C f32 once, and the
// wrapper's zero fill writes the whole [n_rows, 2C] output once. At the
// flagship's level 1 (1,048,576 records, 262,144 points, C = 16, 524,288
// rows) that is about 12.6 + 8.4 + 67 MB. The work is 4C flops a record.
// The edge partials add at most two rows of 2C f32 a chunk (2 MB at level
// 1, written once and read once), and two small launches: the group sums
// and the fix-up, which reads two or three keys a chunk. The skew
// streams' row of ~940k records spans some 7,300 chunks: 230 group sums
// of 32 chunks each, which its fix-up warp adds 32 at a time.
//
// The flat mode (segment_grad_outer_fwd; kFlat) writes the table
// gradient's window rows itself, out[r] = G0[r] + G1[r - 1] in [n_rows *
// C] f32 (JAX's g0 + shift(g1), hash_fused.py:682-686), so neither the
// [n_rows, 2C] totals nor a combine pass exist. The sums are the 2C mode's,
// bit for bit (the same walk, chunk edges and fix-up); only where a
// finished total goes changes. Take the finished keys in order: each row
// with a contribution belongs to one consecutive pair (a, b), written by
// one warp with one __fadd_rn (write_pair), no atomics. A pair of two
// plain segments of one chunk is written by the main kernel, which keeps
// the previous plain segment's key and G1 in registers (lanes C..2C-1
// hold G1; a shuffle moves it onto lanes 0..C-1; at C = 32 each lane holds
// both halves). Every other pair involves a chunk's first or last plain
// segment (their G0 / G1 go to per-chunk slots) or a row that crosses
// chunks (the fix-up stores its total in a slot with the chunk where it
// ends), and a third small launch, the join, writes it: a group of C lanes
// a chunk, its successor found in O(1) (segsum_flat_join_kernel). The wrapper
// zeroes `out` once, which leaves the rows between pairs at +0. Bound at
// level 1: 12.6 + 8.4 MB read, 33.5 MB written once.
//
// The narrow widths (C <= kWalkMaxC = 16; every preset but the TPU profile
// runs C = 2, the tp shards C = 1 and 8). With a lane an output channel, a
// warp of the walk above holds 2C of 32 lanes busy (4 at C = 2), yet every
// lane issues each record's shuffles, compare, shared load, product and add:
// an `-O2` step's 63 M records cost some 1 G warp instructions, most of them
// for idle lanes, and that walk, not bytes, bound the main pass (3.31 of
// B2's 3.92 ms of device time a step on an H100 at 700 W). The flat mode's
// walk there (segsum_flat_walk_kernel) gives a warp 32 / C consecutive
// chunks and a group of C lanes each: lane c of a group sums channel c of
// both halves, so every lane works, a warp instruction advances 32 / C
// records, and G1 needs no shuffle. Each group walks its chunk as a warp
// does above (the same records in the same order, the same slots), so the
// sums, the fix-up and the join are bit for bit the walk above's, and the 2C
// mode keeps that walk as their oracle. The fix-up and the join take a group
// of C lanes a chunk too, at every width. At C = 32 the walk above stays:
// there it was faster (one chunk a warp either way, and its g staging
// spreads a point's 16 words over lanes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "segments.cuh"

namespace {

constexpr int kWarps = 8;                 // warps per block
using segments::kChunk;
using segments::kFull;

__device__ __forceinline__ float hi_bf16(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ float lo_bf16(uint32_t w) {
  return __uint_as_float(w << 16);
}

// Payload word p of one point whose level channels start at element `at`
// of g: channel 2p in the high half, 2p + 1 in the low (0 past C), each
// truncated to bf16. For C >= 2 the wrapper guarantees that `at` and the
// row stride are even and g is 4-byte (bf16) or 8-byte (f32) aligned, so
// the pair is one aligned load; C = 1 reads its one channel alone.
template <int C, bool kBf16>
__device__ __forceinline__ uint32_t payload_word(const void* __restrict__ g,
                                                 int64_t at, int p) {
  if constexpr (kBf16) {
    const uint16_t* gb = static_cast<const uint16_t*>(g) + at + 2 * p;
    if constexpr (C == 1) {
      return (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(gb))
             << 16;
    } else {
      const uint32_t v = __ldg(reinterpret_cast<const unsigned int*>(gb));
      return (v << 16) | (v >> 16);  // little endian: channel 2p is low
    }
  } else {
    const float* gf = static_cast<const float*>(g) + at + 2 * p;
    if constexpr (C == 1) {
      return __float_as_uint(__ldg(gf)) & 0xffff0000u;
    } else {
      const float2 v = __ldg(reinterpret_cast<const float2*>(gf));
      return (__float_as_uint(v.x) & 0xffff0000u) | (__float_as_uint(v.y) >> 16);
    }
  }
}

// Flat mode: row b of the flat gradient out [n_rows * C] gets
// __fadd_rn(G0[b], G1[a]) where the finished key before b is a = b - 1;
// otherwise row a + 1 gets __fadd_rn(+0, G1[a]) and row b
// __fadd_rn(G0[b], +0). Rows outside [0, n_rows) are dropped, and a dropped
// key passes no G1 on. Lane c < C holds channel c of both halves.
__device__ __forceinline__ void write_pair(float* __restrict__ out,
                                           int n_rows, int C, int lane,
                                           bool has_a, int a, float g1a,
                                           bool has_b, int b, float g0b) {
  if (lane >= C) return;
  const bool a_in = has_a && a >= 0 && a < n_rows;
  const bool adj = has_a && has_b && (int64_t)b == (int64_t)a + 1;
  if (has_b && b >= 0 && b < n_rows) {
    out[(int64_t)b * C + lane] = __fadd_rn(g0b, adj && a_in ? g1a : 0.0f);
  }
  if (a_in && !adj && a + 1 < n_rows) {
    out[((int64_t)a + 1) * C + lane] = __fadd_rn(0.0f, g1a);
  }
}

// The flat mode's per-chunk slots (laid out by edges_of): meta
// [n_chunks, 4] i32 = (has a plain segment, first plain key, last plain
// key, last chunk of the row that starts here and crosses); plain
// [n_chunks, 2C] = (G0 of the first plain segment | G1 of the last);
// cross [n_chunks, 2C] = the complete total of the crossing row.
enum Meta { kHasPlain = 0, kFirstKey = 1, kLastKey = 2, kRowEnd = 3 };

template <int C, bool kFlat, bool kBf16>
__global__ void __launch_bounds__(kWarps * 32)
segsum_outer_kernel(const int32_t* __restrict__ keys,
                    const int32_t* __restrict__ perm,
                    const uint32_t* __restrict__ w_word,
                    const void* __restrict__ g, int64_t g_stride, int g_col,
                    float* __restrict__ out, float* __restrict__ head,
                    float* __restrict__ tail, float* __restrict__ plain,
                    int32_t* __restrict__ meta, int M, int B, int n_rows) {
  constexpr int kNW = (C + 1) / 2;         // g words per point
  constexpr int kCh = 2 * C;               // output channels per row
  constexpr int kPerLane = (kCh + 31) / 32;
  __shared__ uint32_t sg[kWarps][32 * kNW];

  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int64_t chunk_id = (int64_t)blockIdx.x * kWarps + wib;
  if (chunk_id * kChunk >= M) return;      // whole warp leaves together
  const segments::Chunk chunk = segments::chunk_of(keys, M, chunk_id);
  const int s0 = chunk.s0, end = chunk.end;

  // what each lane's channels read: the half of the w-word and the word
  // and half of the point's g row
  bool w_hi[kPerLane], g_hi[kPerLane];
  int g_word[kPerLane];
#pragma unroll
  for (int s = 0; s < kPerLane; ++s) {
    const int ch = lane + 32 * s;
    const int c = ch < C ? ch : ch - C;
    w_hi[s] = ch < C;
    g_word[s] = (c < C ? c : 0) >> 1;
    g_hi[s] = (c & 1) == 0;
  }

  float acc[kPerLane];
#pragma unroll
  for (int s = 0; s < kPerLane; ++s) acc[s] = 0.0f;
  int cur = keys[s0];
  bool in_first = true;
  uint32_t* stage = sg[wib];

  // the finished segment `cur`: its head / tail partial, its 2C totals
  // (the 2C mode), or (the flat mode) the rows of its pair with the
  // previous plain segment of this chunk, whose key and G1 stay here
  bool has_prev = false;
  int prev_key = 0;
  float prev_g1 = 0.0f;
  auto finish = [&](bool is_last) {
    const int which = segments::role(chunk, in_first, is_last);
    if (!kFlat || which != segments::kPlain) {
      segments::store<kPerLane>(out, head, tail, chunk, which, cur, n_rows,
                                kCh, acc, lane);
      return;
    }
    if constexpr (kFlat) {
      const float g0 = acc[0];
      float g1;
      if constexpr (kPerLane == 2) {
        g1 = acc[1];
      } else {
        g1 = __shfl_sync(kFull, acc[0], (lane + C) & 31);
      }
      if (has_prev) {
        write_pair(out, n_rows, C, lane, true, prev_key, prev_g1, true, cur,
                   g0);
      } else if (chunk.w == 0) {           // the stream's first key
        write_pair(out, n_rows, C, lane, false, 0, 0.0f, true, cur, g0);
      } else {                             // the join pairs it
        if (lane < C) plain[chunk.w * kCh + lane] = g0;
        if (lane == 0) meta[chunk.w * 4 + kFirstKey] = cur;
      }
      has_prev = true;
      prev_key = cur;
      prev_g1 = g1;
    }
  };

  for (int base = s0; base < end; base += 32) {
    const int n = min(32, end - base);
    const int i = base + lane;
    int k = -1, b = 0;
    uint32_t ww = 0;
    if (lane < n) {
      k = keys[i];
      const uint32_t p = (uint32_t)perm[i];
      ww = w_word[p];
      b = (int)(p % (uint32_t)B);
    }
    // stage the g words of these 32 points: word t is word t % kNW of the
    // point of record t / kNW
#pragma unroll
    for (int t = lane; t < 32 * kNW; t += 32) {
      const int r = t / kNW;
      const int br = __shfl_sync(kFull, b, r);
      stage[t] = r < n ? payload_word<C, kBf16>(
                             g, (int64_t)br * g_stride + g_col, t % kNW)
                       : 0u;
    }
    __syncwarp();
    for (int j = 0; j < n; ++j) {
      const int kj = __shfl_sync(kFull, k, j);
      const uint32_t wj = __shfl_sync(kFull, ww, j);
      if (kj != cur) {
        finish(false);
        in_first = false;
        cur = kj;
#pragma unroll
        for (int s = 0; s < kPerLane; ++s) acc[s] = 0.0f;
      }
      const uint32_t* grow = stage + j * kNW;
#pragma unroll
      for (int s = 0; s < kPerLane; ++s) {
        if (lane + 32 * s < kCh) {
          const uint32_t gw = grow[g_word[s]];
          const float g = g_hi[s] ? hi_bf16(gw) : lo_bf16(gw);
          const float w = w_hi[s] ? hi_bf16(wj) : lo_bf16(wj);
          acc[s] += __bfloat162float(__float2bfloat16_rn(__fmul_rn(w, g)));
        }
      }
    }
    __syncwarp();
  }
  finish(true);
  if constexpr (kFlat) {
    if (lane < C && has_prev) plain[chunk.w * kCh + C + lane] = prev_g1;
    if (lane == 0) {
      meta[chunk.w * 4 + kHasPlain] = has_prev;
      meta[chunk.w * 4 + kLastKey] = prev_key;
    }
  }
}

// The flat mode's walk below 32 channels (C <= kWalkMaxC): the lanes of a
// warp over chunks and channels. A warp owns kChunks = 32 / C consecutive
// chunks and a group of C lanes each; lane c of a group holds channel c of
// both halves (G0 = sum w0 g_c, G1 = sum w1 g_c), so every lane sums and
// no shuffle moves G1 onto the lanes that write. Each group walks its
// chunk exactly as a warp of segsum_outer_kernel walks one: the same
// records in the same order, the same head / tail / plain / meta slots;
// so every f32 addition and every slot is that kernel's, bit for bit.
// Per kSub records of each of its chunks the warp stages keys, w-words
// and g words in shared memory with coalesced loads (item t = lane + 32 u
// is record t % kSub of chunk t / kSub), every gather of the sub-chunk
// issued before the first add; a group then reads its records there, a
// broadcast within the group, the groups' reads of one record index in
// distinct banks (the rows' strides below).
template <int C>
struct Walk {
  static constexpr int kChunks = 32 / C;               // chunks a warp
  static constexpr int kSub = 256 / kChunks < 32 ? 256 / kChunks : 32;
  static constexpr int kNW = (C + 1) / 2;               // g words a point
  static constexpr int kPerLane = kChunks * kSub / 32;  // items a lane
  static constexpr int kKeyStride = kSub + 1;           // odd
  static constexpr int kGStride = kSub * kNW + kNW;     // = kNW mod 32
  static constexpr int kWords = kChunks * (2 * kKeyStride + kGStride);
};

constexpr int kWalkWarps = 4;               // warps per block of the walk
constexpr int kWalkMaxC = 16;               // widths the walk takes

template <int C, bool kBf16>
__global__ void __launch_bounds__(kWalkWarps * 32)
segsum_flat_walk_kernel(const int32_t* __restrict__ keys,
                        const int32_t* __restrict__ perm,
                        const uint32_t* __restrict__ w_word,
                        const void* __restrict__ g, int64_t g_stride,
                        int g_col, float* __restrict__ out,
                        float* __restrict__ head, float* __restrict__ tail,
                        float* __restrict__ plain,
                        int32_t* __restrict__ meta, int M, int B,
                        int n_rows) {
  using W = Walk<C>;
  constexpr int kCh = 2 * C;
  __shared__ uint32_t smem[kWalkWarps][W::kWords];

  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int64_t first =                      // the warp's first chunk
      ((int64_t)blockIdx.x * kWalkWarps + wib) * W::kChunks;
  if (first * kChunk >= M) return;           // whole warp leaves together
  int32_t* sk = reinterpret_cast<int32_t*>(smem[wib]);
  uint32_t* sw = smem[wib] + W::kChunks * W::kKeyStride;
  uint32_t* sg = sw + W::kChunks * W::kKeyStride;

  const int q = lane / C, c = lane % C;      // the lane's chunk, channel
  const bool active = (first + q) * kChunk < M;
  segments::Chunk chunk;
  if (active) {
    chunk = segments::chunk_of(keys, M, first + q);
  } else {
    chunk.w = first + q;
    chunk.s0 = chunk.end = M;
    chunk.first_shared = chunk.last_shared = false;
  }
  float g0 = 0.0f, g1 = 0.0f;
  int cur = active ? keys[chunk.s0] : 0;
  bool in_first = true;

  // the finished segment `cur`: its head / tail partial, or the rows of
  // its pair with the previous plain segment of this chunk, whose key and
  // G1 stay here (segsum_outer_kernel's finish, one group a chunk)
  bool has_prev = false;
  int prev_key = 0;
  float prev_g1 = 0.0f;
  auto finish = [&](bool is_last) {
    const int which = segments::role(chunk, in_first, is_last);
    if (which != segments::kPlain) {
      float* dst = (which == segments::kHead ? head : tail) + chunk.w * kCh;
      dst[c] = g0;
      dst[C + c] = g1;
      return;
    }
    if (has_prev) {
      write_pair(out, n_rows, C, c, true, prev_key, prev_g1, true, cur, g0);
    } else if (chunk.w == 0) {               // the stream's first key
      write_pair(out, n_rows, C, c, false, 0, 0.0f, true, cur, g0);
    } else {                                 // the join pairs it
      plain[chunk.w * kCh + c] = g0;
      if (c == 0) meta[chunk.w * 4 + kFirstKey] = cur;
    }
    has_prev = true;
    prev_key = cur;
    prev_g1 = g1;
  };
  auto step = [&](int j) {
    const int kj = sk[q * W::kKeyStride + j];
    const uint32_t wj = sw[q * W::kKeyStride + j];
    if (kj != cur) {
      finish(false);
      in_first = false;
      cur = kj;
      g0 = 0.0f;
      g1 = 0.0f;
    }
    const uint32_t gw = sg[q * W::kGStride + j * W::kNW + (c >> 1)];
    const float gv = (c & 1) ? lo_bf16(gw) : hi_bf16(gw);
    g0 += __bfloat162float(__float2bfloat16_rn(__fmul_rn(hi_bf16(wj), gv)));
    g1 += __bfloat162float(__float2bfloat16_rn(__fmul_rn(lo_bf16(wj), gv)));
  };

  const int64_t base = first * kChunk;       // the warp's first record
  for (int sub = 0; sub < kChunk; sub += W::kSub) {
    int kk[W::kPerLane];
    uint32_t pp[W::kPerLane];
#pragma unroll
    for (int u = 0; u < W::kPerLane; ++u) {
      const int t = lane + 32 * u;
      const int64_t i =
          base + (int64_t)(t / W::kSub) * kChunk + sub + t % W::kSub;
      kk[u] = i < M ? keys[i] : 0;
      pp[u] = i < M ? (uint32_t)perm[i] : 0xffffffffu;
    }
    uint32_t ww[W::kPerLane], gw[W::kPerLane][W::kNW];
#pragma unroll
    for (int u = 0; u < W::kPerLane; ++u) {
      const bool ok = pp[u] != 0xffffffffu;
      ww[u] = ok ? w_word[pp[u]] : 0u;
      const int64_t at = (int64_t)(ok ? pp[u] % (uint32_t)B : 0u) * g_stride
                         + g_col;
#pragma unroll
      for (int p = 0; p < W::kNW; ++p) {
        gw[u][p] = ok ? payload_word<C, kBf16>(g, at, p) : 0u;
      }
    }
#pragma unroll
    for (int u = 0; u < W::kPerLane; ++u) {
      const int t = lane + 32 * u;
      const int r = t / W::kSub, j = t % W::kSub;
      sk[r * W::kKeyStride + j] = kk[u];
      sw[r * W::kKeyStride + j] = ww[u];
#pragma unroll
      for (int p = 0; p < W::kNW; ++p) {
        sg[r * W::kGStride + j * W::kNW + p] = gw[u][p];
      }
    }
    __syncwarp();
    const int n = min(W::kSub, chunk.end - (chunk.s0 + sub));
    if (n == W::kSub) {
#pragma unroll 4
      for (int j = 0; j < W::kSub; ++j) step(j);
    } else {
      for (int j = 0; j < n; ++j) step(j);
    }
    __syncwarp();
  }
  if (!active) return;
  finish(true);
  if (has_prev) plain[chunk.w * kCh + C + c] = prev_g1;
  if (c == 0) {
    meta[chunk.w * 4 + kHasPlain] = has_prev;
    meta[chunk.w * 4 + kLastKey] = prev_key;
  }
}

// the sums of the chunk groups that lie inside one row
// (segments::group_sum), one warp a group
template <int kPerLane>
__global__ void __launch_bounds__(kWarps * 32)
segsum_edge_group_kernel(const int32_t* __restrict__ keys,
                         const float* __restrict__ head,
                         float* __restrict__ group, int M, int width) {
  segments::group_sum<kPerLane>(
      keys, M, head, group, width,
      (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5), threadIdx.x & 31);
}

// adds each row that crosses chunks from its edge partials, in chunk
// order (segments::fixup_chain), one warp a chunk
template <int kPerLane>
__global__ void __launch_bounds__(kWarps * 32)
segsum_edge_fixup_kernel(const int32_t* __restrict__ keys,
                         const float* __restrict__ head,
                         const float* __restrict__ tail,
                         const float* __restrict__ group,
                         float* __restrict__ out, int M, int n_rows,
                         int width) {
  segments::fixup_chain<kPerLane>(
      keys, M, head, tail, group, out, n_rows, width,
      (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5), threadIdx.x & 31);
}

// The flat mode's fix-up, a group of C lanes a chunk w (32 / C chunks a
// warp; lane c holds channels c and C + c): where a row starts in w and
// crosses (segments::crossing_row), its total and last chunk go to w's
// cross and meta slots, for the join. A row that ends in chunk w + 1 (the
// chunk after it does not start with the row) totals tail[w] + head[w +
// 1], the one addition segments::row_total makes for it, in the group; a
// longer one the whole warp adds afterwards, one row at a time, by
// row_total itself. So each total is the 2C mode's fix-up's, bit for bit,
// and a warp tests 32 / C chunks.
template <int C>
__global__ void __launch_bounds__(kWarps * 32)
segsum_flat_fixup_kernel(const int32_t* __restrict__ keys,
                         const float* __restrict__ head,
                         const float* __restrict__ tail,
                         const float* __restrict__ group,
                         float* __restrict__ cross,
                         int32_t* __restrict__ meta, int M) {
  constexpr int kChunks = 32 / C;               // chunks a warp
  constexpr int width = 2 * C;
  constexpr int kPerLane = (width + 31) / 32;
  const int lane = threadIdx.x & 31;
  const int64_t w =
      ((int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5)) * kChunks
      + lane / C;
  const int c = lane % C;
  int r = 0;
  const bool starts = segments::crossing_row(keys, M, w, &r);
  const int64_t after = (w + 2) * kChunk;        // the chunk after w + 1
  const bool longer = starts && after < M && keys[after] == r;
  if (starts && !longer) {
    const float* t = tail + w * width;
    const float* h = head + (w + 1) * width;
    cross[w * width + c] = __fadd_rn(t[c], h[c]);
    cross[w * width + C + c] = __fadd_rn(t[C + c], h[C + c]);
    if (c == 0) meta[w * 4 + kRowEnd] = (int32_t)(w + 1);
  }
  for (unsigned mask = __ballot_sync(kFull, longer && c == 0); mask;
       mask &= mask - 1) {
    const int src = __ffs(mask) - 1;
    const int64_t wl = __shfl_sync(kFull, w, src);
    const int rl = __shfl_sync(kFull, r, src);
    float acc[kPerLane];
    const int64_t last = segments::row_total<kPerLane>(
        keys, M, head, tail, group, width, wl, rl, lane, acc);
#pragma unroll
    for (int s = 0; s < kPerLane; ++s) {
      const int ch = lane + 32 * s;
      if (ch < width) cross[wl * width + ch] = acc[s];
    }
    if (lane == 0) meta[wl * 4 + kRowEnd] = (int32_t)last;
  }
}

// The flat mode's join, a group of C lanes a chunk w (32 / C chunks a
// warp; lane c of a group writes channel c): the pairs of finished keys
// that are not two plain segments of one chunk. Chunk w's last finished
// key a is the row that starts in w and crosses, else w's last plain
// segment; its successor b is the first finished key of the chunk where
// a ends (w + 1 for a plain segment, the row's last chunk for a crossing
// row), or of the chunk after that when a's row fills its last chunk to
// the end. A crossing row also pairs with w's last plain segment before
// it, and is the stream's first key when chunk 0 has no plain segment.
template <int C>
__global__ void __launch_bounds__(kWarps * 32)
segsum_flat_join_kernel(const int32_t* __restrict__ keys,
                        const float* __restrict__ plain,
                        const float* __restrict__ cross,
                        const int32_t* __restrict__ meta,
                        float* __restrict__ out, int M, int n_rows) {
  constexpr int kChunks = 32 / C;               // chunks a warp
  const int lane = threadIdx.x & 31;
  const int64_t w =
      ((int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5)) * kChunks
      + lane / C;
  const int c = lane % C;
  const int64_t n = ((int64_t)M + kChunk - 1) / kChunk;
  if (w >= n) return;
  constexpr int width = 2 * C;
  const bool has_plain = meta[w * 4 + kHasPlain] != 0;
  int a;
  float g1a;
  int64_t next;
  if (segments::crossing_row(keys, M, w, &a)) {
    const float* total = cross + w * width;
    if (has_plain) {
      write_pair(out, n_rows, C, c, true, meta[w * 4 + kLastKey],
                 plain[w * width + C + c], true, a, total[c]);
    } else if (w == 0) {
      write_pair(out, n_rows, C, c, false, 0, 0.0f, true, a, total[c]);
    }
    g1a = total[C + c];
    next = meta[w * 4 + kRowEnd];
  } else if (has_plain) {
    a = meta[w * 4 + kLastKey];
    g1a = plain[w * width + C + c];
    next = w + 1;
  } else {
    return;                 // a middle chunk, or one holding only a head
  }
  bool has_b = false;
  int b = 0;
  float g0b = 0.0f;
  for (int64_t q = next; q < n && q <= next + 1 && !has_b; ++q) {
    if (meta[q * 4 + kHasPlain]) {
      has_b = true;
      b = meta[q * 4 + kFirstKey];
      g0b = plain[q * width + c];
    } else if (segments::crossing_row(keys, M, q, &b)) {
      has_b = true;
      g0b = cross[q * width + c];
    }
  }
  write_pair(out, n_rows, C, c, true, a, g1a, has_b, b, g0b);
}

unsigned blocks_for(int64_t warps) {
  return (unsigned)((warps + kWarps - 1) / kWarps);
}

int64_t chunks_of(int M) { return ((int64_t)M + kChunk - 1) / kChunk; }

// The scratch `edges` of a stream with n_edge chunk slots, rows of
// `width` f32: head, tail, group sums; then, in the flat mode, plain and
// cross rows and the meta words (segsum.py flat_edge_buffer).
struct Edges {
  float *head, *tail, *group, *plain, *cross;
  int32_t* meta;
};

Edges edges_of(float* edges, int64_t n_edge, int width) {
  Edges e;
  e.head = edges;
  e.tail = e.head + n_edge * width;
  e.group = e.tail + n_edge * width;
  e.plain = e.group
            + (n_edge + segments::kGroup - 1) / segments::kGroup * width;
  e.cross = e.plain + n_edge * width;
  e.meta = reinterpret_cast<int32_t*>(e.cross + n_edge * width);
  return e;
}

// the group sums of a stream whose main kernel has run
template <int kPerLane>
cudaError_t group_sums(const int32_t* keys, const Edges& e, int M, int width,
                       cudaStream_t s) {
  const int64_t n_groups =
      (chunks_of(M) + segments::kGroup - 1) / segments::kGroup;
  segsum_edge_group_kernel<kPerLane><<<blocks_for(n_groups), kWarps * 32, 0,
                                       s>>>(keys, e.head, e.group, M, width);
  return cudaGetLastError();
}

// the group sums and the fix-up of a stream of rows of `width` whose main
// kernel has run (the 2C and channel modes)
template <int kPerLane>
cudaError_t finish_rows(const int32_t* keys, const Edges& e, float* out,
                        int M, int n_rows, int width, cudaStream_t s) {
  cudaError_t err = group_sums<kPerLane>(keys, e, M, width, s);
  if (err != cudaSuccess) return err;
  segsum_edge_fixup_kernel<kPerLane>
      <<<blocks_for(chunks_of(M)), kWarps * 32, 0, s>>>(
          keys, e.head, e.tail, e.group, out, M, n_rows, width);
  return cudaGetLastError();
}

template <int C, bool kFlat>
cudaError_t launch(const int32_t* keys, const int32_t* perm,
                   const uint32_t* w_word, const void* g, int64_t g_stride,
                   int g_col, bool g_bf16, float* out, float* edges, int M,
                   int B, int n_rows, int64_t n_edge, cudaStream_t s) {
  const Edges e = edges_of(edges, n_edge, 2 * C);
  const int64_t n_chunks = chunks_of(M);
  if constexpr (kFlat && C <= kWalkMaxC) {
    const int64_t warps = (n_chunks + Walk<C>::kChunks - 1) / Walk<C>::kChunks;
    const unsigned blocks = (unsigned)((warps + kWalkWarps - 1) / kWalkWarps);
    if (g_bf16) {
      segsum_flat_walk_kernel<C, true><<<blocks, kWalkWarps * 32, 0, s>>>(
          keys, perm, w_word, g, g_stride, g_col, out, e.head, e.tail,
          e.plain, e.meta, M, B, n_rows);
    } else {
      segsum_flat_walk_kernel<C, false><<<blocks, kWalkWarps * 32, 0, s>>>(
          keys, perm, w_word, g, g_stride, g_col, out, e.head, e.tail,
          e.plain, e.meta, M, B, n_rows);
    }
  } else if (g_bf16) {
    segsum_outer_kernel<C, kFlat, true>
        <<<blocks_for(n_chunks), kWarps * 32, 0, s>>>(
            keys, perm, w_word, g, g_stride, g_col, out, e.head, e.tail,
            e.plain, e.meta, M, B, n_rows);
  } else {
    segsum_outer_kernel<C, kFlat, false>
        <<<blocks_for(n_chunks), kWarps * 32, 0, s>>>(
            keys, perm, w_word, g, g_stride, g_col, out, e.head, e.tail,
            e.plain, e.meta, M, B, n_rows);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int kPerLane = (2 * C + 31) / 32;
  if constexpr (!kFlat) {
    return finish_rows<kPerLane>(keys, e, out, M, n_rows, 2 * C, s);
  }
  err = group_sums<kPerLane>(keys, e, M, 2 * C, s);
  if (err != cudaSuccess) return err;
  // the flat fix-up and join: a group of C lanes a chunk
  constexpr int kGroupChunks = 32 / C;
  const unsigned blocks = blocks_for(
      (n_chunks + kGroupChunks - 1) / kGroupChunks);
  segsum_flat_fixup_kernel<C><<<blocks, kWarps * 32, 0, s>>>(
      keys, e.head, e.tail, e.group, e.cross, e.meta, M);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  segsum_flat_join_kernel<C><<<blocks, kWarps * 32, 0, s>>>(
      keys, e.plain, e.cross, e.meta, out, M, n_rows);
  return cudaGetLastError();
}

constexpr int kMaxChan = 64;                // two channels a lane

__global__ void __launch_bounds__(kWarps * 32)
segsum_channel_kernel(const int32_t* __restrict__ keys,
                      const uint32_t* __restrict__ packed,
                      float* __restrict__ out, float* __restrict__ head,
                      float* __restrict__ tail, int M, int n_rows,
                      int n_chan) {
  constexpr int kPerLane = kMaxChan / 32;
  const int n_words = (n_chan + 1) / 2;
  // record-major staging, padded so that both the per-word writes and
  // the per-record reads of neighbouring words hit distinct banks
  __shared__ uint32_t sw[kWarps][32][kMaxChan / 2 + 1];

  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int64_t chunk_id = (int64_t)blockIdx.x * kWarps + wib;
  if (chunk_id * kChunk >= M) return;      // whole warp leaves together
  const segments::Chunk chunk = segments::chunk_of(keys, M, chunk_id);
  const int s0 = chunk.s0, end = chunk.end;

  float acc[kPerLane];
#pragma unroll
  for (int s = 0; s < kPerLane; ++s) acc[s] = 0.0f;
  int cur = keys[s0];
  bool in_first = true;

  for (int base = s0; base < end; base += 32) {
    const int n = min(32, end - base);
    const int i = base + lane;
    const int k = lane < n ? keys[i] : -1;
    for (int wd = 0; wd < n_words; ++wd) {
      sw[wib][lane][wd] = lane < n ? packed[(int64_t)wd * M + i] : 0u;
    }
    __syncwarp();
    for (int j = 0; j < n; ++j) {
      const int kj = __shfl_sync(kFull, k, j);
      if (kj != cur) {
        segments::store<kPerLane>(out, head, tail, chunk,
                                  segments::role(chunk, in_first, false), cur,
                                  n_rows, n_chan, acc, lane);
        in_first = false;
        cur = kj;
#pragma unroll
        for (int s = 0; s < kPerLane; ++s) acc[s] = 0.0f;
      }
#pragma unroll
      for (int s = 0; s < kPerLane; ++s) {
        const int c = lane + 32 * s;
        if (c < n_chan) {
          const uint32_t word = sw[wib][j][c >> 1];
          acc[s] += (c & 1) ? lo_bf16(word) : hi_bf16(word);
        }
      }
    }
    __syncwarp();
  }
  segments::store<kPerLane>(out, head, tail, chunk,
                            segments::role(chunk, in_first, true), cur, n_rows,
                            n_chan, acc, lane);
}

template <bool kFlat>
int launch_outer(const int32_t* keys, const int32_t* perm,
                 const uint32_t* w_word, const void* g, int64_t g_stride,
                 int g_col, int g_bf16, float* out, float* edges, int M, int B,
                 int C, int n_rows, int n_edge, void* stream) {
  if (n_edge < chunks_of(M)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (C) {
#define RAW_NGP_CASE(c)                                                     \
    case c:                                                                 \
      err = launch<c, kFlat>(keys, perm, w_word, g, g_stride, g_col,       \
                             g_bf16 != 0, out, edges, M, B, n_rows, n_edge, \
                             s);                                            \
      break;
    RAW_NGP_CASE(1) RAW_NGP_CASE(2) RAW_NGP_CASE(4) RAW_NGP_CASE(8)
    RAW_NGP_CASE(16) RAW_NGP_CASE(32)
#undef RAW_NGP_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // namespace

// keys [M] i32 ascending, packed [ceil(n_chan/2), M] u32 -> out
// [n_rows, n_chan] f32, which the caller has zeroed (M > 0, 0 < n_chan <=
// 64); edges is scratch of segments::edge_rows(n_edge) rows of n_chan f32
// with n_edge >= ceil(M / 128). Returns the first CUDA error, else
// cudaGetLastError(), or cudaErrorInvalidValue for n_chan or n_edge out of
// range.
extern "C" int segment_totals_fwd(const int32_t* keys, const uint32_t* packed,
                                  float* out, float* edges, int M, int n_chan,
                                  int n_rows, int n_edge, void* stream) {
  if (n_chan <= 0 || n_chan > kMaxChan || n_edge < chunks_of(M)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Edges e = edges_of(edges, n_edge, n_chan);
  segsum_channel_kernel<<<blocks_for(chunks_of(M)), kWarps * 32, 0, s>>>(
      keys, packed, out, e.head, e.tail, M, n_rows, n_chan);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(finish_rows<kMaxChan / 32>(keys, e, out, M,
                                                     n_rows, n_chan, s));
}

// keys [M] i32 ascending, perm [M] i32, w_word [*] u32, g [B, g_stride]
// (bf16 if g_bf16, else f32; the level's C channels from column g_col;
// for C >= 2 g_col and g_stride even and g 4- (bf16) or 8-byte (f32)
// aligned) -> out [n_rows, 2C] f32, which the caller has zeroed (M > 0,
// B > 0); edges is scratch of segments::edge_rows(n_edge) rows of 2C f32
// with n_edge >= ceil(M / 128). Returns the first CUDA error, else
// cudaGetLastError(), or cudaErrorInvalidValue for an unsupported C or too
// few edge rows.
extern "C" int segment_totals_outer_fwd(const int32_t* keys,
                                        const int32_t* perm,
                                        const uint32_t* w_word, const void* g,
                                        int64_t g_stride, int g_col,
                                        int g_bf16, float* out, float* edges,
                                        int M, int B, int C, int n_rows,
                                        int n_edge, void* stream) {
  return launch_outer<false>(keys, perm, w_word, g, g_stride, g_col, g_bf16,
                             out, edges, M, B, C, n_rows, n_edge, stream);
}

// The flat mode, on the same stream: out [n_rows * C] f32, which the
// caller has zeroed, gets row r = G0[r] + G1[r - 1] (see write_pair);
// edges is f32 scratch of (4 n_edge + ceil(n_edge / 32)) rows of 2C (head,
// tail, group sums, plain, cross) followed by 4 n_edge i32 meta words.
// Returns as segment_totals_outer_fwd.
extern "C" int segment_grad_outer_fwd(const int32_t* keys,
                                      const int32_t* perm,
                                      const uint32_t* w_word, const void* g,
                                      int64_t g_stride, int g_col, int g_bf16,
                                      float* out, float* edges, int M, int B,
                                      int C, int n_rows, int n_edge,
                                      void* stream) {
  return launch_outer<true>(keys, perm, w_word, g, g_stride, g_col, g_bf16,
                            out, edges, M, B, C, n_rows, n_edge, stream);
}
