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
// (w0, w1) word of record perm[i] and the g words of point perm[i] % B,
// so the sort moves one key column instead of the C/2 g-words per record.
//
// Design. One warp owns a chunk of segments::kChunk (128) consecutive
// sorted records; its lanes are output channels (2C of them, two per
// lane when 2C = 64). The warp walks its records in order and keeps each
// lane's running total in a register; when the key changes it stores the
// finished row with a plain 128-byte store. So a segment that holds most
// of the stream (a dense level funnels ~1M records into 4,096 rows) costs
// each warp it spans one register sum, not a serial chain on one thread.
// Only a chunk's first and last segment can continue into a neighbouring
// chunk: those partials go to the chunk's head / tail slot of an edge
// buffer, and a second launch adds each crossing row's partials in chunk
// order and stores it once (csrc/segments.cuh; no float atomic). Per 32
// records, the lanes load the keys, permutation and w-words in one
// coalesced pass, then stage the 32 points' g rows in shared memory (8
// lanes read one point's 32 bytes), so every global load of a sub-chunk
// is issued before any is consumed.
//
// Bound: bytes. Per record the kernel reads the key, the permutation and
// one w-word (12 B) and one point's g row (C/2 words; cached, at most B
// distinct rows); it writes each touched row of 2C f32 once, and the
// wrapper's zero fill writes the whole [n_rows, 2C] output once. At the
// flagship's level 1 (1,048,576 records, 262,144 points, C = 16, 524,288
// rows) that is about 12.6 + 8.4 + 67 MB. The work is 4C flops a record.
// The edge partials add at most two rows of 2C f32 a chunk (2 MB at level
// 1, written once and read once), and two small launches: the group sums
// and the fix-up, which reads two or three keys a chunk. The skew
// streams' row of ~940k records spans some 7,300 chunks: 230 group sums
// of 32 chunks each, which its fix-up warp adds 32 at a time.

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

template <int C>
__global__ void __launch_bounds__(kWarps * 32)
segsum_outer_kernel(const int32_t* __restrict__ keys,
                    const int32_t* __restrict__ perm,
                    const uint32_t* __restrict__ w_word,
                    const uint32_t* __restrict__ g_words,
                    float* __restrict__ out, float* __restrict__ head,
                    float* __restrict__ tail, int M, int B, int n_rows) {
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
    // stage the g rows of these 32 points: word t is word t % kNW of the
    // point of record t / kNW
#pragma unroll
    for (int t = lane; t < 32 * kNW; t += 32) {
      const int r = t / kNW;
      const int br = __shfl_sync(kFull, b, r);
      stage[t] = r < n ? __ldg(g_words + (int64_t)br * kNW + (t % kNW)) : 0u;
    }
    __syncwarp();
    for (int j = 0; j < n; ++j) {
      const int kj = __shfl_sync(kFull, k, j);
      const uint32_t wj = __shfl_sync(kFull, ww, j);
      if (kj != cur) {
        segments::store<kPerLane>(out, head, tail, chunk,
                                  segments::role(chunk, in_first, false), cur,
                                  n_rows, kCh, acc, lane);
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
  segments::store<kPerLane>(out, head, tail, chunk,
                            segments::role(chunk, in_first, true), cur, n_rows,
                            kCh, acc, lane);
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

unsigned blocks_for(int64_t warps) {
  return (unsigned)((warps + kWarps - 1) / kWarps);
}

int64_t chunks_of(int M) { return ((int64_t)M + kChunk - 1) / kChunk; }

// the group sums and the fix-up of a stream whose main kernel has run;
// edges holds head, tail and group rows of `width` (n_edge chunk slots)
template <int kPerLane>
cudaError_t finish_rows(const int32_t* keys, float* edges, float* out,
                        int M, int n_rows, int width, int64_t n_edge,
                        cudaStream_t s) {
  float* head = edges;
  float* tail = edges + n_edge * width;
  float* group = edges + 2 * n_edge * width;
  const int64_t n_chunks = chunks_of(M);
  segsum_edge_group_kernel<kPerLane>
      <<<blocks_for((n_chunks + segments::kGroup - 1) / segments::kGroup),
         kWarps * 32, 0, s>>>(keys, head, group, M, width);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  segsum_edge_fixup_kernel<kPerLane><<<blocks_for(n_chunks), kWarps * 32, 0,
                                       s>>>(keys, head, tail, group, out, M,
                                            n_rows, width);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch(const int32_t* keys, const int32_t* perm,
                   const uint32_t* w_word, const uint32_t* g_words,
                   float* out, float* edges, int M, int B, int n_rows,
                   int64_t n_edge, cudaStream_t s) {
  segsum_outer_kernel<C><<<blocks_for(chunks_of(M)), kWarps * 32, 0, s>>>(
      keys, perm, w_word, g_words, out, edges, edges + n_edge * 2 * C, M, B,
      n_rows);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return finish_rows<(2 * C + 31) / 32>(keys, edges, out, M, n_rows, 2 * C,
                                        n_edge, s);
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
  segsum_channel_kernel<<<blocks_for(chunks_of(M)), kWarps * 32, 0, s>>>(
      keys, packed, out, edges, edges + (int64_t)n_edge * n_chan, M, n_rows,
      n_chan);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(finish_rows<kMaxChan / 32>(keys, edges, out, M,
                                                      n_rows, n_chan, n_edge,
                                                      s));
}

// keys [M] i32 ascending, perm [M] i32, w_word [*] u32, g_words [B, (C+1)/2]
// u32 -> out [n_rows, 2C] f32, which the caller has zeroed (M > 0, B > 0);
// edges is scratch of segments::edge_rows(n_edge) rows of 2C f32 with
// n_edge >= ceil(M / 128). Returns the first CUDA error, else
// cudaGetLastError(), or cudaErrorInvalidValue for an unsupported C or too
// few edge rows.
extern "C" int segment_totals_outer_fwd(const int32_t* keys,
                                        const int32_t* perm,
                                        const uint32_t* w_word,
                                        const uint32_t* g_words, float* out,
                                        float* edges, int M, int B, int C,
                                        int n_rows, int n_edge,
                                        void* stream) {
  if (n_edge < chunks_of(M)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (C) {
#define RAW_NGP_CASE(c)                                                     \
    case c:                                                                 \
      err = launch<c>(keys, perm, w_word, g_words, out, edges, M, B, n_rows, \
                      n_edge, s);                                           \
      break;
    RAW_NGP_CASE(1) RAW_NGP_CASE(2) RAW_NGP_CASE(4) RAW_NGP_CASE(8)
    RAW_NGP_CASE(16) RAW_NGP_CASE(32)
#undef RAW_NGP_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
