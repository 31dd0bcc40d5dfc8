// Table gradient of the hash-grid encode, for Hopper (sm_90a): the dense
// (matmul) levels' gradient, summed in a fixed order without atomics, and
// the two glue passes around kernel B2 on the window levels.
//
// mm_grad_table replaces hash_fused._mm_grad_table
// (raw_ngp_tpu/kernels/hash_fused.py:349-378), the transposed one-hot
// contraction grad_T2 = wyz^T @ (wx * g) of every level below
// _matmul_split. Per table entry (z, y, x, c) of such a level it computes
//
//     grad = rnd(sum_b rnd(wyz[b, yz]) * rnd(g[b, c] * rnd(wx[b, x])))
//
// under bf16 (g arrives in bf16; the product of two bf16 values is exact
// in f32, so the only freedom left is the order of the f32 sum, rounded
// once at the end) and the same without rnd in f32. A point touches 2 x
// lanes x 4 yz lanes (fewer where a corner clamps: the lane then weighs
// (1 - f) + f, as _mm_axis_weights merges it); points outside [0, 1]^3
// and NaN points add nothing; rows past res^3 of the level are 0.
//
// Why not the TPU's design: the one-hot matmul avoids gathers on the MXU,
// but on Hopper a dense wgmma of wyz^T @ Gx at B = 262,144 and res 16,
// C 16 is 34 GFLOP of which 99.8% multiply zeros (a point touches 128 of
// the level's 65,536 entries): about 35 us at the bf16 tensor-core peak,
// before the two [B, 256] operands are even built.
//
// Design: the points sorted by cell, every sum in a fixed order. A point
// of cell k (its lower corner, x + res (y + res z)) adds to the rows of
// that cell's 8 corners, so the gradient is a segmented sum over cells
// followed by a gather over rows:
//  1. cell_keys_kernel: each point's cell, res^3 for a point outside
//     [0, 1]^3 or NaN (it sorts last and adds nothing); the same launch
//     zeroes the cell sums. The wrapper sorts the keys with
//     torch.sort(stable=True), a stable radix sort and so deterministic,
//     as the window levels sort theirs.
//  2. cell_sums_kernel (pass 1): a warp owns segments::kChunk (128)
//     consecutive sorted points; its lanes hold the 8C corner sums (corner
//     i = xi + 2 yi + 4 zi, channel c) of the current cell in registers.
//     Per 32 points each lane reads the key, the permutation and the x01
//     of one point (its 2 x-lane and 4 yz-lane weights go to shared
//     memory), the lanes stage the 32 points' g rows in shared memory,
//     and the warp adds the points in sorted order with the products
//     above. A cell inside the chunk is stored into cellsum [res^3, 8, C]
//     with plain stores; a cell that crosses a chunk edge goes through the
//     edge buffers and cell_edge_fixup_kernel, which adds its partials in
//     chunk order (csrc/segments.cuh, shared with B2).
//  3. cell_gather_kernel (pass 2): grad[(x, y, z), c] = the sum over the
//     corners i = 0..7, in that order, of cellsum[(x - xi, y - yi, z - zi),
//     i, c] where that cell exists, rounded once under bf16; rows past
//     res^3 are written 0. Every entry of the level is written once, so
//     the level needs no memset and bf16 no rounding pass. A clamped upper
//     corner (at the top face without align_corners, g1 == g0 = res - 1)
//     is left out: _mm_axis_weights gives that lane weight exactly 0 and
//     the lower one (1 - f) + f, so its products are 0; the gather would
//     look for it at row res of that axis, which does not exist.
//
// Why it is order-free: the stable sort fixes the points' order inside a
// cell (ascending index), the chunks are fixed slices of the sorted
// stream, the fix-up adds a cell's partials in chunk order and the gather
// adds the 8 corners in order. No float atomic anywhere: two calls give
// the same bits, whatever the SM count or the block schedule. Against the
// plain version (one matmul) only the order of the f32 sums differs.
//
// What bounds each pass (flagship: B = 262,144, res 16, C 16, bf16 g).
// The function's bound is bytes: x01 (12 B a point), the level's slice of
// g (2C B a point) and the level's f32 gradient, 11.8 MB or 3.5 us; its
// 67 M flop take 1.0 us at the f32 peak. The design moves more:
// cell_keys reads x01 (3.1 MB), writes the keys (1 MB) and zeroes the cell
// sums (2.1 MB). Pass 1 reads the sorted keys and the int64 permutation
// (3.1 MB), then x01 and the g slice through the permutation (3.1 + 8.4
// MB, gathered by 32-byte sectors: about three sectors a point where the
// order is random), and writes the cell sums once; it issues some 30 warp
// instructions a point, so it is bound by issue and the latency of the
// gathers, not by bytes (0.025 ms on an H100 at 700 W). The group sums
// and the fix-up read three keys a chunk and the edge partials (at most
// 2 x 512 B a chunk; a cell that holds every point spans 2,048 chunks, 64
// group sums). Pass 2 reads the cell sums (2.1 MB) and writes the level
// (0.26 MB): about 0.004 ms. The sort is torch.sort of B int32 keys, a
// CUB radix sort over all 32 bits with its index iota: some 14 launches
// and 0.050 ms of device time at B = 262,144, the largest part of the
// function's time.
//
// pack_g_words writes B2's payload words: per window level, the level's C
// g-channels of every point as ceil(C/2) words of two *truncated* bf16
// halves (hash_fused._pack_bf16_pairs; exact for bf16 g, the top 16 bits
// of f32 g), [L - m, B, ceil(C/2)] int32 in one launch, replacing C
// column slices and the bit operations of pack_bf16_pairs per level.
//
// combine_totals writes the window levels' gradient from B2's totals
// [R, 2C]: grad[r] = G0[r] + G1[r - 1] (hash_fused.py:686; the first
// window row receives no G1), straight into the flat gradient, replacing
// a concatenation, an add and a copy. Both glue passes are bound by
// bytes (one read and one write of their tensors).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "segments.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
using segments::kChunk;
using segments::kFull;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool BF16>
__device__ __forceinline__ float load_g(const void* g, int64_t i) {
  if (BF16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(g)[i]);
  }
  return static_cast<const float*>(g)[i];
}

// The two lanes of each axis of one point at a dense level of resolution
// res (_mm_axis_weights): coords cl[d] and weights A[d], the upper lane
// weight 0 and the lower (1 - f) + f where the upper corner clamps onto
// the lower. Returns false for a point outside [0, 1]^3 or NaN.
__device__ __forceinline__ bool point_lanes(const float* __restrict__ x01,
                                            int64_t b, int res,
                                            int align_corners, int smoothstep,
                                            uint32_t cl[3][2], float A[3][2]) {
  float x[3];
  bool inb = true;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    x[d] = x01[b * 3 + d];
    inb = inb && (x[d] >= 0.0f) && (x[d] <= 1.0f);  // false for NaN
  }
  if (!inb) return false;
  const float top = (float)(res - 1);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float pos, gf;
    if (align_corners) {
      pos = __fmul_rn(x[d], top);
      gf = fminf(floorf(pos), (float)(res - 2));
    } else {
      pos = __fsub_rn(__fmul_rn(x[d], (float)res), 0.5f);
      pos = fminf(fmaxf(pos, 0.0f), top);
      gf = floorf(pos);
    }
    float f = __fsub_rn(pos, gf);
    if (smoothstep) {
      f = __fmul_rn(__fmul_rn(f, f), __fsub_rn(3.0f, __fmul_rn(2.0f, f)));
    }
    const uint32_t g0 = (uint32_t)(int)gf;
    const uint32_t g1 = min(g0 + 1, (uint32_t)res - 1);
    const bool present = g1 != g0;
    const float a0 = __fsub_rn(1.0f, f);
    cl[d][0] = g0;
    cl[d][1] = g1;
    A[d][0] = present ? a0 : __fadd_rn(a0, f);
    A[d][1] = present ? f : 0.0f;
  }
  return true;
}

// each point's cell (lower corner), res^3 for a point outside [0, 1]^3 or
// NaN; the same threads zero the n_zero4 float4 of the cell sums
__global__ void __launch_bounds__(kThreads)
cell_keys_kernel(const float* __restrict__ x01, int32_t* __restrict__ keys,
                 float4* __restrict__ cellsum4, int B, int res,
                 int64_t n_zero4, int align_corners, int smoothstep) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t i = t; i < n_zero4; i += (int64_t)gridDim.x * blockDim.x) {
    cellsum4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  if (t >= B) return;
  uint32_t cl[3][2];
  float A[3][2];
  keys[t] = point_lanes(x01, t, res, align_corners, smoothstep, cl, A)
                ? (int32_t)(cl[0][0] + res * (cl[1][0] + res * cl[2][0]))
                : res * res * res;
}

// pass 1: per-cell corner sums of the points sorted by cell (see the note)
template <int C, bool BF16>
__global__ void __launch_bounds__(kThreads)
cell_sums_kernel(const int32_t* __restrict__ keys,
                 const int64_t* __restrict__ perm,
                 const float* __restrict__ x01, const void* __restrict__ g,
                 float* __restrict__ cellsum, float* __restrict__ head,
                 float* __restrict__ tail, int B, int res, int64_t g_stride,
                 int g_col, int align_corners, int smoothstep) {
  constexpr int kW = 8 * C;                 // a cell's sums, corner-major
  constexpr int kPerLane = (kW + 31) / 32;
  __shared__ float sw[kWarps][32][6];       // per point: wx[2], wyz[4]
  __shared__ float sg[kWarps][32 * C];      // per point: the level's g row

  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int64_t chunk_id = (int64_t)blockIdx.x * kWarps + wib;
  if (chunk_id * kChunk >= B) return;      // whole warp leaves together
  const segments::Chunk chunk = segments::chunk_of(keys, B, chunk_id);
  const int n_cells = res * res * res;

  // the lane's sums: corner (lane + 32 s) / C of channel lane % C
  const int c = lane & (C - 1);
  int xi[kPerLane], yz[kPerLane];
  float acc[kPerLane];
#pragma unroll
  for (int s = 0; s < kPerLane; ++s) {
    const int corner = (lane + 32 * s) / C;
    xi[s] = corner & 1;
    yz[s] = (corner >> 1) & 3;
    acc[s] = 0.0f;
  }
  int cur = keys[chunk.s0];
  bool in_first = true;
  float* gs = sg[wib];

  for (int base = chunk.s0; base < chunk.end; base += 32) {
    const int n = min(32, chunk.end - base);
    int k = n_cells;
    long long p = 0;
    if (lane < n) {
      k = keys[base + lane];
      p = perm[base + lane];
    }
    // this lane's point: its weights, rounded under bf16 (0 where the
    // point adds nothing)
    float wv[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    uint32_t cl[3][2];
    float A[3][2];
    if (k < n_cells
        && point_lanes(x01, p, res, align_corners, smoothstep, cl, A)) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        wv[x] = BF16 ? round_bf16(A[0][x]) : A[0][x];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float t = __fmul_rn(A[2][q >> 1], A[1][q & 1]);
        wv[2 + q] = BF16 ? round_bf16(t) : t;
      }
    }
#pragma unroll
    for (int q = 0; q < 6; ++q) sw[wib][lane][q] = wv[q];
    // stage the g rows of these 32 points: value t is channel t % C of
    // the point of record t / C
#pragma unroll
    for (int t = lane; t < 32 * C; t += 32) {
      const int j = t / C;
      const long long pj = __shfl_sync(kFull, p, j);
      gs[t] = j < n ? load_g<BF16>(g, pj * g_stride + g_col + (t % C)) : 0.0f;
    }
    __syncwarp();
    for (int j = 0; j < n; ++j) {
      const int kj = __shfl_sync(kFull, k, j);
      if (kj != cur) {
        segments::store<kPerLane>(cellsum, head, tail, chunk,
                                  segments::role(chunk, in_first, false), cur,
                                  n_cells, kW, acc, lane);
        in_first = false;
        cur = kj;
#pragma unroll
        for (int s = 0; s < kPerLane; ++s) acc[s] = 0.0f;
      }
      const float gv = gs[j * C + c];
      const float* wj = sw[wib][j];
#pragma unroll
      for (int s = 0; s < kPerLane; ++s) {
        if (lane + 32 * s < kW) {
          const float gx = BF16 ? round_bf16(__fmul_rn(gv, wj[xi[s]]))
                                : __fmul_rn(gv, wj[xi[s]]);
          acc[s] = __fadd_rn(acc[s], __fmul_rn(wj[2 + yz[s]], gx));
        }
      }
    }
    __syncwarp();
  }
  segments::store<kPerLane>(cellsum, head, tail, chunk,
                            segments::role(chunk, in_first, true), cur,
                            n_cells, kW, acc, lane);
}

// the sums of the chunk groups that lie inside one cell
template <int kPerLane>
__global__ void __launch_bounds__(kThreads)
cell_edge_group_kernel(const int32_t* __restrict__ keys,
                       const float* __restrict__ head,
                       float* __restrict__ group, int B, int width) {
  segments::group_sum<kPerLane>(
      keys, B, head, group, width,
      (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5), threadIdx.x & 31);
}

// the cells that cross chunk edges, their partials added in chunk order
template <int kPerLane>
__global__ void __launch_bounds__(kThreads)
cell_edge_fixup_kernel(const int32_t* __restrict__ keys,
                       const float* __restrict__ head,
                       const float* __restrict__ tail,
                       const float* __restrict__ group,
                       float* __restrict__ cellsum, int B, int n_cells,
                       int width) {
  segments::fixup_chain<kPerLane>(
      keys, B, head, tail, group, cellsum, n_cells, width,
      (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5), threadIdx.x & 31);
}

// pass 2: every entry of the level's slice, the 8 corners in order
template <bool BF16>
__global__ void __launch_bounds__(kThreads)
cell_gather_kernel(const float* __restrict__ cellsum,
                   float* __restrict__ grad, int res, int C, int64_t n) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const int64_t r = t / C;
  const int c = (int)(t - r * C);
  if (r >= (int64_t)res * res * res) {
    grad[t] = 0.0f;
    return;
  }
  const int x = (int)(r % res);
  const int y = (int)((r / res) % res);
  const int z = (int)(r / ((int64_t)res * res));
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int cx = x - (i & 1), cy = y - ((i >> 1) & 1), cz = z - (i >> 2);
    if (cx < 0 || cy < 0 || cz < 0) continue;
    const int64_t cell = cx + (int64_t)res * (cy + (int64_t)res * cz);
    acc = __fadd_rn(acc, cellsum[(cell * 8 + i) * C + c]);
  }
  grad[t] = BF16 ? round_bf16(acc) : acc;
}

template <bool BF16>
__global__ void pack_g_words_kernel(const void* __restrict__ g,
                                    uint32_t* __restrict__ words, int64_t B,
                                    int L, int C, int m) {
  const int W = (C + 1) / 2;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)(L - m) * B * W) return;
  const int p = (int)(t % W);
  const int64_t b = (t / W) % B;
  const int lv = m + (int)(t / ((int64_t)W * B));
  const int64_t col = b * L * C + (int64_t)lv * C + 2 * p;
  uint32_t hi, lo = 0;
  if (BF16) {
    const uint16_t* gb = static_cast<const uint16_t*>(g);
    hi = (uint32_t)gb[col] << 16;
    if (2 * p + 1 < C) lo = gb[col + 1];
  } else {
    const uint32_t* gf = static_cast<const uint32_t*>(g);
    hi = gf[col] & 0xffff0000u;
    if (2 * p + 1 < C) lo = gf[col + 1] >> 16;
  }
  words[t] = hi | lo;
}

__global__ void combine_totals_kernel(const float* __restrict__ totals,
                                      float* __restrict__ grad, int64_t R,
                                      int C) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= R * C) return;
  const int64_t r = t / C;
  const int c = (int)(t - r * C);
  const float g0 = totals[r * 2 * C + c];
  grad[t] = r > 0 ? __fadd_rn(g0, totals[(r - 1) * 2 * C + C + c])
                  : __fadd_rn(g0, 0.0f);
}

unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

int64_t chunks_of(int B) { return ((int64_t)B + kChunk - 1) / kChunk; }

// one warp each
unsigned warp_blocks(int64_t warps) {
  return (unsigned)((warps + kWarps - 1) / kWarps);
}

// pass 1, its group sums and its fix-up; edges holds head, tail and group
// rows of 8C (n_edge chunk slots)
template <int C>
cudaError_t launch_cells(const int32_t* keys, const int64_t* perm,
                         const float* x01, const void* g, float* cellsum,
                         float* edges, int64_t n_edge, int B, int res,
                         int64_t g_stride, int g_col, int align_corners,
                         int smoothstep, bool bf16, cudaStream_t s) {
  constexpr int kW = 8 * C;
  constexpr int kPerLane = (kW + 31) / 32;
  float* head = edges;
  float* tail = edges + n_edge * kW;
  float* group = edges + 2 * n_edge * kW;
  const int64_t n_chunks = chunks_of(B);
  if (bf16) {
    cell_sums_kernel<C, true><<<warp_blocks(n_chunks), kThreads, 0, s>>>(
        keys, perm, x01, g, cellsum, head, tail, B, res, g_stride, g_col,
        align_corners, smoothstep);
  } else {
    cell_sums_kernel<C, false><<<warp_blocks(n_chunks), kThreads, 0, s>>>(
        keys, perm, x01, g, cellsum, head, tail, B, res, g_stride, g_col,
        align_corners, smoothstep);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cell_edge_group_kernel<kPerLane>
      <<<warp_blocks((n_chunks + segments::kGroup - 1) / segments::kGroup),
         kThreads, 0, s>>>(keys, head, group, B, kW);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cell_edge_fixup_kernel<kPerLane><<<warp_blocks(n_chunks), kThreads, 0, s>>>(
      keys, head, tail, group, cellsum, B, res * res * res, kW);
  return cudaGetLastError();
}

}  // namespace

// x01 [B, 3] f32 -> keys [B] i32, each point's cell at a dense level of
// resolution res (res^3 for a point outside [0, 1]^3 or NaN); zeroes
// cellsum [res^3 * 8 * C] f32, the scratch of mm_grad_table_fwd. B > 0.
// Returns cudaGetLastError().
extern "C" int mm_grad_keys_fwd(const float* x01, int32_t* keys,
                                float* cellsum, int B, int res, int C,
                                int align_corners, int smoothstep,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n_zero4 = (int64_t)res * res * res * 2 * C;
  cell_keys_kernel<<<blocks_for(B > n_zero4 ? B : n_zero4), kThreads, 0,
                     s>>>(x01, keys, reinterpret_cast<float4*>(cellsum), B,
                          res, n_zero4, align_corners, smoothstep);
  return static_cast<int>(cudaGetLastError());
}

// One dense level's table gradient from its points sorted by cell:
// keys_sorted [B] i32 and perm [B] i64 (torch.sort(keys, stable=True) of
// mm_grad_keys_fwd's keys), x01 [B, 3] f32, g [B, g_stride] (bf16 if
// bf16, else f32; the level's C channels at column g_col), cellsum
// [res^3 * 8 * C] f32 as mm_grad_keys_fwd left it, edges scratch of
// segments::edge_rows(n_edge) rows of 8C f32 with n_edge >= ceil(B / 128)
// -> grad
// [hmap * C] f32, the level's flat slice, every entry written. B > 0, C a
// power of two <= 32, res^3 <= hmap. Returns the first CUDA error, else
// cudaGetLastError(); cudaErrorInvalidValue for an unsupported C or too
// few edge rows.
extern "C" int mm_grad_table_fwd(const int32_t* keys_sorted,
                                 const int64_t* perm, const float* x01,
                                 const void* g, float* cellsum, float* edges,
                                 float* grad, int B, int res,
                                 int C, int hmap, int64_t g_stride, int g_col,
                                 int n_edge, int align_corners, int smoothstep,
                                 int bf16, void* stream) {
  if (n_edge < chunks_of(B)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (C) {
#define RAW_NGP_CASE(c)                                                       \
    case c:                                                                   \
      err = launch_cells<c>(keys_sorted, perm, x01, g, cellsum, edges,        \
                            n_edge, B, res, g_stride, g_col, align_corners,   \
                            smoothstep, bf16 != 0, s);                        \
      break;
    RAW_NGP_CASE(1) RAW_NGP_CASE(2) RAW_NGP_CASE(4) RAW_NGP_CASE(8)
    RAW_NGP_CASE(16) RAW_NGP_CASE(32)
#undef RAW_NGP_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n = (int64_t)hmap * C;
  if (bf16) {
    cell_gather_kernel<true><<<blocks_for(n), kThreads, 0, s>>>(
        cellsum, grad, res, C, n);
  } else {
    cell_gather_kernel<false><<<blocks_for(n), kThreads, 0, s>>>(
        cellsum, grad, res, C, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// g [B, L * C] (bf16 if bf16, else f32) -> words [L - m, B, ceil(C/2)]
// int32 (B > 0, m < L). Returns cudaGetLastError().
extern "C" int pack_g_words_fwd(const void* g, uint32_t* words, int64_t B,
                                int L, int C, int m, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n = (int64_t)(L - m) * B * ((C + 1) / 2);
  if (bf16) {
    pack_g_words_kernel<true><<<blocks_for(n), kThreads, 0, s>>>(
        g, words, B, L, C, m);
  } else {
    pack_g_words_kernel<false><<<blocks_for(n), kThreads, 0, s>>>(
        g, words, B, L, C, m);
  }
  return static_cast<int>(cudaGetLastError());
}

// totals [R, 2C] f32 (B2's G0 | G1 columns) -> grad [R * C] f32 with
// grad[r] = G0[r] + G1[r - 1] (R > 0). Returns cudaGetLastError().
extern "C" int combine_totals_fwd(const float* totals, float* grad, int64_t R,
                                  int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  combine_totals_kernel<<<blocks_for(R * C), kThreads, 0, s>>>(totals, grad,
                                                               R, C);
  return static_cast<int>(cudaGetLastError());
}
