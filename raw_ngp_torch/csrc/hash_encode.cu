// Multiresolution hash-grid encode for Hopper (sm_90a): the forward (which
// also writes the records of its table gradient), its input gradient and
// that gradient's JVP in g (the orientation loss's second-order term).
//
// Replaces the encode that the JAX package runs through XLA in
// raw_ngp_tpu/kernels/hash_fused.py: hash_encode_fused / _fused_fwd (the
// matmul path _mm_forward for dense leading levels, the 2-row vrow
// windows of _window_forward for the rest), the residuals of _fused_fwd
// (_window_indices_weights) and the input VJP of _fused_bwd
// (need_input_grads, :760-778). They stand in for the reference's
// hand-written CUDA gridencoder. Plain versions:
// raw_ngp_torch/kernels/hash_encode.py hash_encode_fused_plain,
// window_records_plain, encode_input_grad_plain and
// encode_input_jvp_plain.
//
// What bounds them. The forward and the input gradient are gathers: per
// (point, level) 8 table rows of C f32 at hashed addresses. The flagship's
// 262,144 uniform points touch 517,036 rows: 15.8 us (forward) and 16.8 us
// (input gradient, g included) at 3.35 TB/s if each row came from DRAM
// once. The level-1 table (524,288 x 16 f32, 33.5 MB) fits in the 50 MB
// L2, so after first touch the gathers are L2 hits, and what decides the
// time is how many sectors and load instructions each row costs and how
// many gathers each SM keeps in flight, not DRAM bytes.
//
// Thread layout of the forward and the input gradient: a group of
// G = ceil(C / 4) adjacent threads per point (4 at the flagship's C = 16),
// thread j of the group owning channels [4j, 4j + 4). So:
// - a corner row is read by the group as one contiguous 16 G-byte piece
//   (two full sectors at C = 16; the two rows of a pairable window are
//   adjacent, 128 B), one float4 a thread, instead of one thread's four
//   float4 at 32 scattered rows per warp instruction;
// - the group walks the levels in order, so every warp runs one level's
//   code path at a time: no warp mixes the dense (matmul) level's chain
//   with the window levels' (the old one-thread-per-(point, level) layout
//   ran both in every warp at L = 2);
// - the hashing is shared: thread j hashes corners j, j + G, ... and the
//   group broadcasts the 8 rows with __shfl_sync (level_rows), so the
//   modulo-heavy index math is not repeated G times;
// - each channel's arithmetic stays inside one thread in the plain
//   version's order, so the bf16 forward keeps JAX's rounding chain bit
//   for bit by construction; each thread keeps 4 channels of state;
// - the windows are walked as they are formed (for_each_window), never
//   stored in arrays indexed by a running count, so nothing is in local
//   memory; runtime axis choices are selects, not array indices.
//
// The forward. Inputs outside [0, 1]^3 or NaN give zeros. In f32 it sums
// the 8 corner values x trilinear weights (ops/hashgrid.hash_encode_01).
// Under bf16 it takes the JAX fused encoder's rounding chain: on a window
// level each lane product rounded, each window's two rows added and
// rounded, the windows summed in f32 (_window_forward); on a dense matmul
// level the partial interpolation Z per x lane rounded, then Z x rnd(wx)
// rounded, the x lanes summed (_mm_forward); the f32 level sum is rounded
// once by the store. Each (point, level) writes its C outputs
// contiguously, 4 a thread (8 B in bf16, 16 B in f32). Position, weight
// and bf16 arithmetic use the _rn intrinsics so nvcc cannot contract them
// into FMAs: the cell, fraction and every rounded product must round
// exactly as the plain version's separate operations. The bf16 chain
// rounds two channels with one conversion (round_bf16x2; the same bits,
// 12-16% less device time than one conversion a value, PERF.md).
//
// The input gradient (pose refinement) takes the same groups: each thread
// reads its quad of every corner row and of g (four bf16 or f32), and the
// sums across channels (a window level's corner value V = sum_c rnd(g_c
// T_c), a dense level's weight cotangents) are formed in channel order by
// a chain of shuffles (group_chain): each thread adds its own terms to the
// running sum of the threads before it, so the f32 sums are the plain
// version's, one add at a time, and the result equals it bit for bit.
// Then d/df_d from the corner values (window level) or through JAX's
// _mm_forward chain (dense level), and the chain rule: df/dx = res
// (res - 1 with align_corners), half of it where the clip bound is met
// exactly (jnp.clip's tie), none beyond it, times the smoothstep
// derivative; 0 outside [0, 1]^3. Thread 0 of the group writes
// grad_x [B, 3] once, the levels summed in order: no atomics,
// deterministic.
//
// The records (kRec, the forward of a table that needs a gradient): per
// window level the forward also writes base [P, B] i32 and the (w0, w1)
// pair of each window as one word of two truncated bf16 halves [P, B]
// (the _pack_bf16_pairs word the table gradient sorts and sums, see
// csrc/segsum.cu), as JAX's _fused_fwd returns _window_indices_weights
// with the output. The windows are the ones the forward walks
// (for_each_window): their weight products follow the JAX order (pair
// axis last, the other axes in index order), so the truncated halves
// match bit for bit. The bf16 forward forms them anyway; the f32 forward
// reads its rows in BitCorners order, and window order is a fixed
// permutation of those 8 rows for each pair axis (window_order), so no
// corner is hashed twice. Lane j of a group stores windows j, j + G, ...
// (one each at C = 16: 4 windows, G = 4). A point outside [0, 1]^3 or NaN
// still gets its records, at the cell of x = 0.5 with weight 0, while its
// outputs stay 0. The records add 8.4 MB written to the forward's bytes
// at the flagship's 262,144 points and 4 windows.
//
// The JVP (the orientation loss's second order) takes the same groups;
// below C = 8 it stages the level table and its outputs in shared memory
// and stores whole rows (encode_input_jvp_kernel). Every kernel reduces
// its hashes with the level table's constants (mod_u32), no runtime
// modulo.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// per-level row of the level table built by the Python wrapper
// (raw_ngp_torch/kernels/hash_encode.py _level_table, LEVEL_COLUMNS):
// res, hmap, offset, n_strides, stride0, stride1, stride2, mode, axis,
// pairable, first window (the records; -1 on the matmul levels), then the
// (mask, magic) pairs that reduce modulo hmap and, on the additive hash's
// levels, modulo hmap - res (mod_u32)
constexpr int kLevelRow = 15;
constexpr int kModeStride = 0, kModeXor = 1, kModeAdditive = 2;

// threads per point (one per channel quad) and channels per thread
template <int C>
constexpr int kGroup = (C + 3) / 4;
template <int C>
constexpr int kQuad = C < 4 ? C : 4;

struct Level {
  uint64_t hmap_magic, add_magic;
  uint32_t res, hmap, offset, stride[3], hmap_mask, add_mask;
  int n_strides, mode, axis;
  bool pairable;
};

__device__ __forceinline__ Level load_level(const int64_t* __restrict__ lp) {
  Level l;
  l.res = (uint32_t)lp[0];
  l.hmap = (uint32_t)lp[1];
  l.offset = (uint32_t)lp[2];
  l.n_strides = (int)lp[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) l.stride[d] = (uint32_t)lp[4 + d];
  l.mode = (int)lp[7];
  l.axis = (int)lp[8];
  l.pairable = lp[9] != 0;
  l.hmap_mask = (uint32_t)lp[11];
  l.hmap_magic = (uint64_t)lp[12];
  l.add_mask = (uint32_t)lp[13];
  l.add_magic = (uint64_t)lp[14];
  return l;
}

// x % d for every uint32 x without a division, from the level table's
// constants (kernels/hash_encode.py mod_constants): x & mask where d is a
// power of two (mask = d - 1; all ones marks the others), else Lemire's
// fastmod, hi64(lo64(magic * x) * d) with magic = floor((2^64 - 1) / d) +
// 1. A runtime % is a sequence of some twenty instructions; this is an
// AND, or a 64-bit multiply and a high half (tests/test_torch_level_table.py
// holds the emulated reduction to % on every level of the port's grids).
// With the hardware % in its place the input gradient measured 7-11%
// less time, the forward 3-11% more and the JVP 11-102% more (PERF.md);
// one reduction serves them all.
__device__ __forceinline__ uint32_t mod_u32(uint32_t x, uint32_t d,
                                            uint32_t mask, uint64_t magic) {
  return mask != 0xffffffffu ? x & mask
                             : (uint32_t)__umul64hi(magic * x, (uint64_t)d);
}

// v[i] for a runtime i, as selects (an array index would go to local memory)
template <typename T>
__device__ __forceinline__ T sel3(const T v[3], int i) {
  return i == 0 ? v[0] : (i == 1 ? v[1] : v[2]);
}

__device__ __forceinline__ uint32_t mix_prime(int d) {
  // _mix_prime: dim 0 borrows the 4th prime since the 1st is 1
  return d == 0 ? 3674653429u : (d == 1 ? 2654435761u : 805459861u);
}

// the table row of grid corner c (_level_indices: dense stride, xor and
// additive hashes, in native uint32)
__device__ __forceinline__ uint32_t level_row(const Level& l,
                                              const uint32_t c[3]) {
  uint32_t index = 0;
  if (l.mode == kModeAdditive) {
    uint32_t g = 0;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      if (d != l.axis) g ^= c[d] * mix_prime(d);
    }
    index = sel3(c, l.axis) + mod_u32(g, l.hmap - l.res, l.add_mask,
                                      l.add_magic);
  } else if (l.mode == kModeXor) {
    index = c[0] ^ (c[1] * 2654435761u) ^ (c[2] * 805459861u);
  } else {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      if (d < l.n_strides) index += c[d] * l.stride[d];
    }
  }
  return mod_u32(index, l.hmap, l.hmap_mask, l.hmap_magic) + l.offset;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float rnd_if(bool bf16, float v) {
  return bf16 ? round_bf16(v) : v;
}

// two values rounded to bf16 by one conversion, back in f32
__device__ __forceinline__ float2 round_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return make_float2(__low2float(h), __high2float(h));
}

// Lower corner g and fraction f of x in one level (_corner_axis).
__device__ __forceinline__ void level_cell(const Level& l, const float x[3],
                                           int align_corners, int smoothstep,
                                           uint32_t g[3], float f[3]) {
  const float top_f = (float)(l.res - 1);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float pos, gf;
    if (align_corners) {
      pos = __fmul_rn(x[d], top_f);
      gf = fminf(floorf(pos), (float)(l.res - 2));
    } else {
      pos = __fsub_rn(__fmul_rn(x[d], (float)l.res), 0.5f);
      pos = fminf(fmaxf(pos, 0.0f), top_f);
      gf = floorf(pos);
    }
    float fd = __fsub_rn(pos, gf);
    if (smoothstep) {
      fd = __fmul_rn(__fmul_rn(fd, fd), __fsub_rn(3.0f, __fmul_rn(2.0f, fd)));
    }
    f[d] = fd;
    g[d] = (uint32_t)(int)gf;
  }
}

// Corner k of the cell at g with bit d of k on axis d (clamped to res - 1):
// the trilinear order, and the dense path's lanes (xi, yi, zi).
struct BitCorners {
  uint32_t g[3];
  uint32_t hi;
  __device__ __forceinline__ void operator()(int k, uint32_t c[3]) const {
#pragma unroll
    for (int d = 0; d < 3; ++d) c[d] = min(g[d] + ((uint32_t)(k >> d) & 1u), hi);
  }
};

// Corner k = 2h + side in JAX's window order (_window_indices_weights): bit
// 0 and 1 of h on the two non-pair axes in index order, side on the pair
// axis a.
struct WindowCorners {
  uint32_t g[3];
  uint32_t hi;
  int a;
  __device__ __forceinline__ void operator()(int k, uint32_t c[3]) const {
    const int h = k >> 1;
    const int r0 = a == 0 ? 1 : 0;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int bit = d == a ? (k & 1) : ((d == r0 ? h : h >> 1) & 1);
      c[d] = min(g[d] + (uint32_t)bit, hi);
    }
  }
};

// The mask of this thread's group of G lanes (G divides the warp).
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  const unsigned lane = threadIdx.x & 31u;
  return G >= 32 ? 0xffffffffu
                 : ((1u << G) - 1u) << (lane & ~(unsigned)(G - 1));
}

// The 8 corner rows of one (point, level): rows[k] is the row of corner
// coords(k). The S threads of a group share the hashing: thread j hashes
// corners j, j + S, ... and the rows are broadcast with __shfl_sync. Every
// index is a compile-time constant after unrolling, so rows stay in
// registers.
template <int S, typename Coords>
__device__ __forceinline__ void level_rows(const Level& l, int j,
                                           unsigned gmask, Coords coords,
                                           int rows[8]) {
  constexpr int kPer = 8 / S;
  int mine[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    uint32_t c[3];
    coords(j + i * S, c);
    mine[i] = (int)level_row(l, c);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if constexpr (S == 1) {
      rows[k] = mine[k];
    } else {
      rows[k] = __shfl_sync(gmask, mine[k / S], k % S, S);
    }
  }
}

// The 2-row windows of one (point, level) from its corner rows in window
// order, in JAX's window order: fn(k, first row, w0, w1) for 4 windows of
// two adjacent rows when the level is pairable, else for 8 one-corner
// windows. The first row is clamped to top = n_params - 2 and w0 / w1 are
// the f32 weights routed to it and the next row, multiplied in JAX's order
// (pair axis last, the other axes in index order) so they match bit for
// bit.
template <typename Fn>
__device__ __forceinline__ void for_each_window(const Level& l,
                                                const int rows[8],
                                                const float f[3], float inb_f,
                                                int top, Fn&& fn) {
  const int a = l.axis;
  const float fa = sel3(f, a);
  const float f0 = sel3(f, a == 0 ? 1 : 0);
  const float f1 = sel3(f, a == 2 ? 1 : 2);
  const float fa1 = __fsub_rn(1.0f, fa);
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    float w_rest = __fmul_rn(inb_f, (h & 1) ? f0 : __fsub_rn(1.0f, f0));
    w_rest = __fmul_rn(w_rest, (h & 2) ? f1 : __fsub_rn(1.0f, f1));
    const int u = rows[2 * h], v = rows[2 * h + 1];
    const float w_u = __fmul_rn(fa1, w_rest);
    const float w_v = __fmul_rn(fa, w_rest);
    if (l.pairable) {
      const int bb = min(min(u, v), top);
      fn(h, bb, __fadd_rn(u == bb ? w_u : 0.0f, v == bb ? w_v : 0.0f),
         __fadd_rn(u == bb + 1 ? w_u : 0.0f, v == bb + 1 ? w_v : 0.0f));
    } else {
      const int bu = min(u, top), bv = min(v, top);
      fn(2 * h, bu, u == bu ? w_u : 0.0f, u == bu + 1 ? w_u : 0.0f);
      fn(2 * h + 1, bv, v == bv ? w_v : 0.0f, v == bv + 1 ? w_v : 0.0f);
    }
  }
}

// This thread's channels of a row (p points at channel 4j): one float4
// where C allows it.
template <int C>
__device__ __forceinline__ void load_quad(const float* __restrict__ p,
                                          float v[kQuad<C>]) {
  if constexpr (C >= 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (C == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

// One window of the bf16 forward, _window_forward's chain: each lane
// product rnd(rnd(T) * rnd(w)) of the rows bb and bb + 1, the two added
// and rounded, then added in f32 to the level's sum. The input gradient's
// JVP runs the same chain on the weights' directional derivatives.
template <int C>
__device__ __forceinline__ void window_bf16(const float* __restrict__ tq,
                                            int bb, float w0, float w1,
                                            float acc[kQuad<C>]) {
  constexpr int Q = kQuad<C>;
  const float wa = round_bf16(w0);
  const float wb = round_bf16(w1);
  float ta[Q], tb[Q];
  load_quad<C>(tq + (int64_t)bb * C, ta);
  load_quad<C>(tq + (int64_t)bb * C + C, tb);
  if constexpr (Q == 1) {
    const float pa = round_bf16(__fmul_rn(round_bf16(ta[0]), wa));
    const float pb = round_bf16(__fmul_rn(round_bf16(tb[0]), wb));
    acc[0] = __fadd_rn(acc[0], round_bf16(__fadd_rn(pa, pb)));
  } else {
#pragma unroll
    for (int q = 0; q < Q; q += 2) {
      const float2 ra = round_bf16x2(ta[q], ta[q + 1]);
      const float2 rb = round_bf16x2(tb[q], tb[q + 1]);
      const float2 pa = round_bf16x2(__fmul_rn(ra.x, wa), __fmul_rn(ra.y, wa));
      const float2 pb = round_bf16x2(__fmul_rn(rb.x, wb), __fmul_rn(rb.y, wb));
      const float2 s = round_bf16x2(__fadd_rn(pa.x, pb.x), __fadd_rn(pa.y, pb.y));
      acc[q] = __fadd_rn(acc[q], s.x);
      acc[q + 1] = __fadd_rn(acc[q + 1], s.y);
    }
  }
}

// One window level of the bf16 forward: window_bf16 over the level's
// windows in window order, the windows summed in f32 (XLA's CPU reduce
// accumulates its bf16 sum in f32 and rounds once, tested bit for bit
// against JAX). rec(k, first row, w0, w1) sees every window (the records).
template <int C, typename Rec>
__device__ __forceinline__ void window_level_bf16(const float* __restrict__ tq,
                                                  const Level& l,
                                                  const int rows[8],
                                                  const float f[3], int top,
                                                  float acc[kQuad<C>],
                                                  Rec&& rec) {
  for_each_window(l, rows, f, 1.0f, top,
                  [&](int k, int bb, float w0, float w1) {
    rec(k, bb, w0, w1);
    window_bf16<C>(tq, bb, w0, w1, acc);
  });
}

// The two lanes' weights of each axis at a dense level (_mm_axis_weights):
// (1 - f, f), or, where the upper lane is clamped onto the lower, one lane
// of weight (1 - f) + f and the other 0.
__device__ __forceinline__ void mm_weights(const uint32_t g[3],
                                           const float f[3], uint32_t res,
                                           float A[3][2], bool present[3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    present[d] = min(g[d] + 1, res - 1) != g[d];
    const float a0 = __fsub_rn(1.0f, f[d]);
    A[d][0] = present[d] ? a0 : __fadd_rn(a0, f[d]);
    A[d][1] = present[d] ? f[d] : 0.0f;
  }
}

// One dense (matmul) level of the bf16 forward, _mm_forward's chain: per x
// lane Z = rnd(sum_yz rnd(wz wy) rnd(T)) over the yz lanes in XLA's order
// (z-major, then y; f32 sum, rounded once), then rnd(Z x rnd(wx)), the two
// x lanes added in f32 (the final rounding is the store's). rows are in
// BitCorners order.
template <int C>
__device__ __forceinline__ void mm_level_bf16(const float* __restrict__ tq,
                                              const Level& l,
                                              const uint32_t g[3],
                                              const float f[3],
                                              const int rows[8],
                                              float acc[kQuad<C>]) {
  constexpr int Q = kQuad<C>;
  float A[3][2];
  bool present[3];
  mm_weights(g, f, l.res, A, present);
#pragma unroll
  for (int xi = 0; xi < 2; ++xi) {
    float z[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) z[q] = 0.0f;
#pragma unroll
    for (int yz = 0; yz < 4; ++yz) {
      const int zi = yz >> 1, yi = yz & 1;
      const float w = round_bf16(__fmul_rn(A[2][zi], A[1][yi]));
      float t[Q];
      load_quad<C>(tq + (int64_t)rows[xi | yi << 1 | zi << 2] * C, t);
      if constexpr (Q == 1) {
        z[0] = __fadd_rn(z[0], __fmul_rn(w, round_bf16(t[0])));
      } else {
#pragma unroll
        for (int q = 0; q < Q; q += 2) {
          const float2 r = round_bf16x2(t[q], t[q + 1]);
          z[q] = __fadd_rn(z[q], __fmul_rn(w, r.x));
          z[q + 1] = __fadd_rn(z[q + 1], __fmul_rn(w, r.y));
        }
      }
    }
    const float wx = round_bf16(A[0][xi]);
    if constexpr (Q == 1) {
      acc[0] = __fadd_rn(acc[0], round_bf16(__fmul_rn(round_bf16(z[0]), wx)));
    } else {
#pragma unroll
      for (int q = 0; q < Q; q += 2) {
        const float2 rz = round_bf16x2(z[q], z[q + 1]);
        const float2 p = round_bf16x2(__fmul_rn(rz.x, wx), __fmul_rn(rz.y, wx));
        acc[q] = __fadd_rn(acc[q], p.x);
        acc[q + 1] = __fadd_rn(acc[q + 1], p.y);
      }
    }
  }
}

// One level of the f32 forward: the 8 corners' values x trilinear weights
// (weights multiplied in dimension order), rows in BitCorners order.
template <int C>
__device__ __forceinline__ void level_f32(const float* __restrict__ tq,
                                          const float f[3], const int rows[8],
                                          float acc[kQuad<C>]) {
  constexpr int Q = kQuad<C>;
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    float w = 1.0f;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float fd = (corner >> d) & 1 ? f[d] : __fsub_rn(1.0f, f[d]);
      w = d == 0 ? fd : __fmul_rn(w, fd);
    }
    float t[Q];
    load_quad<C>(tq + (int64_t)rows[corner] * C, t);
#pragma unroll
    for (int q = 0; q < Q; ++q) acc[q] += t[q] * w;
  }
}

// The 8 rows of a cell in WindowCorners order from its rows in
// BitCorners order: window corner k = 2h + side has side on the pair axis
// a and bits 0 and 1 of h on the other two axes in index order, so its
// bit index is k for a = 0, k with bits 0 and 1 swapped for a = 1, and k
// rotated (bit 0 to 2, 1 to 0, 2 to 1) for a = 2. Selects on a, constant
// indices: the rows stay in registers.
__device__ __forceinline__ void window_order(const int bit_rows[8], int a,
                                             int rows[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int s = k & 1, h0 = (k >> 1) & 1, h1 = k >> 2;
    rows[k] = a == 0 ? bit_rows[k]
              : (a == 1 ? bit_rows[s << 1 | h0 | h1 << 2]
                        : bit_rows[s << 2 | h0 | h1 << 1]);
  }
}

// This thread's outputs of one (point, level): 4 channels (fewer below
// C = 4), rounded to bf16 in pairs or stored as f32.
template <int C, bool BF16>
__device__ __forceinline__ void store_quad(void* __restrict__ out, int64_t o,
                                           const float acc[kQuad<C>]) {
  if constexpr (BF16) {
    __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(out) + o;
    if constexpr (C == 1) {
      dst[0] = __float2bfloat16_rn(acc[0]);
    } else {
      const __nv_bfloat162 p0 = __floats2bfloat162_rn(acc[0], acc[1]);
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(&p0);
      if constexpr (C == 2) {
        *reinterpret_cast<uint32_t*>(dst) = w0;
      } else {
        const __nv_bfloat162 p1 = __floats2bfloat162_rn(acc[2], acc[3]);
        *reinterpret_cast<uint2*>(dst) =
            make_uint2(w0, *reinterpret_cast<const uint32_t*>(&p1));
      }
    }
  } else {
    float* dst = static_cast<float*>(out) + o;
    if constexpr (C >= 4) {
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else if constexpr (C == 2) {
      *reinterpret_cast<float2*>(dst) = make_float2(acc[0], acc[1]);
    } else {
      dst[0] = acc[0];
    }
  }
}

template <int C, bool BF16, bool kRec>
__global__ void __launch_bounds__(kThreads)
hash_encode_kernel(const float* __restrict__ x01,
                   const float* __restrict__ table,
                   const int64_t* __restrict__ levels, void* __restrict__ out,
                   int32_t* __restrict__ base, uint32_t* __restrict__ w_word,
                   int64_t B, int L, int m, int top, int align_corners,
                   int smoothstep) {
  constexpr int G = kGroup<C>, Q = kQuad<C>;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t b = t / G;
  if (b >= B) return;  // whole groups: G divides the warp
  const int j = (int)(t % G);
  const unsigned gmask = group_mask<G>();
  const float* tq = table + 4 * j;  // this thread's channels of row 0

  float x[3];
  bool inb = true;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    x[d] = x01[b * 3 + d];
    inb = inb && (x[d] >= 0.0f) && (x[d] <= 1.0f);  // false for NaN
  }
  if (kRec) {  // a point outside takes the cell of 0.5 for its records
#pragma unroll
    for (int d = 0; d < 3; ++d) x[d] = inb ? x[d] : 0.5f;
  }

  for (int lv = 0; lv < L; ++lv) {
    float acc[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) acc[q] = 0.0f;
    const bool rec = kRec && lv >= m;
    if (inb || rec) {  // uniform within the group
      const Level l = load_level(levels + lv * kLevelRow);
      uint32_t g[3];
      float f[3];
      level_cell(l, x, align_corners, smoothstep, g, f);
      // this lane's windows of the level's records: j, j + G, ...
      const int64_t win0 = rec ? levels[lv * kLevelRow + 10] : 0;
      auto put = [&](int k, int bb, float w0, float w1) {
        if (kRec && rec && k % G == j) {
          const int64_t o = (win0 + k) * B + b;
          base[o] = bb;
          w_word[o] = (__float_as_uint(w0) & 0xffff0000u)
                      | (__float_as_uint(w1) >> 16);
        }
      };
      int rows[8];
      if (BF16 && lv >= m) {
        level_rows<G>(l, j, gmask,
                      WindowCorners{{g[0], g[1], g[2]}, l.res - 1, l.axis},
                      rows);
        if (inb) {
          window_level_bf16<C>(tq, l, rows, f, top, acc, put);
        } else {
          for_each_window(l, rows, f, 0.0f, top, put);
        }
      } else {
        level_rows<G>(l, j, gmask, BitCorners{{g[0], g[1], g[2]}, l.res - 1},
                      rows);
        // the f32 forward's window levels: the records first (after the
        // gathers, ptxas spilled the C = 32 instantiation)
        if (rec) {
          int wrows[8];
          window_order(rows, l.axis, wrows);
          for_each_window(l, wrows, f, inb ? 1.0f : 0.0f, top, put);
        }
        if (inb) {
          if (BF16) {
            mm_level_bf16<C>(tq, l, g, f, rows, acc);
          } else {
            level_f32<C>(tq, f, rows, acc);
          }
        }
      }
    }
    store_quad<C, BF16>(out, (b * L + lv) * C + 4 * j, acc);
  }
}

template <int C, bool kRec>
void launch(bool bf16, const float* x01, const float* table,
            const int64_t* levels, void* out, int32_t* base, uint32_t* w_word,
            int64_t B, int L, int m, int top, int align_corners,
            int smoothstep, cudaStream_t s) {
  const int64_t n = B * kGroup<C>;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  if (bf16) {
    hash_encode_kernel<C, true, kRec><<<blocks, kThreads, 0, s>>>(
        x01, table, levels, out, base, w_word, B, L, m, top, align_corners,
        smoothstep);
  } else {
    hash_encode_kernel<C, false, kRec><<<blocks, kThreads, 0, s>>>(
        x01, table, levels, out, base, w_word, B, L, m, top, align_corners,
        smoothstep);
  }
}

// This thread's channels of g at element o (channel 4j of a (point, level)).
template <int C, bool BF16>
__device__ __forceinline__ void load_g_quad(const void* __restrict__ g,
                                            int64_t o, float v[kQuad<C>]) {
  if constexpr (BF16) {
    const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(g) + o;
    if constexpr (C >= 4) {
      const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
      v[0] = __uint_as_float(w.x << 16);
      v[1] = __uint_as_float(w.x & 0xffff0000u);
      v[2] = __uint_as_float(w.y << 16);
      v[3] = __uint_as_float(w.y & 0xffff0000u);
    } else {
#pragma unroll
      for (int q = 0; q < C; ++q) v[q] = __bfloat162float(p[q]);
    }
  } else {
    load_quad<C>(static_cast<const float*>(g) + o, v);
  }
}

// init + the group's terms in channel order (thread 0's Q terms, then
// thread 1's, ...), one f32 add at a time: each step every thread adds its
// own terms to the running sum and thread s's result is broadcast, so the
// sum is the sequential one over the C channels. Every thread of the
// group gets it.
template <int G, int Q>
__device__ __forceinline__ float group_chain(float init, const float t[Q],
                                             unsigned gmask) {
  float acc = init;
#pragma unroll
  for (int s = 0; s < G; ++s) {
    float a = acc;
#pragma unroll
    for (int q = 0; q < Q; ++q) a = __fadd_rn(a, t[q]);
    if constexpr (G == 1) {
      acc = a;
    } else {
      acc = __shfl_sync(gmask, a, s, G);
    }
  }
  return acc;
}

// d(out_lv . g)/d f_d on a window level (encode_input_grad_plain
// _window_level_ct): corner values V = sum_c rnd(g_c * rnd(T_c)), then per
// axis the differences across it weighted by the other two axes' factors,
// in dimension order. rows are in BitCorners order.
template <int C, bool BF16>
__device__ __forceinline__ void window_level_ct(const float* __restrict__ tq,
                                                const int rows[8],
                                                const float f[3],
                                                const float gv[kQuad<C>],
                                                unsigned gmask, float ct[3]) {
  constexpr int G = kGroup<C>, Q = kQuad<C>;
  float V[8];
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    float t[Q];
    load_quad<C>(tq + (int64_t)rows[corner] * C, t);
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      t[q] = rnd_if(BF16, __fmul_rn(gv[q], rnd_if(BF16, t[q])));
    }
    V[corner] = group_chain<G, Q>(0.0f, t, gmask);
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const int o0 = d == 0 ? 1 : 0;
    const int o1 = d == 2 ? 1 : 2;
    float acc = 0.0f;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int b0 = h & 1, b1 = (h >> 1) & 1;
      const float w0 = b0 ? f[o0] : __fsub_rn(1.0f, f[o0]);
      const float w1 = b1 ? f[o1] : __fsub_rn(1.0f, f[o1]);
      const int lo = (b0 << o0) | (b1 << o1);
      const float diff = __fsub_rn(V[lo | (1 << d)], V[lo]);
      acc = __fadd_rn(acc, __fmul_rn(diff, __fmul_rn(w0, w1)));
    }
    ct[d] = acc;
  }
}

// d(out_lv . g)/d f_d on a dense matmul level, through JAX's _mm_forward
// chain (encode_input_grad_plain _mm_level_ct): Z = sum_yz rnd(wz wy) T per
// x lane, d/d wx = sum_c rnd(g_c rnd(Z_c)), d/d wyz = rnd(sum over x lanes
// and channels of rnd(g_c rnd(wx)) T), then the one-hot lanes'
// derivatives. The two cross-channel sums run as group chains. rows are in
// BitCorners order.
template <int C, bool BF16>
__device__ __forceinline__ void mm_level_ct(const float* __restrict__ tq,
                                            const int rows[8],
                                            const uint32_t g0[3],
                                            const float f[3], uint32_t res,
                                            const float gv[kQuad<C>],
                                            unsigned gmask, float ct[3]) {
  constexpr int G = kGroup<C>, Q = kQuad<C>;
  float A[3][2];
  bool present[3];
  mm_weights(g0, f, res, A, present);
  float wyz[2][2], acc_wyz[2][2];
#pragma unroll
  for (int zi = 0; zi < 2; ++zi) {
#pragma unroll
    for (int yi = 0; yi < 2; ++yi) {
      wyz[zi][yi] = rnd_if(BF16, __fmul_rn(A[2][zi], A[1][yi]));
      acc_wyz[zi][yi] = 0.0f;
    }
  }
  float ct_wx[2];
#pragma unroll
  for (int xi = 0; xi < 2; ++xi) {
    const float wx = rnd_if(BF16, A[0][xi]);
    float gw[Q], z[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      gw[q] = rnd_if(BF16, __fmul_rn(gv[q], wx));
      z[q] = 0.0f;
    }
#pragma unroll
    for (int zi = 0; zi < 2; ++zi) {
#pragma unroll
      for (int yi = 0; yi < 2; ++yi) {
        float t[Q], p[Q];
        load_quad<C>(tq + (int64_t)rows[xi | yi << 1 | zi << 2] * C, t);
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const float tr = rnd_if(BF16, t[q]);
          z[q] = __fadd_rn(z[q], __fmul_rn(wyz[zi][yi], tr));
          p[q] = __fmul_rn(gw[q], tr);
        }
        acc_wyz[zi][yi] = group_chain<G, Q>(acc_wyz[zi][yi], p, gmask);
      }
    }
    float p[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      p[q] = rnd_if(BF16, __fmul_rn(gv[q], rnd_if(BF16, z[q])));
    }
    ct_wx[xi] = group_chain<G, Q>(0.0f, p, gmask);
  }
  float cw[2][2];
#pragma unroll
  for (int zi = 0; zi < 2; ++zi) {
#pragma unroll
    for (int yi = 0; yi < 2; ++yi) cw[zi][yi] = rnd_if(BF16, acc_wyz[zi][yi]);
  }
  const float* az = A[2];
  const float* ay = A[1];
  ct[0] = present[0] ? __fsub_rn(ct_wx[1], ct_wx[0]) : 0.0f;
  ct[1] = present[1]
      ? __fsub_rn(__fadd_rn(__fmul_rn(cw[0][1], az[0]), __fmul_rn(cw[1][1], az[1])),
                  __fadd_rn(__fmul_rn(cw[0][0], az[0]), __fmul_rn(cw[1][0], az[1])))
      : 0.0f;
  ct[2] = present[2]
      ? __fsub_rn(__fadd_rn(__fmul_rn(cw[1][0], ay[0]), __fmul_rn(cw[1][1], ay[1])),
                  __fadd_rn(__fmul_rn(cw[0][0], ay[0]), __fmul_rn(cw[0][1], ay[1])))
      : 0.0f;
}

// Lower corner g0, fraction f and df/dx of x in one level
// (encode_input_grad_plain _axis_terms): df/dx = res (res - 1 with
// align_corners), half of it where the clip bound is met exactly
// (jnp.clip's tie), none beyond it, times the smoothstep derivative.
__device__ __forceinline__ void level_cell_grad(const Level& l,
                                                const float x[3],
                                                int align_corners,
                                                int smoothstep, uint32_t g0[3],
                                                float f[3], float dfdx[3]) {
  const float top = (float)(l.res - 1);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float pos, gf, dpos;
    if (align_corners) {
      pos = __fmul_rn(x[d], top);
      gf = fminf(floorf(pos), (float)(l.res - 2));
      dpos = top;
    } else {
      const float raw = __fsub_rn(__fmul_rn(x[d], (float)l.res), 0.5f);
      pos = fminf(fmaxf(raw, 0.0f), top);
      gf = floorf(pos);
      const float share = (raw > 0.0f && raw < top) ? 1.0f
          : ((raw == 0.0f || raw == top) ? 0.5f : 0.0f);
      dpos = __fmul_rn(share, (float)l.res);
    }
    const float tt = __fsub_rn(pos, gf);
    if (smoothstep) {
      f[d] = __fmul_rn(__fmul_rn(tt, tt), __fsub_rn(3.0f, __fmul_rn(2.0f, tt)));
      dfdx[d] = __fmul_rn(dpos, __fmul_rn(__fmul_rn(6.0f, tt), __fsub_rn(1.0f, tt)));
    } else {
      f[d] = tt;
      dfdx[d] = dpos;
    }
    g0[d] = (uint32_t)(int)gf;
  }
}

// No launch bounds: with __launch_bounds__(256) ptxas caps the C >= 4
// instantiations at 64 registers and spills; (256, 1) lets them take
// 92-96 and keeps 2 blocks an SM; without, they take 64-79, spill nothing
// and keep 3 (as fast as the spilling build, PERF.md).
template <int C, bool BF16>
__global__ void
encode_input_grad_kernel(const float* __restrict__ x01,
                         const float* __restrict__ table,
                         const void* __restrict__ g,
                         const int64_t* __restrict__ levels,
                         float* __restrict__ grad, int64_t B, int L, int m,
                         int align_corners, int smoothstep) {
  constexpr int G = kGroup<C>, Q = kQuad<C>;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t b = t / G;
  if (b >= B) return;  // whole groups: G divides the warp
  const int j = (int)(t % G);
  const unsigned gmask = group_mask<G>();
  const float* tq = table + 4 * j;  // this thread's channels of row 0
  float x[3];
  bool inb = true;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    x[d] = x01[b * 3 + d];
    inb = inb && (x[d] >= 0.0f) && (x[d] <= 1.0f);  // false for NaN
  }
  float gx[3] = {0.0f, 0.0f, 0.0f};
  if (inb) {  // uniform within the group
    for (int lv = 0; lv < L; ++lv) {
      const Level l = load_level(levels + lv * kLevelRow);
      uint32_t g0[3];
      float f[3], dfdx[3];
      level_cell_grad(l, x, align_corners, smoothstep, g0, f, dfdx);
      float gv[Q];
      load_g_quad<C, BF16>(g, (b * L + lv) * C + 4 * j, gv);
      int rows[8];
      level_rows<G>(l, j, gmask, BitCorners{{g0[0], g0[1], g0[2]}, l.res - 1},
                    rows);
      float ct[3];
      if (lv < m) {
        mm_level_ct<C, BF16>(tq, rows, g0, f, l.res, gv, gmask, ct);
      } else {
        window_level_ct<C, BF16>(tq, rows, f, gv, gmask, ct);
      }
#pragma unroll
      for (int d = 0; d < 3; ++d) gx[d] = __fadd_rn(gx[d], __fmul_rn(ct[d], dfdx[d]));
    }
  }
  if (j == 0) {
#pragma unroll
    for (int d = 0; d < 3; ++d) grad[b * 3 + d] = gx[d];
  }
}

template <int C>
void launch_input_grad(bool bf16, const float* x01, const float* table,
                       const void* g, const int64_t* levels, float* grad,
                       int64_t B, int L, int m, int align_corners,
                       int smoothstep, cudaStream_t s) {
  const int64_t n = B * kGroup<C>;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  if (bf16) {
    encode_input_grad_kernel<C, true><<<blocks, kThreads, 0, s>>>(
        x01, table, g, levels, grad, B, L, m, align_corners, smoothstep);
  } else {
    encode_input_grad_kernel<C, false><<<blocks, kThreads, 0, s>>>(
        x01, table, g, levels, grad, B, L, m, align_corners, smoothstep);
  }
}


// The input gradient differentiated in its cotangent g (the orientation
// loss's second-order term, hash_fused.py:760-778 under jax.grad): for a
// cotangent ct of grad_x01 [B, 3], ct_g = sum_d ct_d df/dx_d d(grad_x01_d)
// / dg, the encode's JVP along the positions with the table frozen. It is
// the forward with each interpolation weight replaced by its directional
// derivative along u = ct * df/dx: on a window level the tangents (dw0,
// dw1) of each window's weights (the product rule in for_each_window's
// order) through the forward's chain (window_bf16 under bf16, where XLA's
// transpose of the bf16 casts rounds them), on a dense level the transpose
// of _mm_level_ct's chain: per x lane rnd(rnd(dwx) rnd(Z) + rnd(Y) rnd(wx))
// with Z = rnd(sum_yz rnd(wyz) rnd(T)) and Y = rnd(sum_yz rnd(dwyz) rnd(T)),
// the two lanes added in f32. Each (point, level) is one group of
// ceil(C/4) threads, writing its channel quad once: no atomics (the
// layout: encode_input_jvp_kernel). 0 outside [0, 1]^3 and on NaN.
//
// A one-corner window (a level that is not pairable) still loads its
// second row, whose weight tangent is 0 except at the top clamp: JAX
// forms rnd(T * 0) there, NaN where T is inf or NaN, so skipping the load
// would change the bits on a non-finite table. The row is adjacent to the
// first, mostly in the same 32-byte sector; skipping it on a finite table
// measured 14-20% off the JVP on the -O grid (PERF.md).
template <typename Fn>
__device__ __forceinline__ void for_each_window_tangent(const Level& l,
                                                        const int rows[8],
                                                        const float f[3],
                                                        const float u[3],
                                                        int top, Fn&& fn) {
  const int a = l.axis;
  const int o0 = a == 0 ? 1 : 0, o1 = a == 2 ? 1 : 2;
  const float fa = sel3(f, a), ua = sel3(u, a);
  const float f0 = sel3(f, o0), u0 = sel3(u, o0);
  const float f1 = sel3(f, o1), u1 = sel3(u, o1);
  const float fa1 = __fsub_rn(1.0f, fa);
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const float p0 = (h & 1) ? f0 : __fsub_rn(1.0f, f0);
    const float d0 = (h & 1) ? u0 : -u0;
    const float p1 = (h & 2) ? f1 : __fsub_rn(1.0f, f1);
    const float d1 = (h & 2) ? u1 : -u1;
    const float w_rest = __fmul_rn(p0, p1);
    const float dw_rest = __fadd_rn(__fmul_rn(d0, p1), __fmul_rn(p0, d1));
    const float dw_u = __fadd_rn(__fmul_rn(-ua, w_rest), __fmul_rn(fa1, dw_rest));
    const float dw_v = __fadd_rn(__fmul_rn(ua, w_rest), __fmul_rn(fa, dw_rest));
    const int ru = rows[2 * h], rv = rows[2 * h + 1];
    if (l.pairable) {
      const int bb = min(min(ru, rv), top);
      fn(bb, __fadd_rn(ru == bb ? dw_u : 0.0f, rv == bb ? dw_v : 0.0f),
         __fadd_rn(ru == bb + 1 ? dw_u : 0.0f, rv == bb + 1 ? dw_v : 0.0f));
    } else {
      const int bu = min(ru, top), bv = min(rv, top);
      fn(bu, ru == bu ? dw_u : 0.0f, ru == bu + 1 ? dw_u : 0.0f);
      fn(bv, rv == bv ? dw_v : 0.0f, rv == bv + 1 ? dw_v : 0.0f);
    }
  }
}

// One window of the f32 JVP: the window's two rows times its weight
// tangents, added, then added to the level's sum.
template <int C>
__device__ __forceinline__ void window_f32(const float* __restrict__ tq,
                                           int bb, float w0, float w1,
                                           float acc[kQuad<C>]) {
  constexpr int Q = kQuad<C>;
  float ta[Q], tb[Q];
  load_quad<C>(tq + (int64_t)bb * C, ta);
  load_quad<C>(tq + (int64_t)bb * C + C, tb);
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    acc[q] = __fadd_rn(acc[q], __fadd_rn(__fmul_rn(w0, ta[q]),
                                         __fmul_rn(w1, tb[q])));
  }
}

// One dense (matmul) level of the JVP, rows in BitCorners order.
template <int C, bool BF16>
__device__ __forceinline__ void mm_level_jvp(const float* __restrict__ tq,
                                             const int rows[8],
                                             const uint32_t g0[3],
                                             const float f[3],
                                             const float u[3], uint32_t res,
                                             float acc[kQuad<C>]) {
  constexpr int Q = kQuad<C>;
  float A[3][2], dA[3][2];
  bool present[3];
  mm_weights(g0, f, res, A, present);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    // the clamped lane's (1 - f) + f has no derivative
    dA[d][0] = present[d] ? -u[d] : 0.0f;
    dA[d][1] = present[d] ? u[d] : 0.0f;
  }
#pragma unroll
  for (int xi = 0; xi < 2; ++xi) {
    const float wx = rnd_if(BF16, A[0][xi]);
    const float dwx = rnd_if(BF16, dA[0][xi]);
    float z[Q], y[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) z[q] = y[q] = 0.0f;
#pragma unroll
    for (int yz = 0; yz < 4; ++yz) {
      const int zi = yz >> 1, yi = yz & 1;
      const float w = rnd_if(BF16, __fmul_rn(A[2][zi], A[1][yi]));
      const float dw = rnd_if(BF16, __fadd_rn(__fmul_rn(dA[2][zi], A[1][yi]),
                                              __fmul_rn(A[2][zi], dA[1][yi])));
      float t[Q];
      load_quad<C>(tq + (int64_t)rows[xi | yi << 1 | zi << 2] * C, t);
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float tr = rnd_if(BF16, t[q]);
        z[q] = __fadd_rn(z[q], __fmul_rn(w, tr));
        y[q] = __fadd_rn(y[q], __fmul_rn(dw, tr));
      }
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const float a = rnd_if(BF16, __fmul_rn(dwx, rnd_if(BF16, z[q])));
      const float b = rnd_if(BF16, __fmul_rn(rnd_if(BF16, y[q]), wx));
      acc[q] = __fadd_rn(acc[q], rnd_if(BF16, __fadd_rn(a, b)));
    }
  }
}

// The JVP's layout. Each group of G = ceil(C/4) threads owns a point and
// walks its levels in order, as the forward does: a layout with each warp
// on one level of 32 / G points (level-major) measured no faster at C = 2
// and 29% slower at C = 16 (PERF.md). Below C = 8 (kJvpStaged, G
// = 1: each lane a point, its 4 or 8 output bytes a level L C elements
// from its neighbour's) it adds:
// - the level table (with the moduli's constants, mod_u32) staged in
//   shared memory once a block;
// - the outputs staged in shared memory level-major ([level][point][C]: a
//   warp's lanes write one contiguous run, no bank conflict), the block
//   then writing its rows [n, L C], one contiguous range of global
//   memory, in 16-byte stores.
// From C = 8 a group's quads of a level are 16 to 128 contiguous bytes
// and the staging measured 4-6% slower at C = 16: each group stores them
// where it stands and reads its levels from the table, as the input
// gradient does.
// Each (point, level) is one group's chain in the order above, so the
// bits are the plain version's.
template <int C>
constexpr bool kJvpStaged = C < 8;

template <bool BF16>
struct OutType { using T = float; };
template <>
struct OutType<true> { using T = __nv_bfloat16; };

__host__ __device__ constexpr int align16(int bytes) {
  return (bytes + 15) & ~15;
}

// Bytes of a block's shared memory: the level table, then the tile of
// `points` points.
__host__ __device__ constexpr int jvp_tile_at(int L) {
  return align16(L * (int)sizeof(Level));
}
__host__ __device__ constexpr int jvp_smem_bytes(int L, int C, int points,
                                                 int out_bytes) {
  return jvp_tile_at(L) + points * L * C * out_bytes;
}

// The block's tile ([L][np][C] in shared memory) to its n rows of out: 16
// bytes a thread and store, each read from shared memory in runs of one
// (point, level)'s channels (U elements, fewer than 16 bytes where C is
// small); the last bytes of a block whose rows end off a 16-byte boundary
// one element a thread.
template <int C, bool BF16>
__device__ __forceinline__ void jvp_store_tile(
    const typename OutType<BF16>::T* __restrict__ tile,
    typename OutType<BF16>::T* __restrict__ dst, int n, int np, int L) {
  using T = typename OutType<BF16>::T;
  constexpr int E = 16 / (int)sizeof(T);     // elements a 16-byte chunk
  constexpr int U = C < E ? C : E;           // elements a shared read
  constexpr int UB = U * (int)sizeof(T);     // 2, 4, 8 or 16 bytes
  const int n_el = n * L * C;
  // element e of the block's rows -> its place in the tile
  auto at = [&](int e) {
    const int q = e / C;                     // point * L + level
    const int pt = q / L, lv = q - pt * L;
    return (lv * np + pt) * C + (e - q * C);
  };
  for (int k = threadIdx.x; k < n_el / E; k += blockDim.x) {
    uint32_t w[4];
#pragma unroll
    for (int u = 0; u < E / U; ++u) {
      const T* src = tile + at(k * E + u * U);
      if constexpr (UB == 16) {
        const uint4 v = *reinterpret_cast<const uint4*>(src);
        w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
      } else if constexpr (UB == 8) {
        const uint2 v = *reinterpret_cast<const uint2*>(src);
        w[2 * u] = v.x; w[2 * u + 1] = v.y;
      } else if constexpr (UB == 4) {
        w[u] = *reinterpret_cast<const uint32_t*>(src);
      } else {
        const uint32_t h = *reinterpret_cast<const uint16_t*>(src);
        w[u >> 1] = (u & 1) ? (w[u >> 1] | h << 16) : h;
      }
    }
    *reinterpret_cast<uint4*>(dst + (int64_t)k * E) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
  for (int e = n_el / E * E + threadIdx.x; e < n_el; e += blockDim.x) {
    dst[e] = tile[at(e)];
  }
}

// No launch bounds, as the input gradient's kernel; the block size comes
// from launch_input_jvp (a multiple of 32 from 32 to kThreads).
template <int C, bool BF16>
__global__ void
encode_input_jvp_kernel(const float* __restrict__ x01,
                        const float* __restrict__ table,
                        const float* __restrict__ ct_x,
                        const int64_t* __restrict__ levels,
                        void* __restrict__ out, int64_t B, int L, int m,
                        int top, int align_corners, int smoothstep) {
  using T = typename OutType<BF16>::T;
  constexpr int G = kGroup<C>, Q = kQuad<C>;
  constexpr bool kStaged = kJvpStaged<C>;
  extern __shared__ __align__(16) unsigned char jvp_smem[];
  const int np = blockDim.x / G;            // the block's tile of points
  Level* lvl = reinterpret_cast<Level*>(jvp_smem);
  T* tile = reinterpret_cast<T*>(jvp_smem + jvp_tile_at(L));
  const int64_t b0 = (int64_t)blockIdx.x * np;
  const int64_t rest = B - b0;
  const int n = rest < np ? (int)rest : np;  // the block's points
  if constexpr (kStaged) {
    for (int i = threadIdx.x; i < L; i += blockDim.x) {
      lvl[i] = load_level(levels + i * kLevelRow);
    }
    __syncthreads();
  }
  const int p = threadIdx.x / G, j = threadIdx.x % G;
  if (p < n) {  // whole groups: G divides the warp
    const int64_t b = b0 + p;
    const unsigned gmask = group_mask<G>();
    const float* tq = table + 4 * j;  // this thread's channels of row 0
    float x[3], ct[3];
    bool inb = true;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      x[d] = x01[b * 3 + d];
      ct[d] = ct_x[b * 3 + d];
      inb = inb && (x[d] >= 0.0f) && (x[d] <= 1.0f);  // false for NaN
    }
    for (int lv = 0; lv < L; ++lv) {
      float acc[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) acc[q] = 0.0f;
      if (inb) {  // uniform within the group
        const Level l = kStaged ? lvl[lv]
                                : load_level(levels + lv * kLevelRow);
        uint32_t g0[3];
        float f[3], dfdx[3], u[3];
        level_cell_grad(l, x, align_corners, smoothstep, g0, f, dfdx);
#pragma unroll
        for (int d = 0; d < 3; ++d) u[d] = __fmul_rn(ct[d], dfdx[d]);
        int rows[8];
        if (lv < m) {
          level_rows<G>(l, j, gmask,
                        BitCorners{{g0[0], g0[1], g0[2]}, l.res - 1}, rows);
          mm_level_jvp<C, BF16>(tq, rows, g0, f, u, l.res, acc);
        } else {
          level_rows<G>(l, j, gmask,
                        WindowCorners{{g0[0], g0[1], g0[2]}, l.res - 1,
                                      l.axis},
                        rows);
          for_each_window_tangent(l, rows, f, u, top,
                                  [&](int bb, float w0, float w1) {
            if (BF16) {
              window_bf16<C>(tq, bb, w0, w1, acc);
            } else {
              window_f32<C>(tq, bb, w0, w1, acc);
            }
          });
        }
      }
      if constexpr (kStaged) {
        store_quad<C, BF16>(tile, (lv * np + p) * C + 4 * j, acc);
      } else {
        store_quad<C, BF16>(out, (b * L + lv) * C + 4 * j, acc);
      }
    }
  }
  if constexpr (kStaged) {
    __syncthreads();
    jvp_store_tile<C, BF16>(tile, static_cast<T*>(out) + b0 * L * C, n, np,
                            L);
  }
}

template <int C>
int launch_input_jvp(bool bf16, const float* x01, const float* table,
                     const float* ct_x, const int64_t* levels, void* out,
                     int64_t B, int L, int m, int top, int align_corners,
                     int smoothstep, cudaStream_t s) {
  // staged: the largest block (kThreads down to one warp) whose tile fits
  // in the 48 KB of shared memory a block takes without opting in
  const int out_bytes = bf16 ? 2 : 4;
  int threads = kThreads;
  while (kJvpStaged<C> && threads > 32
         && jvp_smem_bytes(L, C, threads / kGroup<C>, out_bytes) > 48 * 1024) {
    threads /= 2;
  }
  const int np = threads / kGroup<C>;
  const int smem = kJvpStaged<C> ? jvp_smem_bytes(L, C, np, out_bytes) : 0;
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = (unsigned)((B + np - 1) / np);
  if (bf16) {
    encode_input_jvp_kernel<C, true><<<blocks, threads, smem, s>>>(
        x01, table, ct_x, levels, out, B, L, m, top, align_corners,
        smoothstep);
  } else {
    encode_input_jvp_kernel<C, false><<<blocks, threads, smem, s>>>(
        x01, table, ct_x, levels, out, B, L, m, top, align_corners,
        smoothstep);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x01 [B, 3] f32, table [n_params * C] f32 (16-byte aligned), ct_x [B, 3]
// f32 (the cotangent of the input gradient), levels [L, kLevelRow] i64 (m
// dense matmul levels first, top = n_params - 2) -> out [B, L * C] f32 or
// bf16 (16-byte aligned), the cotangent of the input gradient's g. B > 0.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for an unsupported C
// or, below C = 8, a one-warp block's tile beyond 48 KB of shared memory
// (past 85 levels at C = 4 in f32).
extern "C" int hash_encode_input_jvp(const float* x01, const float* table,
                                     const float* ct_x,
                                     const int64_t* levels, void* out,
                                     int64_t B, int L, int C, int m, int top,
                                     int align_corners, int smoothstep,
                                     int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool h = bf16 != 0;
  switch (C) {
#define RAW_NGP_CASE(c)                                                      \
    case c:                                                                  \
      return launch_input_jvp<c>(h, x01, table, ct_x, levels, out, B, L, m,  \
                                 top, align_corners, smoothstep, s);
    RAW_NGP_CASE(1) RAW_NGP_CASE(2) RAW_NGP_CASE(4) RAW_NGP_CASE(8)
    RAW_NGP_CASE(16) RAW_NGP_CASE(32)
#undef RAW_NGP_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x01 [B, 3] f32, table [n_params * C] f32 (16-byte aligned), g [B, L * C]
// (bf16 if bf16, else f32), levels [L, kLevelRow] i64, m matmul levels ->
// grad [B, 3] f32 (B > 0). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for an unsupported C.
extern "C" int hash_encode_bwd_input(const float* x01, const float* table,
                                     const void* g, const int64_t* levels,
                                     float* grad, int64_t B, int L, int C,
                                     int m, int align_corners, int smoothstep,
                                     int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool h = bf16 != 0;
  switch (C) {
    case 1: launch_input_grad<1>(h, x01, table, g, levels, grad, B, L, m, align_corners, smoothstep, s); break;
    case 2: launch_input_grad<2>(h, x01, table, g, levels, grad, B, L, m, align_corners, smoothstep, s); break;
    case 4: launch_input_grad<4>(h, x01, table, g, levels, grad, B, L, m, align_corners, smoothstep, s); break;
    case 8: launch_input_grad<8>(h, x01, table, g, levels, grad, B, L, m, align_corners, smoothstep, s); break;
    case 16: launch_input_grad<16>(h, x01, table, g, levels, grad, B, L, m, align_corners, smoothstep, s); break;
    case 32: launch_input_grad<32>(h, x01, table, g, levels, grad, B, L, m, align_corners, smoothstep, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// x01 [B, 3] f32, table [n_params * C] f32 (16-byte aligned),
// levels [L, kLevelRow] i64 (m dense matmul levels first, top =
// n_params - 2) -> out [B, L * C] f32 or bf16 (16-byte aligned); with
// base and w_word not null also the records of the window levels m..L-1,
// base [P, B] i32 and w_word [P, B] u32 (P windows in all). B > 0.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for an unsupported C.
extern "C" int hash_encode_fwd(const float* x01, const float* table,
                               const int64_t* levels, void* out,
                               int32_t* base, uint32_t* w_word, int64_t B,
                               int L, int C, int m, int top, int align_corners,
                               int smoothstep, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool h = bf16 != 0;
  const bool rec = base != nullptr && w_word != nullptr;
  switch (C) {
#define RAW_NGP_CASE(c)                                                      \
    case c:                                                                  \
      if (rec) {                                                             \
        launch<c, true>(h, x01, table, levels, out, base, w_word, B, L, m,   \
                        top, align_corners, smoothstep, s);                  \
      } else {                                                               \
        launch<c, false>(h, x01, table, levels, out, base, w_word, B, L, m,  \
                         top, align_corners, smoothstep, s);                 \
      }                                                                      \
      break;
    RAW_NGP_CASE(1) RAW_NGP_CASE(2) RAW_NGP_CASE(4) RAW_NGP_CASE(8)
    RAW_NGP_CASE(16) RAW_NGP_CASE(32)
#undef RAW_NGP_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
