// Multiresolution hash-grid encode, forward, and the records of its
// backward, for Hopper (sm_90a).
//
// Replaces the encode that the JAX package runs through XLA in
// raw_ngp_tpu/kernels/hash_fused.py (hash_encode_fused / _fused_fwd: the
// matmul path for dense leading levels and the 2-row vrow-window gathers
// for the rest), which stands in for the reference's hand-written CUDA
// gridencoder. Its plain version is
// raw_ngp_torch/kernels/hash_encode.hash_encode_fused_plain.
//
// One thread per (point, level): it computes the corner rows with the
// _level_indices index math in native uint32 (dense-stride early-out, xor
// and additive variants) and loads each row's C channels as float4.
// Inputs outside [0, 1]^3 or NaN give zeros. In f32 it sums the 8 corner
// values x trilinear weights in f32 (ops/hashgrid.hash_encode_01). Under
// bf16 it takes the JAX fused encoder's rounding chain, bit for bit: on a
// window level the windows of the record kernel (point_windows), each lane
// product rounded, each window's two rows added and rounded, the windows
// summed in f32 (_window_forward); on a dense matmul level the partial
// interpolation Z per x lane rounded, then Z x rnd(wx) rounded, the x
// lanes summed (_mm_forward); the f32 level sum is rounded once by the
// store, which writes the C bf16 outputs as 16-byte vectors. Position,
// weight and bf16 arithmetic use the _rn intrinsics so nvcc cannot
// contract them into FMAs: the cell, fraction and every rounded product
// must round exactly as the plain version's separate operations.
//
// The same file holds the record kernel of the encode's backward,
// window_records: it writes the residuals of hash_fused._fused_fwd
// (_window_indices_weights, the 2-row windows of every level that is not
// on the dense matmul path) as base [P, B] i32 and the (w0, w1) pair of
// each window as one word of two truncated bf16 halves [P, B] (the
// _pack_bf16_pairs word the table gradient sorts and sums, see
// csrc/segsum.cu). Its weight products follow the JAX order (pair axis
// last, the other axes in index order) so the truncated halves match bit
// for bit (point_windows, shared with the bf16 forward). It is bound by
// bytes too: it reads the points and writes two words per window (8.4 MB
// at the flagship's 262,144 points, 4 windows).
//
// The file also holds the input gradient of the encode,
// hash_encode_bwd_input (pose refinement). It replaces the VJP that JAX
// takes through the interpolation weights with the table frozen
// (hash_fused.py _fused_bwd, need_input_grads, :760-778), which stands in
// for the reference gridencoder's dy_dx contraction. One thread per point
// loops over the L levels in registers and writes grad_x [B, 3] f32 once:
// no atomics, deterministic. Per level it recomputes the cell and the
// fractions exactly as the record kernel does, reads the 8 corner rows and
// contracts each with the level's cotangent g. On a window level the
// corner value is V = sum_c rnd(g_c * T_c) (JAX's per-window cotangent)
// and d/df_d = sum over the other axes' corners of (V[d=1] - V[d=0]) x
// their weights; on a dense matmul level the kernel follows JAX's
// _mm_forward chain instead (partial interpolations Z per x lane, the
// weight cotangents rounded where the bf16 matmuls round them). Then the
// chain rule: df/dx = res (res - 1 with align_corners), half of it where
// the clip bound is met exactly (jnp.clip's tie), none beyond it, times
// the smoothstep derivative; 0 outside [0, 1]^3. Under bf16, rnd rounds to
// bf16 and the table is read rounded, as JAX's VJP reads it; in f32 rnd
// is the identity. Every product and sum uses the _rn intrinsics in the
// plain version's order (kernels/hash_encode.py encode_input_grad_plain),
// so nvcc cannot contract them into FMAs. Bound: bytes: the touched rows
// (the forward's), g (B x L x C bf16), x01 and grad_x; the flagship's
// B = 262,144 uniform points touch 517,036 rows and move 56,158,976 B,
// 16.8 us at 3.35 TB/s (chip_smoke.py counts them from its inputs).
//
// Bound: bytes, as a gather. Each (point, level) reads 8 rows of C floats
// at hashed addresses; the flagship's level-1 table (524,288 x 16 f32 =
// 33.5 MB) fits in the 50 MB L2, so after first touch the gathers are L2
// hits and DRAM sees the touched rows once plus the points and the output.
// Threads with neighbouring ids share a point, so the output stores of a
// warp are contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// per-level row of the level table built by the Python wrapper
// (raw_ngp_torch/kernels/hash_encode.py _level_table):
// res, hmap, offset, n_strides, stride0, stride1, stride2, mode, axis,
// pairable, first window (records kernel; -1 on the matmul levels)
constexpr int kLevelRow = 11;
constexpr int kModeStride = 0, kModeXor = 1, kModeAdditive = 2;

__device__ __forceinline__ uint32_t mix_prime(int d) {
  // _mix_prime: dim 0 borrows the 4th prime since the 1st is 1
  return d == 0 ? 3674653429u : (d == 1 ? 2654435761u : 805459861u);
}

__device__ __forceinline__ uint32_t level_row(const int64_t* lp,
                                              const uint32_t c[3]) {
  const uint32_t res = (uint32_t)lp[0];
  const uint32_t hmap = (uint32_t)lp[1];
  const int mode = (int)lp[7];
  uint32_t index = 0;
  if (mode == kModeAdditive) {
    const int a = (int)lp[8];
    uint32_t g = 0;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      if (d != a) g ^= c[d] * mix_prime(d);
    }
    index = c[a] + g % (hmap - res);
  } else if (mode == kModeXor) {
    index = c[0] ^ (c[1] * 2654435761u) ^ (c[2] * 805459861u);
  } else {
    const int ns = (int)lp[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      if (d < ns) index += c[d] * (uint32_t)lp[4 + d];
    }
  }
  return index % hmap + (uint32_t)lp[2];
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The 2-row windows of one (point, level) (hash_fused._window_indices_weights,
// D = 3): 4 windows of two adjacent rows when the level is pairable, else 8
// one-corner windows, in JAX's window order (h over the two non-pair axes,
// then the corner u, v of a non-pairable level). bs is each window's first
// row (clamped to top = n_params - 2), w0/w1 the f32 weights routed to
// rows bs and bs + 1, multiplied in JAX's order (pair axis last, the other
// axes in index order) so they match bit for bit. Returns the count.
__device__ __forceinline__ int point_windows(const int64_t* lp,
                                             const uint32_t g[3],
                                             const float f[3], float inb_f,
                                             int top, int bs[8], float w0s[8],
                                             float w1s[8]) {
  const uint32_t res = (uint32_t)lp[0];
  const int a = (int)lp[8];
  const bool pairable = lp[9] != 0;
  int rest[2];
  for (int d = 0, j = 0; d < 3; ++d) {
    if (d != a) rest[j++] = d;
  }
  const uint32_t a_lo = g[a];
  const uint32_t a_hi = min(a_lo + 1, res - 1);
  const float fa = f[a];
  const float fa1 = __fsub_rn(1.0f, fa);
  int n = 0;
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    uint32_t c[3];
    float w_rest = inb_f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int d = rest[j];
      const uint32_t bit = (h >> j) & 1u;
      c[d] = min(g[d] + bit, res - 1);
      w_rest = __fmul_rn(w_rest, bit ? f[d] : __fsub_rn(1.0f, f[d]));
    }
    c[a] = a_lo;
    const int u = (int)level_row(lp, c);
    c[a] = a_hi;
    const int v = (int)level_row(lp, c);
    const float w_u = __fmul_rn(fa1, w_rest);
    const float w_v = __fmul_rn(fa, w_rest);
    if (pairable) {
      const int bb = min(min(u, v), top);
      bs[n] = bb;
      w0s[n] = __fadd_rn(u == bb ? w_u : 0.0f, v == bb ? w_v : 0.0f);
      w1s[n] = __fadd_rn(u == bb + 1 ? w_u : 0.0f, v == bb + 1 ? w_v : 0.0f);
      ++n;
    } else {
      const int idx[2] = {u, v};
      const float w[2] = {w_u, w_v};
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int bb = min(idx[k], top);
        bs[n] = bb;
        w0s[n] = idx[k] == bb ? w[k] : 0.0f;
        w1s[n] = idx[k] == bb + 1 ? w[k] : 0.0f;
        ++n;
      }
    }
  }
  return n;
}

// Channels [k0, k0 + 4) of a table row, as one float4 where C allows it.
template <int C>
__device__ __forceinline__ float4 load4(const float* __restrict__ row,
                                        int k0) {
  if constexpr (C % 4 == 0) {
    return __ldg(reinterpret_cast<const float4*>(row + k0));
  } else {
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k0 + k < C) v[k] = __ldg(row + k0 + k);
    }
    return make_float4(v[0], v[1], v[2], v[3]);
  }
}

// One window level of the bf16 forward, _window_forward's chain: each lane
// product rnd(rnd(T) * rnd(w)), the window's two rows added and rounded,
// the windows summed in f32 in window order (XLA's CPU reduce accumulates
// its bf16 sum in f32 and rounds once, tested bit for bit against JAX).
template <int C>
__device__ __forceinline__ void window_level_bf16(
    const float* __restrict__ table, const int64_t* lp, const uint32_t g[3],
    const float f[3], int top, float acc[C]) {
  int bs[8];
  float w0s[8], w1s[8];
  const int n = point_windows(lp, g, f, 1.0f, top, bs, w0s, w1s);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (k >= n) break;
    const float* r0 = table + (int64_t)bs[k] * C;
    const float wa = round_bf16(w0s[k]);
    const float wb = round_bf16(w1s[k]);
#pragma unroll
    for (int q = 0; q < (C + 3) / 4; ++q) {
      const float4 ta = load4<C>(r0, 4 * q);
      const float4 tb = load4<C>(r0 + C, 4 * q);
      const float va[4] = {ta.x, ta.y, ta.z, ta.w};
      const float vb[4] = {tb.x, tb.y, tb.z, tb.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (4 * q + j >= C) break;
        const float pa = round_bf16(__fmul_rn(round_bf16(va[j]), wa));
        const float pb = round_bf16(__fmul_rn(round_bf16(vb[j]), wb));
        acc[4 * q + j] = __fadd_rn(acc[4 * q + j],
                                   round_bf16(__fadd_rn(pa, pb)));
      }
    }
  }
}

// One dense (matmul) level of the bf16 forward, _mm_forward's chain: per x
// lane Z = rnd(sum_yz rnd(wz wy) rnd(T)) over the yz lanes in XLA's order
// (z-major, then y; f32 sum, rounded once), then rnd(Z rnd(wx)), the two x
// lanes added in f32 (the final rounding is the store's). A clamped lane
// weighs 0 and the lane below it (1 - f) + f, as _mm_axis_weights merges.
template <int C>
__device__ __forceinline__ void mm_level_bf16(const float* __restrict__ table,
                                              const int64_t* lp,
                                              const uint32_t g[3],
                                              const float f[3], float acc[C]) {
  const uint32_t res = (uint32_t)lp[0];
  uint32_t cl[3][2];
  float A[3][2];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    cl[d][0] = g[d];
    cl[d][1] = min(g[d] + 1, res - 1);
    const bool present = cl[d][1] != cl[d][0];
    const float a0 = __fsub_rn(1.0f, f[d]);
    A[d][0] = present ? a0 : __fadd_rn(a0, f[d]);
    A[d][1] = present ? f[d] : 0.0f;
  }
#pragma unroll
  for (int xi = 0; xi < 2; ++xi) {
    float z[C];
#pragma unroll
    for (int k = 0; k < C; ++k) z[k] = 0.0f;
#pragma unroll
    for (int yz = 0; yz < 4; ++yz) {
      const int zi = yz >> 1, yi = yz & 1;
      const float w = round_bf16(__fmul_rn(A[2][zi], A[1][yi]));
      const uint32_t c[3] = {cl[0][xi], cl[1][yi], cl[2][zi]};
      const float* row = table + (int64_t)level_row(lp, c) * C;
#pragma unroll
      for (int q = 0; q < (C + 3) / 4; ++q) {
        const float4 t4 = load4<C>(row, 4 * q);
        const float t[4] = {t4.x, t4.y, t4.z, t4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (4 * q + j >= C) break;
          z[4 * q + j] = __fadd_rn(z[4 * q + j],
                                   __fmul_rn(w, round_bf16(t[j])));
        }
      }
    }
    const float wx = round_bf16(A[0][xi]);
#pragma unroll
    for (int k = 0; k < C; ++k) {
      acc[k] = __fadd_rn(acc[k], round_bf16(__fmul_rn(round_bf16(z[k]), wx)));
    }
  }
}

// The C bf16 outputs of one (point, level), rounded from f32, written as
// 16-byte stores (one store of 2C bytes below C = 8).
template <int C>
__device__ __forceinline__ void store_bf16(__nv_bfloat16* dst,
                                           const float acc[C]) {
  if constexpr (C == 1) {
    dst[0] = __float2bfloat16_rn(acc[0]);
  } else {
    uint32_t w[C / 2];
#pragma unroll
    for (int k = 0; k < C / 2; ++k) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(acc[2 * k],
                                                     acc[2 * k + 1]);
      w[k] = *reinterpret_cast<const uint32_t*>(&p);
    }
    if constexpr (C >= 8) {
      uint4* d4 = reinterpret_cast<uint4*>(dst);
#pragma unroll
      for (int k = 0; k < C / 8; ++k) {
        d4[k] = make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
      }
    } else if constexpr (C == 4) {
      *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
    } else {
      *reinterpret_cast<uint32_t*>(dst) = w[0];
    }
  }
}

template <int C, bool BF16>
__global__ void hash_encode_kernel(const float* __restrict__ x01,
                                   const float* __restrict__ table,
                                   const int64_t* __restrict__ levels,
                                   void* __restrict__ out, int64_t B, int L,
                                   int m, int top, int align_corners,
                                   int smoothstep) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B * L) return;
  const int64_t b = t / L;
  const int lv = (int)(t - b * L);
  const int64_t* lp = levels + lv * kLevelRow;

  float x[3];
  bool inb = true;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    x[d] = x01[b * 3 + d];
    inb = inb && (x[d] >= 0.0f) && (x[d] <= 1.0f);  // false for NaN
  }

  float acc[C];
#pragma unroll
  for (int k = 0; k < C; ++k) acc[k] = 0.0f;

  if (inb) {
    const uint32_t res = (uint32_t)lp[0];
    const float top_f = (float)(res - 1);
    float frac[3];
    uint32_t g[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      float pos, gf;
      if (align_corners) {
        pos = __fmul_rn(x[d], top_f);
        gf = fminf(floorf(pos), (float)(res - 2));
      } else {
        pos = __fsub_rn(__fmul_rn(x[d], (float)res), 0.5f);
        pos = fminf(fmaxf(pos, 0.0f), top_f);
        gf = floorf(pos);
      }
      float f = __fsub_rn(pos, gf);
      if (smoothstep) {
        f = __fmul_rn(__fmul_rn(f, f), __fsub_rn(3.0f, __fmul_rn(2.0f, f)));
      }
      frac[d] = f;
      g[d] = (uint32_t)(int)gf;
    }
    if (BF16) {
      if (lv < m) {
        mm_level_bf16<C>(table, lp, g, frac, acc);
      } else {
        window_level_bf16<C>(table, lp, g, frac, top, acc);
      }
    } else {
#pragma unroll
      for (int corner = 0; corner < 8; ++corner) {
        uint32_t c[3];
        float w = 1.0f;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const uint32_t bit = (corner >> d) & 1u;
          c[d] = min(g[d] + bit, res - 1);
          const float fd = bit ? frac[d] : __fsub_rn(1.0f, frac[d]);
          w = d == 0 ? fd : __fmul_rn(w, fd);
        }
        const float* row = table + (int64_t)level_row(lp, c) * C;
        if constexpr (C % 4 == 0) {
          const float4* row4 = reinterpret_cast<const float4*>(row);
#pragma unroll
          for (int k = 0; k < C / 4; ++k) {
            const float4 v = __ldg(row4 + k);
            acc[4 * k + 0] += v.x * w;
            acc[4 * k + 1] += v.y * w;
            acc[4 * k + 2] += v.z * w;
            acc[4 * k + 3] += v.w * w;
          }
        } else {
#pragma unroll
          for (int k = 0; k < C; ++k) acc[k] += __ldg(row + k) * w;
        }
      }
    }
  }

  const int64_t o = t * C;  // out[b, lv*C + k] == out[(b*L + lv)*C + k]
  if (BF16) {
    store_bf16<C>(static_cast<__nv_bfloat16*>(out) + o, acc);
  } else {
    float* dst = static_cast<float*>(out) + o;
    if constexpr (C % 4 == 0) {
      float4* dst4 = reinterpret_cast<float4*>(dst);
#pragma unroll
      for (int k = 0; k < C / 4; ++k) {
        dst4[k] = make_float4(acc[4 * k], acc[4 * k + 1], acc[4 * k + 2],
                              acc[4 * k + 3]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < C; ++k) dst[k] = acc[k];
    }
  }
}

template <int C>
void launch(bool bf16, const float* x01, const float* table,
            const int64_t* levels, void* out, int64_t B, int L, int m,
            int top, int align_corners, int smoothstep, cudaStream_t s) {
  const int64_t n = B * L;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  if (bf16) {
    hash_encode_kernel<C, true><<<blocks, kThreads, 0, s>>>(
        x01, table, levels, out, B, L, m, top, align_corners, smoothstep);
  } else {
    hash_encode_kernel<C, false><<<blocks, kThreads, 0, s>>>(
        x01, table, levels, out, B, L, m, top, align_corners, smoothstep);
  }
}

// Window records of one (point, level): 2^(D-1) windows of two adjacent
// rows when the level is pairable, else 2^D one-corner windows
// (hash_fused._window_indices_weights, D = 3).
__global__ void window_records_kernel(const float* __restrict__ x01,
                                      const int64_t* __restrict__ levels,
                                      int32_t* __restrict__ base,
                                      uint32_t* __restrict__ w_word,
                                      int64_t B, int m, int L, int top,
                                      int align_corners, int smoothstep) {
  const int Lw = L - m;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B * Lw) return;
  const int64_t b = t / Lw;
  const int lv = m + (int)(t - b * Lw);
  const int64_t* lp = levels + lv * kLevelRow;
  const uint32_t res = (uint32_t)lp[0];
  const int64_t win0 = lp[10];

  float x[3];
  bool inb = true;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    x[d] = x01[b * 3 + d];
    inb = inb && (x[d] >= 0.0f) && (x[d] <= 1.0f);  // false for NaN
  }
  const float inb_f = inb ? 1.0f : 0.0f;
  float f[3];
  uint32_t g[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float xd = inb ? x[d] : 0.5f;
    float pos, gf;
    if (align_corners) {
      pos = __fmul_rn(xd, (float)(res - 1));
      gf = fminf(floorf(pos), (float)(res - 2));
    } else {
      pos = __fsub_rn(__fmul_rn(xd, (float)res), 0.5f);
      pos = fminf(fmaxf(pos, 0.0f), (float)(res - 1));
      gf = floorf(pos);
    }
    float fd = __fsub_rn(pos, gf);
    if (smoothstep) {
      fd = __fmul_rn(__fmul_rn(fd, fd), __fsub_rn(3.0f, __fmul_rn(2.0f, fd)));
    }
    f[d] = fd;
    g[d] = (uint32_t)(int)gf;
  }
  int bs[8];
  float w0s[8], w1s[8];
  const int n = point_windows(lp, g, f, inb_f, top, bs, w0s, w1s);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (k >= n) break;
    const int64_t o = (win0 + k) * B + b;
    base[o] = bs[k];
    w_word[o] = (__float_as_uint(w0s[k]) & 0xffff0000u)
                | (__float_as_uint(w1s[k]) >> 16);
  }
}

__device__ __forceinline__ float rnd_if(bool bf16, float v) {
  return bf16 ? round_bf16(v) : v;
}

template <bool BF16>
__device__ __forceinline__ float load_g(const void* g, int64_t i) {
  if (BF16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(g)[i]);
  }
  return static_cast<const float*>(g)[i];
}

// sum_c rnd(gv_c * rnd(T_c)) over one table row, channels in order
template <int C, bool BF16>
__device__ __forceinline__ float row_dot(const float* __restrict__ row,
                                         const float* gv) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const float t = rnd_if(BF16, __ldg(row + k));
    acc = __fadd_rn(acc, rnd_if(BF16, __fmul_rn(gv[k], t)));
  }
  return acc;
}

// d(out_lv . g)/d f_d on a window level (encode_input_grad_plain
// _window_level_ct): corner values, then per axis the differences across
// it weighted by the other two axes' factors, in dimension order.
template <int C, bool BF16>
__device__ void window_level_ct(const float* __restrict__ table,
                                const int64_t* lp, const uint32_t g0[3],
                                const float f[3], const float* gv,
                                float ct[3]) {
  const uint32_t res = (uint32_t)lp[0];
  float V[8];
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    uint32_t c[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) c[d] = min(g0[d] + ((corner >> d) & 1), res - 1);
    V[corner] = row_dot<C, BF16>(table + (int64_t)level_row(lp, c) * C, gv);
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
// chain (encode_input_grad_plain _mm_level_ct). Axis d has lanes c0 = g0
// and c1 = min(g0 + 1, res - 1) with weights (1 - f, f), or, where c1 is
// clamped onto c0, one lane of weight (1 - f) + f (and c1's weight 0).
template <int C, bool BF16>
__device__ void mm_level_ct(const float* __restrict__ table,
                            const int64_t* lp, const uint32_t g0[3],
                            const float f[3], const float* gv, float ct[3]) {
  const uint32_t res = (uint32_t)lp[0];
  uint32_t cl[3][2];
  float A[3][2];
  bool present[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    cl[d][0] = g0[d];
    cl[d][1] = min(g0[d] + 1, res - 1);
    present[d] = cl[d][1] != cl[d][0];
    const float a0 = __fsub_rn(1.0f, f[d]);
    A[d][0] = present[d] ? a0 : __fadd_rn(a0, f[d]);
    A[d][1] = present[d] ? f[d] : 0.0f;
  }
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
    float gw[C], z[C];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      gw[k] = rnd_if(BF16, __fmul_rn(gv[k], wx));
      z[k] = 0.0f;
    }
#pragma unroll
    for (int zi = 0; zi < 2; ++zi) {
#pragma unroll
      for (int yi = 0; yi < 2; ++yi) {
        const uint32_t c[3] = {cl[0][xi], cl[1][yi], cl[2][zi]};
        const float* row = table + (int64_t)level_row(lp, c) * C;
        float a = acc_wyz[zi][yi];
#pragma unroll
        for (int k = 0; k < C; ++k) {
          const float t = rnd_if(BF16, __ldg(row + k));
          z[k] = __fadd_rn(z[k], __fmul_rn(wyz[zi][yi], t));
          a = __fadd_rn(a, __fmul_rn(gw[k], t));
        }
        acc_wyz[zi][yi] = a;
      }
    }
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      s = __fadd_rn(s, rnd_if(BF16, __fmul_rn(gv[k], rnd_if(BF16, z[k]))));
    }
    ct_wx[xi] = s;
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

template <int C, bool BF16>
__global__ void __launch_bounds__(kThreads)
encode_input_grad_kernel(const float* __restrict__ x01,
                         const float* __restrict__ table,
                         const void* __restrict__ g,
                         const int64_t* __restrict__ levels,
                         float* __restrict__ grad, int64_t B, int L, int m,
                         int align_corners, int smoothstep) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float x[3];
  bool inb = true;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    x[d] = x01[b * 3 + d];
    inb = inb && (x[d] >= 0.0f) && (x[d] <= 1.0f);  // false for NaN
  }
  float gx[3] = {0.0f, 0.0f, 0.0f};
  if (inb) {
    for (int lv = 0; lv < L; ++lv) {
      const int64_t* lp = levels + lv * kLevelRow;
      const uint32_t res = (uint32_t)lp[0];
      const float top = (float)(res - 1);
      uint32_t g0[3];
      float f[3], dfdx[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        float pos, gf, dpos;
        if (align_corners) {
          pos = __fmul_rn(x[d], top);
          gf = fminf(floorf(pos), (float)(res - 2));
          dpos = top;
        } else {
          const float raw = __fsub_rn(__fmul_rn(x[d], (float)res), 0.5f);
          pos = fminf(fmaxf(raw, 0.0f), top);
          gf = floorf(pos);
          const float share = (raw > 0.0f && raw < top) ? 1.0f
              : ((raw == 0.0f || raw == top) ? 0.5f : 0.0f);
          dpos = __fmul_rn(share, (float)res);
        }
        const float t = __fsub_rn(pos, gf);
        if (smoothstep) {
          f[d] = __fmul_rn(__fmul_rn(t, t), __fsub_rn(3.0f, __fmul_rn(2.0f, t)));
          dfdx[d] = __fmul_rn(dpos, __fmul_rn(__fmul_rn(6.0f, t), __fsub_rn(1.0f, t)));
        } else {
          f[d] = t;
          dfdx[d] = dpos;
        }
        g0[d] = (uint32_t)(int)gf;
      }
      float gv[C];
      const int64_t go = (b * L + lv) * C;
#pragma unroll
      for (int k = 0; k < C; ++k) gv[k] = load_g<BF16>(g, go + k);
      float ct[3];
      if (lv < m) {
        mm_level_ct<C, BF16>(table, lp, g0, f, gv, ct);
      } else {
        window_level_ct<C, BF16>(table, lp, g0, f, gv, ct);
      }
#pragma unroll
      for (int d = 0; d < 3; ++d) gx[d] = __fadd_rn(gx[d], __fmul_rn(ct[d], dfdx[d]));
    }
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) grad[b * 3 + d] = gx[d];
}

template <int C>
void launch_input_grad(bool bf16, const float* x01, const float* table,
                       const void* g, const int64_t* levels, float* grad,
                       int64_t B, int L, int m, int align_corners,
                       int smoothstep, cudaStream_t s) {
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  if (bf16) {
    encode_input_grad_kernel<C, true><<<blocks, kThreads, 0, s>>>(
        x01, table, g, levels, grad, B, L, m, align_corners, smoothstep);
  } else {
    encode_input_grad_kernel<C, false><<<blocks, kThreads, 0, s>>>(
        x01, table, g, levels, grad, B, L, m, align_corners, smoothstep);
  }
}

}  // namespace

// x01 [B, 3] f32, table [n_params * C] f32, g [B, L * C] (bf16 if bf16,
// else f32), levels [L, kLevelRow] i64, m matmul levels -> grad [B, 3] f32
// (B > 0). Returns cudaGetLastError(), or cudaErrorInvalidValue for an
// unsupported C.
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

// x01 [B, 3] f32, levels [L, kLevelRow] i64 -> base [P, B] i32 and
// w_word [P, B] u32 for the levels m..L-1 (P windows in all; B > 0).
// Returns cudaGetLastError().
extern "C" int hash_encode_records(const float* x01, const int64_t* levels,
                                   int32_t* base, uint32_t* w_word,
                                   int64_t B, int m, int L, int top,
                                   int align_corners, int smoothstep,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n = B * (L - m);
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  window_records_kernel<<<blocks, kThreads, 0, s>>>(
      x01, levels, base, w_word, B, m, L, top, align_corners, smoothstep);
  return static_cast<int>(cudaGetLastError());
}

// x01 [B, 3] f32, table [n_params * C] f32 (16-byte aligned),
// levels [L, kLevelRow] i64 (m dense matmul levels first, top =
// n_params - 2) -> out [B, L * C] f32 or bf16 (16-byte aligned).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for an unsupported C.
extern "C" int hash_encode_fwd(const float* x01, const float* table,
                               const int64_t* levels, void* out, int64_t B,
                               int L, int C, int m, int top, int align_corners,
                               int smoothstep, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool h = bf16 != 0;
  switch (C) {
    case 1: launch<1>(h, x01, table, levels, out, B, L, m, top, align_corners, smoothstep, s); break;
    case 2: launch<2>(h, x01, table, levels, out, B, L, m, top, align_corners, smoothstep, s); break;
    case 4: launch<4>(h, x01, table, levels, out, B, L, m, top, align_corners, smoothstep, s); break;
    case 8: launch<8>(h, x01, table, levels, out, B, L, m, top, align_corners, smoothstep, s); break;
    case 16: launch<16>(h, x01, table, levels, out, B, L, m, top, align_corners, smoothstep, s); break;
    case 32: launch<32>(h, x01, table, levels, out, B, L, m, top, align_corners, smoothstep, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
