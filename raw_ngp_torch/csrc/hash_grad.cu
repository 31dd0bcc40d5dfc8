// Table gradient of the hash-grid encode, for Hopper (sm_90a): the dense
// (matmul) levels' gradient as a scatter, and the two glue passes around
// kernel B2 on the window levels.
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
// before the two [B, 256] operands are even built. The scatter's bound is
// bytes: x01 (12 B a point), the level's slice of g (2C B a point) and
// the level's f32 gradient, 11.8 MB or 3.5 us at the flagship; its 67 M
// flop take 1.0 us at the f32 peak.
//
// Design: the level's f32 accumulator is privatised in shared memory. At
// the flagship (4,096 rows x 16 channels, 256 KB) it does not fit a
// block, so it is cut into slices of at most 128 KB (two channel halves
// there; rows too where one channel of a level exceeds 128 KB), one
// block per SM for each slice (gridDim.y = slices). Warp lanes run over
// the slice's channels; each group of `cb` lanes walks a run of
// consecutive points and keeps the 8 corner sums of the current cell in
// registers until the cell changes, so ray-ordered points (about 32 a
// ray, a handful of res-16 cells) touch shared memory a few times a ray
// instead of once a point. Shared atomics inside the block; at the end
// each block adds its nonzero entries to the zeroed level slice with
// global float4 atomicAdd (sm_90), and under bf16 a finishing pass rounds
// the slice in place. Every partial is an f32 sum of the same exact
// products, so kernel and plain version differ only in f32 sum order
// (atomics vary it from run to run). f32 atomics flush subnormal results
// to zero (PTX atom.add.f32), far below any gradient the path produces.
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

namespace {

constexpr int kGradThreads = 1024;
constexpr int kThreads = 256;
constexpr int kSliceBytes = 128 * 1024;  // shared accumulator per block

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

// adds a run's 8 corner sums (corner i = xi + 2 yi + 4 zi) of channel c to
// the block's slice [r0, r1) x cb of shared memory
__device__ __forceinline__ void flush_run(float* acc_s, const int rows[8],
                                          const float acc[8], int r0, int r1,
                                          int cb, int c) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (acc[i] != 0.0f && rows[i] >= r0 && rows[i] < r1) {
      atomicAdd(acc_s + (rows[i] - r0) * cb + c, acc[i]);
    }
  }
}

template <bool BF16>
__global__ void __launch_bounds__(kGradThreads)
mm_grad_table_kernel(const float* __restrict__ x01, const void* __restrict__ g,
                     float* __restrict__ grad, int64_t B, int res, int C,
                     int64_t g_stride, int g_col, int rows_per_slice, int cb,
                     int n_cslices, int64_t per_group, int align_corners,
                     int smoothstep) {
  extern __shared__ float4 smem4[];
  float* acc_s = reinterpret_cast<float*>(smem4);
  const int slice = blockIdx.y;
  const int c0 = (slice % n_cslices) * cb;
  const int r0 = (slice / n_cslices) * rows_per_slice;
  const int n_rows = res * res * res;
  const int r1 = min(r0 + rows_per_slice, n_rows);
  const int n_sm = (r1 - r0) * cb;
  for (int i = threadIdx.x; i < n_sm; i += blockDim.x) acc_s[i] = 0.0f;
  __syncthreads();

  const int c = threadIdx.x % cb;
  const int groups = blockDim.x / cb;
  const int64_t p0 = ((int64_t)blockIdx.x * groups + threadIdx.x / cb)
                     * per_group;
  const int64_t p1 = p0 + per_group < B ? p0 + per_group : B;
  int64_t key = -1;
  int rows[8];
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    rows[i] = 0;
    acc[i] = 0.0f;
  }
  for (int64_t b = p0; b < p1; ++b) {
    uint32_t cl[3][2];
    float A[3][2];
    if (!point_lanes(x01, b, res, align_corners, smoothstep, cl, A)) continue;
    const int64_t k = cl[0][0] + (int64_t)res * (cl[1][0]
                                                 + (int64_t)res * cl[2][0]);
    if (k != key) {  // a new cell: its 8 rows follow from the lower corner
      if (key >= 0) flush_run(acc_s, rows, acc, r0, r1, cb, c);
      key = k;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        rows[i] = (int)(cl[0][i & 1]
                        + res * (cl[1][(i >> 1) & 1] + res * cl[2][i >> 2]));
        acc[i] = 0.0f;
      }
    }
    const float gv = load_g<BF16>(g, b * g_stride + g_col + c0 + c);
#pragma unroll
    for (int xi = 0; xi < 2; ++xi) {
      const float gx = BF16 ? round_bf16(__fmul_rn(gv, round_bf16(A[0][xi])))
                            : __fmul_rn(gv, A[0][xi]);
#pragma unroll
      for (int yz = 0; yz < 4; ++yz) {
        float w = __fmul_rn(A[2][yz >> 1], A[1][yz & 1]);
        if (BF16) w = round_bf16(w);
        const int i = xi + 2 * yz;
        acc[i] = __fadd_rn(acc[i], __fmul_rn(w, gx));
      }
    }
  }
  if (key >= 0) flush_run(acc_s, rows, acc, r0, r1, cb, c);
  __syncthreads();

  // the block's nonzero entries into the level's zeroed [rows, C] slice
  if (cb % 4 == 0) {
    for (int i = threadIdx.x; i < n_sm / 4; i += blockDim.x) {
      const float4 v = smem4[i];
      if (v.x == 0.0f && v.y == 0.0f && v.z == 0.0f && v.w == 0.0f) continue;
      const int r = (4 * i) / cb, cc = (4 * i) % cb;
      atomicAdd(reinterpret_cast<float4*>(
                    grad + (int64_t)(r0 + r) * C + c0 + cc), v);
    }
  } else {
    for (int i = threadIdx.x; i < n_sm; i += blockDim.x) {
      const float v = acc_s[i];
      if (v == 0.0f) continue;
      atomicAdd(grad + (int64_t)(r0 + i / cb) * C + c0 + i % cb, v);
    }
  }
}

__global__ void round_bf16_kernel(float* __restrict__ v, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) v[i] = round_bf16(v[i]);
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

}  // namespace

// x01 [B, 3] f32, g [B, g_stride] (bf16 if bf16, else f32; the level's C
// channels at column g_col) -> grad [hmap * C] f32, the level's flat slice
// of the table gradient (zeroed here first). B > 0, C a power of two
// <= 32, res^3 <= hmap. Returns the first CUDA error, else
// cudaGetLastError().
extern "C" int mm_grad_table_fwd(const float* x01, const void* g, float* grad,
                                 int64_t B, int res, int C, int hmap,
                                 int64_t g_stride, int g_col,
                                 int align_corners, int smoothstep, int bf16,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(grad, 0, (size_t)hmap * C * sizeof(float),
                                    s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_rows = res * res * res;
  // channels of a slice: the largest power-of-two divisor of C whose rows
  // fit the slice; rows are cut too where one channel does not
  int cb = C;
  while (cb > 1 && (int64_t)n_rows * cb * 4 > kSliceBytes) cb /= 2;
  const int rows_per_slice = n_rows < kSliceBytes / (cb * 4)
                               ? n_rows : kSliceBytes / (cb * 4);
  const int n_cslices = C / cb;
  const int n_slices = n_cslices
                       * ((n_rows + rows_per_slice - 1) / rows_per_slice);
  const int smem = rows_per_slice * cb * 4;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // one block an SM for each slice
  const int blocks_x = sms >= 2 * n_slices ? sms / n_slices : 1;
  const int64_t groups = (int64_t)blocks_x * (kGradThreads / cb);
  const int64_t per_group = (B + groups - 1) / groups;
  const dim3 grid(blocks_x, n_slices);
  if (bf16) {
    err = cudaFuncSetAttribute(mm_grad_table_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    mm_grad_table_kernel<true><<<grid, kGradThreads, smem, s>>>(
        x01, g, grad, B, res, C, g_stride, g_col, rows_per_slice, cb,
        n_cslices, per_group, align_corners, smoothstep);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t n = (int64_t)n_rows * C;
    round_bf16_kernel<<<blocks_for(n), kThreads, 0, s>>>(grad, n);
  } else {
    err = cudaFuncSetAttribute(mm_grad_table_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    mm_grad_table_kernel<false><<<grid, kGradThreads, smem, s>>>(
        x01, g, grad, B, res, C, g_stride, g_col, rows_per_slice, cb,
        n_cslices, per_group, align_corners, smoothstep);
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
