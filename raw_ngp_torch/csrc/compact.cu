// The render's budget decimation and streaming compaction, folded into
// one per-ray pipeline, for Hopper (sm_90a).
//
// Replaces the TPU kernel raw_ngp_tpu/kernels/compact_pallas.py
// (_compact_words_impl, reached by compact_attrs_pallas, and its VJP
// _compact_attrs_bwd), which placed records with a one-hot MXU contraction
// over a sequential grid, together with the work the JAX package runs
// around it in XLA: the decimation of raw_ngp_tpu/render/occupancy.py
// :880-885 (valid total, stride, a row scan of the mask, `% stride`,
// dt * stride) and the count, keys and stack of compact_positions_attrs
// (:632-638). What it computes is the same: the
// valid samples (mask & ~miss) of each ray, ranked j = 0, 1, ... along the
// ray; those with j % stride == 0 (stride = max(ceil(total / m_pad), 1)),
// in ray-major order, fill the slots 0, 1, ... of the m_pad budget, and
// the rest past the budget are dropped. Ray r keeps d_r = ceil(n_r /
// stride) samples, so with b_r the exclusive scan of d_r the sample of
// rank j goes to slot s = b_r + j / stride (kept iff s < m_pad). That is
// the flat inclusive count of the decimated mask less one, so every slot
// holds the record it held before: t, dt * stride (one f32 rounding,
// __fmul_rn, as the f32 multiply of the plain version), the ray id and the
// filled flag; unfilled slots hold 0, 0, N, false.
//
//   A. decimate_count_kernel: a warp per ray; the valid bits as
//      __ballot_sync words (ceil(K / 32) a ray), their count n_r, and the
//      count of each block of kRayWarps rays.
//   B. decimate_scan_kernel: a block per kScanThreads rays, a thread per
//      ray; every block sums the block counts of A into the total
//      (integer sums, any order gives the same) and the stride, then
//      scans d_r within its rays (the offsets within the group) and
//      writes the group's sum of d_r.
//   C. decimate_place_kernel: a warp per ray adds the sums of the groups
//      before its own (b_r), places its kept samples (slots of a ray are
//      consecutive, so a warp's stores are too) and writes b_r and the
//      kept count min(b_r + d_r, m_pad) - b_r (>= 0); blocks past the
//      rays fill [num_points, m_pad). When the caller asks, it also
//      writes each slot's flat source index r * K + k (N * K where
//      unfilled), the `pos` of compact_positions_attrs that the expand
//      path scatters at; without it no store is added.
//
// No host sync, no float atomic, no atomic at all: every output is written
// once, by integer math and plain copies. B is spread over blocks because
// one block walking all the rays took 0.050 ms of the fold's 0.059 at
// 16,384 rays on an H100 (SXM, 700 W).
//
// The backward, decimate_bwd_kernel, is B1's backward redesigned: from the
// saved words, b_r and stride, a warp per ray writes every (r, k)
//   g_ts[r, k] = kept ? g_t[s] : 0,
//   g_deltas[r, k] = kept ? g_dt[s] * stride : 0,
// the compaction's scatter-set and the multiply's backward in one pass,
// each output written once. The gradient of the stride-0 deltas view is
// returned whole; autograd's expand backward sums it over K as before.
//
// Bound: bytes. Forward at N = 8,192, K = 64, m_pad = 262,144: the mask,
// miss, the kept records' t, dt, and t_c, dt_c, rid, filled and the
// counts, 5,087,232 B (1.52 us at 3.35 TB/s); three launches of a few
// microseconds each set the floor in practice. Backward: the 2 x m_pad
// cotangents read, the 2 x N x K gradients written, the per-ray state.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRayWarps = 8;         // rays (warps) a block, passes A and C
constexpr int kScanThreads = 1024;   // rays (threads) a block of pass B

// Sum of v[0, count) over one warp; every lane gets it.
__device__ __forceinline__ int64_t warp_sum(const int32_t* v, int count) {
  int64_t s = 0;
  for (int i = threadIdx.x & 31; i < count; i += 32) s += v[i];
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

__global__ void decimate_count_kernel(const uint8_t* __restrict__ mask,
                                      const uint8_t* __restrict__ miss,
                                      uint32_t* __restrict__ words,
                                      int32_t* __restrict__ n,
                                      int32_t* __restrict__ block_n, int N,
                                      int K, int nw) {
  __shared__ int warp_n[kRayWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * kRayWarps + warp;
  int count = 0;
  if (r < N) {   // warp-uniform
    const bool live = miss[r] == 0;
    const uint8_t* row = mask + (int64_t)r * K;
    for (int w = 0; w < nw; ++w) {
      const int k = w * 32 + lane;
      const bool bit = live && k < K && row[k] != 0;
      const unsigned word = __ballot_sync(0xffffffffu, bit);
      if (lane == 0) words[(int64_t)r * nw + w] = word;
      count += __popc(word);
    }
    if (lane == 0) n[r] = count;
  }
  if (lane == 0) warp_n[warp] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int i = 0; i < kRayWarps; ++i) s += warp_n[i];
    block_n[blockIdx.x] = s;
  }
}

// Block-wide sum (exclusive == false) or exclusive scan of v over the
// kScanThreads threads; `shared` holds 32 values. Ends with a barrier.
__device__ int64_t block_scan(int64_t v, int64_t* shared, bool exclusive,
                              int64_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int64_t x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int64_t y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) shared[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int64_t s = shared[lane];
    for (int d = 1; d < 32; d <<= 1) {
      const int64_t y = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += y;
    }
    shared[lane] = s;   // inclusive over the warps
  }
  __syncthreads();
  const int64_t before = warp > 0 ? shared[warp - 1] : 0;
  *total = shared[31];
  __syncthreads();      // shared is free again
  return exclusive ? before + x - v : before + x;
}

__global__ void __launch_bounds__(kScanThreads)
decimate_scan_kernel(const int32_t* __restrict__ n,
                     const int32_t* __restrict__ block_n, int n_blocks_a,
                     int32_t* __restrict__ base, int32_t* __restrict__ group_d,
                     int32_t* __restrict__ stride_out,
                     int64_t* __restrict__ counts, int N, int m_pad) {
  __shared__ int64_t shared[32];
  int s = 0;   // at most N * K < 2^31
  for (int i = threadIdx.x; i < n_blocks_a; i += kScanThreads) {
    s += block_n[i];
  }
  int64_t total;
  block_scan(s, shared, false, &total);
  const int64_t stride64 = max((total + m_pad - 1) / m_pad, (int64_t)1);
  const unsigned stride = (unsigned)stride64;   // <= N * K < 2^31
  const int r = blockIdx.x * kScanThreads + threadIdx.x;
  const int d = r < N ? (int)(((unsigned)n[r] + stride - 1u) / stride) : 0;
  int64_t sum_d;
  const int64_t offset = block_scan(d, shared, true, &sum_d);
  if (r < N) base[r] = (int32_t)offset;   // within the group, for now
  if (threadIdx.x == 0) {
    group_d[blockIdx.x] = (int32_t)sum_d;
    if (blockIdx.x == 0) {
      stride_out[0] = (int32_t)stride64;
      counts[N] = total;                            // valid_total
    }
  }
}

__global__ void decimate_place_kernel(
    const uint32_t* __restrict__ words, int32_t* __restrict__ base,
    const int32_t* __restrict__ group_d, const int32_t* __restrict__ stride_p,
    int64_t* __restrict__ counts, const float* __restrict__ ts,
    const float* __restrict__ deltas, int64_t d_sn, int64_t d_sk,
    float* __restrict__ t_c, float* __restrict__ dt_c,
    int32_t* __restrict__ rid, uint8_t* __restrict__ filled,
    int32_t* __restrict__ pos, int N, int K, int nw, int m_pad,
    int ray_blocks, int n_groups) {
  if ((int)blockIdx.x >= ray_blocks) {   // the unfilled tail
    const int64_t n_filled = min(warp_sum(group_d, n_groups), (int64_t)m_pad);
    const int j = (blockIdx.x - ray_blocks) * blockDim.x + threadIdx.x;
    if (j == 0) counts[N + 1] = n_filled;           // num_points
    if (j >= m_pad || j < n_filled) return;
    t_c[j] = 0.0f;
    dt_c[j] = 0.0f;
    rid[j] = N;
    filled[j] = 0;
    if (pos != nullptr) pos[j] = N * K;              // the sentinel M
    return;
  }
  const int r = blockIdx.x * kRayWarps + (threadIdx.x >> 5);
  if (r >= N) return;   // warp-uniform
  const int lane = threadIdx.x & 31;
  const int within = base[r];   // the offset within the group (pass B)
  const int b = within + (int)warp_sum(group_d, r / kScanThreads);
  const unsigned stride = stride_p[0];
  const float fstride = (float)stride_p[0];   // the plain stride.float()
  int rank = 0;                               // valid samples before word w
  for (int w = 0; w < nw; ++w) {
    const unsigned word = words[(int64_t)r * nw + w];
    if ((word >> lane) & 1u) {
      const unsigned j = rank + __popc(word & ((1u << lane) - 1u));
      const unsigned q = j / stride;
      const int64_t s = (int64_t)b + q;
      if (j == q * stride && s < m_pad) {
        const int k = w * 32 + lane;
        t_c[s] = ts[(int64_t)r * K + k];
        dt_c[s] = __fmul_rn(deltas[r * d_sn + k * d_sk], fstride);
        rid[s] = r;
        filled[s] = 1;
        if (pos != nullptr) pos[s] = r * K + k;     // < N * K < 2^31
      }
    }
    rank += __popc(word);
  }
  __syncwarp();      // every lane has read base[r] before lane 0 rewrites it
  if (lane == 0) {   // rank is n_r now
    const int d = (int)(((unsigned)rank + stride - 1u) / stride);
    base[r] = b;
    counts[r] = max(min((int64_t)b + d, (int64_t)m_pad) - b, (int64_t)0);
  }
}

__global__ void decimate_bwd_kernel(const uint32_t* __restrict__ words,
                                    const int32_t* __restrict__ base,
                                    const int32_t* __restrict__ stride_p,
                                    const float* __restrict__ g_t,
                                    const float* __restrict__ g_dt,
                                    float* __restrict__ g_ts,
                                    float* __restrict__ g_deltas, int N,
                                    int K, int nw, int m_pad) {
  const int r = blockIdx.x * kRayWarps + (threadIdx.x >> 5);
  if (r >= N) return;
  const int lane = threadIdx.x & 31;
  const int b = base[r];
  const unsigned stride = stride_p[0];
  const float fstride = (float)stride_p[0];
  int rank = 0;
  for (int w = 0; w < nw; ++w) {
    const unsigned word = words[(int64_t)r * nw + w];
    const int k = w * 32 + lane;
    if (k < K) {
      float gt = 0.0f, gd = 0.0f;
      if ((word >> lane) & 1u) {
        const unsigned j = rank + __popc(word & ((1u << lane) - 1u));
        const unsigned q = j / stride;
        const int64_t s = (int64_t)b + q;
        if (j == q * stride && s < m_pad) {
          gt = g_t[s];
          gd = __fmul_rn(g_dt[s], fstride);
        }
      }
      g_ts[(int64_t)r * K + k] = gt;
      g_deltas[(int64_t)r * K + k] = gd;
    }
    rank += __popc(word);
  }
}

// Scratch of the fold, int32 words (at most N * ceil(K / 32) + 3N + 2):
// the valid words [N * nw] (u32), the counts n [N], the bases [N] (each
// ray's offset within its group from pass B, its slot b_r from pass C on,
// which the backward reads), the counts of pass A's blocks, the sums of
// pass B's groups and the stride.
struct Scratch {
  uint32_t* words;
  int32_t* n;
  int32_t* base;
  int32_t* block_n;
  int32_t* group_d;
  int32_t* stride;
};

Scratch scratch_of(int32_t* p, int N, int nw) {
  Scratch s;
  s.words = reinterpret_cast<uint32_t*>(p);
  s.n = p + (int64_t)N * nw;
  s.base = s.n + N;
  s.block_n = s.base + N;
  s.group_d = s.block_n + (N + kRayWarps - 1) / kRayWarps;
  s.stride = s.group_d + (N + kScanThreads - 1) / kScanThreads;
  return s;
}

}  // namespace

// mask [N, K] bool, miss [N] bool, ts [N, K] f32, deltas f32 read at
// r * d_sn + k * d_sk (the march's stride-0 dt.expand(N, K)), m_pad > 0,
// N * K < 2^31 -> tdt [2, m_pad] f32 (t_c, dt_c), rid [m_pad] i32, filled
// [m_pad] bool, counts [N + 2] i64 (per ray, then valid_total and
// num_points), scratch [N * ceil(K / 32) + 3N + 2] i32 (kept for the
// backward) and, when `pos` is not null, pos [m_pad] i32: each slot's flat
// source index r * K + k, N * K in unfilled slots (the expand path's
// scatter index). Returns cudaGetLastError().
extern "C" int decimate_compact_fwd(const void* mask, const void* miss,
                                    const float* ts, const float* deltas,
                                    int64_t d_sn, int64_t d_sk, float* tdt,
                                    int32_t* rid, void* filled,
                                    int64_t* counts, int32_t* scratch,
                                    int32_t* pos, int N, int K, int m_pad,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nw = (K + 31) / 32;
  const Scratch s = scratch_of(scratch, N, nw);
  const int ray_blocks = (N + kRayWarps - 1) / kRayWarps;
  const int groups = (N + kScanThreads - 1) / kScanThreads;
  decimate_count_kernel<<<ray_blocks, 32 * kRayWarps, 0, st>>>(
      static_cast<const uint8_t*>(mask), static_cast<const uint8_t*>(miss),
      s.words, s.n, s.block_n, N, K, nw);
  decimate_scan_kernel<<<groups, kScanThreads, 0, st>>>(
      s.n, s.block_n, ray_blocks, s.base, s.group_d, s.stride, counts, N,
      m_pad);
  const int fill_blocks = (m_pad + 32 * kRayWarps - 1) / (32 * kRayWarps);
  decimate_place_kernel<<<ray_blocks + fill_blocks, 32 * kRayWarps, 0, st>>>(
      s.words, s.base, s.group_d, s.stride, counts, ts, deltas, d_sn, d_sk,
      tdt, tdt + m_pad, rid, static_cast<uint8_t*>(filled), pos, N, K, nw,
      m_pad, ray_blocks, groups);
  return static_cast<int>(cudaGetLastError());
}

// g [2, m_pad] f32 (the cotangents of t_c and dt_c), scratch of the
// forward -> g_ts, g_deltas [N, K] f32, every entry written. Returns
// cudaGetLastError().
extern "C" int decimate_compact_bwd(const float* g, const int32_t* scratch,
                                    float* g_ts, float* g_deltas, int N,
                                    int K, int m_pad, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nw = (K + 31) / 32;
  const Scratch s = scratch_of(const_cast<int32_t*>(scratch), N, nw);
  decimate_bwd_kernel<<<(N + kRayWarps - 1) / kRayWarps, 32 * kRayWarps, 0,
                        st>>>(s.words, s.base, s.stride, g, g + m_pad, g_ts,
                              g_deltas, N, K, nw, m_pad);
  return static_cast<int>(cudaGetLastError());
}
