// Streaming compaction of a masked record stream, for Hopper (sm_90a).
//
// Replaces the TPU kernel raw_ngp_tpu/kernels/compact_pallas.py
// (_compact_words_impl / _kernel, reached by compact_attrs_pallas), which
// placed records with a one-hot MXU contraction over a sequential grid.
// What it computes carries over, the placement does not: the caller has
// the inclusive count c = cumsum(mask) and keys = c - 1 for the records
// kept (rank < m_pad), a sentinel above m_pad otherwise. Then
//   pos[key] = i, attrs_c[a][key] = attrs[a][i]     for every kept record i,
//   pos[j] = M,   attrs_c[a][j] = 0                  for j >= min(c[M-1], m_pad).
// Kept ranks are 0, 1, 2, ... in flat order, each exactly once, so the two
// passes write disjoint slots and every result is a plain copy: bit-exact
// with the plain version (compact_positions + gather_flat_sorted).
//
// Bound: bytes. The work is a copy of a few bytes per record; the least
// traffic is the M keys, the attrs of the kept records and the m_pad
// output slots (about 9-16 MB at M = 1,048,576, m_pad = 262,144, two attrs,
// i.e. a few microseconds at 3.35 TB/s). Keys are ascending ranks, so
// neighbouring threads read and write neighbouring addresses and both
// passes stream. The fill pass reads n_kept on the device: no host sync.
// The TPU kernel's M < 2^24 limit (3-byte index payload) does not apply.
//
// The same file holds the backward, compact_attrs_bwd: the gradient of the
// compacted attributes with respect to the flat ones. It replaces the VJP
// of the TPU kernel, compact_pallas.py _compact_attrs_bwd (an XLA
// scatter-set of each slot's cotangent to its source index pos[slot], 0
// elsewhere). The scatter is not carried over: it is turned into a gather
// by the forward's keys. Record i was kept into slot keys[i] (or dropped,
// key >= m_pad), so
//   out[a][i] = keys[i] < m_pad ? g[a][keys[i]] : 0.
// One thread per flat record writes each output exactly once: no zero
// fill, no scatter, no atomics, and a plain copy of bits, so it is
// bit-exact with the plain version (torch.zeros + index_copy_ at the
// filled pos) by construction. Bound: bytes: the M keys, the n_attr x M
// outputs and the cotangents of the kept slots (8,388,608 B at M =
// 524,288, m_pad = 262,144, two attributes: 2.5 us at 3.35 TB/s). Keys
// ascend with i, so neighbouring threads read neighbouring g entries and
// every access streams.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void compact_scatter(const float* __restrict__ attrs,
                                const int32_t* __restrict__ keys,
                                int32_t* __restrict__ pos,
                                float* __restrict__ attrs_c,
                                int M, int m_pad, int n_attr) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  const int k = keys[i];
  if (k < 0 || k >= m_pad) return;  // dropped record (sentinel key)
  pos[k] = i;
  for (int a = 0; a < n_attr; ++a) {
    attrs_c[(int64_t)a * m_pad + k] = attrs[(int64_t)a * M + i];
  }
}

__global__ void compact_fill(const int32_t* __restrict__ count_incl,
                             int32_t* __restrict__ pos,
                             float* __restrict__ attrs_c,
                             int M, int m_pad, int n_attr) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m_pad) return;
  const int n_kept = min(count_incl[M - 1], m_pad);
  if (j < n_kept) return;
  pos[j] = M;
  for (int a = 0; a < n_attr; ++a) attrs_c[(int64_t)a * m_pad + j] = 0.0f;
}

__global__ void compact_bwd(const float* __restrict__ g,
                            const int32_t* __restrict__ keys,
                            float* __restrict__ out, int M, int m_pad,
                            int n_attr) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  const int k = keys[i];
  const bool kept = k >= 0 && k < m_pad;
  for (int a = 0; a < n_attr; ++a) {
    out[(int64_t)a * M + i] = kept ? g[(int64_t)a * m_pad + k] : 0.0f;
  }
}

}  // namespace

// g [n_attr, m_pad] f32 (slot cotangents), keys [M] i32 (the forward's)
// -> out [n_attr, M] f32, every entry written. Returns cudaGetLastError().
extern "C" int compact_attrs_bwd(const float* g, const int32_t* keys,
                                 float* out, int M, int m_pad, int n_attr,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  compact_bwd<<<(M + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      g, keys, out, M, m_pad, n_attr);
  return static_cast<int>(cudaGetLastError());
}

// attrs [n_attr, M] f32, keys [M] i32, count_incl [M] i32 (M > 0)
// -> pos [m_pad] i32, attrs_c [n_attr, m_pad] f32. Returns cudaGetLastError().
extern "C" int compact_attrs_fwd(const float* attrs, const int32_t* keys,
                                 const int32_t* count_incl, int32_t* pos,
                                 float* attrs_c, int M, int m_pad,
                                 int n_attr, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  compact_scatter<<<(M + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      attrs, keys, pos, attrs_c, M, m_pad, n_attr);
  compact_fill<<<(m_pad + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      count_incl, pos, attrs_c, M, m_pad, n_attr);
  return static_cast<int>(cudaGetLastError());
}
