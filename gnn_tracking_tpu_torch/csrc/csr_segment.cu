// Sorted segment-sum and sorted gather, for Hopper (sm_90a).
//
// Replaces the TPU kernels of gnn_tracking_tpu/ops/pallas/csr_segment.py:
//   * sorted_segment_sum (_fwd_kernel): out[i] = sum of messages[e] over the edges e whose
//     (non-decreasing) target is i;
//   * sorted_gather (_gather_kernel): out[e] = values[dst[e]].
// Each is the other's vector-Jacobian product. The TPU kernels turn both into windowed one-hot
// matmuls on the MXU (a scatter has no fast TPU lowering); on this card a sorted segment-sum is a
// CSR row sum and a gather is a gather, so neither needs a matrix unit.
//
// What bounds them on this card: bytes. At F = 32, E = 262144, N = 32768 the segment-sum moves
// E*F*4 in + N*F*4 out + the row pointer (~37.9 MB, ~11.3 us at 3.35 TB/s) and the gather
// N*F*4 + E*4 in + E*F*4 out (~38.8 MB, ~11.6 us). No arithmetic to speak of.
//
// Design (simple and exact first):
//  * segment-sum: one thread per (node, feature); it sums the node's CSR rows in edge order from
//    0.f. Consecutive threads take consecutive features of a row, so a warp reads one 128-byte
//    row per step at F = 32. No atomics: the result is bitwise deterministic and equals any other
//    in-order sum. An optional permutation reads row perm[p] in place of row p, which sums the
//    edges of one source in source-sorted order (EventGraph.sort_edges_by_target stores
//    src_perm and src_rowptr); those reads are random rows.
//  * gather: one thread per output element, coalesced writes; exact.
//  * the segment-sum also reads bf16 rows (the bf16 fused relational op's e' and per-edge node
//    gradients, sorted_segment_sum_bf16): each value widened to f32, the same f32 sum and output;
//    the gather also moves bf16 rows (sorted_gather_bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// out[i][c] = sum over p in [rowptr[i], rowptr[i+1]) of msgs[row(p)][c], row(p) = perm ? perm[p] : p
template <typename T>
__global__ void __launch_bounds__(THREADS)
csr_rows_sum_kernel(const T* __restrict__ msgs, const int* __restrict__ rowptr,
                    const int* __restrict__ perm, int n, int f, float* __restrict__ out) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)n * f) return;
  const int node = (int)(i / f);
  const int c = (int)(i % f);
  const int lo = rowptr[node];
  const int hi = rowptr[node + 1];
  float s = 0.f;
  if (perm != nullptr) {
    for (int p = lo; p < hi; ++p) s += widen(msgs[(long)perm[p] * f + c]);
  } else {
    for (int p = lo; p < hi; ++p) s += widen(msgs[(long)p * f + c]);
  }
  out[i] = s;
}

// out[e][c] = values[idx[e]][c]
template <typename T>
__global__ void __launch_bounds__(THREADS)
gather_rows_kernel(const T* __restrict__ values, const int* __restrict__ idx, long total, int f,
                   T* __restrict__ out) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long e = i / f;
  const int c = (int)(i % f);
  out[i] = values[(long)idx[e] * f + c];
}

template <typename T>
int launch_sum(const T* msgs, const int* rowptr, const int* perm, float* out, int n, int f,
               void* stream_ptr) {
  const long outs = (long)n * f;
  if (outs > 0) {
    csr_rows_sum_kernel<T><<<(unsigned)((outs + THREADS - 1) / THREADS), THREADS, 0,
                             static_cast<cudaStream_t>(stream_ptr)>>>(msgs, rowptr, perm, n, f,
                                                                       out);
  }
  return cudaGetLastError();
}

template <typename T>
int launch_gather(const T* values, const int* idx, T* out, int n_edges, int f, void* stream_ptr) {
  const long total = (long)n_edges * f;
  if (total > 0) {
    gather_rows_kernel<T><<<(unsigned)((total + THREADS - 1) / THREADS), THREADS, 0,
                            static_cast<cudaStream_t>(stream_ptr)>>>(values, idx, total, f, out);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// msgs [rows, F] f32; rowptr [N + 1] int32; perm [E] int32 or null; out [N, F] f32.
// Returns cudaGetLastError().
int sorted_segment_sum(const float* msgs, const int* rowptr, const int* perm, float* out, int n,
                       int f, void* stream_ptr) {
  return launch_sum(msgs, rowptr, perm, out, n, f, stream_ptr);
}

// The same with msgs [rows, F] bf16; the sums and out stay f32.
int sorted_segment_sum_bf16(const __nv_bfloat16* msgs, const int* rowptr, const int* perm,
                            float* out, int n, int f, void* stream_ptr) {
  return launch_sum(msgs, rowptr, perm, out, n, f, stream_ptr);
}

// values [N, F] f32; idx [E] int32 (each in [0, N)); out [E, F] f32. Returns cudaGetLastError().
int sorted_gather(const float* values, const int* idx, float* out, int n_edges, int f,
                  void* stream_ptr) {
  return launch_gather(values, idx, out, n_edges, f, stream_ptr);
}

// The same with values and out bf16.
int sorted_gather_bf16(const __nv_bfloat16* values, const int* idx, __nv_bfloat16* out,
                       int n_edges, int f, void* stream_ptr) {
  return launch_gather(values, idx, out, n_edges, f, stream_ptr);
}

}  // extern "C"
