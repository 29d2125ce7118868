// Exact pairwise top-k with split candidate ranges, for Hopper (sm_90a).
//
// Replaces the TPU kernels gnn_tracking_tpu/ops/pallas/pairwise_topk.py::pairwise_topk
// (_pairwise_topk_kernel: candidates resident in VMEM, with batch ids) and ::pairwise_topk_streaming
// (_pairwise_topk_stream_kernel: candidates streamed from HBM, 2-D grid, running top-k revisited
// across candidate blocks). Both compute one function; on this card they are one kernel pair.
// For every valid query i: the k nearest valid candidates j by squared Euclidean distance, sorted
// ascending, ties to the lower index. A candidate is valid if its batch id equals the query's
// (masked candidates carry batch id -2) and, unless `loop`, j != i. Masked queries get (+inf, 0)
// in every slot, as do slots left unfilled.
//
// What bounds it on this card: arithmetic. Every valid query meets every candidate: N^2 distances
// of D dimensions (3 D flops each); at N = 32768, D = 8 that is 25.8 GFLOP against ~3 MB of
// traffic, at N = 262144 1.65 TFLOP.
// Design: two kernels.
//  P (partial top-k): grid (query blocks x S candidate splits), the TPU's second grid axis turned
//    into split-K. One thread per query, 64 queries per block; the split's candidates are streamed
//    through shared memory in tiles of 256 (coordinates zero-padded to DP = 4, 8, 16 or 32, read by
//    a warp as a broadcast); each thread keeps its running top-k sorted in shared memory, laid out
//    [slot][thread] (free of bank conflicts), with the k-th distance as the live threshold. Distances
//    are direct sum (q - c)^2 with fmaf in dimension order, as csrc/pairwise_topk.cu computes them,
//    so both kernels give the same bits. It writes [S, k, N] partials, unfilled slots
//    (+inf, INT_MAX) so that they sort last. S is chosen so that the grid fills the SMs about
//    twice over: the resident top-k (pairwise_topk.cu) has N / 32 warps in all, under 8 per SM at
//    N = 32768; the splits multiply that by S.
//  M (merge): one thread per query, an S-way merge of the sorted partial lists by (d^2, index),
//    which keeps ties at the lower index; writes k slots, (+inf, 0) where unfilled or masked.
// The TPU kernel's k-round select merge (Mosaic has no sort) is not carried over.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QB = 64;      // queries (threads) per block of P
constexpr int TC = 256;     // candidates per shared-memory tile
constexpr int MAX_K = 256;  // k * QB * 8 bytes = 128 KB of running top-k at the largest k
constexpr int MAX_S = 64;   // candidate splits
constexpr int MB = 128;     // threads per block of M

template <int DP>
__global__ void __launch_bounds__(QB)
topk_partial_kernel(const float* __restrict__ x, const int* __restrict__ cbatch,
                    const int* __restrict__ qbatch, const uint8_t* __restrict__ qvalid, int n,
                    int d, int k, int loop, int span, float* __restrict__ part_d,
                    int* __restrict__ part_i) {
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);              // [TC][DP]
  int* tile_b = reinterpret_cast<int*>(tile + TC * DP);       // [TC]
  float* best_d = reinterpret_cast<float*>(tile_b + TC);      // [k][QB]
  int* best_i = reinterpret_cast<int*>(best_d + k * QB);      // [k][QB]

  const int t = threadIdx.x;
  const int q = blockIdx.x * QB + t;
  const int s = blockIdx.y;
  const int c_begin = s * span;
  const int c_end = (n - c_begin) < span ? n : c_begin + span;
  const bool active = q < n && qvalid[q];
  float qv[DP];
#pragma unroll
  for (int j = 0; j < DP; ++j) qv[j] = (active && j < d) ? x[(long)q * d + j] : 0.f;
  const int qb = active ? qbatch[q] : 0;

  int cnt = 0;  // filled slots
  float tau = INFINITY;  // inclusive bound while not full, strict k-th distance once full
  bool full = false;

  for (int c0 = c_begin; c0 < c_end; c0 += TC) {
    __syncthreads();
    for (int i = t; i < TC * DP; i += QB) {
      const int c = c0 + i / DP;
      const int j = i % DP;
      tile[i] = (c < c_end && j < d) ? x[(long)c * d + j] : 0.f;
    }
    for (int i = t; i < TC; i += QB) tile_b[i] = (c0 + i < c_end) ? cbatch[c0 + i] : -1;
    __syncthreads();
    if (!active) continue;
    const int tc = (c_end - c0) < TC ? (c_end - c0) : TC;
    for (int ci = 0; ci < tc; ++ci) {
      const float* cp = tile + ci * DP;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < DP; ++j) {
        const float df = qv[j] - cp[j];
        acc = fmaf(df, df, acc);
      }
      const int c = c0 + ci;
      const bool ok = tile_b[ci] == qb && (loop || c != q);
      const bool take = ok && (full ? acc < tau : acc <= tau);
      if (take) {
        int p = full ? k - 1 : cnt;
        while (p > 0 && best_d[(p - 1) * QB + t] > acc) {
          best_d[p * QB + t] = best_d[(p - 1) * QB + t];
          best_i[p * QB + t] = best_i[(p - 1) * QB + t];
          --p;
        }
        best_d[p * QB + t] = acc;
        best_i[p * QB + t] = c;
        if (!full) {
          ++cnt;
          full = cnt == k;
        }
        if (full) tau = best_d[(k - 1) * QB + t];
      }
    }
  }
  if (!active) return;  // M writes masked queries without reading their partials
  for (int j = 0; j < k; ++j) {
    const bool filled = j < cnt;
    const long off = ((long)s * k + j) * n + q;
    part_d[off] = filled ? best_d[j * QB + t] : INFINITY;
    part_i[off] = filled ? best_i[j * QB + t] : INT_MAX;
  }
}

__global__ void __launch_bounds__(MB)
topk_merge_kernel(const float* __restrict__ part_d, const int* __restrict__ part_i,
                  const uint8_t* __restrict__ qvalid, int n, int k, int splits,
                  float* __restrict__ out_d, int* __restrict__ out_i) {
  const int q = blockIdx.x * MB + threadIdx.x;
  if (q >= n) return;
  float* od = out_d + (long)q * k;
  int* oi = out_i + (long)q * k;
  int j = 0;
  if (qvalid[q]) {
    int ptr[MAX_S];
    for (int s = 0; s < splits; ++s) ptr[s] = 0;
    for (; j < k; ++j) {
      int best = -1;
      float bd = INFINITY;
      int bi = INT_MAX;
      for (int s = 0; s < splits; ++s) {
        if (ptr[s] >= k) continue;
        const long off = ((long)s * k + ptr[s]) * n + q;
        const float dv = part_d[off];
        const int iv = part_i[off];
        if (dv < bd || (dv == bd && iv < bi)) {
          bd = dv;
          bi = iv;
          best = s;
        }
      }
      // the lists are sorted, so once the smallest head is +inf every later slot is unfilled
      if (best < 0 || !isfinite(bd)) break;
      od[j] = bd;
      oi[j] = bi;
      ++ptr[best];
    }
  }
  for (; j < k; ++j) {
    od[j] = INFINITY;
    oi[j] = 0;
  }
}

template <int DP>
size_t partial_smem(int k) {
  return (size_t)TC * DP * sizeof(float) + TC * sizeof(int) +
         (size_t)k * QB * (sizeof(float) + sizeof(int));
}

template <int DP>
cudaError_t plan(int n, int k, int* splits, int* span) {
  const size_t smem = partial_smem<DP>(k);
  cudaError_t err = cudaFuncSetAttribute(topk_partial_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, topk_partial_kernel<DP>, QB, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long qblocks = (n + QB - 1) / QB;
  const long target = 2L * sms * per_sm;  // about two waves of resident blocks
  long s = (target + qblocks - 1) / qblocks;
  const long tiles = (n + TC - 1) / TC;  // at least one tile per split
  if (s > tiles) s = tiles;
  if (s > MAX_S) s = MAX_S;
  if (s < 1) s = 1;
  const long per = (n + s - 1) / s;
  const long sp = (per + TC - 1) / TC * TC;
  *span = (int)sp;
  *splits = (int)((n + sp - 1) / sp);
  return cudaSuccess;
}

template <int DP>
cudaError_t launch(const float* x, const int* cbatch, const int* qbatch, const uint8_t* qvalid,
                   int n, int d, int k, int loop, int splits, int span, float* part_d,
                   int* part_i, float* out_d, int* out_i, cudaStream_t stream) {
  const size_t smem = partial_smem<DP>(k);
  cudaError_t err = cudaFuncSetAttribute(topk_partial_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + QB - 1) / QB, splits);
  topk_partial_kernel<DP><<<grid, QB, smem, stream>>>(x, cbatch, qbatch, qvalid, n, d, k, loop,
                                                      span, part_d, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  topk_merge_kernel<<<(n + MB - 1) / MB, MB, 0, stream>>>(part_d, part_i, qvalid, n, k, splits,
                                                          out_d, out_i);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// The number of candidate splits S and the candidates per split for (n, d, k): the wrapper
// allocates the [S, k, n] partials from them. Returns cudaGetLastError()-style codes.
int pairwise_topk_split_plan(int n, int d, int k, void* out_splits, void* out_span) {
  int* splits = static_cast<int*>(out_splits);
  int* span = static_cast<int*>(out_span);
  if (n <= 0 || k <= 0 || k > MAX_K) return cudaErrorInvalidValue;
  if (d <= 4) return plan<4>(n, k, splits, span);
  if (d <= 8) return plan<8>(n, k, splits, span);
  if (d <= 16) return plan<16>(n, k, splits, span);
  if (d <= 32) return plan<32>(n, k, splits, span);
  return cudaErrorInvalidValue;
}

// x [n, d] f32, cbatch [n] i32 (-2 = masked candidate), qbatch [n] i32, qvalid [n] u8,
// partials [splits, k, n] (f32, i32) scratch, outputs [n, k]. P then M on `stream`.
int pairwise_topk_split(const float* x, const int* cbatch, const int* qbatch,
                        const uint8_t* qvalid, float* part_d, int* part_i, float* out_d,
                        int* out_i, int n, int d, int k, int loop, int splits, int span,
                        void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n == 0 || k == 0) return cudaSuccess;
  if (k > MAX_K || splits < 1 || splits > MAX_S || span < 1) return cudaErrorInvalidValue;
  if (d <= 4)
    return launch<4>(x, cbatch, qbatch, qvalid, n, d, k, loop, splits, span, part_d, part_i,
                     out_d, out_i, stream);
  if (d <= 8)
    return launch<8>(x, cbatch, qbatch, qvalid, n, d, k, loop, splits, span, part_d, part_i,
                     out_d, out_i, stream);
  if (d <= 16)
    return launch<16>(x, cbatch, qbatch, qvalid, n, d, k, loop, splits, span, part_d, part_i,
                      out_d, out_i, stream);
  if (d <= 32)
    return launch<32>(x, cbatch, qbatch, qvalid, n, d, k, loop, splits, span, part_d, part_i,
                      out_d, out_i, stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
