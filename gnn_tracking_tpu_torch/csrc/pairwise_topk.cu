// Survivor-filtered pairwise top-k for Hopper (sm_90a).
//
// Replaces the TPU kernel
// gnn_tracking_tpu/ops/pallas/pairwise_topk.py::pairwise_topk_filter (_pairwise_topk_filter_kernel).
// For every query i: the k nearest valid candidates j by squared Euclidean distance, sorted
// ascending, ties to the lower index. A candidate is valid if its batch id equals the query's
// (masked candidates carry batch id -2) and, unless `loop`, j != i. With a finite radius2 only
// candidates with d2 <= radius2 are kept; unfilled slots are (+inf, 0).
//
// What bounds it on this card: arithmetic. Every query meets every candidate: N^2 distances of
// D dimensions (3 D flops each); at the serving shapes (N = 32768, D = 8) that is 25.8 GFLOP
// against ~18 MB of traffic.
// Design: one thread per query, 64 queries per block; candidates are streamed through shared
// memory in tiles of 256 (coordinates zero-padded to DP = 4, 8, 16 or 32 so the query vector
// stays in registers and a warp reads each candidate as a broadcast); each thread keeps its
// running top-k sorted in shared memory, laid out [slot][thread] so that every access is free of
// bank conflicts; the k-th distance is the live threshold tau (the TPU kernel's survivor filter),
// so a candidate costs one distance and one compare unless it improves the running set.
// Distances are computed directly as sum (q - c)^2, never by norm expansion.
// Known limit (later work): N / 32 warps in all, so at N = 32768 fewer than 8 warps per SM are
// resident; splitting the candidate range over several threads per query would fix that.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QB = 64;   // queries (threads) per block
constexpr int TC = 256;  // candidates per shared-memory tile

template <int DP>
__global__ void __launch_bounds__(QB)
topk_filter_kernel(const float* __restrict__ x, const int* __restrict__ cbatch,
                   const int* __restrict__ qbatch, int n, int d, int k, int loop, float radius2,
                   float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);              // [TC][DP]
  int* tile_b = reinterpret_cast<int*>(tile + TC * DP);       // [TC]
  float* best_d = reinterpret_cast<float*>(tile_b + TC);      // [k][QB]
  int* best_i = reinterpret_cast<int*>(best_d + k * QB);      // [k][QB]

  const int t = threadIdx.x;
  const int q = blockIdx.x * QB + t;
  const bool active = q < n;
  float qv[DP];
#pragma unroll
  for (int j = 0; j < DP; ++j) qv[j] = (active && j < d) ? x[(long)q * d + j] : 0.f;
  const int qb = active ? qbatch[q] : -3;

  int cnt = 0;           // filled slots
  float tau = radius2;   // inclusive bound while not full, strict k-th distance once full
  bool full = false;

  for (int c0 = 0; c0 < n; c0 += TC) {
    __syncthreads();
    for (int i = t; i < TC * DP; i += QB) {
      const int c = c0 + i / DP;
      const int j = i % DP;
      tile[i] = (c < n && j < d) ? x[(long)c * d + j] : 0.f;
    }
    for (int i = t; i < TC; i += QB) tile_b[i] = (c0 + i < n) ? cbatch[c0 + i] : -1;
    __syncthreads();
    if (!active) continue;
    const int tc = (n - c0) < TC ? (n - c0) : TC;
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
  if (!active) return;
  for (int j = 0; j < k; ++j) {
    const bool filled = j < cnt;
    out_d[(long)q * k + j] = filled ? best_d[j * QB + t] : INFINITY;
    out_i[(long)q * k + j] = filled ? best_i[j * QB + t] : 0;
  }
}

template <int DP>
cudaError_t launch(const float* x, const int* cbatch, const int* qbatch, int n, int d, int k,
                   int loop, float radius2, float* out_d, int* out_i, cudaStream_t stream) {
  const size_t smem = (size_t)TC * DP * sizeof(float) + TC * sizeof(int) +
                      (size_t)k * QB * (sizeof(float) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(topk_filter_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (n + QB - 1) / QB;
  topk_filter_kernel<DP><<<grid, QB, smem, stream>>>(x, cbatch, qbatch, n, d, k, loop, radius2,
                                                     out_d, out_i);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// x [n, d] f32 (masked queries already zero-substituted), cbatch [n] i32 (-2 = masked),
// qbatch [n] i32, outputs [n, k]. radius2 = +inf selects plain k-nearest.
int pairwise_topk_filter(const float* x, const int* cbatch, const int* qbatch, float* out_d,
                         int* out_i, int n, int d, int k, int loop, float radius2,
                         void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n == 0 || k == 0) return cudaSuccess;
  if (d <= 4) return launch<4>(x, cbatch, qbatch, n, d, k, loop, radius2, out_d, out_i, stream);
  if (d <= 8) return launch<8>(x, cbatch, qbatch, n, d, k, loop, radius2, out_d, out_i, stream);
  if (d <= 16) return launch<16>(x, cbatch, qbatch, n, d, k, loop, radius2, out_d, out_i, stream);
  if (d <= 32) return launch<32>(x, cbatch, qbatch, n, d, k, loop, radius2, out_d, out_i, stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
