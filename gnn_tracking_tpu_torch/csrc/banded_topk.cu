// Banded top-k for Hopper (sm_90a): the k nearest neighbours of each key-sorted point among the
// candidate blocks of a +-radius band around its own block.
//
// Replaces the TPU kernel gnn_tracking_tpu/ops/pallas/windowed_topk.py::banded_topk_sorted
// (_banded_topk_kernel). Points are sorted by their key (projection on the principal axis).
// Query q lies in query block i = q / block_q; its band is the candidate blocks
// clip(i * block_q / block_c + j - radius, 0, ncb - 1) for j in [0, 2 radius], each distinct
// block once, i.e. candidates [lo * block_c, min((hi + 1) * block_c, n)). Candidates at or beyond
// n are excluded, and so is q itself unless `loop`. Invalid points carry coordinates of 1e30,
// whose squared distance overflows to +inf, so they never fill a slot; an invalid query
// returns (+inf, 0) in every slot, and so does a slot left unfilled. The k smallest are kept
// ascending; ties go to the lower index. Distances are direct, sum_d (q - c)^2 with fmaf
// (the TPU kernel used the norm expansion at HIGHEST precision).
//
// What bounds it on this card: arithmetic. At 262,144 points with radius 4, block_q 256 and
// block_c 1024, a query meets up to 9 blocks of 1024 candidates: 2.4e9 pairs, at 3 flops per
// dimension 21.6 GFLOP for the 3-d spatial coordinates (0.32 ms at 67 TFLOP/s f32) and
// 57.5 GFLOP for an 8-d latent (0.86 ms), against 3-8 MB of points and 17 MB of outputs.
// chip_smoke.py computes the bound from the band of each of its two inputs.
// Design: one block of 128 threads per 128 consecutive queries, one thread per query; the query
// vector (zero-padded to DP = 4, 8, 16 or 32) stays in registers. The union of the block's
// bands (one band when 128 divides block_q) is streamed through shared memory in tiles of 256
// candidates read as broadcasts, and each thread tests its own band's bounds. The running
// top-k is sorted in shared memory, laid out [slot][thread]; the k-th distance is the live
// threshold, so a candidate costs one distance and one compare unless it improves the set.
// Known limit (later work): every block re-reads its 9216-candidate band from L2, and the
// insertion is a serial shift of up to k entries.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QB = 128;  // queries (threads) per block
constexpr int TC = 256;  // candidates per shared-memory tile

__device__ __forceinline__ void band_of(int q, int n_cblocks, int block_q, int block_c,
                                        int radius, int n, int* lo, int* hi) {
  const int qc = (int)((long)(q / block_q) * block_q / block_c);
  int cb_lo = qc - radius, cb_hi = qc + radius;
  cb_lo = cb_lo < 0 ? 0 : (cb_lo > n_cblocks - 1 ? n_cblocks - 1 : cb_lo);
  cb_hi = cb_hi < 0 ? 0 : (cb_hi > n_cblocks - 1 ? n_cblocks - 1 : cb_hi);
  *lo = cb_lo * block_c;
  const long end = (long)(cb_hi + 1) * block_c;
  *hi = end < n ? (int)end : n;
}

template <int DP>
__global__ void __launch_bounds__(QB)
banded_topk_kernel(const float* __restrict__ x, const uint8_t* __restrict__ valid, int n, int d,
                   int k, int radius, int block_q, int block_c, int n_cblocks, int loop,
                   float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);          // [TC][DP]
  float* best_d = tile + TC * DP;                          // [k][QB]
  int* best_i = reinterpret_cast<int*>(best_d + k * QB);   // [k][QB]

  const int t = threadIdx.x;
  const int q0 = blockIdx.x * QB;
  const int q = q0 + t;
  const bool active = q < n;
  const bool qvalid = active && valid[q] != 0;
  float qv[DP];
#pragma unroll
  for (int j = 0; j < DP; ++j) qv[j] = (active && j < d) ? x[(long)q * d + j] : 0.f;

  // this thread's band, and the union over the block (bands are monotone in q)
  int lo = 0, hi = 0, u_lo = 0, u_hi = 0, tmp = 0;
  band_of(active ? q : q0, n_cblocks, block_q, block_c, radius, n, &lo, &hi);
  const int q_last = (q0 + QB - 1) < (n - 1) ? (q0 + QB - 1) : (n - 1);
  band_of(q0, n_cblocks, block_q, block_c, radius, n, &u_lo, &tmp);
  band_of(q_last, n_cblocks, block_q, block_c, radius, n, &tmp, &u_hi);

  int cnt = 0;
  float tau = INFINITY;
  for (int c0 = u_lo; c0 < u_hi; c0 += TC) {
    const int tc = (u_hi - c0) < TC ? (u_hi - c0) : TC;
    __syncthreads();
    for (int i = t; i < TC * DP; i += QB) {
      const int r = i / DP;
      const int j = i % DP;
      tile[i] = (r < tc && j < d) ? x[(long)(c0 + r) * d + j] : 0.f;
    }
    __syncthreads();
    if (!qvalid) continue;
    const int from = (lo > c0 ? lo : c0) - c0;
    const int to = ((hi < c0 + tc) ? hi : c0 + tc) - c0;
    for (int ci = from; ci < to; ++ci) {
      const float* cp = tile + ci * DP;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < DP; ++j) {
        const float df = qv[j] - cp[j];
        acc = fmaf(df, df, acc);
      }
      const int c = c0 + ci;
      if (!(acc < tau) || (!loop && c == q)) continue;
      int p = cnt < k ? cnt : k - 1;
      while (p > 0 && best_d[(p - 1) * QB + t] > acc) {
        best_d[p * QB + t] = best_d[(p - 1) * QB + t];
        best_i[p * QB + t] = best_i[(p - 1) * QB + t];
        --p;
      }
      best_d[p * QB + t] = acc;
      best_i[p * QB + t] = c;
      if (cnt < k) ++cnt;
      if (cnt == k) tau = best_d[(k - 1) * QB + t];
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
cudaError_t launch(const float* x, const uint8_t* valid, float* out_d, int* out_i, int n, int d,
                   int k, int radius, int block_q, int block_c, int n_cblocks, int loop,
                   cudaStream_t stream) {
  const size_t smem = (size_t)TC * DP * sizeof(float) + (size_t)k * QB * (sizeof(float) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(banded_topk_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (n + QB - 1) / QB;
  banded_topk_kernel<DP><<<grid, QB, smem, stream>>>(x, valid, n, d, k, radius, block_q, block_c,
                                                    n_cblocks, loop, out_d, out_i);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// x [n, d] f32 key-sorted points (invalid rows already 1e30), valid [n] u8; outputs [n, k]
// (f32 squared distances ascending, i32 indices in sorted order). n_cblocks is the number of
// candidate blocks after padding n to block_q and then to block_c.
int banded_topk_sorted(const float* x, const uint8_t* valid, float* out_d, int* out_i, int n,
                       int d, int k, int radius, int block_q, int block_c, int n_cblocks,
                       int loop, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n == 0 || k == 0) return cudaSuccess;
  if (d <= 4) return launch<4>(x, valid, out_d, out_i, n, d, k, radius, block_q, block_c, n_cblocks, loop, stream);
  if (d <= 8) return launch<8>(x, valid, out_d, out_i, n, d, k, radius, block_q, block_c, n_cblocks, loop, stream);
  if (d <= 16) return launch<16>(x, valid, out_d, out_i, n, d, k, radius, block_q, block_c, n_cblocks, loop, stream);
  if (d <= 32) return launch<32>(x, valid, out_d, out_i, n, d, k, radius, block_q, block_c, n_cblocks, loop, stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
