// IVF probe for Hopper (sm_90a): each bucket slot's best kw candidates among the slabs of the
// T cells its own cell probes.
//
// Replaces the TPU kernel gnn_tracking_tpu/ops/pallas/ivf_probe.py::ivf_probe (_probe_kernel).
// For each cell i and each query slot s of it, the candidates are the slabs of cells
// nbr[i, 0..T), concatenated in nbr order. Distances are direct: sum_d (q - c)^2, accumulated
// dimension by dimension with fmaf. A candidate whose id equals the query's is excluded unless
// `loop`. The kw smallest are kept ascending; ties go to the first position in the
// concatenation. Empty slots hold coordinates of 1e30, whose squared distance overflows to +inf
// in float32, so they never fill a slot; a slot left unfilled is (+inf, 0). (The TPU kernel fills
// it with +inf and the id of the first candidate; only finite entries carry meaning.)
// Ids are int32 throughout (the TPU kernel carried them as an f32 lane, exact below 2^24).
//
// What bounds it on this card: memory. The work the data needs is the pairs of valid query
// slots and valid candidate slots of the probed cells, at 3 flops per dimension; at the
// full-detector shapes (C = 8192 cells, cap = 96 slots, T = 8 slabs of capc = 256 candidates,
// d = 8, kw = 16) that is ~7e7 pairs for 262,144 points (N x T x ~32 points a cell), ~1.7 GFLOP
// (0.03 ms at 67 TFLOP/s f32), while the tables and the outputs are ~200 MB (0.06 ms at
// 3.35 TB/s). chip_smoke.py computes both for the tables of its build. The kernel walks every
// slot, empty ones included: C * cap * T * capc = 1.61e9 pairs, ~20x the pairs the bound counts.
// Design: one block per (cell, group of up to 256 query slots), one thread per slot; the query
// vector (coordinates zero-padded to DP = 4, 8, 16 or 32) stays in registers, and the T slabs
// are streamed in order through shared memory in tiles of 256 candidates, so a warp reads
// each candidate as a broadcast. Each thread keeps its running top-kw sorted in shared memory,
// laid out [slot][thread] (free of bank conflicts); the kw-th distance is the live threshold,
// so a candidate costs one distance and one compare unless it improves the running set.
// Known limit (later work): with 96 slots a block holds 3 warps, and every slab is read
// once per probing cell (8x over all cells) instead of being shared between cells that
// probe it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;  // query slots per block at most
constexpr int TC = 256;           // candidates per shared-memory tile

template <int DP>
__global__ void __launch_bounds__(MAX_THREADS)
ivf_probe_kernel(const float* __restrict__ xb, const int* __restrict__ ib,
                 const float* __restrict__ xc, const int* __restrict__ ic,
                 const int* __restrict__ nbr, int cap, int capc, int d, int t_probe, int kw,
                 int loop, float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ float4 smem4[];
  const int nt = blockDim.x;
  float* tile = reinterpret_cast<float*>(smem4);         // [TC][DP]
  int* tile_id = reinterpret_cast<int*>(tile + TC * DP);  // [TC]
  float* best_d = reinterpret_cast<float*>(tile_id + TC); // [kw][nt]
  int* best_i = reinterpret_cast<int*>(best_d + kw * nt); // [kw][nt]

  const int cell = blockIdx.x;
  const int t = threadIdx.x;
  const int slot = blockIdx.y * nt + t;
  const bool active = slot < cap;
  const long qrow = (long)cell * cap + slot;
  float qv[DP];
#pragma unroll
  for (int j = 0; j < DP; ++j) qv[j] = (active && j < d) ? xb[qrow * d + j] : 0.f;
  const int qid = active ? ib[qrow] : 0;

  int cnt = 0;          // filled slots
  float tau = INFINITY; // the kw-th distance once full: a candidate must be strictly smaller

  for (int tt = 0; tt < t_probe; ++tt) {
    const long base = (long)nbr[(long)cell * t_probe + tt] * capc;
    for (int c0 = 0; c0 < capc; c0 += TC) {
      const int tc = (capc - c0) < TC ? (capc - c0) : TC;
      __syncthreads();
      for (int i = t; i < TC * DP; i += nt) {
        const int r = i / DP;
        const int j = i % DP;
        tile[i] = (r < tc && j < d) ? xc[(base + c0 + r) * d + j] : 0.f;
      }
      for (int i = t; i < TC; i += nt) tile_id[i] = (i < tc) ? ic[base + c0 + i] : 0;
      __syncthreads();
      if (!active) continue;
      for (int ci = 0; ci < tc; ++ci) {
        const float* cp = tile + ci * DP;
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < DP; ++j) {
          const float df = qv[j] - cp[j];
          acc = fmaf(df, df, acc);
        }
        if (!(acc < tau) || (!loop && tile_id[ci] == qid)) continue;
        int p = cnt < kw ? cnt : kw - 1;
        while (p > 0 && best_d[(p - 1) * nt + t] > acc) {
          best_d[p * nt + t] = best_d[(p - 1) * nt + t];
          best_i[p * nt + t] = best_i[(p - 1) * nt + t];
          --p;
        }
        best_d[p * nt + t] = acc;
        best_i[p * nt + t] = tile_id[ci];
        if (cnt < kw) ++cnt;
        if (cnt == kw) tau = best_d[(kw - 1) * nt + t];
      }
    }
  }
  if (!active) return;
  for (int j = 0; j < kw; ++j) {
    const bool filled = j < cnt;
    out_d[qrow * kw + j] = filled ? best_d[j * nt + t] : INFINITY;
    out_i[qrow * kw + j] = filled ? best_i[j * nt + t] : 0;
  }
}

template <int DP>
cudaError_t launch(const float* xb, const int* ib, const float* xc, const int* ic,
                   const int* nbr, float* out_d, int* out_i, int c, int cap, int capc, int d,
                   int t_probe, int kw, int loop, cudaStream_t stream) {
  int nt = cap < MAX_THREADS ? cap : MAX_THREADS;
  nt = (nt + 31) / 32 * 32;
  const size_t smem = (size_t)TC * DP * sizeof(float) + TC * sizeof(int) +
                      (size_t)kw * nt * (sizeof(float) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(ivf_probe_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(c, (cap + nt - 1) / nt);
  ivf_probe_kernel<DP><<<grid, nt, smem, stream>>>(xb, ib, xc, ic, nbr, cap, capc, d, t_probe,
                                                   kw, loop, out_d, out_i);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// xb [c, cap, d] f32 query slabs, ib [c, cap] i32 their ids, xc [c, capc, d] f32 candidate
// slabs, ic [c, capc] i32 their ids, nbr [c, t_probe] i32 cells each cell probes;
// outputs [c * cap, kw] (f32 squared distances ascending, i32 ids).
int ivf_probe(const float* xb, const int* ib, const float* xc, const int* ic, const int* nbr,
              float* out_d, int* out_i, int c, int cap, int capc, int d, int t_probe, int kw,
              int loop, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (c == 0 || cap == 0 || kw == 0) return cudaSuccess;
  if (d <= 4) return launch<4>(xb, ib, xc, ic, nbr, out_d, out_i, c, cap, capc, d, t_probe, kw, loop, stream);
  if (d <= 8) return launch<8>(xb, ib, xc, ic, nbr, out_d, out_i, c, cap, capc, d, t_probe, kw, loop, stream);
  if (d <= 16) return launch<16>(xb, ib, xc, ic, nbr, out_d, out_i, c, cap, capc, d, t_probe, kw, loop, stream);
  if (d <= 32) return launch<32>(xb, ib, xc, ic, nbr, out_d, out_i, c, cap, capc, d, t_probe, kw, loop, stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
