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
// Design: one block per (cell, group of nt query slots), one thread per slot; nt is the largest
// multiple of 32 up to 256 (and up to cap) whose lists fit the card's shared memory beside the
// tile, and the grid's second dimension covers the other slots. At d <= 32 (ivf_probe_kernel) the
// query vector, zero-padded to DP = 4, 8, 16 or 32, stays in registers and the T slabs are
// streamed in order through shared memory in tiles of 256 candidates, so a warp reads each
// candidate as a broadcast. Each thread keeps its running top-kw sorted in shared memory, laid
// out [slot][thread] (free of bank conflicts); the kw-th distance is the live threshold, so a
// candidate costs one distance and one compare unless it improves the running set. Above 32
// dimensions, or where even 32 lists do not fit beside the tile (kw of ~770 and more), the wide
// kernel (ivf_probe_wide) takes d at run time, keeps the queries in shared memory ([d][nt], in
// device memory where that does not fit), shrinks the tile, and keeps each slot's list in its
// output row in device memory where no list fits, so every d and kw runs.
// Known limit (later work): with 96 slots a block holds 3 warps, and every slab is read
// once per probing cell (8x over all cells) instead of being shared between cells that
// probe it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

constexpr int MAX_THREADS = 256;  // query slots per block at most
constexpr int TC = 256;           // candidates per shared-memory tile at most

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

// Any d and kw (d > 32, or lists that do not fit beside the padded kernel's tile): d at run time,
// the query in shared memory (q_smem) or read from xb; tiles of `rows` candidates; lists in shared
// memory (LIST_SMEM) or in the output rows (known at compile time, so the insertion's loads stay
// shared-memory loads).
template <bool LIST_SMEM>
__global__ void __launch_bounds__(MAX_THREADS)
ivf_probe_wide(const float* __restrict__ xb, const int* __restrict__ ib,
               const float* __restrict__ xc, const int* __restrict__ ic,
               const int* __restrict__ nbr, int cap, int capc, int d, int t_probe, int kw,
               int loop, int rows, int q_smem, float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ float4 smem4[];
  const int nt = blockDim.x;
  float* tile = reinterpret_cast<float*>(smem4);          // [rows][d]
  int* tile_id = reinterpret_cast<int*>(tile + rows * d);  // [rows]
  float* qsm = reinterpret_cast<float*>(tile_id + rows);  // with q_smem: [d][nt]
  float* lsm = qsm + (q_smem ? d * nt : 0);               // LIST_SMEM: [kw][nt] twice

  const int cell = blockIdx.x;
  const int t = threadIdx.x;
  const int slot = blockIdx.y * nt + t;
  const bool active = slot < cap;
  const long qrow = (long)cell * cap + slot;
  const long qsafe = (long)cell * cap + (active ? slot : 0);
  const float* qp = xb + qsafe * d;  // the query's coordinates, stride qstride
  int qstride = 1;
  if (q_smem) {
    for (int j = 0; j < d; ++j) qsm[j * nt + t] = active ? xb[qrow * d + j] : 0.f;
    qp = qsm + t;
    qstride = nt;
  }
  const int qid = active ? ib[qrow] : 0;
  // the list: slot j at best_[j * ls + off], in shared memory ([kw][nt]) or the slot's output row;
  // one index for both arrays, so the insertion's shift computes one address a step
  using Idx = typename std::conditional<LIST_SMEM, int, long>::type;
  float* best_d = LIST_SMEM ? lsm : out_d;
  int* best_i = LIST_SMEM ? reinterpret_cast<int*>(lsm + kw * nt) : out_i;
  const Idx ls = LIST_SMEM ? nt : 1;
  const Idx off = LIST_SMEM ? (Idx)t : (Idx)(qsafe * kw);

  int cnt = 0;          // filled slots
  float tau = INFINITY; // the kw-th distance once full: a candidate must be strictly smaller

  for (int tt = 0; tt < t_probe; ++tt) {
    const long base = (long)nbr[(long)cell * t_probe + tt] * capc;
    for (int c0 = 0; c0 < capc; c0 += rows) {
      const int tc = (capc - c0) < rows ? (capc - c0) : rows;
      __syncthreads();
      for (int i = t; i < rows * d; i += nt) {
        const int r = i / d;
        tile[i] = r < tc ? xc[(base + c0 + r) * d + i % d] : 0.f;
      }
      for (int i = t; i < rows; i += nt) tile_id[i] = (i < tc) ? ic[base + c0 + i] : 0;
      __syncthreads();
      if (!active) continue;
      for (int ci = 0; ci < tc; ++ci) {
        const float* cp = tile + ci * d;
        float acc = 0.f;
        for (int j = 0; j < d; ++j) {
          const float df = qp[j * qstride] - cp[j];
          acc = fmaf(df, df, acc);
        }
        if (!(acc < tau) || (!loop && tile_id[ci] == qid)) continue;
        int p = cnt < kw ? cnt : kw - 1;
        while (p > 0 && best_d[(p - 1) * ls + off] > acc) {
          best_d[p * ls + off] = best_d[(p - 1) * ls + off];
          best_i[p * ls + off] = best_i[(p - 1) * ls + off];
          --p;
        }
        best_d[p * ls + off] = acc;
        best_i[p * ls + off] = tile_id[ci];
        if (cnt < kw) ++cnt;
        if (cnt == kw) tau = best_d[(kw - 1) * ls + off];
      }
    }
  }
  if (!active) return;
  for (int j = 0; j < kw; ++j) {
    const bool filled = j < cnt;
    const float dv = filled ? best_d[j * ls + off] : INFINITY;
    const int iv = filled ? best_i[j * ls + off] : 0;
    out_d[qrow * kw + j] = dv;
    out_i[qrow * kw + j] = iv;
  }
}

// The padded kernel's shared memory: a tile of TC candidates and nt lists.
size_t padded_smem(int dp, int nt, int kw) {
  return (size_t)TC * dp * sizeof(float) + TC * sizeof(int) + (size_t)kw * nt * (sizeof(float) + sizeof(int));
}

// The wide kernel's: a tile of `rows` candidates, the queries (q_smem) and the lists (list_smem).
size_t wide_smem(int d, int rows, int nt, int kw, bool list_smem, bool q_smem) {
  return (size_t)rows * (d + 1) * sizeof(float) + (q_smem ? (size_t)d * nt * sizeof(float) : 0) +
         (list_smem ? (size_t)kw * nt * (sizeof(float) + sizeof(int)) : 0);
}

// The block of a launch: the most query slots (a multiple of 32, at most 256 and at most cap
// rounded up) whose lists fit the card's shared memory. At d <= 32 (DP > 0) the padded kernel
// takes them beside a tile of 256 candidates; where even 32 slots do not fit, or above 32
// dimensions, the wide kernel: the query in shared memory and smaller tiles before fewer slots,
// the lists in device memory where none of that fits.
template <int DP>
cudaError_t launch(const float* xb, const int* ib, const float* xc, const int* ic,
                   const int* nbr, float* out_d, int* out_i, int c, int cap, int capc, int d,
                   int t_probe, int kw, int loop, cudaStream_t stream) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  int nt0 = cap < MAX_THREADS ? cap : MAX_THREADS;
  nt0 = (nt0 + 31) / 32 * 32;
  if constexpr (DP > 0) {
    for (int nt = nt0; nt >= 32; nt -= 32) {
      const size_t smem = padded_smem(DP, nt, kw);
      if (smem > (size_t)optin) continue;
      err = cudaFuncSetAttribute(ivf_probe_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return err;
      const dim3 grid(c, (cap + nt - 1) / nt);
      ivf_probe_kernel<DP><<<grid, nt, smem, stream>>>(xb, ib, xc, ic, nbr, cap, capc, d, t_probe,
                                                       kw, loop, out_d, out_i);
      return cudaGetLastError();
    }
  }
  int nt = 0, rows = 0;
  bool list_smem = false, q_smem = false;
  for (int lists : {1, 0}) {
    for (int qs : {1, 0}) {
      for (int r = TC; r >= 4 && nt == 0; r /= 2) {
        for (int n_ = nt0; n_ >= 32; n_ -= 32) {
          if (wide_smem(d, r, n_, kw, lists, qs) <= (size_t)optin) {
            nt = n_, rows = r, list_smem = lists, q_smem = qs;
            break;
          }
          if (!lists && !qs) break;  // no list or query a slot: the slots do not change the need
        }
      }
      if (nt) break;
    }
    if (nt) break;
  }
  if (nt == 0) return cudaErrorInvalidValue;  // not even a tile of 4 candidates fits
  const size_t smem = wide_smem(d, rows, nt, kw, list_smem, q_smem);
  auto kern = list_smem ? ivf_probe_wide<true> : ivf_probe_wide<false>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(c, (cap + nt - 1) / nt);
  kern<<<grid, nt, smem, stream>>>(xb, ib, xc, ic, nbr, cap, capc, d, t_probe, kw, loop, rows,
                                   q_smem, out_d, out_i);
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
  return launch<0>(xb, ib, xc, ic, nbr, out_d, out_i, c, cap, capc, d, t_probe, kw, loop, stream);
}

}  // extern "C"
