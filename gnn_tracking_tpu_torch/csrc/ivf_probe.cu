// IVF probe for Hopper (sm_90a): each bucket slot's best kw candidates among the slabs of the
// T cells its own cell probes.
//
// Replaces the TPU kernel gnn_tracking_tpu/ops/pallas/ivf_probe.py::ivf_probe (_probe_kernel).
// For each cell i and each query slot s of it, the candidates are the slabs of cells
// nbr[i, 0..T), concatenated in nbr order. Distances are direct: sum_d (q - c)^2, accumulated
// dimension by dimension with fmaf. A candidate whose id equals the query's is excluded unless
// `loop`. The kw smallest are kept ascending; ties go to the first position in the
// concatenation. Empty slots hold coordinates of 1e30, whose squared distance to a real point
// overflows to +inf in float32, so they never fill its slots; a slot left unfilled is (+inf, 0).
// (The TPU kernel fills it with +inf and the id of the first candidate; only finite entries carry
// meaning.) Ids are int32 throughout (the TPU kernel carried them as an f32 lane, exact below 2^24).
//
// What bounds it on this card: memory. The work the data needs is the pairs of valid query
// slots and valid candidate slots of the probed cells, at 3 flops per dimension; at the
// full-detector shapes (C = 8192 cells, cap = 96 slots, T = 8 slabs of capc = 256 candidates,
// d = 8, kw = 16) that is ~7e7 pairs for 262,144 points (N x T x ~32 points a cell), ~1.7 GFLOP
// (0.03 ms at 67 TFLOP/s f32), while the tables and the outputs are ~200 MB (0.06 ms at
// 3.35 TB/s). chip_smoke.py computes both for the tables of its build. The table holds
// C * cap * T * capc = 1.61e9 slot pairs, ~24x the valid ones: about 2/3 of the query slots and
// 7/8 of the candidate slots are empty.
//
// Design at d <= 32 and kw <= 32 (the register path, two kernels):
//  * slab_index_kernel, one warp a cell, reads each slab once and sorts its slots into three
//    classes: real (every |coordinate| < 2^62), empty (every coordinate exactly 1e30) and other
//    (anything else: huge values, inf, NaN). It writes the real candidates of each candidate slab,
//    compacted in slot order and zero-padded to DP = 4, 8, 16 or 32 columns, with their ids and
//    their bounding box; the slab's count of empty slots and, where they all share one id, that
//    id; whether the slab holds an "other" slot; and each query slab's real slots in order.
//  * probe_warp_kernel, a warp for each 32 query slots of a cell: a real query meets a real
//    candidate by the parent's arithmetic, and never an empty one: (q - 1e30)^2 overflows to +inf,
//    which never enters. An empty query meets an empty candidate at exactly 0 ((1e30 - 1e30)^2)
//    and a real one at +inf, so its row is the first kw empty candidates in concatenation order
//    that the id test lets through, at (0, id), then (+inf, 0): placed from the slabs' counts by
//    a prefix sum (a scan of the slab's ids where they differ), once for the warp's empty slots
//    where they share a query id. A cell whose query slab or any probed slab holds an "other"
//    slot takes every query slot against every raw candidate slot instead, so every input gets
//    the parent's bits. Empty query slots thus cost no distance, and empty candidate slots
//    neither a load nor a distance.
//  * The warp takes 32 real queries, one a lane, the query in registers, and the T slabs in
//    order. Before a slab, it skips it where in every lane the squared distance from the query to
//    the slab's box exceeds the kw-th distance by more than rounding can bridge (2^-10): no
//    candidate in it could enter. On the JAX benchmark's cloud this skips ~3/4 of the candidates
//    (the kw nearest lie in the own cell and its sibling). A scanned slab's rows stream through a
//    32-row stage in the warp's shared memory, the next chunk loaded while the warp scans this one,
//    and every lane reads the same candidate (a broadcast), U at a step. Each query keeps its
//    top-kw in registers: K = 8, 16 or 32 slots, ascending, the first K - kw at -inf, so the kw-th
//    distance (+inf while unfilled) is always the last slot. A candidate below it (and not the
//    query itself) goes to the lane's pending list in shared memory; when a lane's list is nearly
//    full the warp's lanes insert theirs together (the unrolled insertion, slot r's distance
//    max(d[r - 1], min(d[r], x))), so a warp pays for each lane's admissions and not for every
//    step on which one lane admits. Candidates are inserted in concatenation order after any
//    equal distance, which is the parent's tie rule, bit for bit. The rows go out through the
//    stage, 32 / kw rows a store.
// Above 32 dimensions or 32 slots, the parent's kernels run as they were: one block per (cell,
// group of nt query slots), one thread per slot; nt is the largest multiple of 32 up to 256 (and
// up to cap) whose lists fit the card's shared memory beside the tile, and the grid's second
// dimension covers the other slots. At d <= 32 (ivf_probe_kernel) the query vector, zero-padded
// to DP, stays in registers and the T slabs are streamed in order through shared memory in tiles
// of 256 candidates, so a warp reads each candidate as a broadcast. Each thread keeps its running
// top-kw sorted in shared memory, laid out [slot][thread] (free of bank conflicts). Above 32
// dimensions, or where even 32 lists do not fit beside the tile (kw of ~770 and more), the wide
// kernel (ivf_probe_wide) takes d at run time, keeps the queries in shared memory ([d][nt], in
// device memory where that does not fit), shrinks the tile, and keeps each slot's list in its
// output row in device memory where no list fits, so every d and kw runs. Those two walk every
// slot, empty ones included.

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

// ---- the register path (d <= 32, kw <= 32) -------------------------------------------------

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;   // warps a block of the register path
constexpr int KS = 32;     // largest kw of the register path
constexpr int PB = 12;     // pending candidates a query (8, 10, 16 and 32 ran slower)
// blocks an SM the build's instantiation (DP <= 8, K <= 16) is held to: 6 (80 registers) ran
// faster than 4 or 5 (PERF.md, row #15)
constexpr int MIN_BLOCKS = 6;
constexpr float REAL_MAX = 0x1p62f;  // a real slot's coordinates lie below this in magnitude
constexpr float EMPTY = 1e30f;        // an empty slot's coordinates

enum SlotClass : int { REAL = 0, EMPTY_SLOT = 1, OTHER = 2, NO_SLOT = 3 };

// The slot's class from its d coordinates (v, zero-padded to DP). A real query against an empty
// candidate (or the reverse): some |q - c| >= 1e30 - 2^62, whose square overflows, so the
// distance is +inf whatever else is added. Two empty slots: every difference 0, distance 0.
template <int DP>
__device__ __forceinline__ int slot_class(const float (&v)[DP], int d) {
  bool real = true, empty = true;
#pragma unroll
  for (int j = 0; j < DP; ++j) {
    if (j < d) {
      real &= fabsf(v[j]) < REAL_MAX;
      empty &= v[j] == EMPTY;
    }
  }
  return real ? REAL : (empty ? EMPTY_SLOT : OTHER);
}

// Row r of a [rows, d] table, zero-padded to DP; `vec`: d == DP and 16-byte rows.
template <int DP>
__device__ __forceinline__ void load_row(float (&v)[DP], const float* __restrict__ x, long r, int d,
                                         bool vec) {
  if (vec) {
    const float4* src = reinterpret_cast<const float4*>(x + r * DP);
#pragma unroll
    for (int e = 0; e < DP / 4; ++e) {
      const float4 f = src[e];
      v[4 * e] = f.x, v[4 * e + 1] = f.y, v[4 * e + 2] = f.z, v[4 * e + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < DP; ++j) v[j] = j < d ? x[r * d + j] : 0.f;
  }
}

// The register path's scratch (one allocation, laid out by carve(); the wrapper sizes it):
//  slab [C][4]: real candidates, empty slots, the empty slots' id, flags (UNIFORM: every empty slot
//    has that id; HAS_OTHER: an "other" slot);
//  box [C][2][DP]: the smallest and largest coordinate of each slab's real candidates;
//  lx [C][capc][DP], lid [C][capc]: each slab's real candidates, compacted in slot order;
//  qslab [C][2]: real query slots, HAS_OTHER; qorder [C][cap]: the real query slots ascending from
//    the front, the others ascending from the back.
struct Scratch {
  int* slab;
  float* box;
  float* lx;
  int* lid;
  int* qslab;
  int* qorder;
};
constexpr int UNIFORM = 1, HAS_OTHER = 2;

__host__ __device__ inline Scratch carve(void* base, int c, int cap, int capc, int dp) {
  char* p = static_cast<char*>(base);
  Scratch s;
  s.slab = reinterpret_cast<int*>(p);
  p += (size_t)c * 4 * sizeof(int);
  s.box = reinterpret_cast<float*>(p);
  p += (size_t)c * 2 * dp * sizeof(float);
  s.lx = reinterpret_cast<float*>(p);
  p += (size_t)c * capc * dp * sizeof(float);
  s.lid = reinterpret_cast<int*>(p);
  p += (size_t)c * capc * sizeof(int);
  s.qslab = reinterpret_cast<int*>(p);
  p += (size_t)c * 2 * sizeof(int);
  s.qorder = reinterpret_cast<int*>(p);
  return s;
}

// One warp a cell: its candidate slab and its query slab, each slot read once.
template <int DP>
__global__ void __launch_bounds__(32 * WARPS)
slab_index_kernel(const float* __restrict__ xb, const int* __restrict__ ib,
                  const float* __restrict__ xc, const int* __restrict__ ic, int c, int cap,
                  int capc, int d, int vec, Scratch s) {
  const int lane = threadIdx.x & 31;
  const int cell = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (cell >= c) return;
  const unsigned below = (1u << lane) - 1u;
  int live = 0, n_empty = 0, empty_id = 0;
  bool uniform = true, other = false;
  float lo[DP], hi[DP];  // this lane's part of the slab's box
#pragma unroll
  for (int j = 0; j < DP; ++j) lo[j] = INFINITY, hi[j] = -INFINITY;
  for (int r0 = 0; r0 < capc; r0 += 32) {
    const int r = r0 + lane;
    const long row = (long)cell * capc + r;
    float v[DP];
    int cls = NO_SLOT, id = 0;
    if (r < capc) {
      load_row<DP>(v, xc, row, d, vec);
      cls = slot_class<DP>(v, d);
      id = ic[row];
    }
    const unsigned real = __ballot_sync(FULL, cls == REAL);
    const unsigned empty = __ballot_sync(FULL, cls == EMPTY_SLOT);
    other |= __ballot_sync(FULL, cls == OTHER) != 0u;
    if (cls == REAL) {
      const long at = (long)cell * capc + live + __popc(real & below);
      float4* dst = reinterpret_cast<float4*>(s.lx + at * DP);
#pragma unroll
      for (int e = 0; e < DP / 4; ++e) dst[e] = make_float4(v[4 * e], v[4 * e + 1], v[4 * e + 2], v[4 * e + 3]);
      s.lid[at] = id;
#pragma unroll
      for (int j = 0; j < DP; ++j) lo[j] = fminf(lo[j], v[j]), hi[j] = fmaxf(hi[j], v[j]);
    }
    live += __popc(real);
    if (empty) {
      if (n_empty == 0) empty_id = __shfl_sync(FULL, id, __ffs(empty) - 1);
      uniform &= __ballot_sync(FULL, cls == EMPTY_SLOT && id != empty_id) == 0u;
      n_empty += __popc(empty);
    }
  }
#pragma unroll
  for (int j = 0; j < DP; ++j) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo[j] = fminf(lo[j], __shfl_xor_sync(FULL, lo[j], o));
      hi[j] = fmaxf(hi[j], __shfl_xor_sync(FULL, hi[j], o));
    }
  }
  if (lane == 0) {
    reinterpret_cast<int4*>(s.slab)[cell] =
        make_int4(live, n_empty, empty_id, (uniform ? UNIFORM : 0) | (other ? HAS_OTHER : 0));
#pragma unroll
    for (int j = 0; j < DP; ++j) {
      s.box[(long)cell * 2 * DP + j] = lo[j];
      s.box[(long)cell * 2 * DP + DP + j] = hi[j];
    }
  }
  int front = 0, back = 0;
  other = false;
  for (int r0 = 0; r0 < cap; r0 += 32) {
    const int r = r0 + lane;
    float v[DP];
    int cls = NO_SLOT;
    if (r < cap) {
      load_row<DP>(v, xb, (long)cell * cap + r, d, vec);
      cls = slot_class<DP>(v, d);
    }
    const unsigned real = __ballot_sync(FULL, cls == REAL);
    const unsigned rest = __ballot_sync(FULL, cls == EMPTY_SLOT || cls == OTHER);
    other |= __ballot_sync(FULL, cls == OTHER) != 0u;
    if (cls == REAL) s.qorder[(long)cell * cap + front + __popc(real & below)] = r;
    if (cls == EMPTY_SLOT || cls == OTHER) s.qorder[(long)cell * cap + cap - 1 - back - __popc(rest & below)] = r;
    front += __popc(real);
    back += __popc(rest);
  }
  if (lane == 0) {
    s.qslab[2 * cell] = front;
    s.qslab[2 * cell + 1] = other ? HAS_OTHER : 0;
  }
}

// A query's list: K slots, ascending. The first K - kw hold -inf (never moved: every candidate is
// above them), the last kw the running top-kw (+inf while unfilled).
template <int K>
__device__ __forceinline__ void init_list(float (&dl)[K], int (&il)[K], int kw) {
#pragma unroll
  for (int r = 0; r < K; ++r) {
    dl[r] = r < K - kw ? -INFINITY : INFINITY;
    il[r] = 0;
  }
}

// Insert (x, c), below the last entry: after every entry <= x (a later candidate never passes an
// equal distance), the rest move up one and the last drops out.
template <int K>
__device__ __forceinline__ void insert(float (&dl)[K], int (&il)[K], float x, int c) {
  // the list is sorted, so slot r's new distance is max(d[r - 1], min(d[r], x))
#pragma unroll
  for (int r = K - 1; r > 0; --r) {
    const bool up = dl[r - 1] > x;
    const bool gt = dl[r] > x;
    il[r] = up ? il[r - 1] : (gt ? c : il[r]);
    dl[r] = fmaxf(dl[r - 1], fminf(dl[r], x));
  }
  if (dl[0] > x) {
    dl[0] = x;
    il[0] = c;
  }
}

// A lane's pending candidates ([PB][32] in the warp's shared memory, np of them) that still
// belong in its list, in the order they came; then the bound. A lane without a query keeps -inf.
template <int K>
__device__ __forceinline__ void flush(float (&dl)[K], int (&il)[K], float& thr, int& np,
                                      const float* pend_d, const int* pend_c, int lane) {
  for (int b = 0; b < np; ++b) {
    const float x = pend_d[b * 32 + lane];
    if (x < dl[K - 1]) insert<K>(dl, il, x, pend_c[b * 32 + lane]);
  }
  if (thr > -INFINITY) thr = dl[K - 1];
  np = 0;
}

struct Probe {
  const float* xb;
  const int* ib;
  const float* xc;
  const int* ic;
  const int* nbr;
  int c, cap, capc, d, t_probe, kw, loop, vec;
  float* out_d;
  int* out_i;
};

// The bytes of a warp's shared memory: the candidate stage ([32][DP] floats, 32 ids) and the
// pending lists ([PB][32] twice), or the rows on their way out ([32][kw | 1] twice: an odd stride,
// free of bank conflicts).
__host__ __device__ inline int warp_bytes(int dp, int kw) {
  const int scan = 32 * dp * 4 + 32 * 4 + PB * 32 * 8;
  const int rows = 32 * (kw | 1) * 8;
  return ((scan > rows ? scan : rows) + 15) / 16 * 16;
}

// Candidates a step: U x DP floats are whole float4s (4 a step at DP = 8 ran slower than 2).
template <int DP>
struct Step {
  static constexpr int U = DP <= 16 ? 2 : 1;
};

// The squared gap between q and [lo, hi] (0 inside).
__device__ __forceinline__ float gap2(float q, float lo, float hi) {
  const float g = fmaxf(fmaxf(lo - q, q - hi), 0.f);
  return g * g;
}
// A slab is skipped where the box's squared distance, times this, still exceeds the kw-th
// distance: the fmaf chain over at most 32 dimensions and the box's sum each round within
// ~34 x 2^-24 of the exact squares, far inside 2^-10.
constexpr float BOX_MARGIN = 1.f - 0x1p-10f;

// One round: each lane's query slot (`slot`, -1 for none; the valid lanes come first) against the
// cell's candidates in concatenation order: the compacted real ones, or (RAW) every slot of the
// T slabs. Writes the round's rows.
template <int DP, int K, bool RAW>
__device__ void probe_round(const Probe& a, const Scratch& s, int cell, int slot, char* wsm, int lane) {
  constexpr int U = Step<DP>::U;
  float* stage = reinterpret_cast<float*>(wsm);               // [32][DP]
  int* stage_id = reinterpret_cast<int*>(stage + 32 * DP);    // [32]
  float* pend_d = reinterpret_cast<float*>(stage_id + 32);    // [PB][32]
  int* pend_c = reinterpret_cast<int*>(pend_d + PB * 32);     // [PB][32]

  float qv[DP], dl[K];
  int il[K];
  int qid = 0;
  float thr = -INFINITY;  // a lane without a query admits nothing
  if (slot >= 0) {
    const long q = (long)cell * a.cap + slot;
    load_row<DP>(qv, a.xb, q, a.d, a.vec);
    qid = a.ib[q];
    thr = INFINITY;
  } else {
#pragma unroll
    for (int j = 0; j < DP; ++j) qv[j] = 0.f;
  }
  init_list<K>(dl, il, a.kw);
  int np = 0;
  // The T slabs in order, up to 32 at a time: lane t holds slab t's cell and its count. Before a
  // slab the warp inserts its pending candidates, then skips the slab where, in every lane, the
  // squared distance from the query to the slab's box exceeds the kw-th distance by more than
  // rounding can bridge: no candidate in it could enter, so the lists stay the parent's bit for
  // bit. (The "other" path walks raw slots, which the box does not cover, and skips nothing.)
  // The slab's rows stream through the stage 32 at a time, the next chunk loaded while the warp
  // scans this one.
  for (int t0 = 0; t0 < a.t_probe; t0 += 32) {
    const int nt = min(32, a.t_probe - t0);
    const int my_cell = lane < nt ? a.nbr[(long)cell * a.t_probe + t0 + lane] : 0;
    const int my_n = lane < nt ? (RAW ? a.capc : s.slab[4 * my_cell]) : 0;
    for (int tt = 0; tt < nt; ++tt) {
      const int n = __shfl_sync(FULL, my_n, tt);
      const int sl = __shfl_sync(FULL, my_cell, tt);
      if (n == 0) continue;
      if (!RAW) {
        if (__any_sync(FULL, np > 0)) flush<K>(dl, il, thr, np, pend_d, pend_c, lane);
        const float4* bx = reinterpret_cast<const float4*>(s.box + (long)sl * 2 * DP);
        float lb = 0.f;
#pragma unroll
        for (int e = 0; e < DP / 4; ++e) {
          const float4 l4 = bx[e], h4 = bx[DP / 4 + e];
          lb += gap2(qv[4 * e], l4.x, h4.x) + gap2(qv[4 * e + 1], l4.y, h4.y) +
                gap2(qv[4 * e + 2], l4.z, h4.z) + gap2(qv[4 * e + 3], l4.w, h4.w);
        }
        if (__all_sync(FULL, lb * BOX_MARGIN > thr)) continue;
      }
      float v[DP];
      int id = 0;
      auto fetch = [&](int r) {  // row r of the slab into v / id; NaN past its end, never admitted
        if (r < n) {
          const long row = (long)sl * a.capc + r;
          if (RAW) {
            load_row<DP>(v, a.xc, row, a.d, a.vec);
            id = a.ic[row];
          } else {
            load_row<DP>(v, s.lx, row, DP, true);
            id = s.lid[row];
          }
        } else {
#pragma unroll
          for (int j = 0; j < DP; ++j) v[j] = __int_as_float(0x7fc00000);
          id = 0;
        }
      };
      fetch(lane);
      for (int r0 = 0; r0 < n; r0 += 32) {
        const int cnt = min(32, n - r0);
        __syncwarp();  // the last chunk's readers are done
        float4* dst = reinterpret_cast<float4*>(stage + lane * DP);
#pragma unroll
        for (int e = 0; e < DP / 4; ++e) dst[e] = make_float4(v[4 * e], v[4 * e + 1], v[4 * e + 2], v[4 * e + 3]);
        stage_id[lane] = id;
        __syncwarp();
        if (r0 + 32 < n) fetch(r0 + 32 + lane);  // in flight while this chunk is scanned
        for (int ci = 0; ci < cnt; ci += U) {
          float cv[U][DP];
          const float4* src = reinterpret_cast<const float4*>(stage + ci * DP);
#pragma unroll
          for (int e = 0; e < U * DP / 4; ++e) {  // the same address in every lane: a broadcast
            const float4 f = src[e];
            cv[(4 * e) / DP][(4 * e) % DP] = f.x;
            cv[(4 * e + 1) / DP][(4 * e + 1) % DP] = f.y;
            cv[(4 * e + 2) / DP][(4 * e + 2) % DP] = f.z;
            cv[(4 * e + 3) / DP][(4 * e + 3) % DP] = f.w;
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            float acc = 0.f;
#pragma unroll
            for (int j = 0; j < DP; ++j) {
              const float df = qv[j] - cv[u][j];
              acc = fmaf(df, df, acc);
            }
            if (acc < thr) {
              const int cid = stage_id[ci + u];
              if (a.loop || cid != qid) {
                pend_d[np * 32 + lane] = acc;
                pend_c[np * 32 + lane] = cid;
                ++np;
              }
            }
          }
          // room for one more step in every pending list, or the warp's lanes insert together
          if (__any_sync(FULL, np > PB - U)) flush<K>(dl, il, thr, np, pend_d, pend_c, lane);
        }
      }
    }
  }
  flush<K>(dl, il, thr, np, pend_d, pend_c, lane);

  // the rows, through the warp's shared memory: a row a store
  const int rs = a.kw | 1;
  float* row_d = reinterpret_cast<float*>(wsm);  // [32][rs]
  int* row_i = reinterpret_cast<int*>(row_d + 32 * rs);
  __syncwarp();
#pragma unroll
  for (int r = 0; r < K; ++r) {
    if (r < K - a.kw) continue;  // the -inf slots
    const bool filled = dl[r] < INFINITY;
    row_d[lane * rs + r - (K - a.kw)] = filled ? dl[r] : INFINITY;
    row_i[lane * rs + r - (K - a.kw)] = filled ? il[r] : 0;
  }
  __syncwarp();
  const int rows = __popc(__ballot_sync(FULL, slot >= 0));
  const int rpi = 32 / a.kw, rr = lane / a.kw, j = lane - rr * a.kw;  // 32 / kw rows a store
  for (int i = 0; i < rows; i += rpi) {
    const int row = i + rr;
    const int sl = __shfl_sync(FULL, slot, min(row, 31));
    if (rr < rpi && row < rows) {
      const long q = (long)cell * a.cap + sl;
      a.out_d[q * a.kw + j] = row_d[row * rs + j];
      a.out_i[q * a.kw + j] = row_i[row * rs + j];
    }
  }
  __syncwarp();
}

// An empty query's row (no "other" slot in the cell): the first kw empty candidates in
// concatenation order that the id test lets through, at distance 0; their ids go to ans[0..n).
// Up to 32 slabs at a time, one a lane: where every slab's empty slots share an id, their counts'
// prefix sum places the ids; else the slabs one by one, a slab whose ids differ slot by slot.
__device__ int empty_row(const Probe& a, const Scratch& s, int cell, int qid, int* ans, int lane) {
  const unsigned below = (1u << lane) - 1u;
  int filled = 0;
  __syncwarp();  // the last row's readers are done
  for (int t0 = 0; t0 < a.t_probe && filled < a.kw; t0 += 32) {
    const int nt = min(32, a.t_probe - t0);
    int4 m = make_int4(0, 0, 0, UNIFORM);
    int sl = 0;
    if (lane < nt) {
      sl = a.nbr[(long)cell * a.t_probe + t0 + lane];
      m = reinterpret_cast<const int4*>(s.slab)[sl];
    }
    const bool uniform = (m.w & UNIFORM) != 0;
    if (__all_sync(FULL, uniform)) {
      const int take = a.loop || m.z != qid ? m.y : 0;
      int end = take;  // inclusive prefix sum: this slab's ids end at filled + end
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, end, o);
        if (lane >= o) end += y;
      }
      for (int j = max(filled + end - take, 0); j < min(filled + end, a.kw); ++j) ans[j] = m.z;
      filled = min(a.kw, filled + __shfl_sync(FULL, end, 31));
      continue;
    }
    for (int tt = 0; tt < nt && filled < a.kw; ++tt) {
      const int n_e = __shfl_sync(FULL, m.y, tt);
      const int e_id = __shfl_sync(FULL, m.z, tt);
      const int st = __shfl_sync(FULL, sl, tt);
      if (n_e == 0) continue;
      if (__shfl_sync(FULL, m.w, tt) & UNIFORM) {
        if (a.loop || e_id != qid) {
          const int take = min(n_e, a.kw - filled);
          if (lane < take) ans[filled + lane] = e_id;
          filled += take;
        }
        continue;
      }
      for (int r0 = 0; r0 < a.capc && filled < a.kw; r0 += 32) {  // ids that differ: the slots
        const int r = r0 + lane;
        bool take = false;
        int id = 0;
        if (r < a.capc) {
          const long row = (long)st * a.capc + r;
          float v[KS];
          load_row<KS>(v, a.xc, row, a.d, false);
          id = a.ic[row];
          take = slot_class<KS>(v, a.d) == EMPTY_SLOT && (a.loop || id != qid);
        }
        const unsigned m2 = __ballot_sync(FULL, take);
        const int at = filled + __popc(m2 & below);
        if (take && at < a.kw) ans[at] = id;
        filled = min(a.kw, filled + __popc(m2));
      }
    }
  }
  __syncwarp();
  return filled;
}

template <int DP, int K>
__global__ void __launch_bounds__(32 * WARPS, DP <= 8 && K <= 16 ? MIN_BLOCKS : 1)
probe_warp_kernel(Probe a, Scratch s) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int groups = (a.cap + 31) / 32;  // warps a cell
  const long unit = (long)blockIdx.x * WARPS + w;
  const int cell = (int)(unit / groups);
  const int g = (int)(unit % groups);
  if (cell >= a.c) return;
  char* wsm = reinterpret_cast<char*>(smem4) + (size_t)w * warp_bytes(DP, a.kw);
  bool other = s.qslab[2 * cell + 1] != 0;
  for (int t0 = 0; t0 < a.t_probe; t0 += 32) {
    const int t = t0 + lane;
    const bool o = t < a.t_probe && (s.slab[4 * a.nbr[(long)cell * a.t_probe + t] + 3] & HAS_OTHER);
    other |= __any_sync(FULL, o);
  }
  if (other) {  // every query slot against every raw candidate slot: the parent's arithmetic
    probe_round<DP, K, true>(a, s, cell, 32 * g + lane < a.cap ? 32 * g + lane : -1, wsm, lane);
    return;
  }
  const int n_real = s.qslab[2 * cell];
  // the real query slots [32 g, 32 g + 32)
  if (32 * g < n_real) {
    const int slot = 32 * g + lane < n_real ? s.qorder[(long)cell * a.cap + 32 * g + lane] : -1;
    probe_round<DP, K, false>(a, s, cell, slot, wsm, lane);
  }
  // the empty query slots [n_real + 32 g, n_real + 32 g + 32) in slot order (qorder's back,
  // read backwards): one row for them all where they share a query id (or with `loop`), written
  // 32 / kw rows a store; else a row a query id
  const int e0 = n_real + 32 * g;
  if (e0 >= a.cap) return;
  int* ans = reinterpret_cast<int*>(wsm);
  const int m = min(32, a.cap - e0);
  const int slot = lane < m ? s.qorder[(long)cell * a.cap + a.cap - 1 - (e0 - n_real) - lane] : 0;
  const int qid = lane < m ? a.ib[(long)cell * a.cap + slot] : 0;
  const int q0 = __shfl_sync(FULL, qid, 0);
  if (a.loop || __all_sync(FULL, lane >= m || qid == q0)) {
    const int filled = empty_row(a, s, cell, q0, ans, lane);
    const int rpi = 32 / a.kw, rr = lane / a.kw, j = lane - rr * a.kw;
    const float dv = j < filled ? 0.f : INFINITY;
    const int iv = j < filled ? ans[j] : 0;
    for (int i = 0; i < m; i += rpi) {
      const int row = i + rr;
      const int sl = __shfl_sync(FULL, slot, min(row, 31));
      if (rr < rpi && row < m) {
        const long q = (long)cell * a.cap + sl;
        a.out_d[q * a.kw + j] = dv;
        a.out_i[q * a.kw + j] = iv;
      }
    }
    return;
  }
  int filled = 0, have_id = 0;
  bool have = false;
  for (int i = 0; i < m; ++i) {
    const int si = __shfl_sync(FULL, slot, i);
    const int qi = __shfl_sync(FULL, qid, i);
    if (!have || qi != have_id) {
      filled = empty_row(a, s, cell, qi, ans, lane);
      have = true;
      have_id = qi;
    }
    if (lane < a.kw) {
      const long q = (long)cell * a.cap + si;
      a.out_d[q * a.kw + lane] = lane < filled ? 0.f : INFINITY;
      a.out_i[q * a.kw + lane] = lane < filled ? ans[lane] : 0;
    }
  }
}

template <int DP, int K>
cudaError_t launch_reg(const Probe& a, void* scratch, cudaStream_t stream) {
  const Scratch s = carve(scratch, a.c, a.cap, a.capc, DP);
  const unsigned blocks = (unsigned)((a.c + WARPS - 1) / WARPS);
  slab_index_kernel<DP><<<blocks, 32 * WARPS, 0, stream>>>(a.xb, a.ib, a.xc, a.ic, a.c, a.cap,
                                                           a.capc, a.d, a.vec, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // a warp for each 32 query slots of a cell; at most 4 x 8,448 bytes (kw = 31 or 32): no
  // opt-in, so a CUDA graph can capture it
  const long units = (long)a.c * ((a.cap + 31) / 32);
  const size_t smem = (size_t)WARPS * warp_bytes(DP, a.kw);
  probe_warp_kernel<DP, K><<<(unsigned)((units + WARPS - 1) / WARPS), 32 * WARPS, smem, stream>>>(a, s);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_reg_k(const Probe& a, void* scratch, cudaStream_t stream) {
  if (a.kw <= 8) return launch_reg<DP, 8>(a, scratch, stream);
  if (a.kw <= 16) return launch_reg<DP, 16>(a, scratch, stream);
  return launch_reg<DP, KS>(a, scratch, stream);
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
// outputs [c * cap, kw] (f32 squared distances ascending, i32 ids). At d <= 32 and kw <= 32,
// scratch holds c * (24 + 8 DP + 4 capc (DP + 1) + 4 cap) bytes (DP: d rounded up to 4, 8, 16 or 32;
// ops/ivf_probe.py scratch_bytes), otherwise it is not read (may be null).
int ivf_probe(const float* xb, const int* ib, const float* xc, const int* ic, const int* nbr,
              float* out_d, int* out_i, void* scratch, int c, int cap, int capc, int d,
              int t_probe, int kw, int loop, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (c == 0 || cap == 0 || kw == 0) return cudaSuccess;
  if (d <= 32 && kw <= KS) {
    if (scratch == nullptr) return cudaErrorInvalidValue;
    const int dp = d <= 4 ? 4 : d <= 8 ? 8 : d <= 16 ? 16 : 32;
    const bool aligned = reinterpret_cast<uintptr_t>(xb) % 16 == 0 && reinterpret_cast<uintptr_t>(xc) % 16 == 0;
    const Probe a = {xb, ib, xc, ic, nbr, c, cap, capc, d, t_probe, kw, loop, d == dp && aligned, out_d, out_i};
    if (dp == 4) return launch_reg_k<4>(a, scratch, stream);
    if (dp == 8) return launch_reg_k<8>(a, scratch, stream);
    if (dp == 16) return launch_reg_k<16>(a, scratch, stream);
    return launch_reg_k<32>(a, scratch, stream);
  }
  if (d <= 4) return launch<4>(xb, ib, xc, ic, nbr, out_d, out_i, c, cap, capc, d, t_probe, kw, loop, stream);
  if (d <= 8) return launch<8>(xb, ib, xc, ic, nbr, out_d, out_i, c, cap, capc, d, t_probe, kw, loop, stream);
  if (d <= 16) return launch<16>(xb, ib, xc, ic, nbr, out_d, out_i, c, cap, capc, d, t_probe, kw, loop, stream);
  if (d <= 32) return launch<32>(xb, ib, xc, ic, nbr, out_d, out_i, c, cap, capc, d, t_probe, kw, loop, stream);
  return launch<0>(xb, ib, xc, ic, nbr, out_d, out_i, c, cap, capc, d, t_probe, kw, loop, stream);
}

}  // extern "C"
