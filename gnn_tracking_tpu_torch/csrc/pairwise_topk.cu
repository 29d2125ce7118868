// Survivor-filtered pairwise top-k for Hopper (sm_90a): a warp-cooperative selection in registers.
//
// Replaces the TPU kernel
// gnn_tracking_tpu/ops/pallas/pairwise_topk.py::pairwise_topk_filter (_pairwise_topk_filter_kernel).
// For every query i: the k nearest valid candidates j by squared Euclidean distance, sorted
// ascending, ties to the lower index. A candidate is valid if its batch id equals the query's
// (masked candidates carry batch id -2) and, unless `loop`, j != i. With a finite radius2 only
// candidates with d2 <= radius2 are kept; unfilled slots are (+inf, 0).
//
// What bounds it on this card: arithmetic. Every query meets every candidate: N^2 distances of
// D dimensions (3 D flops each); at N = 32768, D = 8 that is 25.8 GFLOP against ~3 MB of traffic.
// The direct difference (D subtractions and D FMAs a pair, never the norm expansion) keeps every
// d2 bitwise equal to the split kernel's (csrc/pairwise_topk_split.cu).
//
// Design (the k-selection of Johnson, Douze & Jegou, "Billion-scale similarity search with
// GPUs", WarpSelect; the TPU kernel's k-round peel and while-loop extraction are not carried over):
//  * Keys. A candidate is the 64-bit key (float_bits(d2) << 32) | j. Since d2 >= +0 its bits
//    order like the float, so ascending keys are the contract's order, ties to the lower index,
//    whatever order the candidates are scanned in.
//  * One warp per query: Q = 4, 2 or 1 queries a warp (by k and D), each with its own queues,
//    reusing a candidate's registers Q times. Lane l scans candidates c0 + l, c0 + 32 + l, ...,
//    U = 2 a step (independent distance chains).
//  * Warp queue: the 32 K smallest keys so far, sorted ascending across the warp in registers,
//    "blocked" (lane l holds elements l K .. l K + K - 1), K in {2, 4, 8, 16} (k <= 32 K).
//    It starts as the sentinel (float_bits(radius2) << 32) | 0xFFFFFFFF, computed by the wrapper
//    (radius2 = +inf in kNN mode), so that the strict compare key < tau admits d2 <= radius2
//    inclusively; sentinel slots are written as (+inf, 0). tau is the queue's k-th key.
//  * The common step is the distances and one compare each against tau's d2 (and the batch, when
//    the warp's queries share it), then one vote. Only when a lane passes do the self, batch and
//    exact key compares run: a step that takes at most INSERT keys inserts them one by one into
//    the warp queue (a shift across the lanes, __shfl_up_sync); a denser step (full rows: the
//    untrained latent) pushes them into thread queues of T <= K keys a lane (shift registers).
//    When a thread queue has fewer than U free slots (__any_sync), the warp merges: each lane sorts
//    its T keys (a sorting network in registers), the 32 runs are merged across the warp (bitonic
//    merges with __shfl_xor_sync), the warp queue takes the 32 K smallest of both (min against
//    the reversed run, then a bitonic clean-up), and tau is refreshed. A last merge follows the
//    last tile. The result depends only on the key order, so a second launch gives the same bits.
//  * Candidates stream through shared memory in tiles shared by all warps of a block, copied with
//    cp.async into a ring of three buffers (one __syncthreads a tile; two tiles in flight). A
//    tile holds DP / 4 planes of float4 (plane p: dimensions 4p..4p+3 of every candidate), so a
//    warp reads its 32 candidates as conflict-free 16-byte loads, and the batch ids beside them.
//    The wrapper pads coordinates to DP (4, 8, 16 or 32) columns with zeros, which add nothing to
//    a sum of squares, and the candidate rows to a multiple of 512 with NaN: a NaN d2's bits lie
//    above every sentinel, so padding (and any NaN input) is never admitted and the scan needs no
//    bounds check.
// No per-query state lives in shared memory: registers set the occupancy (one block of 16 warps an
// SM, 8 at D > 16; 16-64 queries a block read the candidates from L2).
//  * Above DP = 32 (d > 32, padded to a multiple of 4 and known at run time): tiles stream
//    through the ring in slabs of up to 32 dimensions, and a lane's 8 candidates of a tile carry
//    their sums across the slabs (topk_select_wide_kernel; one query a warp), so shared memory holds no
//    more than at DP = 32 whatever d is. The sums run over the dimensions ascending as above, and
//    the selection is the same code (take_step).
//  * k > MAX_K (the warp queue's 512 keys): the wrapper runs ceil(k / 512) passes. A pass after
//    the first takes a key floor a query (the last key of the pass before; FLOOR below) and keeps
//    only the candidates whose key is above it. Keys are unique, so the passes' outputs, one after
//    the other, are exactly the top k in key order. Without FLOOR the kernel is the k <= 512 one.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr uint64_t EMPTY = ~0ull;  // thread-queue filler: above every key and every sentinel
constexpr int STAGES = 3;
constexpr int MAX_K = 512;
constexpr int CAND_ALIGN = 512;  // the candidate rows come padded to a multiple of this

// Thread-queue length, queries per warp, candidates a step, insertion limit, block shape and tile
// size for DP padded dimensions and a warp queue of 32 K keys (chosen on an H100: PERF.md).
template <int DP, int K>
struct Cfg {
  static constexpr int T = K < 8 ? K : 8;
  static constexpr int Q = DP > 8 ? 1 : K <= 2 ? 4 : K <= 8 ? 2 : 1;
  static constexpr int U = 2;  // candidates a lane scans a step: two independent sums
  static constexpr unsigned INSERT = K <= 4 ? 16 : 6;  // keys a step inserts one by one, at most
  static constexpr int WARPS = DP >= 32 ? 8 : 16;       // one block an SM: <= 128 registers (255)
  static constexpr int TC = DP <= 8 ? 512 : 256;
  static constexpr int STAGE_F4 = TC * (DP / 4) + TC / 4;  // float4s of one ring buffer
};

__device__ __forceinline__ uint64_t kmin(uint64_t a, uint64_t b) { return a < b ? a : b; }
__device__ __forceinline__ uint64_t kmax(uint64_t a, uint64_t b) { return a < b ? b : a; }

__device__ __forceinline__ void ce(uint64_t& a, uint64_t& b) {  // a <= b afterwards
  const uint64_t lo = kmin(a, b), hi = kmax(a, b);
  a = lo;
  b = hi;
}

__device__ __forceinline__ uint64_t shfl_xor64(uint64_t v, int m) {
  const unsigned lo = __shfl_xor_sync(FULL, static_cast<unsigned>(v), m);
  const unsigned hi = __shfl_xor_sync(FULL, static_cast<unsigned>(v >> 32), m);
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

__device__ __forceinline__ uint64_t shfl64(uint64_t v, int src) {
  const unsigned lo = __shfl_sync(FULL, static_cast<unsigned>(v), src);
  const unsigned hi = __shfl_sync(FULL, static_cast<unsigned>(v >> 32), src);
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Sort a lane's N registers ascending (bitonic network, every index known at compile time).
template <int N>
__device__ __forceinline__ void sort_lane(uint64_t (&v)[N]) {
#pragma unroll
  for (int size = 2; size <= N; size <<= 1) {
#pragma unroll
    for (int stride = size / 2; stride > 0; stride >>= 1) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int j = i ^ stride;
        if (j > i) {
          if ((i & size) == 0) {
            ce(v[i], v[j]);
          } else {
            ce(v[j], v[i]);
          }
        }
      }
    }
  }
}

// Half-cleaners at register strides N/2 .. 1: sorts each lane's N registers ascending when they
// hold a bitonic sequence.
template <int N>
__device__ __forceinline__ void clean_lane(uint64_t (&v)[N]) {
#pragma unroll
  for (int stride = N / 2; stride > 0; stride >>= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if ((i & stride) == 0) ce(v[i], v[i + stride]);
    }
  }
}

// Half-cleaners at lane strides `from` .. 1 (element strides from * N .. N), then in registers.
template <int N>
__device__ __forceinline__ void clean_warp(uint64_t (&v)[N], int lane, int from) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    if (s > from) continue;
    const bool upper = lane & s;
#pragma unroll
    for (int r = 0; r < N; ++r) {
      const uint64_t p = shfl_xor64(v[r], s);
      v[r] = upper ? kmax(v[r], p) : kmin(v[r], p);
    }
  }
  clean_lane<N>(v);
}

// Sort 32 N keys held blocked (element lane * N + r) across the warp ascending: each lane's run
// sorted, then runs of 1, 2, 4, 8, 16 lanes merged pairwise (flip, then half-cleaners).
template <int N>
__device__ __forceinline__ void sort_warp(uint64_t (&v)[N], int lane) {
  sort_lane<N>(v);
#pragma unroll
  for (int lanes = 1; lanes < 32; lanes <<= 1) {
    // element i against i ^ (2 lanes N - 1): lane ^ (2 lanes - 1), register N - 1 - r
    const int m = 2 * lanes - 1;
    const bool upper = lane & lanes;
#pragma unroll
    for (int r = 0; r < (N + 1) / 2; ++r) {
      const int s = N - 1 - r;
      const uint64_t pr = shfl_xor64(v[s], m);  // the partner's v[s] meets our v[r]
      if (s != r) {
        const uint64_t ps = shfl_xor64(v[r], m);  // the partner's v[r] meets our v[s]
        v[s] = upper ? kmax(v[s], ps) : kmin(v[s], ps);
      }
      v[r] = upper ? kmax(v[r], pr) : kmin(v[r], pr);
    }
    clean_warp<N>(v, lane, lanes / 2);
  }
}

// The k-th key of the warp queue, in every lane.
template <int K>
__device__ __forceinline__ uint64_t kth_key(const uint64_t (&w)[K], int k) {
  const int kr = (k - 1) % K;
  uint64_t v = w[0];
#pragma unroll
  for (int r = 1; r < K; ++r) {
    if (r == kr) v = w[r];
  }
  return shfl64(v, (k - 1) / K);
}

// Merge the thread queues `b` into the warp queue `w` and refresh tau (the k-th key); empties `b`.
template <int K, int T>
__device__ __forceinline__ void merge_queues(uint64_t (&w)[K], uint64_t (&b)[T], int& cnt,
                                             uint64_t& tau, int lane, int k) {
  sort_warp<T>(b, lane);
  // w[i] = min(w[i], b[32 K - 1 - i]) with b padded by EMPTY to 32 K keys: the 32 K smallest of
  // both, as a bitonic sequence. b's element j sits at lane j / T, register j % T.
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int src = (31 - lane) * (K / T) + (K - 1 - r) / T;
    uint64_t p = shfl64(b[T - 1 - (r % T)], src & 31);
    if (src >= 32) p = EMPTY;
    w[r] = kmin(w[r], p);
  }
  clean_warp<K>(w, lane, 16);
  tau = kth_key<K>(w, k);
#pragma unroll
  for (int r = 0; r < T; ++r) b[r] = EMPTY;
  cnt = 0;
}

// Insert one key x (the same in every lane, below tau) into the warp queue and refresh tau: an
// element keeps its place below x, x takes the first place at or above it, the rest move up one
// (the last key of each lane to the next lane; the queue's last key drops out).
template <int K>
__device__ __forceinline__ void insert_key(uint64_t (&w)[K], uint64_t x, uint64_t& tau, int lane,
                                           int k) {
  const unsigned lo = __shfl_up_sync(FULL, static_cast<unsigned>(w[K - 1]), 1);
  const unsigned hi = __shfl_up_sync(FULL, static_cast<unsigned>(w[K - 1] >> 32), 1);
  uint64_t prev = lane == 0 ? 0ull : (static_cast<uint64_t>(hi) << 32) | lo;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const uint64_t cur = w[r];
    w[r] = cur < x ? cur : (prev < x ? x : prev);
    prev = cur;
  }
  tau = kth_key<K>(w, k);
}

// One step's selection for Q queries and U candidates a lane (d2: their distances; `any`: the
// lane holds a candidate that may pass its query's tau). Behind one vote, the self, batch, floor
// and exact key compares; a step that takes at most INSERT keys inserts them one by one into the
// warp queues (no thread-queue round trip), a denser step pushes them into the thread queues and
// merges those that may not take the next step's U keys.
template <int K, int T, int Q, int U, unsigned INSERT, bool FLOOR>
__device__ __forceinline__ void take_step(const float (&d2)[Q][U], const int (&cb)[U],
                                          const int (&cc)[U], bool any, const int (&qb)[Q],
                                          const int (&qx)[Q], const uint64_t (&fl)[Q],
                                          uint64_t (&w)[Q][K], uint64_t (&b)[Q][T],
                                          int (&cnt)[Q], uint64_t (&tau)[Q], int lane, int k) {
  if (!__any_sync(FULL, any)) return;
  uint64_t key[Q][U];
  bool take[Q][U];
  unsigned takes = 0;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      key[q][u] = (static_cast<uint64_t>(__float_as_uint(d2[q][u])) << 32) |
                  static_cast<unsigned>(cc[u]);
      take[q][u] = cb[u] == qb[q] && cc[u] != qx[q] && key[q][u] < tau[q] &&
                   (!FLOOR || key[q][u] > fl[q]);
      takes += take[q][u];
    }
  }
  if (__reduce_add_sync(FULL, takes) <= INSERT) {
    // a few keys: each goes straight into its warp queue (no thread-queue round trip)
#pragma unroll
    for (int q = 0; q < Q; ++q) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        for (unsigned m = __ballot_sync(FULL, take[q][u]); m != 0; m &= m - 1) {
          const uint64_t x = shfl64(key[q][u], __ffs(m) - 1);
          if (x < tau[q]) insert_key<K>(w[q], x, tau[q], lane, k);
        }
      }
    }
  } else {
    bool full = false;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (take[q][u]) {
#pragma unroll
          for (int r = T - 1; r > 0; --r) b[q][r] = b[q][r - 1];
          b[q][0] = key[q][u];
          ++cnt[q];
        }
      }
      full |= cnt[q] > T - U;  // the next step may push U keys
    }
    if (__any_sync(FULL, full)) {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        if (__any_sync(FULL, cnt[q] > T - U)) {
          merge_queues<K, T>(w[q], b[q], cnt[q], tau[q], lane, k);
        }
      }
    }
  }
}

template <int DP, int K>
__device__ __forceinline__ void load_tile(float4* stage, const float4* __restrict__ xp,
                                          const int* __restrict__ cbatch, int c0) {
  using C = Cfg<DP, K>;
  constexpr int P = DP / 4, THREADS = C::WARPS * 32;
  for (int e = threadIdx.x; e < C::TC * P; e += THREADS) {
    const int c = e / P, p = e % P;
    cp_async16(stage + p * C::TC + c, xp + (long)(c0 + c) * P + p);
  }
  int* tb = reinterpret_cast<int*>(stage + C::TC * P);
  for (int e = threadIdx.x; e < C::TC / 4; e += THREADS) cp_async16(tb + 4 * e, cbatch + c0 + 4 * e);
}

// Candidates rr .. rr + U - 1 of a lane's share of the tile in shared memory: coordinates and batch.
template <int DP, int U, int TC>
__device__ __forceinline__ void load_step(const float4* planes, const int* tb, int rr, int lane,
                                          float (&cv)[U][DP], int (&cb)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int ci = (rr + u) * 32 + lane;
#pragma unroll
    for (int p = 0; p < DP / 4; ++p) {
      const float4 v = planes[p * TC + ci];
      cv[u][4 * p] = v.x;
      cv[u][4 * p + 1] = v.y;
      cv[u][4 * p + 2] = v.z;
      cv[u][4 * p + 3] = v.w;
    }
    cb[u] = tb[ci];
  }
}

template <int DP, int K, bool FLOOR>
__global__ void __launch_bounds__(Cfg<DP, K>::WARPS * 32, 1)
topk_select_kernel(const float4* __restrict__ xp, const int* __restrict__ cbatch,
                   const int* __restrict__ qbatch, const uint64_t* __restrict__ floor, int n,
                   int k, int loop, uint64_t sentinel, float* __restrict__ out_d,
                   int* __restrict__ out_i) {
  using C = Cfg<DP, K>;
  constexpr int T = C::T, U = C::U, Q = C::Q, TC = C::TC, P = DP / 4;
  extern __shared__ float4 smem[];

  const int lane = threadIdx.x & 31;
  const int q0 = (blockIdx.x * C::WARPS + (threadIdx.x >> 5)) * Q;
  const bool active = q0 < n;  // warp-uniform

  float qv[Q][DP];
  int qb[Q], qi[Q], qx[Q], cnt[Q];
  uint64_t w[Q][K], b[Q][T], tau[Q], fl[Q];  // fl: the key floor (FLOOR), else unused
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    qi[q] = min(q0 + q, n - 1);  // a warp's queries past n repeat query n - 1 and write nothing
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float4 v = xp[(long)qi[q] * P + p];
      qv[q][4 * p] = v.x;
      qv[q][4 * p + 1] = v.y;
      qv[q][4 * p + 2] = v.z;
      qv[q][4 * p + 3] = v.w;
    }
    qb[q] = qbatch[qi[q]];
    qx[q] = loop ? -1 : qi[q];  // the candidate index a query excludes (none with `loop`)
    fl[q] = FLOOR ? floor[qi[q]] : 0ull;
    cnt[q] = 0;
    tau[q] = sentinel;
#pragma unroll
    for (int r = 0; r < K; ++r) w[q][r] = sentinel;
#pragma unroll
    for (int r = 0; r < T; ++r) b[q][r] = EMPTY;
  }

  bool one_batch = true;  // the warp's queries share a batch id: one compare a candidate serves all
#pragma unroll
  for (int q = 1; q < Q; ++q) one_batch &= qb[q] == qb[0];

  const int tiles = (n + TC - 1) / TC;
  load_tile<DP, K>(smem, xp, cbatch, 0);
  cp_async_commit();
  if (tiles > 1) load_tile<DP, K>(smem + C::STAGE_F4, xp, cbatch, TC);
  cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<1>();  // tile t has landed (tile t + 1 may be in flight)
    __syncthreads();     // ... for every thread's copies, and every warp is done with tile t - 1
    if (t + 2 < tiles) {
      load_tile<DP, K>(smem + ((t + 2) % STAGES) * C::STAGE_F4, xp, cbatch, (t + 2) * TC);
    }
    cp_async_commit();
    if (!active) continue;
    const float4* planes = smem + (t % STAGES) * C::STAGE_F4;
    const int* tb = reinterpret_cast<const int*>(planes + TC * P);
    const int c0 = t * TC;
    // whole tiles: the rows past n are NaN, whose keys are never below tau
    for (int rr = 0; rr < TC / 32; rr += U) {
      float cv[U][DP];  // this step's candidates (U a lane)
      int cb[U], cc[U];
      load_step<DP, U, TC>(planes, tb, rr, lane, cv, cb);
      bool near[U];  // the candidate may be taken at all: its batch is the queries' (when shared)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        cc[u] = c0 + (rr + u) * 32 + lane;
        near[u] = cb[u] == qb[0] || !one_batch;
      }
      // distances for U candidates x Q queries, held to tau's distance only (d2 <= tau's d2, one
      // compare, and the batch when the warp's queries share it); self, batch and the exact key
      // compare follow behind one vote, where the candidates near tau (rare once it has settled)
      // are inserted or pushed
      float d2[Q][U];
      bool any = false;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float acc = 0.f;
#pragma unroll
          for (int j = 0; j < DP; ++j) {
            const float df = qv[q][j] - cv[u][j];
            acc = fmaf(df, df, acc);
          }
          d2[q][u] = acc;
          any |= near[u] && __float_as_uint(acc) <= static_cast<unsigned>(tau[q] >> 32);
        }
      }
      take_step<K, T, Q, U, C::INSERT, FLOOR>(d2, cb, cc, any, qb, qx, fl, w, b, cnt, tau, lane, k);
    }
  }
  if (!active) return;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    if (__any_sync(FULL, cnt[q] > 0)) merge_queues<K, T>(w[q], b[q], cnt[q], tau[q], lane, k);
    if (q0 + q >= n) continue;
    const long base = (long)(q0 + q) * k;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const int i = lane * K + r;
      if (i >= k) continue;
      const uint64_t key = w[q][r];
      const bool filled = key < sentinel;
      out_d[base + i] = filled ? __uint_as_float(static_cast<unsigned>(key >> 32)) : INFINITY;
      out_i[base + i] = filled ? static_cast<int>(static_cast<unsigned>(key)) : 0;
    }
  }
}

// The kernel for DP > 32 padded dimensions (a multiple of 4, known at run time), any k of the warp
// queue: one query a warp; tiles of TC candidates, each streamed through the same ring in slabs of
// DC dimensions, the last slab of a tile narrower where DC does not divide DP (plane p of a slab:
// dimensions 4p..4p+3 of the slab's, as above);
// a lane sums the distances of its TC / 32 candidates of the tile over the slabs, fmaf over the
// dimensions ascending, exactly as the kernel above (so every d2 has the same bits), the query's
// DC coordinates of a slab coming from device memory (the same address in every lane); after
// the tile's last slab it runs the same selection over them, U a step.
// f(std::integral_constant<int, W>{}) for the run-time w in 1 .. N: a slab's width as a constant,
// so that its loops unroll fully
template <int N, typename F>
__device__ __forceinline__ void with_width(int w, F f) {
  if constexpr (N > 1) {
    if (w < N) return with_width<N - 1>(w, f);
  }
  f(std::integral_constant<int, N>{});
}

struct Wide {
  static constexpr int TC = 256, DC = 32, PC = DC / 4, WARPS = 8, U = 2;
  static constexpr int SLAB_F4 = TC * PC + TC / 4;  // float4s of one ring buffer
};

template <int K, bool FLOOR>
__global__ void __launch_bounds__(Wide::WARPS * 32, 1)
topk_select_wide_kernel(const float4* __restrict__ xp, const int* __restrict__ cbatch,
                        const int* __restrict__ qbatch, const uint64_t* __restrict__ floor,
                        int n, int dp, int k, int loop, uint64_t sentinel,
                        float* __restrict__ out_d, int* __restrict__ out_i) {
  constexpr int T = K < 8 ? K : 8, U = Wide::U, TC = Wide::TC, PC = Wide::PC;
  constexpr int CPL = TC / 32;  // candidates of a tile a lane
  constexpr unsigned INSERT = K <= 4 ? 16 : 6;
  constexpr int THREADS = Wide::WARPS * 32;
  extern __shared__ float4 smem[];

  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * Wide::WARPS + (threadIdx.x >> 5);
  const bool active = q0 < n;  // warp-uniform
  const int qi = min(q0, n - 1);
  const int P = dp / 4, nc = (P + PC - 1) / PC;  // slabs a tile; the last may be narrower
  const float4* qrow = xp + (long)qi * P;
  int qb[1] = {qbatch[qi]}, qx[1] = {loop ? -1 : qi}, cnt[1] = {0};
  uint64_t w[1][K], b[1][T], tau[1] = {sentinel}, fl[1] = {FLOOR ? floor[qi] : 0ull};
#pragma unroll
  for (int r = 0; r < K; ++r) w[0][r] = sentinel;
#pragma unroll
  for (int r = 0; r < T; ++r) b[0][r] = EMPTY;

  // slab s: tile s / nc, its float4 columns PC (s % nc) .. (at most PC, fewer in a tile's last
  // slab where PC does not divide P); the tile's batch ids with its last slab
  auto load_slab = [&](float4* stage, int s) {
    const int c0 = (s / nc) * TC, c = s % nc, pc = min(PC, P - c * PC);
    for (int e = threadIdx.x; e < TC * pc; e += THREADS) {
      const int ci = e / pc, p = e % pc;
      cp_async16(stage + p * TC + ci, xp + (long)(c0 + ci) * P + c * PC + p);
    }
    if (c == nc - 1) {
      int* tb = reinterpret_cast<int*>(stage + TC * PC);
      for (int e = threadIdx.x; e < TC / 4; e += THREADS) cp_async16(tb + 4 * e, cbatch + c0 + 4 * e);
    }
  };
  const int slabs = (n + TC - 1) / TC * nc;
  load_slab(smem, 0);
  cp_async_commit();
  if (slabs > 1) load_slab(smem + Wide::SLAB_F4, 1);
  cp_async_commit();
  float acc[CPL];
  for (int s = 0; s < slabs; ++s) {
    cp_async_wait<1>();  // slab s has landed (slab s + 1 may be in flight)
    __syncthreads();     // ... for every thread's copies, and every warp is done with slab s - 1
    if (s + 2 < slabs) load_slab(smem + ((s + 2) % STAGES) * Wide::SLAB_F4, s + 2);
    cp_async_commit();
    if (!active) continue;
    const float4* planes = smem + (s % STAGES) * Wide::SLAB_F4;
    const int c = s % nc, pc = min(PC, P - c * PC);
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < CPL; ++i) acc[i] = 0.f;
    }
    with_width<PC>(pc, [&](auto width) {  // the slab's float4 columns, known at compile time
      constexpr int W = decltype(width)::value;
      float qv[4 * W];
#pragma unroll
      for (int p = 0; p < W; ++p) {
        const float4 v = __ldg(qrow + c * PC + p);
        qv[4 * p] = v.x;
        qv[4 * p + 1] = v.y;
        qv[4 * p + 2] = v.z;
        qv[4 * p + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
#pragma unroll
        for (int p = 0; p < W; ++p) {
          const float4 v = planes[p * TC + i * 32 + lane];
          const float cv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float df = qv[4 * p + j] - cv[j];
            acc[i] = fmaf(df, df, acc[i]);
          }
        }
      }
    });
    if (c != nc - 1) continue;
    // whole tiles: the rows past n are NaN, whose keys are never below tau
    const int* tb = reinterpret_cast<const int*>(planes + TC * PC);
    const int c0 = (s / nc) * TC;
#pragma unroll
    for (int rr = 0; rr < CPL; rr += U) {
      float d2[1][U];
      int cb[U], cc[U];
      bool any = false;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int ci = (rr + u) * 32 + lane;
        cb[u] = tb[ci];
        cc[u] = c0 + ci;
        d2[0][u] = acc[rr + u];
        any |= cb[u] == qb[0] && __float_as_uint(acc[rr + u]) <= static_cast<unsigned>(tau[0] >> 32);
      }
      take_step<K, T, 1, U, INSERT, FLOOR>(d2, cb, cc, any, qb, qx, fl, w, b, cnt, tau, lane, k);
    }
  }
  if (!active) return;
  if (__any_sync(FULL, cnt[0] > 0)) merge_queues<K, T>(w[0], b[0], cnt[0], tau[0], lane, k);
  const long base = (long)q0 * k;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int i = lane * K + r;
    if (i >= k) continue;
    const uint64_t key = w[0][r];
    const bool filled = key < sentinel;
    out_d[base + i] = filled ? __uint_as_float(static_cast<unsigned>(key >> 32)) : INFINITY;
    out_i[base + i] = filled ? static_cast<int>(static_cast<unsigned>(key)) : 0;
  }
}

template <int K, bool FLOOR = false>
cudaError_t launch_wide(const float* xp, const int* cbatch, const int* qbatch,
                        const uint64_t* floor, int n, int dp, int k, int loop, uint64_t sentinel,
                        float* out_d, int* out_i, cudaStream_t stream) {
  static_assert(CAND_ALIGN % Wide::TC == 0, "tiles must divide the candidate padding");
  const size_t smem = (size_t)STAGES * Wide::SLAB_F4 * sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(topk_select_wide_kernel<K, FLOOR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (n + Wide::WARPS - 1) / Wide::WARPS;
  topk_select_wide_kernel<K, FLOOR><<<grid, Wide::WARPS * 32, smem, stream>>>(
      reinterpret_cast<const float4*>(xp), cbatch, qbatch, floor, n, dp, k, loop, sentinel, out_d,
      out_i);
  return cudaGetLastError();
}

// The queue for k as in launch_k; dp > 32 at run time
cudaError_t launch_wide_k(const float* xp, const int* cbatch, const int* qbatch,
                          const uint64_t* floor, int n, int dp, int k, int loop,
                          uint64_t sentinel, float* out_d, int* out_i, cudaStream_t stream) {
  if (floor != nullptr) {
    return launch_wide<16, true>(xp, cbatch, qbatch, floor, n, dp, k, loop, sentinel, out_d, out_i,
                                 stream);
  }
  const int per_lane = (k + 31) / 32;
  if (per_lane <= 2) return launch_wide<2>(xp, cbatch, qbatch, floor, n, dp, k, loop, sentinel, out_d, out_i, stream);
  if (per_lane <= 4) return launch_wide<4>(xp, cbatch, qbatch, floor, n, dp, k, loop, sentinel, out_d, out_i, stream);
  if (per_lane <= 8) return launch_wide<8>(xp, cbatch, qbatch, floor, n, dp, k, loop, sentinel, out_d, out_i, stream);
  return launch_wide<16>(xp, cbatch, qbatch, floor, n, dp, k, loop, sentinel, out_d, out_i, stream);
}

template <int DP, int K, bool FLOOR = false>
cudaError_t launch(const float* xp, const int* cbatch, const int* qbatch, const uint64_t* floor,
                   int n, int k, int loop, uint64_t sentinel, float* out_d, int* out_i,
                   cudaStream_t stream) {
  using C = Cfg<DP, K>;
  static_assert(CAND_ALIGN % C::TC == 0, "tiles must divide the candidate padding");
  const size_t smem = (size_t)STAGES * C::STAGE_F4 * sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(topk_select_kernel<DP, K, FLOOR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int per_block = C::WARPS * C::Q;
  const int grid = (n + per_block - 1) / per_block;
  topk_select_kernel<DP, K, FLOOR><<<grid, C::WARPS * 32, smem, stream>>>(
      reinterpret_cast<const float4*>(xp), cbatch, qbatch, floor, n, k, loop, sentinel, out_d,
      out_i);
  return cudaGetLastError();
}

// A pass with a key floor takes the widest queue (passes after the first are for k > MAX_K)
template <int DP>
cudaError_t launch_k(const float* xp, const int* cbatch, const int* qbatch, const uint64_t* floor,
                     int n, int k, int loop, uint64_t sentinel, float* out_d, int* out_i,
                     cudaStream_t stream) {
  if (floor != nullptr) {
    return launch<DP, 16, true>(xp, cbatch, qbatch, floor, n, k, loop, sentinel, out_d, out_i,
                                stream);
  }
  const int per_lane = (k + 31) / 32;  // K = 2 at the least: thread queues of 2 merge half as often
  if (per_lane <= 2) return launch<DP, 2>(xp, cbatch, qbatch, floor, n, k, loop, sentinel, out_d, out_i, stream);
  if (per_lane <= 4) return launch<DP, 4>(xp, cbatch, qbatch, floor, n, k, loop, sentinel, out_d, out_i, stream);
  if (per_lane <= 8) return launch<DP, 8>(xp, cbatch, qbatch, floor, n, k, loop, sentinel, out_d, out_i, stream);
  return launch<DP, 16>(xp, cbatch, qbatch, floor, n, k, loop, sentinel, out_d, out_i, stream);
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// xp [rows, dp] f32: the points (masked queries already zero-substituted), zero-padded to dp
// columns (4, 8, 16 or 32, or above 32 a multiple of 4: the run-time-d kernel), then NaN rows to
// rows, a multiple of CAND_ALIGN (whole tiles: the scan reads every row of a tile); cbatch [rows]
// i32 (-2 = masked); qbatch [n] i32; outputs [n, k].
// sentinel = (float_bits(radius2) << 32) | 0xFFFFFFFF, radius2 = +inf for plain k-nearest, 0 to
// admit nothing. floor: null, or [n] keys (as int64, all below 2^63) that each query's candidates
// must exceed (a pass after the first for k > MAX_K).
int pairwise_topk_filter(const float* xp, const int* cbatch, const int* qbatch,
                         const unsigned long long* floor, float* out_d, int* out_i, int n,
                         int rows, int d, int dp, int k, int loop, unsigned long long sentinel,
                         void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n == 0 || k == 0) return cudaSuccess;
  if (n < 0 || k < 0 || k > MAX_K || d < 0 || d > dp) return cudaErrorInvalidValue;
  if (rows < n || rows % CAND_ALIGN != 0) return cudaErrorInvalidValue;  // padding too short
  const uint64_t s = sentinel;
  const uint64_t* f = reinterpret_cast<const uint64_t*>(floor);
  if (dp == 4) return launch_k<4>(xp, cbatch, qbatch, f, n, k, loop, s, out_d, out_i, stream);
  if (dp == 8) return launch_k<8>(xp, cbatch, qbatch, f, n, k, loop, s, out_d, out_i, stream);
  if (dp == 16) return launch_k<16>(xp, cbatch, qbatch, f, n, k, loop, s, out_d, out_i, stream);
  if (dp == 32) return launch_k<32>(xp, cbatch, qbatch, f, n, k, loop, s, out_d, out_i, stream);
  if (dp > 32 && dp % 4 == 0) {
    return launch_wide_k(xp, cbatch, qbatch, f, n, dp, k, loop, s, out_d, out_i, stream);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
