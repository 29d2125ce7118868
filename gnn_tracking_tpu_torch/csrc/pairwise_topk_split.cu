// Exact pairwise top-k with split candidate ranges, for Hopper (sm_90a), for k <= KS = 32.
//
// Replaces the TPU kernels gnn_tracking_tpu/ops/pallas/pairwise_topk.py::pairwise_topk
// (_pairwise_topk_kernel: candidates resident in VMEM, with batch ids) and ::pairwise_topk_streaming
// (_pairwise_topk_stream_kernel: candidates streamed from HBM, 2-D grid, running top-k revisited
// across candidate blocks). Both compute one function; on this card they are one kernel pair.
// For every valid query i: the k nearest valid candidates j by squared Euclidean distance, sorted
// ascending, ties to the lower index. A candidate is valid if it is unmasked, its batch id equals
// the query's and, unless `loop`, j != i. Masked queries get (+inf, 0) in every slot, as do slots
// left unfilled. Larger k take csrc/pairwise_topk.cu (the wrapper's choice).
//
// What bounds it on this card: arithmetic. Every valid query meets every candidate of its batch.
// A pair costs D subtractions and D FMAs (the direct difference, fmaf in dimension order, as
// csrc/pairwise_topk.cu computes it, so both kernels give the same bits) and one compare: 17
// FP32-pipe instructions at D = 8. At N = 262,144 that is 6.87e10 pairs, ~35-39 ms of issue on
// 132 SMs x 128 lanes at 1.755-1.98 GHz; the data (N x D floats) is a few MB.
// Design, two kernels after a layout pass:
//  L (layout): the points padded to DP columns and whole tiles, NaN in masked and padding rows,
//    the batch ids, and the smallest and largest batch id of the unmasked rows of every tile of TC
//    candidates, one warp a tile; it sets the shared bounds to +inf.
//  P (partial top-k): grid (query blocks x S candidate splits), 128 threads a block.
//    * Each thread owns R queries (1 or 2) with their DP coordinates in registers, and takes U =
//      4 / R candidates a step (fewer at wide DP): a step holds R x U independent distance chains.
//      Every thread of the block reads the same candidate, a broadcast from shared memory, so a
//      candidate's DP floats are loaded once a thread and used R times.
//    * Each query keeps its running top-k in registers: K (a power of two >= k) distances and
//      indices, sorted ascending, every index known at compile time; the first K - k slots hold
//      -inf, so tau, the k-th distance (+inf while unfilled), is always the last slot. The common
//      step is the distances and one compare each against tau;
//      the unrolled insertion (and the batch and self tests) run only for a candidate below tau,
//      about k (1 + ln(span / k)) times a query in a split of `span` candidates.
//    * Ties without 64-bit keys: a split's candidates are scanned in index order, so a candidate
//      equal in distance to an entry comes after it. The test is strict (d2 < tau) and the
//      insertion places it after equal entries: ascending (d2, index).
//    * Masked candidates, padding rows and masked queries carry NaN coordinates (L writes them):
//      a NaN d2 never passes d2 < tau, so there is no mask test a pair, and a masked query fills
//      no slot.
//    * The S splits of a query share a bound (one atomicMin a tile and query in an array of N
//      floats): the k-th distance of any split's full list is at least the query's k-th nearest,
//      so a candidate above it is dropped (d2 equal to it is kept: it may win its tie by index).
//      A list then holds every one of the query's k nearest that its split has, and maybe
//      others; M's merge is exact all the same. Without the bound every split restarts its list,
//      and the insertions grow with S.
//    * A block skips (and does not load) every tile whose batch range misses the batch range of
//      its queries; the other tiles stream through a cp.async ring of three buffers (one
//      __syncthreads a tile, two tiles in flight).
//    * It writes [S, k, N] partials, unfilled slots +inf.
//  M (merge): one thread a query. The S sorted lists, in split (= index) order, each from its head
//    while below the k-th distance so far, go through P's insertion, so ties stay at the lower
//    index. Writes k slots, (+inf, 0) where unfilled.
// Above DP = 32 (d > 32, padded to a multiple of 4 and known at run time) P streams slabs of 32
// candidates x up to 32 dimensions and a thread carries its query's 32 sums across a group's slabs
// (topk_partial_wide_kernel, R = 1): shared memory stays at 12.4 KiB whatever d is. M is the same.
// R and S (pairwise_topk_split_plan): R = 2 where its query blocks fill the card's resident blocks
// once, else 1; then S splits so that the grid fills them about twice.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 128;     // threads a block of P
constexpr int TC = 256;          // candidates a tile
constexpr int STAGES = 3;        // cp.async ring
constexpr int KS = 32;           // largest k
constexpr int MAX_S = 64;        // candidate splits
constexpr int CAND_ALIGN = 512;  // rows are padded to a multiple: whole tiles, whole query blocks
constexpr int MB = 128;          // threads a block of M

// DP padded dimensions, a list of K slots a query, R queries a thread, U candidates a step (four
// distance chains, fewer at wide DP); OK: the instantiation is built (R = 1 always, R = 2 while
// its lists and coordinates take at most 112 registers; R = 4 was slower on an H100, PERF.md).
template <int DP_, int K_, int R_>
struct Cfg {
  static constexpr int DP = DP_, K = K_, R = R_, P = DP_ / 4;
  static constexpr int U = DP_ <= 8 || 32 / DP_ >= 4 / R_ ? 4 / R_ : 32 / DP_;
  static constexpr bool OK = R_ == 1 || (R_ == 2 && R_ * 2 * K_ + (R_ + U) * DP_ <= 112);
  static constexpr int STAGE_F4 = TC * P + TC / 4;  // float4s of one ring buffer: points, batch ids
  static constexpr size_t SMEM = (size_t)STAGES * STAGE_F4 * sizeof(float4);
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A query's list: K slots, ascending. The first K - k hold -inf (never moved: every candidate is
// above them), the last k the running top-k (+inf while unfilled), so the k-th distance is always
// d[K - 1]: no slot is chosen at run time.
template <int K>
__device__ __forceinline__ void init_list(float (&d)[K], int (&ix)[K], int k) {
#pragma unroll
  for (int r = 0; r < K; ++r) {
    d[r] = r < K - k ? -INFINITY : INFINITY;
    ix[r] = 0;
  }
}

// Insert (x, c), x < d[K - 1], into the list: entries below or equal to x keep their place (equal
// ones have lower indices), the rest move up one and the last drops out.
template <int K>
__device__ __forceinline__ void insert(float (&d)[K], int (&ix)[K], float x, int c) {
#pragma unroll
  for (int r = K - 1; r > 0; --r) {
    const bool up = d[r - 1] > x;       // entry r - 1 moves to r
    const bool here = !up && d[r] > x;  // x lands at r
    d[r] = up ? d[r - 1] : (here ? x : d[r]);
    ix[r] = up ? ix[r - 1] : (here ? c : ix[r]);
  }
  if (d[0] > x) {
    d[0] = x;
    ix[0] = c;
  }
}

// One warp a tile of TC rows: the points zero-padded to dp columns, NaN in every column of a
// masked or padding row; the batch ids (0 without batch); the shared bounds +inf; the tile's
// batch range over its unmasked rows (INT_MAX, INT_MIN where it has none).
__global__ void __launch_bounds__(128)
layout_kernel(const float* __restrict__ x, const uint8_t* __restrict__ mask,
              const int* __restrict__ batch, int n, int d, int dp, int tiles,
              float* __restrict__ xp, int* __restrict__ bp, int2* __restrict__ trange,
              unsigned* __restrict__ bound) {
  const int tile = blockIdx.x * 4 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (tile >= tiles) return;  // the whole warp
  const int row0 = tile * TC;
  auto valid = [&](int row) { return row < n && (mask == nullptr || mask[row]); };
  for (int e = lane; e < TC * dp; e += 32) {  // consecutive lanes, consecutive floats
    const int row = row0 + e / dp, j = e % dp;
    float v = __int_as_float(0x7fc00000);  // NaN: a masked or padding row
    if (valid(row)) v = j < d ? x[(long)row * d + j] : 0.f;
    xp[(long)row0 * dp + e] = v;
  }
  int lo = INT_MAX, hi = INT_MIN;
  for (int row = row0 + lane; row < row0 + TC; row += 32) {
    const int b = row < n && batch != nullptr ? batch[row] : 0;
    bp[row] = b;
    bound[row] = 0x7f800000u;  // +inf
    if (valid(row)) {
      lo = min(lo, b);
      hi = max(hi, b);
    }
  }
  lo = __reduce_min_sync(FULL, lo);
  hi = __reduce_max_sync(FULL, hi);
  if (lane == 0) trange[tile] = make_int2(lo, hi);
}

template <typename C>
__device__ __forceinline__ void load_tile(float4* stage, const float4* __restrict__ xp,
                                          const int* __restrict__ batch, int tile) {
  const float4* src = xp + (long)tile * TC * C::P;
  for (int e = threadIdx.x; e < TC * C::P; e += THREADS) cp_async16(stage + e, src + e);
  int* tb = reinterpret_cast<int*>(stage + TC * C::P);
  const int* bsrc = batch + (long)tile * TC;
  for (int e = threadIdx.x; e < TC / 4; e += THREADS) cp_async16(tb + 4 * e, bsrc + 4 * e);
}

template <int DP_, int K_, int R_>
__global__ void __launch_bounds__(THREADS)
topk_partial_kernel(const float4* __restrict__ xp, const int* __restrict__ batch,
                    const int2* __restrict__ trange, unsigned* __restrict__ bound, int n, int tiles,
                    int k, int loop, int span_tiles, float* __restrict__ part_d,
                    int* __restrict__ part_i) {
  using C = Cfg<DP_, K_, R_>;
  constexpr int DP = C::DP, K = C::K, R = C::R, P = C::P, U = C::U;
  extern __shared__ float4 smem[];
  __shared__ int qrange[2];

  const int t = threadIdx.x;
  const int q0 = blockIdx.x * THREADS * R;
  const int s = blockIdx.y;
  const int t_begin = s * span_tiles;
  const int t_end = min(tiles, t_begin + span_tiles);

  float qv[R][DP], d[R][K], thr[R];
  int qb[R], qs[R], ix[R][K];
  int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int q = q0 + r * THREADS + t;  // < rows: the query blocks fit the padding
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float4 v = xp[(long)q * P + p];
      qv[r][4 * p] = v.x;
      qv[r][4 * p + 1] = v.y;
      qv[r][4 * p + 2] = v.z;
      qv[r][4 * p + 3] = v.w;
    }
    qb[r] = batch[q];
    qs[r] = loop ? -1 : q;  // the candidate a query excludes (none with `loop`)
    if (!isnan(qv[r][0])) {
      lo = min(lo, qb[r]);
      hi = max(hi, qb[r]);
    }
    init_list<K>(d[r], ix[r], k);
    thr[r] = INFINITY;
  }
  if (t == 0) {
    qrange[0] = INT_MAX;
    qrange[1] = INT_MIN;
  }
  __syncthreads();
  lo = __reduce_min_sync(FULL, lo);
  hi = __reduce_max_sync(FULL, hi);
  if ((t & 31) == 0) {
    atomicMin(&qrange[0], lo);
    atomicMax(&qrange[1], hi);
  }
  __syncthreads();
  const int qlo = qrange[0], qhi = qrange[1];
  // the next tile at or after tt whose batch range meets the queries' (t_end if none)
  auto next_live = [&](int tt) {
    for (; tt < t_end; ++tt) {
      const int2 b = trange[tt];
      if (b.x <= qhi && b.y >= qlo) break;
    }
    return tt;
  };

  int cur = next_live(t_begin);
  int nxt = cur < t_end ? next_live(cur + 1) : t_end;
  if (cur < t_end) load_tile<C>(smem, xp, batch, cur);
  cp_async_commit();
  if (nxt < t_end) load_tile<C>(smem + C::STAGE_F4, xp, batch, nxt);
  cp_async_commit();
  for (int i = 0; cur < t_end; ++i) {
    cp_async_wait<1>();  // tile i has landed (tile i + 1 may be in flight)
    __syncthreads();     // ... for every thread's copies, and every thread is done with tile i - 1
    const int after = nxt < t_end ? next_live(nxt + 1) : t_end;
    if (after < t_end) load_tile<C>(smem + ((i + 2) % STAGES) * C::STAGE_F4, xp, batch, after);
    cp_async_commit();
    const float4* tile = smem + (i % STAGES) * C::STAGE_F4;
    const int* tb = reinterpret_cast<const int*>(tile + TC * P);
    const int c0 = cur * TC;
#pragma unroll 2
    for (int ci = 0; ci < TC; ci += U) {
      float cv[U][DP];
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const float4 v = tile[(ci + u) * P + p];  // the same address in every lane: a broadcast
          cv[u][4 * p] = v.x;
          cv[u][4 * p + 1] = v.y;
          cv[u][4 * p + 2] = v.z;
          cv[u][4 * p + 3] = v.w;
        }
      }
      float d2[R][U];
      bool any = false;
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float acc = 0.f;
#pragma unroll
          for (int j = 0; j < DP; ++j) {
            const float df = qv[r][j] - cv[u][j];
            acc = fmaf(df, df, acc);
          }
          d2[r][u] = acc;
          any |= acc < thr[r];
        }
      }
      if (any) {  // rare once the lists have settled
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int c = c0 + ci + u;
          const int cb = tb[ci + u];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            // in index order: u before u + 1, each against the k-th its predecessor left
            if (d2[r][u] < thr[r] && cb == qb[r] && c != qs[r]) {
              insert<K>(d[r], ix[r], d2[r][u], c);
              thr[r] = fminf(thr[r], d[r][K - 1]);
            }
          }
        }
      }
    }
    // the splits of a query share their k-th distances (d2 >= +0: the bits order like the
    // floats): a candidate above any split's k-th is in none of the query's k nearest
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const unsigned mine = __float_as_uint(d[r][K - 1]);
      const unsigned b = min(atomicMin(bound + q0 + r * THREADS + t, mine), mine);
      thr[r] = fminf(d[r][K - 1], b < 0x7f800000u ? __uint_as_float(b + 1) : INFINITY);  // d2 <= b
    }
    cur = nxt;
    nxt = after;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int q = q0 + r * THREADS + t;
    if (q >= n) continue;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (j < K - k) continue;  // the -inf slots
      const long off = ((long)s * k + j - (K - k)) * n + q;
      part_d[off] = d[r][j];
      part_i[off] = ix[r][j];
    }
  }
}

template <int K>
__global__ void __launch_bounds__(MB)
topk_merge_kernel(const float* __restrict__ part_d, const int* __restrict__ part_i, int n, int k,
                  int splits, float* __restrict__ out_d, int* __restrict__ out_i) {
  const int q = blockIdx.x * MB + threadIdx.x;
  if (q >= n) return;
  float d[K];
  int ix[K];
  init_list<K>(d, ix, k);
  for (int s = 0; s < splits; ++s) {
    float pd[K];
    int pi[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {  // the whole list in flight at once
      pd[j] = INFINITY;
      pi[j] = 0;
      if (j < k) {
        const long off = ((long)s * k + j) * n + q;
        pd[j] = part_d[off];
        pi[j] = part_i[off];
      }
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (!(pd[j] < d[K - 1])) break;  // the list is sorted: the rest cannot enter
      insert<K>(d, ix, pd[j], pi[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (j < K - k) continue;  // the -inf slots
    const bool filled = d[j] < INFINITY;
    const long off = (long)q * k + j - (K - k);
    out_d[off] = filled ? d[j] : INFINITY;
    out_i[off] = filled ? ix[j] : 0;
  }
}

// P for DP > 32 padded dimensions (a multiple of 4, known at run time): R = 1, the list in
// registers as above. The live tiles come through the ring in slabs of WG = 32 candidates x up to
// WDC dimensions ([candidate][dimension], read as broadcasts); a thread sums the distances of a
// group's WG candidates to its query over the group's slabs, fmaf over the dimensions ascending
// (the query's WDC coordinates of a slab from device memory), exactly as P and row #12 sum them,
// then tests and inserts them in index order. Tiles are skipped and bounds shared as in P.
constexpr int WG = 32, WDC = 32, WPC = WDC / 4;

// f(std::integral_constant<int, W>{}) for the run-time w in 1 .. N: a slab's width as a constant,
// so that its loops unroll fully
template <int N, typename F>
__device__ __forceinline__ void with_width(int w, F f) {
  if constexpr (N > 1) {
    if (w < N) return with_width<N - 1>(w, f);
  }
  f(std::integral_constant<int, N>{});
}
constexpr int WSLAB_F4 = WG * WPC + WG / 4;  // float4s of one ring buffer: points, batch ids
constexpr size_t WSMEM = (size_t)STAGES * WSLAB_F4 * sizeof(float4);

template <int K>
__global__ void __launch_bounds__(THREADS)
topk_partial_wide_kernel(const float4* __restrict__ xp, const int* __restrict__ batch,
                         const int2* __restrict__ trange, unsigned* __restrict__ bound, int n,
                         int tiles, int dp, int k, int loop, int span_tiles,
                         float* __restrict__ part_d, int* __restrict__ part_i) {
  extern __shared__ float4 smem[];
  __shared__ int qrange[2];

  const int t = threadIdx.x;
  const int q = blockIdx.x * THREADS + t;  // < rows: the query blocks fit the padding
  const int s = blockIdx.y;
  const int t_begin = s * span_tiles;
  const int t_end = min(tiles, t_begin + span_tiles);
  // slabs a tile: a group's nc slabs of at most WPC float4 columns each (fewer in the last where
  // WPC does not divide P)
  const int P = dp / 4, nc = (P + WPC - 1) / WPC, spt = TC / WG * nc;
  const float4* qrow = xp + (long)q * P;

  float d[K], thr = INFINITY;
  int ix[K];
  const int qb = batch[q];
  const int qs = loop ? -1 : q;  // the candidate a query excludes (none with `loop`)
  const bool qvalid = !isnan(qrow[0].x);
  init_list<K>(d, ix, k);
  if (t == 0) {
    qrange[0] = INT_MAX;
    qrange[1] = INT_MIN;
  }
  __syncthreads();
  const int lo = __reduce_min_sync(FULL, qvalid ? qb : INT_MAX);
  const int hi = __reduce_max_sync(FULL, qvalid ? qb : INT_MIN);
  if ((t & 31) == 0) {
    atomicMin(&qrange[0], lo);
    atomicMax(&qrange[1], hi);
  }
  __syncthreads();
  const int qlo = qrange[0], qhi = qrange[1];
  auto next_live = [&](int tt) {
    for (; tt < t_end; ++tt) {
      const int2 b = trange[tt];
      if (b.x <= qhi && b.y >= qlo) break;
    }
    return tt;
  };
  // a slab is (tile, j): group j / nc of the tile, dimensions WDC (j % nc) ..; tile t_end: none
  auto advance = [&](int2 c) {
    return c.y + 1 < spt ? make_int2(c.x, c.y + 1) : make_int2(next_live(c.x + 1), 0);
  };
  auto load_slab = [&](float4* stage, int2 c) {
    const long r0 = (long)c.x * TC + c.y / nc * WG;
    const int dim4 = c.y % nc * WPC, pc = min(WPC, P - dim4);
    for (int e = t; e < WG * pc; e += THREADS) {
      cp_async16(stage + e / pc * WPC + e % pc, xp + (r0 + e / pc) * P + dim4 + e % pc);
    }
    int* tb = reinterpret_cast<int*>(stage + WG * WPC);
    if (t < WG / 4) cp_async16(tb + 4 * t, batch + r0 + 4 * t);
  };

  int2 cur = make_int2(next_live(t_begin), 0);
  int2 nxt = cur.x < t_end ? advance(cur) : cur;
  if (cur.x < t_end) load_slab(smem, cur);
  cp_async_commit();
  if (nxt.x < t_end) load_slab(smem + WSLAB_F4, nxt);
  cp_async_commit();
  float acc[WG];
  for (int i = 0; cur.x < t_end; ++i) {
    cp_async_wait<1>();  // slab i has landed (slab i + 1 may be in flight)
    __syncthreads();     // ... for every thread's copies, and every thread is done with slab i - 1
    const int2 after = nxt.x < t_end ? advance(nxt) : nxt;
    if (after.x < t_end) load_slab(smem + ((i + 2) % STAGES) * WSLAB_F4, after);
    cp_async_commit();
    const float4* slab = smem + (i % STAGES) * WSLAB_F4;
    const int c = cur.y % nc, pc = min(WPC, P - c * WPC);
    if (c == 0) {
#pragma unroll
      for (int g = 0; g < WG; ++g) acc[g] = 0.f;
    }
    with_width<WPC>(pc, [&](auto width) {  // the slab's float4 columns, known at compile time
      constexpr int W = decltype(width)::value;
      float qv[4 * W];
#pragma unroll
      for (int p = 0; p < W; ++p) {
        const float4 v = __ldg(qrow + c * WPC + p);
        qv[4 * p] = v.x;
        qv[4 * p + 1] = v.y;
        qv[4 * p + 2] = v.z;
        qv[4 * p + 3] = v.w;
      }
#pragma unroll
      for (int g = 0; g < WG; ++g) {
#pragma unroll
        for (int p = 0; p < W; ++p) {
          const float4 v = slab[g * WPC + p];  // the same address in every lane: a broadcast
          const float cv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float df = qv[4 * p + j] - cv[j];
            acc[g] = fmaf(df, df, acc[g]);
          }
        }
      }
    });
    if (c == nc - 1) {
      const int* tb = reinterpret_cast<const int*>(slab + WG * WPC);
      const int c0 = cur.x * TC + cur.y / nc * WG;
#pragma unroll
      for (int g = 0; g < WG; ++g) {  // in index order
        if (acc[g] < thr && tb[g] == qb && c0 + g != qs) {
          insert<K>(d, ix, acc[g], c0 + g);
          thr = fminf(thr, d[K - 1]);
        }
      }
      if (cur.y == spt - 1) {  // the tile's last slab: share the k-th distance, as P does
        const unsigned mine = __float_as_uint(d[K - 1]);
        const unsigned b = min(atomicMin(bound + q, mine), mine);
        thr = fminf(d[K - 1], b < 0x7f800000u ? __uint_as_float(b + 1) : INFINITY);
      }
    }
    cur = nxt;
    nxt = after;
  }
  if (q >= n) return;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (j < K - k) continue;  // the -inf slots
    const long off = ((long)s * k + j - (K - k)) * n + q;
    part_d[off] = d[j];
    part_i[off] = ix[j];
  }
}

// Call f(std::integral_constant<int, K>{}) for the list length K (a power of two, 1 .. KS).
template <typename F>
cudaError_t with_list(int kk, F&& f) {
  switch (kk) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    default: return cudaErrorInvalidValue;
  }
}

inline int list_len(int k) {
  int kk = 1;
  while (kk < k) kk *= 2;
  return kk;
}

template <int K>
cudaError_t set_wide_smem() {
  return cudaFuncSetAttribute(topk_partial_wide_kernel<K>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)WSMEM);
}

// Call f(Cfg<DP, K, R>{}) for the run-time (dp, K, r); cudaErrorInvalidValue where not built.
template <int DP, int K, typename F>
cudaError_t with_r(int r, F& f) {
  if (r == 1) return f(Cfg<DP, K, 1>{});
  if constexpr (Cfg<DP, K, 2>::OK) {
    if (r == 2) return f(Cfg<DP, K, 2>{});
  }
  return cudaErrorInvalidValue;
}

template <int DP, typename F>
cudaError_t with_k(int kk, int r, F& f) {
  switch (kk) {
    case 1: return with_r<DP, 1>(r, f);
    case 2: return with_r<DP, 2>(r, f);
    case 4: return with_r<DP, 4>(r, f);
    case 8: return with_r<DP, 8>(r, f);
    case 16: return with_r<DP, 16>(r, f);
    case 32: return with_r<DP, 32>(r, f);
    default: return cudaErrorInvalidValue;
  }
}

template <typename F>
cudaError_t with_cfg(int dp, int k, int r, F&& f) {
  int kk = 1;
  while (kk < k) kk *= 2;
  switch (dp) {
    case 4: return with_k<4>(kk, r, f);
    case 8: return with_k<8>(kk, r, f);
    case 16: return with_k<16>(kk, r, f);
    case 32: return with_k<32>(kk, r, f);
    default: return cudaErrorInvalidValue;
  }
}

template <typename C>
cudaError_t set_smem() {
  return cudaFuncSetAttribute(topk_partial_kernel<C::DP, C::K, C::R>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// The launch plan for (n, dp, k): out[0] = R (queries a thread), out[1] = S (candidate splits),
// out[2] = tiles a split. The wrapper allocates the [S, k, n] partials from it.
int pairwise_topk_split_plan(int n, int dp, int k, void* out) {
  int* plan = static_cast<int*>(out);
  if (n <= 0 || k <= 0 || k > KS) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long tiles = ((long)n + CAND_ALIGN - 1) / CAND_ALIGN * (CAND_ALIGN / TC);
  long qblocks = 0, slots = 0;
  int r = 0;
  if (dp > 32) {  // the run-time-d P: R = 1
    int per_sm = 0;
    err = with_list(list_len(k), [&](auto kc) {
      constexpr int K = decltype(kc)::value;
      cudaError_t e = set_wide_smem<K>();
      if (e != cudaSuccess) return e;
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, topk_partial_wide_kernel<K>, THREADS, WSMEM);
    });
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    r = 1;
    qblocks = ((long)n + THREADS - 1) / THREADS;
    slots = (long)sms * per_sm;
  } else {
    for (int want : {2, 1}) {
      int per_sm = 0;
      err = with_cfg(dp, k, want, [&](auto c) {
        using C = decltype(c);
        cudaError_t e = set_smem<C>();
        if (e != cudaSuccess) return e;
        return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, topk_partial_kernel<C::DP, C::K, C::R>, THREADS, C::SMEM);
      });
      if (err == cudaErrorInvalidValue && want > 1) continue;  // not built for this (dp, k)
      if (err != cudaSuccess) return err;
      if (per_sm < 1) return cudaErrorInvalidConfiguration;
      r = want;
      qblocks = ((long)n + THREADS * r - 1) / (THREADS * r);
      slots = (long)sms * per_sm;
      if (qblocks >= slots) break;  // one full wave of resident blocks without splitting
    }
  }
  long s = (2 * slots + qblocks - 1) / qblocks;  // about two waves
  if (s > tiles) s = tiles;
  if (s > MAX_S) s = MAX_S;
  if (s < 1) s = 1;
  const long span = (tiles + s - 1) / s;
  plan[0] = r;
  plan[1] = (int)((tiles + span - 1) / span);
  plan[2] = (int)span;
  return cudaSuccess;
}

// x [n, d] f32; mask [n] u8 or null (all valid); batch [n] i32 or null (all 0). Scratch: xp
// [rows, dp] f32, bp [rows] i32 (rows: n rounded up to CAND_ALIGN; dp: d rounded up to 4, 8, 16
// or 32, or above 32 to a multiple of 4: the run-time-d P, R = 1), `scratch` rows / TC int2
// then rows u32, partials [splits, k, n] (f32, i32). Outputs [n, k]. r, splits and span_tiles as
// pairwise_topk_split_plan gives them (or another R built for this k and dp). The layout pass, P
// and M on `stream`.
int pairwise_topk_split(const float* x, const uint8_t* mask, const int* batch, float* xp, int* bp,
                        void* scratch, float* part_d, int* part_i, float* out_d, int* out_i,
                        int n, int d, int rows, int dp, int k, int loop, int r, int splits,
                        int span_tiles, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n == 0 || k == 0) return cudaSuccess;
  if (n < 0 || k < 0 || k > KS || rows < n || rows % CAND_ALIGN != 0 || d < 1 || d > dp) {
    return cudaErrorInvalidValue;
  }
  const int tiles = rows / TC;
  if (splits < 1 || splits > MAX_S || span_tiles < 1 || (long)splits * span_tiles < tiles ||
      (long)(splits - 1) * span_tiles >= tiles) {
    return cudaErrorInvalidValue;
  }
  int2* tr = static_cast<int2*>(scratch);
  unsigned* bound = reinterpret_cast<unsigned*>(tr + tiles);
  layout_kernel<<<(tiles + 3) / 4, 128, 0, stream>>>(x, mask, batch, n, d, dp, tiles, xp, bp, tr,
                                                      bound);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (dp > 32) {
    if (dp % 4 != 0 || r != 1) return cudaErrorInvalidValue;
    return with_list(list_len(k), [&](auto kc) {
      constexpr int K = decltype(kc)::value;
      cudaError_t e = set_wide_smem<K>();
      if (e != cudaSuccess) return e;
      const dim3 grid((n + THREADS - 1) / THREADS, splits);
      topk_partial_wide_kernel<K><<<grid, THREADS, WSMEM, stream>>>(
          reinterpret_cast<const float4*>(xp), bp, tr, bound, n, tiles, dp, k, loop, span_tiles,
          part_d, part_i);
      e = cudaGetLastError();
      if (e != cudaSuccess) return e;
      topk_merge_kernel<K><<<(n + MB - 1) / MB, MB, 0, stream>>>(part_d, part_i, n, k, splits,
                                                                 out_d, out_i);
      return cudaGetLastError();
    });
  }
  return with_cfg(dp, k, r, [&](auto c) {
    using C = decltype(c);
    cudaError_t e = set_smem<C>();
    if (e != cudaSuccess) return e;
    const dim3 grid((n + THREADS * C::R - 1) / (THREADS * C::R), splits);
    topk_partial_kernel<C::DP, C::K, C::R><<<grid, THREADS, C::SMEM, stream>>>(
        reinterpret_cast<const float4*>(xp), bp, tr, bound, n, tiles, k, loop, span_tiles,
        part_d, part_i);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    topk_merge_kernel<C::K><<<(n + MB - 1) / MB, MB, 0, stream>>>(part_d, part_i, n, k, splits,
                                                                   out_d, out_i);
    return cudaGetLastError();
  });
}

}  // extern "C"
