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
// ascending; ties go to the lower index. Distances are direct, sum_d (q - c)^2 with fmaf in
// dimension order (the TPU kernel used the norm expansion at HIGHEST precision), so every path
// below gives the same bits.
//
// What bounds it on this card: arithmetic. At 262,144 points with radius 4, block_q 256 and
// block_c 1024, a query meets 9 blocks of 1024 candidates: 2.4e9 pairs. At 3 flops per dimension
// that is 0.32 ms (d = 3) and 0.86 ms (d = 8) at 67 TFLOP/s f32, against 3-8 MB of points and
// 17 MB of outputs. The direct difference issues 2 d + 1 FP32 instructions a pair (d
// subtractions, d FMAs, one compare): 0.50 ms at d = 3 and 1.22 ms at d = 8 on 132 SMs x 128
// lanes at 1,980 MHz. chip_smoke.py computes both from the band of each input.
//
// Design, two paths (banded_topk_plan picks one):
//  * k <= 32 at d = 3 and d = 8, the spatial and latent builds' (band_reg_kernel<D, K>, the
//    resident design of rows #13 / #11 in csrc/pairwise_topk_split.cu): 128 threads a block, one query each, with its D
//    coordinates in registers (two queries a thread, R = 2 there, ran no faster here:
//    PERF.md); the block's band union streams through a cp.async ring of three 256-candidate
//    tiles (one __syncthreads a tile, two tiles in flight), and every thread reads the same
//    candidate, a broadcast from shared memory, U at a step (U x D floats as float4s), so U
//    distance chains are independent. Each query keeps its top-k in registers: K (a power of
//    two >= k) slots, ascending, the first K - k at -inf, so the k-th distance (+inf while
//    unfilled) is always the last slot and no slot is chosen at run time. A pair costs its
//    distance and one compare against the k-th distance; a candidate at or below it (and not
//    the query itself) is pushed to the query's pending list in shared memory (PB slots), and
//    when a lane's pending list is nearly full the warp (by a vote, so that its lanes insert
//    together) inserts every pending candidate that still belongs in the list with the
//    unrolled insertion. With ~9,000 candidates a query, a lane admits ~0.7 % of them, so a
//    warp of 32 lanes would enter an insertion on most steps; the pending lists keep that work
//    to each lane's own admissions.
//    The scan order: the points are sorted along the key, so a band scanned in index order
//    meets the first half of its candidates at falling distances, and nearly every one of them
//    would insert. Tiles are scanned from the block's own tile outwards (own, +1, -1, +2,
//    ...): the lists fill with near candidates first and later tiles rarely insert. Ties go to
//    the lower index all the same: the lists order (distance, index) pairs, a candidate equal
//    in distance to the k-th enters if its index is lower, and the insertion places it by
//    index among equal distances, so the result is the scan in index order's, bit for bit. The
//    band bounds are tested once a tile: a tile inside the query's band takes the unmasked
//    loop, a band edge the masked one (one candidate at a time). No padding beyond d. An
//    invalid query gets -inf as its bound, so it inserts nothing.
//  * every other (d, k) (band_list_kernel<DP, LIST_SMEM>): one thread a query, QB = 128, 64
//    or 32 queries a block, whichever keeps the most queries resident an SM beside their lists; the query
//    zero-padded to DP = 4, 8, 16 or 32 in registers (DP = 0: d at run time, the query in shared
//    or device memory); tiles of 256 candidates staged synchronously, in the same outward order;
//    the running top-k sorted by (distance, index) in shared memory, laid out [slot][thread].
//    Candidates at or below the k-th go to a pending list, and the warp's lanes merge theirs
//    together (sorted, then merged from the list's tail). Where even 32 lists do not fit, each
//    query's list lives in its output row in device memory, so every k runs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int THREADS = 128;  // threads a block of the register path
constexpr int TC = 256;       // candidates a tile
constexpr int STAGES = 3;     // cp.async ring of the register path
constexpr int KS = 32;        // largest k of the register path
constexpr int PB = 16;        // pending candidates a query (band_reg_kernel, band_list_kernel)

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy the rows [tile * rows, tile * rows + rows) of x [n, d] (cut at n) into `stage`, as they
// lie in memory: 16-byte copies (rows is a multiple of 4, so a tile starts on 16 bytes), the
// tail of the last tile in 4-byte ones. Rows past n are left as they were.
__device__ __forceinline__ void load_rows(float* stage, const float* __restrict__ x, int tile,
                                          int rows, int n, int d) {
  const long f0 = (long)tile * rows * d;
  const int nrows = min(rows, n - tile * rows);
  const int nf = nrows * d;
  const int n4 = nf >> 2;
  const float4* src = reinterpret_cast<const float4*>(x + f0);
  float4* dst = reinterpret_cast<float4*>(stage);
  for (int e = threadIdx.x; e < n4; e += blockDim.x) cp_async16(dst + e, src + e);
  for (int e = 4 * n4 + threadIdx.x; e < nf; e += blockDim.x) cp_async4(stage + e, x + f0 + e);
}

// A query's list: K slots, ascending. The first K - k hold -inf (never moved: every candidate is
// above them), the last k the running top-k (+inf while unfilled).
template <int K>
__device__ __forceinline__ void init_list(float (&d)[K], int (&ix)[K], int k) {
#pragma unroll
  for (int r = 0; r < K; ++r) {
    d[r] = r < K - k ? -INFINITY : INFINITY;
    ix[r] = 0;
  }
}

// (a, i) after (x, c) in the lists' order: by distance, then by index.
__device__ __forceinline__ bool after(float a, int i, float x, int c) {
  return a > x || (a == x && i > c);
}

// (x, c) enters the list: before its last entry, the k-th (a +inf slot never admits).
template <int K>
__device__ __forceinline__ bool admits(const float (&d)[K], const int (&ix)[K], float x, int c) {
  return x < d[K - 1] || (x == d[K - 1] && x < INFINITY && c < ix[K - 1]);
}

// Insert (x, c), which admits() holds: entries before it keep their place, the rest move up one
// and the last drops out.
template <int K>
__device__ __forceinline__ void insert(float (&d)[K], int (&ix)[K], float x, int c) {
#pragma unroll
  for (int r = K - 1; r > 0; --r) {
    const bool up = after(d[r - 1], ix[r - 1], x, c);
    const bool here = !up && after(d[r], ix[r], x, c);
    d[r] = up ? d[r - 1] : (here ? x : d[r]);
    ix[r] = up ? ix[r - 1] : (here ? c : ix[r]);
  }
  if (after(d[0], ix[0], x, c)) {
    d[0] = x;
    ix[0] = c;
  }
}

// The i-th of the tiles [first, end) in the scan order: `own` first, then outwards, alternating
// right and left while both sides last.
__device__ __forceinline__ int scan_tile(int i, int own, int first, int end) {
  const int left = own - first, right = end - 1 - own, m = min(left, right);
  if (i <= 2 * m) return (i & 1) ? own + (i + 1) / 2 : own - i / 2;
  return right > left ? own + (i - m) : own - (i - m);
}

// The tile holding the middle one of the block's queries [q0, q0 + nq), within [first, end).
__device__ __forceinline__ int own_tile(int q0, int nq, int n, int rows, int first, int end) {
  return max(first, min(end - 1, min(q0 + nq / 2, n - 1) / rows));
}

template <int K>
__device__ __forceinline__ void write_list(const float (&d)[K], const int (&ix)[K], int k, long q,
                                           float* __restrict__ out_d, int* __restrict__ out_i) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (j < K - k) continue;  // the -inf slots
    const bool filled = d[j] < INFINITY;
    out_d[q * k + j - (K - k)] = filled ? d[j] : INFINITY;
    out_i[q * k + j - (K - k)] = filled ? ix[j] : 0;
  }
}

// D coordinates, K slots, U candidates a step (U x D floats are whole float4s).
template <int D_, int K_>
struct Reg {
  static constexpr int D = D_, K = K_;
  static constexpr int U0 = D_ <= 8 ? 4 : 32 / D_;
  static constexpr int U = (U0 * D_) % 4 == 0 ? U0 : 4;
};

// Insert a thread's pending candidates ([PB][THREADS] in shared memory, np of them) that still
// belong in its list, and refresh the bound.
template <int K>
__device__ __forceinline__ void flush(float (&d)[K], int (&ix)[K], float& thr, int& np,
                                      const float* pend_d, const int* pend_c, int t) {
  for (int b = 0; b < np; ++b) {
    const float x = pend_d[b * THREADS + t];
    const int c = pend_c[b * THREADS + t];
    if (admits<K>(d, ix, x, c)) insert<K>(d, ix, x, c);
  }
  if (thr > -INFINITY) thr = d[K - 1];  // an invalid query keeps -inf
  np = 0;
}

template <int D, int K>
__global__ void __launch_bounds__(THREADS)
band_reg_kernel(const float* __restrict__ x, const uint8_t* __restrict__ valid, int n, int k,
                int radius, int block_q, int block_c, int n_cblocks, int loop,
                float* __restrict__ out_d, int* __restrict__ out_i) {
  constexpr int U = Reg<D, K>::U;
  constexpr int STAGE = TC * D;  // floats of one ring buffer
  extern __shared__ float4 smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float* pend_d = ring + STAGES * STAGE;  // [PB][THREADS]
  int* pend_c = reinterpret_cast<int*>(pend_d + PB * THREADS);

  const int t = threadIdx.x;
  const int q0 = blockIdx.x * THREADS;
  const int q = q0 + t;
  const bool in = q < n;
  float qv[D], d[K];
  int ix[K];
#pragma unroll
  for (int j = 0; j < D; ++j) qv[j] = in ? x[(long)q * D + j] : 0.f;
  init_list<K>(d, ix, k);
  float thr = in && valid[q] ? INFINITY : -INFINITY;  // an invalid query inserts nothing
  const int qs = loop ? -1 : q;  // the candidate the query excludes (none with `loop`)
  int np = 0;                    // its pending candidates
  int lo = 0, hi = 0, u_lo = 0, u_hi = 0, tmp = 0;
  band_of(in ? q : n - 1, n_cblocks, block_q, block_c, radius, n, &lo, &hi);
  // the union of the block's bands (bands are monotone in q)
  band_of(q0, n_cblocks, block_q, block_c, radius, n, &u_lo, &tmp);
  band_of(min(q0 + THREADS - 1, n - 1), n_cblocks, block_q, block_c, radius, n, &tmp, &u_hi);
  const int t_first = u_lo / TC, t_end = (u_hi + TC - 1) / TC, tiles = t_end - t_first;
  const int own = own_tile(q0, THREADS, n, TC, t_first, t_end);

  if (tiles > 0) load_rows(ring, x, scan_tile(0, own, t_first, t_end), TC, n, D);
  cp_async_commit();
  if (tiles > 1) load_rows(ring + STAGE, x, scan_tile(1, own, t_first, t_end), TC, n, D);
  cp_async_commit();
  for (int i = 0; i < tiles; ++i) {
    cp_async_wait<1>();  // tile i has landed (i + 1 may be in flight)
    __syncthreads();     // ... for every thread's copies, and every thread is done with i - 1
    if (i + 2 < tiles) {
      load_rows(ring + ((i + 2) % STAGES) * STAGE, x, scan_tile(i + 2, own, t_first, t_end), TC, n, D);
    }
    cp_async_commit();
    const float* tile = ring + (i % STAGES) * STAGE;
    const int c0 = scan_tile(i, own, t_first, t_end) * TC;
    if (lo <= c0 && hi >= c0 + TC) {  // the tile lies in the band
      for (int c2 = 0; c2 < TC; c2 += 2 * U) {
#pragma unroll
        for (int ci = c2; ci < c2 + 2 * U; ci += U) {
          float cv[U][D];
          const float4* src = reinterpret_cast<const float4*>(tile + ci * D);
#pragma unroll
          for (int e = 0; e < U * D / 4; ++e) {  // the same address in every lane: a broadcast
            const float4 v = src[e];
            cv[(4 * e) / D][(4 * e) % D] = v.x;
            cv[(4 * e + 1) / D][(4 * e + 1) % D] = v.y;
            cv[(4 * e + 2) / D][(4 * e + 2) % D] = v.z;
            cv[(4 * e + 3) / D][(4 * e + 3) % D] = v.w;
          }
          float d2[U];
          bool any = false;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            float acc = 0.f;
#pragma unroll
            for (int j = 0; j < D; ++j) {
              const float df = qv[j] - cv[u][j];
              acc = fmaf(df, df, acc);
            }
            d2[u] = acc;
            any |= acc <= thr;
          }
          if (any) {
#pragma unroll
            for (int u = 0; u < U; ++u) {
              if (d2[u] <= thr && c0 + ci + u != qs) {
                pend_d[np * THREADS + t] = d2[u];
                pend_c[np * THREADS + t] = c0 + ci + u;
                ++np;
              }
            }
          }
        }
        // room for two more steps in the pending list, or the warp's lanes insert together
        if (__any_sync(__activemask(), np > PB - 2 * U)) flush<K>(d, ix, thr, np, pend_d, pend_c, t);
      }
    } else {  // a band edge: one candidate at a time, inserted at once
      const int from = max(lo, c0) - c0, to = min(hi, c0 + TC) - c0;
      for (int ci = from; ci < to; ++ci) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < D; ++j) {
          const float df = qv[j] - tile[ci * D + j];
          acc = fmaf(df, df, acc);
        }
        const int c = c0 + ci;
        if (acc <= thr && c != qs && admits<K>(d, ix, acc, c)) {
          insert<K>(d, ix, acc, c);
          thr = d[K - 1];
        }
      }
    }
  }
  flush<K>(d, ix, thr, np, pend_d, pend_c, t);
  if (in) write_list<K>(d, ix, k, q, out_d, out_i);
}

// Where the query's coordinates are read from: shared memory [d][nq] (`qsm`), or its row of x.
struct QueryRows {
  const float* p;
  int stride;
};
__device__ __forceinline__ QueryRows query_rows(float* qsm, const float* __restrict__ x, int q,
                                                int n, int d, int t, int nq) {
  if (qsm == nullptr) return {x + (long)min(q, n - 1) * d, 1};
  for (int j = 0; j < d; ++j) qsm[j * nq + t] = q < n ? x[(long)q * d + j] : 0.f;
  return {qsm + t, nq};
}

// Merge a thread's np pending candidates (stride ps) into its sorted list of cnt entries (stride
// ls), keeping the first k in (distance, index) order: the pending ones sorted by insertion, then
// merged from the tail, which moves only the list entries above the smallest pending one.
// Returns the list's new count.
__device__ __forceinline__ int merge_pending(float* bd, int* bi, int ls, int cnt, int k, float* pd,
                                             int* pi, int ps, int np) {
  for (int a = 1; a < np; ++a) {
    const float x = pd[a * ps];
    const int c = pi[a * ps];
    int b = a;
    for (; b > 0 && after(pd[(b - 1) * ps], pi[(b - 1) * ps], x, c); --b) {
      pd[b * ps] = pd[(b - 1) * ps];
      pi[b * ps] = pi[(b - 1) * ps];
    }
    pd[b * ps] = x;
    pi[b * ps] = c;
  }
  const int total = min(k, cnt + np);
  int drop = cnt + np - total;  // the largest ones, met first from the tail
  int a = cnt - 1, b = np - 1, p = total - 1;
  while (b >= 0) {  // p > a while a pending one is left: no unread list entry is overwritten
    float v;
    int vi;
    if (a >= 0 && after(bd[a * ls], bi[a * ls], pd[b * ps], pi[b * ps])) {
      v = bd[a * ls], vi = bi[a * ls], --a;
    } else {
      v = pd[b * ps], vi = pi[b * ps], --b;
    }
    if (drop > 0) {
      --drop;
      continue;
    }
    bd[p * ls] = v, bi[p * ls] = vi, --p;
  }
  return total;
}

// Every (d, k) but band_reg_kernel's: one thread a query, QB = blockDim.x queries a block; the query zero-padded to DP
// columns in registers (DP = 0: d at run time, the query in shared memory with q_smem, else read
// from x); tiles of `rows` candidates ([rows][DP or d]); the lists in shared memory ([k][QB],
// LIST_SMEM) or in the output rows (the pointers' space is known at compile time, so their
// loads stay shared-memory loads). A candidate at or below the k-th distance goes to the
// query's pending list ([PB][QB] in shared memory); when a lane's is nearly full the warp's
// lanes merge theirs into their lists together (merge_pending).
template <int DP, bool LIST_SMEM>
__global__ void __launch_bounds__(THREADS)
band_list_kernel(const float* __restrict__ x, const uint8_t* __restrict__ valid, int n, int d,
                 int k, int radius, int block_q, int block_c, int n_cblocks, int loop, int rows_,
                 int q_smem, float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ float4 smem4[];
  const int qb = blockDim.x;
  const int rows = DP > 0 ? TC : rows_;  // a compile-time tile where d is padded
  const int dp = DP > 0 ? DP : d;
  float* tile = reinterpret_cast<float*>(smem4);  // [rows][dp]
  float* qsm = tile + rows * dp;                   // DP = 0 with q_smem: [d][qb]
  float* lsm = qsm + (DP == 0 && q_smem ? d * qb : 0);
  float* pd = lsm + (LIST_SMEM ? 2 * k * qb : 0) + threadIdx.x;  // pending: [PB][qb] twice
  int* pi = reinterpret_cast<int*>(pd + PB * qb);

  const int t = threadIdx.x;
  const int q0 = blockIdx.x * qb;
  const int q = q0 + t;
  const bool active = q < n;
  const bool qvalid = active && valid[q] != 0;
  float qv[DP > 0 ? DP : 1];
  QueryRows qr = {nullptr, 0};
  if constexpr (DP > 0) {
#pragma unroll
    for (int j = 0; j < DP; ++j) qv[j] = (active && j < d) ? x[(long)q * d + j] : 0.f;
  } else {
    qr = query_rows(q_smem ? qsm : nullptr, x, q, n, d, t, qb);
  }
  // the list: [slot][thread] in shared memory, or the query's output row
  float* bd;
  int* bi;
  if constexpr (LIST_SMEM) {
    bd = lsm + t;
    bi = reinterpret_cast<int*>(lsm + k * qb) + t;
  } else {
    bd = out_d + (long)min(q, n - 1) * k;
    bi = out_i + (long)min(q, n - 1) * k;
  }
  const int ls = LIST_SMEM ? qb : 1;

  int lo = 0, hi = 0, u_lo = 0, u_hi = 0, tmp = 0;
  band_of(active ? q : q0, n_cblocks, block_q, block_c, radius, n, &lo, &hi);
  band_of(q0, n_cblocks, block_q, block_c, radius, n, &u_lo, &tmp);
  band_of(min(q0 + qb - 1, n - 1), n_cblocks, block_q, block_c, radius, n, &tmp, &u_hi);

  const int t_first = u_lo / rows, t_end = (u_hi + rows - 1) / rows;
  const int own = own_tile(q0, qb, n, rows, t_first, t_end);
  int cnt = 0, np = 0;
  float tau = 3.402823466e38f;  // the k-th distance once the list is full (no +inf enters)
  for (int i = 0; i < t_end - t_first; ++i) {
    const int c0 = scan_tile(i, own, t_first, t_end) * rows;
    const int tc = min(n - c0, rows);
    __syncthreads();
    for (int e = t; e < rows * dp; e += qb) {
      const int r = e / dp;
      const int j = e % dp;
      tile[e] = (r < tc && j < d) ? x[(long)(c0 + r) * d + j] : 0.f;
    }
    __syncthreads();
    if (!qvalid) continue;
    const int from = max(lo, c0) - c0;
    const int to = min(hi, c0 + tc) - c0;
    for (int ci = from; ci < to; ++ci) {
      const float* cp = tile + ci * dp;
      float acc = 0.f;
      if constexpr (DP > 0) {
#pragma unroll
        for (int j = 0; j < DP; ++j) {
          const float df = qv[j] - cp[j];
          acc = fmaf(df, df, acc);
        }
      } else {
        for (int j = 0; j < d; ++j) {
          const float df = qr.p[j * qr.stride] - cp[j];
          acc = fmaf(df, df, acc);
        }
      }
      const int c = c0 + ci;
      if (acc <= tau && (loop || c != q)) {
        pd[np * qb] = acc, pi[np * qb] = c, ++np;
      }
      // every fourth candidate and after a tile: room for four more in every pending list, or
      // the lanes merge together
      if (((ci - from) & 3) == 3 || ci == to - 1) {
        if (__any_sync(__activemask(), np > PB - 4)) {
          cnt = merge_pending(bd, bi, ls, cnt, k, pd, pi, qb, np);
          np = 0;
          if (cnt == k) tau = bd[(k - 1) * ls];
        }
      }
    }
  }
  if (np > 0) cnt = merge_pending(bd, bi, ls, cnt, k, pd, pi, qb, np);
  if (!active) return;
  for (int j = 0; j < k; ++j) {
    const bool filled = j < cnt;
    const float dv = filled ? bd[j * ls] : INFINITY;
    const int iv = filled ? bi[j * ls] : 0;
    out_d[(long)q * k + j] = dv;
    out_i[(long)q * k + j] = iv;
  }
}

int smem_optin() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) {
    return 0;
  }
  return optin;
}

// Call f(Reg<D, K>{}) for the run-time (d, K); cudaErrorInvalidValue at a d not specialised.
template <int D, typename F>
cudaError_t with_k(int kk, F& f) {
  switch (kk) {
    case 1: return f(Reg<D, 1>{});
    case 2: return f(Reg<D, 2>{});
    case 4: return f(Reg<D, 4>{});
    case 8: return f(Reg<D, 8>{});
    case 16: return f(Reg<D, 16>{});
    case 32: return f(Reg<D, 32>{});
    default: return cudaErrorInvalidValue;
  }
}

int pow2_at_least(int k) {
  int kk = 1;
  while (kk < k) kk *= 2;
  return kk;
}

// The dimensions band_reg_kernel is built for: the spatial (3) and latent (8) builds'.
bool specialised(int d) { return d == 3 || d == 8; }

template <typename F>
cudaError_t with_reg(int d, int k, F&& f) {
  const int kk = pow2_at_least(k);
  switch (d) {
    case 3: return with_k<3>(kk, f);
    case 8: return with_k<8>(kk, f);
    default: return cudaErrorInvalidValue;
  }
}

int list_dp(int d) { return d <= 4 ? 4 : d <= 8 ? 8 : d <= 16 ? 16 : d <= 32 ? 32 : 0; }

template <bool LIST_SMEM, typename F>
cudaError_t with_list_dp(int d, F& f) {
  switch (list_dp(d)) {
    case 4: return f(band_list_kernel<4, LIST_SMEM>);
    case 8: return f(band_list_kernel<8, LIST_SMEM>);
    case 16: return f(band_list_kernel<16, LIST_SMEM>);
    case 32: return f(band_list_kernel<32, LIST_SMEM>);
    default: return f(band_list_kernel<0, LIST_SMEM>);
  }
}

template <typename F>
cudaError_t with_list(int d, bool list_smem, F&& f) {
  return list_smem ? with_list_dp<true>(d, f) : with_list_dp<false>(d, f);
}

// The shared memory of a launch of `path` with qb queries a block (see banded_topk_plan).
size_t plan_smem(int path, int d, int k, int qb, int rows, int flags) {
  const size_t f = sizeof(float);
  if (path == 0) {
    return (size_t)STAGES * rows * d * f + (size_t)PB * THREADS * (f + sizeof(int));
  }
  const int dp = list_dp(d) > 0 ? list_dp(d) : d;
  return (size_t)rows * dp * f + (list_dp(d) == 0 && (flags & 2) ? (size_t)qb * d * f : 0) +
         (flags & 1 ? (size_t)k * qb * (f + sizeof(int)) : 0) + (size_t)PB * qb * (f + sizeof(int));
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// The launch plan for (d, k): out[0] the path (0: band_reg_kernel, k <= 32 at a specialised d;
// 1: band_list_kernel, every other (d, k)), out[1] the queries a block, out[2] the tile's rows,
// out[3] flags (path 1; 1: lists in shared memory, 2: the query in shared memory at a run-time
// d), out[4] the shared memory of a block. cudaErrorInvalidValue where even a tile of 4 rows
// exceeds a block's shared memory.
int banded_topk_plan(int d, int k, void* out) {
  int* plan = static_cast<int*>(out);
  if (d <= 0 || k <= 0) return cudaErrorInvalidValue;
  const int optin = smem_optin();
  if (optin <= 0) return cudaErrorInvalidDevice;
  if (k <= KS && specialised(d)) {
    plan[0] = 0, plan[1] = THREADS, plan[2] = TC, plan[3] = 0;
    plan[4] = (int)plan_smem(0, d, k, THREADS, TC, 0);
    return cudaSuccess;
  }
  // the lists in shared memory, with the queries a block that keep the most queries resident an
  // SM, at the largest tile that fits
  const bool padded = list_dp(d) > 0;
  long best = 0;
  for (int flags_q : {2, 0}) {
    if (padded && flags_q) continue;
    for (int rows = TC; rows >= 4 && best == 0; rows /= 2) {
      if (padded && rows != TC) break;
      for (int qb : {128, 64, 32}) {
        const size_t need = plan_smem(1, d, k, qb, rows, 1 | flags_q);
        if (need > (size_t)optin) continue;
        int per_sm = 0;
        const cudaError_t err = with_list(d, true, [&](auto kern) {
          cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)need);
          if (e != cudaSuccess) return e;
          return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, qb, need);
        });
        if (err != cudaSuccess) return err;
        if ((long)qb * per_sm > best) {
          best = (long)qb * per_sm;
          plan[0] = 1, plan[1] = qb, plan[2] = rows, plan[3] = 1 | flags_q, plan[4] = (int)need;
        }
      }
    }
    if (best > 0) return cudaSuccess;
  }
  // the lists in the output rows
  for (int flags_q : {2, 0}) {
    if (padded && flags_q) continue;
    for (int rows = TC; rows >= 4; rows /= 2) {
      const size_t need = plan_smem(1, d, k, THREADS, rows, flags_q);
      if (need > (size_t)optin) continue;
      plan[0] = 1, plan[1] = THREADS, plan[2] = rows, plan[3] = flags_q, plan[4] = (int)need;
      return cudaSuccess;
    }
  }
  return cudaErrorInvalidValue;
}

// x [n, d] f32 key-sorted points (invalid rows already 1e30), starting on 16 bytes; valid [n] u8;
// outputs [n, k] (f32 squared distances ascending, i32 indices in sorted order). n_cblocks is the
// number of candidate blocks after padding n to block_q and then to block_c. path, qb (queries a
// block), rows and flags as banded_topk_plan gives them.
int banded_topk_sorted(const float* x, const uint8_t* valid, float* out_d, int* out_i, int n,
                       int d, int k, int radius, int block_q, int block_c, int n_cblocks,
                       int loop, int path, int qb, int rows, int flags, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n == 0 || k == 0) return cudaSuccess;
  if (n < 0 || d < 1 || k < 0 || rows < 4 || rows > TC || rows % 4 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = plan_smem(path, d, k, qb, rows, flags);
  if (path == 0) {
    if (rows != TC || qb != THREADS) return cudaErrorInvalidValue;
    return with_reg(d, k, [&](auto c) {
      using C = decltype(c);
      auto kern = band_reg_kernel<C::D, C::K>;
      cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
      if (e != cudaSuccess) return e;
      kern<<<(n + THREADS - 1) / THREADS, THREADS, smem, stream>>>(
          x, valid, n, k, radius, block_q, block_c, n_cblocks, loop, out_d, out_i);
      return cudaGetLastError();
    });
  }
  if (path == 1) {
    if (qb != 32 && qb != 64 && qb != 128) return cudaErrorInvalidValue;
    if (list_dp(d) > 0 && rows != TC) return cudaErrorInvalidValue;
    return with_list(d, (flags & 1) != 0, [&](auto kern) {
      cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
      if (e != cudaSuccess) return e;
      kern<<<(n + qb - 1) / qb, qb, smem, stream>>>(x, valid, n, d, k, radius, block_q, block_c,
                                                    n_cblocks, loop, rows, (flags & 2) != 0,
                                                    out_d, out_i);
      return cudaGetLastError();
    });
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
