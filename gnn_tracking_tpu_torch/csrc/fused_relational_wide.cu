// Fused interaction-network edge pipeline at any width, forward and backward, f32 and bf16, for
// Hopper (sm_90a): the layout the wrappers take where the resident kernels' weights and tiles do
// not fit one block's shared memory (csrc/fused_relational.cu: rows #1 / #2, C32 / D32;
// csrc/fused_relational_bf16.cu: A-D).
//
// Replaces the TPU kernels gnn_tracking_tpu/ops/pallas/fused_relational.py::fused_relational
// (_fwd_kernel, _bwd_kernel) and ::fused_relational_flat, and fused_relational_t.py's
// fused_relational_flat_t and fused_relational_layer_tt (the save flag), at the widths that the
// resident kernels cannot hold: for every edge (src -> dst)
//     e' = mask * ( relu( relu([x_dst, x_src, ea] W1 + b1) W2 + b2 ) W3 + b3 )
// and its backward, with the same contracts as those two files (masked edges come out as exact
// zeros; the per-node sums are csr_segment.cu's, launched by the wrapper).
//
// What bounds it on this card: arithmetic, 2 (K H + H H + H Fo) flops an unmasked edge forward
// and 2 (3 K H + 3 H H + 2 H Fo) backward (K = 2 Fx + Fe): on the CUDA cores in f32 (67 TFLOP/s;
// the f32 bits are the resident kernels', so no TF32), on the tensor cores in bf16; the backward
// also moves its weight-gradient factors through device memory once each way. Design:
//  * persistent blocks of 256 threads take tiles of unmasked edges (the wrappers' stable
//    partition, unmasked first); the plan (fused_relational_wide_plan.cuh, which the wrappers
//    read through fused_relational_wide_plan) picks the route and the tile;
//  * f32 (and bf16 where its tensor-core tiles do not fit): the activations of a tile live k-major
//    ([width][TE + 4] f32) in shared memory, TE = 64 or 32 as the widths allow, and where not even
//    TE = 32 fits, in a slice of device memory a block (the same code reads them through generic
//    pointers): no width is refused. Every product streams its weight through a cp.async ring in
//    shared memory (KC rows of W^T x 256 or 64 columns a stage) that all 8 warps share; a thread
//    holds a register tile of RE edges x 8 outputs (8 x 8 at TE = 64 and 256 columns), its edges
//    and columns two 16-byte runs apart, so a warp's shared-memory reads are broadcasts of 4 and 8
//    consecutive 16-byte words. Each output is a chain of fmaf over the contraction ascending from
//    0.f, then + b (then ReLU in the hidden layers): in f32 exactly the resident kernels'
//    arithmetic, so the outputs and the input gradients keep their bits, and the forward and the
//    backward's recompute agree bit for bit. bf16 there: values held in f32 (exact), weights f32;
//  * bf16 on the tensor cores (every width a multiple of 32, tiles in shared memory): tiles of 64
//    edges, edge-major bf16 ([64][width + 8]: the 8 rows of an ldmatrix in 8 bank groups); each
//    weight streams as bf16 through a 3-stage ring, n-major ([256][TC_KT + 8]: the mma's B
//    fragments without a transpose), issued two chunks ahead across products and tiles;
//    mma.sync.m16n8k16 with f32 accumulation, 8 warps as 2 x 4 over edges x columns. The
//    activations are rounded to bf16 where A-D round them: h1, h2, the masked e', g_e' =
//    bf16(mask (g_e'_out + g_agg[dst])), g_h2, g_h1 and the per-edge input gradients;
//  * the ReLU masks of h1 and h2 are kept as bits by the thread that owns the entry in the
//    recompute and in the gradient product (the same register tile or fragment);
//  * weight gradients: the backward's edge pass writes each tile's factors (m, h1, h2, g_h2,
//    g_h1, g_e' as the working type, edge-major) to a scratch that holds a chunk of tiles (the
//    plan caps it near 256 MB); after each chunk wgrad_kernel (f32 FMA; wgrad_tc_kernel on the
//    tensor cores in bf16) computes dW = sum_e g^T a and db = sum_e g over the chunk's edges, a
//    block a 128 x 128 tile of dW and a slice of whole tiles of edges, each entry's sum over the
//    slice in a fixed order; fixed_order_sum.cuh then sums the slices in order. Every sum's order
//    is fixed by the plan, so a second launch gives the same bits; the weight gradients' bits are
//    not the resident kernels';
//  * the masked edges' rows (zeros, and with the save flag the endpoint rows) are written a
//    warp a row with 16-byte stores where the row allows them (masked_rows_kernel).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "fixed_order_sum.cuh"
#include "fused_relational_wide_plan.cuh"

namespace {

// A build with -DWIDE_PHASES (chip_smoke.py's wide_phases) counts each phase's cycles between the
// block's barriers (thread 0 of every block, summed): the gather and each product of a tile.
#ifdef WIDE_PHASES
__device__ unsigned long long wide_phase_cycles[24];
#define PHASE_START long long phase_mark = clock64()
#define PHASE(i)                                                                            \
  do {                                                                                      \
    if (threadIdx.x == 0) {                                                                 \
      const long long now = clock64();                                                      \
      atomicAdd(&wide_phase_cycles[i], (unsigned long long)(now - phase_mark));             \
      phase_mark = now;                                                                     \
    }                                                                                       \
  } while (0)
#else
#define PHASE_START
#define PHASE(i)
#endif

using namespace wide_plan;

constexpr int WARPS = THREADS / 32;
// steps of a full chunk unrolled in the forward's and the backward's products (the backward runs
// five products in one kernel: shorter loops keep its code in the instruction cache)
constexpr int FWD_UNROLL = 8;
constexpr int BWD_UNROLL = 2;
constexpr int WG_STAGES = 3;  // wgrad: ring stages

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) { return __float2bfloat16(v); }
// v as the activation it becomes: rounded to bf16 where the inputs are bf16
template <typename T>
__device__ __forceinline__ float act(float v) { return to_f(from_f<T>(v)); }

// four consecutive values, 16-byte (f32) or 8-byte (bf16) aligned
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  uint2 u;
  *reinterpret_cast<__nv_bfloat162*>(&u.x) = __floats2bfloat162_rn(a, b);
  *reinterpret_cast<__nv_bfloat162*>(&u.y) = __floats2bfloat162_rn(c, d);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// cp.async of 16 bytes, global -> shared, through L2 only; src_bytes = 0 fills the 16 bytes with
// zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------------- the products of a tile
// Thread roles of a product whose register tile is RE edges x 8 outputs: NB = 8 N_OG columns a
// ring stage. Lanes 8 apart share their edges, lanes of a group of 8 their columns; a thread's
// edges are RE consecutive ones (RE = 8: two runs of 4, TE / 2 apart), its columns two runs of 4,
// NB / 2 apart.
template <int TE, int RE>
struct Lanes {
  static constexpr int N_EG = TE / RE;
  static constexpr int N_OG = THREADS / N_EG;
  static constexpr int NB = 8 * N_OG;
  static constexpr int N_WO = N_OG / 8;  // warps along the columns
  static_assert(TE % RE == 0 && (N_EG == 8 || N_EG == 32), "8 x RE or 32 x RE edges");
  int eg, og;
  __device__ __forceinline__ Lanes() {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    og = (lane & 7) + 8 * (warp % N_WO);
    eg = (lane >> 3) + 4 * (warp / N_WO);
  }
  __device__ __forceinline__ int edge(int r) const {
    if constexpr (RE == 8) return r < 4 ? 4 * eg + r : TE / 2 + 4 * eg + r - 4;
    return RE * eg + r;
  }
  __device__ __forceinline__ int col(int q) const {
    return q < 4 ? 4 * og + q : NB / 2 + 4 * og + q - 4;
  }
};

// a thread's RE values of one row of a k-major tile
template <int TE, int RE>
__device__ __forceinline__ void load_a(const float* row, int eg, float (&a)[RE]) {
  if constexpr (RE == 8) {
    const float4 u = *reinterpret_cast<const float4*>(row + 4 * eg);
    const float4 v = *reinterpret_cast<const float4*>(row + TE / 2 + 4 * eg);
    a[0] = u.x, a[1] = u.y, a[2] = u.z, a[3] = u.w, a[4] = v.x, a[5] = v.y, a[6] = v.z, a[7] = v.w;
  } else if constexpr (RE == 4) {
    const float4 u = *reinterpret_cast<const float4*>(row + 4 * eg);
    a[0] = u.x, a[1] = u.y, a[2] = u.z, a[3] = u.w;
  } else if constexpr (RE == 2) {
    const float2 u = *reinterpret_cast<const float2*>(row + 2 * eg);
    a[0] = u.x, a[1] = u.y;
  } else {
    a[0] = row[eg];
  }
}
template <int TE, int RE>
__device__ __forceinline__ void store_a(float* row, int eg, const float (&a)[RE]) {
  if constexpr (RE == 8) {
    *reinterpret_cast<float4*>(row + 4 * eg) = make_float4(a[0], a[1], a[2], a[3]);
    *reinterpret_cast<float4*>(row + TE / 2 + 4 * eg) = make_float4(a[4], a[5], a[6], a[7]);
  } else if constexpr (RE == 4) {
    *reinterpret_cast<float4*>(row + 4 * eg) = make_float4(a[0], a[1], a[2], a[3]);
  } else if constexpr (RE == 2) {
    *reinterpret_cast<float2*>(row + 2 * eg) = make_float2(a[0], a[1]);
  } else {
    row[eg] = a[0];
  }
}

// y[e][j] = sum_{c < kin} in[c][e] wt[c][j] for the tile's TE edges and j < m, each a chain of
// fmaf over c ascending from 0.f; in: a k-major tile [kin][ld]; wt: [kin][m] f32 in device
// memory (m % 4 == 0), streamed through the ring in chunks of KC rows x NB columns (zeros past
// the edges of wt). epi(col0, lanes, acc) takes each column block's register tiles. The caller
// separates products with a barrier.
template <int TE, int RE, int UNROLL, typename Epi>
__device__ __forceinline__ void product(const float* in, int kin, int ld,
                                        const float* __restrict__ wt, int m, float* ring,
                                        const Epi& epi) {
  using L = Lanes<TE, RE>;
  constexpr int NB = L::NB, VPR = NB / 4;
  const L l;
  const int n_cb = (m + NB - 1) / NB, n_ch = (kin + KC - 1) / KC, total = n_cb * n_ch;
  auto load = [&](int i) {
    const int cb = i / n_ch, ch = i - cb * n_ch;
    float* stage = ring + (i % STAGES) * STAGE_FLOATS;
#pragma unroll
    for (int u = 0; u < KC * VPR / THREADS; ++u) {
      const int v = threadIdx.x + u * THREADS, r = v / VPR, c = ch * KC + r;
      const int col = cb * NB + 4 * (v % VPR);
      const bool ok = c < kin && col < m;
      cp_async16(stage + r * NB + 4 * (v % VPR), ok ? wt + (long)c * m + col : wt, ok ? 16 : 0);
    }
  };
  auto step = [&](const float* arow, const float* brow, float (&acc)[RE][8]) {
    float a[RE];
    load_a<TE, RE>(arow, l.eg, a);
    const float4 b0 = *reinterpret_cast<const float4*>(brow + 4 * l.og);
    const float4 b1 = *reinterpret_cast<const float4*>(brow + NB / 2 + 4 * l.og);
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int r = 0; r < RE; ++r) {
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(a[r], b[q], acc[r][q]);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) load(s);
    cp_async_commit();
  }
  int i = 0;
  for (int cb = 0; cb < n_cb; ++cb) {
    float acc[RE][8];
#pragma unroll
    for (int r = 0; r < RE; ++r) {
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
    }
    for (int ch = 0; ch < n_ch; ++ch, ++i) {
      cp_async_wait<STAGES - 2>();  // chunk i has landed
      __syncthreads();              // ... for every thread, and chunk i - 1's stage is free
      if (i + STAGES - 1 < total) load(i + STAGES - 1);
      cp_async_commit();
      const float* stage = ring + (i % STAGES) * STAGE_FLOATS;
      const float* arows = in + (long)ch * KC * ld;
      if ((ch + 1) * KC <= kin) {
#pragma unroll UNROLL
        for (int c = 0; c < KC; ++c) step(arows + c * ld, stage + c * NB, acc);
      } else {
        for (int c = 0; c < kin - ch * KC; ++c) step(arows + c * ld, stage + c * NB, acc);
      }
    }
    epi(cb * NB, l, acc);
  }
}

// product with the ring's column count for m (pick_nb)
template <int TE, int UNROLL, typename Epi>
__device__ __forceinline__ void run(const float* in, int kin, int ld, const float* __restrict__ wt,
                                    int m, float* ring, const Epi& epi) {
  if (pick_nb(m) == 256) {
    product<TE, TE / 8, UNROLL>(in, kin, ld, wt, m, ring, epi);
  } else {
    product<TE, TE / 32, UNROLL>(in, kin, ld, wt, m, ring, epi);
  }
}

// ------------------------------------------------------------------- the epilogues
// out[j][e] = act(relu(y + b[j])) into a k-major tile: the forward's hidden layers
template <typename T>
struct ToTile {
  const float* b;
  float* out;
  int ld, m;
  template <int TE, int RE>
  __device__ __forceinline__ void operator()(int col0, const Lanes<TE, RE>& l,
                                             const float (&acc)[RE][8]) const {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int j = col0 + l.col(q);
      if (j >= m) continue;
      const float bj = __ldg(b + j);
      float v[RE];
#pragma unroll
      for (int r = 0; r < RE; ++r) v[r] = act<T>(fmaxf(acc[r][q] + bj, 0.f));
      store_a<TE, RE>(out + (long)j * ld, l.eg, v);
    }
  }
};

// the v[r][q] of a register tile as factor rows fac[e][j] (edge-major, pitch m) and, with out, into
// a k-major tile
template <typename T, int TE, int RE>
__device__ __forceinline__ void keep(const Lanes<TE, RE>& l, int col0, int m, const float (&v)[RE][8],
                                     T* fac, float* out, int ld) {
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int j = col0 + l.col(4 * g);
    if (j >= m) continue;
#pragma unroll
    for (int r = 0; r < RE; ++r) {
      store4(fac + (long)l.edge(r) * m + j, v[r][4 * g], v[r][4 * g + 1], v[r][4 * g + 2],
             v[r][4 * g + 3]);
    }
    if (out == nullptr) continue;
#pragma unroll
    for (int q = 4 * g; q < 4 * g + 4; ++q) {
      float a[RE];
#pragma unroll
      for (int r = 0; r < RE; ++r) a[r] = v[r][q];
      store_a<TE, RE>(out + (long)(col0 + l.col(q)) * ld, l.eg, a);
    }
  }
}

// The backward's recompute: h = act(relu(y + b)) as factor rows, into the k-major tile `out`
// (h1; h2 has no reader in the tile), and its ReLU mask as the thread's bits (bit 8 r + q) for
// the gradient product that the same thread computes at the same entries
template <typename T>
struct Recompute {
  const float* b;
  float* out;
  int ld, m;
  T* fac;
  uint64_t* bits;
  template <int TE, int RE>
  __device__ __forceinline__ void operator()(int col0, const Lanes<TE, RE>& l,
                                             const float (&acc)[RE][8]) const {
    float v[RE][8];
    uint64_t word = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int j = col0 + l.col(q);
      const float bj = j < m ? __ldg(b + j) : 0.f;
#pragma unroll
      for (int r = 0; r < RE; ++r) {
        v[r][q] = act<T>(fmaxf(acc[r][q] + bj, 0.f));
        if (v[r][q] > 0.f) word |= 1ull << (8 * r + q);
      }
    }
    keep<T>(l, col0, m, v, fac, out, ld);
    bits[(col0 / Lanes<TE, RE>::NB) * THREADS + threadIdx.x] = word;
  }
};

// g = act(y) where the layer's ReLU mask (the recompute's bits) is set, else 0: a ReLU's
// derivative (0 at 0), as factor rows and into the k-major tile `out`
template <typename T>
struct Masked {
  const uint64_t* bits;
  float* out;
  int ld, m;
  T* fac;
  template <int TE, int RE>
  __device__ __forceinline__ void operator()(int col0, const Lanes<TE, RE>& l,
                                             const float (&acc)[RE][8]) const {
    const uint64_t word = bits[(col0 / Lanes<TE, RE>::NB) * THREADS + threadIdx.x];
    float v[RE][8];
#pragma unroll
    for (int r = 0; r < RE; ++r) {
#pragma unroll
      for (int q = 0; q < 8; ++q) v[r][q] = (word >> (8 * r + q)) & 1 ? act<T>(acc[r][q]) : 0.f;
    }
    keep<T>(l, col0, m, v, fac, out, ld);
  }
};

// e_out[edge] = y + b3 for the tile's `valid` edges
template <typename T>
struct OutRows {
  const float* b;
  T* e_out;
  const int* tid;
  int m, valid;
  template <int TE, int RE>
  __device__ __forceinline__ void operator()(int col0, const Lanes<TE, RE>& l,
                                             const float (&acc)[RE][8]) const {
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int j = col0 + l.col(4 * g);
      if (j >= m) continue;
      const float b0 = __ldg(b + j), b1 = __ldg(b + j + 1), b2 = __ldg(b + j + 2),
                  b3 = __ldg(b + j + 3);
#pragma unroll
      for (int r = 0; r < RE; ++r) {
        const int e = l.edge(r);
        if (e >= valid) continue;
        store4(e_out + (long)tid[e] * m + j, acc[r][4 * g] + b0, acc[r][4 * g + 1] + b1,
               acc[r][4 * g + 2] + b2, acc[r][4 * g + 3] + b3);
      }
    }
  }
};

// g_m = g_h1 W1 of the tile's `valid` edges split into g_xd, g_xs, g_ea (zero where relu_edge
// cut the edge feature: ea <= 0)
template <typename T>
struct InputGrads {
  T* g_xd;
  T* g_xs;
  T* g_ea;
  const T* ea;
  const int* tid;
  int fx, fe, k, relu_edge, valid;
  template <int TE, int RE>
  __device__ __forceinline__ void operator()(int col0, const Lanes<TE, RE>& l,
                                             const float (&acc)[RE][8]) const {
#pragma unroll
    for (int r = 0; r < RE; ++r) {
      const int e = l.edge(r);
      if (e >= valid) continue;
      const long id = tid[e];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int i = col0 + l.col(q);
        float v = acc[r][q];
        if (i < fx) {
          g_xd[id * fx + i] = from_f<T>(v);
        } else if (i < 2 * fx) {
          g_xs[id * fx + i - fx] = from_f<T>(v);
        } else if (i < k) {
          if (relu_edge && !(to_f(ea[id * fe + i - 2 * fx]) > 0.f)) v = 0.f;
          g_ea[id * fe + i - 2 * fx] = from_f<T>(v);
        }
      }
    }
  }
};

// g_e' = act(g_eout + g_agg[dst]) of a warp's EPW edges (zeros where not live) into get [fo][ld]
// (k-major, from column e0) and fac_g [EPW][fo]
template <int EPW, typename T>
__device__ __forceinline__ void gather_get(const T* __restrict__ g_eout, const T* __restrict__ g_agg,
                                           const long (&edge)[EPW], const long (&d)[EPW],
                                           const bool (&live)[EPW], int fo, int ld, int e0,
                                           float* get, T* fac_g) {
  const int lane = threadIdx.x & 31;
  for (int c0 = 0; c0 < fo; c0 += 32) {
    const int c = c0 + lane;
    float v[EPW];
#pragma unroll
    for (int j = 0; j < EPW; ++j) {
      v[j] = live[j] && c < fo ? act<T>(to_f(g_eout[edge[j] * fo + c]) + to_f(g_agg[d[j] * fo + c]))
                               : 0.f;
    }
    if (c >= fo) continue;
#pragma unroll
    for (int j = 0; j < EPW; ++j) {
      get[(long)c * ld + e0 + j] = v[j];
      fac_g[(long)(e0 + j) * fo + c] = from_f<T>(v[j]);
    }
  }
}

// Tile t's inputs [x[dst], x[src], ea] (relu(ea) with relu_edge) into m, k-major [k][ld], zeros
// past the `count` unmasked edges, and the edge ids into tid: a warp takes TE / 8 edges, its lanes
// a row's columns, the warp's loads of a column step all in flight together. With gd_in the
// endpoint rows are the saved x[dst], x[src] (x null); with gd_out they are also saved there (the
// forward's save flag). BWD also writes the rows as factors (fac_m [TE][kp], zero-padded) and
// g_e' = act(g_eout + g_agg[dst]) into get [fo][ld] and fac_g [TE][fo].
template <typename T, int TE, bool BWD>
__device__ __forceinline__ void gather(const T* __restrict__ x, const T* __restrict__ gd_in,
                                       const T* __restrict__ gs_in, T* gd_out, T* gs_out,
                                       const T* __restrict__ ea, const int* __restrict__ src,
                                       const int* __restrict__ dst, const int* __restrict__ ids,
                                       const T* __restrict__ g_eout, const T* __restrict__ g_agg,
                                       int count, int t, int fx, int fe, int fo, int relu_edge,
                                       int ld, float* m, float* get, int* tid, T* fac_m,
                                       T* fac_g) {
  constexpr int EPW = TE / WARPS;
  const int lane = threadIdx.x & 31, e0 = (threadIdx.x >> 5) * EPW;
  const int k = 2 * fx + fe, kp = padded_k(k);
  const bool saved = x == nullptr;
  long edge[EPW], d[EPW], rd[EPW], rs[EPW];
  bool live[EPW];
#pragma unroll
  for (int j = 0; j < EPW; ++j) {
    const int slot = t * TE + e0 + j;
    live[j] = slot < count;
    edge[j] = live[j] ? __ldg(ids + slot) : 0;
  }
#pragma unroll
  for (int j = 0; j < EPW; ++j) {
    d[j] = live[j] ? __ldg(dst + edge[j]) : 0;
    rd[j] = (saved ? edge[j] : d[j]) * fx;
    rs[j] = (saved ? edge[j] : (live[j] ? __ldg(src + edge[j]) : 0)) * fx;
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < EPW; ++j) tid[e0 + j] = (int)edge[j];
  }
  const T* xd = saved ? gd_in : x;
  const T* xs = saved ? gs_in : x;
  if constexpr (std::is_same<T, float>::value) {
    // f32 rows of whole 16-byte words: a lane a word, the loads of a warp's edges in flight
    const int fx4 = fx / 4, k4 = k / 4, kp4 = kp / 4;
    if (fx % 4 == 0 && fe % 4 == 0 &&
        (reinterpret_cast<uintptr_t>(xd) | reinterpret_cast<uintptr_t>(xs) |
         reinterpret_cast<uintptr_t>(ea)) % 16 == 0) {
      for (int v0 = 0; v0 < (BWD ? kp4 : k4); v0 += 32) {
        const int v = v0 + lane;
        float4 u[EPW];
#pragma unroll
        for (int j = 0; j < EPW; ++j) {
          u[j] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (live[j] && v < k4) {
            u[j] = v < fx4 ? reinterpret_cast<const float4*>(xd + rd[j])[v]
                           : (v < 2 * fx4 ? reinterpret_cast<const float4*>(xs + rs[j])[v - fx4]
                                          : reinterpret_cast<const float4*>(ea + edge[j] * fe)[v - 2 * fx4]);
          }
        }
#pragma unroll
        for (int j = 0; j < EPW; ++j) {
          float4 f = u[j];
          if (relu_edge && v >= 2 * fx4) {
            f = make_float4(fmaxf(f.x, 0.f), fmaxf(f.y, 0.f), fmaxf(f.z, 0.f), fmaxf(f.w, 0.f));
          }
          if (v < k4) {
            float* col = m + (long)(4 * v) * ld + e0 + j;
            col[0] = f.x, col[ld] = f.y, col[2 * ld] = f.z, col[3 * ld] = f.w;
          }
          if (BWD && v < kp4) reinterpret_cast<float4*>(fac_m + (long)(e0 + j) * kp)[v] = f;
          if (!BWD && gd_out != nullptr && live[j]) {
            if (v < fx4) {
              reinterpret_cast<float4*>(gd_out + edge[j] * fx)[v] = u[j];
            } else if (v < 2 * fx4) {
              reinterpret_cast<float4*>(gs_out + edge[j] * fx)[v - fx4] = u[j];
            }
          }
        }
      }
      if (BWD) gather_get<EPW>(g_eout, g_agg, edge, d, live, fo, ld, e0, get, fac_g);
      return;
    }
  }
  for (int c0 = 0; c0 < (BWD ? kp : k); c0 += 32) {
    const int c = c0 + lane;
    T raw[EPW];
#pragma unroll
    for (int j = 0; j < EPW; ++j) {
      T v = from_f<T>(0.f);
      if (live[j] && c < k) {
        if (c < fx) {
          v = xd[rd[j] + c];
        } else if (c < 2 * fx) {
          v = xs[rs[j] + c - fx];
        } else {
          v = ea[edge[j] * fe + c - 2 * fx];
        }
      }
      raw[j] = v;
    }
#pragma unroll
    for (int j = 0; j < EPW; ++j) {
      float v = to_f(raw[j]);
      if (relu_edge && c >= 2 * fx) v = fmaxf(v, 0.f);
      if (c < k) m[(long)c * ld + e0 + j] = v;
      if (BWD && c < kp) fac_m[(long)(e0 + j) * kp + c] = from_f<T>(v);
      if (!BWD && gd_out != nullptr && live[j]) {
        if (c < fx) {
          gd_out[edge[j] * fx + c] = raw[j];
        } else if (c < 2 * fx) {
          gs_out[edge[j] * fx + c - fx] = raw[j];
        }
      }
    }
  }
  if (BWD) gather_get<EPW>(g_eout, g_agg, edge, d, live, fo, ld, e0, get, fac_g);
}

// ------------------------------------------------------------------- the kernels
template <typename T>
struct FwdArgs {
  const T* x;
  const T* ea;
  const int* src;
  const int* dst;
  const int* ids;
  const int* count;
  const float *w1t, *b1, *w2t, *b2, *w3t, *b3;
  T* e_out;
  T* gd;
  T* gs;
  float* tiles;
  int fx, fe, h, fo, relu_edge;
};

// The forward, persistent: blocks take tiles of TE unmasked edges in turn (ids[:count]);
// DEVICE_TILES: the tiles in a slice of `tiles` a block
template <typename T, int TE, bool DEVICE_TILES>
__global__ void __launch_bounds__(THREADS, 1) wide_fwd_kernel(const FwdArgs<T> a) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  const int k = 2 * a.fx + a.fe, ld = TE + 4;
  float* A = DEVICE_TILES ? a.tiles + blockIdx.x * tile_floats(k, a.h, a.fo, false, TE)
                          : ring + RING_FLOATS;
  float* B = A + (long)max(k, a.h) * ld;
  int* tid = reinterpret_cast<int*>(B + (long)a.h * ld);
  const int count = *a.count, n_tiles = (count + TE - 1) / TE;
  PHASE_START;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    gather<T, TE, false>(a.x, nullptr, nullptr, a.gd, a.gs, a.ea, a.src, a.dst, a.ids, nullptr,
                         nullptr, count, t, a.fx, a.fe, a.fo, a.relu_edge, ld, A, nullptr, tid,
                         nullptr, nullptr);
    __syncthreads();
    PHASE(0);
    run<TE, FWD_UNROLL>(A, k, ld, a.w1t, a.h, ring, ToTile<T>{a.b1, B, ld, a.h});
    __syncthreads();
    PHASE(1);
    run<TE, FWD_UNROLL>(B, a.h, ld, a.w2t, a.h, ring, ToTile<T>{a.b2, A, ld, a.h});
    __syncthreads();
    PHASE(2);
    run<TE, FWD_UNROLL>(A, a.h, ld, a.w3t, a.fo, ring,
            OutRows<T>{a.b3, a.e_out, tid, a.fo, min(TE, count - t * TE)});
    __syncthreads();  // the tiles are free for the next tile's gather
    PHASE(3);
  }
}

template <typename T>
struct BwdArgs {
  const T* x;
  const T* gd;
  const T* gs;
  const T* ea;
  const int* src;
  const int* dst;
  const int* ids;
  const int* count;
  const float *w1t, *b1, *w2t, *b2, *w1p, *w2, *w3;
  const T* g_eout;
  const T* g_agg;
  T* g_xd;
  T* g_xs;
  T* g_ea;
  T* fac;
  float* tiles;
  int fx, fe, h, fo, relu_edge, chunk_tiles;
};

// The factor rows of a chunk of `slots` edge slots: m [kp], h1, h2, g_h2, g_h1 [h], g_e' [fo]
template <typename T>
struct Factors {
  T *m, *h1, *h2, *gh2, *gh1, *get;
  __host__ __device__ Factors(T* base, long slots, int kp, int h) {
    m = base;
    h1 = m + slots * kp;
    h2 = h1 + slots * h;
    gh2 = h2 + slots * h;
    gh1 = gh2 + slots * h;
    get = gh1 + slots * h;
  }
};

// The backward's edge pass over chunk `chunk`'s tiles, persistent: the recompute of h1 and h2 (the
// forward's products), g_e' = g_eout + g_agg[dst], then
//   g_h2 = (g_e' W3) * [h2 > 0];  g_h1 = (g_h2 W2) * [h1 > 0];  g_m = g_h1 W1 -> g_xd, g_xs, g_ea
// with every factor of the weight gradients written to the chunk's rows (wgrad_kernel's input).
// x null: the endpoint rows are the saved gd, gs.
template <typename T, int TE, bool DEVICE_TILES>
__global__ void __launch_bounds__(THREADS, 1) wide_bwd_kernel(const BwdArgs<T> a, int chunk) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  const int k = 2 * a.fx + a.fe, k4 = (k + 3) & ~3, kp = padded_k(k), ld = TE + 4, h = a.h;
  const int n_cb = (h + pick_nb(h) - 1) / pick_nb(h);
  float* A = DEVICE_TILES ? a.tiles + blockIdx.x * tile_floats(k, h, a.fo, true, TE)
                          : ring + RING_FLOATS;
  float* B = A + (long)max(k, h) * ld;
  float* G = B + (long)h * ld;
  uint64_t* bits1 = reinterpret_cast<uint64_t*>(G + (long)a.fo * ld);
  uint64_t* bits2 = bits1 + n_cb * THREADS;
  int* tid = reinterpret_cast<int*>(bits2 + n_cb * THREADS);
  const Factors<T> f(a.fac, (long)a.chunk_tiles * TE, kp, h);
  const int count = *a.count, n_tiles = (count + TE - 1) / TE;
  const int t0 = chunk * a.chunk_tiles, t1 = min(t0 + a.chunk_tiles, n_tiles);
  PHASE_START;
  for (int t = t0 + blockIdx.x; t < t1; t += gridDim.x) {
    const long s = (long)(t - t0) * TE;  // the tile's first factor row
    const int valid = min(TE, count - t * TE);
    gather<T, TE, true>(a.x, a.gd, a.gs, nullptr, nullptr, a.ea, a.src, a.dst, a.ids, a.g_eout,
                        a.g_agg, count, t, a.fx, a.fe, a.fo, a.relu_edge, ld, A, G, tid,
                        f.m + s * kp, f.get + s * a.fo);
    __syncthreads();
    PHASE(4);
    run<TE, BWD_UNROLL>(A, k, ld, a.w1t, h, ring, Recompute<T>{a.b1, B, ld, h, f.h1 + s * h, bits1});
    __syncthreads();
    PHASE(5);
    run<TE, BWD_UNROLL>(B, h, ld, a.w2t, h, ring, Recompute<T>{a.b2, nullptr, ld, h, f.h2 + s * h, bits2});
    __syncthreads();
    PHASE(6);
    run<TE, BWD_UNROLL>(G, a.fo, ld, a.w3, h, ring, Masked<T>{bits2, B, ld, h, f.gh2 + s * h});  // g_h2 over h1
    __syncthreads();
    PHASE(7);
    run<TE, BWD_UNROLL>(B, h, ld, a.w2, h, ring, Masked<T>{bits1, A, ld, h, f.gh1 + s * h});  // g_h1 over m
    __syncthreads();
    PHASE(8);
    run<TE, BWD_UNROLL>(A, h, ld, a.w1p, k4, ring,
            InputGrads<T>{a.g_xd, a.g_xs, a.g_ea, a.ea, tid, a.fx, a.fe, k, a.relu_edge, valid});
    __syncthreads();  // the tiles are free for the next tile's gather
    PHASE(9);
  }
}

// The three weight-gradient products of a chunk: dW[i][j] = sum_e g[e][i] a[e][j] and db[i] =
// sum_e g[e][i] over (g, a) = (g_h1, m), (g_h2, h1), (g_e', h2)
template <typename T>
struct WgradArgs {
  const T* g[3];
  const T* a[3];
  int pitch_g[3], pitch_a[3], rows[3], cols[3], tiles_n[3], first[3];
  long woff[3], boff[3];
  float* partial;
  long p;
  const int* count;
  int te, chunk_tile0, slice_tiles, slice0;
};

// A thread's RM x RN entries of a block's BT x BT tile of dW over n_k ring stages of BK edges (rows
// and columns two runs of 4, BT / 2 apart; RM = 4 or RN = 4: only the first run, where the tile's
// rows or columns past BT / 2 lie beyond the weight), each a chain of fmaf over the edges ascending
// from 0.f; with bias the sums of the rows (a thread of the first column group each).
template <typename T, int RM, int RN>
__device__ __forceinline__ void wgrad_tile(T* sg, T* sa, const T* g, const T* a, int pg, int pa,
                                           int gcols, int acols, int n_k, bool bias, int row0,
                                           int rows, int col0, int cols, float* w_out, float* b_out) {
  constexpr int VEC = 16 / sizeof(T), VPR = BT / VEC;
  auto load = [&](int i) {
    T* dg = sg + (i % WG_STAGES) * BK * BT;
    T* da = sa + (i % WG_STAGES) * BK * BT;
#pragma unroll
    for (int u = 0; u < BK * VPR / THREADS; ++u) {
      const int v = threadIdx.x + u * THREADS, r = v / VPR, c = (v % VPR) * VEC;
      const long e = (long)i * BK + r;
      cp_async16(dg + r * BT + c, c < gcols ? g + e * pg + c : g, c < gcols ? 16 : 0);
      cp_async16(da + r * BT + c, c < acols ? a + e * pa + c : a, c < acols ? 16 : 0);
    }
  };
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ng = (lane & 7) + 8 * (warp & 1), mg = (lane >> 3) + 4 * (warp >> 1);
  float acc[RM][RN], bsum[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    bsum[r] = 0.f;
#pragma unroll
    for (int q = 0; q < RN; ++q) acc[r][q] = 0.f;
  }
#pragma unroll
  for (int s = 0; s < WG_STAGES - 1; ++s) {
    if (s < n_k) load(s);
    cp_async_commit();
  }
  for (int i = 0; i < n_k; ++i) {
    cp_async_wait<WG_STAGES - 2>();
    __syncthreads();
    if (i + WG_STAGES - 1 < n_k) load(i + WG_STAGES - 1);
    cp_async_commit();
    const T* dg = sg + (i % WG_STAGES) * BK * BT;
    const T* da = sa + (i % WG_STAGES) * BK * BT;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float gv[8], av[8];
      load4(dg + kk * BT + 4 * mg, *reinterpret_cast<float(*)[4]>(gv));
      if (RM == 8) load4(dg + kk * BT + BT / 2 + 4 * mg, *reinterpret_cast<float(*)[4]>(gv + 4));
      load4(da + kk * BT + 4 * ng, *reinterpret_cast<float(*)[4]>(av));
      if (RN == 8) load4(da + kk * BT + BT / 2 + 4 * ng, *reinterpret_cast<float(*)[4]>(av + 4));
#pragma unroll
      for (int r = 0; r < RM; ++r) {
#pragma unroll
        for (int q = 0; q < RN; ++q) acc[r][q] = fmaf(gv[r], av[q], acc[r][q]);
        if (bias) bsum[r] += gv[r];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int i = row0 + (r < 4 ? 4 * mg + r : BT / 2 + 4 * mg + r - 4);
    if (i >= rows) continue;
#pragma unroll
    for (int q = 0; q < RN; ++q) {
      const int j = col0 + (q < 4 ? 4 * ng + q : BT / 2 + 4 * ng + q - 4);
      if (j < cols) w_out[(long)i * cols + j] = acc[r][q];
    }
    if (bias && ng == 0) b_out[i] = bsum[r];
  }
}

// Block (x, y): one BT x BT tile of one product (x) over slice y of the chunk (slice_tiles tiles of
// te edges; slice0 + y is its partial), the slice's edges streamed through a 3-stage cp.async
// ring of BK edges (wgrad_tile; a thread 8 x 8 entries, 4 rows or columns where the tile has no
// more than BT / 2 in the weight); in the blocks of the first column tile also the bias sums of its
// rows. A slice past the unmasked edges is skipped; the fixed-order sum reads only the slices before
// it.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2) wgrad_kernel(const WgradArgs<T> w) {
  extern __shared__ float4 smem4[];
  T* sg = reinterpret_cast<T*>(smem4);  // [WG_STAGES][BK][BT]
  T* sa = sg + WG_STAGES * BK * BT;     // [WG_STAGES][BK][BT]
  const int count = *w.count, n_tiles = (count + w.te - 1) / w.te;
  const int t0 = (w.slice0 + blockIdx.y) * w.slice_tiles;
  if (t0 >= n_tiles) return;
  const int n_k = (min(t0 + w.slice_tiles, n_tiles) - t0) * w.te / BK;
  const int b = blockIdx.x, p = (b >= w.first[1]) + (b >= w.first[2]);
  const int tm = (b - w.first[p]) / w.tiles_n[p], tn = (b - w.first[p]) % w.tiles_n[p];
  const long slot0 = (long)(t0 - w.chunk_tile0) * w.te;
  const int pg = w.pitch_g[p], pa = w.pitch_a[p], rows = w.rows[p], cols = w.cols[p];
  const T* g = w.g[p] + slot0 * pg + tm * BT;
  const T* a = w.a[p] + slot0 * pa + tn * BT;
  const int gcols = pg - tm * BT, acols = pa - tn * BT;  // columns left in a row (pitches % VEC == 0)
  float* out = w.partial + (long)(w.slice0 + blockIdx.y) * w.p;
  const bool half_m = rows - tm * BT <= BT / 2, half_n = cols - tn * BT <= BT / 2;
#define WGRAD_TILE(RM, RN)                                                                     \
  wgrad_tile<T, RM, RN>(sg, sa, g, a, pg, pa, gcols, acols, n_k, tn == 0, tm * BT, rows, tn * BT, \
                        cols, out + w.woff[p], out + w.boff[p])
  if (half_m && half_n) {
    WGRAD_TILE(4, 4);
  } else if (half_m) {
    WGRAD_TILE(4, 8);
  } else if (half_n) {
    WGRAD_TILE(8, 4);
  } else {
    WGRAD_TILE(8, 8);
  }
#undef WGRAD_TILE
}

// The masked edges (ids[count:]): a warp a row, 16-byte stores where the row and the pointers
// allow them; zero rows of z0, z1, z2 (widths w0, w1, w2; null: none) and, with gd, the endpoint
// rows x[dst], x[src] into gd, gs
template <typename T>
__device__ __forceinline__ void zero_row(T* row, int w, int lane) {
  if ((w * (int)sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(row) % 16 == 0) {
    for (int v = lane; v < w * (int)sizeof(T) / 16; v += 32) {
      reinterpret_cast<uint4*>(row)[v] = make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int c = lane; c < w; c += 32) row[c] = from_f<T>(0.f);
  }
}
template <typename T>
__device__ __forceinline__ void copy_row(T* to, const T* from, int w, int lane) {
  if ((w * (int)sizeof(T)) % 16 == 0 &&
      (reinterpret_cast<uintptr_t>(to) | reinterpret_cast<uintptr_t>(from)) % 16 == 0) {
    for (int v = lane; v < w * (int)sizeof(T) / 16; v += 32) {
      reinterpret_cast<uint4*>(to)[v] = __ldg(reinterpret_cast<const uint4*>(from) + v);
    }
  } else {
    for (int c = lane; c < w; c += 32) to[c] = from[c];
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) masked_rows_kernel(
    const int* __restrict__ ids, const int* __restrict__ count_ptr, int n_edges, T* z0, int w0,
    T* z1, int w1, T* z2, int w2, const T* __restrict__ x, const int* __restrict__ src,
    const int* __restrict__ dst, T* gd, T* gs, int fx) {
  const int lane = threadIdx.x & 31, warps = gridDim.x * WARPS, count = *count_ptr;
  for (int r = blockIdx.x * WARPS + (threadIdx.x >> 5); r < n_edges - count; r += warps) {
    const long edge = __ldg(ids + count + r);
    if (z0 != nullptr) zero_row(z0 + edge * w0, w0, lane);
    if (z1 != nullptr) zero_row(z1 + edge * w1, w1, lane);
    if (z2 != nullptr) zero_row(z2 + edge * w2, w2, lane);
    if (gd != nullptr) {
      copy_row(gd + edge * fx, x + (long)__ldg(dst + edge) * fx, fx, lane);
      copy_row(gs + edge * fx, x + (long)__ldg(src + edge) * fx, fx, lane);
    }
  }
}

// ---------------------------------------------- bf16 on the tensor cores (where it fits)
// The bf16 route where its tiles fit shared memory: the same pipeline on mma.sync.m16n8k16 (bf16
// operands, f32 accumulation) with ldmatrix fragments. Tiles of TC_TE edges are bf16 and
// edge-major ([TC_TE][width + 8]: rows 16 * odd bytes apart, so the 8 rows of an ldmatrix hit 8
// bank groups); each weight streams through a 3-stage ring, n-major ([nb][TC_KT + 8]: the mma's
// B fragments without a transpose), in chunks of TC_KT rows of the contraction. 8 warps: 2 along
// the edges (32 each) x 4 along a chunk's columns. The activations are rounded where A-D round.
using bf16 = __nv_bfloat16;

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(saddr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(saddr(p))
               : "memory");
}
// c += a b for a 16 x 16 bf16 A fragment and a 16 x 8 bf16 B fragment, f32 accumulation
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// One product's weight on this route: w [m][kin] bf16 (the output's columns as rows), in chunks of
// TC_KT contraction rows x nb columns, column block by column block
struct TcStream {
  const bf16* w;
  int kin, m, nb, n_ch, total;
};
__device__ __forceinline__ TcStream make_tc_stream(const void* w, int kin, int m) {
  const int nb = pick_nb(m), n_ch = (kin + TC_KT - 1) / TC_KT;
  return {static_cast<const bf16*>(w), kin, m, nb, n_ch, (m + nb - 1) / nb * n_ch};
}

// The weight ring of this route: the products of a tile stream their weights through the same
// TC_STAGES stages in the order the kernel runs them, and every tile repeats that order, so chunk
// i of the sequence (counted on across products and tiles) lands in stage i % TC_STAGES, issued
// TC_STAGES - 1 chunks before its use: the next product's and the next tile's first chunks load
// while the current ones are consumed (the tensor cores consume a chunk in fewer cycles than the
// CUDA cores, so a ring drained at every product would wait on each refill). Zeros past the edges
// of a weight.
struct TcRing {
  bf16* buf;
  const TcStream* streams;
  int period, issued, used;
  __device__ __forceinline__ void issue() {
    int j = issued % period, p = 0;
    while (j >= streams[p].total) j -= streams[p++].total;
    const TcStream s = streams[p];
    const int cb = j / s.n_ch, ch = j - cb * s.n_ch;
    bf16* stage = buf + (issued % TC_STAGES) * TC_STAGE;
    for (int v = threadIdx.x; v < s.nb * (TC_KT / 8); v += THREADS) {
      const int n = v / (TC_KT / 8), kv = v % (TC_KT / 8), col = cb * s.nb + n;
      const bool ok = col < s.m && ch * TC_KT + 8 * kv < s.kin;
      cp_async16(stage + n * TC_SP + 8 * kv,
                 ok ? s.w + (long)col * s.kin + ch * TC_KT + 8 * kv : s.w, ok ? 16 : 0);
    }
    cp_async_commit();
    ++issued;
  }
  // the next chunk to consume, once it has landed for every thread; the stage of the chunk before
  // it is then free for the chunk TC_STAGES - 1 ahead
  __device__ __forceinline__ const bf16* next() {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();
    issue();
    return buf + (used++ % TC_STAGES) * TC_STAGE;
  }
};

// The ring of a kernel whose tiles run the products of `s` (n of them, copied to `streams` in
// shared memory) in that order, primed with its first TC_STAGES - 1 chunks
__device__ __forceinline__ TcRing start_tc_ring(bf16* buf, TcStream* streams,
                                                const TcStream (&s)[5], int n) {
  if ((int)threadIdx.x < n) streams[threadIdx.x] = s[threadIdx.x];
  __syncthreads();
  int period = 0;
  for (int p = 0; p < n; ++p) period += s[p].total;
  TcRing ring{buf, streams, period, 0, 0};
  for (int i = 0; i < TC_STAGES - 1; ++i) ring.issue();
  return ring;
}

// A warp's share of a product on this route: NT n8 tiles of its column quarter (NB / 32 of them)
// for 2 m16 tiles of its 32 edges. The entry (mt, nt, i) of a thread sits at edge
// 32 wm + 16 mt + lane / 4 + 8 (i / 2) and column col0 + wn NB / 4 + 8 nt + 2 (lane % 4) + i % 2.
struct TcLanes {
  int wm, wn, g, q;
  __device__ __forceinline__ TcLanes() {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    wm = warp >> 2, wn = warp & 3, g = lane >> 2, q = lane & 3;
  }
  __device__ __forceinline__ int edge(int mt, int i) const { return 32 * wm + 16 * mt + g + 8 * (i >> 1); }
};

// y[e][j] = sum_{c < kin} in[e][c] w[j][c] for the tile's edges and j < m on the tensor cores;
// in: an edge-major bf16 tile with row pitch ld (kin % 16 == 0; a last chunk of fewer rows runs
// only its k16 steps); the weight: the ring's next stream. epi(col0, lanes, acc) takes each column
// block's fragments.
template <int NB, typename Epi>
__device__ __forceinline__ void tc_product(const bf16* in, int kin, int ld, int m, TcRing& ring,
                                           const Epi& epi) {
  constexpr int NT = NB / 32;
  const TcLanes l;
  const int lane = threadIdx.x & 31, n_cb = (m + NB - 1) / NB, n_ch = (kin + TC_KT - 1) / TC_KT;
  // this lane's ldmatrix rows: A (edges, and the k half), B (columns, and the k half)
  const bf16* a_row = in + (long)(32 * l.wm + (lane & 15)) * ld + 8 * (lane >> 4);
  const int b_off = (l.wn * (NB / 4) + (lane & 7) + ((lane >> 4) << 3)) * TC_SP + 8 * ((lane >> 3) & 1);
  for (int cb = 0; cb < n_cb; ++cb) {
    float acc[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
      }
    }
    for (int ch = 0; ch < n_ch; ++ch) {
      const bf16* stage = ring.next();
#pragma unroll
      for (int ks = 0; ks < TC_KT / 16; ++ks) {
        if (ch * TC_KT + 16 * ks >= kin) break;
        uint32_t a[2][4];
        ldsm4(a[0], a_row + ch * TC_KT + 16 * ks);
        ldsm4(a[1], a_row + 16 * ld + ch * TC_KT + 16 * ks);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t b[4];
          ldsm4(b, stage + b_off + 16 * np * TC_SP + 16 * ks);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma16816(acc[mt][2 * np], a[mt], b[0], b[1]);
            mma16816(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
          }
        }
      }
    }
    epi(cb * NB + l.wn * (NB / 4), l, acc);
  }
}

template <typename Epi>
__device__ __forceinline__ void tc_run(const bf16* in, int kin, int ld, int m, TcRing& ring,
                                       const Epi& epi) {
  if (pick_nb(m) == 256) {
    tc_product<256>(in, kin, ld, m, ring, epi);
  } else {
    tc_product<64>(in, kin, ld, m, ring, epi);
  }
}

// the epilogues of this route: each gets the column of its warp's first n8 tile (c0) and the
// fragments; the entry (mt, nt, i) is at edge l.edge(mt, i), column c0 + 8 nt + 2 q + i % 2
struct TcToTile {  // out[e][j] = bf16(relu(y + b[j]))
  const float* b;
  bf16* out;
  int ld, m;
  template <int NT>
  __device__ __forceinline__ void operator()(int c0, const TcLanes& l, const float (&acc)[2][NT][4]) const {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int j = c0 + 8 * nt + 2 * l.q;
      if (j >= m) continue;
      const float b0 = __ldg(b + j), b1 = __ldg(b + j + 1);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          store2(out + (long)l.edge(mt, 2 * h) * ld + j, fmaxf(acc[mt][nt][2 * h] + b0, 0.f),
                 fmaxf(acc[mt][nt][2 * h + 1] + b1, 0.f));
        }
      }
    }
  }
};

// the backward's recompute (bits and factor rows as Recompute) and its gradient products (as Masked)
template <bool MASKED>
struct TcKeep {
  const float* b;  // the bias (recompute)
  const uint64_t* bits_in;  // the mask (gradient products)
  uint64_t* bits_out;
  bf16* out;  // the tile (null: none)
  int ld, m;
  bf16* fac;  // factor rows [TC_TE][m]
  template <int NT>
  __device__ __forceinline__ void operator()(int c0, const TcLanes& l, const float (&acc)[2][NT][4]) const {
    const int word = ((c0 - l.wn * (NT * 8)) / (NT * 32)) * THREADS + threadIdx.x;
    const uint64_t in = MASKED ? bits_in[word] : 0;
    uint64_t mask = 0;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int j = c0 + 8 * nt + 2 * l.q;
      const bool ok = j < m;
      const float b0 = !MASKED && ok ? __ldg(b + j) : 0.f, b1 = !MASKED && ok ? __ldg(b + j + 1) : 0.f;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int bit = (mt * NT + nt) * 4 + 2 * h;
          float v0, v1;
          if (MASKED) {
            v0 = (in >> bit) & 1 ? acc[mt][nt][2 * h] : 0.f;
            v1 = (in >> (bit + 1)) & 1 ? acc[mt][nt][2 * h + 1] : 0.f;
          } else {
            v0 = act<bf16>(fmaxf(acc[mt][nt][2 * h] + b0, 0.f));
            v1 = act<bf16>(fmaxf(acc[mt][nt][2 * h + 1] + b1, 0.f));
            mask |= (uint64_t)(v0 > 0.f) << bit | (uint64_t)(v1 > 0.f) << (bit + 1);
          }
          if (!ok) continue;
          const int e = l.edge(mt, 2 * h);
          store2(fac + (long)e * m + j, v0, v1);
          if (out != nullptr) store2(out + (long)e * ld + j, v0, v1);
        }
      }
    }
    if (!MASKED) bits_out[word] = mask;
  }
};

struct TcOutRows {  // e_out[edge] = bf16(y + b3) for the tile's `valid` edges
  const float* b;
  bf16* e_out;
  const int* tid;
  int m, valid;
  template <int NT>
  __device__ __forceinline__ void operator()(int c0, const TcLanes& l, const float (&acc)[2][NT][4]) const {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int j = c0 + 8 * nt + 2 * l.q;
      if (j >= m) continue;
      const float b0 = __ldg(b + j), b1 = __ldg(b + j + 1);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = l.edge(mt, 2 * h);
          if (e < valid) {
            store2(e_out + (long)tid[e] * m + j, acc[mt][nt][2 * h] + b0, acc[mt][nt][2 * h + 1] + b1);
          }
        }
      }
    }
  }
};

struct TcInputGrads {  // g_m split into g_xd, g_xs, g_ea (zero where relu_edge cut ea <= 0)
  bf16* g_xd;
  bf16* g_xs;
  bf16* g_ea;
  const bf16* ea;
  const int* tid;
  int fx, fe, k, relu_edge, valid;
  template <int NT>
  __device__ __forceinline__ void operator()(int c0, const TcLanes& l, const float (&acc)[2][NT][4]) const {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int i = c0 + 8 * nt + 2 * l.q;  // even; fx and fe are multiples of 32
      if (i >= k) continue;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = l.edge(mt, 2 * h);
          if (e >= valid) continue;
          const long id = tid[e];
          float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
          if (i < fx) {
            store2(g_xd + id * fx + i, v0, v1);
          } else if (i < 2 * fx) {
            store2(g_xs + id * fx + i - fx, v0, v1);
          } else {
            const bf16* r = ea + id * fe + i - 2 * fx;
            if (relu_edge && !(to_f(r[0]) > 0.f)) v0 = 0.f;
            if (relu_edge && !(to_f(r[1]) > 0.f)) v1 = 0.f;
            store2(g_ea + id * fe + i - 2 * fx, v0, v1);
          }
        }
      }
    }
  }
};

// 8 bf16 as one 16-byte word, relu'd where `relu`
__device__ __forceinline__ uint4 relu8(uint4 u, bool relu) {
  if (!relu) return u;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    p[i] = __floats2bfloat162_rn(fmaxf(f.x, 0.f), fmaxf(f.y, 0.f));
  }
  return u;
}

// Tile t's rows [x[dst], x[src], ea] (relu(ea) with relu_edge) into m [TC_TE][ld] bf16 (zeros past
// the `count` unmasked edges) and the edge ids into tid, 16 bytes a lane, a warp's 8 edges' loads
// in flight together; gd_in / gd_out as in gather. BWD also writes the rows as factors (fac_m
// [TC_TE][k]) and g_e' = bf16(g_eout + g_agg[dst]) into get [TC_TE][fo + 8] and fac_g [TC_TE][fo].
template <bool BWD>
__device__ __forceinline__ void tc_gather(const bf16* __restrict__ x, const bf16* __restrict__ gd_in,
                                          const bf16* __restrict__ gs_in, bf16* gd_out, bf16* gs_out,
                                          const bf16* __restrict__ ea, const int* __restrict__ src,
                                          const int* __restrict__ dst, const int* __restrict__ ids,
                                          const bf16* __restrict__ g_eout,
                                          const bf16* __restrict__ g_agg, int count, int t, int fx,
                                          int fe, int fo, int relu_edge, int ld, bf16* m, bf16* get,
                                          int* tid, bf16* fac_m, bf16* fac_g) {
  constexpr int EPW = TC_TE / WARPS;
  const int lane = threadIdx.x & 31, e0 = (threadIdx.x >> 5) * EPW;
  const int k = 2 * fx + fe, vx = fx / 8, vk = k / 8, vo = fo / 8;
  const bool saved = x == nullptr;
  long edge[EPW], d[EPW], rd[EPW], rs[EPW];
  bool live[EPW];
#pragma unroll
  for (int j = 0; j < EPW; ++j) {
    const int slot = t * TC_TE + e0 + j;
    live[j] = slot < count;
    edge[j] = live[j] ? __ldg(ids + slot) : 0;
  }
#pragma unroll
  for (int j = 0; j < EPW; ++j) {
    d[j] = live[j] ? __ldg(dst + edge[j]) : 0;
    rd[j] = (saved ? edge[j] : d[j]) * fx;
    rs[j] = (saved ? edge[j] : (live[j] ? __ldg(src + edge[j]) : 0)) * fx;
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < EPW; ++j) tid[e0 + j] = (int)edge[j];
  }
  const uint4* xd = reinterpret_cast<const uint4*>(saved ? gd_in : x);
  const uint4* xs = reinterpret_cast<const uint4*>(saved ? gs_in : x);
  const uint4* ev = reinterpret_cast<const uint4*>(ea);
  for (int v0 = 0; v0 < vk; v0 += 32) {
    const int v = v0 + lane;
    uint4 u[EPW];
#pragma unroll
    for (int j = 0; j < EPW; ++j) {
      u[j] = make_uint4(0, 0, 0, 0);
      if (live[j] && v < vk) {
        u[j] = v < vx ? xd[rd[j] / 8 + v]
                      : (v < 2 * vx ? xs[rs[j] / 8 + v - vx] : relu8(ev[edge[j] * (fe / 8) + v - 2 * vx], relu_edge));
      }
    }
    if (v >= vk) continue;
#pragma unroll
    for (int j = 0; j < EPW; ++j) {
      *reinterpret_cast<uint4*>(m + (long)(e0 + j) * ld + 8 * v) = u[j];
      if (BWD) reinterpret_cast<uint4*>(fac_m + (long)(e0 + j) * k)[v] = u[j];
      if (!BWD && gd_out != nullptr && live[j]) {
        if (v < vx) {
          reinterpret_cast<uint4*>(gd_out + edge[j] * fx)[v] = u[j];
        } else if (v < 2 * vx) {
          reinterpret_cast<uint4*>(gs_out + edge[j] * fx)[v - vx] = u[j];
        }
      }
    }
  }
  if (BWD) {
    for (int v0 = 0; v0 < vo; v0 += 32) {
      const int v = v0 + lane;
      uint4 a[EPW], b[EPW];
#pragma unroll
      for (int j = 0; j < EPW; ++j) {
        a[j] = b[j] = make_uint4(0, 0, 0, 0);
        if (live[j] && v < vo) {
          a[j] = reinterpret_cast<const uint4*>(g_eout + edge[j] * fo)[v];
          b[j] = reinterpret_cast<const uint4*>(g_agg + d[j] * fo)[v];
        }
      }
      if (v >= vo) continue;
#pragma unroll
      for (int j = 0; j < EPW; ++j) {
        const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a[j]);
        const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b[j]);
        uint4 o;
        __nv_bfloat162* po = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 fa = __bfloat1622float2(pa[i]), fb = __bfloat1622float2(pb[i]);
          po[i] = __floats2bfloat162_rn(fa.x + fb.x, fa.y + fb.y);
        }
        *reinterpret_cast<uint4*>(get + (long)(e0 + j) * (fo + 8) + 8 * v) = o;
        reinterpret_cast<uint4*>(fac_g + (long)(e0 + j) * fo)[v] = o;
      }
    }
  }
}

// The forward on the tensor cores: as wide_fwd_kernel (bf16, tiles in shared memory). The
// weights: w1 = W1 [H][K], w2 = W2 [H][H], w3 = W3 [Fo][H] bf16 (FwdArgs' w1t, w2t, w3t).
__global__ void __launch_bounds__(THREADS, 1) tc_fwd_kernel(const FwdArgs<bf16> a) {
  extern __shared__ float4 smem4[];
  bf16* ring_buf = reinterpret_cast<bf16*>(smem4);
  const int k = 2 * a.fx + a.fe, h = a.h, la = max(k, h) + 8, lb = h + 8;
  bf16* A = ring_buf + TC_STAGES * TC_STAGE;
  bf16* B = A + (long)TC_TE * la;
  int* tid = reinterpret_cast<int*>(B + (long)TC_TE * lb);
  __shared__ TcStream streams[3];
  TcRing ring = start_tc_ring(ring_buf, streams,
                              {make_tc_stream(a.w1t, k, h), make_tc_stream(a.w2t, h, h),
                               make_tc_stream(a.w3t, h, a.fo)},
                              3);
  const int count = *a.count, n_tiles = (count + TC_TE - 1) / TC_TE;
  PHASE_START;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    tc_gather<false>(a.x, nullptr, nullptr, a.gd, a.gs, a.ea, a.src, a.dst, a.ids, nullptr,
                     nullptr, count, t, a.fx, a.fe, a.fo, a.relu_edge, la, A, nullptr, tid,
                     nullptr, nullptr);
    __syncthreads();
    PHASE(10);
    tc_run(A, k, la, h, ring, TcToTile{a.b1, B, lb, h});
    __syncthreads();
    PHASE(11);
    tc_run(B, h, lb, h, ring, TcToTile{a.b2, A, la, h});
    __syncthreads();
    PHASE(12);
    tc_run(A, h, la, a.fo, ring, TcOutRows{a.b3, a.e_out, tid, a.fo, min(TC_TE, count - t * TC_TE)});
    __syncthreads();
    PHASE(13);
  }
  cp_async_wait<0>();
}

// The backward's edge pass on the tensor cores: as wide_bwd_kernel (bf16, tiles in shared
// memory). The weights: w1t = W1 [H][K], w2t = W2 [H][H] (the recompute), w3 = W3^T [H][Fo], w2 =
// W2^T [H][H], w1p = W1^T [K][H] (the gradient products), bf16.
__global__ void __launch_bounds__(THREADS, 1) tc_bwd_kernel(const BwdArgs<bf16> a, int chunk) {
  extern __shared__ float4 smem4[];
  bf16* ring_buf = reinterpret_cast<bf16*>(smem4);
  const int k = 2 * a.fx + a.fe, h = a.h, fo = a.fo, la = max(k, h) + 8, lb = h + 8, lg = fo + 8;
  const int n_cb = (h + pick_nb(h) - 1) / pick_nb(h);
  bf16* A = ring_buf + TC_STAGES * TC_STAGE;
  bf16* B = A + (long)TC_TE * la;
  bf16* G = B + (long)TC_TE * lb;
  uint64_t* bits1 = reinterpret_cast<uint64_t*>(G + (long)TC_TE * lg);
  uint64_t* bits2 = bits1 + n_cb * THREADS;
  int* tid = reinterpret_cast<int*>(bits2 + n_cb * THREADS);
  const Factors<bf16> f(a.fac, (long)a.chunk_tiles * TC_TE, k, h);
  __shared__ TcStream streams[5];
  TcRing ring = start_tc_ring(ring_buf, streams,
                              {make_tc_stream(a.w1t, k, h), make_tc_stream(a.w2t, h, h),
                               make_tc_stream(a.w3, fo, h), make_tc_stream(a.w2, h, h),
                               make_tc_stream(a.w1p, h, k)},
                              5);
  const int count = *a.count, n_tiles = (count + TC_TE - 1) / TC_TE;
  const int t0 = chunk * a.chunk_tiles, t1 = min(t0 + a.chunk_tiles, n_tiles);
  PHASE_START;
  for (int t = t0 + blockIdx.x; t < t1; t += gridDim.x) {
    const long s = (long)(t - t0) * TC_TE;
    const int valid = min(TC_TE, count - t * TC_TE);
    tc_gather<true>(a.x, a.gd, a.gs, nullptr, nullptr, a.ea, a.src, a.dst, a.ids, a.g_eout,
                    a.g_agg, count, t, a.fx, a.fe, fo, a.relu_edge, la, A, G, tid, f.m + s * k,
                    f.get + s * fo);
    __syncthreads();
    PHASE(14);
    tc_run(A, k, la, h, ring, TcKeep<false>{a.b1, nullptr, bits1, B, lb, h, f.h1 + s * h});
    __syncthreads();
    PHASE(15);
    tc_run(B, h, lb, h, ring, TcKeep<false>{a.b2, nullptr, bits2, nullptr, lb, h, f.h2 + s * h});
    __syncthreads();
    PHASE(16);
    tc_run(G, fo, lg, h, ring, TcKeep<true>{nullptr, bits2, nullptr, B, lb, h, f.gh2 + s * h});
    __syncthreads();
    PHASE(17);
    tc_run(B, h, lb, h, ring, TcKeep<true>{nullptr, bits1, nullptr, A, la, h, f.gh1 + s * h});
    __syncthreads();
    PHASE(18);
    tc_run(A, h, la, k, ring,
           TcInputGrads{a.g_xd, a.g_xs, a.g_ea, a.ea, tid, a.fx, a.fe, k, a.relu_edge, valid});
    __syncthreads();
    PHASE(19);
  }
  cp_async_wait<0>();
}

// wgrad_kernel on the tensor cores (bf16 factors): a block's BT x BT tile of dW over its slice,
// the slice's edges through a 3-stage ring of TC_KT edges ([TC_KT][BT + 8] bf16 a factor); 8 warps,
// 2 along the rows (64 each) x 4 along the columns (32 each), fragments by ldmatrix.trans; the
// bias sums of the first column tile's blocks in f32 by one thread a row, edges ascending.
constexpr int TCW_P = BT + 8;  // a wgrad stage's row pitch (bf16)
constexpr int TCW_STAGE = TC_KT * TCW_P;

__global__ void __launch_bounds__(THREADS, 2) wgrad_tc_kernel(const WgradArgs<bf16> w) {
  extern __shared__ float4 smem4[];
  bf16* sg = reinterpret_cast<bf16*>(smem4);  // [WG_STAGES][TC_KT][TCW_P]
  bf16* sa = sg + WG_STAGES * TCW_STAGE;
  const int count = *w.count, n_tiles = (count + w.te - 1) / w.te;
  const int t0 = (w.slice0 + blockIdx.y) * w.slice_tiles;
  if (t0 >= n_tiles) return;
  const int n_k = (min(t0 + w.slice_tiles, n_tiles) - t0) * w.te / TC_KT;
  const int b = blockIdx.x, p = (b >= w.first[1]) + (b >= w.first[2]);
  const int tm = (b - w.first[p]) / w.tiles_n[p], tn = (b - w.first[p]) % w.tiles_n[p];
  const long slot0 = (long)(t0 - w.chunk_tile0) * w.te;
  const int pg = w.pitch_g[p], pa = w.pitch_a[p];
  const bf16* g = w.g[p] + slot0 * pg + tm * BT;
  const bf16* a = w.a[p] + slot0 * pa + tn * BT;
  const int gcols = pg - tm * BT, acols = pa - tn * BT;
  auto load = [&](int i) {
    bf16* dg = sg + (i % WG_STAGES) * TCW_STAGE;
    bf16* da = sa + (i % WG_STAGES) * TCW_STAGE;
#pragma unroll
    for (int u = 0; u < TC_KT * (BT / 8) / THREADS; ++u) {
      const int v = threadIdx.x + u * THREADS, r = v / (BT / 8), c = (v % (BT / 8)) * 8;
      const long e = (long)i * TC_KT + r;
      cp_async16(dg + r * TCW_P + c, c < gcols ? g + e * pg + c : g, c < gcols ? 16 : 0);
      cp_async16(da + r * TCW_P + c, c < acols ? a + e * pa + c : a, c < acols ? 16 : 0);
    }
  };
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, wm = warp >> 2, wn = warp & 3;
  const bool bias = tn == 0;
  float acc[4][4][4], bsum = 0.f;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
    }
  }
  // this lane's ldmatrix.trans rows: A from g [edge][row] (k-major), B from a [edge][column]
  const int a_off = ((lane & 7) + ((lane >> 4) << 3)) * TCW_P + 64 * wm + 8 * ((lane >> 3) & 1);
  const int b_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * TCW_P + 32 * wn + 8 * (lane >> 4);
#pragma unroll
  for (int s = 0; s < WG_STAGES - 1; ++s) {
    if (s < n_k) load(s);
    cp_async_commit();
  }
  for (int i = 0; i < n_k; ++i) {
    cp_async_wait<WG_STAGES - 2>();
    __syncthreads();
    if (i + WG_STAGES - 1 < n_k) load(i + WG_STAGES - 1);
    cp_async_commit();
    const bf16* dg = sg + (i % WG_STAGES) * TCW_STAGE;
    const bf16* da = sa + (i % WG_STAGES) * TCW_STAGE;
#pragma unroll
    for (int ks = 0; ks < TC_KT / 16; ++ks) {
      uint32_t af[4][4], bf[2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) ldsm4t(af[mt], dg + a_off + 16 * ks * TCW_P + 16 * mt);
#pragma unroll
      for (int np = 0; np < 2; ++np) ldsm4t(bf[np], da + b_off + 16 * ks * TCW_P + 16 * np);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          mma16816(acc[mt][2 * np], af[mt], bf[np][0], bf[np][1]);
          mma16816(acc[mt][2 * np + 1], af[mt], bf[np][2], bf[np][3]);
        }
      }
    }
    if (bias && threadIdx.x < BT) {
      for (int r = 0; r < TC_KT; ++r) bsum += to_f(dg[r * TCW_P + threadIdx.x]);
    }
  }
  float* out = w.partial + (long)(w.slice0 + blockIdx.y) * w.p;
  const int rows = w.rows[p], cols = w.cols[p], g8 = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = tm * BT + 64 * wm + 16 * mt + g8 + 8 * (i >> 1);
      if (row >= rows) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = tn * BT + 32 * wn + 8 * nt + 2 * q + (i & 1);
        if (col < cols) out[w.woff[p] + (long)row * cols + col] = acc[mt][nt][i];
      }
    }
  }
  if (bias && threadIdx.x < BT && tm * BT + (int)threadIdx.x < rows) {
    out[w.boff[p] + tm * BT + threadIdx.x] = bsum;
  }
}

template <typename T>
using FwdKernel = void (*)(FwdArgs<T>);
template <typename T>
using BwdKernel = void (*)(BwdArgs<T>, int);
template <typename T>
using WgradKernel = void (*)(WgradArgs<T>);
// the tensor-core kernels of a dtype (bf16 only)
inline FwdKernel<bf16> tc_kernel(const FwdArgs<bf16>&) { return tc_fwd_kernel; }
inline FwdKernel<float> tc_kernel(const FwdArgs<float>&) { return nullptr; }
inline BwdKernel<bf16> tc_kernel(const BwdArgs<bf16>&) { return tc_bwd_kernel; }
inline BwdKernel<float> tc_kernel(const BwdArgs<float>&) { return nullptr; }
inline WgradKernel<bf16> tc_kernel(const WgradArgs<bf16>&) { return wgrad_tc_kernel; }
inline WgradKernel<float> tc_kernel(const WgradArgs<float>&) { return nullptr; }

// ------------------------------------------------------------------- the launches
template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) cudaGetLastError();  // not to resurface in a later call's check
  return err;
}

// The shared memory of an edge kernel at tile te (tiles null: in shared memory too; tc: the
// tensor-core route, te = TC_TE), checked against the card's opt-in limit; te must be 64 or 32 on
// the CUDA cores, and DEVICE_TE with device tiles.
cudaError_t edge_smem(int k, int h, int fo, bool backward, int te, const float* tiles, bool tc,
                      size_t* smem) {
  if (tc ? te != TC_TE || tiles != nullptr || k % 32 || h % 32 || fo % 32
         : (tiles != nullptr ? te != DEVICE_TE : te != 64 && te != 32)) {
    return cudaErrorInvalidValue;
  }
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return err;
  if (tc) {
    *smem = (size_t)(TC_RING_BYTES + tc_tile_bytes(k, h, fo, backward));
  } else {
    const long floats = RING_FLOATS + (tiles != nullptr ? 0 : tile_floats(k, h, fo, backward, te));
    *smem = (size_t)floats * sizeof(float);
  }
  return (long)*smem <= optin ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T>
int masked_rows(const int* ids, const int* count, int n_edges, T* z0, int w0, T* z1, int w1, T* z2,
                int w2, const T* x, const int* edge_index, T* gd, T* gs, int fx, int blocks,
                cudaStream_t stream) {
  const int grid = (n_edges + WARPS - 1) / WARPS < 4 * blocks ? (n_edges + WARPS - 1) / WARPS
                                                               : 4 * blocks;
  masked_rows_kernel<T><<<grid, THREADS, 0, stream>>>(ids, count, n_edges, z0, w0, z1, w1, z2, w2,
                                                      x, edge_index, edge_index + n_edges, gd, gs,
                                                      fx);
  return cudaGetLastError();
}

template <typename T>
int fwd(const FwdArgs<T>& a, int n_edges, int te, int blocks, bool tc, cudaStream_t stream) {
  size_t smem = 0;
  cudaError_t err = edge_smem(2 * a.fx + a.fe, a.h, a.fo, false, te, a.tiles, tc, &smem);
  if (err != cudaSuccess) return err;
  const FwdKernel<T> kernel =
      tc ? tc_kernel(a)
         : (a.tiles != nullptr ? wide_fwd_kernel<T, DEVICE_TE, true>
                               : (te == 64 ? wide_fwd_kernel<T, 64, false> : wide_fwd_kernel<T, 32, false>));
  if (kernel == nullptr) return cudaErrorInvalidValue;
  err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  err = (cudaError_t)masked_rows<T>(a.ids, a.count, n_edges, a.e_out, a.fo, nullptr, 0, nullptr, 0,
                                    a.x, a.src, a.gd, a.gs, a.fx, blocks, stream);
  if (err != cudaSuccess) return err;
  const int tiles = (n_edges + te - 1) / te;  // at most: the masked edges take no tile
  kernel<<<tiles < blocks ? tiles : blocks, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
int bwd(const BwdArgs<T>& a, const int* edge_index, float* partial, float* grads, int n_edges,
        int te, int blocks, int n_chunks, int slices, int slice_tiles, bool tc,
        cudaStream_t stream) {
  const int k = 2 * a.fx + a.fe, kp = padded_k(k), h = a.h, fo = a.fo;
  const int n_tiles_max = (n_edges + te - 1) / te;
  if (a.chunk_tiles < 1 || slices < 1 || slices * slice_tiles != a.chunk_tiles ||
      (long)n_chunks * a.chunk_tiles < n_tiles_max || te % (tc ? TC_KT : BK) != 0) {
    return cudaErrorInvalidValue;
  }
  size_t smem = 0;
  cudaError_t err = edge_smem(k, h, fo, true, te, a.tiles, tc, &smem);
  if (err != cudaSuccess) return err;
  const BwdKernel<T> kernel =
      tc ? tc_kernel(a)
         : (a.tiles != nullptr ? wide_bwd_kernel<T, DEVICE_TE, true>
                               : (te == 64 ? wide_bwd_kernel<T, 64, false> : wide_bwd_kernel<T, 32, false>));
  if (kernel == nullptr) return cudaErrorInvalidValue;
  err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const WgradKernel<T> wkernel = tc ? tc_kernel(WgradArgs<T>{}) : wgrad_kernel<T>;
  const size_t wsmem = tc ? 2 * WG_STAGES * TCW_STAGE * sizeof(bf16) : 2 * WG_STAGES * BK * BT * sizeof(T);
  err = set_smem(wkernel, wsmem);
  if (err != cudaSuccess) return err;
  err = (cudaError_t)masked_rows<T>(a.ids, a.count, n_edges, a.g_xd, a.fx, a.g_xs, a.fx, a.g_ea,
                                    a.fe, nullptr, edge_index, nullptr, nullptr, a.fx, blocks,
                                    stream);
  if (err != cudaSuccess) return err;
  const long slots = (long)a.chunk_tiles * te;
  const Factors<T> f(a.fac, slots, kp, h);
  WgradArgs<T> w{};
  const T* gs[3] = {f.gh1, f.gh2, f.get};
  const T* as[3] = {f.m, f.h1, f.h2};
  const int rows[3] = {h, h, fo}, cols[3] = {k, h, h}, pitch_g[3] = {h, h, fo},
            pitch_a[3] = {kp, h, h};
  const long woff[3] = {0, (long)h * k + h, (long)h * k + h + (long)h * h + h};
  int dw_tiles = 0;
  for (int p = 0; p < 3; ++p) {
    w.g[p] = gs[p];
    w.a[p] = as[p];
    w.pitch_g[p] = pitch_g[p];
    w.pitch_a[p] = pitch_a[p];
    w.rows[p] = rows[p];
    w.cols[p] = cols[p];
    w.woff[p] = woff[p];
    w.boff[p] = woff[p] + (long)rows[p] * cols[p];
    w.tiles_n[p] = (cols[p] + BT - 1) / BT;
    w.first[p] = dw_tiles;
    dw_tiles += (rows[p] + BT - 1) / BT * w.tiles_n[p];
  }
  w.partial = partial;
  w.p = grad_floats(k, h, fo);
  w.count = a.count;
  w.te = te;
  w.slice_tiles = slice_tiles;
  const int grid = a.chunk_tiles < blocks ? a.chunk_tiles : blocks;
  for (int c = 0; c < n_chunks; ++c) {
    kernel<<<grid, THREADS, smem, stream>>>(a, c);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    w.chunk_tile0 = c * a.chunk_tiles;
    w.slice0 = c * slices;
    wkernel<<<dim3(dw_tiles, slices), THREADS, wsmem, stream>>>(w);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  fixed_order_sum::sum_partials_kernel<<<(unsigned)((w.p + THREADS - 1) / THREADS), THREADS, 0,
                                          stream>>>(partial, n_chunks * slices, slice_tiles * te,
                                                    a.count, w.p, grads);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

#ifdef WIDE_PHASES
// the phase cycles summed since the last call (24 counters), then zeroed
int fused_relational_wide_phases(void* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, wide_phase_cycles, sizeof(wide_phase_cycles));
  if (err != cudaSuccess) return err;
  static const unsigned long long zero[24] = {};
  return cudaMemcpyToSymbol(wide_phase_cycles, zero, sizeof(zero));
}
#endif

// The forward. x [N, Fx], ea [E, Fe], e_out [E, Fo] (and with save gd, gs [E, Fx]) in f32, or
// bf16 where bf16 != 0; edge_index [2, E] i32 (row 0 source, row 1 target); ids [E] i32 the edge
// ids, unmasked first (*count of them, on the device), then the masked; biases f32 [H], [H], [Fo].
// On the CUDA cores (tc = 0) the weights are f32, w1 = W1^T [K][H], w2 = W2^T [H][H], w3 = W3^T
// [H][Fo] (H, Fo multiples of 4), te (64 or 32) edges a tile, tiles null where they fit shared
// memory, else te = 32 and `blocks` slices of the plan's device_tile_floats floats; on the
// tensor cores (tc = 1, bf16, every width a multiple of 32) the weights are bf16, w1 = W1 [H][K],
// w2 = W2 [H][H], w3 = W3 [Fo][H], te = 64 and tiles null. At most `blocks` blocks. te, tc,
// blocks and tiles are the plan's (fused_relational_wide_plan). Returns cudaGetLastError().
int fused_relational_wide_fwd(const void* x, const void* ea, const int* edge_index, const int* ids,
                              const int* count, const void* w1, const float* b1, const void* w2,
                              const float* b2, const void* w3, const float* b3, void* e_out,
                              void* gd, void* gs, float* tiles, int n_edges, int fx, int fe, int h,
                              int fo, int relu_edge, int bf16, int save, int te, int tc, int blocks,
                              void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_edges == 0) return cudaSuccess;
  if (h % 4 != 0 || fo % 4 != 0 || blocks < 1) return cudaErrorInvalidValue;
  const float* w1f = static_cast<const float*>(w1);
  const float* w2f = static_cast<const float*>(w2);
  const float* w3f = static_cast<const float*>(w3);
  if (bf16) {
    using T = __nv_bfloat16;
    const FwdArgs<T> a{static_cast<const T*>(x), static_cast<const T*>(ea), edge_index,
                       edge_index + n_edges, ids, count, w1f, b1, w2f, b2, w3f, b3,
                       static_cast<T*>(e_out), save ? static_cast<T*>(gd) : nullptr,
                       save ? static_cast<T*>(gs) : nullptr, tiles, fx, fe, h, fo, relu_edge};
    return fwd(a, n_edges, te, blocks, tc != 0, stream);
  }
  const FwdArgs<float> a{static_cast<const float*>(x), static_cast<const float*>(ea), edge_index,
                         edge_index + n_edges, ids, count, w1f, b1, w2f, b2, w3f, b3,
                         static_cast<float*>(e_out), save ? static_cast<float*>(gd) : nullptr,
                         save ? static_cast<float*>(gs) : nullptr, tiles, fx, fe, h, fo,
                         relu_edge};
  return fwd(a, n_edges, te, blocks, tc != 0, stream);
}

// The backward, from x, or (x null) from the rows gd = x[dst], gs = x[src] [E, Fx] that the
// saving forward wrote. ids / count, te, tc, tiles and blocks as in the forward; b1, b2 f32; the
// weights: the recompute's w1r, w2r as the forward's w1, w2 (their dtype and orientation at tc),
// and the gradient products' w1g, w2g, w3g: on the CUDA cores f32 W1 [H][K4] (rows zero-padded to
// K4 = K rounded up to 4), W2 [H][H], W3 [Fo][H]; on the tensor cores bf16 W1^T [K][H], W2^T
// [H][H], W3^T [H][Fo]. g_eout [E, Fo], g_agg [N, Fo]; writes the per-edge gradients g_xd, g_xs
// [E, Fx] (of x_dst and x_src), g_ea [E, Fe] in the input dtype, and grads [P] f32 packed as w1,
// b1, w2, b2, w3, b3 ([out][in]). The edges run in n_chunks chunks of chunk_tiles tiles, whose
// factors take `factors` (chunk_tiles te (K8 + 4 H + Fo) elements of the input dtype, K8 = K
// rounded up to 8); each chunk's weight gradients in `slices` slices of slice_tiles tiles (slices
// slice_tiles = chunk_tiles), one partial [P] f32 a slice in `partial` [n_chunks slices][P].
// Returns cudaGetLastError().
int fused_relational_wide_bwd(const void* x, const void* gd, const void* gs, const void* ea,
                              const int* edge_index, const int* ids, const int* count,
                              const void* w1r, const float* b1, const void* w2r, const float* b2,
                              const void* w1g, const void* w2g, const void* w3g,
                              const void* g_eout, const void* g_agg, void* g_xd, void* g_xs,
                              void* g_ea, void* factors, float* partial, float* grads,
                              float* tiles, int n_edges, int fx, int fe, int h, int fo,
                              int relu_edge, int bf16, int te, int tc, int blocks, int chunk_tiles,
                              int n_chunks, int slices, int slice_tiles, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_edges == 0) return cudaSuccess;
  if (h % 4 != 0 || fo % 4 != 0 || blocks < 1) return cudaErrorInvalidValue;
  const float* w[5] = {static_cast<const float*>(w1r), static_cast<const float*>(w2r),
                       static_cast<const float*>(w1g), static_cast<const float*>(w2g),
                       static_cast<const float*>(w3g)};
  if (bf16) {
    using T = __nv_bfloat16;
    const BwdArgs<T> a{static_cast<const T*>(x), static_cast<const T*>(gd),
                       static_cast<const T*>(gs), static_cast<const T*>(ea), edge_index,
                       edge_index + n_edges, ids, count, w[0], b1, w[1], b2, w[2], w[3], w[4],
                       static_cast<const T*>(g_eout), static_cast<const T*>(g_agg),
                       static_cast<T*>(g_xd), static_cast<T*>(g_xs), static_cast<T*>(g_ea),
                       static_cast<T*>(factors), tiles, fx, fe, h, fo, relu_edge, chunk_tiles};
    return bwd(a, edge_index, partial, grads, n_edges, te, blocks, n_chunks, slices, slice_tiles,
               tc != 0, stream);
  }
  const BwdArgs<float> a{static_cast<const float*>(x), static_cast<const float*>(gd),
                         static_cast<const float*>(gs), static_cast<const float*>(ea), edge_index,
                         edge_index + n_edges, ids, count, w[0], b1, w[1], b2, w[2], w[3], w[4],
                         static_cast<const float*>(g_eout), static_cast<const float*>(g_agg),
                         static_cast<float*>(g_xd), static_cast<float*>(g_xs),
                         static_cast<float*>(g_ea), static_cast<float*>(factors), tiles, fx, fe, h,
                         fo, relu_edge, chunk_tiles};
  return bwd(a, edge_index, partial, grads, n_edges, te, blocks, n_chunks, slices, slice_tiles,
             tc != 0, stream);
}

}  // extern "C"
