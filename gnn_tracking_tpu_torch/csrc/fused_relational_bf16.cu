// Fused interaction-network edge pipeline in bf16 on the tensor cores, forward and backward, for
// Hopper (sm_90a).
//
// Replaces the TPU kernels of the JAX package run with compute_dtype="bfloat16":
//   A  fused_relational_bf16_fwd       gnn_tracking_tpu/ops/pallas/fused_relational.py
//      (_fwd_kernel_flat, fused_relational_flat :721) and fused_relational_t.py (_fwd_kernel_t,
//      fused_relational_flat_t :308, and fused_relational_layer_tt without save_acts);
//   B  fused_relational_bf16_bwd       their VJPs, fused_relational.py (_bwd_kernel_flat :781)
//      and fused_relational_t.py (_bwd_kernel_t :377);
//   C  fused_relational_bf16_fwd_save  fused_relational_t.py (_fwd_kernel_save_t :610): A, and
//      it also writes the gathered endpoint rows x[dst], x[src] ([E, Fx] bf16 each);
//   D  fused_relational_bf16_bwd_saved fused_relational_t.py (_bwd_kernel_saved_t :680): B,
//      reading those rows in place of the gather.
// The TPU layouts (natural, edges on lanes, transposed across the stack) are one function; here
// the edges are target-sorted rows. For every edge (src -> dst), with m = [x_dst, x_src, ea]
// (ea through a ReLU first with relu_edge):
//     h1 = bf16(relu(m W1^T + b1)),  h2 = bf16(relu(h1 W2^T + b2)),
//     e' = bf16(mask ? h2 W3^T + b3 : 0)
// with bf16 operands and f32 accumulation in every product, and the biases added in f32. The
// aggregation agg = bf16(f32 sum of e' per target) is csr_segment.cu's segment sum over the bf16
// rows, launched by the wrapper. The backward recomputes h1 and h2 (B) or reads the gathered rows
// and recomputes from them (D), then
//     g_e' = bf16(mask ? g_e'_out + g_agg[dst] : 0)     (g_agg read by dst here: no gather kernel)
//     g_h2 = bf16((g_e' W3) * [h2 > 0]),  g_h1 = bf16((g_h2 W2) * [h1 > 0]),  g_m = bf16(g_h1 W1)
// and writes g_m's three column blocks as g_xd, g_xs (per-edge node gradients, summed per node
// by the wrapper with csr_segment.cu, target side and source side) and g_ea (zero where ea <= 0
// with relu_edge). dW1 = g_h1^T m, dW2 = g_h2^T h1, dW3 = g_e'^T h2 and the bias gradients are
// f32 sums, rounded to bf16 once at the end. The ReLU masks are read off the bf16 activations:
// [bf16(relu(p)) > 0] equals [p > 0] for every f32 p except 0 < p < 2^-134, which bf16 cannot hold.
//
// What bounds them on this card: at ec.yml's widths (Fx = Fe = Fo = 64, K = 2 Fx + Fe = 192,
// H = 128) the forward does 2 (K H + H H + H Fo) = 98,304 flops per edge against 640 bytes of
// compulsory traffic per edge (x rows counted once per node), ~150 flop/byte: below the bf16
// ridge (~295), so the forward's floor is bytes (~0.023 ms at 262,144 edges) with arithmetic
// close behind (~0.026 ms at 989 TFLOP/s). The backward does 2 (3 K H + 3 H H + 2 H Fo) flops per
// edge, ~0.074 ms of tensor-core time at 262,144 edges: arithmetic.
//
// Forward design (A, C; 16 warps, one block an SM, 180 KiB of shared memory at ec.yml's widths).
// The forward's floor is bytes (above), and a tile's three products are ~3 M multiply-adds, ~1,500
// cycles of an SM's tensor cores; what bounds a straightforward kernel is everything around them:
// gathers that the products wait for, work on masked edges, and narrow stores. So:
//  * only unmasked edges are computed: the wrapper's stable partition of the edge ids (unmasked
//    first, count on the device; the layer's backward takes the same partition) gives blocks
//    tiles of TE unmasked edges, and the masked edges get their zero e' rows (and, in C, their
//    endpoint rows as plain row copies) without any MLP work;
//  * one layout with the backward: weights and tiles are 8 x 8 core matrices (cm below), and the
//    three products run on wgmma through the backward's product<0> (W read K-major for m W^T), so
//    h1 and h2 are the backward's recompute, bit for bit;
//  * no load waits in front of the tensor cores: the next tile's m rows go by cp.async into a
//    second m buffer before this tile's products (one buffer where two do not fit, refilled once
//    this tile's m is read), and the edge ids and endpoints come two tiles ahead through the
//    backward's ring of three index slots;
//  * e' is staged as bf16 in h1's buffer once h1 is read and written out as whole 16-byte pieces
//    of rows, lane pairs on a row's 32-byte sector; C writes its saved endpoint rows from the
//    landed m tile the same way. Every launch gives the same bits, and C's e' are A's.
// Backward design (B, D; 16 warps, one block an SM, 203 KiB of shared memory at ec.yml's
// widths):
//  * the edge ids come partitioned stably, unmasked first (count on the device; the forward's
//    partition); blocks take tiles of TE unmasked edges only, and the masked edges get their
//    zero rows of g_xd, g_xs, g_ea directly (a masked edge adds exactly 0 to every
//    weight-gradient sum);
//  * weights and tiles are stored as 8 x 8 core matrices (cm below), the layout wgmma reads
//    without a swizzle and ldmatrix reads without bank conflicts;
//  * the recompute and input-gradient products run on wgmma (m64n32k16 or m64n48k16, both
//    operands in shared memory, W read K-major for m W^T and MN-major for g W): the four
//    warpgroups take 32- or 48-column slices of the 64-edge tile;
//  * the weight gradients g^T a run on mma.sync (ldmatrix.trans for both operands), 16 x 32
//    chunks a warp. dW3 and dW2 (48 chunks at ec.yml's widths, 3 a warp: 48 f32 a thread) stay
//    in registers for the whole launch and are stored once into the block's slice of a
//    [blocks, P] f32 partial; dW1's chunks are summed per tile and added into the partial in
//    the L2 (red.global.add.v2.f32) by each entry's only writer, in tile order: 98,304 bytes a
//    tile, where the parent read and wrote the whole 197,888-byte partial every tile. A second
//    kernel sums the partials of the blocks that took a tile, in block order;
//  * bias gradients are products too: the weight-gradient A fragments (g^T) times a B fragment
//    of ones, on the chunk whose columns start at 0;
//  * no load waits in front of the tensor cores: the next tile's m rows go by cp.async into a
//    second m buffer before this tile's products, its g_e'_out and g_agg[dst] rows into the h1
//    and g_h2 buffers while phase 3 (which reads neither) runs, and the edge ids and endpoints
//    come two tiles ahead through a ring of three index slots. Widths whose second m buffer
//    does not fit (Fo = H = 128 at K = 192, K = 288 at H = 128) keep one (BUFFERS = 1): the
//    next tile's m rows are copied after this tile's last read of m; wider ones are refused;
//  * every sum's order is fixed by blockIdx, the tile order and the chunk's owner, so two
//    launches give the same bits, and D gives B's bits: the saved rows are the values the
//    gather reads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fixed_order_sum.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TE = 64;  // edges per tile
// 16 warps a block (4 warpgroups): 4 a scheduler, to hide the latencies of ldmatrix and mma.sync
// at 128 registers a thread
constexpr int WARPS = 16;
constexpr int THREADS = 32 * WARPS;

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const bf16* p) {
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The shared-memory tiles use the core-matrix layout that wgmma reads without a
// swizzle: an R x C bf16 tile is stored as (R/8) x (C/8) core matrices of 8 x 8 elements, each
// 128 contiguous bytes (8 rows of 16 bytes), along C first. Element (r, c) sits at cm(r, c, C).
// Any 16-byte row of a core matrix is also an ldmatrix row, and the 8 rows of one ldmatrix
// matrix are one core matrix: 128 contiguous bytes, no bank conflict.
__device__ __forceinline__ int cm(int r, int c, int C) {
  return (((r >> 3) * (C >> 3) + (c >> 3)) << 6) + ((r & 7) << 3) + (c & 7);
}

// One warp, one 16 x 32 chunk of a weight gradient over the tile's TE edges:
// acc[j] (+)= G[:, m0:m0+16]^T Act[:, n0+8j : n0+8j+8] (G [TE][cg], Act [TE][ca] in shared
// memory, core-matrix layout, both read through ldmatrix.trans). With `bias`, also bacc (+)= the
// column sums of G[:, m0:m0+16] (bacc[0] for column m0+g, bacc[1] for m0+g+8), as the product of
// the same A fragments with a B of ones: the bias gradient on the tensor cores, no serial loop.
__device__ __forceinline__ void wgrad_chunk(float (&acc)[4][4], float (&bacc)[2], bool bias,
                                            const bf16* G, int cg, int m0, const bf16* Act,
                                            int ca, int n0) {
  constexpr uint32_t ONES = 0x3f803f80u;  // two bf16 1.0
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k0 = 0; k0 < TE; k0 += 16) {
    uint32_t a[4];
    ldsm4t(a, G + cm(k0 + (lane & 7) + ((lane >> 4) << 3), m0 + (((lane >> 3) & 1) << 3), cg));
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int nb = n0 + 16 * half;
      uint32_t b[4];
      ldsm4t(b, Act + cm(k0 + (lane & 7) + (((lane >> 3) & 1) << 3), nb + ((lane >> 4) << 3), ca));
      mma16816(acc[2 * half], a, b[0], b[1]);
      mma16816(acc[2 * half + 1], a, b[2], b[3]);
    }
    if (bias) {
      float c[4] = {bacc[0], 0.f, bacc[1], 0.f};
      mma16816(c, a, ONES, ONES);
      bacc[0] = c[0];
      bacc[1] = c[2];
    }
  }
}

// Write a chunk's sums into the block's partial: part_w [rows][kin] (the chunk at (m0, n0)) and,
// with `bias`, part_b [rows]. `first` stores (the block's first tile, or the registers' final
// flush); else each entry is added in the L2 (red.global.add, two floats at a time for the
// weights) by its only writer, whose same-address operations keep program order (tile order).
__device__ __forceinline__ void flush_chunk(const float (&acc)[4][4], const float (&bacc)[2],
                                            bool bias, int m0, int n0, float* __restrict__ part_w,
                                            int kin, float* __restrict__ part_b, bool first) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float* entry = part_w + (long)(m0 + g + 8 * r) * kin + n0 + 8 * j + 2 * t;
      if (first) {
        *reinterpret_cast<float2*>(entry) = make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
      } else {
        // result unused: compiled to red.global.add.v2.f32
        atomicAdd(reinterpret_cast<float2*>(entry), make_float2(acc[j][2 * r], acc[j][2 * r + 1]));
      }
    }
  }
  if (bias && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (first) {
        part_b[m0 + g + 8 * r] = bacc[r];
      } else {
        atomicAdd(part_b + m0 + g + 8 * r, bacc[r]);
      }
    }
  }
}

// This tile's sum of chunk c of a weight gradient (nout x kin, chunks of 16 x 32 numbered down
// the rows first; G [TE][nout], Act [TE][kin]), added into the partial at once (flush_chunk)
__device__ __forceinline__ void wgrad_chunk_flush(int c, const bf16* G, int nout, const bf16* Act,
                                                  int kin, float* part_w, float* part_b,
                                                  bool first) {
  const int mt = nout / 16;
  const int m0 = (c % mt) * 16, n0 = (c / mt) * 32;
  float acc[4][4] = {};
  float bacc[2] = {0.f, 0.f};
  wgrad_chunk(acc, bacc, n0 == 0, G, nout, m0, Act, kin, n0);
  flush_chunk(acc, bacc, n0 == 0, m0, n0, part_w, kin, part_b, first);
}

__device__ __forceinline__ void store2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

__device__ __forceinline__ bool positive(const bf16* p) { return __bfloat162float(*p) > 0.f; }

// 8 bf16 through a ReLU (a set sign bit gives +0)
__device__ __forceinline__ uint4 relu8(uint4 v) {
  uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t lo = (w[i] & 0x8000u) ? 0u : (w[i] & 0xffffu);
    uint32_t hi = (w[i] & 0x80000000u) ? 0u : (w[i] & 0xffff0000u);
    w[i] = lo | hi;
  }
  return v;
}

__device__ __forceinline__ uint4 ld16(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// ---------------------------------------------------------------- layouts, slots and products
// Weight-gradient chunks a warp keeps in registers for the whole launch: chunk warp + WARPS s
// (s < REG_SLOTS) of dW3's chunks followed by dW2's (48 chunks at ec.yml's widths: all of them).
constexpr int REG_SLOTS = 48 / WARPS;

// The backward's shared memory: W1, W2, W3 ([out][in]) and the tiles, all in the core-matrix
// layout (cm), then b1, b2 as f32 and the edge slots. `buffers` m tiles: 2 where they fit (the
// next tile's m rows arrive during this tile's products), else 1 (they are copied after this
// tile's last read of m, and waited at the next tile's start).
struct BwdLayout {
  int k, h, fo, buffers;
  __host__ __device__ BwdLayout(int k_, int h_, int fo_, int buffers_)
      : k(k_), h(h_), fo(fo_), buffers(buffers_) {}
  // h1 and g_h2 widths: they also take the next tile's g_e'_out and g_agg[dst] rows
  __host__ __device__ int act() const { return h > fo ? h : fo; }
  __host__ __device__ long weights() const { return (long)h * k + (long)h * h + (long)fo * h; }
  __host__ __device__ long tiles() const {
    return (long)TE * (buffers * k + 2 * act() + h + fo);
  }
  __host__ __device__ long bytes() const {
    return 2L * (weights() + tiles()) + 4L * 2 * h + 4L * 3 * 3 * TE;
  }
};

// The forward's shared memory: the same weights and m tiles, then h1 (which also takes the tile's
// e' rows once h1 is read) and h2, b1, b2, b3 as f32 and the edge slots.
struct FwdLayout {
  int k, h, fo, buffers;
  __host__ __device__ FwdLayout(int k_, int h_, int fo_, int buffers_)
      : k(k_), h(h_), fo(fo_), buffers(buffers_) {}
  __host__ __device__ int act() const { return h > fo ? h : fo; }
  __host__ __device__ long bytes() const {
    return 2L * ((long)h * k + (long)h * h + (long)fo * h + (long)TE * (buffers * k + act() + h)) +
           4L * (2 * h + fo) + 4L * 3 * 3 * TE;
  }
};

// The per-tile edge slots: [3][3][TE] ints (edge id, dst, src; id -1 past the tile's unmasked
// edges). Tile j of a block uses slot j % 3; the next tile's copies read slot (j + 1) % 3, and
// slot (j + 2) % 3 is filled during tile j for tile j + 2.
struct Slots {
  int* base;
  __device__ int* id(int s) const { return base + s * 3 * TE; }
  __device__ int* dst(int s) const { return base + s * 3 * TE + TE; }
  __device__ int* src(int s) const { return base + s * 3 * TE + 2 * TE; }
};

// ---- wgmma (sm_90a): the input-side products, both operands in shared memory
// Matrix descriptor of a no-swizzle (core-matrix) operand: start address, the byte distance
// between core matrices adjacent in the leading dimension (lbo) and in the strided one (sbo).
__device__ __forceinline__ uint64_t gmma_desc(const bf16* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((saddr(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}
// shared-memory writes of this thread (st.shared, landed cp.async) before wgmma reads them
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void gmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void gmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void gmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving uses of an accumulator across the wait
__device__ __forceinline__ void reg_fence(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// d (+)= A B for a 64 x 16 A (K-major) and a 16 x NS B (TB = 0: K-major; 1: MN-major); f32 d
template <int TB>
__device__ __forceinline__ void gmma_n32(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc), "n"(TB));
}
template <int TB>
__device__ __forceinline__ void gmma_n48(float (&d)[24], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, 0, %27;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(acc), "n"(TB));
}

// out[TE, n] = A[TE, kdim] B on wgmma: A is a cm tile [TE][kdim]; B is W [n][kdim] (TB = 0,
// K-major: cm with C = kdim) or W [kdim][n] (TB = 1, MN-major: cm with C = n). The 4 warpgroups
// take NS-wide column slices in turn; epi(row, col, v0, v1) receives (row, col) and (row, col+1).
template <int NS, int TB, typename Epi>
__device__ __forceinline__ void gmma_product(const bf16* A, int kdim, const bf16* B, int n,
                                             Epi epi) {
  constexpr int R = NS / 2;
  const int wg = threadIdx.x >> 7, wi = (threadIdx.x >> 5) & 3;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  for (int n0 = wg * NS; n0 < n; n0 += 4 * NS) {
    float d[R];
#pragma unroll
    for (int i = 0; i < R; ++i) d[i] = 0.f;
    // the zeros are defined before the fence: no move of an accumulator may fall between the
    // wgmmas (ptxas would serialize them)
#pragma unroll
    for (int i = 0; i < R; ++i) reg_fence(d[i]);
    gmma_fence();
    for (int k0 = 0; k0 < kdim; k0 += 16) {
      // A: core matrices adjacent in K are 128 B apart, in M kdim * 16 B
      const uint64_t da = gmma_desc(A + cm(0, k0, kdim), 128, kdim * 16);
      const uint64_t db = TB == 0 ? gmma_desc(B + cm(n0, k0, kdim), 128, kdim * 16)
                                  : gmma_desc(B + cm(k0, n0, n), n * 16, 128);
      if constexpr (NS == 32) {
        gmma_n32<TB>(d, da, db, k0 > 0);
      } else {
        gmma_n48<TB>(d, da, db, k0 > 0);
      }
    }
    gmma_commit();
    gmma_wait_all();
#pragma unroll
    for (int i = 0; i < R; ++i) reg_fence(d[i]);
#pragma unroll
    for (int j = 0; j < NS / 8; ++j) {
      epi(16 * wi + g, n0 + 8 * j + 2 * t, d[4 * j], d[4 * j + 1]);
      epi(16 * wi + g + 8, n0 + 8 * j + 2 * t, d[4 * j + 2], d[4 * j + 3]);
    }
  }
}

// gmma_product with the slice width that splits n evenly over the 4 warpgroups where one does
template <int TB, typename Epi>
__device__ __forceinline__ void product(const bf16* A, int kdim, const bf16* B, int n, Epi epi) {
  if (n % (4 * 32) != 0 && n % (4 * 48) == 0) {
    gmma_product<48, TB>(A, kdim, B, n, epi);
  } else {
    gmma_product<32, TB>(A, kdim, B, n, epi);
  }
}

// Stage W1, W2, W3 ([out][in]) in the core-matrix layout and b1, b2 (and b3 where given) as f32.
__device__ __forceinline__ void stage_weights_cm(int k, int h, int fo, bf16* sw1, bf16* sw2,
                                                 bf16* sw3, float* sb, const bf16* w1,
                                                 const bf16* b1, const bf16* w2, const bf16* b2,
                                                 const bf16* w3, const bf16* b3) {
  const struct { const bf16* src; bf16* dst; int rows, cols; } mats[3] = {
      {w1, sw1, h, k}, {w2, sw2, h, h}, {w3, sw3, fo, h}};
  for (const auto& m : mats) {
    const int vecs = m.cols / 8;
    for (int i = threadIdx.x; i < m.rows * vecs; i += THREADS) {
      const int r = i / vecs, c = (i % vecs) * 8;
      *reinterpret_cast<uint4*>(m.dst + cm(r, c, m.cols)) = ld16(m.src + (long)r * m.cols + c);
    }
  }
  for (int i = threadIdx.x; i < h; i += THREADS) {
    sb[i] = __bfloat162float(b1[i]);
    sb[h + i] = __bfloat162float(b2[i]);
  }
  if (b3 != nullptr) {
    for (int i = threadIdx.x; i < fo; i += THREADS) sb[2 * h + i] = __bfloat162float(b3[i]);
  }
}

// Copy i of a tile's rows (16 bytes each): edge e, columns c..c+7. Lane pairs take a row's 32-byte
// sector, 16 consecutive pairs 16 edges: a warp's shared-memory accesses fill whole core
// matrices (no bank conflict) and its global reads whole sectors.
__device__ __forceinline__ void chunk_of(int i, int& e, int& c) {
  const int p = i >> 1;
  e = p % TE;
  c = (2 * (p / TE) + (i & 1)) * 8;
}

// Tile `tile`'s ids (unmasked edges ids[tile TE ...], count of them) and endpoints into slot s
// (threads < TE, plain loads: the prologue only)
template <bool SAVED>
__device__ __forceinline__ void load_slot(const Slots& S, int s, int tile, int n_tiles, int count,
                                          const int* ids, const int* src, const int* dst) {
  if (threadIdx.x >= TE) return;
  const long e = (long)tile * TE + threadIdx.x;
  int id = -1, d = 0, sr = 0;
  if (tile < n_tiles && e < count) {
    id = __ldg(ids + e);
    d = __ldg(dst + id);
    if (!SAVED) sr = __ldg(src + id);
  }
  S.id(s)[threadIdx.x] = id;
  S.dst(s)[threadIdx.x] = d;
  S.src(s)[threadIdx.x] = sr;
}

// Issue the m = [x_dst, x_src, ea] rows of the tile in slot s into bm [TE][k] (cm; cp.async, 16
// bytes a copy, zeros for empty slots). SAVED: the endpoint rows come from gd / gs.
template <bool SAVED>
__device__ __forceinline__ void issue_m(bf16* bm, const Slots& S, int s, int k, int fx, int fe,
                                        const bf16* x, const bf16* gd, const bf16* gs,
                                        const bf16* ea) {
  const int kv = k / 8;
  const int* sid = S.id(s);
  const int* sd = S.dst(s);
  const int* ss = S.src(s);
  for (int i = threadIdx.x; i < TE * kv; i += THREADS) {
    int e, c;
    chunk_of(i, e, c);
    const int id = sid[e];
    const bf16* p = ea;
    int bytes = 0;
    if (id >= 0) {
      bytes = 16;
      if (c < fx) {
        p = SAVED ? gd + (long)id * fx + c : x + (long)sd[e] * fx + c;
      } else if (c < 2 * fx) {
        p = SAVED ? gs + (long)id * fx + (c - fx) : x + (long)ss[e] * fx + (c - fx);
      } else {
        p = ea + (long)id * fe + (c - 2 * fx);
      }
    }
    cp_async16(bm + cm(e, c, k), p, bytes);
  }
}

// After the copies landed: the ReLU on this thread's own ea copies in bm (issue_m's mapping)
__device__ __forceinline__ void relu_own(bf16* bm, int k, int fx) {
  const int kv = k / 8;
  for (int i = threadIdx.x; i < TE * kv; i += THREADS) {
    int e, c;
    chunk_of(i, e, c);
    if (c >= 2 * fx) {
      uint4* q = reinterpret_cast<uint4*>(bm + cm(e, c, k));
      *q = relu8(*q);
    }
  }
}

// Issue the g_e'_out rows and the g_agg[dst] rows of the tile in slot s into ra and rb ([TE][fo],
// cm; cp.async, zeros for empty slots)
__device__ __forceinline__ void issue_g(bf16* ra, bf16* rb, const Slots& S, int s, int fo,
                                        const bf16* g_eout, const bf16* g_agg) {
  const int fov = fo / 8;
  const int* sid = S.id(s);
  const int* sd = S.dst(s);
  for (int i = threadIdx.x; i < TE * fov; i += THREADS) {
    int e, c;
    chunk_of(i, e, c);
    const int id = sid[e];
    const int bytes = id >= 0 ? 16 : 0;
    cp_async16(ra + cm(e, c, fo), id >= 0 ? g_eout + (long)id * fo + c : g_eout, bytes);
    cp_async16(rb + cm(e, c, fo), id >= 0 ? g_agg + (long)sd[e] * fo + c : g_agg, bytes);
  }
}

// After the copies landed: g_e' = bf16(g_e'_out + g_agg[dst]) of this thread's own copies
// (issue_g's mapping) into bget [TE][fo]; empty slots give zero rows
__device__ __forceinline__ void combine_own(bf16* bget, const bf16* ra, const bf16* rb, int fo) {
  const int fov = fo / 8;
  for (int i = threadIdx.x; i < TE * fov; i += THREADS) {
    int e, c;
    chunk_of(i, e, c);
    const uint4 a = *reinterpret_cast<const uint4*>(ra + cm(e, c, fo));
    const uint4 b = *reinterpret_cast<const uint4*>(rb + cm(e, c, fo));
    uint4 out;
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 fa = __bfloat1622float2(a2[q]);
      const float2 fb = __bfloat1622float2(b2[q]);
      o2[q] = __floats2bfloat162_rn(fa.x + fb.x, fa.y + fb.y);
    }
    *reinterpret_cast<uint4*>(bget + cm(e, c, fo)) = out;
  }
}

// ------------------------------------------------------------------------------- forward (A, C)
// C: the endpoint rows of the tile in slot s (m's first 2 fx columns, landed in bm) out to
// save_d / save_s, 16 bytes a copy, lane pairs on a row's 32-byte sector
__device__ __forceinline__ void save_rows(const bf16* bm, const int* sid, int k, int fx,
                                          bf16* save_d, bf16* save_s) {
  for (int i = threadIdx.x; i < TE * (2 * fx / 8); i += THREADS) {
    int e, c;
    chunk_of(i, e, c);
    const long id = sid[e];
    if (id < 0) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(bm + cm(e, c, k));
    *reinterpret_cast<uint4*>(c < fx ? save_d + id * fx + c : save_s + id * fx + (c - fx)) = v;
  }
}

// The forward, persistent: blocks take tiles of TE unmasked edges in turn (ids[:count], as in
// the backward), and the masked edges get zero e' rows (and, SAVE, their endpoint rows) without
// any MLP work. Per tile, on wgmma (a warpgroup a column slice):
//   h1 = bf16(relu(m W1^T + b1)),  h2 = bf16(relu(h1 W2^T + b2)),  e' = bf16(h2 W3^T + b3)
// staged in h1's buffer and written out as whole rows. The next tile's m rows are issued
// (cp.async) into the second m buffer before this tile's products (BUFFERS = 1: into the one m
// buffer once product 1 has read it); the edge ids and endpoints come two tiles ahead. SAVE (C)
// also writes the gathered rows x[dst], x[src] of every edge: the unmasked ones from the landed
// m tile, the masked ones as row copies.
template <bool SAVE, int BUFFERS>
__global__ void __launch_bounds__(THREADS, 1)
fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ ea, const int* __restrict__ src,
           const int* __restrict__ dst, const int* __restrict__ ids,
           const int* __restrict__ count_ptr, const bf16* __restrict__ w1,
           const bf16* __restrict__ b1, const bf16* __restrict__ w2, const bf16* __restrict__ b2,
           const bf16* __restrict__ w3, const bf16* __restrict__ b3, bf16* __restrict__ e_out,
           bf16* __restrict__ save_d, bf16* __restrict__ save_s, int n_edges, int fx, int fe, int h,
           int fo, int relu_edge) {
  extern __shared__ uint4 smem4[];
  const int k = 2 * fx + fe;
  const int count = *count_ptr;
  const int n_tiles = (count + TE - 1) / TE;
  const int G = gridDim.x;
  bf16* sw1 = reinterpret_cast<bf16*>(smem4);
  bf16* sw2 = sw1 + h * k;
  bf16* sw3 = sw2 + h * h;
  bf16* bms[2];
  bms[0] = sw3 + fo * h;
  bms[1] = bms[0] + (BUFFERS - 1) * TE * k;
  bf16* bh1 = bms[1] + TE * k;             // h1, then the tile's e' rows
  bf16* bh2 = bh1 + TE * (h > fo ? h : fo);  // h2
  float* sb = reinterpret_cast<float*>(bh2 + TE * h);
  const float* sb1 = sb;
  const float* sb2 = sb + h;
  const float* sb3 = sb + 2 * h;
  const Slots S{reinterpret_cast<int*>(sb + 2 * h + fo)};

  // prologue: the first two tiles' slots, the first tile's copies under the weights' staging
  const int t_first = blockIdx.x;
  load_slot<false>(S, 0, t_first, n_tiles, count, ids, src, dst);
  load_slot<false>(S, 1, t_first + G, n_tiles, count, ids, src, dst);
  __syncthreads();
  if (t_first < n_tiles) {
    issue_m<false>(bms[0], S, 0, k, fx, fe, x, nullptr, nullptr, ea);
    cp_async_commit();
  }
  stage_weights_cm(k, h, fo, sw1, sw2, sw3, sb, w1, b1, w2, b2, w3, b3);
  // masked edges (ids[count:]), 32 a warp: their ids (and, SAVE, endpoints) in one load a lane,
  // then the warp's lanes take consecutive 16-byte pieces of the edges' rows: the zero e' row and
  // (SAVE) the copies of x[dst], x[src]
  {
    const int lane = threadIdx.x & 31;
    const int fov = fo / 8;
    const int per = fov + (SAVE ? fx / 4 : 0);  // pieces an edge
    const long n_masked = n_edges - count;
    for (long base = ((long)blockIdx.x * WARPS + (threadIdx.x >> 5)) * 32; base < n_masked;
         base += (long)G * WARPS * 32) {
      int id = 0, nd = 0, ns = 0;
      if (base + lane < n_masked) {
        id = __ldg(ids + count + base + lane);
        if (SAVE) {
          nd = __ldg(dst + id);
          ns = __ldg(src + id);
        }
      }
      const int pieces = (int)min(32L, n_masked - base) * per;
#pragma unroll 4
      for (int t0 = 0; t0 < pieces; t0 += 32) {
        const int t = t0 + lane;
        const int j = t < pieces ? t / per : 0;
        const long edge = __shfl_sync(0xffffffffu, id, j);
        const int q = t - j * per;
        if (SAVE) {
          const int c = 8 * (q - fov);
          const bool to_dst = c < fx;
          const int node_d = __shfl_sync(0xffffffffu, nd, j);
          const int node_s = __shfl_sync(0xffffffffu, ns, j);
          const long node = to_dst ? node_d : node_s;
          if (t < pieces && q >= fov) {
            const int col = to_dst ? c : c - fx;
            *reinterpret_cast<uint4*>((to_dst ? save_d : save_s) + edge * fx + col) =
                ld16(x + node * fx + col);
          }
        }
        if (t < pieces && q < fov) {
          *reinterpret_cast<uint4*>(e_out + edge * fo + 8 * q) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
  }
  if (t_first >= n_tiles) return;

  int j = 0;
  for (int tile = t_first; tile < n_tiles; tile += G, ++j) {
    const int cur = j % 3, nxt = (j + 1) % 3, after = (j + 2) % 3;
    bf16* bm = bms[j & 1];
    const bool has_next = tile + G < n_tiles;
    cp_async_wait_all();
    if (relu_edge) relu_own(bm, k, fx);
    fence_async_smem();
    __syncthreads();  // the tile's m (and, first, the weights) in place; the last e' rows out
    if (BUFFERS == 2 && has_next) {
      issue_m<false>(bms[(j + 1) & 1], S, nxt, k, fx, fe, x, nullptr, nullptr, ea);
      cp_async_commit();
    }
    // the slots of tile + 2G: the id now, the endpoints after the next barrier
    const long e2 = (long)(tile + 2 * G) * TE + threadIdx.x;
    const bool live2 = threadIdx.x < TE && e2 < count;
    const int id2 = live2 ? __ldg(ids + e2) : -1;
    const int* sid = S.id(cur);
    if (SAVE) save_rows(bm, sid, k, fx, save_d, save_s);
    product<0>(bm, k, sw1, h, [&](int r, int c, float v0, float v1) {
      store2(bh1 + cm(r, c, h), fmaxf(v0 + sb1[c], 0.f), fmaxf(v1 + sb1[c + 1], 0.f));
    });
    fence_async_smem();
    __syncthreads();  // h1 in place, m read
    if (BUFFERS == 1 && has_next) {
      issue_m<false>(bm, S, nxt, k, fx, fe, x, nullptr, nullptr, ea);
      cp_async_commit();
    }
    const int d2 = live2 ? __ldg(dst + id2) : 0;
    const int s2 = live2 ? __ldg(src + id2) : 0;
    product<0>(bh1, h, sw2, h, [&](int r, int c, float v0, float v1) {
      store2(bh2 + cm(r, c, h), fmaxf(v0 + sb2[c], 0.f), fmaxf(v1 + sb2[c + 1], 0.f));
    });
    fence_async_smem();
    __syncthreads();  // h2 in place, h1 read
    if (threadIdx.x < TE) {
      S.id(after)[threadIdx.x] = id2;
      S.dst(after)[threadIdx.x] = d2;
      S.src(after)[threadIdx.x] = s2;
    }
    product<0>(bh2, h, sw3, fo, [&](int r, int c, float v0, float v1) {
      store2(bh1 + cm(r, c, fo), v0 + sb3[c], v1 + sb3[c + 1]);
    });
    __syncthreads();  // e' in place
    for (int i = threadIdx.x; i < TE * (fo / 8); i += THREADS) {
      int e, c;
      chunk_of(i, e, c);
      const long id = sid[e];
      if (id >= 0) {
        *reinterpret_cast<uint4*>(e_out + id * fo + c) =
            *reinterpret_cast<const uint4*>(bh1 + cm(e, c, fo));
      }
    }
  }
}

// ------------------------------------------------------------------------------ backward (B, D)
// The backward, persistent: blocks take tiles of TE unmasked edges in turn (ids[:count], the
// wrapper's stable partition of the edge ids, unmasked first; count on the device), and the
// masked edges get zero rows of g_xd, g_xs and g_ea without any MLP work. Per tile: the recompute
// of h1 and h2 (the forward's values), then three phases, each an input-gradient product and a
// weight-gradient product over the same tiles:
//   1. g_h2 = bf16((g_e' W3) * [h2 > 0]);  dW3, db3 (+)= g_e'^T [h2, 1]
//   2. g_h1 = bf16((g_h2 W2) * [h1 > 0]) over h2;  dW2, db2 (+)= g_h2^T [h1, 1]
//   3. g_m = bf16(g_h1 W1) -> g_xd, g_xs, g_ea;  dW1, db1 (+)= g_h1^T [m, 1]
// The recompute and input-gradient products run on wgmma (a warpgroup a column slice), the
// weight gradients on mma.sync (a warp a 16 x 32 chunk). The next tile's m rows are issued
// (cp.async) into the second m buffer before this tile's products (with BUFFERS = 1, into the
// one m buffer after this tile's dW1), its g_e'_out and g_agg[dst]
// rows into the h1 / g_h2 buffers at phase 3 (which reads neither); each thread adds (and ReLUs)
// its own copies after cp.async.wait_group at the next tile's start. The edge ids and endpoints
// come two tiles ahead, so no copy waits on an index load. dW3 and dW2 (and their biases) stay
// in registers for the whole launch (REG_SLOTS chunks a warp) and are stored once at the end;
// dW1's chunks are added into the block's partial every tile by their one owner thread
// (flush_chunk). SAVED (D) reads the endpoint rows from gd = x[dst], gs = x[src]: the same
// values, so D's outputs are bitwise B's.
template <bool SAVED, int BUFFERS>
__global__ void __launch_bounds__(THREADS, 1)
bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gd, const bf16* __restrict__ gs,
           const bf16* __restrict__ ea, const int* __restrict__ src, const int* __restrict__ dst,
           const int* __restrict__ ids, const int* __restrict__ count_ptr,
           const bf16* __restrict__ w1, const bf16* __restrict__ b1, const bf16* __restrict__ w2,
           const bf16* __restrict__ b2, const bf16* __restrict__ w3,
           const bf16* __restrict__ g_eout, const bf16* __restrict__ g_agg,
           bf16* __restrict__ g_xd, bf16* __restrict__ g_xs, bf16* __restrict__ g_ea,
           float* __restrict__ partial, int n_edges, int fx, int fe, int h, int fo,
           int relu_edge) {
  extern __shared__ uint4 smem4[];
  const int k = 2 * fx + fe;
  const BwdLayout L(k, h, fo, BUFFERS);
  const int count = *count_ptr;
  const int n_tiles = (count + TE - 1) / TE;
  const int G = gridDim.x;
  bf16* sw1 = reinterpret_cast<bf16*>(smem4);
  bf16* sw2 = sw1 + h * k;
  bf16* sw3 = sw2 + h * h;
  bf16* bms[2];
  bms[0] = sw3 + fo * h;
  bms[1] = bms[0] + (BUFFERS - 1) * TE * k;
  bf16* bh1 = bms[1] + TE * k;     // h1; on arrival the next tile's g_e'_out rows
  bf16* bh2 = bh1 + TE * L.act();  // h2, then g_h1
  bf16* bgh2 = bh2 + TE * h;       // g_h2; on arrival the next tile's g_agg[dst] rows
  bf16* bget = bgh2 + TE * L.act();  // g_e'
  float* sb = reinterpret_cast<float*>(bget + TE * fo);
  const float* sb1 = sb;
  const float* sb2 = sb + h;
  const Slots S{reinterpret_cast<int*>(sb + 2 * h)};

  // prologue: the first two tiles' slots, the first tile's copies under the weights' staging
  const int t_first = blockIdx.x;
  load_slot<SAVED>(S, 0, t_first, n_tiles, count, ids, src, dst);
  load_slot<SAVED>(S, 1, t_first + G, n_tiles, count, ids, src, dst);
  __syncthreads();
  if (t_first < n_tiles) {
    issue_m<SAVED>(bms[0], S, 0, k, fx, fe, x, gd, gs, ea);
    issue_g(bh1, bgh2, S, 0, fo, g_eout, g_agg);
    cp_async_commit();
  }
  stage_weights_cm(k, h, fo, sw1, sw2, sw3, sb, w1, b1, w2, b2, w3, nullptr);
  // masked edges (ids[count:]): zero rows, a thread a row (a warp's id loads are one
  // coalesced load, and no thread waits on more than a few of them)
  {
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    for (long r = (long)blockIdx.x * THREADS + threadIdx.x; r < n_edges - count;
         r += (long)G * THREADS) {
      const long edge = __ldg(ids + count + r);
      for (int c = 0; c < fx; c += 8) {
        *reinterpret_cast<uint4*>(g_xd + edge * fx + c) = z;
        *reinterpret_cast<uint4*>(g_xs + edge * fx + c) = z;
      }
      for (int c = 0; c < fe; c += 8) *reinterpret_cast<uint4*>(g_ea + edge * fe + c) = z;
    }
  }
  if (t_first >= n_tiles) return;  // no tile: the partial stays untouched

  const long p_len = (long)h * k + h + (long)h * h + h + (long)fo * h + fo;
  float* pw1 = partial + (long)blockIdx.x * p_len;
  float* pb1 = pw1 + (long)h * k;
  float* pw2 = pb1 + h;
  float* pb2 = pw2 + (long)h * h;
  float* pw3 = pb2 + h;
  float* pb3 = pw3 + (long)fo * h;

  const int warp = threadIdx.x >> 5;
  const int mt3 = fo / 16, mt2 = h / 16;
  const int n3 = mt3 * (h / 32), n23 = n3 + mt2 * (h / 32), n1 = mt2 * (k / 32);
  float acc[REG_SLOTS][4][4];
  float bacc[REG_SLOTS][2];
#pragma unroll
  for (int s = 0; s < REG_SLOTS; ++s) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[s][j][q] = 0.f;
    }
    bacc[s][0] = bacc[s][1] = 0.f;
  }

  int j = 0;
  for (int tile = t_first; tile < n_tiles; tile += G, ++j) {
    const bool first = j == 0;
    const int cur = j % 3, nxt = (j + 1) % 3, after = (j + 2) % 3;
    bf16* bm = bms[j & 1];
    const bool has_next = tile + G < n_tiles;
    cp_async_wait_all();
    combine_own(bget, bh1, bgh2, fo);
    if (relu_edge) relu_own(bm, k, fx);
    fence_async_smem();
    __syncthreads();  // the tile's m and g_e' (and, first, the weights) are in place
    if (BUFFERS == 2 && has_next) {
      issue_m<SAVED>(bms[(j + 1) & 1], S, nxt, k, fx, fe, x, gd, gs, ea);
      cp_async_commit();
    }
    // the slots of tile + 2G: the id now, the endpoints after the next barrier
    const long e2 = (long)(tile + 2 * G) * TE + threadIdx.x;
    const bool live2 = threadIdx.x < TE && e2 < count;
    const int id2 = live2 ? __ldg(ids + e2) : -1;
    // recompute h1 and h2
    product<0>(bm, k, sw1, h, [&](int r, int c, float v0, float v1) {
      store2(bh1 + cm(r, c, h), fmaxf(v0 + sb1[c], 0.f), fmaxf(v1 + sb1[c + 1], 0.f));
    });
    fence_async_smem();
    __syncthreads();
    const int d2 = live2 ? __ldg(dst + id2) : 0;
    const int s2 = live2 && !SAVED ? __ldg(src + id2) : 0;
    product<0>(bh1, h, sw2, h, [&](int r, int c, float v0, float v1) {
      store2(bh2 + cm(r, c, h), fmaxf(v0 + sb2[c], 0.f), fmaxf(v1 + sb2[c + 1], 0.f));
    });
    __syncthreads();
    // 1. g_h2 = bf16((g_e' W3) * [h2 > 0]); dW3, db3 (+)= g_e'^T [h2, 1]
    product<1>(bget, fo, sw3, h, [&](int r, int c, float v0, float v1) {
      const bf16* a = bh2 + cm(r, c, h);
      store2(bgh2 + cm(r, c, h), positive(a) ? v0 : 0.f, positive(a + 1) ? v1 : 0.f);
    });
#pragma unroll
    for (int s = 0; s < REG_SLOTS; ++s) {
      const int c = warp + WARPS * s;
      if (c < n3) {
        const int m0 = (c % mt3) * 16, n0 = (c / mt3) * 32;
        wgrad_chunk(acc[s], bacc[s], n0 == 0, bget, fo, m0, bh2, h, n0);
      }
    }
    for (int c = warp + WARPS * REG_SLOTS; c < n3; c += WARPS) {
      wgrad_chunk_flush(c, bget, fo, bh2, h, pw3, pb3, first);
    }
    fence_async_smem();
    __syncthreads();
    // 2. g_h1 = bf16((g_h2 W2) * [h1 > 0]) over h2; dW2, db2 (+)= g_h2^T [h1, 1]
    product<1>(bgh2, h, sw2, h, [&](int r, int c, float v0, float v1) {
      const bf16* a = bh1 + cm(r, c, h);
      store2(bh2 + cm(r, c, h), positive(a) ? v0 : 0.f, positive(a + 1) ? v1 : 0.f);
    });
#pragma unroll
    for (int s = 0; s < REG_SLOTS; ++s) {
      const int c = warp + WARPS * s;
      if (c >= n3 && c < n23) {
        const int c2 = c - n3;
        const int m0 = (c2 % mt2) * 16, n0 = (c2 / mt2) * 32;
        wgrad_chunk(acc[s], bacc[s], n0 == 0, bgh2, h, m0, bh1, h, n0);
      }
    }
    for (int c = warp + WARPS * REG_SLOTS; c < n23; c += WARPS) {
      if (c >= n3) wgrad_chunk_flush(c - n3, bgh2, h, bh1, h, pw2, pb2, first);
    }
    fence_async_smem();
    __syncthreads();  // h1, g_h2 and g_e' are free
    // the next tile's g_e'_out and g_agg[dst] rows into the h1 and g_h2 buffers; tile + 2G's slots
    if (has_next) {
      issue_g(bh1, bgh2, S, nxt, fo, g_eout, g_agg);
      cp_async_commit();
    }
    if (threadIdx.x < TE) {
      S.id(after)[threadIdx.x] = id2;
      S.dst(after)[threadIdx.x] = d2;
      S.src(after)[threadIdx.x] = s2;
    }
    // 3. g_m = bf16(g_h1 W1), split into the dst, src and edge blocks; dW1, db1 (+)= g_h1^T [m, 1]
    const int* sid = S.id(cur);
    product<1>(bh2, h, sw1, k, [&](int r, int c, float v0, float v1) {
      const long edge = sid[r];
      if (edge < 0) return;
      if (c < fx) {
        store2(g_xd + edge * fx + c, v0, v1);
      } else if (c < 2 * fx) {
        store2(g_xs + edge * fx + (c - fx), v0, v1);
      } else {
        // m holds relu(ea) with relu_edge: relu(ea) > 0 exactly where ea > 0
        const bf16* a = bm + cm(r, c, k);
        if (relu_edge) {
          v0 = positive(a) ? v0 : 0.f;
          v1 = positive(a + 1) ? v1 : 0.f;
        }
        store2(g_ea + edge * fe + (c - 2 * fx), v0, v1);
      }
    });
    for (int c = warp; c < n1; c += WARPS) {
      wgrad_chunk_flush(c, bh2, h, bm, k, pw1, pb1, first);
    }
    if (BUFFERS == 1 && has_next) {
      __syncthreads();  // m is read
      issue_m<SAVED>(bm, S, nxt, k, fx, fe, x, gd, gs, ea);
      cp_async_commit();
    }
  }
  // the register-resident chunks of dW3 and dW2, stored once
#pragma unroll
  for (int s = 0; s < REG_SLOTS; ++s) {
    const int c = warp + WARPS * s;
    if (c < n3) {
      const int m0 = (c % mt3) * 16, n0 = (c / mt3) * 32;
      flush_chunk(acc[s], bacc[s], n0 == 0, m0, n0, pw3, h, pb3, true);
    } else if (c < n23) {
      const int c2 = c - n3;
      const int m0 = (c2 % mt2) * 16, n0 = (c2 / mt2) * 32;
      flush_chunk(acc[s], bacc[s], n0 == 0, m0, n0, pw2, h, pb2, true);
    }
  }
}

// The largest dynamic shared memory a block of the current device can opt into
int smem_optin() {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return optin;
}

// The backward's layout at these widths on the current device: two m buffers where they fit
BwdLayout bwd_layout(int k, int h, int fo) {
  const BwdLayout two(k, h, fo, 2);
  return two.bytes() <= smem_optin() ? two : BwdLayout(k, h, fo, 1);
}

// The forward's layout at these widths on the current device, chosen as the backward's
FwdLayout fwd_layout(int k, int h, int fo) {
  const FwdLayout two(k, h, fo, 2);
  return two.bytes() <= smem_optin() ? two : FwdLayout(k, h, fo, 1);
}

// Set the kernel's shared-memory size and find its persistent grid: min(tiles, SMs x blocks per
// SM), or 0 for no edges. Errors are returned and cleared, so that they do not resurface in a
// later call's cudaGetLastError().
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int threads, size_t smem, int n_edges, int max_blocks,
                    int* grid) {
  *grid = 0;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  int limit = sms * per_sm;
  if (max_blocks > 0 && max_blocks < limit) limit = max_blocks;
  const int tiles = (n_edges + TE - 1) / TE;
  *grid = tiles < limit ? tiles : limit;
  return cudaSuccess;
}

template <bool SAVE>
int launch_fwd(const bf16* x, const bf16* ea, const int* edge_index, const int* ids,
               const int* count, const bf16* w1, const bf16* b1, const bf16* w2, const bf16* b2,
               const bf16* w3, const bf16* b3, bf16* e_out, bf16* save_d, bf16* save_s,
               int n_edges, int fx, int fe, int h, int fo, int relu_edge, void* stream_ptr) {
  const FwdLayout L = fwd_layout(2 * fx + fe, h, fo);
  const size_t smem = L.bytes();
  auto kernel = L.buffers == 2 ? fwd_kernel<SAVE, 2> : fwd_kernel<SAVE, 1>;
  int grid = 0;
  cudaError_t err = prepare(kernel, THREADS, smem, n_edges, 0, &grid);
  if (err != cudaSuccess) return err;
  if (grid > 0) {
    kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream_ptr)>>>(
        x, ea, edge_index, edge_index + n_edges, ids, count, w1, b1, w2, b2, w3, b3, e_out, save_d,
        save_s, n_edges, fx, fe, h, fo, relu_edge);
  }
  return cudaGetLastError();
}

template <bool SAVED>
int launch_bwd(const bf16* x, const bf16* gd, const bf16* gs, const bf16* ea,
               const int* edge_index, const int* ids, const int* count, const bf16* w1,
               const bf16* b1, const bf16* w2, const bf16* b2, const bf16* w3,
               const bf16* g_eout, const bf16* g_agg, bf16* g_xd, bf16* g_xs, bf16* g_ea,
               float* partial, bf16* grads, int n_edges, int fx, int fe, int h, int fo,
               int relu_edge, int max_blocks, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int k = 2 * fx + fe;
  const BwdLayout L = bwd_layout(k, h, fo);
  const size_t smem = L.bytes();
  if (max_blocks < 1) return cudaErrorInvalidValue;
  auto kernel = L.buffers == 2 ? bwd_kernel<SAVED, 2> : bwd_kernel<SAVED, 1>;
  int grid = 0;
  cudaError_t err = prepare(kernel, THREADS, smem, n_edges, max_blocks, &grid);
  if (err != cudaSuccess) return err;
  if (grid > 0) {
    kernel<<<grid, THREADS, smem, stream>>>(
        x, gd, gs, ea, edge_index, edge_index + n_edges, ids, count, w1, b1, w2, b2, w3, g_eout,
        g_agg, g_xd, g_xs, g_ea, partial, n_edges, fx, fe, h, fo, relu_edge);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long p = (long)h * k + h + (long)h * h + h + (long)fo * h + fo;
  fixed_order_sum::sum_partials_kernel<<<(unsigned)((p + 255) / 256), 256, 0, stream>>>(
      partial, grid, TE, count, p, grads);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// The shared memory a block of A or C (B or D) takes at these widths (one m buffer where two do not
// fit), and the most that a block of the current device can take: the wrapper refuses widths
// where the first exceeds the second.
int fused_relational_bf16_fwd_smem(int fx, int fe, int h, int fo) {
  return (int)fwd_layout(2 * fx + fe, h, fo).bytes();
}
int fused_relational_bf16_bwd_smem(int fx, int fe, int h, int fo) {
  return (int)bwd_layout(2 * fx + fe, h, fo).bytes();
}
int fused_relational_bf16_smem_optin() { return smem_optin(); }

// A. edge_index [2, E] int32 (row 0 source, row 1 target, targets sorted); ids [E] int32, the
// edge ids partitioned stably with the unmasked first, and count [1] int32, their number (both in
// device memory: the kernel tiles ids[:count] and writes zero rows for the rest); x [N, Fx],
// ea [E, Fe], weights [out][in] and biases, all bf16 with 16-byte aligned rows. Writes e_out
// [E, Fo] bf16. Fx, Fe, H and Fo are multiples of 32. Returns cudaGetLastError(), or the error of
// widths whose weights and tiles exceed one block's shared memory (which the wrapper refuses
// first).
int fused_relational_bf16_fwd(const bf16* x, const bf16* ea, const int* edge_index,
                              const int* ids, const int* count, const bf16* w1, const bf16* b1,
                              const bf16* w2, const bf16* b2, const bf16* w3, const bf16* b3,
                              bf16* e_out, int n_edges, int fx, int fe, int h, int fo,
                              int relu_edge, void* stream_ptr) {
  return launch_fwd<false>(x, ea, edge_index, ids, count, w1, b1, w2, b2, w3, b3, e_out, nullptr,
                           nullptr, n_edges, fx, fe, h, fo, relu_edge, stream_ptr);
}

// C. As A, and writes the gathered endpoint rows of every edge: save_d [E, Fx] = x[dst],
// save_s = x[src].
int fused_relational_bf16_fwd_save(const bf16* x, const bf16* ea, const int* edge_index,
                                   const int* ids, const int* count, const bf16* w1,
                                   const bf16* b1, const bf16* w2, const bf16* b2, const bf16* w3,
                                   const bf16* b3, bf16* e_out, bf16* save_d, bf16* save_s,
                                   int n_edges, int fx, int fe, int h, int fo, int relu_edge,
                                   void* stream_ptr) {
  return launch_fwd<true>(x, ea, edge_index, ids, count, w1, b1, w2, b2, w3, b3, e_out, save_d,
                          save_s, n_edges, fx, fe, h, fo, relu_edge, stream_ptr);
}

// B. g_eout [E, Fo] and g_agg [N, Fo] bf16 (read by target in the kernel); ids [E] int32, the
// edge ids partitioned stably with the unmasked first, and count [1] int32, their number (both
// in device memory: the kernel tiles ids[:count] and writes zero rows for the rest). Writes g_xd,
// g_xs [E, Fx] (per-edge gradients of x[dst] and x[src]), g_ea [E, Fe] and grads [P] packed as
// w1, b1, w2, b2, w3, b3 ([out][in]), all bf16; partial is [max_blocks, P] f32 scratch, and the
// persistent grid is at most max_blocks blocks.
int fused_relational_bf16_bwd(const bf16* x, const bf16* ea, const int* edge_index,
                              const int* ids, const int* count, const bf16* w1, const bf16* b1,
                              const bf16* w2, const bf16* b2, const bf16* w3, const bf16* g_eout,
                              const bf16* g_agg, bf16* g_xd, bf16* g_xs, bf16* g_ea,
                              float* partial, bf16* grads, int n_edges, int fx, int fe, int h,
                              int fo, int relu_edge, int max_blocks, void* stream_ptr) {
  return launch_bwd<false>(x, nullptr, nullptr, ea, edge_index, ids, count, w1, b1, w2, b2, w3,
                           g_eout, g_agg, g_xd, g_xs, g_ea, partial, grads, n_edges, fx, fe, h, fo,
                           relu_edge, max_blocks, stream_ptr);
}

// D. As B, with the endpoint rows read from C's saved gd = x[dst], gs = x[src] ([E, Fx]).
int fused_relational_bf16_bwd_saved(const bf16* gd, const bf16* gs, const bf16* ea,
                                    const int* edge_index, const int* ids, const int* count,
                                    const bf16* w1, const bf16* b1, const bf16* w2, const bf16* b2,
                                    const bf16* w3, const bf16* g_eout, const bf16* g_agg,
                                    bf16* g_xd, bf16* g_xs, bf16* g_ea, float* partial,
                                    bf16* grads, int n_edges, int fx, int fe, int h, int fo,
                                    int relu_edge, int max_blocks, void* stream_ptr) {
  return launch_bwd<true>(nullptr, gd, gs, ea, edge_index, ids, count, w1, b1, w2, b2, w3, g_eout,
                          g_agg, g_xd, g_xs, g_ea, partial, grads, n_edges, fx, fe, h, fo,
                          relu_edge, max_blocks, stream_ptr);
}

}  // extern "C"
