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
// Design (simple and right first; no wgmma or TMA yet):
//  * persistent blocks of 8 warps, one per SM (the weights and tiles take 145 KB forward, 187 KB
//    backward of shared memory). Each block stages W1, W2, W3 once, in PyTorch's [out][in]
//    layout, rows padded by 8 bf16 (16 bytes) so that ldmatrix reads hit 8 different bank groups;
//  * a tile is TE = 64 edges. Its gathered input and activations live in shared memory only,
//    rounded to bf16 exactly where the JAX kernels round them;
//  * every product is mma.sync.m16n8k16 bf16 -> f32. A warp computes 16 x 32 output chunks;
//    operands come through ldmatrix: W's rows as B for the forward products (m W^T), W through
//    ldmatrix.trans for the backward's g W, and activations through ldmatrix.trans as both
//    operands of the weight gradients (g^T a);
//  * weight gradients: each tile's product starts from 0 in registers and is added into the
//    block's own slice of a [blocks, P] f32 partial in device memory (L2-resident); each entry
//    belongs to one thread for the whole launch, so there are no atomics. A second kernel sums
//    the partials over blocks in block order and rounds to bf16. Two launches give the same bits,
//    and C/D give the bits of A/B: the saved rows are the values the gather reads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TE = 64;       // edges per tile
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int PAD = 8;       // bf16 padding of every shared-memory row

__host__ __device__ inline int ld(int width) { return width + PAD; }

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(saddr(p))
               : "memory");
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

// One warp: acc[j] (+)= A[m0:m0+16, :kdim] B[:kdim, n0+8j : n0+8j+8] for j < 4.
// A_T: A is stored transposed, as [k][m] (else [m][k]); B_T: B is stored as [k][n] (else as
// [n][k], the [out][in] layout of a weight). lda / ldb are the stored rows' strides.
template <bool A_T, bool B_T>
__device__ __forceinline__ void warp_gemm(float (&acc)[4][4], const bf16* A, int lda, int m0,
                                          const bf16* B, int ldb, int n0, int kdim) {
  const int lane = threadIdx.x & 31;
  for (int k0 = 0; k0 < kdim; k0 += 16) {
    uint32_t a[4];
    if (A_T) {
      ldsm4t(a, A + (k0 + (lane & 7) + ((lane >> 4) << 3)) * lda + m0 + (((lane >> 3) & 1) << 3));
    } else {
      ldsm4(a, A + (m0 + (lane & 15)) * lda + k0 + ((lane >> 4) << 3));
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int nb = n0 + 16 * half;
      uint32_t b[4];
      if (B_T) {
        ldsm4t(b, B + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ldb + nb + ((lane >> 4) << 3));
      } else {
        ldsm4(b, B + (nb + (lane & 7) + ((lane >> 4) << 3)) * ldb + k0 + (((lane >> 3) & 1) << 3));
      }
      mma16816(acc[2 * half], a, b[0], b[1]);
      mma16816(acc[2 * half + 1], a, b[2], b[3]);
    }
  }
}

// out[TE, n] = A[TE, kdim] B (B as in warp_gemm); epi(row, col, v0, v1) receives the f32 values
// of (row, col) and (row, col + 1). n % 32 == 0, kdim % 16 == 0.
template <bool B_T, typename Epi>
__device__ __forceinline__ void tile_gemm(const bf16* A, int lda, int kdim, const bf16* B, int ldb,
                                          int n, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int chunks = (TE / 16) * (n / 32);
  for (int c = warp; c < chunks; c += WARPS) {
    const int m0 = (c % (TE / 16)) * 16;
    const int n0 = (c / (TE / 16)) * 32;
    float acc[4][4] = {};
    warp_gemm<false, B_T>(acc, A, lda, m0, B, ldb, n0, kdim);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      epi(m0 + g, n0 + 8 * j + 2 * t, acc[j][0], acc[j][1]);
      epi(m0 + g + 8, n0 + 8 * j + 2 * t, acc[j][2], acc[j][3]);
    }
  }
}

// Weight gradient of one tile: part_w[j][i] (+)= sum_e G[e][j] Act[e][i] for j < nout, i < kin,
// and part_b[j] (+)= sum_e G[e][j]; `first` starts the block's partial from this tile's sum. G is
// [TE][ldg], Act [TE][lda] in shared memory. The entries a thread touches depend on threadIdx only.
__device__ __forceinline__ void weight_grad(const bf16* G, int ldg, int nout, const bf16* Act,
                                            int lda, int kin, float* __restrict__ part_w,
                                            float* __restrict__ part_b, bool first) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mt = nout / 16;
  const int chunks = mt * (kin / 32);
  for (int c = warp; c < chunks; c += WARPS) {
    const int m0 = (c % mt) * 16;
    const int n0 = (c / mt) * 32;
    // the partial is read before the products, so its latency hides behind them
    float2 prev[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        prev[j][r] = first ? make_float2(0.f, 0.f)
                           : *reinterpret_cast<const float2*>(
                                 part_w + (long)(m0 + g + 8 * r) * kin + n0 + 8 * j + 2 * t);
      }
    }
    float acc[4][4] = {};
    warp_gemm<true, true>(acc, G, ldg, m0, Act, lda, n0, TE);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        *reinterpret_cast<float2*>(part_w + (long)(m0 + g + 8 * r) * kin + n0 + 8 * j + 2 * t) =
            make_float2(prev[j][r].x + acc[j][2 * r], prev[j][r].y + acc[j][2 * r + 1]);
      }
    }
  }
  for (int j = threadIdx.x; j < nout; j += THREADS) {
    float s = 0.f;
    for (int e = 0; e < TE; ++e) s += __bfloat162float(G[e * ldg + j]);
    part_b[j] = first ? s : part_b[j] + s;
  }
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

// Shared-memory layout shared by all four kernels: the weights, then the tile buffers.
struct Layout {
  int k, h, fo;
  __host__ __device__ Layout(int k_, int h_, int fo_) : k(k_), h(h_), fo(fo_) {}
  __host__ __device__ long weights_bytes() const {
    return 2L * (h * ld(k) + h * ld(h) + fo * ld(h)) + 4L * (2 * h + fo);
  }
  __host__ __device__ int wide() const { return ld(k > h ? k : h); }
  __host__ __device__ long fwd_bytes() const {
    return weights_bytes() + 2L * TE * (wide() + ld(h));
  }
  __host__ __device__ long bwd_bytes() const {
    return weights_bytes() + 2L * TE * (wide() + 3 * ld(h) + ld(fo));
  }
};

// Stage W1, W2, W3 ([out][in], padded rows) and the biases (as f32) into shared memory.
__device__ __forceinline__ void stage_weights(const Layout& L, unsigned char* smem,
                                              const bf16* w1, const bf16* b1, const bf16* w2,
                                              const bf16* b2, const bf16* w3, const bf16* b3,
                                              bf16*& sw1, bf16*& sw2, bf16*& sw3, float*& sb) {
  const int k = L.k, h = L.h, fo = L.fo;
  sw1 = reinterpret_cast<bf16*>(smem);
  sw2 = sw1 + h * ld(k);
  sw3 = sw2 + h * ld(h);
  sb = reinterpret_cast<float*>(sw3 + fo * ld(h));
  const struct { const bf16* src; bf16* dst; int rows, cols; } mats[3] = {
      {w1, sw1, h, k}, {w2, sw2, h, h}, {w3, sw3, fo, h}};
  for (const auto& m : mats) {
    const int vecs = m.cols / 8;
    for (int i = threadIdx.x; i < m.rows * vecs; i += THREADS) {
      const int r = i / vecs, c = (i % vecs) * 8;
      *reinterpret_cast<uint4*>(m.dst + r * ld(m.cols) + c) = ld16(m.src + (long)r * m.cols + c);
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

// The tile's m = [x_dst, x_src, ea] rows (zero past the last edge) into bm [TE][ld(k)].
// SAVED: the endpoint rows come from gd / gs ([E, Fx], the forward's saved gathers) instead of x.
// save_d / save_s (optional): where to write the gathered endpoint rows.
template <bool SAVED>
__device__ __forceinline__ void gather_tile(bf16* bm, int k, long t0, int n_edges, int fx, int fe,
                                            const bf16* x, const bf16* gd, const bf16* gs,
                                            const bf16* ea, const int* src, const int* dst,
                                            int relu_edge, bf16* save_d, bf16* save_s) {
  const int kv = k / 8;
  for (int i = threadIdx.x; i < TE * kv; i += THREADS) {
    const int e = i / kv, c = (i % kv) * 8;
    const long edge = t0 + e;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (edge < n_edges) {
      if (c < fx) {
        v = SAVED ? ld16(gd + edge * fx + c) : ld16(x + (long)dst[edge] * fx + c);
        if (save_d != nullptr) *reinterpret_cast<uint4*>(save_d + edge * fx + c) = v;
      } else if (c < 2 * fx) {
        v = SAVED ? ld16(gs + edge * fx + (c - fx)) : ld16(x + (long)src[edge] * fx + (c - fx));
        if (save_s != nullptr) *reinterpret_cast<uint4*>(save_s + edge * fx + (c - fx)) = v;
      } else {
        v = ld16(ea + edge * fe + (c - 2 * fx));
        if (relu_edge) v = relu8(v);
      }
    }
    *reinterpret_cast<uint4*>(bm + e * ld(k) + c) = v;
  }
}

// ------------------------------------------------------------------------------- forward (A, C)
template <bool SAVE>
__global__ void __launch_bounds__(THREADS, 1)
fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ ea, const int* __restrict__ src,
           const int* __restrict__ dst, const uint8_t* __restrict__ mask,
           const bf16* __restrict__ w1, const bf16* __restrict__ b1, const bf16* __restrict__ w2,
           const bf16* __restrict__ b2, const bf16* __restrict__ w3, const bf16* __restrict__ b3,
           bf16* __restrict__ e_out, bf16* __restrict__ save_d, bf16* __restrict__ save_s,
           int n_edges, int fx, int fe, int h, int fo, int relu_edge) {
  extern __shared__ uint4 smem4[];
  const int k = 2 * fx + fe;
  const Layout L(k, h, fo);
  bf16 *sw1, *sw2, *sw3;
  float* sb;
  stage_weights(L, reinterpret_cast<unsigned char*>(smem4), w1, b1, w2, b2, w3, b3, sw1, sw2, sw3,
                sb);
  bf16* bm = reinterpret_cast<bf16*>(sb + 2 * h + fo);  // [TE][ld(k)] m, then [TE][ld(h)] h2
  bf16* bh1 = bm + TE * L.wide();                       // [TE][ld(h)] h1
  const float* sb1 = sb;
  const float* sb2 = sb + h;
  const float* sb3 = sb + 2 * h;

  const int n_tiles = (n_edges + TE - 1) / TE;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long t0 = (long)tile * TE;
    __syncthreads();  // weights staged / the previous tile's buffers consumed
    gather_tile<false>(bm, k, t0, n_edges, fx, fe, x, nullptr, nullptr, ea, src, dst, relu_edge,
                       SAVE ? save_d : nullptr, SAVE ? save_s : nullptr);
    __syncthreads();
    tile_gemm<false>(bm, ld(k), k, sw1, ld(k), h, [&](int r, int c, float v0, float v1) {
      store2(bh1 + r * ld(h) + c, fmaxf(v0 + sb1[c], 0.f), fmaxf(v1 + sb1[c + 1], 0.f));
    });
    __syncthreads();
    tile_gemm<false>(bh1, ld(h), h, sw2, ld(h), h, [&](int r, int c, float v0, float v1) {
      store2(bm + r * ld(h) + c, fmaxf(v0 + sb2[c], 0.f), fmaxf(v1 + sb2[c + 1], 0.f));
    });
    __syncthreads();
    tile_gemm<false>(bm, ld(h), h, sw3, ld(h), fo, [&](int r, int c, float v0, float v1) {
      const long edge = t0 + r;
      if (edge >= n_edges) return;
      const bool on = mask[edge] != 0;
      store2(e_out + edge * fo + c, on ? v0 + sb3[c] : 0.f, on ? v1 + sb3[c + 1] : 0.f);
    });
  }
}

// ------------------------------------------------------------------------------ backward (B, D)
template <bool SAVED>
__global__ void __launch_bounds__(THREADS, 1)
bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gd, const bf16* __restrict__ gs,
           const bf16* __restrict__ ea, const int* __restrict__ src, const int* __restrict__ dst,
           const uint8_t* __restrict__ mask, const bf16* __restrict__ w1,
           const bf16* __restrict__ b1, const bf16* __restrict__ w2, const bf16* __restrict__ b2,
           const bf16* __restrict__ w3, const bf16* __restrict__ g_eout,
           const bf16* __restrict__ g_agg, bf16* __restrict__ g_xd, bf16* __restrict__ g_xs,
           bf16* __restrict__ g_ea, float* __restrict__ partial, int n_edges, int fx, int fe,
           int h, int fo, int relu_edge) {
  extern __shared__ uint4 smem4[];
  const int k = 2 * fx + fe;
  const Layout L(k, h, fo);
  bf16 *sw1, *sw2, *sw3;
  float* sb;
  stage_weights(L, reinterpret_cast<unsigned char*>(smem4), w1, b1, w2, b2, w3, nullptr, sw1, sw2,
                sw3, sb);
  bf16* bm = reinterpret_cast<bf16*>(sb + 2 * h + fo);  // [TE][ld(k)]  m
  bf16* bh1 = bm + TE * L.wide();                       // [TE][ld(h)]  h1
  bf16* bh2 = bh1 + TE * ld(h);                         // [TE][ld(h)]  h2, then g_h1
  bf16* bgh2 = bh2 + TE * ld(h);                        // [TE][ld(h)]  g_h2
  bf16* bget = bgh2 + TE * ld(h);                       // [TE][ld(fo)] g_e'
  const float* sb1 = sb;
  const float* sb2 = sb + h;

  const long p = (long)h * k + h + (long)h * h + h + (long)fo * h + fo;
  float* pw1 = partial + (long)blockIdx.x * p;
  float* pb1 = pw1 + (long)h * k;
  float* pw2 = pb1 + h;
  float* pb2 = pw2 + (long)h * h;
  float* pw3 = pb2 + h;
  float* pb3 = pw3 + (long)fo * h;

  const int n_tiles = (n_edges + TE - 1) / TE;
  const int fov = fo / 8;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long t0 = (long)tile * TE;
    const bool first = tile == (int)blockIdx.x;
    __syncthreads();  // weights staged / the previous tile's buffers consumed
    gather_tile<SAVED>(bm, k, t0, n_edges, fx, fe, x, gd, gs, ea, src, dst, relu_edge, nullptr,
                       nullptr);
    // g_e' = bf16(mask ? g_e'_out + g_agg[dst] : 0), zero past the last edge
    for (int i = threadIdx.x; i < TE * fov; i += THREADS) {
      const int e = i / fov, c = (i % fov) * 8;
      const long edge = t0 + e;
      uint4 out = make_uint4(0u, 0u, 0u, 0u);
      if (edge < n_edges && mask[edge]) {
        uint4 a = ld16(g_eout + edge * fo + c);
        uint4 b = ld16(g_agg + (long)dst[edge] * fo + c);
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* b2v = reinterpret_cast<const __nv_bfloat162*>(&b);
        __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 fa = __bfloat1622float2(a2[q]);
          const float2 fb = __bfloat1622float2(b2v[q]);
          o2[q] = __floats2bfloat162_rn(fa.x + fb.x, fa.y + fb.y);
        }
      }
      *reinterpret_cast<uint4*>(bget + e * ld(fo) + c) = out;
    }
    __syncthreads();
    // recompute h1 and h2, the forward's bits
    tile_gemm<false>(bm, ld(k), k, sw1, ld(k), h, [&](int r, int c, float v0, float v1) {
      store2(bh1 + r * ld(h) + c, fmaxf(v0 + sb1[c], 0.f), fmaxf(v1 + sb1[c + 1], 0.f));
    });
    __syncthreads();
    tile_gemm<false>(bh1, ld(h), h, sw2, ld(h), h, [&](int r, int c, float v0, float v1) {
      store2(bh2 + r * ld(h) + c, fmaxf(v0 + sb2[c], 0.f), fmaxf(v1 + sb2[c + 1], 0.f));
    });
    __syncthreads();
    // g_h2 = bf16((g_e' W3) * [h2 > 0]); dW3 += g_e'^T h2, db3 += sum g_e'
    tile_gemm<true>(bget, ld(fo), fo, sw3, ld(h), h, [&](int r, int c, float v0, float v1) {
      const bf16* a = bh2 + r * ld(h) + c;
      store2(bgh2 + r * ld(h) + c, positive(a) ? v0 : 0.f, positive(a + 1) ? v1 : 0.f);
    });
    weight_grad(bget, ld(fo), fo, bh2, ld(h), h, pw3, pb3, first);
    __syncthreads();
    // g_h1 = bf16((g_h2 W2) * [h1 > 0]) over h2's buffer; dW2 += g_h2^T h1, db2 += sum g_h2
    tile_gemm<true>(bgh2, ld(h), h, sw2, ld(h), h, [&](int r, int c, float v0, float v1) {
      const bf16* a = bh1 + r * ld(h) + c;
      store2(bh2 + r * ld(h) + c, positive(a) ? v0 : 0.f, positive(a + 1) ? v1 : 0.f);
    });
    weight_grad(bgh2, ld(h), h, bh1, ld(h), h, pw2, pb2, first);
    __syncthreads();
    // g_m = bf16(g_h1 W1), split into the dst, src and edge blocks; dW1 += g_h1^T m
    tile_gemm<true>(bh2, ld(h), h, sw1, ld(k), k, [&](int r, int c, float v0, float v1) {
      const long edge = t0 + r;
      if (edge >= n_edges) return;
      if (c < fx) {
        store2(g_xd + edge * fx + c, v0, v1);
      } else if (c < 2 * fx) {
        store2(g_xs + edge * fx + (c - fx), v0, v1);
      } else {
        // m holds relu(ea) with relu_edge: relu(ea) > 0 exactly where ea > 0
        const bf16* a = bm + r * ld(k) + c;
        if (relu_edge) {
          v0 = positive(a) ? v0 : 0.f;
          v1 = positive(a + 1) ? v1 : 0.f;
        }
        store2(g_ea + edge * fe + (c - 2 * fx), v0, v1);
      }
    });
    weight_grad(bh2, ld(h), h, bm, ld(k), k, pw1, pb1, first);
  }
}

// out[i] = bf16(sum over b < blocks of partial[b][i]), in block order
__global__ void __launch_bounds__(256)
sum_partials_kernel(const float* __restrict__ partial, int blocks, long p, bf16* __restrict__ out) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += partial[(long)b * p + i];
  out[i] = __float2bfloat16_rn(s);
}

// Set the kernel's shared-memory size and find its persistent grid: min(tiles, SMs x blocks per
// SM), or 0 for no edges. Errors are returned and cleared, so that they do not resurface in a
// later call's cudaGetLastError().
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem, int n_edges, int max_blocks, int* grid) {
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
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
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
int launch_fwd(const bf16* x, const bf16* ea, const int* edge_index, const uint8_t* mask,
               const bf16* w1, const bf16* b1, const bf16* w2, const bf16* b2, const bf16* w3,
               const bf16* b3, bf16* e_out, bf16* save_d, bf16* save_s, int n_edges, int fx,
               int fe, int h, int fo, int relu_edge, void* stream_ptr) {
  const size_t smem = Layout(2 * fx + fe, h, fo).fwd_bytes();
  int grid = 0;
  cudaError_t err = prepare(fwd_kernel<SAVE>, smem, n_edges, 0, &grid);
  if (err != cudaSuccess) return err;
  if (grid > 0) {
    fwd_kernel<SAVE><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream_ptr)>>>(
        x, ea, edge_index, edge_index + n_edges, mask, w1, b1, w2, b2, w3, b3, e_out, save_d,
        save_s, n_edges, fx, fe, h, fo, relu_edge);
  }
  return cudaGetLastError();
}

template <bool SAVED>
int launch_bwd(const bf16* x, const bf16* gd, const bf16* gs, const bf16* ea,
               const int* edge_index, const uint8_t* mask, const bf16* w1, const bf16* b1,
               const bf16* w2, const bf16* b2, const bf16* w3, const bf16* g_eout,
               const bf16* g_agg, bf16* g_xd, bf16* g_xs, bf16* g_ea, float* partial,
               bf16* grads, int n_edges, int fx, int fe, int h, int fo, int relu_edge,
               int max_blocks, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int k = 2 * fx + fe;
  const size_t smem = Layout(k, h, fo).bwd_bytes();
  if (max_blocks < 1) return cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t err = prepare(bwd_kernel<SAVED>, smem, n_edges, max_blocks, &grid);
  if (err != cudaSuccess) return err;
  if (grid > 0) {
    bwd_kernel<SAVED><<<grid, THREADS, smem, stream>>>(
        x, gd, gs, ea, edge_index, edge_index + n_edges, mask, w1, b1, w2, b2, w3, g_eout, g_agg,
        g_xd, g_xs, g_ea, partial, n_edges, fx, fe, h, fo, relu_edge);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long p = (long)h * k + h + (long)h * h + h + (long)fo * h + fo;
  sum_partials_kernel<<<(unsigned)((p + 255) / 256), 256, 0, stream>>>(partial, grid, p, grads);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// A. edge_index [2, E] int32 (row 0 source, row 1 target, targets sorted); mask [E] uint8;
// x [N, Fx], ea [E, Fe], weights [out][in] and biases, all bf16 with 16-byte aligned rows.
// Writes e_out [E, Fo] bf16. Fx, Fe, H and Fo are multiples of 32. Returns cudaGetLastError(), or
// the error of widths whose weights and tiles exceed one block's shared memory.
int fused_relational_bf16_fwd(const bf16* x, const bf16* ea, const int* edge_index,
                              const uint8_t* mask, const bf16* w1, const bf16* b1, const bf16* w2,
                              const bf16* b2, const bf16* w3, const bf16* b3, bf16* e_out,
                              int n_edges, int fx, int fe, int h, int fo, int relu_edge,
                              void* stream_ptr) {
  return launch_fwd<false>(x, ea, edge_index, mask, w1, b1, w2, b2, w3, b3, e_out, nullptr,
                           nullptr, n_edges, fx, fe, h, fo, relu_edge, stream_ptr);
}

// C. As A, and writes the gathered endpoint rows: save_d [E, Fx] = x[dst], save_s = x[src].
int fused_relational_bf16_fwd_save(const bf16* x, const bf16* ea, const int* edge_index,
                                   const uint8_t* mask, const bf16* w1, const bf16* b1,
                                   const bf16* w2, const bf16* b2, const bf16* w3, const bf16* b3,
                                   bf16* e_out, bf16* save_d, bf16* save_s, int n_edges, int fx,
                                   int fe, int h, int fo, int relu_edge, void* stream_ptr) {
  return launch_fwd<true>(x, ea, edge_index, mask, w1, b1, w2, b2, w3, b3, e_out, save_d, save_s,
                          n_edges, fx, fe, h, fo, relu_edge, stream_ptr);
}

// B. g_eout [E, Fo] and g_agg [N, Fo] bf16 (read by target in the kernel). Writes g_xd, g_xs
// [E, Fx] (per-edge gradients of x[dst] and x[src]), g_ea [E, Fe] and grads [P] packed as w1, b1,
// w2, b2, w3, b3 ([out][in]), all bf16; partial is [max_blocks, P] f32 scratch, and the
// persistent grid is at most max_blocks blocks.
int fused_relational_bf16_bwd(const bf16* x, const bf16* ea, const int* edge_index,
                              const uint8_t* mask, const bf16* w1, const bf16* b1, const bf16* w2,
                              const bf16* b2, const bf16* w3, const bf16* g_eout,
                              const bf16* g_agg, bf16* g_xd, bf16* g_xs, bf16* g_ea,
                              float* partial, bf16* grads, int n_edges, int fx, int fe, int h,
                              int fo, int relu_edge, int max_blocks, void* stream_ptr) {
  return launch_bwd<false>(x, nullptr, nullptr, ea, edge_index, mask, w1, b1, w2, b2, w3, g_eout,
                           g_agg, g_xd, g_xs, g_ea, partial, grads, n_edges, fx, fe, h, fo,
                           relu_edge, max_blocks, stream_ptr);
}

// D. As B, with the endpoint rows read from C's saved gd = x[dst], gs = x[src] ([E, Fx]).
int fused_relational_bf16_bwd_saved(const bf16* gd, const bf16* gs, const bf16* ea,
                                    const int* edge_index, const uint8_t* mask, const bf16* w1,
                                    const bf16* b1, const bf16* w2, const bf16* b2, const bf16* w3,
                                    const bf16* g_eout, const bf16* g_agg, bf16* g_xd, bf16* g_xs,
                                    bf16* g_ea, float* partial, bf16* grads, int n_edges, int fx,
                                    int fe, int h, int fo, int relu_edge, int max_blocks,
                                    void* stream_ptr) {
  return launch_bwd<true>(nullptr, gd, gs, ea, edge_index, mask, w1, b1, w2, b2, w3, g_eout,
                          g_agg, g_xd, g_xs, g_ea, partial, grads, n_edges, fx, fe, h, fo,
                          relu_edge, max_blocks, stream_ptr);
}

}  // extern "C"
