// Fused interaction-network edge pipeline, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels gnn_tracking_tpu/ops/pallas/fused_relational.py::fused_relational:
// the forward (_fwd_kernel) and the backward (_bwd_kernel). For every edge (src -> dst)
//     e' = mask * ( relu( relu([x_dst, x_src, ea] W1 + b1) W2 + b2 ) W3 + b3 )
// Masked edges come out as exact zeros. With relu_edge the incoming edge features pass through a
// ReLU first. The aggregation agg[i] = sum of e' over the edges whose target is i is the sorted
// segment-sum kernel of csr_segment.cu, launched by the wrapper after this file's edge kernel.
//
// What bounds them on this card: arithmetic. Per edge the forward MLP costs 2 (K H + H H + H Fo)
// flops (K = 2 Fx + Fe); at the serving shapes (K = 96, H = 128, Fo = 32, E = 262144) that is
// 17.2 GFLOP per layer against ~37 MB of compulsory traffic, some 460 flop per byte, far above the
// card's f32 ridge point. The backward recomputes the two hidden layers (the output layer is linear
// and its value is not needed) and computes the input and weight gradients of all three:
// 2 (3 K H + 3 H H + 2 H Fo) flops per edge, 49.4 GFLOP at all 262,144 edges.
//
// Forward design (f32 FMA on the CUDA cores, TF32 off; tensor cores are later work):
//  * the wrapper partitions the edge ids stably, unmasked first (a cumsum and a scatter, the
//    count left on the device): the MLP runs on unmasked edges only, and the kernel writes the
//    masked edges' zero rows directly, row by row;
//  * persistent blocks of 256 threads, one per SM; each stages W1, W2, W3 and the biases ONCE
//    into shared memory, transposed to [in][out];
//  * tiles of FTE = 64 unmasked edges; activations are k-major ([k][edge]), so each thread owns
//    an 8-edge x 4-output register tile (4 x 4 where a layer is narrower than 128) and reads it
//    per k as float4s: 32 FMA per 3 shared loads, a warp's edge loads one contiguous row;
//  * the next tile's gather [x_dst, x_src, ea] is issued with cp.async into a second buffer
//    before the current tile's layers run; h2 overwrites the current input tile;
//  * every output is fmaf over k ascending from 0.f, then + b (then ReLU in the hidden layers),
//    as the backward's recompute does, so the two agree bit for bit;
//  * with the save flag (row #7 in f32, kernel C32) it also writes the gathered endpoint rows
//    x[dst], x[src] of every edge for the backward that reads them (row #8, kernel D32);
//  * wide layers (ec.yml's K = 192, H = 128, Fo = 64: 321.8 KiB with W1 staged, against one
//    block's 227 KiB) keep W1^T ([K][H], transposed by the wrapper) in device memory; each
//    output's FMA order is the same in both layouts, so they give the same bits. Widths whose
//    tiles and W2, W3 do not fit even so (fused_relational_fits) take
//    csrc/fused_relational_wide.cu, whose f32 arithmetic is this file's.
// Backward design (f32 FMA on the CUDA cores, TF32 off; 256 threads, one persistent block an SM):
//  * the same partition as the forward: the MLP backward runs on tiles of FTE = 64 unmasked
//    edges only, and the kernel writes the masked edges' zero rows of g_xd, g_xs, g_ea directly
//    (a masked edge adds exactly 0 to every weight-gradient sum);
//  * k-major tiles with rows padded to BLD = 68 floats (consecutive rows 4 banks apart); the
//    recompute of h1 and h2 is the forward's dense_tile, so its activations and ReLU masks are
//    the forward's bit for bit;
//  * the three input-gradient products (g_h2 = (g_et W3) * [h2 > 0], g_h1 = (g_h2 W2) * [h1 > 0],
//    g_m = g_h1 W1) use dense_tile's register tiles (8 x 4 or 4 x 4, 16-byte loads) in their own
//    loop (grad_product, with a store per product); they read each weight as PyTorch stores it
//    ([out][in] is their [k][out]), the recompute reads W^T;
//  * the weight gradients contract along the tile's edges, which are contiguous in both
//    operands: a warp owns a 32 x 32 (or 16 x 32) block of dW, a thread 8 x 4 (4 x 4) entries fed
//    by 16-byte loads of 4 edges; each 64-edge tile's sum goes into the block's slice of a
//    [blocks, P] partial in device memory (L2): the block's first tile stores it, later tiles
//    add it there with red.global.add.f32 from the entry's only writer, in tile order (one
//    thread owns an entry for the whole launch, and same-address operations of one thread keep
//    program order); a second kernel sums the partials of the blocks that took a tile, in block
//    order. Every sum's order is fixed, so a second launch gives the same bits;
//  * four big tile buffers rotate roles (m, h1, h2 / g_h1, g_h2): the last phase (g_m and dW1)
//    reads neither h1 nor g_h2 nor g_et, so the next tile's gather lands in their buffers
//    (cp.async) while it runs;
//  * the tiles take 144.5 KiB at the GraphTCN's widths (K = 96, H = 128, Fo = 32), so W2 is staged
//    there too (209 KiB in all); at ec.yml's (K = 192, H = 128, Fo = 64) the tiles alone take
//    221 KiB, and every weight is read through L1/L2. W1^T, W1 (rows padded to a multiple of 4),
//    W2^T and W3 always are, in the orientation each product reads along 16-byte rows;
//  * node gradients: the kernel writes the per-edge dst and src parts of the input gradient; the
//    wrapper sums them per node with csr_segment.cu's segment-sum, in target order and in source
//    order (through src_perm), in a fixed order (see csr_segment.cu).
// The saved-rows backward (D32) reads x[dst], x[src] from the rows C32 wrote; every output is
// then bitwise the recomputing backward's.
// The TPU's slab windows, one-hot MXU gathers and 8-sublane index tiles are not carried over.

#include <cuda_runtime.h>

#include "fixed_order_sum.cuh"

namespace {

constexpr int THREADS = 256;  // threads per block of the backward

// ------------------------------------------------------------------ forward
constexpr int FTE = 64;         // edges per tile of the forward
constexpr int FTHREADS = 256;  // threads per block of the forward

// Tiles of the forward hold activations k-major, [k][FTE]: a thread reads four edges of one k
// as one float4, and a warp's reads of one k are one contiguous row.

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <bool GLOBAL>
__device__ __forceinline__ float4 ld4(const float* p) {
  if constexpr (GLOBAL) return __ldg(reinterpret_cast<const float4*>(p));
  return *reinterpret_cast<const float4*>(p);
}

// One dense layer over a tile: y[e][j] = sum_k in[k][e] wt[k][j] for e < FTE, j < m, each a
// chain of fmaf over k ascending from 0.f (the backward's recompute runs this function too).
// A thread owns RE edges x RO outputs: edges {4 eg + r} (and {32 + 4 eg + r} when RE = 8),
// outputs {4 og + c} (and {m/2 + 4 og + c} when RO = 8), so each k costs RE/4 + RO/4 float4
// loads for RE RO FMAs. wt is [kin][m], in shared memory or (W_GLOBAL) in device memory.
// HIDDEN: out[j][e] = relu(y + b[j]). Else the output layer: e_out[ids[e]][j] = y + b[j] for
// the tile's `valid` edges. LD is the tiles' row stride (the backward pads its rows).
template <int RE, int RO, bool W_GLOBAL, bool HIDDEN, int LD = FTE>
__device__ __forceinline__ void dense_tile(const float* __restrict__ in, int kin,
                                           const float* __restrict__ wt,
                                           const float* __restrict__ b, int m,
                                           float* __restrict__ out,
                                           const int* __restrict__ ids, int valid,
                                           float* __restrict__ e_out) {
  constexpr int n_eg = FTE / RE;
  const int n_og = m / RO;
  for (int u = threadIdx.x; u < n_eg * n_og; u += blockDim.x) {
    const int eg = u % n_eg;
    const int og = u / n_eg;
    float acc[RE][RO];
#pragma unroll
    for (int r = 0; r < RE; ++r) {
#pragma unroll
      for (int c = 0; c < RO; ++c) acc[r][c] = 0.f;
    }
    const float* arow = in + 4 * eg;
    const float* wcol = wt + 4 * og;
#pragma unroll 8
    for (int kk = 0; kk < kin; ++kk) {
      float a[RE], w[RO];
      const float4 a0 = *reinterpret_cast<const float4*>(arow + kk * LD);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      if constexpr (RE == 8) {
        const float4 a1 = *reinterpret_cast<const float4*>(arow + kk * LD + 32);
        a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      }
      const float4 w0 = ld4<W_GLOBAL>(wcol + (long)kk * m);
      w[0] = w0.x; w[1] = w0.y; w[2] = w0.z; w[3] = w0.w;
      if constexpr (RO == 8) {
        const float4 w1 = ld4<W_GLOBAL>(wcol + (long)kk * m + m / 2);
        w[4] = w1.x; w[5] = w1.y; w[6] = w1.z; w[7] = w1.w;
      }
#pragma unroll
      for (int r = 0; r < RE; ++r) {
#pragma unroll
        for (int c = 0; c < RO; ++c) acc[r][c] = fmaf(a[r], w[c], acc[r][c]);
      }
    }
#pragma unroll
    for (int c = 0; c < RO; ++c) {
      const int j = (c < 4 ? 0 : m / 2) + 4 * og + (c & 3);
      const float bj = b[j];
      if constexpr (HIDDEN) {
#pragma unroll
        for (int q = 0; q < RE / 4; ++q) {
          *reinterpret_cast<float4*>(out + j * LD + 32 * q + 4 * eg) =
              make_float4(fmaxf(acc[4 * q][c] + bj, 0.f), fmaxf(acc[4 * q + 1][c] + bj, 0.f),
                          fmaxf(acc[4 * q + 2][c] + bj, 0.f), fmaxf(acc[4 * q + 3][c] + bj, 0.f));
        }
      } else {
#pragma unroll
        for (int r = 0; r < RE; ++r) acc[r][c] += bj;
      }
    }
    if constexpr (!HIDDEN) {
#pragma unroll
      for (int r = 0; r < RE; ++r) {
        const int e = (r < 4 ? 0 : 32) + 4 * eg + (r & 3);
        if (e >= valid) continue;
        float* row = e_out + (long)ids[e] * m + 4 * og;
        *reinterpret_cast<float4*>(row) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        if constexpr (RO == 8) {
          *reinterpret_cast<float4*>(row + m / 2) =
              make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
        }
      }
    }
  }
}

// a layer with the widest register tile that still gives every thread work
template <bool W_GLOBAL, bool HIDDEN, int LD = FTE>
__device__ __forceinline__ void dense(const float* in, int kin, const float* wt, const float* b,
                                      int m, float* out, const int* ids, int valid,
                                      float* e_out) {
  if (m >= 128) {
    dense_tile<8, 4, W_GLOBAL, HIDDEN, LD>(in, kin, wt, b, m, out, ids, valid, e_out);
  } else {
    dense_tile<4, 4, W_GLOBAL, HIDDEN, LD>(in, kin, wt, b, m, out, ids, valid, e_out);
  }
}

// shared memory of the forward (floats); without w1_shared, W1^T stays in device memory
__host__ __device__ inline long smem_floats(int k, int h, int fo, bool w1_shared) {
  const long weights = (w1_shared ? (long)k * h : 0L) + h + (long)h * h + h + (long)h * fo + fo;
  const long acts = 2L * FTE * (k > h ? k : h) + (long)FTE * h;  // two input tiles (one is h2), h1
  return weights + acts + 2L * FTE;                              // + the tiles' edge ids
}

// Issue the copies of tile t's inputs [x[dst], x[src], ea] into `a` (k-major, row stride LD) and
// its edge ids into `tid`; rows past the `count` unmasked edges are zeros. Consecutive threads
// take consecutive edges of one input column, so the shared-memory side is conflict-free. SAVED
// (the backward D32) reads the endpoint rows from gd = x[dst], gs = x[src] instead.
template <int LD = FTE, bool SAVED = false>
__device__ __forceinline__ void gather_tile(const float* __restrict__ x,
                                            const float* __restrict__ gd,
                                            const float* __restrict__ gs,
                                            const float* __restrict__ ea,
                                            const int* __restrict__ src,
                                            const int* __restrict__ dst,
                                            const int* __restrict__ ids, int count, int t, int fx,
                                            int fe, float* __restrict__ a, int* __restrict__ tid) {
  const int k = 2 * fx + fe;
  const int t0 = t * FTE;
  const int e = threadIdx.x % FTE;
  const bool live = t0 + e < count;
  const int edge = live ? __ldg(ids + t0 + e) : 0;
  if (threadIdx.x < FTE) tid[e] = edge;
  const float* xd = SAVED ? gd + (long)edge * fx : x + (long)(live ? __ldg(dst + edge) : 0) * fx;
  const float* xs = SAVED ? gs + (long)edge * fx : x + (long)(live ? __ldg(src + edge) : 0) * fx;
  const float* er = ea + (long)edge * fe;
  for (int c = threadIdx.x / FTE; c < k; c += blockDim.x / FTE) {
    float* slot = a + c * LD + e;
    if (!live) {
      *slot = 0.f;
    } else if (c < fx) {
      cp_async4(slot, xd + c);
    } else if (c < 2 * fx) {
      cp_async4(slot, xs + (c - fx));
    } else {
      cp_async4(slot, er + (c - 2 * fx));
    }
  }
  cp_async_commit();
}

// The forward, persistent: blocks take tiles of FTE unmasked edges in turn (ids[:count]: the
// wrapper's stable partition of the edge ids, unmasked first, then masked; count on the
// device). Each tile's gather (cp.async) is issued before the previous tile's layers run.
// Masked edges get zero rows of e_out without any MLP work. SAVE (row #7, kernel C32) also
// writes the gathered endpoint rows gd = x[dst], gs = x[src] of every edge, for the backward
// that reads them (row #8).
template <bool W1_SHARED, bool SAVE>
__global__ void __launch_bounds__(FTHREADS, 1)
edge_mlp_kernel(const float* __restrict__ x, const float* __restrict__ ea,
                const int* __restrict__ src, const int* __restrict__ dst,
                const int* __restrict__ ids, const int* __restrict__ count_ptr,
                const float* __restrict__ w1, const float* __restrict__ w1t_dev,
                const float* __restrict__ b1,
                const float* __restrict__ w2, const float* __restrict__ b2,
                const float* __restrict__ w3, const float* __restrict__ b3,
                float* __restrict__ e_out, float* __restrict__ gd, float* __restrict__ gs,
                int n_edges, int fx, int fe, int h, int fo, int relu_edge) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int k = 2 * fx + fe;
  const int kh = k > h ? k : h;
  float* w1t = smem;                             // [k][h] (W1_SHARED)
  float* sb1 = w1t + (W1_SHARED ? k * h : 0);    // [h]
  float* w2t = sb1 + h;                          // [h][h]
  float* sb2 = w2t + h * h;                      // [h]
  float* w3t = sb2 + h;                          // [h][fo]
  float* sb3 = w3t + h * fo;                     // [fo]
  float* abuf = sb3 + fo;                        // [2][kh][FTE]: input tiles, then h2
  float* bh1 = abuf + 2 * kh * FTE;              // [h][FTE]
  int* tids = reinterpret_cast<int*>(bh1 + h * FTE);  // [2][FTE]

  const int count = *count_ptr;
  const int n_tiles = (count + FTE - 1) / FTE;
  if ((int)blockIdx.x < n_tiles) {  // the first tile's gather runs under the weights' staging
    gather_tile(x, nullptr, nullptr, ea, src, dst, ids, count, blockIdx.x, fx, fe, abuf, tids);
  }
  // weights arrive in PyTorch's [out][in] layout; staged as [in][out], consecutive threads
  // writing consecutive words
  if (W1_SHARED) {
    for (int i = threadIdx.x; i < h * k; i += blockDim.x) w1t[i] = w1[(i % h) * k + i / h];
  }
  for (int i = threadIdx.x; i < h * h; i += blockDim.x) w2t[i] = w2[(i % h) * h + i / h];
  for (int i = threadIdx.x; i < fo * h; i += blockDim.x) w3t[i] = w3[(i % fo) * h + i / fo];
  for (int i = threadIdx.x; i < h; i += blockDim.x) {
    sb1[i] = b1[i];
    sb2[i] = b2[i];
  }
  for (int i = threadIdx.x; i < fo; i += blockDim.x) sb3[i] = b3[i];

  // masked edges (ids[count:]): zero rows (and, with SAVE, their endpoint rows), row by row
  const int stride = gridDim.x * blockDim.x;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < (long)(n_edges - count) * fo;
       i += stride) {
    const long edge = __ldg(ids + count + i / fo);
    e_out[edge * fo + i % fo] = 0.f;
  }
  if (SAVE) {
    for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < (long)(n_edges - count) * fx;
         i += stride) {
      const long edge = __ldg(ids + count + i / fx);
      const int c = (int)(i % fx);
      gd[edge * fx + c] = x[(long)dst[edge] * fx + c];
      gs[edge * fx + c] = x[(long)src[edge] * fx + c];
    }
  }

  const float* w1r = W1_SHARED ? w1t : w1t_dev;
  int buf = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    float* a = abuf + buf * kh * FTE;
    const int* tid = tids + buf * FTE;
    const int next = t + gridDim.x;
    if (next < n_tiles) {
      // the other buffer was last read by the previous tile's output layer, before its barrier
      gather_tile(x, nullptr, nullptr, ea, src, dst, ids, count, next, fx, fe,
                  abuf + (buf ^ 1) * kh * FTE,
                  tids + (buf ^ 1) * FTE);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const int valid = min(FTE, count - t * FTE);
    if (relu_edge) {  // this thread's own copies of the edge features, visible to it now
      const int e = threadIdx.x % FTE;
      for (int c = threadIdx.x / FTE; c < k; c += blockDim.x / FTE) {
        if (c >= 2 * fx) a[c * FTE + e] = fmaxf(a[c * FTE + e], 0.f);
      }
    }
    __syncthreads();  // the tile's inputs, edge ids and (first tile) the weights are staged
    if (SAVE) {  // the gathered rows, from the tile (consecutive threads: consecutive edges)
      if (fx % 4 == 0) {
        for (int i = threadIdx.x; i < FTE * (fx / 4); i += blockDim.x) {
          const int e = i % FTE;
          const int c = 4 * (i / FTE);
          if (e >= valid) continue;
          const long row = (long)tid[e] * fx + c;
          *reinterpret_cast<float4*>(gd + row) = make_float4(
              a[c * FTE + e], a[(c + 1) * FTE + e], a[(c + 2) * FTE + e], a[(c + 3) * FTE + e]);
          *reinterpret_cast<float4*>(gs + row) =
              make_float4(a[(fx + c) * FTE + e], a[(fx + c + 1) * FTE + e],
                          a[(fx + c + 2) * FTE + e], a[(fx + c + 3) * FTE + e]);
        }
      } else {
        for (int i = threadIdx.x; i < FTE * fx; i += blockDim.x) {
          const int e = i % FTE;
          const int c = i / FTE;
          if (e >= valid) continue;
          gd[(long)tid[e] * fx + c] = a[c * FTE + e];
          gs[(long)tid[e] * fx + c] = a[(fx + c) * FTE + e];
        }
      }
    }
    dense<!W1_SHARED, true>(a, k, w1r, sb1, h, bh1, nullptr, 0, nullptr);
    __syncthreads();
    dense<false, true>(bh1, h, w2t, sb2, h, a, nullptr, 0, nullptr);  // h2 over the input tile
    __syncthreads();
    dense<false, false>(a, h, w3t, sb3, fo, nullptr, tid, valid, e_out);
    __syncthreads();  // the tile's buffer is free for the gather two tiles on
    buf ^= 1;
  }
}

// ------------------------------------------------------------------ backward
constexpr int BLD = FTE + 4;  // row stride of the backward's k-major tiles: rows 4 banks apart

// shared memory of the backward (floats): four [kh][BLD] tiles (kh = max(k, h, fo)) that rotate
// through the roles m, h1, h2 / g_h1, g_h2 and the next tile's inputs; g_et [fo][BLD]; W2 where
// w2_shared; the edge ids of two tiles
__host__ __device__ inline long bwd_smem_floats(int k, int h, int fo, bool w2_shared) {
  const long kh = k > h ? (k > fo ? k : fo) : (h > fo ? h : fo);
  return 4L * kh * BLD + (long)fo * BLD + (w2_shared ? (long)h * h : 0L) + 2L * FTE;
}

// weight-gradient values, packed as w1 [h][k], b1 [h], w2 [h][h], b2 [h], w3 [fo][h], b3 [fo]
__host__ __device__ inline long grad_floats(int k, int h, int fo) {
  return (long)h * k + h + (long)h * h + h + (long)fo * h + fo;
}

// Issue the copies of tile t's output cotangents g_eout[id] into ge and g_agg[dst[id]] (the
// wrapper's gathered rows) into ga, both k-major [fo][BLD]; zeros past the `count` unmasked
// edges. The thread that copies (c, e) of one copies (c, e) of the other, so it can sum the two
// without a barrier once its copies have landed.
__device__ __forceinline__ void gather_cotangents(const float* __restrict__ g_eout,
                                                  const float* __restrict__ g_agg_e,
                                                  const int* __restrict__ ids, int count, int t,
                                                  int fo, float* __restrict__ ge,
                                                  float* __restrict__ ga) {
  const int t0 = t * FTE;
  const int e = threadIdx.x % FTE;
  const bool live = t0 + e < count;
  const long edge = live ? __ldg(ids + t0 + e) : 0;
  for (int c = threadIdx.x / FTE; c < fo; c += blockDim.x / FTE) {
    if (live) {
      cp_async4(ge + c * BLD + e, g_eout + edge * fo + c);
      cp_async4(ga + c * BLD + e, g_agg_e + edge * fo + c);
    } else {
      ge[c * BLD + e] = 0.f;
      ga[c * BLD + e] = 0.f;
    }
  }
  cp_async_commit();
}

// An input-gradient product over a tile: y[e][j] = sum_kk in[kk][e] wt[kk][j] (kk < kin,
// j < m, m % 4 == 0; wt [kin][m] in shared or device memory, 16-byte aligned), each a chain of
// fmaf over kk ascending from 0.f. Threads as in dense_tile: an RE-edge x 4-output register tile
// fed by RE/4 + 1 float4 loads per kk. epi(eg, og, acc) stores the tile.
template <int RE, bool W_GLOBAL, typename Epi>
__device__ __forceinline__ void grad_product(const float* __restrict__ in, int kin,
                                             const float* __restrict__ wt, int m, Epi epi) {
  constexpr int n_eg = FTE / RE;
  const int n_og = m / 4;
  for (int u = threadIdx.x; u < n_eg * n_og; u += blockDim.x) {
    const int eg = u % n_eg;
    const int og = u / n_eg;
    float acc[RE][4];
#pragma unroll
    for (int r = 0; r < RE; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    }
    const float* arow = in + 4 * eg;
    const float* wcol = wt + 4 * og;
#pragma unroll 8
    for (int kk = 0; kk < kin; ++kk) {
      float a[RE];
      const float4 a0 = *reinterpret_cast<const float4*>(arow + kk * BLD);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      if constexpr (RE == 8) {
        const float4 a1 = *reinterpret_cast<const float4*>(arow + kk * BLD + 32);
        a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      }
      const float4 w0 = ld4<W_GLOBAL>(wcol + (long)kk * m);
      const float w[4] = {w0.x, w0.y, w0.z, w0.w};
#pragma unroll
      for (int r = 0; r < RE; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], w[c], acc[r][c]);
      }
    }
    epi(eg, og, acc);
  }
}

// the register tile (8 or 4 edges) that takes the fewest rounds of the block's threads
template <bool W_GLOBAL, typename Epi>
__device__ __forceinline__ void grad_product_any(const float* in, int kin, const float* wt, int m,
                                                 Epi epi) {
  const int n_og = m / 4;
  const int rounds8 = (8 * n_og + blockDim.x - 1) / blockDim.x;   // units of 8 x 4
  const int rounds4 = (16 * n_og + blockDim.x - 1) / blockDim.x;  // units of 4 x 4, half the work
  if (2 * rounds8 <= rounds4) {
    grad_product<8, W_GLOBAL>(in, kin, wt, m, epi);
  } else {
    grad_product<4, W_GLOBAL>(in, kin, wt, m, epi);
  }
}

// edge e of register-tile row r (edges {4 eg + r} and, with 8 rows, {32 + 4 eg + r - 4})
__device__ __forceinline__ int tile_edge(int eg, int r) { return (r < 4 ? 0 : 32) + 4 * eg + (r & 3); }

// out[j][e] = act[j][e] > 0 ? y : 0 (a ReLU's derivative, 0 at 0), into a k-major tile
struct MaskedStore {
  const float* act;
  float* out;
  template <int RE>
  __device__ __forceinline__ void operator()(int eg, int og, const float (&acc)[RE][4]) const {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = 4 * og + c;
#pragma unroll
      for (int q = 0; q < RE / 4; ++q) {
        const int at = j * BLD + 32 * q + 4 * eg;
        const float4 h = *reinterpret_cast<const float4*>(act + at);
        *reinterpret_cast<float4*>(out + at) =
            make_float4(h.x > 0.f ? acc[4 * q][c] : 0.f, h.y > 0.f ? acc[4 * q + 1][c] : 0.f,
                        h.z > 0.f ? acc[4 * q + 2][c] : 0.f, h.w > 0.f ? acc[4 * q + 3][c] : 0.f);
      }
    }
  }
};

// g_m = g_h1 W1 split into the per-edge rows g_xd [E, fx], g_xs [E, fx] and g_ea [E, fe] of the
// tile's `valid` edges; with relu_edge, g_ea is cut where the tile's ReLU'd edge feature is 0
struct InputGradStore {
  const float* m;
  const int* tid;
  int valid, k, fx, fe, relu_edge;
  float* g_xd;
  float* g_xs;
  float* g_ea;
  template <int RE>
  __device__ __forceinline__ void operator()(int eg, int og, const float (&acc)[RE][4]) const {
#pragma unroll
    for (int r = 0; r < RE; ++r) {
      const int e = tile_edge(eg, r);
      if (e >= valid) continue;
      const long id = tid[e];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = 4 * og + c;
        float v = acc[r][c];
        if (i < fx) {
          g_xd[id * fx + i] = v;
        } else if (i < 2 * fx) {
          g_xs[id * fx + (i - fx)] = v;
        } else if (i < k) {
          if (relu_edge && !(m[i * BLD + e] > 0.f)) v = 0.f;
          g_ea[id * fe + (i - 2 * fx)] = v;
        }
      }
    }
  }
};

// part[r][c] (+)= sum_{e < FTE} g[r][e] a[c][e] for r < rows, c < cols (g, a: k-major tiles;
// part [rows][cols], this block's slice of the partials in device memory). A warp takes a block
// of 4R rows x 32 columns: lane (q = lane / 8, l = lane % 8) the rows r0 + q + 4i (i < R) and
// the columns c0 + l + 8j (j < 4), and per 4 edges R + 4 float4 loads feed 16 R FMAs; the loads
// of g are broadcasts, those of a hit 8 consecutive rows 4 banks apart. Each entry's tile sum
// runs over e ascending from 0.f; the block's first tile writes it to the partial, and every
// later tile's sum is added there by the L2 (red.global.add.f32, a rounded f32 add). A thread's
// entries depend on threadIdx and the widths only, so each partial entry has one writer, whose
// adds keep its program order (tile order): the order of every sum is fixed, and a second
// launch gives the same bits. (A read-modify-write of the partial through the SM was slower on
// the H100.)
template <int R>
__device__ __forceinline__ void weight_grad(const float* __restrict__ g, int rows,
                                            const float* __restrict__ a, int cols,
                                            float* __restrict__ part, bool first) {
  const int lane = threadIdx.x % 32;
  const int q = lane / 8, l = lane % 8;
  const int ncb = (cols + 31) / 32;
  const int units = (rows + 4 * R - 1) / (4 * R) * ncb;
  for (int u = threadIdx.x / 32; u < units; u += blockDim.x / 32) {
    const int r0 = (u / ncb) * 4 * R + q;
    const int c0 = (u % ncb) * 32 + l;
    int row[R], col[4];
    bool rok[R], cok[4];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      row[i] = r0 + 4 * i;
      rok[i] = row[i] < rows;
      if (!rok[i]) row[i] = 0;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      col[j] = c0 + 8 * j;
      cok[j] = col[j] < cols;
      if (!cok[j]) col[j] = 0;
    }
    float acc[R][4];
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    }
#pragma unroll 2
    for (int e = 0; e < FTE; e += 4) {
      float4 gv[R], av[4];
#pragma unroll
      for (int i = 0; i < R; ++i) gv[i] = *reinterpret_cast<const float4*>(g + row[i] * BLD + e);
#pragma unroll
      for (int j = 0; j < 4; ++j) av[j] = *reinterpret_cast<const float4*>(a + col[j] * BLD + e);
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(gv[i].x, av[j].x, acc[i][j]);
          acc[i][j] = fmaf(gv[i].y, av[j].y, acc[i][j]);
          acc[i][j] = fmaf(gv[i].z, av[j].z, acc[i][j]);
          acc[i][j] = fmaf(gv[i].w, av[j].w, acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!(rok[i] && cok[j])) continue;
        float* entry = part + (long)row[i] * cols + col[j];
        if (first) {
          *entry = acc[i][j];
        } else {
          atomicAdd(entry, acc[i][j]);  // result unused: compiled to red.global.add.f32
        }
      }
    }
  }
}

// dW (+)= g^T a with the row block (32 or 16 rows a warp) that takes the fewest rounds, and
// db (+)= the row sums of g, each over e ascending from 0.f
__device__ __forceinline__ void weight_and_bias_grad(const float* g, int rows, const float* a,
                                                     int cols, float* part_w, float* part_b,
                                                     bool first) {
  const int warps = blockDim.x / 32;
  const int ncb = (cols + 31) / 32;
  const int rounds8 = ((rows + 31) / 32 * ncb + warps - 1) / warps;
  const int rounds4 = ((rows + 15) / 16 * ncb + warps - 1) / warps;
  if (2 * rounds8 <= rounds4) {
    weight_grad<8>(g, rows, a, cols, part_w, first);
  } else {
    weight_grad<4>(g, rows, a, cols, part_w, first);
  }
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    float s = 0.f;
    for (int e = 0; e < FTE; e += 4) {
      const float4 v = *reinterpret_cast<const float4*>(g + r * BLD + e);
      s += v.x;
      s += v.y;
      s += v.z;
      s += v.w;
    }
    part_b[r] = first ? s : part_b[r] + s;
  }
}

// The backward, persistent: blocks take tiles of FTE unmasked edges in turn (ids[:count], as in
// the forward), and masked edges get zero rows of g_xd, g_xs and g_ea without any MLP work. Per
// tile: the recompute of h1 and h2 through the forward's dense_tile (the forward's activations
// bit for bit); g_et = g_e' + g_agg[dst]; then three phases, each an input-gradient product and
// a weight-gradient product that read the same tiles:
//   1. g_h2 = (g_et W3) * [h2 > 0];  dW3 (+)= g_et^T h2, db3 (+)= sum g_et
//   2. g_h1 = (g_h2 W2) * [h1 > 0] over h2;  dW2 (+)= g_h2^T h1, db2 (+)= sum g_h2
//   3. g_m = g_h1 W1 -> g_xd, g_xs, g_ea;  dW1 (+)= g_h1^T m, db1 (+)= sum g_h1
// Phase 3 reads neither h1 nor g_h2 nor g_et, so the next tile's gather (cp.async) lands in
// their buffers while it runs, and the four big buffers rotate roles from tile to tile. W2 is
// staged where W2_SHARED; W1^T, W1 (rows padded to k4), W2^T and W3 are read through L1/L2.
// SAVED (row #8, kernel D32) gathers the endpoint rows from gd = x[dst], gs = x[src], which the
// saving forward wrote; every output is then bitwise the recomputing backward's.
template <bool W2_SHARED, bool SAVED>
__global__ void __launch_bounds__(THREADS, 1)
edge_mlp_bwd_kernel(const float* __restrict__ x, const float* __restrict__ gd,
                    const float* __restrict__ gs, const float* __restrict__ ea,
                    const int* __restrict__ src, const int* __restrict__ dst,
                    const int* __restrict__ ids, const int* __restrict__ count_ptr,
                    const float* __restrict__ w1t, const float* __restrict__ w1p,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const float* __restrict__ w2t, const float* __restrict__ b2,
                    const float* __restrict__ w3,
                    const float* __restrict__ g_eout, const float* __restrict__ g_agg_e,
                    float* __restrict__ g_xd, float* __restrict__ g_xs,
                    float* __restrict__ g_ea, float* __restrict__ partial, int n_edges, int fx,
                    int fe, int h, int fo, int relu_edge) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int k = 2 * fx + fe;
  const int k4 = (k + 3) & ~3;
  const int kh = k > h ? (k > fo ? k : fo) : (h > fo ? h : fo);
  float* big = smem;                                      // [4][kh][BLD]
  float* ge = big + 4 * kh * BLD;                         // [fo][BLD]: g_e', then g_et
  float* sw2 = ge + fo * BLD;                             // [h][h] (W2_SHARED)
  int* tids = reinterpret_cast<int*>(sw2 + (W2_SHARED ? h * h : 0));  // [2][FTE]

  const int count = *count_ptr;
  const int n_tiles = (count + FTE - 1) / FTE;
  // roles of the big buffers: m, h1 (on arrival: g_agg[dst]), h2 then g_h1, g_h2
  int im = 0, ia = 1, ib = 2, ic = 3, buf = 0;
  if ((int)blockIdx.x < n_tiles) {  // the first tile's copies run under the staging below
    gather_tile<BLD, SAVED>(x, gd, gs, ea, src, dst, ids, count, blockIdx.x, fx, fe,
                            big + im * kh * BLD, tids);
    gather_cotangents(g_eout, g_agg_e, ids, count, blockIdx.x, fo, ge, big + ia * kh * BLD);
  }
  if (W2_SHARED) {
    for (int i = threadIdx.x; i < h * h; i += blockDim.x) sw2[i] = w2[i];
  }
  // masked edges (ids[count:]): zero rows, a warp a row
  const int warps = gridDim.x * (blockDim.x / 32);
  for (int r = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32; r < n_edges - count; r += warps) {
    const long edge = __ldg(ids + count + r);
    for (int c = threadIdx.x % 32; c < fx; c += 32) {
      g_xd[edge * fx + c] = 0.f;
      g_xs[edge * fx + c] = 0.f;
    }
    for (int c = threadIdx.x % 32; c < fe; c += 32) g_ea[edge * fe + c] = 0.f;
  }

  float* pw1 = partial + (long)blockIdx.x * grad_floats(k, h, fo);
  float* pb1 = pw1 + (long)h * k;
  float* pw2 = pb1 + h;
  float* pb2 = pw2 + (long)h * h;
  float* pw3 = pb2 + h;
  float* pb3 = pw3 + (long)fo * h;
  const float* w2r = W2_SHARED ? sw2 : w2;

  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const bool first = t == (int)blockIdx.x;
    float* m = big + im * kh * BLD;
    float* h1 = big + ia * kh * BLD;
    float* h2 = big + ib * kh * BLD;
    float* gh2 = big + ic * kh * BLD;
    const int* tid = tids + buf * FTE;
    cp_async_wait<0>();
    {  // this thread's own copies, visible to it now: g_et = g_e' + g_agg[dst], relu(ea)
      const int e = threadIdx.x % FTE;
      for (int c = threadIdx.x / FTE; c < fo; c += blockDim.x / FTE) ge[c * BLD + e] += h1[c * BLD + e];
      if (relu_edge) {
        for (int c = threadIdx.x / FTE; c < k; c += blockDim.x / FTE) {
          if (c >= 2 * fx) m[c * BLD + e] = fmaxf(m[c * BLD + e], 0.f);
        }
      }
    }
    __syncthreads();  // the tile's inputs and (first tile) W2 are staged
    const int valid = min(FTE, count - t * FTE);
    dense<true, true, BLD>(m, k, w1t, b1, h, h1, nullptr, 0, nullptr);
    __syncthreads();
    dense<true, true, BLD>(h1, h, w2t, b2, h, h2, nullptr, 0, nullptr);
    __syncthreads();
    grad_product_any<true>(ge, fo, w3, h, MaskedStore{h2, gh2});
    weight_and_bias_grad(ge, fo, h2, h, pw3, pb3, first);
    __syncthreads();
    grad_product_any<!W2_SHARED>(gh2, h, w2r, h, MaskedStore{h1, h2});  // g_h1 over h2
    weight_and_bias_grad(gh2, h, h1, h, pw2, pb2, first);
    __syncthreads();  // h1, g_h2 and g_et are free for the next tile's copies
    const int next = t + gridDim.x;
    if (next < n_tiles) {
      gather_tile<BLD, SAVED>(x, gd, gs, ea, src, dst, ids, count, next, fx, fe, h1,
                              tids + (buf ^ 1) * FTE);
      gather_cotangents(g_eout, g_agg_e, ids, count, next, fo, ge, gh2);
    }
    grad_product_any<true>(h2, h, w1p, k4,
                           InputGradStore{m, tid, valid, k, fx, fe, relu_edge, g_xd, g_xs, g_ea});
    weight_and_bias_grad(h2, h, m, k, pw1, pb1, first);
    // next tile: m in h1's buffer, g_agg[dst] in g_h2's (its h1's); the others are free once
    // every thread has passed the next tile's first barrier
    const int old_m = im;
    im = ia;
    ia = ic;
    ic = ib;
    ib = old_m;
    buf ^= 1;
  }
}

// Shared-memory bytes of a kernel whose first layout needs `resident` bytes and second `wide`:
// the first where it fits one block's opt-in limit, else the second. Sets *fits to whether the
// first does (the forward: W1 staged; the backward: W2 staged).
inline size_t pick_layout(long resident, long wide, bool* fits) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *fits = resident * (long)sizeof(float) <= optin;
  return (size_t)(*fits ? resident : wide) * sizeof(float);
}

template <bool W1_SHARED, bool SAVE>
cudaError_t launch_fwd(const float* x, const float* ea, const int* edge_index,
                       const int* ids, const int* count, const float* w1,
                       const float* w1t, const float* b1, const float* w2, const float* b2,
                       const float* w3, const float* b3, float* e_out, float* gd, float* gs,
                       int n_edges, int fx, int fe, int h, int fo, int relu_edge, size_t smem,
                       cudaStream_t stream) {
  auto kernel = edge_mlp_kernel<W1_SHARED, SAVE>;
  // widths whose tiles exceed one block's shared memory even so fail here; the error is
  // returned, and cleared so that it does not resurface in a later call's cudaGetLastError()
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  if (n_edges == 0) return cudaSuccess;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, FTHREADS, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int tiles = (n_edges + FTE - 1) / FTE;  // at most: the masked edges take no tile
  const int grid = tiles < sms * per_sm ? tiles : sms * per_sm;
  kernel<<<grid, FTHREADS, smem, stream>>>(x, ea, edge_index, edge_index + n_edges, ids,
                                           count, w1, w1t, b1, w2, b2, w3, b3, e_out, gd, gs,
                                           n_edges, fx, fe, h, fo, relu_edge);
  return cudaGetLastError();
}

template <bool W2_SHARED, bool SAVED>
cudaError_t launch_bwd(const float* x, const float* gd, const float* gs, const float* ea,
                       const int* edge_index, const int* ids, const int* count, const float* w1t,
                       const float* w1p, const float* b1, const float* w2, const float* w2t,
                       const float* b2, const float* w3, const float* g_eout,
                       const float* g_agg_e, float* g_xd, float* g_xs, float* g_ea,
                       float* partial, int n_edges, int fx, int fe, int h, int fo, int relu_edge,
                       int blocks, size_t smem, cudaStream_t stream) {
  auto kernel = edge_mlp_bwd_kernel<W2_SHARED, SAVED>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  if (blocks > 0) {
    kernel<<<blocks, THREADS, smem, stream>>>(x, gd, gs, ea, edge_index, edge_index + n_edges,
                                              ids, count, w1t, w1p, b1, w2, w2t, b2, w3, g_eout,
                                              g_agg_e, g_xd, g_xs, g_ea, partial, n_edges, fx, fe,
                                              h, fo, relu_edge);
  }
  return cudaGetLastError();
}

template <bool SAVE>
int fwd(const float* x, const float* ea, const int* edge_index, const int* ids, const int* count,
        const float* w1, const float* w1t, const float* b1, const float* w2, const float* b2,
        const float* w3, const float* b3, float* e_out,
        float* gd, float* gs, int n_edges, int fx, int fe, int h, int fo, int relu_edge,
        void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int k = 2 * fx + fe;
  bool w1_shared = true;
  const size_t smem = pick_layout(smem_floats(k, h, fo, true), smem_floats(k, h, fo, false),
                                  &w1_shared);
  if (!w1_shared && w1t == nullptr) return cudaErrorInvalidValue;
  auto launch = w1_shared ? launch_fwd<true, SAVE> : launch_fwd<false, SAVE>;
  return launch(x, ea, edge_index, ids, count, w1, w1t, b1, w2, b2, w3, b3, e_out, gd, gs,
                n_edges, fx, fe, h, fo, relu_edge, smem, stream);
}

template <bool SAVED>
int bwd(const float* x, const float* gd, const float* gs, const float* ea, const int* edge_index,
        const int* ids, const int* count, const float* w1t, const float* w1p, const float* b1,
        const float* w2, const float* w2t, const float* b2, const float* w3,
        const float* g_eout, const float* g_agg_e, float* g_xd, float* g_xs, float* g_ea,
        float* partial, float* grads, int n_edges, int fx, int fe, int h, int fo, int relu_edge,
        int max_blocks, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int k = 2 * fx + fe;
  if (max_blocks < 1) return cudaErrorInvalidValue;
  const int tiles = (n_edges + FTE - 1) / FTE;  // at most: the masked edges take no tile
  const int blocks = tiles < max_blocks ? tiles : max_blocks;
  bool w2_shared = true;
  const size_t smem = pick_layout(bwd_smem_floats(k, h, fo, true),
                                  bwd_smem_floats(k, h, fo, false), &w2_shared);
  auto launch = w2_shared ? launch_bwd<true, SAVED> : launch_bwd<false, SAVED>;
  cudaError_t err = launch(x, gd, gs, ea, edge_index, ids, count, w1t, w1p, b1, w2, w2t, b2, w3,
                           g_eout, g_agg_e, g_xd, g_xs, g_ea, partial, n_edges, fx, fe, h, fo,
                           relu_edge, blocks, smem, stream);
  if (err != cudaSuccess) return err;
  const long p = grad_floats(k, h, fo);
  fixed_order_sum::sum_partials_kernel<<<(unsigned)((p + THREADS - 1) / THREADS), THREADS, 0,
                                          stream>>>(partial, blocks, FTE, count, p, grads);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// 1 where the forward stages W1 in shared memory at these widths, 0 where it reads W1^T from
// device memory: the wrapper builds W1^T only then.
int fused_relational_w1_shared(int fx, int fe, int h, int fo) {
  bool w1_shared = true;
  pick_layout(smem_floats(2 * fx + fe, h, fo, true), 0, &w1_shared);
  return w1_shared ? 1 : 0;
}

// 1 where the forward (backward = 0) or the backward (1) fits one block's shared memory at these
// widths in the layout pick_layout chooses, 0 where neither of its layouts does: the wrapper then
// takes csrc/fused_relational_wide.cu.
int fused_relational_fits(int fx, int fe, int h, int fo, int backward) {
  const int k = 2 * fx + fe;
  bool first = true;
  const size_t bytes = backward ? pick_layout(bwd_smem_floats(k, h, fo, true),
                                              bwd_smem_floats(k, h, fo, false), &first)
                                : pick_layout(smem_floats(k, h, fo, true),
                                              smem_floats(k, h, fo, false), &first);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes <= (size_t)optin ? 1 : 0;
}

// edge_index is [2, E] int32 (row 0 source, row 1 target); ids [E] int32 the edge ids,
// unmasked in edge order first (*count of them), then the masked (device memory: the
// wrapper's stable partition of the mask);
// weights in [out][in] layout, and w1t = W1^T [K][H], read in place of a staged copy where W1
// does not fit shared memory (null elsewhere). Writes e_out [E, Fo]. Returns cudaGetLastError().
int fused_relational_fwd(const float* x, const float* ea, const int* edge_index,
                         const int* ids, const int* count, const float* w1,
                         const float* w1t, const float* b1, const float* w2, const float* b2,
                         const float* w3, const float* b3, float* e_out, int n_edges, int fx,
                         int fe, int h, int fo, int relu_edge, void* stream_ptr) {
  return fwd<false>(x, ea, edge_index, ids, count, w1, w1t, b1, w2, b2, w3, b3, e_out,
                    nullptr, nullptr, n_edges, fx, fe, h, fo, relu_edge, stream_ptr);
}

// The forward that also writes the gathered endpoint rows gd = x[dst], gs = x[src] [E, Fx] of
// every edge (row #7 in f32, kernel C32); e_out is bitwise the forward's.
int fused_relational_fwd_save(const float* x, const float* ea, const int* edge_index,
                              const int* ids, const int* count,
                              const float* w1, const float* w1t, const float* b1,
                              const float* w2, const float* b2, const float* w3, const float* b3,
                              float* e_out, float* gd, float* gs, int n_edges, int fx, int fe,
                              int h, int fo, int relu_edge, void* stream_ptr) {
  return fwd<true>(x, ea, edge_index, ids, count, w1, w1t, b1, w2, b2, w3, b3, e_out, gd,
                   gs, n_edges, fx, fe, h, fo, relu_edge, stream_ptr);
}

// Backward. ids / count as in the forward; w1t = W1^T [K][H], w1p = W1 [H][K4] (rows padded
// with zeros to K4 = K rounded up to 4), w2 = W2 [H][H], w2t = W2^T, w3 = W3 [Fo][H], every one
// 16-byte aligned; g_eout [E, Fo]; g_agg_e [E, Fo] = g_agg[dst] (sorted_gather); writes g_xd,
// g_xs [E, Fx] (per-edge gradients of x_dst and x_src), g_ea [E, Fe], and grads [P] packed as
// w1, b1, w2, b2, w3, b3 ([out][in]); partial is [max_blocks, P] scratch. The edge kernel is
// persistent with min(tiles of E, max_blocks) blocks; the wrapper passes the SM count (one block
// an SM fits). Returns cudaGetLastError(), or the error of widths whose tiles do not fit one
// block's shared memory even with W2 in device memory.
int fused_relational_bwd(const float* x, const float* ea, const int* edge_index, const int* ids,
                         const int* count, const float* w1t, const float* w1p, const float* b1,
                         const float* w2, const float* w2t, const float* b2, const float* w3,
                         const float* g_eout, const float* g_agg_e, float* g_xd, float* g_xs,
                         float* g_ea, float* partial, float* grads, int n_edges, int fx, int fe,
                         int h, int fo, int relu_edge, int max_blocks, void* stream_ptr) {
  return bwd<false>(x, nullptr, nullptr, ea, edge_index, ids, count, w1t, w1p, b1, w2, w2t, b2,
                    w3, g_eout, g_agg_e, g_xd, g_xs, g_ea, partial, grads, n_edges, fx, fe, h, fo,
                    relu_edge, max_blocks, stream_ptr);
}

// The backward from the rows gd = x[dst], gs = x[src] [E, Fx] that fused_relational_fwd_save
// wrote, in place of x (row #8 in f32, kernel D32); every output is bitwise the backward's.
int fused_relational_bwd_saved(const float* gd, const float* gs, const float* ea,
                               const int* edge_index, const int* ids, const int* count,
                               const float* w1t, const float* w1p, const float* b1,
                               const float* w2, const float* w2t, const float* b2,
                               const float* w3, const float* g_eout, const float* g_agg_e,
                               float* g_xd, float* g_xs, float* g_ea, float* partial,
                               float* grads, int n_edges, int fx, int fe, int h, int fo,
                               int relu_edge, int max_blocks, void* stream_ptr) {
  return bwd<true>(nullptr, gd, gs, ea, edge_index, ids, count, w1t, w1p, b1, w2, w2t, b2, w3,
                   g_eout, g_agg_e, g_xd, g_xs, g_ea, partial, grads, n_edges, fx, fe, h, fo,
                   relu_edge, max_blocks, stream_ptr);
}

}  // extern "C"
