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
//    x[dst], x[src] of every edge for the backward that reads them (row #8, kernel D32).
// Backward design (tiles of TE = 32 edges, 256 threads). It needs every weight in both
// orientations (W for the recompute, W^T for the input gradients) and somewhere to sum 33k
// weight-gradient values, which together exceed one block's 227 KB. So:
//  * the weights are staged ONCE in PyTorch's [out][in] layout with rows padded to an odd stride
//    (130 KB at the serving widths). A thread owns outputs strided by a quarter of the width, so
//    a warp reads consecutive rows (recompute: contraction along a row) or consecutive columns
//    (input gradients: contraction down a column) without bank conflicts, both with scalar loads;
//  * per tile of TE = 32 edges, everything lives in shared memory (65 KB): the gathered input,
//    h1, h2 (then g_h1), g_h2 and g_et = mask * (g_e' + g_agg[dst]). The recompute repeats the
//    forward's FMA order, so it gives the forward's activations bit for bit. Nothing of the
//    forward is saved between the passes, as in the TPU kernel;
//  * weight gradients: each block adds its tiles' sums (each tile's from 0) into its own slice
//    of a [blocks, P] partial buffer in device memory (L2-resident, 17 MB at 132 blocks). Each
//    entry belongs to one thread for the whole launch (a 4 x 4 register tile per 32-edge step), so
//    the read-modify-write needs no atomics and no barrier. A second kernel sums the partials over
//    blocks in block order: three levels of summation (tile, block, grid), not one long chain;
//  * node gradients: the kernel writes the per-edge dst and src parts of the input gradient; the
//    wrapper sums them per node with csr_segment.cu's segment-sum, in target order and in
//    source order (through src_perm), in a fixed order (see csr_segment.cu);
//  * so there are no float atomics anywhere: two launches on the same inputs give the same bits.
// Wide layers. When the weights and tiles exceed one block's shared memory (ec.yml's K = 192,
// H = 128, Fo = 64: 321.8 KiB forward, 274.9 KiB backward, against 227 KiB), both take a second
// layout: W1, the [H, K] block and the largest, stays in device memory (forward 225.8 KiB,
// backward 178.4 KiB of shared memory at those widths; the forward at the GraphTCN's widths
// needs 225.6 KiB with W1 staged). It is read where a warp's lanes take
// consecutive addresses: W1^T ([K][H], transposed by the wrapper) for the forward and the
// backward's recompute, W1 ([H][K]) for the backward's input gradients. Every width that fits
// keeps the first layout. Each output's FMA order is the same in both layouts, so they give the
// same bits. The saved-rows backward (D32) reads x[dst], x[src] from the rows C32 wrote.
// The TPU's slab windows, one-hot MXU gathers and 8-sublane index tiles are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TE = 32;        // edges per tile of the backward
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
// chain of fmaf over k ascending from 0.f (the backward's recompute_layer has the same order).
// A thread owns RE edges x RO outputs: edges {4 eg + r} (and {32 + 4 eg + r} when RE = 8),
// outputs {4 og + c} (and {m/2 + 4 og + c} when RO = 8), so each k costs RE/4 + RO/4 float4
// loads for RE RO FMAs. wt is [kin][m], in shared memory or (W_GLOBAL) in device memory.
// HIDDEN: out[j][e] = relu(y + b[j]). Else the output layer: e_out[ids[e]][j] = y + b[j] for
// the tile's `valid` edges.
template <int RE, int RO, bool W_GLOBAL, bool HIDDEN>
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
      const float4 a0 = *reinterpret_cast<const float4*>(arow + kk * FTE);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      if constexpr (RE == 8) {
        const float4 a1 = *reinterpret_cast<const float4*>(arow + kk * FTE + 32);
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
          *reinterpret_cast<float4*>(out + j * FTE + 32 * q + 4 * eg) =
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
template <bool W_GLOBAL, bool HIDDEN>
__device__ __forceinline__ void dense(const float* in, int kin, const float* wt, const float* b,
                                      int m, float* out, const int* ids, int valid,
                                      float* e_out) {
  if (m >= 128) {
    dense_tile<8, 4, W_GLOBAL, HIDDEN>(in, kin, wt, b, m, out, ids, valid, e_out);
  } else {
    dense_tile<4, 4, W_GLOBAL, HIDDEN>(in, kin, wt, b, m, out, ids, valid, e_out);
  }
}

// shared memory of the forward (floats); without w1_shared, W1^T stays in device memory
__host__ __device__ inline long smem_floats(int k, int h, int fo, bool w1_shared) {
  const long weights = (w1_shared ? (long)k * h : 0L) + h + (long)h * h + h + (long)h * fo + fo;
  const long acts = 2L * FTE * (k > h ? k : h) + (long)FTE * h;  // two input tiles (one is h2), h1
  return weights + acts + 2L * FTE;                              // + the tiles' edge ids
}

// Issue the copies of tile t's inputs [x[dst], x[src], ea] into `a` (k-major) and its edge ids
// into `tid`; rows past the `count` unmasked edges are zeros. Consecutive threads take
// consecutive edges of one input column, so the shared-memory side is conflict-free.
__device__ __forceinline__ void gather_tile(const float* __restrict__ x,
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
  const float* xd = x + (long)(live ? __ldg(dst + edge) : 0) * fx;
  const float* xs = x + (long)(live ? __ldg(src + edge) : 0) * fx;
  const float* er = ea + (long)edge * fe;
  for (int c = threadIdx.x / FTE; c < k; c += blockDim.x / FTE) {
    float* slot = a + c * FTE + e;
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
    gather_tile(x, ea, src, dst, ids, count, blockIdx.x, fx, fe, abuf, tids);
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
      gather_tile(x, ea, src, dst, ids, count, next, fx, fe, abuf + (buf ^ 1) * kh * FTE,
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
__host__ __device__ inline int odd_ld(int n) { return n | 1; }

// shared memory of the backward; without w1_shared, W1 stays in device memory
__host__ __device__ inline long bwd_smem_floats(int k, int h, int fo, bool w1_shared) {
  const long ldk = odd_ld(k), ldh = odd_ld(h), ldo = odd_ld(fo);
  const long weights = (w1_shared ? h * ldk : 0L) + h * ldh + fo * ldh + 2L * h;
  const long tiles = TE * (ldk + 3 * ldh + ldo);
  return weights + tiles;
}

// weight-gradient values, packed as w1 [h][k], b1 [h], w2 [h][h], b2 [h], w3 [fo][h], b3 [fo]
__host__ __device__ inline long grad_floats(int k, int h, int fo) {
  return (long)h * k + h + (long)h * h + h + (long)fo * h + fo;
}

// out[e][j] = relu(sum_k in[e][k] w(j, k) + b[j]) for j < m (m % 4 == 0), w(j, k) at
// w[j * so + k * si]: [m][ldw] is (ldw, 1), a transposed [kin][m] is (1, m).
// Same FMA order as the forward's dense_tile, so the same bits as the forward's activations.
__device__ __forceinline__ void recompute_layer(const float* __restrict__ in, int ld_in, int kin,
                                                const float* __restrict__ w, int so, int si,
                                                const float* __restrict__ b, int m,
                                                float* __restrict__ out, int ld_out) {
  const int groups = m / 4;
  const int units = (TE / 4) * groups;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int jg = u % groups;
    const int e0 = (u / groups) * 4;
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    }
    for (int kk = 0; kk < kin; ++kk) {
      float a[4], wv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = in[(e0 + r) * ld_in + kk];
#pragma unroll
      for (int c = 0; c < 4; ++c) wv[c] = w[(long)(jg + groups * c) * so + (long)kk * si];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], wv[c], acc[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = jg + groups * c;
        out[(e0 + r) * ld_out + j] = fmaxf(acc[r][c] + b[j], 0.f);
      }
    }
  }
}

// v[e][i] = sum_j g[e][j] w[j][i] for i < kin (contraction down the columns of w [m][ldw]),
// zeroed where act[e][i] <= 0 when act is given; store(e, i, v) writes it.
template <typename Store>
__device__ __forceinline__ void backprop_layer(const float* __restrict__ g, int ld_g, int m,
                                               const float* __restrict__ w, int ldw, int kin,
                                               const float* __restrict__ act, int ld_act,
                                               Store store) {
  const int groups = (kin + 3) / 4;
  const int units = (TE / 4) * groups;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int ig = u % groups;
    const int e0 = (u / groups) * 4;
    int col[4];
    bool ok[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      col[c] = ig + groups * c;
      ok[c] = col[c] < kin;
      if (!ok[c]) col[c] = 0;
    }
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    }
    for (int j = 0; j < m; ++j) {
      float a[4], wv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = g[(e0 + r) * ld_g + j];
#pragma unroll
      for (int c = 0; c < 4; ++c) wv[c] = w[j * ldw + col[c]];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], wv[c], acc[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (!ok[c]) continue;
        float v = acc[r][c];
        if (act != nullptr && !(act[(e0 + r) * ld_act + col[c]] > 0.f)) v = 0.f;
        store(e0 + r, col[c], v);
      }
    }
  }
}

// part_w[j][i] (+)= sum_e g[e][j] a[e][i] (j < m, i < kin), part_b[j] (+)= sum_e g[e][j], over the
// tile's TE rows; `first` starts from zero. Each tile's sum starts from 0 and is then added to the
// partial (two-level summation: a block's ~2000 edges do not run through one accumulator). The
// entries a thread touches depend on threadIdx only.
__device__ __forceinline__ void weight_grad(const float* __restrict__ g, int ld_g, int m,
                                            const float* __restrict__ a, int ld_a, int kin,
                                            float* __restrict__ part_w,
                                            float* __restrict__ part_b, bool first) {
  const int ign = (kin + 3) / 4;
  const int jgn = m / 4;
  const int units = ign * jgn;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int ig = u % ign;
    const int jg = u / ign;
    int col[4];
    bool ok[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      col[c] = ig + ign * c;
      ok[c] = col[c] < kin;
      if (!ok[c]) col[c] = 0;
    }
    // the partial is read before the tile's FMAs, so its latency hides behind them
    float acc[4][4], prev[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[r][c] = 0.f;
        prev[r][c] = (first || !ok[c]) ? 0.f : part_w[(long)(jg + jgn * r) * kin + col[c]];
      }
    }
    for (int e = 0; e < TE; ++e) {
      float gv[4], av[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) gv[r] = g[e * ld_g + jg + jgn * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) av[c] = a[e * ld_a + col[c]];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(gv[r], av[c], acc[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (ok[c]) part_w[(long)(jg + jgn * r) * kin + col[c]] = first ? acc[r][c] : prev[r][c] + acc[r][c];
      }
    }
  }
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    float s = 0.f;
    for (int e = 0; e < TE; ++e) s += g[e * ld_g + j];
    part_b[j] = first ? s : part_b[j] + s;
  }
}

// SAVED (row #8, kernel D32): the tile's endpoint rows come from gd = x[dst], gs = x[src], which
// the saving forward wrote, in place of the gather from x; everything else is the same, so every
// output is bitwise the recomputing backward's.
template <bool W1_SHARED, bool SAVED>
__global__ void __launch_bounds__(THREADS)
edge_mlp_bwd_kernel(const float* __restrict__ x, const float* __restrict__ gd,
                    const float* __restrict__ gs, const float* __restrict__ ea,
                    const int* __restrict__ src, const int* __restrict__ dst,
                    const uint8_t* __restrict__ mask,
                    const float* __restrict__ w1, const float* __restrict__ w1t_dev,
                    const float* __restrict__ b1,
                    const float* __restrict__ w2, const float* __restrict__ b2,
                    const float* __restrict__ w3,
                    const float* __restrict__ g_eout, const float* __restrict__ g_agg_e,
                    float* __restrict__ g_xd, float* __restrict__ g_xs,
                    float* __restrict__ g_ea, float* __restrict__ partial, int n_edges, int fx,
                    int fe, int h, int fo, int relu_edge) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int k = 2 * fx + fe;
  const int ldk = odd_ld(k), ldh = odd_ld(h), ldo = odd_ld(fo);
  float* sw1 = smem;             // [h][ldk]   W1 as [out][in] (W1_SHARED)
  float* sw2 = sw1 + (W1_SHARED ? h * ldk : 0);  // [h][ldh]
  float* sw3 = sw2 + h * ldh;    // [fo][ldh]
  float* sb1 = sw3 + fo * ldh;   // [h]
  float* sb2 = sb1 + h;          // [h]
  float* bm = sb2 + h;           // [TE][ldk]  gathered [x_dst, x_src, ea]
  float* bh1 = bm + TE * ldk;    // [TE][ldh]  h1
  float* bh2 = bh1 + TE * ldh;   // [TE][ldh]  h2, then g_h1
  float* bgh2 = bh2 + TE * ldh;  // [TE][ldh]  g_h2
  float* bget = bgh2 + TE * ldh; // [TE][ldo]  g_et

  if (W1_SHARED) {
    for (int i = threadIdx.x; i < h * k; i += blockDim.x) sw1[(i / k) * ldk + i % k] = w1[i];
  }
  // W1 as the layers read it: staged as [h][ldk], or in device memory, where the recompute reads
  // W1^T [k][h] and the input gradients W1 [h][k] (consecutive lanes, consecutive addresses)
  const float* w1r = W1_SHARED ? sw1 : w1t_dev;
  const int so1 = W1_SHARED ? ldk : 1, si1 = W1_SHARED ? 1 : h;
  const float* w1b = W1_SHARED ? sw1 : w1;
  const int ldw1 = W1_SHARED ? ldk : k;
  for (int i = threadIdx.x; i < h * h; i += blockDim.x) sw2[(i / h) * ldh + i % h] = w2[i];
  for (int i = threadIdx.x; i < fo * h; i += blockDim.x) sw3[(i / h) * ldh + i % h] = w3[i];
  for (int i = threadIdx.x; i < h; i += blockDim.x) {
    sb1[i] = b1[i];
    sb2[i] = b2[i];
  }

  float* pw1 = partial + (long)blockIdx.x * grad_floats(k, h, fo);
  float* pb1 = pw1 + (long)h * k;
  float* pw2 = pb1 + h;
  float* pb2 = pw2 + (long)h * h;
  float* pw3 = pb2 + h;
  float* pb3 = pw3 + (long)fo * h;

  const int n_tiles = (n_edges + TE - 1) / TE;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long t0 = (long)tile * TE;
    const bool first = tile == (int)blockIdx.x;
    __syncthreads();  // weights staged / previous tile's buffers consumed
    for (int i = threadIdx.x; i < TE * k; i += blockDim.x) {
      const int e = i / k;
      const int c = i % k;
      const long edge = t0 + e;
      float v = 0.f;
      if (edge < n_edges) {
        if (c < fx) {
          v = SAVED ? gd[edge * fx + c] : x[(long)dst[edge] * fx + c];
        } else if (c < 2 * fx) {
          v = SAVED ? gs[edge * fx + (c - fx)] : x[(long)src[edge] * fx + (c - fx)];
        } else {
          v = ea[edge * fe + (c - 2 * fx)];
          if (relu_edge) v = fmaxf(v, 0.f);
        }
      }
      bm[e * ldk + c] = v;
    }
    // g_et = mask * (g_e' + g_agg[dst]); zero past the last edge
    for (int i = threadIdx.x; i < TE * fo; i += blockDim.x) {
      const int e = i / fo;
      const int c = i % fo;
      const long edge = t0 + e;
      float v = 0.f;
      if (edge < n_edges && mask[edge]) v = g_eout[edge * fo + c] + g_agg_e[edge * fo + c];
      bget[e * ldo + c] = v;
    }
    __syncthreads();
    recompute_layer(bm, ldk, k, w1r, so1, si1, sb1, h, bh1, ldh);
    __syncthreads();
    recompute_layer(bh1, ldh, h, sw2, ldh, 1, sb2, h, bh2, ldh);
    __syncthreads();
    // g_h2 = (g_et W3) * (h2 > 0); dW3 += g_et^T h2
    backprop_layer(bget, ldo, fo, sw3, ldh, h, bh2, ldh,
                   [&](int e, int i, float v) { bgh2[e * ldh + i] = v; });
    weight_grad(bget, ldo, fo, bh2, ldh, h, pw3, pb3, first);
    __syncthreads();
    // g_h1 = (g_h2 W2) * (h1 > 0) over h2's buffer; dW2 += g_h2^T h1
    backprop_layer(bgh2, ldh, h, sw2, ldh, h, bh1, ldh,
                   [&](int e, int i, float v) { bh2[e * ldh + i] = v; });
    weight_grad(bgh2, ldh, h, bh1, ldh, h, pw2, pb2, first);
    __syncthreads();
    // g_m = g_h1 W1, split into the dst, src and edge blocks; dW1 += g_h1^T m
    backprop_layer(bh2, ldh, h, w1b, ldw1, k, nullptr, 0, [&](int e, int i, float v) {
      const long edge = t0 + e;
      if (edge >= n_edges) return;
      if (i < fx) {
        g_xd[edge * fx + i] = v;
      } else if (i < 2 * fx) {
        g_xs[edge * fx + (i - fx)] = v;
      } else {
        if (relu_edge && !(bm[e * ldk + i] > 0.f)) v = 0.f;
        g_ea[edge * fe + (i - 2 * fx)] = v;
      }
    });
    weight_grad(bh2, ldh, h, bm, ldk, k, pw1, pb1, first);
  }
}

// out[i] = sum over b < blocks of partial[b][i], in block order
__global__ void __launch_bounds__(THREADS)
sum_partials_kernel(const float* __restrict__ partial, int blocks, long p,
                    float* __restrict__ out) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += partial[(long)b * p + i];
  out[i] = s;
}

// Shared-memory bytes of a kernel whose first layout needs `resident` bytes and second `wide`:
// the first where it fits one block's opt-in limit, else the second. Sets *w1_shared.
inline size_t pick_layout(long resident, long wide, bool* w1_shared) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *w1_shared = resident * (long)sizeof(float) <= optin;
  return (size_t)(*w1_shared ? resident : wide) * sizeof(float);
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

template <bool W1_SHARED, bool SAVED>
cudaError_t launch_bwd(const float* x, const float* gd, const float* gs, const float* ea,
                       const int* edge_index, const uint8_t* mask, const float* w1,
                       const float* w1t, const float* b1, const float* w2, const float* b2,
                       const float* w3, const float* g_eout, const float* g_agg_e, float* g_xd,
                       float* g_xs, float* g_ea, float* partial, int n_edges, int fx, int fe,
                       int h, int fo, int relu_edge, int blocks, size_t smem,
                       cudaStream_t stream) {
  auto kernel = edge_mlp_bwd_kernel<W1_SHARED, SAVED>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  if (blocks > 0) {
    kernel<<<blocks, THREADS, smem, stream>>>(x, gd, gs, ea, edge_index, edge_index + n_edges,
                                              mask, w1, w1t, b1, w2, b2, w3, g_eout, g_agg_e,
                                              g_xd, g_xs, g_ea, partial, n_edges, fx, fe, h, fo,
                                              relu_edge);
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
        const uint8_t* mask, const float* w1, const float* w1t, const float* b1, const float* w2,
        const float* b2, const float* w3, const float* g_eout, const float* g_agg_e, float* g_xd,
        float* g_xs, float* g_ea, float* partial, float* grads, int n_edges, int fx, int fe,
        int h, int fo, int relu_edge, int max_blocks, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int k = 2 * fx + fe;
  if (max_blocks < 1) return cudaErrorInvalidValue;
  const int tiles = (n_edges + TE - 1) / TE;
  const int blocks = tiles < max_blocks ? tiles : max_blocks;
  bool w1_shared = true;
  const size_t smem = pick_layout(bwd_smem_floats(k, h, fo, true),
                                  bwd_smem_floats(k, h, fo, false), &w1_shared);
  if (!w1_shared && w1t == nullptr) return cudaErrorInvalidValue;
  auto launch = w1_shared ? launch_bwd<true, SAVED> : launch_bwd<false, SAVED>;
  cudaError_t err = launch(x, gd, gs, ea, edge_index, mask, w1, w1t, b1, w2, b2, w3, g_eout,
                           g_agg_e, g_xd, g_xs, g_ea, partial, n_edges, fx, fe, h, fo, relu_edge,
                           blocks, smem, stream);
  if (err != cudaSuccess) return err;
  const long p = grad_floats(k, h, fo);
  sum_partials_kernel<<<(unsigned)((p + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      partial, blocks, p, grads);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// 1 where the forward (backward = 0) or the backward (1) stages W1 in shared memory at these
// widths, 0 where it reads W1^T from device memory: the wrapper builds W1^T only then.
int fused_relational_w1_shared(int fx, int fe, int h, int fo, int backward) {
  const int k = 2 * fx + fe;
  bool w1_shared = true;
  pick_layout(backward ? bwd_smem_floats(k, h, fo, true) : smem_floats(k, h, fo, true), 0,
              &w1_shared);
  return w1_shared ? 1 : 0;
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

// Backward. g_eout [E, Fo]; g_agg_e [E, Fo] = g_agg[dst] (sorted_gather); writes g_xd, g_xs
// [E, Fx] (per-edge gradients of x_dst and x_src), g_ea [E, Fe], and grads [P] packed as
// w1, b1, w2, b2, w3, b3 ([out][in]); w1t as in the forward; partial is [max_blocks, P] scratch.
// The edge kernel is persistent with min(tiles, max_blocks) blocks; the wrapper passes the SM
// count, since the kernel's shared memory leaves room for one block per SM at the model's
// widths. Returns cudaGetLastError(), or the error of widths whose shared memory does not fit
// one block even with W1 in device memory.
int fused_relational_bwd(const float* x, const float* ea, const int* edge_index,
                         const uint8_t* mask, const float* w1, const float* w1t, const float* b1,
                         const float* w2, const float* b2, const float* w3, const float* g_eout,
                         const float* g_agg_e, float* g_xd, float* g_xs, float* g_ea,
                         float* partial, float* grads, int n_edges, int fx, int fe, int h, int fo,
                         int relu_edge, int max_blocks, void* stream_ptr) {
  return bwd<false>(x, nullptr, nullptr, ea, edge_index, mask, w1, w1t, b1, w2, b2, w3, g_eout,
                    g_agg_e, g_xd, g_xs, g_ea, partial, grads, n_edges, fx, fe, h, fo, relu_edge,
                    max_blocks, stream_ptr);
}

// The backward from the rows gd = x[dst], gs = x[src] [E, Fx] that fused_relational_fwd_save
// wrote, in place of x (row #8 in f32, kernel D32); every output is bitwise the backward's.
int fused_relational_bwd_saved(const float* gd, const float* gs, const float* ea,
                               const int* edge_index, const uint8_t* mask, const float* w1,
                               const float* w1t, const float* b1, const float* w2,
                               const float* b2, const float* w3, const float* g_eout,
                               const float* g_agg_e, float* g_xd, float* g_xs, float* g_ea,
                               float* partial, float* grads, int n_edges, int fx, int fe, int h,
                               int fo, int relu_edge, int max_blocks, void* stream_ptr) {
  return bwd<true>(nullptr, gd, gs, ea, edge_index, mask, w1, w1t, b1, w2, b2, w3, g_eout,
                   g_agg_e, g_xd, g_xs, g_ea, partial, grads, n_edges, fx, fe, h, fo, relu_edge,
                   max_blocks, stream_ptr);
}

}  // extern "C"
