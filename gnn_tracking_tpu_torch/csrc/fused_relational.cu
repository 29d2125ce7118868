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
// Forward design (simple and exact first; tensor cores are later work):
//  * f32 FMA on the CUDA cores, persistent blocks (as many as fit, one per SM at these widths);
//  * each block stages W1, W2, W3 and the biases ONCE into shared memory, transposed to
//    [in][out] so that a warp reads consecutive outputs of one input row as float4;
//  * edges are processed in tiles of TE = 32: the tile's gathered inputs [x_dst, x_src, ea]
//    and both hidden activations live in shared memory only; each thread of a hidden layer owns
//    a 4-edge x 4-output register tile (16 FMA per 4 broadcast loads + 1 float4 load);
//  * the output layer writes e' straight to device memory, masked.
//
// Backward design. It needs every weight in both orientations (W for the recompute, W^T for the
// input gradients) and somewhere to sum 33k weight-gradient values, which together exceed one
// block's 227 KB. So:
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
//    source order (through src_perm), in edge order within each node;
//  * so there are no float atomics anywhere: two launches on the same inputs give the same bits.
// Wide layers. When the weights and tiles exceed one block's shared memory (ec.yml's K = 192,
// H = 128, Fo = 64: 233.5 KiB forward, 274.9 KiB backward, against 227 KiB), both take a second
// layout: W1, the [H, K] block and the largest, stays in device memory (forward 137.5 KiB,
// backward 178.4 KiB of shared memory at those widths). It is read where a warp's lanes take
// consecutive addresses: W1^T ([K][H], transposed by the wrapper) for the forward and the
// backward's recompute, W1 ([H][K]) for the backward's input gradients. Every width that fits
// keeps the first layout. Each output's FMA order is the same in both layouts, so they give the
// same bits.
// The TPU's slab windows, one-hot MXU gathers and 8-sublane index tiles are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TE = 32;        // edges per tile
constexpr int THREADS = 256;  // threads per block

// out[e][j] = act(sum_k in[e][k] * wt[k][j] + b[j]) for e < TE, j < m (m % 4 == 0).
// in: [TE][in_stride] shared, wt: [kin][m] shared (or in device memory), out: [TE][out_stride]
// shared.
template <int RE>
__device__ __forceinline__ void dense_smem(const float* __restrict__ in, int in_stride, int kin,
                                           const float* __restrict__ wt,
                                           const float* __restrict__ b, int m,
                                           float* __restrict__ out, int out_stride) {
  const int groups = m / 4;
  const int units = (TE / RE) * groups;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int jg = u % groups;
    const int e0 = (u / groups) * RE;
    float acc[RE][4];
#pragma unroll
    for (int r = 0; r < RE; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    }
    for (int kk = 0; kk < kin; ++kk) {
      const float4 w = *reinterpret_cast<const float4*>(wt + kk * m + 4 * jg);
#pragma unroll
      for (int r = 0; r < RE; ++r) {
        const float a = in[(e0 + r) * in_stride + kk];
        acc[r][0] = fmaf(a, w.x, acc[r][0]);
        acc[r][1] = fmaf(a, w.y, acc[r][1]);
        acc[r][2] = fmaf(a, w.z, acc[r][2]);
        acc[r][3] = fmaf(a, w.w, acc[r][3]);
      }
    }
#pragma unroll
    for (int r = 0; r < RE; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        out[(e0 + r) * out_stride + 4 * jg + c] = fmaxf(acc[r][c] + b[4 * jg + c], 0.f);
      }
    }
  }
}

// Output layer: e_out[t0 + e][j] = mask ? (in[e] . wt[:, j] + b[j]) : 0, straight to global.
__device__ __forceinline__ void dense_out(const float* __restrict__ in, int in_stride, int kin,
                                          const float* __restrict__ wt,
                                          const float* __restrict__ b, int m,
                                          const uint8_t* __restrict__ mask, long t0, int n_edges,
                                          float* __restrict__ e_out) {
  const int groups = m / 4;
  const int units = TE * groups;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int jg = u % groups;
    const int e = u / groups;
    const long edge = t0 + e;
    if (edge >= n_edges) continue;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int kk = 0; kk < kin; ++kk) {
      const float4 w = *reinterpret_cast<const float4*>(wt + kk * m + 4 * jg);
      const float a = in[e * in_stride + kk];
      acc.x = fmaf(a, w.x, acc.x);
      acc.y = fmaf(a, w.y, acc.y);
      acc.z = fmaf(a, w.z, acc.z);
      acc.w = fmaf(a, w.w, acc.w);
    }
    float4 v;
    if (mask[edge]) {
      v = make_float4(acc.x + b[4 * jg], acc.y + b[4 * jg + 1], acc.z + b[4 * jg + 2],
                      acc.w + b[4 * jg + 3]);
    } else {
      v = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    *reinterpret_cast<float4*>(e_out + edge * m + 4 * jg) = v;
  }
}

// shared memory of the forward; without w1_shared, W1 stays in device memory
__host__ __device__ inline long smem_floats(int k, int h, int fo, bool w1_shared) {
  const long weights = (w1_shared ? (long)k * h : 0L) + h + (long)h * h + h + (long)h * fo + fo;
  const long buf_a = (long)TE * ((k > h ? k : h) + 1);  // gathered input, then h2
  const long buf_b = (long)TE * (h + 1);                // h1
  return weights + buf_a + buf_b;
}

template <bool W1_SHARED>
__global__ void __launch_bounds__(THREADS)
edge_mlp_kernel(const float* __restrict__ x, const float* __restrict__ ea,
                const int* __restrict__ src, const int* __restrict__ dst,
                const uint8_t* __restrict__ mask,
                const float* __restrict__ w1, const float* __restrict__ w1t_dev,
                const float* __restrict__ b1,
                const float* __restrict__ w2, const float* __restrict__ b2,
                const float* __restrict__ w3, const float* __restrict__ b3,
                float* __restrict__ e_out, int n_edges, int fx, int fe, int h, int fo,
                int relu_edge) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int k = 2 * fx + fe;
  float* w1t = smem;              // [k][h] (W1_SHARED)
  float* sb1 = w1t + (W1_SHARED ? k * h : 0);  // [h]
  float* w2t = sb1 + h;           // [h][h]
  float* sb2 = w2t + h * h;       // [h]
  float* w3t = sb2 + h;           // [h][fo]
  float* sb3 = w3t + h * fo;      // [fo]
  float* buf_a = sb3 + fo;        // [TE][max(k, h) + 1]
  float* buf_b = buf_a + TE * ((k > h ? k : h) + 1);  // [TE][h + 1]

  // weights arrive in PyTorch's [out][in] layout; stage them as [in][out]
  if (W1_SHARED) {
    for (int i = threadIdx.x; i < h * k; i += blockDim.x) w1t[(i % k) * h + i / k] = w1[i];
  }
  for (int i = threadIdx.x; i < h * h; i += blockDim.x) w2t[(i % h) * h + i / h] = w2[i];
  for (int i = threadIdx.x; i < fo * h; i += blockDim.x) w3t[(i % h) * fo + i / h] = w3[i];
  for (int i = threadIdx.x; i < h; i += blockDim.x) {
    sb1[i] = b1[i];
    sb2[i] = b2[i];
  }
  for (int i = threadIdx.x; i < fo; i += blockDim.x) sb3[i] = b3[i];

  const int n_tiles = (n_edges + TE - 1) / TE;
  const int in_stride = k + 1;
  const int h_stride = h + 1;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long t0 = (long)tile * TE;
    __syncthreads();  // weights staged / previous tile's buf_a consumed
    for (int i = threadIdx.x; i < TE * k; i += blockDim.x) {
      const int e = i / k;
      const int c = i % k;
      const long edge = t0 + e;
      float v = 0.f;
      if (edge < n_edges) {
        if (c < fx) {
          v = x[(long)dst[edge] * fx + c];
        } else if (c < 2 * fx) {
          v = x[(long)src[edge] * fx + (c - fx)];
        } else {
          v = ea[edge * fe + (c - 2 * fx)];
          if (relu_edge) v = fmaxf(v, 0.f);
        }
      }
      buf_a[e * in_stride + c] = v;
    }
    __syncthreads();
    dense_smem<4>(buf_a, in_stride, k, W1_SHARED ? w1t : w1t_dev, sb1, h, buf_b, h_stride);
    __syncthreads();
    dense_smem<4>(buf_b, h_stride, h, w2t, sb2, h, buf_a, h_stride);
    __syncthreads();
    dense_out(buf_a, h_stride, h, w3t, sb3, fo, mask, t0, n_edges, e_out);
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
// Same FMA order as dense_smem, so the same bits as the forward's activations.
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

template <bool W1_SHARED>
__global__ void __launch_bounds__(THREADS)
edge_mlp_bwd_kernel(const float* __restrict__ x, const float* __restrict__ ea,
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
          v = x[(long)dst[edge] * fx + c];
        } else if (c < 2 * fx) {
          v = x[(long)src[edge] * fx + (c - fx)];
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

template <bool W1_SHARED>
cudaError_t launch_fwd(const float* x, const float* ea, const int* edge_index,
                       const uint8_t* mask, const float* w1, const float* w1t, const float* b1,
                       const float* w2,
                       const float* b2, const float* w3, const float* b3, float* e_out,
                       int n_edges, int fx, int fe, int h, int fo, int relu_edge, size_t smem,
                       cudaStream_t stream) {
  // widths whose tiles exceed one block's shared memory even so fail here; the error is
  // returned, and cleared so that it does not resurface in a later call's cudaGetLastError()
  cudaError_t err = cudaFuncSetAttribute(edge_mlp_kernel<W1_SHARED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  if (n_edges == 0) return cudaSuccess;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, edge_mlp_kernel<W1_SHARED>, THREADS,
                                                      smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int tiles = (n_edges + TE - 1) / TE;
  const int grid = tiles < sms * per_sm ? tiles : sms * per_sm;
  edge_mlp_kernel<W1_SHARED><<<grid, THREADS, smem, stream>>>(
      x, ea, edge_index, edge_index + n_edges, mask, w1, w1t, b1, w2, b2, w3, b3, e_out, n_edges,
      fx, fe, h, fo, relu_edge);
  return cudaGetLastError();
}

template <bool W1_SHARED>
cudaError_t launch_bwd(const float* x, const float* ea, const int* edge_index,
                       const uint8_t* mask, const float* w1, const float* w1t, const float* b1,
                       const float* w2,
                       const float* b2, const float* w3, const float* g_eout,
                       const float* g_agg_e, float* g_xd, float* g_xs, float* g_ea,
                       float* partial, int n_edges, int fx, int fe, int h, int fo, int relu_edge,
                       int blocks, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(edge_mlp_bwd_kernel<W1_SHARED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  if (blocks > 0) {
    edge_mlp_bwd_kernel<W1_SHARED><<<blocks, THREADS, smem, stream>>>(
        x, ea, edge_index, edge_index + n_edges, mask, w1, w1t, b1, w2, b2, w3, g_eout, g_agg_e,
        g_xd, g_xs, g_ea, partial, n_edges, fx, fe, h, fo, relu_edge);
  }
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

// edge_index is [2, E] int32 (row 0 source, row 1 target); mask [E] uint8; weights in
// [out][in] layout, and w1t = W1^T [K][H], read in place of a staged copy where W1 does not fit
// shared memory (null elsewhere). Writes e_out [E, Fo]. Returns cudaGetLastError().
int fused_relational_fwd(const float* x, const float* ea, const int* edge_index,
                         const uint8_t* mask, const float* w1, const float* w1t, const float* b1,
                         const float* w2,
                         const float* b2, const float* w3, const float* b3, float* e_out,
                         int n_edges, int fx, int fe, int h, int fo, int relu_edge,
                         void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int k = 2 * fx + fe;
  bool w1_shared = true;
  const size_t smem = pick_layout(smem_floats(k, h, fo, true), smem_floats(k, h, fo, false),
                                  &w1_shared);
  if (!w1_shared && w1t == nullptr) return cudaErrorInvalidValue;
  if (w1_shared) {
    return launch_fwd<true>(x, ea, edge_index, mask, w1, w1t, b1, w2, b2, w3, b3, e_out, n_edges,
                            fx, fe, h, fo, relu_edge, smem, stream);
  }
  return launch_fwd<false>(x, ea, edge_index, mask, w1, w1t, b1, w2, b2, w3, b3, e_out, n_edges,
                           fx, fe, h, fo, relu_edge, smem, stream);
}

// Backward. g_eout [E, Fo]; g_agg_e [E, Fo] = g_agg[dst] (sorted_gather); writes g_xd, g_xs
// [E, Fx] (per-edge gradients of x_dst and x_src), g_ea [E, Fe], and grads [P] packed as
// w1, b1, w2, b2, w3, b3 ([out][in]); w1t as in the forward; partial is [max_blocks, P] scratch. The edge kernel is
// persistent with min(tiles, max_blocks) blocks; the wrapper passes the SM count, since the
// kernel's shared memory leaves room for one block per SM at the model's widths. Returns
// cudaGetLastError(), or the error of widths whose shared memory does not fit one block even
// with W1 in device memory.
int fused_relational_bwd(const float* x, const float* ea, const int* edge_index,
                         const uint8_t* mask, const float* w1, const float* w1t, const float* b1,
                         const float* w2,
                         const float* b2, const float* w3, const float* g_eout,
                         const float* g_agg_e, float* g_xd, float* g_xs, float* g_ea,
                         float* partial, float* grads, int n_edges, int fx, int fe, int h, int fo,
                         int relu_edge, int max_blocks, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int k = 2 * fx + fe;
  if (max_blocks < 1) return cudaErrorInvalidValue;
  const int tiles = (n_edges + TE - 1) / TE;
  const int blocks = tiles < max_blocks ? tiles : max_blocks;
  bool w1_shared = true;
  const size_t smem = pick_layout(bwd_smem_floats(k, h, fo, true),
                                  bwd_smem_floats(k, h, fo, false), &w1_shared);
  if (!w1_shared && w1t == nullptr) return cudaErrorInvalidValue;
  cudaError_t err =
      w1_shared ? launch_bwd<true>(x, ea, edge_index, mask, w1, w1t, b1, w2, b2, w3, g_eout,
                                   g_agg_e, g_xd, g_xs, g_ea, partial, n_edges, fx, fe, h, fo,
                                   relu_edge, blocks, smem, stream)
                : launch_bwd<false>(x, ea, edge_index, mask, w1, w1t, b1, w2, b2, w3, g_eout,
                                    g_agg_e, g_xd, g_xs, g_ea, partial, n_edges, fx, fe, h, fo,
                                    relu_edge, blocks, smem, stream);
  if (err != cudaSuccess) return err;
  const long p = grad_floats(k, h, fo);
  sum_partials_kernel<<<(unsigned)((p + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      partial, blocks, p, grads);
  return cudaGetLastError();
}

}  // extern "C"
