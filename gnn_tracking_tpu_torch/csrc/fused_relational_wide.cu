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
// What bounds it on this card: arithmetic, as the resident kernels: 2 (K H + H H + H Fo) flops an
// unmasked edge forward and 2 (3 K H + 3 H H + 2 H Fo) backward (K = 2 Fx + Fe), on the CUDA cores
// in f32 here (67 TFLOP/s), where A-D reach the tensor cores. This path is for widths no
// configured model uses (ec.yml and tc.yml take 64 / 128); it is simple, not fast.
// Design:
//  * the weights stay in device memory (L2; the wrapper hands them over as f32, each in the
//    orientation its product reads along 16-byte rows: W1^T, W2^T, W3^T for the forward and the
//    recompute, W1 (rows padded to a multiple of 4), W2, W3 for the input gradients);
//  * persistent blocks of 256 threads take tiles of TE unmasked edges (the wrappers' stable
//    partition, unmasked first; the masked edges' rows are written as zeros, and with the save
//    flag their endpoint rows, without any MLP work); TE is the largest of 64, 32, 16, 8, 4 whose
//    activation tiles (k-major, [width][TE + 4]) fit one block's shared memory, and where not even
//    TE = 4 fits, the tiles of TE = 64 live in a slice of device memory a block (the same code
//    reads them through generic pointers): no width is refused;
//  * every product is a register tile of 4 edges x 4 outputs a thread, a chain of fmaf over the
//    contraction ascending from 0.f, then + b (then ReLU in the hidden layers): in f32 exactly the
//    resident kernels' arithmetic, so the forward and the backward's recompute agree bit for bit
//    with each other and with rows #1 / #2;
//  * bf16: inputs and weights are bf16 values held in f32 (exact), every product accumulates in
//    f32, and the activations are rounded to bf16 where A-D round them: h1, h2, the masked e',
//    g_e' = bf16(mask (g_e'_out + g_agg[dst])), g_h2, g_h1 and the per-edge input gradients; the
//    weight gradients are f32 sums of those bf16 products, rounded by the wrapper;
//  * weight gradients: a thread owns 4 x 4 entries of a weight for the whole launch (its
//    entries depend on threadIdx and the widths only), sums them over a tile's edges ascending and
//    adds the sum to the block's partial in device memory in tile order; a second kernel sums the
//    partials of the blocks that took a tile, in block order. Every sum's order is fixed, so a
//    second launch gives the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "fixed_order_sum.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TE_MAX = 64;

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

// The tiles (floats): the forward's m [K], h1 [H], h2 [H]; the backward's m [K], h1 [H],
// h2 then g_h1 [H], g_h2 [H], g_et [Fo]; each [width][TE + 4]; then TE edge ids.
__host__ __device__ inline long tile_rows(int k, int h, int fo, bool backward) {
  return backward ? (long)k + 3L * h + fo : (long)k + 2L * h;
}
__host__ __device__ inline long tile_floats(int k, int h, int fo, bool backward, int te) {
  return tile_rows(k, h, fo, backward) * (te + 4) + te;
}

// weight-gradient values, packed as w1 [h][k], b1 [h], w2 [h][h], b2 [h], w3 [fo][h], b3 [fo]
__host__ __device__ inline long grad_floats(int k, int h, int fo) {
  return (long)h * k + h + (long)h * h + h + (long)fo * h + fo;
}

// y[e][j] = sum_{c < kin} in[c][e] wt[c][j] for e < te, j < m (m % 4 == 0), each a chain of fmaf
// over c ascending from 0.f; in: a k-major tile [kin][ld]; wt: [kin][m] f32 in device memory.
// A thread owns edges 4 eg .. 4 eg + 3 x outputs 4 og .. 4 og + 3: per c one float4 of the tile
// (the same address across a warp's lanes) and one of wt (consecutive across the lanes).
// epi(eg, og, acc) stores the register tile.
template <typename Epi>
__device__ __forceinline__ void product(const float* in, int kin, const float* __restrict__ wt,
                                        int m, int te, int ld, Epi epi) {
  const int n_og = m / 4;
  for (int u = threadIdx.x; u < te / 4 * n_og; u += blockDim.x) {
    const int og = u % n_og, eg = u / n_og;
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    }
    const float* a = in + 4 * eg;
    const float* w = wt + 4 * og;
#pragma unroll 4
    for (int c = 0; c < kin; ++c) {
      const float4 av = *reinterpret_cast<const float4*>(a + (long)c * ld);
      const float4 wv = __ldg(reinterpret_cast<const float4*>(w + (long)c * m));
      const float ar[4] = {av.x, av.y, av.z, av.w}, wr[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(ar[r], wr[q], acc[r][q]);
      }
    }
    epi(eg, og, acc);
  }
}

// out[j][e] = act(relu(y + b[j])) into a k-major tile: a hidden layer
template <typename T>
struct Hidden {
  const float* b;
  float* out;
  int ld;
  __device__ __forceinline__ void operator()(int eg, int og, const float (&acc)[4][4]) const {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = 4 * og + c;
      const float bj = __ldg(b + j);
      *reinterpret_cast<float4*>(out + (long)j * ld + 4 * eg) =
          make_float4(act<T>(fmaxf(acc[0][c] + bj, 0.f)), act<T>(fmaxf(acc[1][c] + bj, 0.f)),
                      act<T>(fmaxf(acc[2][c] + bj, 0.f)), act<T>(fmaxf(acc[3][c] + bj, 0.f)));
    }
  }
};

// out[j][e] = act(mask[j][e] > 0 ? y : 0): a ReLU's derivative (0 at 0), into a k-major tile
template <typename T>
struct Masked {
  const float* mask;
  float* out;
  int ld;
  __device__ __forceinline__ void operator()(int eg, int og, const float (&acc)[4][4]) const {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const long at = (long)(4 * og + c) * ld + 4 * eg;
      const float4 h = *reinterpret_cast<const float4*>(mask + at);
      *reinterpret_cast<float4*>(out + at) =
          make_float4(h.x > 0.f ? act<T>(acc[0][c]) : 0.f, h.y > 0.f ? act<T>(acc[1][c]) : 0.f,
                      h.z > 0.f ? act<T>(acc[2][c]) : 0.f, h.w > 0.f ? act<T>(acc[3][c]) : 0.f);
    }
  }
};

// part[i][j] (+)= sum_{e < te} g[i][e] a[j][e] for i < rows, j < cols (g, a: k-major tiles), each a
// chain of fmaf over e ascending from 0.f; part_b[i] (+)= sum_e g[i][e]. A thread owns 4 x 4
// entries (and bias entries) fixed by threadIdx and the widths; the block's first tile stores its
// sums, later tiles add theirs, in tile order.
__device__ __forceinline__ void weight_grad(const float* g, int rows, const float* a, int cols,
                                            int te, int ld, float* __restrict__ part,
                                            float* __restrict__ part_b, bool first) {
  const int ncb = (cols + 3) / 4;
  for (int u = threadIdx.x; u < (rows + 3) / 4 * ncb; u += blockDim.x) {
    const int i0 = u / ncb * 4, j0 = u % ncb * 4;
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    }
    const float* gr[4];
    const float* ar[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      gr[r] = g + (long)min(i0 + r, rows - 1) * ld;
      ar[r] = a + (long)min(j0 + r, cols - 1) * ld;
    }
    for (int e = 0; e < te; e += 4) {
      float4 gv[4], av[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        gv[r] = *reinterpret_cast<const float4*>(gr[r] + e);
        av[r] = *reinterpret_cast<const float4*>(ar[r] + e);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[r][c] = fmaf(gv[r].x, av[c].x, acc[r][c]);
          acc[r][c] = fmaf(gv[r].y, av[c].y, acc[r][c]);
          acc[r][c] = fmaf(gv[r].z, av[c].z, acc[r][c]);
          acc[r][c] = fmaf(gv[r].w, av[c].w, acc[r][c]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (i0 + r >= rows || j0 + c >= cols) continue;
        float* p = part + (long)(i0 + r) * cols + j0 + c;
        *p = first ? acc[r][c] : *p + acc[r][c];
      }
    }
  }
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    float s = 0.f;
    for (int e = 0; e < te; ++e) s += g[(long)i * ld + e];
    part_b[i] = first ? s : part_b[i] + s;
  }
}

// Tile t's inputs [x[dst], x[src], ea] (relu(ea) with relu_edge) into m, k-major [k][ld], zeros
// past the `count` unmasked edges, and the edge ids into tid. SAVED reads the endpoint rows from
// gd = x[dst], gs = x[src]; SAVE also writes them there from x (the forward's save flag).
template <typename T, bool SAVED, bool SAVE>
__device__ __forceinline__ void gather_tile(const T* __restrict__ x, const T* gd, const T* gs,
                                            T* gd_out, T* gs_out, const T* __restrict__ ea,
                                            const int* __restrict__ src,
                                            const int* __restrict__ dst,
                                            const int* __restrict__ ids, int count, int t, int te,
                                            int ld, int fx, int fe, int relu_edge, float* m,
                                            int* tid) {
  const int k = 2 * fx + fe;
  const int e = threadIdx.x % te;
  const bool live = t * te + e < count;
  const long edge = live ? __ldg(ids + t * te + e) : 0;
  if (threadIdx.x < te) tid[e] = (int)edge;
  const long rd = SAVED ? edge * fx : (long)(live ? __ldg(dst + edge) : 0) * fx;
  const long rs = SAVED ? edge * fx : (long)(live ? __ldg(src + edge) : 0) * fx;
  for (int c = threadIdx.x / te; c < k; c += blockDim.x / te) {
    float v = 0.f;
    if (live) {
      if (c < fx) {
        const T raw = SAVED ? gd[rd + c] : x[rd + c];
        if (SAVE) gd_out[edge * fx + c] = raw;
        v = to_f(raw);
      } else if (c < 2 * fx) {
        const T raw = SAVED ? gs[rs + c - fx] : x[rs + c - fx];
        if (SAVE) gs_out[edge * fx + c - fx] = raw;
        v = to_f(raw);
      } else {
        v = to_f(ea[edge * fe + c - 2 * fx]);
        if (relu_edge) v = fmaxf(v, 0.f);
      }
    }
    m[(long)c * ld + e] = v;
  }
}

// The forward, persistent: blocks take tiles of te unmasked edges in turn (ids[:count]); masked
// edges get zero rows of e_out (and with SAVE their endpoint rows) without MLP work.
template <typename T, bool SAVE>
__global__ void __launch_bounds__(THREADS, 1)
wide_fwd_kernel(const T* __restrict__ x, const T* __restrict__ ea, const int* __restrict__ src,
                const int* __restrict__ dst, const int* __restrict__ ids,
                const int* __restrict__ count_ptr, const float* __restrict__ w1t,
                const float* __restrict__ b1, const float* __restrict__ w2t,
                const float* __restrict__ b2, const float* __restrict__ w3t,
                const float* __restrict__ b3, T* __restrict__ e_out, T* gd, T* gs,
                float* scratch, int n_edges, int fx, int fe, int h, int fo, int relu_edge,
                int te) {
  extern __shared__ float4 smem4[];
  const int k = 2 * fx + fe, ld = te + 4;
  float* base = scratch != nullptr ? scratch + blockIdx.x * tile_floats(k, h, fo, false, te)
                                   : reinterpret_cast<float*>(smem4);
  float* m = base;                      // [k][ld]
  float* h1 = m + (long)k * ld;         // [h][ld]
  float* h2 = h1 + (long)h * ld;        // [h][ld]
  int* tid = reinterpret_cast<int*>(h2 + (long)h * ld);  // [te]

  const int count = *count_ptr;
  const long stride = (long)gridDim.x * blockDim.x;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < (long)(n_edges - count) * fo;
       i += stride) {
    e_out[(long)__ldg(ids + count + i / fo) * fo + i % fo] = from_f<T>(0.f);
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
  const int n_tiles = (count + te - 1) / te;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    gather_tile<T, false, SAVE>(x, nullptr, nullptr, gd, gs, ea, src, dst, ids, count, t, te, ld,
                                fx, fe, relu_edge, m, tid);
    __syncthreads();
    const int valid = min(te, count - t * te);
    product(m, k, w1t, h, te, ld, Hidden<T>{b1, h1, ld});
    __syncthreads();
    product(h1, h, w2t, h, te, ld, Hidden<T>{b2, h2, ld});
    __syncthreads();
    product(h2, h, w3t, fo, te, ld, [&](int eg, int og, const float (&acc)[4][4]) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = 4 * eg + r;
        if (e >= valid) continue;
        T* row = e_out + (long)tid[e] * fo;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = 4 * og + c;
          row[j] = from_f<T>(acc[r][c] + __ldg(b3 + j));
        }
      }
    });
    __syncthreads();  // the tiles are free for the next tile's gather
  }
}

// The backward, persistent, over the same tiles: the recompute of h1 and h2 (the forward's
// products), g_et = g_e' + g_agg[dst], then
//   1. g_h2 = (g_et W3) * [h2 > 0];  dW3 (+)= g_et^T h2, db3 (+)= sum g_et
//   2. g_h1 = (g_h2 W2) * [h1 > 0] over h2;  dW2 (+)= g_h2^T h1, db2 (+)= sum g_h2
//   3. g_m = g_h1 W1 -> g_xd, g_xs, g_ea;  dW1 (+)= g_h1^T m, db1 (+)= sum g_h1
// Masked edges get zero rows of g_xd, g_xs, g_ea. SAVED reads the endpoint rows from gd, gs.
template <typename T, bool SAVED>
__global__ void __launch_bounds__(THREADS, 1)
wide_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gd, const T* __restrict__ gs,
                const T* __restrict__ ea, const int* __restrict__ src,
                const int* __restrict__ dst, const int* __restrict__ ids,
                const int* __restrict__ count_ptr, const float* __restrict__ w1t,
                const float* __restrict__ b1, const float* __restrict__ w2t,
                const float* __restrict__ b2, const float* __restrict__ w1p,
                const float* __restrict__ w2, const float* __restrict__ w3,
                const T* __restrict__ g_eout, const T* __restrict__ g_agg,
                T* __restrict__ g_xd, T* __restrict__ g_xs, T* __restrict__ g_ea,
                float* __restrict__ partial, float* scratch, int n_edges, int fx, int fe, int h,
                int fo, int relu_edge, int te) {
  extern __shared__ float4 smem4[];
  const int k = 2 * fx + fe, k4 = (k + 3) & ~3, ld = te + 4;
  float* base = scratch != nullptr ? scratch + blockIdx.x * tile_floats(k, h, fo, true, te)
                                   : reinterpret_cast<float*>(smem4);
  float* m = base;                       // [k][ld]
  float* h1 = m + (long)k * ld;          // [h][ld]
  float* h2 = h1 + (long)h * ld;         // [h][ld]: h2, then g_h1
  float* gh2 = h2 + (long)h * ld;        // [h][ld]
  float* get = gh2 + (long)h * ld;       // [fo][ld]
  int* tid = reinterpret_cast<int*>(get + (long)fo * ld);  // [te]

  const int count = *count_ptr;
  const int warps = gridDim.x * (blockDim.x / 32);
  for (int r = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32; r < n_edges - count; r += warps) {
    const long edge = __ldg(ids + count + r);
    for (int c = threadIdx.x % 32; c < fx; c += 32) {
      g_xd[edge * fx + c] = from_f<T>(0.f);
      g_xs[edge * fx + c] = from_f<T>(0.f);
    }
    for (int c = threadIdx.x % 32; c < fe; c += 32) g_ea[edge * fe + c] = from_f<T>(0.f);
  }
  float* pw1 = partial + (long)blockIdx.x * grad_floats(k, h, fo);
  float* pb1 = pw1 + (long)h * k;
  float* pw2 = pb1 + h;
  float* pb2 = pw2 + (long)h * h;
  float* pw3 = pb2 + h;
  float* pb3 = pw3 + (long)fo * h;

  const int n_tiles = (count + te - 1) / te;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const bool first = t == (int)blockIdx.x;
    gather_tile<T, SAVED, false>(x, gd, gs, nullptr, nullptr, ea, src, dst, ids, count, t, te, ld,
                                 fx, fe, relu_edge, m, tid);
    {  // the output cotangents of the tile's unmasked edges, zeros past them
      const int e = threadIdx.x % te;
      const bool live = t * te + e < count;
      const long edge = live ? __ldg(ids + t * te + e) : 0;
      const long target = live ? __ldg(dst + edge) : 0;
      for (int c = threadIdx.x / te; c < fo; c += blockDim.x / te) {
        get[(long)c * ld + e] =
            live ? act<T>(to_f(g_eout[edge * fo + c]) + to_f(g_agg[target * fo + c])) : 0.f;
      }
    }
    __syncthreads();
    const int valid = min(te, count - t * te);
    product(m, k, w1t, h, te, ld, Hidden<T>{b1, h1, ld});
    __syncthreads();
    product(h1, h, w2t, h, te, ld, Hidden<T>{b2, h2, ld});
    __syncthreads();
    product(get, fo, w3, h, te, ld, Masked<T>{h2, gh2, ld});
    weight_grad(get, fo, h2, h, te, ld, pw3, pb3, first);
    __syncthreads();
    product(gh2, h, w2, h, te, ld, Masked<T>{h1, h2, ld});  // g_h1 over h2
    weight_grad(gh2, h, h1, h, te, ld, pw2, pb2, first);
    __syncthreads();
    product(h2, h, w1p, k4, te, ld, [&](int eg, int og, const float (&acc)[4][4]) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = 4 * eg + r;
        if (e >= valid) continue;
        const long id = tid[e];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = 4 * og + c;
          float v = acc[r][c];
          if (i < fx) {
            g_xd[id * fx + i] = from_f<T>(v);
          } else if (i < 2 * fx) {
            g_xs[id * fx + i - fx] = from_f<T>(v);
          } else if (i < k) {
            if (relu_edge && !(m[(long)i * ld + e] > 0.f)) v = 0.f;
            g_ea[id * fe + i - 2 * fx] = from_f<T>(v);
          }
        }
      }
    });
    weight_grad(h2, h, m, k, te, ld, pw1, pb1, first);
    __syncthreads();  // the tiles are free for the next tile's gather
  }
}

// The tile of the widths: the largest TE (64 .. 4) whose tiles fit one block's shared memory
// (*smem their bytes), else TE = 64 with the tiles in device memory (*smem = 0).
cudaError_t plan(int fx, int fe, int h, int fo, bool backward, int* te, size_t* smem) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return err;
  const int k = 2 * fx + fe;
  for (int t = TE_MAX; t >= 4; t /= 2) {
    const long bytes = tile_floats(k, h, fo, backward, t) * (long)sizeof(float);
    if (bytes <= optin) {
      *te = t;
      *smem = (size_t)bytes;
      return cudaSuccess;
    }
  }
  *te = TE_MAX;
  *smem = 0;
  return cudaSuccess;
}

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) cudaGetLastError();  // not to resurface in a later call's check
  return err;
}

template <typename T, bool SAVE>
int fwd(const void* x, const void* ea, const int* edge_index, const int* ids, const int* count,
        const float* w1t, const float* b1, const float* w2t, const float* b2, const float* w3t,
        const float* b3, void* e_out, void* gd, void* gs, float* scratch, int n_edges, int fx,
        int fe, int h, int fo, int relu_edge, int max_blocks, cudaStream_t stream) {
  int te = 0;
  size_t smem = 0;
  cudaError_t err = plan(fx, fe, h, fo, false, &te, &smem);
  if (err != cudaSuccess) return err;
  if (smem == 0 && scratch == nullptr) return cudaErrorInvalidValue;
  auto kernel = wide_fwd_kernel<T, SAVE>;
  err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (n_edges + te - 1) / te;  // at most: the masked edges take no tile
  int grid = max_blocks;
  if (smem > 0) {  // as many blocks as are resident at once
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    grid = sms * per_sm;
  }
  if (grid > tiles) grid = tiles;
  if (grid < 1) return cudaErrorInvalidValue;
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(ea), edge_index, edge_index + n_edges, ids,
      count, w1t, b1, w2t, b2, w3t, b3, static_cast<T*>(e_out), static_cast<T*>(gd),
      static_cast<T*>(gs), smem > 0 ? nullptr : scratch, n_edges, fx, fe, h, fo, relu_edge, te);
  return cudaGetLastError();
}

template <typename T, bool SAVED>
int bwd(const void* x, const void* gd, const void* gs, const void* ea, const int* edge_index,
        const int* ids, const int* count, const float* w1t, const float* b1, const float* w2t,
        const float* b2, const float* w1p, const float* w2, const float* w3, const void* g_eout,
        const void* g_agg, void* g_xd, void* g_xs, void* g_ea, float* partial, float* grads,
        float* scratch, int n_edges, int fx, int fe, int h, int fo, int relu_edge, int max_blocks,
        cudaStream_t stream) {
  int te = 0;
  size_t smem = 0;
  cudaError_t err = plan(fx, fe, h, fo, true, &te, &smem);
  if (err != cudaSuccess) return err;
  if (smem == 0 && scratch == nullptr) return cudaErrorInvalidValue;
  auto kernel = wide_bwd_kernel<T, SAVED>;
  err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (n_edges + te - 1) / te;  // at most: the masked edges take no tile
  const int blocks = tiles < max_blocks ? tiles : max_blocks;
  if (blocks < 1) return cudaErrorInvalidValue;
  kernel<<<blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gd), static_cast<const T*>(gs),
      static_cast<const T*>(ea), edge_index, edge_index + n_edges, ids, count, w1t, b1, w2t, b2,
      w1p, w2, w3, static_cast<const T*>(g_eout), static_cast<const T*>(g_agg),
      static_cast<T*>(g_xd), static_cast<T*>(g_xs), static_cast<T*>(g_ea), partial,
      smem > 0 ? nullptr : scratch, n_edges, fx, fe, h, fo, relu_edge, te);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long p = grad_floats(2 * fx + fe, h, fo);
  fixed_order_sum::sum_partials_kernel<<<(unsigned)((p + THREADS - 1) / THREADS), THREADS, 0,
                                          stream>>>(partial, blocks, te, count, p, grads);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// The tiles a block of the forward (backward = 0) or the backward (1) takes at these widths:
// out[0] = TE (edges a tile), out[1] = floats a block needs in device memory (0 where the tiles
// fit shared memory; else the wrapper passes `scratch` of max_blocks such slices).
int fused_relational_wide_plan(int fx, int fe, int h, int fo, int backward, void* out) {
  int te = 0;
  size_t smem = 0;
  cudaError_t err = plan(fx, fe, h, fo, backward != 0, &te, &smem);
  if (err != cudaSuccess) return err;
  long* o = static_cast<long*>(out);
  o[0] = te;
  o[1] = smem > 0 ? 0 : tile_floats(2 * fx + fe, h, fo, backward != 0, te);
  return cudaSuccess;
}

// The forward. x [N, Fx], ea [E, Fe], e_out [E, Fo] (and with save gd, gs [E, Fx]) in f32, or
// bf16 where bf16 != 0; edge_index [2, E] i32 (row 0 source, row 1 target); ids [E] i32 the edge
// ids, unmasked first (*count of them, on the device), then the masked; weights f32: w1t = W1^T
// [K][H], w2t = W2^T [H][H], w3t = W3^T [H][Fo], biases [H], [H], [Fo] (H, Fo multiples of 4);
// scratch: max_blocks slices of fused_relational_wide_plan's floats, or null where the tiles
// fit shared memory. Returns cudaGetLastError().
int fused_relational_wide_fwd(const void* x, const void* ea, const int* edge_index, const int* ids,
                              const int* count, const float* w1t, const float* b1,
                              const float* w2t, const float* b2, const float* w3t,
                              const float* b3, void* e_out, void* gd, void* gs, float* scratch,
                              int n_edges, int fx, int fe, int h, int fo, int relu_edge, int bf16,
                              int save, int max_blocks, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_edges == 0) return cudaSuccess;
  if (h % 4 != 0 || fo % 4 != 0 || max_blocks < 1) return cudaErrorInvalidValue;
  auto f = bf16 ? (save ? &fwd<__nv_bfloat16, true> : &fwd<__nv_bfloat16, false>)
                : (save ? &fwd<float, true> : &fwd<float, false>);
  return f(x, ea, edge_index, ids, count, w1t, b1, w2t, b2, w3t, b3, e_out, gd, gs, scratch,
           n_edges, fx, fe, h, fo, relu_edge, max_blocks, stream);
}

// The backward, from x, or (x null) from the rows gd = x[dst], gs = x[src] [E, Fx] that the
// saving forward wrote. ids / count and w1t, b1, w2t, b2 as in the forward; w1p = W1 [H][K4]
// (rows zero-padded to K4 = K rounded up to 4), w2 = W2 [H][H], w3 = W3 [Fo][H], f32; g_eout
// [E, Fo], g_agg [N, Fo]; writes the per-edge gradients g_xd, g_xs [E, Fx] (of x_dst and x_src),
// g_ea [E, Fe] in the input dtype, and grads [P] f32 packed as w1, b1, w2, b2, w3, b3 ([out][in]);
// partial is [max_blocks, P] scratch, scratch as in the forward. Returns cudaGetLastError().
int fused_relational_wide_bwd(const void* x, const void* gd, const void* gs, const void* ea,
                              const int* edge_index, const int* ids, const int* count,
                              const float* w1t, const float* b1, const float* w2t,
                              const float* b2, const float* w1p, const float* w2,
                              const float* w3, const void* g_eout, const void* g_agg, void* g_xd,
                              void* g_xs, void* g_ea, float* partial, float* grads,
                              float* scratch, int n_edges, int fx, int fe, int h, int fo,
                              int relu_edge, int bf16, int max_blocks, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_edges == 0) return cudaSuccess;
  if (h % 4 != 0 || fo % 4 != 0 || max_blocks < 1) return cudaErrorInvalidValue;
  const bool saved = x == nullptr;
  auto f = bf16 ? (saved ? &bwd<__nv_bfloat16, true> : &bwd<__nv_bfloat16, false>)
                : (saved ? &bwd<float, true> : &bwd<float, false>);
  return f(x, gd, gs, ea, edge_index, ids, count, w1t, b1, w2t, b2, w1p, w2, w3, g_eout, g_agg,
           g_xd, g_xs, g_ea, partial, grads, scratch, n_edges, fx, fe, h, fo, relu_edge,
           max_blocks, stream);
}

}  // extern "C"
