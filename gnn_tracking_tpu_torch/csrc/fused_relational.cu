// Fused interaction-network edge pipeline, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel gnn_tracking_tpu/ops/pallas/fused_relational.py::fused_relational
// (forward, _fwd_kernel): for every edge (src -> dst)
//     e' = mask * ( relu( relu([x_dst, x_src, ea] W1 + b1) W2 + b2 ) W3 + b3 )
// and agg[i] = sum of e' over the edges whose target is i. Masked edges come out as exact
// zeros and add nothing. With relu_edge the incoming edge features pass through a ReLU first.
//
// What bounds it on this card: arithmetic. Per edge the MLP costs 2 (K H + H H + H Fo) flops
// (K = 2 Fx + Fe); at the serving shapes (K = 96, H = 128, Fo = 32, E = 262144) that is
// 17.2 GFLOP per layer against ~37 MB of compulsory traffic (x, edge features, indices, e', agg),
// some 460 flop per byte, far above the card's f32 ridge point.
//
// Design (simple and exact first; tensor cores are later work):
//  * f32 FMA on the CUDA cores, persistent blocks (as many as fit, one per SM at these widths);
//  * each block stages W1, W2, W3 and the biases ONCE into shared memory, transposed to
//    [in][out] so that a warp reads consecutive outputs of one input row as float4;
//  * edges are processed in tiles of TE = 32: the tile's gathered inputs [x_dst, x_src, ea]
//    and both hidden activations live in shared memory only; each thread of a hidden layer owns
//    a 4-edge x 4-output register tile (16 FMA per 4 broadcast loads + 1 float4 load);
//  * the output layer writes e' straight to device memory, masked;
//  * aggregation: edges arrive sorted by target with a CSR row pointer (built once per event by
//    EventGraph.sort_edges_by_target), and a second kernel sums each node's contiguous rows of
//    e' in edge order. No atomics: the result is bitwise deterministic.
// The TPU's slab windows, one-hot MXU gathers and 8-sublane index tiles are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TE = 32;        // edges per tile
constexpr int THREADS = 256;  // threads per block

// out[e][j] = act(sum_k in[e][k] * wt[k][j] + b[j]) for e < TE, j < m (m % 4 == 0).
// in: [TE][in_stride] shared, wt: [kin][m] shared, out: [TE][out_stride] shared.
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

__host__ __device__ inline long smem_floats(int k, int h, int fo) {
  const long weights = (long)k * h + h + (long)h * h + h + (long)h * fo + fo;
  const long buf_a = (long)TE * ((k > h ? k : h) + 1);  // gathered input, then h2
  const long buf_b = (long)TE * (h + 1);                // h1
  return weights + buf_a + buf_b;
}

__global__ void __launch_bounds__(THREADS)
edge_mlp_kernel(const float* __restrict__ x, const float* __restrict__ ea,
                const int* __restrict__ src, const int* __restrict__ dst,
                const uint8_t* __restrict__ mask,
                const float* __restrict__ w1, const float* __restrict__ b1,
                const float* __restrict__ w2, const float* __restrict__ b2,
                const float* __restrict__ w3, const float* __restrict__ b3,
                float* __restrict__ e_out, int n_edges, int fx, int fe, int h, int fo,
                int relu_edge) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int k = 2 * fx + fe;
  float* w1t = smem;              // [k][h]
  float* sb1 = w1t + k * h;       // [h]
  float* w2t = sb1 + h;           // [h][h]
  float* sb2 = w2t + h * h;       // [h]
  float* w3t = sb2 + h;           // [h][fo]
  float* sb3 = w3t + h * fo;      // [fo]
  float* buf_a = sb3 + fo;        // [TE][max(k, h) + 1]
  float* buf_b = buf_a + TE * ((k > h ? k : h) + 1);  // [TE][h + 1]

  // weights arrive in PyTorch's [out][in] layout; stage them as [in][out]
  for (int i = threadIdx.x; i < h * k; i += blockDim.x) w1t[(i % k) * h + i / k] = w1[i];
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
    dense_smem<4>(buf_a, in_stride, k, w1t, sb1, h, buf_b, h_stride);
    __syncthreads();
    dense_smem<4>(buf_b, h_stride, h, w2t, sb2, h, buf_a, h_stride);
    __syncthreads();
    dense_out(buf_a, h_stride, h, w3t, sb3, fo, mask, t0, n_edges, e_out);
  }
}

// agg[i][f] = sum over e in [rowptr[i], rowptr[i+1]) of e_out[e][f], in edge order.
__global__ void csr_rows_sum_kernel(const float* __restrict__ e_out,
                                    const int* __restrict__ rowptr, int n, int fo,
                                    float* __restrict__ agg) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)n * fo) return;
  const int node = (int)(i / fo);
  const int f = (int)(i % fo);
  float s = 0.f;
  for (int e = rowptr[node]; e < rowptr[node + 1]; ++e) s += e_out[(long)e * fo + f];
  agg[i] = s;
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// edge_index is [2, E] int32 (row 0 source, row 1 target, targets non-decreasing);
// rowptr [N + 1] int32; mask [E] uint8; weights in [out][in] layout. Returns cudaGetLastError().
int fused_relational_fwd(const float* x, const float* ea, const int* edge_index,
                         const uint8_t* mask, const int* rowptr, const float* w1,
                         const float* b1, const float* w2, const float* b2, const float* w3,
                         const float* b3, float* e_out, float* agg, int n, int n_edges, int fx,
                         int fe, int h, int fo, int relu_edge, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int k = 2 * fx + fe;
  const size_t smem = smem_floats(k, h, fo) * sizeof(float);
  // widths whose weights and tiles exceed one block's shared memory fail here; the error is
  // returned, and cleared so that it does not resurface in a later call's cudaGetLastError()
  cudaError_t err = cudaFuncSetAttribute(edge_mlp_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  if (n_edges > 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, edge_mlp_kernel, THREADS, smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return err;
    }
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    const int tiles = (n_edges + TE - 1) / TE;
    const int grid = tiles < sms * per_sm ? tiles : sms * per_sm;
    edge_mlp_kernel<<<grid, THREADS, smem, stream>>>(x, ea, edge_index, edge_index + n_edges,
                                                     mask, w1, b1, w2, b2, w3, b3, e_out,
                                                     n_edges, fx, fe, h, fo, relu_edge);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long outs = (long)n * fo;
  if (outs > 0) {
    csr_rows_sum_kernel<<<(unsigned)((outs + 255) / 256), 256, 0, stream>>>(e_out, rowptr, n,
                                                                            fo, agg);
  }
  return cudaGetLastError();
}

}  // extern "C"
