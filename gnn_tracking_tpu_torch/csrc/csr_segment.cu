// Sorted segment-sum and sorted gather, for Hopper (sm_90a).
//
// Replaces the TPU kernels of gnn_tracking_tpu/ops/pallas/csr_segment.py:
//   * sorted_segment_sum (_fwd_kernel): out[i] = sum of messages[e] over the edges e whose
//     (non-decreasing) target is i;
//   * sorted_gather (_gather_kernel): out[e] = values[dst[e]].
// Each is the other's vector-Jacobian product. The TPU kernels turn both into windowed one-hot
// matmuls on the MXU (a scatter has no fast TPU lowering); on this card a sorted segment-sum is a
// CSR row sum and a gather is a gather, so neither needs a matrix unit.
//
// What bounds them on this card: bytes. At F = 32, E = 262144, N = 32768 the segment-sum moves
// E*F*4 in + N*F*4 out + the row pointer (~37.9 MB, ~11.3 us at 3.35 TB/s) and the gather
// N*F*4 + E*4 in + E*F*4 out (~38.8 MB, ~11.6 us). No arithmetic to speak of.
//
// Segment-sum design: the work is cut over rows (edges), not over nodes, so that one long
// segment (a graph whose masked edges all point at node N-1, or a source hub) is spread over the
// card like any other rows.
//  * A group of G lanes (G = the row's 16-byte vectors rounded up to a power of 2, at most 32)
//    walks a tile of TILE consecutive rows in order; each lane owns whole 16-byte vectors of the
//    row (4 f32 or 8 bf16 values; scalar columns where the width or the address is not a
//    multiple of 16 bytes), and up to 8 rows are loaded before they are added (the first batch
//    before the search below), so that many loads are in flight.
//  * The tile's first node comes from a binary search of rowptr on the device (no host sync).
//    The group sums each run of rows of one node in registers from 0.f, in row order, and writes
//    a node whose rows all lie in the tile straight to out. The run that started before the tile
//    (head) and the run that goes on past it (tail) go to shared memory instead.
//  * After the block's groups are done, the block joins its groups' partials in group order:
//    a tail plus the heads of the groups it runs into; a node whose rows end inside the block is
//    written there. What still runs past the block goes to a small buffer in device memory
//    (one head and one tail per block), which a second kernel joins in block order; that kernel
//    also writes the zeros of empty nodes. It is launched as the first kernel's programmatic
//    dependent (a Hopper launch attribute): it starts while the first kernel's last blocks run,
//    writes the zeros, and waits for the first kernel only before it reads the partials.
//  * So out[i] is a sum in a fixed order that depends only on rowptr: row order within a tile,
//    then tile order within a block, then block order. No atomics: two launches on the same
//    inputs give the same bits.
//  * An optional permutation reads row perm[p] in place of row p, which sums the edges of one
//    source in source-sorted order (EventGraph.sort_edges_by_target stores src_perm and
//    src_rowptr); those reads are random rows.
//  * bf16 rows (the bf16 fused relational op's e' and per-edge node gradients): each value is
//    widened to f32; the sums and out stay f32.
// Gather design (a copy of bits, so one kernel serves f32 and bf16 rows): a group of G lanes a
// row (G = the row's 16-byte vectors rounded up to a power of 2, at most 32), each lane moving
// whole 16-byte vectors (4 f32 or 8 bf16 values; elements one at a time where the row's bytes or
// an address are not a multiple of 16), so a warp reads and writes 32 / G whole rows an
// instruction. Each thread holds GATHER_ROWS rows in flight: their indices loaded once a row,
// then every row's loads, then its stores. No division by F. The sorted index is not used: a
// run of equal rows is read from L2 again, which the bound's bytes do not count.
// Requires rowptr[0] = 0 and rowptr[n] = rows, as the CSR arrays of a sorted graph have.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 16;  // rows per group
// rows loaded ahead of their adds: 8, fewer where a lane holds more than 4 values of a row
__host__ __device__ constexpr int rows_ahead(int values) {
  return values >= 16 ? 2 : values >= 8 ? 4 : 8;
}
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// VEC consecutive values of a row, widened to f32 (VEC = 1: one value; else one 16-byte load)
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float* v) {
  if constexpr (VEC == 1) {
    v[0] = widen(__ldg(p));
  } else if constexpr (sizeof(T) == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* __restrict__ p, const float* v) {
  if constexpr (VEC == 1) {
    p[0] = v[0];
  } else {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    }
  }
}

// Per-block partials in device memory, nblk blocks: head and tail rows [nblk][f] f32, then
// head node, tail node (-1: none) and "the block's last run goes on past it" flags [nblk] int.
struct BlockParts {
  float* head;
  float* tail;
  int* head_node;
  int* tail_node;
  int* open_end;
};

__host__ __device__ inline BlockParts block_parts(void* scratch, int nblk, int f) {
  float* fl = static_cast<float*>(scratch);
  int* in = reinterpret_cast<int*>(fl + 2L * nblk * f);
  return {fl, fl + (long)nblk * f, in, in + nblk, in + 2 * nblk};
}

// Largest i in [0, n) with rowptr[i] <= p: the node whose rows hold position p. The g_lanes
// lanes of a group search together, each round probing g_lanes points of the interval at once
// (a (g_lanes + 1)-ary search: 5 dependent loads for 32,768 nodes at g_lanes = 8, not 15).
// Every lane of the warp must call it.
__device__ __forceinline__ int node_of(const int* __restrict__ rowptr, int n, int p, int g_lanes,
                                       int j) {
  const int lane = threadIdx.x % 32;
  const unsigned group_bits = (g_lanes == 32 ? FULL : ((1u << g_lanes) - 1u)) << (lane - j);
  int lo = 0, hi = n - 1;
  while (!__all_sync(FULL, lo == hi)) {
    const int step = (hi - lo + g_lanes) / (g_lanes + 1);
    const int q = lo + (j + 1) * step;
    const bool pred = lo < hi && q <= hi && __ldg(rowptr + q) <= p;
    const int c = __popc(__ballot_sync(FULL, pred) & group_bits);
    const int first_false = lo + (c + 1) * step;
    if (lo < hi) {
      if (c < g_lanes && first_false <= hi) hi = first_false - 1;
      lo += c * step;
    }
  }
  return lo;
}

// Kernel 1: tiles of rows -> out (nodes inside a tile or a block) and block partials.
// Shared memory: head and tail rows [gpb][f] f32, then head node, tail node, open-end [gpb] int.
// (at most 64 registers a thread: 4 blocks an SM, so the ~512 blocks of 262,144 rows run in one
// wave; the widest variants spill a little)
template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(THREADS, 4)
segment_tiles_kernel(const T* __restrict__ msgs, const int* __restrict__ rowptr,
                     const int* __restrict__ perm, int n, int rows, int f, int g_lanes,
                     float* __restrict__ out, void* scratch, int nblk) {
  extern __shared__ float4 smem4[];
  const int gpb = THREADS / g_lanes;  // groups per block
  float* s_head = reinterpret_cast<float*>(smem4);
  float* s_tail = s_head + gpb * f;
  int* s_hnode = reinterpret_cast<int*>(s_tail + gpb * f);
  int* s_tnode = s_hnode + gpb;
  int* s_open = s_tnode + gpb;

  const int g = threadIdx.x / g_lanes;  // group within the block
  const int j = threadIdx.x % g_lanes;  // lane within the group
  const int nvec = (f + VEC - 1) / VEC;
  constexpr int U = rows_ahead(NV * VEC);
  const long a = ((long)blockIdx.x * gpb + g) * TILE;
  const int b = (int)min((long)rows, a + TILE);  // <= a past the last row
  // rows p0 .. p0 + U - 1 into v (the first batch is issued before the search for the tile's node)
  float v[U][NV][VEC];
  auto load_batch = [&](int p0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = p0 + u;
      if (p >= b) break;
      const long r = perm != nullptr ? (long)__ldg(perm + p) : (long)p;
#pragma unroll
      for (int q = 0; q < NV; ++q) {
        const int vc = j + g_lanes * q;
        if (vc < nvec) load_vec<T, VEC>(msgs + r * f + vc * VEC, v[u][q]);
      }
    }
  };
  load_batch((int)a);
  // every lane searches (a clamped past the last row), so the search's warp votes see all lanes
  const int cur0 = node_of(rowptr, n, (int)min(a, (long)rows - 1), g_lanes, j);
  if (a < rows) {
    int cur = cur0;
    bool head_open = __ldg(rowptr + cur) < a;  // the tile starts inside node cur's rows
    int nb = __ldg(rowptr + cur + 1);
    int nnb = __ldg(rowptr + min(cur + 2, n));
    int hnode = -1;
    float acc[NV][VEC];
#pragma unroll
    for (int q = 0; q < NV; ++q) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[q][i] = 0.f;
    }
    // a finished run: straight to out, or to the tile's head slot when it began before the tile
    auto flush = [&](int node) {
#pragma unroll
      for (int q = 0; q < NV; ++q) {
        const int vc = j + g_lanes * q;
        if (vc >= nvec) continue;
        float* dst = head_open ? s_head + g * f + vc * VEC : out + (long)node * f + vc * VEC;
        store_vec<VEC>(dst, acc[q]);
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[q][i] = 0.f;
      }
      if (head_open) hnode = node;
      head_open = false;
    };
    for (int p0 = (int)a; p0 < b; p0 += U) {
      if (p0 != a) load_batch(p0);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int p = p0 + u;
        if (p >= b) break;
        if (p == nb) {  // node cur's rows end before row p
          flush(cur);
          ++cur;
          nb = nnb;
          nnb = __ldg(rowptr + min(cur + 2, n));
          while (nb == p) {  // empty nodes (their zeros come from the second kernel)
            ++cur;
            nb = nnb;
            nnb = __ldg(rowptr + min(cur + 2, n));
          }
        }
#pragma unroll
        for (int q = 0; q < NV; ++q) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[q][i] += v[u][q][i];
        }
      }
    }
    int tnode = -1;
    const bool open_end = nb > b;  // node cur's rows go on past the tile
    if (!open_end) {
      flush(cur);
    } else if (head_open) {  // the whole tile lies inside node cur's rows
      flush(cur);
    } else {
#pragma unroll
      for (int q = 0; q < NV; ++q) {
        const int vc = j + g_lanes * q;
        if (vc < nvec) store_vec<VEC>(s_tail + g * f + vc * VEC, acc[q]);
      }
      tnode = cur;
    }
    if (j == 0) {
      s_hnode[g] = hnode;
      s_tnode[g] = tnode;
      s_open[g] = open_end ? 1 : 0;
    }
  } else if (j == 0) {
    s_hnode[g] = -1;
    s_tnode[g] = -1;
    s_open[g] = 0;
  }
  __syncthreads();

  // join the groups' partials, in group order. A run goes on from group u to u + 1 when group u
  // has no tail and its last run is open (the whole tile inside it).
  const BlockParts bp = block_parts(scratch, nblk, f);
  for (int idx = threadIdx.x; idx < (gpb + 1) * f; idx += blockDim.x) {
    const int gi = idx / f - 1;  // -1: the block's head run
    const int c = idx % f;
    int node, u;
    float s;
    if (gi < 0) {
      node = s_hnode[0];
      if (node < 0) {
        if (c == 0) bp.head_node[blockIdx.x] = -1;
        continue;
      }
      s = 0.f;
      u = 0;
    } else {
      node = s_tnode[gi];
      if (node < 0) continue;
      s = s_tail[gi * f + c];
      u = gi + 1;
    }
    bool on = true;  // the run goes on into group u
    for (; u < gpb && on; ++u) {
      s += s_head[u * f + c];
      on = s_tnode[u] < 0 && s_open[u];
    }
    if (gi < 0) {
      bp.head[(long)blockIdx.x * f + c] = s;
      if (c == 0) bp.head_node[blockIdx.x] = node;
    } else if (on) {  // past the block's last group
      bp.tail[(long)blockIdx.x * f + c] = s;
    } else {
      out[(long)node * f + c] = s;
    }
  }
  if (threadIdx.x == 0) {
    // the block's tail: the last group's tail, or the tail whose run covers the groups after it
    int tail = -1;
    for (int gi = gpb - 1; gi >= 0; --gi) {
      if (s_tnode[gi] >= 0) {
        bool on = true;
        for (int u = gi + 1; u < gpb && on; ++u) on = s_tnode[u] < 0 && s_open[u];
        if (on) tail = s_tnode[gi];
        break;
      }
    }
    bp.tail_node[blockIdx.x] = tail;
    bp.open_end[blockIdx.x] = s_open[gpb - 1];
  }
}

// Kernel 2, one warp per block of kernel 1: a block tail plus the heads of the blocks its run
// covers, in block order; and zeros for empty nodes.
__global__ void __launch_bounds__(THREADS)
segment_blocks_kernel(const int* __restrict__ rowptr, int n, int f, const void* scratch,
                      int nblk, float* __restrict__ out) {
  const int warp = (int)(((long)blockIdx.x * blockDim.x + threadIdx.x) / 32);
  const int lane = threadIdx.x % 32;
  const int warps = (int)((long)gridDim.x * blockDim.x / 32);
  for (int i = warp * 32 + lane; i < n; i += warps * 32) {
    if (__ldg(rowptr + i) == __ldg(rowptr + i + 1)) {
      for (int c = 0; c < f; ++c) out[(long)i * f + c] = 0.f;
    }
  }
  // the partials below are kernel 1's: it was launched first, and this kernel may start before
  // it ends (programmatic dependent launch), so wait for it here, after the empty nodes
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (warp >= nblk) return;
  const BlockParts bp = block_parts(const_cast<void*>(scratch), nblk, f);
  const int node = bp.tail_node[warp];
  if (node < 0) return;
  // the run covers blocks warp + 1 .. last: block u passes it on when it has no tail and an
  // open end
  int last = warp + 1;
  for (;;) {
    const int u = last + lane;
    const bool on = u < nblk && bp.tail_node[u] < 0 && bp.open_end[u];
    const unsigned m = __ballot_sync(FULL, on);
    if (m != FULL) {
      last += __ffs(~m) - 1;
      break;
    }
    last += 32;
  }
  last = min(last, nblk - 1);
  for (int c = lane; c < f; c += 32) {
    float s = bp.tail[(long)warp * f + c];
    int u = warp + 1;
    for (; u + 8 <= last + 1; u += 8) {  // 8 loads in flight, then their adds in block order
      float h[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) h[i] = bp.head[(long)(u + i) * f + c];
#pragma unroll
      for (int i = 0; i < 8; ++i) s += h[i];
    }
    for (; u <= last; ++u) s += bp.head[(long)u * f + c];
    out[(long)node * f + c] = s;
  }
}

// out[e] = values[idx[e]], rows of nvec words of type V (uint4: 16-byte vectors; unsigned or
// unsigned short: single elements); G lanes a row, GATHER_ROWS rows a thread: a warp's rows are
// [row0, row0 + GATHER_ROWS * 32 / G), instruction k taking rows row0 + k * 32 / G + lane / G.
constexpr int GATHER_ROWS = 4;

template <typename V>
__global__ void __launch_bounds__(THREADS)
gather_rows_kernel(const V* __restrict__ values, const int* __restrict__ idx, int n_edges,
                   int nvec, int g_lanes, V* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int per_warp = 32 / g_lanes;  // rows a warp instruction
  const long warp = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long row0 = warp * GATHER_ROWS * per_warp + lane / g_lanes;
  long e[GATHER_ROWS];
  long src[GATHER_ROWS];
#pragma unroll
  for (int k = 0; k < GATHER_ROWS; ++k) {
    e[k] = row0 + (long)k * per_warp;
    src[k] = e[k] < n_edges ? (long)__ldg(idx + e[k]) * nvec : -1;
  }
  for (int c = lane % g_lanes; c < nvec; c += g_lanes) {
    V v[GATHER_ROWS];
#pragma unroll
    for (int k = 0; k < GATHER_ROWS; ++k) {
      if (src[k] >= 0) v[k] = __ldg(values + src[k] + c);
    }
#pragma unroll
    for (int k = 0; k < GATHER_ROWS; ++k) {
      if (src[k] >= 0) out[e[k] * nvec + c] = v[k];
    }
  }
}

constexpr int MAX_NV = 8;

// lanes per row group: the row's vectors rounded up to a power of 2, at most 32
inline int group_lanes(int nvec) {
  int g = 1;
  while (g < nvec && g < 32) g *= 2;
  return g;
}

template <typename T, int VEC, int NV>
cudaError_t launch_tiles(const T* msgs, const int* rowptr, const int* perm, int n, int rows, int f,
                         int g_lanes, float* out, void* scratch, int nblk, cudaStream_t stream) {
  const int gpb = THREADS / g_lanes;
  // within the 48 KB a launch may take without opting in (F <= 512 at 8 groups a block), so
  // the launch sets no attribute and can be captured in a CUDA graph
  const size_t smem = (size_t)gpb * (2 * f * sizeof(float) + 3 * sizeof(int));
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  segment_tiles_kernel<T, VEC, NV><<<nblk, THREADS, smem, stream>>>(msgs, rowptr, perm, n, rows, f,
                                                                   g_lanes, out, scratch, nblk);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_tiles_nv(const T* msgs, const int* rowptr, const int* perm, int n, int rows,
                            int f, int g_lanes, float* out, void* scratch, int nblk,
                            cudaStream_t stream) {
  const int nv = ((f + VEC - 1) / VEC + g_lanes - 1) / g_lanes;
  if (nv > MAX_NV) return cudaErrorInvalidValue;
  if (nv == 1) {
    return launch_tiles<T, VEC, 1>(msgs, rowptr, perm, n, rows, f, g_lanes, out, scratch, nblk,
                                      stream);
  }
  if (nv == 2) {
    return launch_tiles<T, VEC, 2>(msgs, rowptr, perm, n, rows, f, g_lanes, out, scratch, nblk,
                                      stream);
  }
  if (nv <= 4) {
    return launch_tiles<T, VEC, 4>(msgs, rowptr, perm, n, rows, f, g_lanes, out, scratch, nblk,
                                   stream);
  }
  return launch_tiles<T, VEC, MAX_NV>(msgs, rowptr, perm, n, rows, f, g_lanes, out, scratch, nblk,
                                      stream);
}

template <typename T>
int launch_sum(const T* msgs, const int* rowptr, const int* perm, float* out, int n, int rows,
               int f, void* scratch, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n <= 0 || f <= 0) return cudaGetLastError();
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = f % VEC == 0 && reinterpret_cast<uintptr_t>(msgs) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int nvec = vec ? f / VEC : f;
  const int g_lanes = group_lanes(nvec);
  const int rows_per_block = TILE * (THREADS / g_lanes);
  const int nblk = (rows + rows_per_block - 1) / rows_per_block;
  if (rows > 0) {
    cudaError_t err =
        vec ? launch_tiles_nv<T, VEC>(msgs, rowptr, perm, n, rows, f, g_lanes, out, scratch, nblk,
                                      stream)
            : launch_tiles_nv<T, 1>(msgs, rowptr, perm, n, rows, f, g_lanes, out, scratch, nblk,
                                    stream);
    if (err != cudaSuccess) return err;
  }
  const int warps = nblk > (n + 31) / 32 ? nblk : (n + 31) / 32;
  const int per_block = THREADS / 32;
  // launched as kernel 1's programmatic dependent: its launch and its zeros of empty nodes
  // overlap kernel 1's last blocks
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((warps + per_block - 1) / per_block);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const void* cscratch = scratch;
  cudaError_t err =
      cudaLaunchKernelEx(&cfg, segment_blocks_kernel, rowptr, n, f, cscratch, nblk, out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename V>
cudaError_t launch_gather_words(const V* values, const int* idx, V* out, int n_edges, int nvec,
                                cudaStream_t stream) {
  const int g_lanes = group_lanes(nvec);
  const long rows_per_block = (long)GATHER_ROWS * (32 / g_lanes) * (THREADS / 32);
  const long blocks = (n_edges + rows_per_block - 1) / rows_per_block;
  gather_rows_kernel<V><<<(unsigned)blocks, THREADS, 0, stream>>>(values, idx, n_edges, nvec,
                                                                  g_lanes, out);
  return cudaGetLastError();
}

template <typename T>
int launch_gather(const T* values, const int* idx, T* out, int n_edges, int f, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_edges <= 0 || f <= 0) return cudaGetLastError();
  const long bytes = (long)f * sizeof(T);
  const bool vec = bytes % 16 == 0 && reinterpret_cast<uintptr_t>(values) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    return launch_gather_words(reinterpret_cast<const uint4*>(values), idx,
                               reinterpret_cast<uint4*>(out), n_edges, (int)(bytes / 16), stream);
  }
  using W = typename std::conditional<sizeof(T) == 4, unsigned, unsigned short>::type;
  return launch_gather_words(reinterpret_cast<const W*>(values), idx, reinterpret_cast<W*>(out),
                             n_edges, f, stream);
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// msgs [rows, F] f32; rowptr [N + 1] int32 (rowptr[0] = 0, rowptr[N] = rows); perm [rows] int32
// or null; out [N, F] f32; scratch of ceil(rows / 128) (2 F + 3) 4-byte words (a block takes at
// least 8 groups of TILE = 16 rows, and keeps 2 F + 3 words of partials). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for F > 512 (F > 256 on the scalar path).
int sorted_segment_sum(const float* msgs, const int* rowptr, const int* perm, float* out, int n,
                       int rows, int f, void* scratch, void* stream_ptr) {
  return launch_sum(msgs, rowptr, perm, out, n, rows, f, scratch, stream_ptr);
}

// The same with msgs [rows, F] bf16; the sums and out stay f32.
int sorted_segment_sum_bf16(const __nv_bfloat16* msgs, const int* rowptr, const int* perm,
                            float* out, int n, int rows, int f, void* scratch, void* stream_ptr) {
  return launch_sum(msgs, rowptr, perm, out, n, rows, f, scratch, stream_ptr);
}

// values [N, F] f32; idx [E] int32 (each in [0, N)); out [E, F] f32. Returns cudaGetLastError().
int sorted_gather(const float* values, const int* idx, float* out, int n_edges, int f,
                  void* stream_ptr) {
  return launch_gather(values, idx, out, n_edges, f, stream_ptr);
}

// The same with values and out bf16.
int sorted_gather_bf16(const __nv_bfloat16* values, const int* idx, __nv_bfloat16* out,
                       int n_edges, int f, void* stream_ptr) {
  return launch_gather(values, idx, out, n_edges, f, stream_ptr);
}

}  // extern "C"
