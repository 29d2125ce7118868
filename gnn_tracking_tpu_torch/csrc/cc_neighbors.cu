// Connected components over a fixed-degree neighbour table, for Hopper (sm_90a).
//
// Replaces the TPU kernel gnn_tracking_tpu/ops/pallas/cc_kernel.py::cc_neighbors_pallas
// (_cc_kernel), whose contract is gnn_tracking_tpu/ops/cc.py::connected_components_neighbors:
// neighbor_idx [N, k] with validity mask [N, k] describes a symmetric graph; the result labels
// every node with the minimum node index of its component.
//
// What bounds it on this card: memory traffic. The table is read once from device memory (N k
// (4 + 1) bytes: 10.5 MB at N = 32768, k = 64, 3.1 us at 3.35 TB/s); later sweeps find it in L2
// (50 MB), with a label gathered per unmasked entry. The sweeps depend on the components'
// diameters (a handful for DBSCAN's track-sized clusters, thanks to pointer jumping). The grid
// barrier between sweeps costs a few microseconds, as much as a sweep from L2 at that size.
// Design: the whole fixed-point loop in ONE launch, as the TPU kernel runs it in one pallas_call.
//  * A cooperative persistent grid (cudaLaunchCooperativeKernel; as many blocks as are resident
//    at once, by occupancy) with a grid barrier between sweeps; the "changed" word and the error
//    word are tested on the device, and the call ends in one read back of (sweeps, error).
//  * Sweep 1 reads the index table itself (labels == iota: labels[neighbor_idx] is
//    neighbor_idx, ops/cc.py:124-131), so it gathers no label; it takes no pointer jumps (no
//    label is written before it ends), and it checks every unmasked index: a node with one
//    outside [0, N) writes its label with the sign bit set, and sweep 2, which meets every such
//    label (the node's own, a neighbour's or a jump's target), raises the error word and ends
//    the loop before any negative label is followed. A flagged row's own thread raises it
//    without gathering: only rows whose indices all lie in [0, N) are ever gathered through.
//  * A thread a node: with k % 4 == 0 it reads its row's indices as 16-byte vectors and the mask
//    bytes as one 4-byte word per 4 entries, gathers only the unmasked entries' labels, and runs
//    its own pointer jumps, so a warp follows 32 chains at once. Chosen by measurement on an
//    H100 (PERF.md, row #16): 2, 4, 8, 16 or 32 lanes a node (a butterfly for the row minimum,
//    the jumps on one lane) were no faster on a served event's table (within 3 %) and 1.6-3.5x
//    slower on a permuted chain.
//  * Labels only ever decrease and always name a node of the same component, so reading labels
//    that other threads update within a sweep is safe (reads go to L2, never a stale L1 line);
//    a sweep that changes nothing proves the fixed point, which for a symmetric table is the
//    component minimum: the labels are bitwise the plain version's, however the sweeps
//    interleave. The loop stops there, or after max_sweeps sweeps (N: a component's diameter is
//    below N, and after s sweeps every label is at most the least index within s hops).
//  * Three rotating "changed" words: sweep s raises word s % 3 and clears word (s + 1) % 3,
//    which no thread reads again before sweep s + 1 starts; sweep 1 clears all of them and the
//    error word, so the scratch needs no initialisation.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int BAD = INT_MIN;  // the sign bit: a label whose row holds an unmasked index outside [0, n)

// f(j) for each unmasked index j of a row: VEC (k % 4 == 0, aligned) as an int4 of indices and a
// word of mask bytes per 4 entries
template <bool VEC, typename F>
__device__ __forceinline__ void row_entries(const int* __restrict__ row,
                                            const uint8_t* __restrict__ mrow, int k, F f) {
  if constexpr (VEC) {
    for (int c = 0; c < k / 4; ++c) {
      const int4 j = __ldg(reinterpret_cast<const int4*>(row) + c);
      const unsigned m = __ldg(reinterpret_cast<const unsigned*>(mrow) + c);
      if (m & 0xffu) f(j.x);
      if (m & 0xff00u) f(j.y);
      if (m & 0xff0000u) f(j.z);
      if (m & 0xff000000u) f(j.w);
    }
  } else {
    for (int c = 0; c < k; ++c) {
      if (__ldg(mrow + c)) f(__ldg(row + c));
    }
  }
}

// state: [0..2] the rotating "changed" words, [3] the error word (scratch, any content), then
// the stats it writes at the end: [4] sweeps run, [5] 1 where an unmasked index lies outside
// [0, n), else 0.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
cc_kernel(const int* __restrict__ idx, const uint8_t* __restrict__ mask, int* labels,
          int* state, int n, int k, int max_sweeps, int jumps) {
  cg::grid_group grid = cg::this_grid();
  const long first = (long)blockIdx.x * THREADS + threadIdx.x;
  const long stride = (long)gridDim.x * THREADS;
  volatile int* vstate = state;

  // ---- sweep 1: labels = min(i, the row's unmasked indices), the indices checked
  if (blockIdx.x == 0 && threadIdx.x < 4) vstate[threadIdx.x] = 0;
  for (long node = first; node < n; node += stride) {
    int m = (int)node;
    bool bad = false;
    row_entries<VEC>(idx + node * k, mask + node * k, k, [&](int j) {
      if (j < 0 || j >= n) {
        bad = true;
      } else {
        m = min(m, j);
      }
    });
    __stcg(labels + node, m | (bad ? BAD : 0));
  }
  grid.sync();

  int sweep = 1;
  int err = 0;
  while (true) {
    ++sweep;
    const int slot = sweep % 3;
    if (blockIdx.x == 0 && threadIdx.x == 0) vstate[(sweep + 1) % 3] = 0;
    bool changed = false, bad = false;
    for (long node = first; node < n; node += stride) {
      const int cur = __ldcg(labels + node);
      if (cur < 0) {  // a flagged row (sweep 2 only): an index of it lies outside [0, n), so its
        bad = true;   // labels are never gathered
        continue;
      }
      int v = cur;  // negative below: a neighbour's flagged label (sweep 2 only)
      row_entries<VEC>(idx + node * k, mask + node * k, k,
                       [&](int j) { v = min(v, __ldcg(labels + j)); });
      for (int s = 0; s < jumps && v >= 0; ++s) {
        const int l = __ldcg(labels + v);
        if (l >= v) break;  // a root: the next hops read it again
        v = l;              // (a flagged target makes v negative and ends the jumps)
      }
      if (v < 0) {
        bad = true;
      } else if (v < cur) {
        __stcg(labels + node, v);
        changed = true;
      }
    }
    changed = __syncthreads_or(changed);
    bad = __syncthreads_or(bad);
    if (threadIdx.x == 0) {
      if (changed) vstate[slot] = 1;
      if (bad) vstate[3] = 1;
    }
    grid.sync();
    err = vstate[3];
    if (err || !vstate[slot] || sweep >= max_sweeps) break;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    state[4] = sweep;
    state[5] = err;
  }
}

template <bool VEC>
cudaError_t launch(const int* idx, const uint8_t* mask, int* labels, int* state, int n, int k,
                   int max_sweeps, int jumps, cudaStream_t stream) {
  static int per_sm = -1, sms = 0;  // the occupancy of this instantiation, asked once
  auto kernel = cc_kernel<VEC>;
  if (per_sm < 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
    }
    if (err != cudaSuccess) {
      per_sm = -1;
      return err;
    }
  }
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long want = ((long)n + THREADS - 1) / THREADS;
  const long resident = (long)sms * per_sm;
  const unsigned blocks = (unsigned)(want < resident ? want : resident);
  void* args[] = {&idx, &mask, &labels, &state, &n, &k, &max_sweeps, &jumps};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(blocks),
                                     dim3(THREADS), args, 0, stream);
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// idx [n, k] i32 and mask [n, k] u8 (0 / 1), contiguous; labels [n] i32 output; state: 6 ints of
// device scratch (any content); stats: 2 host ints (pinned memory: one short copy), written as
// (sweeps, 1 if an unmasked index lies outside [0, n) else 0), the labels being undefined then.
// The loop runs at most max(max_sweeps, 2) sweeps (sweep 2 checks the indices). One cooperative
// launch on `stream`, then the call's one read back: the two stats words, after which the stream
// is synchronised.
int cc_neighbors(const int* idx, const uint8_t* mask, int* labels, int* state, int* stats, int n,
                 int k, int max_sweeps, int jumps, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n <= 0 || k < 0 || jumps < 0) return cudaErrorInvalidValue;
  if (max_sweeps < 2) max_sweeps = 2;
  const bool vec = k % 4 == 0 && reinterpret_cast<uintptr_t>(idx) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(mask) % 4 == 0;
  cudaError_t err = vec ? launch<true>(idx, mask, labels, state, n, k, max_sweeps, jumps, stream)
                        : launch<false>(idx, mask, labels, state, n, k, max_sweeps, jumps, stream);
  if (err != cudaSuccess) return err;
  err = cudaMemcpyAsync(stats, state + 4, 2 * sizeof(int), cudaMemcpyDeviceToHost, stream);
  if (err != cudaSuccess) return err;
  return cudaStreamSynchronize(stream);
}

}  // extern "C"
