// Connected components over a fixed-degree neighbour table, for Hopper (sm_90a).
//
// Replaces the TPU kernel gnn_tracking_tpu/ops/pallas/cc_kernel.py::cc_neighbors_pallas
// (_cc_kernel), whose contract is gnn_tracking_tpu/ops/cc.py::connected_components_neighbors:
// neighbor_idx [N, k] with validity mask [N, k] describes a symmetric graph; the result labels
// every node with the minimum node index of its component.
//
// What bounds it on this card: memory traffic per sweep. A sweep reads the table
// (N k (4 + 1) bytes: 10.5 MB at N = 32768, k = 64) plus a label per valid entry; the number
// of sweeps depends on the components' diameters (a handful for DBSCAN's track-sized clusters,
// thanks to pointer jumping). The host round trip that reads the "changed" flag after every
// sweep costs as much as a sweep at these sizes.
// Design (the multi-sweep variant, not the single-block one): one warp per node reads its row
// coalesced, takes the minimum label over the valid neighbours with a warp reduction, then lane 0
// follows label pointers `jumps` times and lowers its label in place, raising a device flag if it
// changed. Labels only ever decrease and always name a node of the same component, so reading
// labels that other warps are updating in the same sweep is safe; a sweep that changes nothing
// proves the fixed point, which for a symmetric table is the component minimum. The loop stops
// there, or after max_sweeps sweeps.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

__global__ void iota_kernel(int* __restrict__ labels, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) labels[i] = i;
}

__global__ void sweep_kernel(const int* __restrict__ idx, const uint8_t* __restrict__ mask,
                             int* labels, int* changed, int n, int k, int jumps) {
  const long gt = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long node = gt >> 5;
  const int lane = threadIdx.x & 31;
  if (node >= n) return;  // uniform per warp
  const long row = node * k;
  int m = INT_MAX;
  for (int j = lane; j < k; j += 32) {
    if (mask[row + j]) m = min(m, labels[idx[row + j]]);
  }
  m = __reduce_min_sync(0xffffffffu, m);
  if (lane == 0) {
    const int cur = labels[node];
    m = min(m, cur);
    for (int s = 0; s < jumps; ++s) m = min(m, labels[m]);
    if (m < cur) {
      labels[node] = m;
      *changed = 1;
    }
  }
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// labels [n] i32 output; changed: one device int of scratch; sweeps_out: host int.
int cc_neighbors(const int* idx, const uint8_t* mask, int* labels, int* changed, int n, int k,
                 int max_sweeps, int jumps, int* sweeps_out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  *sweeps_out = 0;
  if (n == 0) return cudaSuccess;
  iota_kernel<<<(n + 255) / 256, 256, 0, stream>>>(labels, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long threads = (long)n * 32;
  const unsigned grid = (unsigned)((threads + 255) / 256);
  int host_changed = 1;
  int sweeps = 0;
  while (host_changed && sweeps < max_sweeps) {
    err = cudaMemsetAsync(changed, 0, sizeof(int), stream);
    if (err != cudaSuccess) return err;
    sweep_kernel<<<grid, 256, 0, stream>>>(idx, mask, labels, changed, n, k, jumps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++sweeps;
    err = cudaMemcpyAsync(&host_changed, changed, sizeof(int), cudaMemcpyDeviceToHost, stream);
    if (err != cudaSuccess) return err;
    err = cudaStreamSynchronize(stream);
    if (err != cudaSuccess) return err;
  }
  *sweeps_out = sweeps;
  return cudaGetLastError();
}

}  // extern "C"
