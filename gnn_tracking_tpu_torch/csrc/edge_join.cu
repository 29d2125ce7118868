// The geometric layer-pair join of graph building, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is the counterpart of the JAX package's host-native join
// (csrc/edge_join.cpp:49-103, bound by gnn_tracking_tpu/native.py), which in turn replaced the
// numpy cross join of gnn_tracking_tpu/graph_construction/graph_builder.py:161-200. It is the hot
// loop of the graph-building ETL: a full TrackML event holds ~3.3e8 candidate pairs of hits over
// the 23 adjacent pixel layer pairs, of which ~1e6 survive the cuts.
//
// For every layer pair (l1, l2) of the table and every hit i on l1 and j on l2, in float64:
//   dr = r_j - r_i; dphi = phi_j - phi_i wrapped to [-pi, pi]; dz = z_j - z_i;
//   dR = sqrt(deta^2 + dphi^2), eta = -log(tan(atan2(r, z) / 2));
//   kept where |dphi / dr| < phi_slope_max, |z_i - r_i dz / dr| < z0_max and dR < dR_max, and,
//   for a pair with an intersecting-layer radius R, where R dz / dr + z0 is not inside
//   (-z_bound, z_bound).
// Outputs (index_1, index_2, dr, dphi, dz, dR) in the JAX order: pairs in table order, within a
// pair the hits of l1 in ascending index, each with its hits of l2 in ascending index.
//
// What bounds it on this card: FP64 operations. ~12 operations a candidate pair for the cuts
// (a division in the slope cut, another in the z0 cut, a square root in the dR cut), against a
// few bytes a hit in and 48 bytes an edge out.
//
// Design:
//  * prepare_kernel gathers the hits in (layer, index) order (the wrapper's stable sort by layer)
//    and casts r, phi, z to float64, and computes eta once a hit: a function of one hit, so its
//    bits equal those of a computation per pair;
//  * count_kernel: a warp takes one row (a hit of l1 in one pair) and walks the hits of l2 32 at a
//    time, one a lane; the cuts are evaluated in the order slope, z0, dR, intersect, and a pair
//    stops at its first failed cut (most pairs fail the slope cut); a ballot counts the row's
//    edges. All pairs of the event are one launch: rows are numbered across the pair table, and a
//    warp finds its pair by a binary search of the table's first rows;
//  * scan_kernel (one block) turns the row counts into each row's first output position and the
//    edge count, which the wrapper reads to size the outputs;
//  * write_kernel repeats count_kernel's walk and writes each kept pair at the row's position plus
//    the edges before it: the ballot's lower lanes and the earlier steps of the walk. So the
//    order within a row is l2's index order, with no sort.
// Arithmetic: every operation is a correctly rounded float64 intrinsic (__dadd_rn, __dmul_rn,
// __ddiv_rn, __dsqrt_rn), so nvcc contracts nothing into an FMA (deta*deta + dphi*dphi would
// otherwise become one and change dR's bits), and atan2 / tan / log are libdevice's, as in
// torch's float64 kernels: the plain torch version on the card gives the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TABLE_COLS = 6;  // start_1, n_1, start_2, n_2, first row, intersect flag
constexpr unsigned FULL = 0xffffffffu;
constexpr double kPi = 3.14159265358979323846;
constexpr double kTwoPi = 2 * kPi;

struct Cuts {
  double phi_slope_max, z0_max, dR_max, z_bound;
};

struct Pair {
  int start1, n1, start2, n2, row0, intersect;
  double layer_r;
};

__device__ __forceinline__ Pair find_pair(const int* __restrict__ table, const double* __restrict__ radii,
                                          int n_pairs, int row) {
  int lo = 0, hi = n_pairs - 1;  // the last pair whose first row is <= row
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (__ldg(table + mid * TABLE_COLS + 4) <= row) lo = mid; else hi = mid - 1;
  }
  const int* t = table + lo * TABLE_COLS;
  return {__ldg(t), __ldg(t + 1), __ldg(t + 2), __ldg(t + 3), __ldg(t + 4), __ldg(t + 5),
          __ldg(radii + lo)};
}

// The cuts on one candidate pair; on success dr, dphi, dz, dR hold the edge's attributes.
__device__ __forceinline__ bool keep(double r1, double phi1, double z1, double eta1, double r2, double phi2,
                                     double z2, double eta2, const Cuts& c, bool intersect, double layer_r,
                                     double& dr, double& dphi, double& dz, double& dR) {
  dr = __dsub_rn(r2, r1);
  dphi = __dsub_rn(phi2, phi1);
  if (dphi > kPi) dphi = __dsub_rn(dphi, kTwoPi);
  if (dphi < -kPi) dphi = __dadd_rn(dphi, kTwoPi);
  const double phi_slope = __ddiv_rn(dphi, dr);
  if (!(fabs(phi_slope) < c.phi_slope_max)) return false;
  dz = __dsub_rn(z2, z1);
  const double z0 = __dsub_rn(z1, __ddiv_rn(__dmul_rn(r1, dz), dr));
  if (!(fabs(z0) < c.z0_max)) return false;
  const double deta = __dsub_rn(eta2, eta1);
  dR = __dsqrt_rn(__dadd_rn(__dmul_rn(deta, deta), __dmul_rn(dphi, dphi)));
  if (!(dR < c.dR_max)) return false;
  if (intersect) {
    const double z_coord = __dadd_rn(__ddiv_rn(__dmul_rn(layer_r, dz), dr), z0);
    if (z_coord > -c.z_bound && z_coord < c.z_bound) return false;
  }
  return true;
}

__global__ void prepare_kernel(const float* __restrict__ r, const float* __restrict__ phi,
                               const float* __restrict__ z, const int* __restrict__ order,
                               double* __restrict__ hits, int n) {
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < n; s += gridDim.x * blockDim.x) {
    const int i = __ldg(order + s);
    const double rr = static_cast<double>(__ldg(r + i));
    const double zz = static_cast<double>(__ldg(z + i));
    hits[s] = rr;
    hits[n + s] = static_cast<double>(__ldg(phi + i));
    hits[2 * n + s] = zz;
    hits[3 * n + s] = -log(tan(__ddiv_rn(atan2(rr, zz), 2.0)));
  }
}

// WRITE = false: counts[row] = the row's edges. WRITE = true: the edges at offsets[row].
template <bool WRITE>
__global__ void __launch_bounds__(THREADS) join_kernel(
    const double* __restrict__ hits, int n, const int* __restrict__ order, const int* __restrict__ table,
    const double* __restrict__ radii, int n_pairs, int rows, Cuts cuts, int* __restrict__ counts,
    const long long* __restrict__ offsets, long long* __restrict__ out_i1, long long* __restrict__ out_i2,
    double* __restrict__ out_dr, double* __restrict__ out_dphi, double* __restrict__ out_dz,
    double* __restrict__ out_dR) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const double* __restrict__ hr = hits;
  const double* __restrict__ hphi = hits + n;
  const double* __restrict__ hz = hits + 2 * n;
  const double* __restrict__ heta = hits + 3 * n;
  const int n_warps = gridDim.x * WARPS;
  for (int row = blockIdx.x * WARPS + threadIdx.x / 32; row < rows; row += n_warps) {
    const Pair p = find_pair(table, radii, n_pairs, row);
    const int a = p.start1 + (row - p.row0);
    const double r1 = __ldg(hr + a), phi1 = __ldg(hphi + a), z1 = __ldg(hz + a), eta1 = __ldg(heta + a);
    long long pos = WRITE ? __ldg(offsets + row) : 0;
    const long long i1 = WRITE ? static_cast<long long>(__ldg(order + a)) : 0;
    int found = 0;
    for (int b0 = 0; b0 < p.n2; b0 += 32) {
      const int b = p.start2 + b0 + lane;
      double dr = 0, dphi = 0, dz = 0, dR = 0;
      const bool ok = b0 + lane < p.n2 &&
                      keep(r1, phi1, z1, eta1, __ldg(hr + b), __ldg(hphi + b), __ldg(hz + b), __ldg(heta + b),
                           cuts, p.intersect != 0, p.layer_r, dr, dphi, dz, dR);
      const unsigned votes = __ballot_sync(FULL, ok);
      if (WRITE && ok) {
        const long long at = pos + __popc(votes & below);
        out_i1[at] = i1;
        out_i2[at] = static_cast<long long>(__ldg(order + b));
        out_dr[at] = dr;
        out_dphi[at] = dphi;
        out_dz[at] = dz;
        out_dR[at] = dR;
      }
      pos += __popc(votes);
      found += __popc(votes);
    }
    if (!WRITE && lane == 0) counts[row] = found;
  }
}

// One block: offsets[k] = counts[0] + ... + counts[k - 1], offsets[rows] = the sum of all.
__global__ void __launch_bounds__(1024) scan_kernel(const int* __restrict__ counts, long long* __restrict__ offsets,
                                                    int rows) {
  __shared__ long long warp_sums[32];
  const int t = threadIdx.x, lane = t & 31, warp = t / 32;
  const int per = (rows + blockDim.x - 1) / blockDim.x;
  const int lo = min(rows, t * per), hi = min(rows, lo + per);
  long long own = 0;
  for (int k = lo; k < hi; ++k) own += counts[k];
  long long incl = own;
  for (int d = 1; d < 32; d <<= 1) {
    const long long v = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const long long w = lane < static_cast<int>(blockDim.x / 32) ? warp_sums[lane] : 0;
    long long s = w;
    for (int d = 1; d < 32; d <<= 1) {
      const long long v = __shfl_up_sync(FULL, s, d);
      if (lane >= d) s += v;
    }
    warp_sums[lane] = s - w;
  }
  __syncthreads();
  long long run = warp_sums[warp] + incl - own;
  for (int k = lo; k < hi; ++k) {
    offsets[k] = run;
    run += counts[k];
  }
  if (t == static_cast<int>(blockDim.x) - 1) offsets[rows] = run;
}

int join_blocks(int rows) {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long want = (static_cast<long long>(rows) + WARPS - 1) / WARPS;
  return static_cast<int>(want < 16LL * sms ? want : 16LL * sms);
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// r, phi, z: float32 [n]; order: int32 [n], the hits in (layer, index) order; hits: float64
// [4, n] scratch (r, phi, z, eta in that order); table: int32 [n_pairs, 6] (start_1, n_1,
// start_2, n_2, first row, intersect flag; starts into the order, first rows ascending from 0);
// radii: float64 [n_pairs]; rows: the sum of n_1; counts: int32 [rows] out; offsets: int64
// [rows + 1] out (offsets[rows] = the edge count). Returns cudaGetLastError().
int edge_join_count(const float* r, const float* phi, const float* z, const int* order, double* hits, int n,
                    const int* table, const double* radii, int n_pairs, int rows, double phi_slope_max,
                    double z0_max, double dR_max, double z_bound, int* counts, long long* offsets,
                    void* stream_ptr) {
  if (n_pairs <= 0 || rows <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Cuts cuts{phi_slope_max, z0_max, dR_max, z_bound};
  prepare_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(r, phi, z, order, hits, n);
  join_kernel<false><<<join_blocks(rows), THREADS, 0, stream>>>(hits, n, order, table, radii, n_pairs, rows, cuts,
                                                                counts, nullptr, nullptr, nullptr, nullptr,
                                                                nullptr, nullptr, nullptr);
  scan_kernel<<<1, 1024, 0, stream>>>(counts, offsets, rows);
  return static_cast<int>(cudaGetLastError());
}

// hits, order, table, radii as filled / given to edge_join_count; offsets its output; out_*:
// [offsets[rows]] (int64 hit indices, float64 attributes). Returns cudaGetLastError().
int edge_join_write(const double* hits, const int* order, int n, const int* table, const double* radii,
                    const long long* offsets, int n_pairs, int rows, double phi_slope_max, double z0_max,
                    double dR_max, double z_bound, long long* out_i1, long long* out_i2, double* out_dr,
                    double* out_dphi, double* out_dz, double* out_dR, void* stream_ptr) {
  if (n_pairs <= 0 || rows <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Cuts cuts{phi_slope_max, z0_max, dR_max, z_bound};
  join_kernel<true><<<join_blocks(rows), THREADS, 0, stream>>>(hits, n, order, table, radii, n_pairs, rows, cuts,
                                                               nullptr, offsets, out_i1, out_i2, out_dr,
                                                               out_dphi, out_dz, out_dR);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
