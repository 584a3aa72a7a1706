// rand_tail.cu — the tail of the fused randomized-projection pair update:
// reduced one-sided Jacobi, top-chi selection, truncation and the vh rows,
// for sm_90a.
//
// Replaces the Pallas TPU kernel aqc_research_tpu/ops/fused_rand.py:
// _rand_tail_raw (body _rand_tail_kernel_body), pass C of the fused rand
// route, and computes what it computes, per matrix:
//
//   1. the adaptive Jacobi (K1's loop) on the (ell, n) planes (Re B, -Im B)
//      = conj(B), B = Q^H theta the projected pair matrix: row j of the
//      rotated planes is (s_j u_j)^T of B^H;
//   2. the epilogue shared with K4 (rank_truncate.cuh): row norms, the
//      stable top-chi selection, the 32 eps noise guard, the discarded-weight
//      rule against the FULL theta weight tot2, lambda and 1/s;
//   3. vh rows = (w_re inv, -w_im inv) of the selected rows.
//
// The Pallas kernel's sentinel lane padding, chunk floor and padded-slot
// weights are Mosaic artefacts and have no counterpart here: each matrix
// stops on its own, as its chunk = 1 would.
//
// Design: where the planes live decides the kernel (the "home", chosen in
// Python by ops/fused_rand.tail_plane_home, never by trying a launch).
//   * cluster (ell <= 256, n <= 256 on an H100: chi = 64, 72 rows of 128
//     lanes, and chi = 128, 136 rows of 256 lanes): ``cluster`` CTAs per
//     matrix hold the rows by seat in their shared memory and run
//     cluster_sweeps.cuh (a warp per row pair, one cluster barrier per
//     phase).  Then K4's cluster epilogue: each CTA takes the norms of the
//     rows it holds, gathers all ell of them through distributed shared
//     memory, and runs the same select_truncate against the input tot2;
//     each vh row is written by the CTA that holds the selected row;
//   * shared (the heads the rule keeps on one block): one block of up to 8
//     warps per matrix holds the planes in its shared memory
//     (seat_sweeps.cuh);
//   * global (past the cluster's shapes): one block per matrix rotates a
//     scratch pair in device memory that the wrapper allocates.
// Device memory is read once and only the chi selected rows are written,
// except in the global home.  The sweep count is an output.
//
// Bounds.  Like K1: the chain of a phase and its barrier; a one-block home
// gives a matrix one SM (B ~ 10-14 of 132 SMs busy) and a warp several
// pairs in series, the cluster home every pair its own warp on up to 8 SMs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster_sweeps.cuh"
#include "rank_truncate.cuh"
#include "seat_sweeps.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kHomeShared = 0, kHomeCluster = 1, kHomeGlobal = 2;

// One block per matrix.  kSmemPlanes: the planes live in dynamic shared
// memory; otherwise in the scratch planes wk_re/wk_im (batch, ell, n) in
// device memory.
template <bool kSmemPlanes>
__global__ void __launch_bounds__(kSmemPlanes ? aqc::kSmemThreads : aqc::kMaxThreads)
rand_tail_kernel(const float* __restrict__ m_re, const float* __restrict__ m_im,
                 const float* __restrict__ tot2_in, float* wk_re, float* wk_im,
                 float* __restrict__ vh_re, float* __restrict__ vh_im,
                 float* __restrict__ lam_out, float* __restrict__ inv_out,
                 int* __restrict__ sweeps_out, int ell, int n, int chi, int max_sweeps,
                 int hybrid, float thr2) {
  extern __shared__ float smem[];
  __shared__ int s_go;
  const size_t in_base = static_cast<size_t>(blockIdx.x) * ell * n;
  float* w_re;
  float* w_im;
  float* stats;
  if constexpr (kSmemPlanes) {
    w_re = smem;
    w_im = w_re + ell * n;
    stats = w_im + ell * n;
  } else {
    w_re = wk_re + in_base;
    w_im = wk_im + in_base;
    stats = smem;
  }
  const aqc::RankScratch rs(stats + aqc::seat_stats_floats(ell), ell, chi);

  for (int i = threadIdx.x; i < ell * n; i += blockDim.x) {
    w_re[i] = m_re[in_base + i];
    w_im[i] = m_im[in_base + i];
  }
  __syncthreads();

  const int k = aqc::adaptive_seat_sweeps(w_re, w_im, stats, &s_go, ell, n, max_sweeps, hybrid);

  const size_t o = static_cast<size_t>(blockIdx.x) * chi;
  aqc::rank_truncate(w_re, w_im, ell, n, chi, false, tot2_in[blockIdx.x], thr2, rs,
                     lam_out + o, inv_out + o);
  if (threadIdx.x == 0) sweeps_out[blockIdx.x] = k;

  // ---- vh rows: conj of the selected rows, scaled by 1/s ----
  const size_t out_base = static_cast<size_t>(blockIdx.x) * chi * n;
  for (int i = threadIdx.x; i < chi * n; i += blockDim.x) {
    const int row = i / n, e = i - row * n;
    const float inv = rs.inv[row];
    const int src = rs.sel[row] * n + e;
    vh_re[out_base + i] = w_re[src] * inv;
    vh_im[out_base + i] = -(w_im[src] * inv);
  }
}

// A cluster of ``cluster`` CTAs per matrix (blocks mat * cluster ..), the
// rows by seat in their distributed shared memory (the file comment).
template <int kQ>
__global__ void __launch_bounds__(aqc::kClusterMaxThreads)
rand_tail_cluster_kernel(const float* __restrict__ m_re, const float* __restrict__ m_im,
                         const float* __restrict__ tot2_in, float* __restrict__ vh_re,
                         float* __restrict__ vh_im, float* __restrict__ lam_out,
                         float* __restrict__ inv_out, int* __restrict__ sweeps_out, int ell,
                         int n, int chi, int cluster, int max_sweeps, int hybrid, float thr2) {
  cg::cluster_group grp = cg::this_cluster();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ int s_go;

  const int me = static_cast<int>(grp.block_rank());
  const int mat = blockIdx.x / cluster;
  const int half = ell / 2;  // seats of each side: row j in L[j], row half + j in R[j]
  const int pairs_per = aqc::cluster_pairs_per_cta(ell, cluster);
  const int seat0 = me * pairs_per;
  const int held = max(0, min(pairs_per, half - seat0));
  float* stats = smem;
  const int stats_floats = aqc::cluster_stats_floats(ell, cluster);
  const aqc::RankScratch rs(stats + stats_floats, ell, chi);
  float* w_re = smem + aqc::cluster_head_floats(ell, cluster, aqc::rank_truncate_floats(ell, chi));
  float* w_im = w_re + aqc::cluster_seat_floats(ell, n, cluster) / 2;
  const size_t in_base = static_cast<size_t>(mat) * ell * n;

  // ---- 1. the rows of this CTA's seats; the sweeps ----
  for (int side = 0; side < 2; ++side) {
    const size_t src = in_base + static_cast<size_t>(side * half + seat0) * n;
    float* dre = aqc::seat_slot(w_re, 0, side, 0, pairs_per, n);
    float* dim = aqc::seat_slot(w_im, 0, side, 0, pairs_per, n);
    for (int i = threadIdx.x; i < held * n; i += blockDim.x) {
      dre[i] = m_re[src + i];
      dim[i] = m_im[src + i];
    }
  }
  grp.sync();
  int cur = 0;
  const int k = aqc::cluster_seat_sweeps<kQ>(w_re, w_im, stats, &s_go, ell, n, cluster,
                                             max_sweeps, hybrid, cur);

  // ---- 2. the norms of the rows held here, then of all rows: every CTA
  //         ranks the same numbers and applies the same rule ----
  for (int side = 0; side < 2; ++side) {
    aqc::row_norms(aqc::seat_slot(w_re, cur, side, 0, pairs_per, n),
                   aqc::seat_slot(w_im, cur, side, 0, pairs_per, n), held, n,
                   rs.s2 + side * half + seat0);
  }
  grp.sync();  // also ends the stats warps' last reads of the statistics
  for (int i = threadIdx.x; i < ell; i += blockDim.x) {
    const int owner = (i % half) / pairs_per;
    if (owner != me) rs.s2[i] = *grp.map_shared_rank(rs.s2 + i, owner);
  }
  grp.sync();  // every CTA holds all norms; no CTA reads another's shared memory after this
  const size_t o = static_cast<size_t>(mat) * chi;
  aqc::select_truncate(rs, ell, chi, false, tot2_in[mat], thr2,
                       me == 0 ? lam_out + o : nullptr, me == 0 ? inv_out + o : nullptr);
  if (me == 0 && threadIdx.x == 0) sweeps_out[mat] = k;

  // ---- 3. vh rows, each from the CTA that holds the selected row ----
  const size_t out_base = static_cast<size_t>(mat) * chi * n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int row = warp; row < chi; row += nwarps) {
    const int src = rs.sel[row];
    const int seat = src % half;
    if (seat / pairs_per != me) continue;
    const float inv = rs.inv[row];
    const float* re = aqc::seat_slot(w_re, cur, src / half, seat % pairs_per, pairs_per, n);
    const float* im = aqc::seat_slot(w_im, cur, src / half, seat % pairs_per, pairs_per, n);
    float* dre = vh_re + out_base + static_cast<size_t>(row) * n;
    float* dim = vh_im + out_base + static_cast<size_t>(row) * n;
    for (int e = lane; e < n; e += 32) {
      dre[e] = re[e] * inv;
      dim[e] = -(im[e] * inv);
    }
  }
}

using ClusterKernel = void (*)(const float*, const float*, const float*, float*, float*, float*,
                               float*, int*, int, int, int, int, int, int, float);

ClusterKernel cluster_kernel(int n) {
  switch (aqc::cluster_q(n)) {
    case 1: return rand_tail_cluster_kernel<1>;
    case 2: return rand_tail_cluster_kernel<2>;
    case 4: return rand_tail_cluster_kernel<4>;
    case 8: return rand_tail_cluster_kernel<8>;
    default: return nullptr;
  }
}

size_t cluster_smem_bytes(int ell, int n, int chi, int cluster) {
  return sizeof(float) * aqc::cluster_cta_floats(ell, n, cluster, aqc::rank_truncate_floats(ell, chi));
}

cudaLaunchConfig_t cluster_config(int batch, int ell, int n, int chi, int cluster,
                                  cudaStream_t stream, cudaLaunchAttribute* attr) {
  return aqc::cluster_launch_config(batch, cluster, aqc::cluster_threads(ell, cluster),
                                    cluster_smem_bytes(ell, n, chi, cluster), stream, attr);
}

// Validates a cluster-home shape and opts its kernel into the shared memory.
cudaError_t prepare_cluster(int ell, int n, int chi, int cluster, ClusterKernel* kernel) {
  *kernel = cluster_kernel(n);
  if (*kernel == nullptr || n < ell || chi < 1 || chi > ell || !aqc::cluster_shape_ok(ell, n, cluster))
    return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(cluster_smem_bytes(ell, n, chi, cluster)));
}

}  // namespace

extern "C" {

// Launches the rand tail on ``stream``; returns the CUDA error code of the
// launch (0 on success).  Inputs are contiguous f32: planes (batch, ell, n),
// tot2 (batch,); outputs vh planes (batch, chi, n), lam and inv (batch,
// chi), sweeps (batch,) int32.  ``home`` (ops/fused_rand.tail_plane_home):
// 0 shared, 1 cluster (``cluster`` CTAs of ``threads`` = 32 (ceil(ell / 2 /
// cluster) + 1) threads per matrix), 2 global (wk_re/wk_im are then (batch,
// ell, n) scratch planes); one block of ``threads`` per matrix otherwise.
int rand_tail_launch(const float* m_re, const float* m_im, const float* tot2, float* wk_re,
                     float* wk_im, float* vh_re, float* vh_im, float* lam, float* inv,
                     int* sweeps, int batch, int ell, int n, int chi, int max_sweeps, int hybrid,
                     float thr2, int threads, int home, int cluster, void* stream) {
  if (batch < 1 || ell < 2 || ell % 2 || n < ell || chi < 1 || chi > ell)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (home == kHomeCluster) {
    if (!aqc::cluster_shape_ok(ell, n, cluster) || threads != aqc::cluster_threads(ell, cluster))
      return cudaErrorInvalidValue;
    ClusterKernel kernel = nullptr;
    cudaError_t err = prepare_cluster(ell, n, chi, cluster, &kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = cluster_config(batch, ell, n, chi, cluster, s, attr);
    err = cudaLaunchKernelEx(&cfg, kernel, m_re, m_im, tot2, vh_re, vh_im, lam, inv, sweeps, ell,
                             n, chi, cluster, max_sweeps, hybrid, thr2);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  if (home != kHomeShared && home != kHomeGlobal) return cudaErrorInvalidValue;
  const bool smem_planes = home == kHomeShared;
  const int cap = smem_planes ? aqc::kSmemThreads : aqc::kMaxThreads;
  if (threads < 32 || threads > cap || threads % 32) return cudaErrorInvalidValue;
  if (!smem_planes && (wk_re == nullptr || wk_im == nullptr)) return cudaErrorInvalidValue;
  const size_t planes = smem_planes ? 2 * static_cast<size_t>(ell) * n : 0;
  const size_t smem = sizeof(float) * (planes + aqc::seat_stats_floats(ell) +
                                       aqc::rank_truncate_floats(ell, chi));
  auto kernel = smem_planes ? rand_tail_kernel<true> : rand_tail_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<batch, threads, smem, s>>>(m_re, m_im, tot2, wk_re, wk_im, vh_re, vh_im, lam, inv,
                                      sweeps, ell, n, chi, max_sweeps, hybrid, thr2);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of the cluster home at (ell, n, chi, cluster) the card
// keeps resident at once (cudaOccupancyMaxActiveClusters), or minus the
// CUDA error code.
int rand_tail_cluster_occupancy(int ell, int n, int chi, int cluster) {
  ClusterKernel kernel = nullptr;
  cudaError_t err = prepare_cluster(ell, n, chi, cluster, &kernel);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(1, ell, n, chi, cluster, nullptr, attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  return err != cudaSuccess ? -static_cast<int>(err) : clusters;
}

}  // extern "C"
