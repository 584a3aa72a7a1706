// jacobi_rows.cu — batched adaptive one-sided complex Jacobi (Brent-Luk
// round robin) on transposed re/im planes, for sm_90a.
//
// Replaces the Pallas TPU kernel aqc_research_tpu/ops/pallas_jacobi.py:
// _jacobi_pallas_raw (body _jacobi_kernel_body, loop _adaptive_seat_sweeps)
// and computes what it computes: for every (c, r) plane pair — row j is
// column j of the input matrix — rotate the c rows pairwise until they are
// mutually orthogonal, returning W = (m V)^T and each matrix's sweep count.
// The loop itself (schedule, rotation, criteria, stopping) lives in
// seat_sweeps.cuh (one block per matrix) and cluster_sweeps.cuh (a
// thread-block cluster per matrix), shared with the rand-tail and fused
// pair kernels.
//
// Design: where the planes live decides the kernel (the "home", chosen in
// Python by ops/jacobi_kernel.plane_home, never by trying a launch).
//   * cluster (4 <= c <= 256, r <= 256 on an H100; the 20q path's 128x128
//     and the unfused 256x256): ``cluster`` CTAs per matrix
//     (ops/jacobi_kernel.cluster_size) hold the rows by seat in their
//     shared memory, a warp per row pair and one cluster barrier per phase
//     (cluster_sweeps.cuh).  Each CTA loads the rows of its seats (row j in
//     L[j], row c/2 + j in R[j]) and writes them back in input order: every
//     complete sweep returns each row to its first seat;
//   * shared (the heads the rule keeps on one block): one block of up to 8
//     warps per matrix holds both planes in its shared memory for the whole
//     run (seat_sweeps.cuh);
//   * global (past the cluster's shapes): one block per matrix rotates the
//     output planes in place in device memory, L2-resident.
// Device memory is touched once on the way in and once on the way out
// except in the global home.
//
// Bounds.  At the MPS slice's shapes the kernel is bound by the chain of a
// phase (a pair's shared loads, Gram butterflies, rotation, stores) and its
// barrier, not by device memory or f32 rate: a one-block home gives a
// matrix one SM and a warp several pairs in series; the cluster home gives
// every pair its own warp on up to 8 SMs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster_sweeps.cuh"
#include "seat_sweeps.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kHomeShared = 0, kHomeCluster = 1, kHomeGlobal = 2;

// One block per matrix.  kSmemPlanes: the planes live in dynamic shared
// memory; otherwise in the output planes in device memory.
template <bool kSmemPlanes>
__global__ void __launch_bounds__(kSmemPlanes ? aqc::kSmemThreads : aqc::kMaxThreads)
jacobi_rows_kernel(const float* __restrict__ in_re, const float* __restrict__ in_im,
                   float* out_re, float* out_im, int* __restrict__ sweeps_out, int c, int r,
                   int max_sweeps, int hybrid) {
  extern __shared__ float smem[];
  __shared__ int s_go;
  const size_t base = static_cast<size_t>(blockIdx.x) * c * r;
  float* w_re;
  float* w_im;
  float* stats;
  if constexpr (kSmemPlanes) {
    w_re = smem;
    w_im = w_re + c * r;
    stats = w_im + c * r;
  } else {
    w_re = out_re + base;
    w_im = out_im + base;
    stats = smem;
  }

  for (int i = threadIdx.x; i < c * r; i += blockDim.x) {
    w_re[i] = in_re[base + i];
    w_im[i] = in_im[base + i];
  }
  __syncthreads();

  const int k = aqc::adaptive_seat_sweeps(w_re, w_im, stats, &s_go, c, r, max_sweeps, hybrid);

  if constexpr (kSmemPlanes) {
    for (int i = threadIdx.x; i < c * r; i += blockDim.x) {
      out_re[base + i] = w_re[i];
      out_im[base + i] = w_im[i];
    }
  }
  if (threadIdx.x == 0) sweeps_out[blockIdx.x] = k;
}

// A cluster of ``cluster`` CTAs per matrix (blocks mat * cluster ..), the
// rows by seat in their distributed shared memory (the file comment).
template <int kQ>
__global__ void __launch_bounds__(aqc::kClusterMaxThreads)
jacobi_rows_cluster_kernel(const float* __restrict__ in_re, const float* __restrict__ in_im,
                           float* __restrict__ out_re, float* __restrict__ out_im,
                           int* __restrict__ sweeps_out, int c, int r, int cluster,
                           int max_sweeps, int hybrid) {
  cg::cluster_group grp = cg::this_cluster();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ int s_go;

  const int me = static_cast<int>(grp.block_rank());
  const int mat = blockIdx.x / cluster;
  const int p = c / 2;
  const int pairs_per = aqc::cluster_pairs_per_cta(c, cluster);
  const int seat0 = me * pairs_per;
  // At every sweep boundary the seats of one side hold contiguous rows:
  // side * p + seat0 .. + held.
  const int held = max(0, min(pairs_per, p - seat0));
  float* stats = smem;
  float* w_re = smem + aqc::cluster_head_floats(c, cluster, 0);
  float* w_im = w_re + aqc::cluster_seat_floats(c, r, cluster) / 2;
  const size_t base = static_cast<size_t>(mat) * c * r;

  for (int side = 0; side < 2; ++side) {
    const size_t src = base + static_cast<size_t>(side * p + seat0) * r;
    float* dre = aqc::seat_slot(w_re, 0, side, 0, pairs_per, r);
    float* dim = aqc::seat_slot(w_im, 0, side, 0, pairs_per, r);
    for (int i = threadIdx.x; i < held * r; i += blockDim.x) {
      dre[i] = in_re[src + i];
      dim[i] = in_im[src + i];
    }
  }
  grp.sync();
  int cur = 0;
  const int k = aqc::cluster_seat_sweeps<kQ>(w_re, w_im, stats, &s_go, c, r, cluster, max_sweeps,
                                             hybrid, cur);

  for (int side = 0; side < 2; ++side) {
    const size_t dst = base + static_cast<size_t>(side * p + seat0) * r;
    const float* sre = aqc::seat_slot(w_re, cur, side, 0, pairs_per, r);
    const float* sim = aqc::seat_slot(w_im, cur, side, 0, pairs_per, r);
    for (int i = threadIdx.x; i < held * r; i += blockDim.x) {
      out_re[dst + i] = sre[i];
      out_im[dst + i] = sim[i];
    }
  }
  if (me == 0 && threadIdx.x == 0) sweeps_out[mat] = k;
  grp.sync();  // the stats warps' last remote reads end before any CTA exits
}

using ClusterKernel = void (*)(const float*, const float*, float*, float*, int*, int, int, int,
                               int, int);

ClusterKernel cluster_kernel(int r) {
  switch (aqc::cluster_q(r)) {
    case 1: return jacobi_rows_cluster_kernel<1>;
    case 2: return jacobi_rows_cluster_kernel<2>;
    case 4: return jacobi_rows_cluster_kernel<4>;
    case 8: return jacobi_rows_cluster_kernel<8>;
    default: return nullptr;
  }
}

size_t cluster_smem_bytes(int c, int r, int cluster) {
  return sizeof(float) * aqc::cluster_cta_floats(c, r, cluster, 0);
}

cudaLaunchConfig_t cluster_config(int batch, int c, int r, int cluster, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  return aqc::cluster_launch_config(batch, cluster, aqc::cluster_threads(c, cluster),
                                    cluster_smem_bytes(c, r, cluster), stream, attr);
}

// Validates a cluster-home shape and opts its kernel into the shared memory.
cudaError_t prepare_cluster(int c, int r, int cluster, ClusterKernel* kernel) {
  *kernel = cluster_kernel(r);
  if (*kernel == nullptr || !aqc::cluster_shape_ok(c, r, cluster)) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(cluster_smem_bytes(c, r, cluster)));
}

}  // namespace

extern "C" {

// Launches the Jacobi on ``stream``; returns the CUDA error code of the
// launch (0 on success).  Planes are (batch, c, r) f32, contiguous; ``home``
// (ops/jacobi_kernel.plane_home): 0 shared, 1 cluster (``cluster`` CTAs of
// ``threads`` = 32 (ceil(c / 2 / cluster) + 1) threads per matrix), 2
// global (one block of ``threads`` per matrix either way).
int jacobi_rows_launch(const float* in_re, const float* in_im, float* out_re, float* out_im,
                       int* sweeps, int batch, int c, int r, int max_sweeps, int hybrid,
                       int threads, int home, int cluster, void* stream) {
  if (batch < 1 || c < 2 || c % 2 || r < 1) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (home == kHomeCluster) {
    if (!aqc::cluster_shape_ok(c, r, cluster) || threads != aqc::cluster_threads(c, cluster))
      return cudaErrorInvalidValue;
    ClusterKernel kernel = nullptr;
    cudaError_t err = prepare_cluster(c, r, cluster, &kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = cluster_config(batch, c, r, cluster, s, attr);
    err = cudaLaunchKernelEx(&cfg, kernel, in_re, in_im, out_re, out_im, sweeps, c, r, cluster,
                             max_sweeps, hybrid);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  if (home != kHomeShared && home != kHomeGlobal) return cudaErrorInvalidValue;
  const bool smem_planes = home == kHomeShared;
  const int cap = smem_planes ? aqc::kSmemThreads : aqc::kMaxThreads;
  if (threads < 32 || threads > cap || threads % 32) return cudaErrorInvalidValue;
  const size_t planes = smem_planes ? 2 * static_cast<size_t>(c) * r : 0;
  const size_t smem = sizeof(float) * (planes + aqc::seat_stats_floats(c));
  auto kernel = smem_planes ? jacobi_rows_kernel<true> : jacobi_rows_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<batch, threads, smem, s>>>(in_re, in_im, out_re, out_im, sweeps, c, r, max_sweeps,
                                      hybrid);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of the cluster home at (c, r, cluster) the card keeps
// resident at once (cudaOccupancyMaxActiveClusters), or minus the CUDA
// error code.
int jacobi_rows_cluster_occupancy(int c, int r, int cluster) {
  ClusterKernel kernel = nullptr;
  cudaError_t err = prepare_cluster(c, r, cluster, &kernel);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(1, c, r, cluster, nullptr, attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  return err != cudaSuccess ? -static_cast<int>(err) : clusters;
}

}  // extern "C"
