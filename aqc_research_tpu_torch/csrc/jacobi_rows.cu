// jacobi_rows.cu — batched adaptive one-sided complex Jacobi (Brent-Luk
// round robin) on transposed re/im planes, for sm_90a.
//
// Replaces the Pallas TPU kernel aqc_research_tpu/ops/pallas_jacobi.py:
// _jacobi_pallas_raw (body _jacobi_kernel_body, loop _adaptive_seat_sweeps)
// and computes what it computes: for every (c, r) plane pair — row j is
// column j of the input matrix — rotate the c rows pairwise until they are
// mutually orthogonal, returning W = (m V)^T and each matrix's sweep count.
// The loop itself (schedule, rotation, criteria, stopping) lives in
// seat_sweeps.cuh, shared with the rand-tail and fused pair kernels.
//
// Design.  One thread block per matrix.  A plane pair that fits one block's
// shared memory (128 KB at 128x128) is loaded there for the whole run, so
// device memory is touched once on the way in and once on the way out.  A
// larger one (512 KB at 256x256) is copied into the output planes, which
// the block then rotates in place in device memory, L2-resident (the plane
// home rule of seat_sweeps.cuh).  Output rows are in input order (every
// complete sweep returns each row to its seat).
//
// Bounds.  At the MPS slice's shapes the kernel is bound by the traffic of
// the per-phase rotations (shared memory or the SM's L2 bandwidth) and by
// the per-phase barrier, not by device memory or f32 rate: a half-layer
// batch of B ~ 10-14 matrices fills only 10-14 of the H100's 132 SMs.

#include <cuda_runtime.h>

#include "seat_sweeps.cuh"

namespace {

// kSmemPlanes: the planes live in dynamic shared memory; otherwise in the
// output planes in device memory.
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

}  // namespace

extern "C" {

// Launches one block per matrix on ``stream``; returns the CUDA error code
// of the launch (0 on success).  Planes are (batch, c, r) f32, contiguous;
// ``smem_planes`` chooses the plane home (ops/jacobi_kernel.plane_home).
int jacobi_rows_launch(const float* in_re, const float* in_im, float* out_re,
                       float* out_im, int* sweeps, int batch, int c, int r,
                       int max_sweeps, int hybrid, int threads, int smem_planes, void* stream) {
  const int cap = smem_planes ? aqc::kSmemThreads : aqc::kMaxThreads;
  if (threads < 32 || threads > cap || threads % 32) return cudaErrorInvalidValue;
  const size_t planes = smem_planes ? 2 * static_cast<size_t>(c) * r : 0;
  const size_t smem = sizeof(float) * (planes + aqc::seat_stats_floats(c));
  auto kernel = smem_planes ? jacobi_rows_kernel<true> : jacobi_rows_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      in_re, in_im, out_re, out_im, sweeps, c, r, max_sweeps, hybrid);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
