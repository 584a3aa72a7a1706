// jacobi_rows.cu — batched adaptive one-sided complex Jacobi (Brent-Luk
// round robin) on transposed re/im planes, for sm_90a.
//
// Replaces the Pallas TPU kernel aqc_research_tpu/ops/pallas_jacobi.py:
// _jacobi_pallas_raw (body _jacobi_kernel_body, loop _adaptive_seat_sweeps)
// and computes what it computes: for every (c, r) plane pair — row j is
// column j of the input matrix — rotate the c rows pairwise until they are
// mutually orthogonal, returning W = (m V)^T and each matrix's sweep count.
// The loop itself (schedule, rotation, criteria, stopping) lives in
// seat_sweeps.cuh, shared with the rand-tail kernel.
//
// Design.  One thread block per matrix; both planes live in dynamic shared
// memory (128 KB at 128x128) for the whole run, so device memory is touched
// once on the way in and once on the way out.  Output rows are in input
// order (every complete sweep returns each row to its seat).
//
// Bounds.  At the MPS slice's 128x128 shape the kernel is bound by shared
// memory traffic and by the per-phase barrier, not by device memory.  A
// half-layer batch of B ~ 10 matrices fills only ~10 of the H100's 132 SMs.
// Splitting one matrix over a thread-block cluster (distributed shared
// memory), which is also what the 256x256 shape (512 KB of planes) needs, is
// later work.

#include <cuda_runtime.h>

#include "seat_sweeps.cuh"

namespace {

__global__ void __launch_bounds__(aqc::kMaxThreads)
jacobi_rows_kernel(const float* __restrict__ in_re, const float* __restrict__ in_im,
                   float* __restrict__ out_re, float* __restrict__ out_im,
                   int* __restrict__ sweeps_out, int c, int r, int max_sweeps,
                   int hybrid) {
  extern __shared__ float smem[];
  __shared__ int s_go;
  float* w_re = smem;
  float* w_im = w_re + c * r;
  float* stats = w_im + c * r;

  const size_t base = static_cast<size_t>(blockIdx.x) * c * r;
  for (int i = threadIdx.x; i < c * r; i += blockDim.x) {
    w_re[i] = in_re[base + i];
    w_im[i] = in_im[base + i];
  }
  __syncthreads();

  const int k = aqc::adaptive_seat_sweeps(w_re, w_im, stats, &s_go, c, r, max_sweeps, hybrid);

  for (int i = threadIdx.x; i < c * r; i += blockDim.x) {
    out_re[base + i] = w_re[i];
    out_im[base + i] = w_im[i];
  }
  if (threadIdx.x == 0) sweeps_out[blockIdx.x] = k;
}

}  // namespace

extern "C" {

// Launches one block per matrix on ``stream``; returns the CUDA error code
// of the launch (0 on success).  Planes are (batch, c, r) f32, contiguous.
int jacobi_rows_launch(const float* in_re, const float* in_im, float* out_re,
                       float* out_im, int* sweeps, int batch, int c, int r,
                       int max_sweeps, int hybrid, int threads, void* stream) {
  if (threads < 32 || threads > aqc::kMaxThreads || threads % 32) return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (2 * static_cast<size_t>(c) * r + aqc::seat_stats_floats(c));
  cudaError_t err = cudaFuncSetAttribute(
      jacobi_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  jacobi_rows_kernel<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      in_re, in_im, out_re, out_im, sweeps, c, r, max_sweeps, hybrid);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
