// rand_tail.cu — the tail of the fused randomized-projection pair update:
// reduced one-sided Jacobi, top-chi selection, truncation and the vh rows,
// for sm_90a.
//
// Replaces the Pallas TPU kernel aqc_research_tpu/ops/fused_rand.py:
// _rand_tail_raw (body _rand_tail_kernel_body), pass C of the fused rand
// route, and computes what it computes, per matrix:
//
//   1. the adaptive Jacobi (seat_sweeps.cuh, K1's loop) on the (ell, n)
//      planes (Re B, -Im B) = conj(B), B = Q^H theta the projected pair
//      matrix: row j of the rotated planes is (s_j u_j)^T of B^H;
//   2. the epilogue shared with K4 (rank_truncate.cuh): row norms, the
//      stable top-chi selection, the 32 eps noise guard, the discarded-weight
//      rule against the FULL theta weight tot2, lambda and 1/s;
//   3. vh rows = (w_re inv, -w_im inv) of the selected rows.
//
// The Pallas kernel's sentinel lane padding, chunk floor and padded-slot
// weights are Mosaic artefacts and have no counterpart here: one block per
// matrix gives the per-matrix stopping that its chunk = 1 would.
//
// Design.  One thread block per matrix.  Planes that fit one block's shared
// memory (72 x 128 x 8 B = 73.7 KB at chi = 64, 160 KB at chi = 96) are
// loaded there for the sweeps and the epilogue, so device memory is read
// once and only the chi selected rows are written.  Larger ones (chi = 128:
// 136 rows of 256 lanes, 278,528 B) are copied into a scratch pair in
// device memory that the wrapper allocates, and rotated there in place
// (the plane home rule of seat_sweeps.cuh).  The sweep count is an output.
//
// Bounds.  Like K1, bound by the traffic of the per-phase rotations and the
// per-phase barrier of the sweeps; a half-layer batch of B ~ 10-14 matrices
// fills 10-14 of 132 SMs.

#include <cuda_runtime.h>

#include "rank_truncate.cuh"
#include "seat_sweeps.cuh"

namespace {

// kSmemPlanes: the planes live in dynamic shared memory; otherwise in the
// scratch planes wk_re/wk_im (batch, ell, n) in device memory.
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

}  // namespace

extern "C" {

// Launches one block per matrix on ``stream``; returns the CUDA error code
// of the launch (0 on success).  Inputs are contiguous f32: planes (batch,
// ell, n), tot2 (batch,); outputs vh planes (batch, chi, n), lam and inv
// (batch, chi), sweeps (batch,) int32.  ``smem_planes`` chooses the plane
// home; without it wk_re/wk_im are (batch, ell, n) scratch planes.
int rand_tail_launch(const float* m_re, const float* m_im, const float* tot2, float* wk_re,
                     float* wk_im, float* vh_re, float* vh_im, float* lam, float* inv,
                     int* sweeps, int batch, int ell, int n, int chi, int max_sweeps, int hybrid,
                     float thr2, int threads, int smem_planes, void* stream) {
  const int cap = smem_planes ? aqc::kSmemThreads : aqc::kMaxThreads;
  if (threads < 32 || threads > cap || threads % 32) return cudaErrorInvalidValue;
  if (ell < 2 || ell % 2 || n < ell || chi < 1 || chi > ell) return cudaErrorInvalidValue;
  if (!smem_planes && (wk_re == nullptr || wk_im == nullptr)) return cudaErrorInvalidValue;
  const size_t planes = smem_planes ? 2 * static_cast<size_t>(ell) * n : 0;
  const size_t smem = sizeof(float) * (planes + aqc::seat_stats_floats(ell) +
                                       aqc::rank_truncate_floats(ell, chi));
  auto kernel = smem_planes ? rand_tail_kernel<true> : rand_tail_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      m_re, m_im, tot2, wk_re, wk_im, vh_re, vh_im, lam, inv, sweeps, ell, n, chi, max_sweeps,
      hybrid, thr2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
