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
//   2. row norms s^2 and their stable descending rank (ties: lower row
//      first), the top-chi rows selected in that order;
//   3. the noise guard s^2 > (32 eps)^2 s^2_max;
//   4. the discarded-weight rule against the FULL theta weight tot2: tail^2
//      = (guarded suffix sum of the selected s^2) + max(tot2 - sum s^2 -
//      16 eps tot2, 0), keep = tail^2 > thr^2 tot2 and guard;
//   5. lambda = keep ? s sqrt(tot2 / max(kept^2, 1e-38)) : 0 and
//      inv = keep ? 1 / max(s, 1e-38) : 0;
//   6. vh rows = (w_re inv, -w_im inv) of the selected rows.
//
// The Pallas kernel's sentinel lane padding, chunk floor and padded-slot
// weights are Mosaic artefacts and have no counterpart here: one block per
// matrix gives the per-matrix stopping that its chunk = 1 would.
//
// Design.  One thread block per matrix, both planes in dynamic shared memory
// (72 x 128 x 8 B = 73.7 KB at chi = 64, 160 KB at chi = 96) for the sweeps
// and the epilogue, so device memory is read once and only the chi selected
// rows are written.  The rank is one comparison loop per row (ell^2
// comparisons), and the rule's suffix sums run in one thread: both are tiny
// beside the sweeps.  The sweep count is an output.
//
// Bounds.  Like K1, bound by shared-memory traffic and the per-phase
// barrier of the sweeps; a half-layer batch of B ~ 10 matrices fills ~10 of
// 132 SMs.  chi = 128 (ell = 136 rows of 256 lanes, 278,528 B of planes)
// does not fit one SM's shared memory: the wrapper raises there, and a
// cluster or L2-resident design is later work.

#include <cuda_runtime.h>

#include "seat_sweeps.cuh"

namespace {

__global__ void __launch_bounds__(aqc::kMaxThreads)
rand_tail_kernel(const float* __restrict__ m_re, const float* __restrict__ m_im,
                 const float* __restrict__ tot2_in, float* __restrict__ vh_re,
                 float* __restrict__ vh_im, float* __restrict__ lam_out,
                 float* __restrict__ inv_out, int* __restrict__ sweeps_out, int ell, int n,
                 int chi, int max_sweeps, int hybrid, float thr2) {
  extern __shared__ float smem[];
  __shared__ int s_go;
  float* w_re = smem;
  float* w_im = w_re + ell * n;
  float* stats = w_im + ell * n;
  float* s2 = stats + aqc::seat_stats_floats(ell);  // [ell] row norms^2
  float* s2s = s2 + ell;                             // [chi] selected, descending
  float* inv_s = s2s + chi;                          // [chi] keep flag, then inv
  int* sel = reinterpret_cast<int*>(inv_s + chi);    // [chi] row of rank k

  const size_t in_base = static_cast<size_t>(blockIdx.x) * ell * n;
  for (int i = threadIdx.x; i < ell * n; i += blockDim.x) {
    w_re[i] = m_re[in_base + i];
    w_im[i] = m_im[in_base + i];
  }
  __syncthreads();

  const int k = aqc::adaptive_seat_sweeps(w_re, w_im, stats, &s_go, ell, n, max_sweeps, hybrid);

  // ---- row norms ----
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int j = warp; j < ell; j += nwarps) {
    const float* re = w_re + j * n;
    const float* im = w_im + j * n;
    float acc = 0.f;
    for (int e = lane; e < n; e += 32) acc += re[e] * re[e] + im[e] * im[e];
    acc = aqc::warp_sum(acc);
    if (lane == 0) s2[j] = acc;
  }
  for (int i = threadIdx.x; i < chi; i += blockDim.x) {
    sel[i] = 0;  // only a non-finite row norm leaves a rank unfilled
    s2s[i] = 0.f;
  }
  __syncthreads();

  // ---- stable descending rank + top-chi select ----
  for (int j = threadIdx.x; j < ell; j += blockDim.x) {
    const float v = s2[j];
    int rank = 0;
    for (int m = 0; m < ell; ++m) {
      const float w = s2[m];
      rank += (w > v) || (w == v && m < j);
    }
    if (rank < chi) {
      sel[rank] = j;
      s2s[rank] = v;
    }
  }
  __syncthreads();

  // ---- guard, discarded-weight rule vs the full weight, lambda, inv ----
  if (threadIdx.x == 0) {
    const float tot2 = tot2_in[blockIdx.x];
    const float floor2 = (32.f * aqc::kEps32) * (32.f * aqc::kEps32) * s2s[0];
    float head = 0.f;
    for (int i = 0; i < chi; ++i) head += s2s[i];
    const float rest2 = fmaxf(tot2 - head - 16.f * aqc::kEps32 * tot2, 0.f);
    float seen = 0.f, kept2 = 0.f;
    for (int i = chi - 1; i >= 0; --i) {  // suffix sums from the small end
      const bool guard = s2s[i] > floor2;
      if (guard) seen += s2s[i];
      const bool keep = guard && (seen + rest2 > thr2 * tot2);
      inv_s[i] = keep ? 1.f : 0.f;
      if (keep) kept2 += s2s[i];
    }
    const float rescale = sqrtf(tot2 / fmaxf(kept2, 1e-38f));
    const size_t o = static_cast<size_t>(blockIdx.x) * chi;
    for (int i = 0; i < chi; ++i) {
      const bool keep = inv_s[i] != 0.f;
      const float s = sqrtf(s2s[i]);
      const float inv = keep ? 1.f / fmaxf(s, 1e-38f) : 0.f;
      lam_out[o + i] = keep ? s * rescale : 0.f;
      inv_out[o + i] = inv;
      inv_s[i] = inv;
    }
    sweeps_out[blockIdx.x] = k;
  }
  __syncthreads();

  // ---- vh rows: conj of the selected rows, scaled by 1/s ----
  const size_t out_base = static_cast<size_t>(blockIdx.x) * chi * n;
  for (int i = threadIdx.x; i < chi * n; i += blockDim.x) {
    const int row = i / n, e = i - row * n;
    const float inv = inv_s[row];
    const int src = sel[row] * n + e;
    vh_re[out_base + i] = w_re[src] * inv;
    vh_im[out_base + i] = -(w_im[src] * inv);
  }
}

}  // namespace

extern "C" {

// Launches one block per matrix on ``stream``; returns the CUDA error code
// of the launch (0 on success).  Inputs are contiguous f32: planes (batch,
// ell, n), tot2 (batch,); outputs vh planes (batch, chi, n), lam and inv
// (batch, chi), sweeps (batch,) int32.
int rand_tail_launch(const float* m_re, const float* m_im, const float* tot2, float* vh_re,
                     float* vh_im, float* lam, float* inv, int* sweeps, int batch, int ell,
                     int n, int chi, int max_sweeps, int hybrid, float thr2, int threads,
                     void* stream) {
  if (threads < 32 || threads > aqc::kMaxThreads || threads % 32) return cudaErrorInvalidValue;
  if (ell < 2 || ell % 2 || n < ell || chi < 1 || chi > ell) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(ell) * n +
                                       aqc::seat_stats_floats(ell) + ell + 3 * chi);
  cudaError_t err = cudaFuncSetAttribute(
      rand_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  rand_tail_kernel<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      m_re, m_im, tot2, vh_re, vh_im, lam, inv, sweeps, ell, n, chi, max_sweeps, hybrid, thr2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
