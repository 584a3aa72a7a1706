// fused_pair.cu — the fused pair update of the jacobi route: θ build,
// adaptive one-sided Jacobi, selection, truncation and both factors of a
// batch of MPS pair updates in one kernel, for sm_90a.
//
// Replaces the Pallas TPU kernel aqc_research_tpu/ops/fused_pair.py:
// _fused_pair_raw (body _fused_kernel_body) and computes what it computes,
// per matrix:
//
//   1. W0 = θᵀ (2chi, 2chi) from the λ-scaled Γ planes and the gate
//      (theta_tiles.cuh, K2's tile loop), kept for step 5;
//   2. the adaptive Jacobi (seat_sweeps.cuh) on a working copy of W0, with
//      L = rows 0..chi-1 and R = rows chi..2chi-1 (the JAX seating):
//      row j of the rotated planes is (s_j u_j)^T;
//   3. the epilogue shared with K3 (rank_truncate.cuh): row norms, the
//      stable top-chi selection, the 32 eps guard and the discarded-weight
//      rule against the rows' own total weight, lambda and 1/s;
//   4. uᵀ rows = inv * (selected rows);
//   5. vh = inv * conj(uᵀ) @ W0ᵀ.  Row k of the rotated planes is s_k u_k^T,
//      so the recovery uses the NORMALIZED rows and then inv once more: the
//      standard vh = diag(1/s) u^H m (the comment at fused_pair.py:219-222).
//
// Stopping is per matrix (one block per matrix), the semantics of the
// Pallas kernel's chunk = 1; its chunk padding has no counterpart.  The
// product of step 5 is a tiled SIMT product in true f32 (plain FMA, no
// tensor cores, so no TF32), as the reference forces precision=HIGHEST.
//
// Design.  One thread block per matrix.  W0 lives in a scratch pair in
// device memory (the kernel writes it in step 1 and reads it in step 5, so
// never through __ldg).  The working planes follow the plane home rule of
// seat_sweeps.cuh: in shared memory up to 2chi = 160 (256 threads, one
// tile group), else in a second scratch pair in device memory, L2-resident
// (1024 threads, four tile groups that build and multiply four 16x16
// tiles at a time).
//
// Bounds.  The sweeps dominate, as in K1: bound by the traffic of the
// per-phase rotations and the per-phase barrier, with B ~ 14 blocks on 132
// SMs at 28 qubits.  Steps 1 and 5 are 32chi^3 + 8chi(2chi)^2 flops per
// matrix (~134 MFLOP at chi = 128), a fraction of a millisecond per block.

#include <cuda_runtime.h>

#include "rank_truncate.cuh"
#include "seat_sweeps.cuh"
#include "theta_tiles.cuh"

namespace {

constexpr int kT = aqc::kThetaTile;

struct VhTileBuf {
  float ut[2][kT][kT + 1];  // [re, im][i][e], padded against bank conflicts
  float w0[2][kT][kT + 1];  // [re, im][j][e]
};

union TileBuf {
  aqc::ThetaTileBuf theta;
  VhTileBuf vh;
};

// kSmemPlanes: the working planes live in dynamic shared memory (one tile
// group of 256 threads); otherwise in wk_re/wk_im in device memory (four
// groups, 1024 threads).
template <bool kSmemPlanes>
__global__ void __launch_bounds__(kSmemPlanes ? aqc::kSmemThreads : aqc::kMaxThreads)
fused_pair_kernel(const float* __restrict__ gate, const float* __restrict__ a_re,
                  const float* __restrict__ a_im, const float* __restrict__ b_re,
                  const float* __restrict__ b_im, float* w0_re, float* w0_im, float* wk_re,
                  float* wk_im, float* __restrict__ ut_re, float* __restrict__ ut_im,
                  float* __restrict__ vh_re, float* __restrict__ vh_im,
                  float* __restrict__ lam_out, int* __restrict__ sweeps_out, int chi,
                  int max_sweeps, int hybrid, float thr2) {
  constexpr int kGroups = kSmemPlanes ? aqc::kSmemThreads / aqc::kTileThreads
                                      : aqc::kMaxThreads / aqc::kTileThreads;
  extern __shared__ float smem[];
  __shared__ int s_go;
  __shared__ float s_gate[32];
  __shared__ TileBuf tbuf[kGroups];

  const int n = 2 * chi;
  const size_t nn = static_cast<size_t>(n) * n;
  const int mat = blockIdx.x;
  const int group = threadIdx.x / aqc::kTileThreads;
  const int t = threadIdx.x % aqc::kTileThreads;
  float* w0r = w0_re + mat * nn;
  float* w0i = w0_im + mat * nn;
  float* w_re;
  float* w_im;
  float* stats;
  if constexpr (kSmemPlanes) {
    w_re = smem;
    w_im = w_re + nn;
    stats = w_im + nn;
  } else {
    w_re = wk_re + mat * nn;
    w_im = wk_im + mat * nn;
    stats = smem;
  }
  const aqc::RankScratch rs(stats + aqc::seat_stats_floats(n), n, chi);

  // ---- 1. θ build into the retained W0 (the groups take tiles in turn) ----
  if (threadIdx.x < 32) s_gate[threadIdx.x] = gate[static_cast<size_t>(mat) * 32 + threadIdx.x];
  const size_t in_base = static_cast<size_t>(mat) * 2 * chi * chi;
  const int tiles = (chi + kT - 1) / kT;
  for (int first = 0; first < tiles * tiles; first += kGroups) {
    const int tile = first + group;
    const bool active = tile < tiles * tiles;
    const int c0 = active ? (tile / tiles) * kT : 0;
    const int a0 = active ? (tile % tiles) * kT : 0;
    aqc::theta_tile(s_gate, a_re + in_base, a_im + in_base, b_re + in_base, b_im + in_base, w0r,
                    w0i, chi, c0, a0, active, t, tbuf[group].theta);
  }
  __syncthreads();

  // ---- 2. adaptive Jacobi on a working copy ----
  for (size_t i = threadIdx.x; i < nn; i += blockDim.x) {
    w_re[i] = w0r[i];
    w_im[i] = w0i[i];
  }
  __syncthreads();
  const int k = aqc::adaptive_seat_sweeps(w_re, w_im, stats, &s_go, n, n, max_sweeps, hybrid);

  // ---- 3. rank, select, guard, truncation, lambda, 1/s ----
  aqc::rank_truncate(w_re, w_im, n, n, chi, true, 0.f, thr2, rs,
                     lam_out + static_cast<size_t>(mat) * chi, nullptr);
  if (threadIdx.x == 0) sweeps_out[mat] = k;

  // ---- 4. uᵀ rows = inv * selected rows ----
  const size_t out_base = static_cast<size_t>(mat) * chi * n;
  float* utr = ut_re + out_base;
  float* uti = ut_im + out_base;
  for (int i = threadIdx.x; i < chi * n; i += blockDim.x) {
    const int row = i / n, e = i - row * n;
    const float inv = rs.inv[row];
    const int src = rs.sel[row] * n + e;
    utr[i] = w_re[src] * inv;
    uti[i] = w_im[src] * inv;
  }
  __syncthreads();

  // ---- 5. vh = inv * conj(uᵀ) @ W0ᵀ, 16x16 output tiles per group ----
  const int tx = t % kT, ty = t / kT;
  const int ti = (chi + kT - 1) / kT, tj = (n + kT - 1) / kT;
  VhTileBuf& vb = tbuf[group].vh;
  for (int first = 0; first < ti * tj; first += kGroups) {
    const int tile = first + group;
    const bool active = tile < ti * tj;
    const int i0 = active ? (tile / tj) * kT : 0;
    const int j0 = active ? (tile % tj) * kT : 0;
    float acc_re = 0.f, acc_im = 0.f;
    for (int e0 = 0; e0 < n; e0 += kT) {
      const int e = e0 + tx;
      const bool u_ok = active && i0 + ty < chi && e < n;
      const bool w_ok = active && j0 + ty < n && e < n;
      const size_t u_at = static_cast<size_t>(i0 + ty) * n + e;
      const size_t w_at = static_cast<size_t>(j0 + ty) * n + e;
      vb.ut[0][ty][tx] = u_ok ? utr[u_at] : 0.f;
      vb.ut[1][ty][tx] = u_ok ? uti[u_at] : 0.f;
      vb.w0[0][ty][tx] = w_ok ? w0r[w_at] : 0.f;
      vb.w0[1][ty][tx] = w_ok ? w0i[w_at] : 0.f;
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kT; ++q) {
        const float ur = vb.ut[0][ty][q], ui = vb.ut[1][ty][q];
        const float wr = vb.w0[0][tx][q], wi = vb.w0[1][tx][q];
        acc_re += ur * wr + ui * wi;  // conj(u) w
        acc_im += ur * wi - ui * wr;
      }
      __syncthreads();
    }
    const int i = i0 + ty, j = j0 + tx;
    if (active && i < chi && j < n) {
      const float inv = rs.inv[i];
      vh_re[out_base + static_cast<size_t>(i) * n + j] = acc_re * inv;
      vh_im[out_base + static_cast<size_t>(i) * n + j] = acc_im * inv;
    }
  }
}

}  // namespace

extern "C" {

// Launches one block per matrix on ``stream``; returns the CUDA error code
// of the launch (0 on success).  Inputs are contiguous f32: gate (batch,
// 32), a/b planes (batch, 2, chi, chi); scratch w0 (batch, 2chi, 2chi) and,
// without ``smem_planes``, wk (batch, 2chi, 2chi); outputs uᵀ and vh planes
// (batch, chi, 2chi), lam (batch, chi), sweeps (batch,) int32.
int fused_pair_launch(const float* gate, const float* a_re, const float* a_im,
                      const float* b_re, const float* b_im, float* w0_re, float* w0_im,
                      float* wk_re, float* wk_im, float* ut_re, float* ut_im, float* vh_re,
                      float* vh_im, float* lam, int* sweeps, int batch, int chi, int max_sweeps,
                      int hybrid, float thr2, int smem_planes, void* stream) {
  if (chi < 1 || batch < 1) return cudaErrorInvalidValue;
  if (!smem_planes && (wk_re == nullptr || wk_im == nullptr)) return cudaErrorInvalidValue;
  const int n = 2 * chi;
  const size_t planes = smem_planes ? 2 * static_cast<size_t>(n) * n : 0;
  const size_t smem = sizeof(float) * (planes + aqc::seat_stats_floats(n) +
                                       aqc::rank_truncate_floats(n, chi));
  const int threads = smem_planes ? aqc::kSmemThreads : aqc::kMaxThreads;
  auto kernel = smem_planes ? fused_pair_kernel<true> : fused_pair_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      gate, a_re, a_im, b_re, b_im, w0_re, w0_im, wk_re, wk_im, ut_re, ut_im, vh_re, vh_im, lam,
      sweeps, chi, max_sweeps, hybrid, thr2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
