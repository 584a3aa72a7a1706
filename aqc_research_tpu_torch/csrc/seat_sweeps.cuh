// seat_sweeps.cuh — the adaptive one-sided complex Jacobi loop (Brent-Luk
// round robin) on transposed re/im planes in shared or device memory, shared
// by jacobi_rows.cu (K1), rand_tail.cu (K3) and fused_pair.cu (K4).
//
// Replaces the shared Pallas loop aqc_research_tpu/ops/pallas_jacobi.py:
// _adaptive_seat_sweeps and computes what it computes: for a (c, r) plane
// pair — row j is column j of the input matrix — rotate the c rows pairwise
// until they are mutually orthogonal, leaving W = (m V)^T in place.  Each
// sweep is 2p-1 phases (p = c/2); a phase rotates the p disjoint row pairs
// (L[j], R[j]).  A matrix stops after the sweep whose largest
// entry-absolute residual |c| / sqrt(s_max^2 * max(|w_i|^2, |w_j|^2))
// ("entry"; "hybrid" gates with max(min(|w_i|^2, |w_j|^2),
// (32 eps)^2 s_max^2)) falls below 1e-6, or after max_sweeps sweeps.  The
// rotation formulas are those of the Pallas kernel, term for term, so the
// two agree to f32 rounding.
//
// Design.  The caller gives one thread block to one matrix.  Each warp takes
// a share of the p pairs of a phase: its lanes stride over the r entries,
// and warp shuffles reduce the pair's Gram entries (aa, bb, c) so that every
// lane holds the rotation and applies it in place.  The butterfly reductions
// leave every lane with bit-identical sums, so the active/inactive branch is
// warp-uniform.  The round robin moves no rows: a full tour is one cycle of
// the 2p-1 non-fixed seats, so the row in seat j at phase t is computed in
// closed form, and after every complete sweep each row is back in its own
// place.  One __syncthreads() separates phases.  The phase residual needs
// the phase's s_max, so the pair statistics go to a double-buffered shared
// array and warp 0 reduces phase t while the other warps already rotate
// phase t+1.
//
// Where the planes live ("plane home").  The loop takes plain float*
// planes; only the statistics and the go flag must be in shared memory.
// A plane pair that fits one block's shared memory (with the caller's own
// shared arrays) is loaded there, by a block of at most kSmemThreads
// threads.  A larger one stays in device memory, in a buffer the wrapper
// allocates with torch.empty (the kernel's output or scratch), and the
// block works on it in place with up to kMaxThreads threads (a warp per
// row pair, 32 at most).  At 28 qubits that is at most 1 MB per matrix and
// B <= 14 matrices per launch, so the planes stay resident in the 50 MB L2.
// __syncthreads() makes a block's global writes visible to the whole
// block; the planes are never read through __ldg or a const __restrict__
// pointer, since the block writes them.  The wrappers decide the home with
// one Python function of (c, r, max_smem) (ops/jacobi_kernel.plane_home),
// so the CPU tests see the rule.
//
// cluster_sweeps.cuh runs this loop on a thread-block cluster with the
// planes in distributed shared memory (a cluster barrier per phase), for K1
// and K3 wherever their home rules say "cluster" (the path shapes among
// them); block_sweeps.cuh runs its rotations in a block-cyclic order for K4
// at 176 <= 2chi <= 256.  So this loop keeps the heads the rules leave on
// one block and the shapes past the cluster's.
//
// Bounds.  At the shared-memory shapes (c <= 128 rows of r <= 128 lanes)
// the loop is bound by shared-memory traffic (every phase reads both planes
// twice and writes them once) and by the per-phase barrier; in device
// memory by the one SM's L2 bandwidth for the same traffic.  Neither is
// near the card's memory or f32 bound: B ~ 10-14 blocks fill 10-14 of 132
// SMs.

#pragma once

#include <cuda_runtime.h>

namespace aqc {

constexpr float kEps32 = 1.1920928955078125e-07f;  // FLT_EPSILON
constexpr float kConvTol = 1e-6f;
constexpr int kSmemThreads = 256;  // block size cap, planes in shared memory
constexpr int kMaxThreads = 1024;  // block size cap, planes in device memory

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Position i on the seat cycle L1 -> ... -> L_{p-1} -> R_{p-1} -> ... -> R0
// -> L1, mapped to the row that sits there at the start of a sweep.
__device__ __forceinline__ int cycle_row(int i, int p) {
  return i < p - 1 ? i + 1 : 3 * p - 2 - i;
}

// Rows seated at L[j] / R[j] in phase t: every phase moves each non-fixed
// row one step along the cycle (L[0] keeps row 0).
__device__ __forceinline__ int seat_l(int j, int t, int p) {
  if (j == 0) return 0;
  const int m = 2 * p - 1;
  return cycle_row(((j - 1 - t) % m + m) % m, p);
}

__device__ __forceinline__ int seat_r(int j, int t, int p) {
  const int m = 2 * p - 1;
  return cycle_row(((2 * p - 2 - j - t) % m + m) % m, p);
}

// Shared floats the loop needs beside the planes: the double-buffered
// per-pair statistics, 3 x 2 x c/2.
__host__ __device__ constexpr int seat_stats_floats(int c) { return 3 * c; }

// Runs the adaptive sweeps on the (c, r) planes w_re/w_im (shared or device
// memory, written by this block only); ``stats`` holds seat_stats_floats(c)
// shared floats and ``go_flag`` one shared int.  Every thread of the block
// calls it after the planes are loaded and a __syncthreads(); it returns (in
// every thread) the number of sweeps run, with the rows back in input order
// and the block synchronised.
__device__ inline int adaptive_seat_sweeps(float* w_re, float* w_im, float* stats, int* go_flag,
                                           int c, int r, int max_sweeps, int hybrid) {
  const int p = c / 2;
  float* st_aa = stats;  // [2][p]: phase parity x pair
  float* st_bb = st_aa + 2 * p;
  float* st_c = st_bb + 2 * p;  // |c|
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int phases = 2 * p - 1;

  int k = 0;
  bool go = max_sweeps > 0;
  while (go) {
    float resid = 0.f;  // meaningful in warp 0 only
    for (int t = 0; t < phases; ++t) {
      const int buf = (t & 1) * p;
      for (int j = warp; j < p; j += nwarps) {
        float* lre = w_re + seat_l(j, t, p) * r;
        float* lim = w_im + seat_l(j, t, p) * r;
        float* rre = w_re + seat_r(j, t, p) * r;
        float* rim = w_im + seat_r(j, t, p) * r;
        float aa = 0.f, bb = 0.f, cre = 0.f, cim = 0.f;
        for (int e = lane; e < r; e += 32) {
          const float a_r = lre[e], a_i = lim[e], b_r = rre[e], b_i = rim[e];
          aa += a_r * a_r + a_i * a_i;
          bb += b_r * b_r + b_i * b_i;
          cre += a_r * b_r + a_i * b_i;
          cim += a_r * b_i - a_i * b_r;
        }
        aa = warp_sum(aa);
        bb = warp_sum(bb);
        cre = warp_sum(cre);
        cim = warp_sum(cim);

        const float abs_c = sqrtf(cre * cre + cim * cim);
        const float norm_ab = sqrtf(fmaxf(aa * bb, 1e-30f));
        const bool active = abs_c > kEps32 * norm_ab;
        if (lane == 0) {
          st_aa[buf + j] = aa;
          st_bb[buf + j] = bb;
          st_c[buf + j] = abs_c;
        }
        if (active) {  // an inactive pair's rotation is the identity
          const float ph_re = cre / abs_c;
          const float ph_im = cim / abs_c;
          const float tau = (bb - aa) / (2.f * abs_c);
          const float sgn = tau >= 0.f ? 1.f : -1.f;  // sign(0) = +1
          const float tt = sgn / (fabsf(tau) + sqrtf(1.f + tau * tau));
          const float cs = rsqrtf(1.f + tt * tt);
          const float sn_r = tt * cs;
          const float sn_re = sn_r * ph_re;
          const float sn_im = sn_r * ph_im;
          // L' = cs L - conj(sn) R ;  R' = sn L + cs R
          for (int e = lane; e < r; e += 32) {
            const float a_r = lre[e], a_i = lim[e], b_r = rre[e], b_i = rim[e];
            lre[e] = cs * a_r - (sn_re * b_r + sn_im * b_i);
            lim[e] = cs * a_i - (sn_re * b_i - sn_im * b_r);
            rre[e] = sn_re * a_r - sn_im * a_i + cs * b_r;
            rim[e] = sn_re * a_i + sn_im * a_r + cs * b_i;
          }
        }
      }
      __syncthreads();
      if (warp == 0) {
        // Phase residual against this phase's s_max^2 (the other warps are
        // already in phase t+1, writing the other stats buffer).
        float smax2 = 0.f;
        for (int j = lane; j < p; j += 32)
          smax2 = fmaxf(smax2, fmaxf(st_aa[buf + j], st_bb[buf + j]));
        smax2 = warp_max(smax2);
        const float floor2 = (32.f * kEps32) * (32.f * kEps32) * smax2;
        float worst = 0.f;
        for (int j = lane; j < p; j += 32) {
          const float a = st_aa[buf + j], b = st_bb[buf + j];
          const float gate = hybrid ? fmaxf(fminf(a, b), floor2) : fmaxf(a, b);
          worst = fmaxf(worst, st_c[buf + j] / sqrtf(fmaxf(smax2 * gate, 1e-30f)));
        }
        resid = fmaxf(resid, warp_max(worst));
      }
    }
    ++k;
    if (threadIdx.x == 0) *go_flag = (k < max_sweeps) && (resid >= kConvTol);
    __syncthreads();
    go = *go_flag;
  }
  return k;
}

}  // namespace aqc
