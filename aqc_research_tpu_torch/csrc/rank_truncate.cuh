// rank_truncate.cuh — the epilogue after the Jacobi sweeps that the rand
// tail (rand_tail.cu, K3) and the fused pair update (fused_pair.cu, K4)
// share: row norms, the stable top-chi selection, the noise guard and the
// discarded-weight rule.
//
// Computes what the Pallas kernels' epilogues compute
// (aqc_research_tpu/ops/fused_rand.py:_rand_tail_kernel_body and
// ops/fused_pair.py:_fused_kernel_body, steps 3-4), per matrix:
//
//   1. row norms s^2 of the rotated rows and their stable descending rank
//      (ties: lower row first), the top-chi rows selected in that order;
//   2. the noise guard s^2 > (32 eps)^2 s^2_max;
//   3. the discarded-weight rule against the full weight tot2: tail^2 =
//      (guarded suffix sum of the selected s^2) + max(tot2 - sum s^2 -
//      16 eps tot2, 0), keep = tail^2 > thr^2 tot2 and guard;
//   4. lambda = keep ? s sqrt(tot2 / max(kept^2, 1e-38)) : 0 and
//      inv = keep ? 1 / max(s, 1e-38) : 0.
//
// The Pallas kernels rank by a comparison matrix and select by a 0/1
// permutation matmul because Mosaic has no sort.  Here one block holds all
// row norms (K4's cluster path gathers them into every CTA and each runs
// the same select_truncate), so the rank is one comparison loop per row
// (rows^2 comparisons over the block) and the selected rows are read in
// place by the caller through ``sel``.  The rule's suffix sums run in one
// thread (chi <= 128 values, a few microseconds): tiny beside the sweeps.
// Rows may lie in shared or device memory.

#pragma once

#include <cuda_runtime.h>

#include "seat_sweeps.cuh"

namespace aqc {

// The epilogue's shared arrays, carved from rank_truncate_floats(rows, chi)
// shared floats: s2 [rows] row norms^2, s2s [chi] the selected ones
// (descending), inv [chi] keep flag, then 1/s, sel [chi] the row of rank k.
__host__ __device__ constexpr int rank_truncate_floats(int rows, int chi) { return rows + 3 * chi; }

struct RankScratch {
  float* s2;
  float* s2s;
  float* inv;
  int* sel;
  __device__ RankScratch(float* base, int rows, int chi)
      : s2(base), s2s(base + rows), inv(base + rows + chi),
        sel(reinterpret_cast<int*>(base + rows + 2 * chi)) {}
};

// Row norms s^2 of the (rows, n) planes into s2[0..rows), a warp per row
// (rows may lie in shared or device memory); no barrier.
__device__ inline void row_norms(const float* w_re, const float* w_im, int rows, int n, float* s2) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int j = warp; j < rows; j += nwarps) {
    const float* re = w_re + static_cast<size_t>(j) * n;
    const float* im = w_im + static_cast<size_t>(j) * n;
    float acc = 0.f;
    for (int e = lane; e < n; e += 32) acc += re[e] * re[e] + im[e] * im[e];
    acc = warp_sum(acc);
    if (lane == 0) s2[j] = acc;
  }
}

// Steps 1-4 on the row norms ``rs.s2[0..rows)``, which every thread of the
// block must see (written before a barrier).  With ``weight_from_rows`` the
// full weight is the sum of the rows' s^2 (the rows are the whole matrix:
// K4), else ``tot2``.  Writes lam_out[0..chi) and inv_out[0..chi) where not
// null; returns with the block synchronised and ``rs.sel`` / ``rs.inv``
// holding the selected rows in rank order and their 1/s (0 where dropped).
__device__ inline void select_truncate(const RankScratch& rs, int rows, int chi,
                                       bool weight_from_rows, float tot2, float thr2,
                                       float* lam_out, float* inv_out) {
  const float* s2 = rs.s2;
  float* s2s = rs.s2s;
  float* inv_s = rs.inv;
  int* sel = rs.sel;
  for (int i = threadIdx.x; i < chi; i += blockDim.x) {
    sel[i] = 0;  // only a non-finite row norm leaves a rank unfilled
    s2s[i] = 0.f;
  }
  __syncthreads();

  // ---- stable descending rank + top-chi select ----
  for (int j = threadIdx.x; j < rows; j += blockDim.x) {
    const float v = s2[j];
    int rank = 0;
    for (int m = 0; m < rows; ++m) {
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
    if (weight_from_rows) {
      tot2 = 0.f;
      for (int j = 0; j < rows; ++j) tot2 += s2[j];
    }
    const float floor2 = (32.f * kEps32) * (32.f * kEps32) * s2s[0];
    float head = 0.f;
    for (int i = 0; i < chi; ++i) head += s2s[i];
    const float rest2 = fmaxf(tot2 - head - 16.f * kEps32 * tot2, 0.f);
    float seen = 0.f, kept2 = 0.f;
    for (int i = chi - 1; i >= 0; --i) {  // suffix sums from the small end
      const bool guard = s2s[i] > floor2;
      if (guard) seen += s2s[i];
      const bool keep = guard && (seen + rest2 > thr2 * tot2);
      inv_s[i] = keep ? 1.f : 0.f;
      if (keep) kept2 += s2s[i];
    }
    const float rescale = sqrtf(tot2 / fmaxf(kept2, 1e-38f));
    for (int i = 0; i < chi; ++i) {
      const bool keep = inv_s[i] != 0.f;
      const float s = sqrtf(s2s[i]);
      const float inv = keep ? 1.f / fmaxf(s, 1e-38f) : 0.f;
      if (lam_out != nullptr) lam_out[i] = keep ? s * rescale : 0.f;
      if (inv_out != nullptr) inv_out[i] = inv;
      inv_s[i] = inv;
    }
  }
  __syncthreads();
}

// The whole epilogue on the (rows, n) rotated planes of one block: every
// thread of the block calls it after the sweeps (see select_truncate).
__device__ inline void rank_truncate(const float* w_re, const float* w_im, int rows, int n,
                                     int chi, bool weight_from_rows, float tot2, float thr2,
                                     const RankScratch& rs, float* lam_out, float* inv_out) {
  row_norms(w_re, w_im, rows, n, rs.s2);
  __syncthreads();
  select_truncate(rs, rows, chi, weight_from_rows, tot2, thr2, lam_out, inv_out);
}

}  // namespace aqc
