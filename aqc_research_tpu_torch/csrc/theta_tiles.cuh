// theta_tiles.cuh — one 16x16 tile of the gated two-site θᵀ planes, shared
// by theta_build.cu (K2: one block per tile) and fused_pair.cu (K4: one
// block per matrix walks all its tiles).
//
// Computes what the Pallas helper aqc_research_tpu/ops/fused_pair.py:
// _theta_build computes, on the tile (c0.., a0..) of all four output blocks:
//
//   a[u][b, a'] = g1[u, a', b] lam_l[a'] lam_c[b];  bm[v][c, b] = g2[v, b, c] lam_r[c]
//   M_uv = bm[v] @ a[u]                          (complex chi x chi products)
//   W0[t*chi + c, s*chi + a'] = sum_uv gate[(s,t),(u,v)] M_uv[c, a']
//
// from the λ-scaled transposed Γ planes (2, chi, chi) of one matrix (re and
// im of a and of bm) and its flat gate table (re of the 4x4 gate in
// [0, 16), im in [16, 32)).
//
// Arithmetic is true f32 (plain FMA on the CUDA cores, no tensor cores, so
// no TF32): the reference forces precision=HIGHEST because bf16 products
// cost 2e-3 relative error (fused_pair.py:70-78).  A group of 256 threads
// owns the tile, one (c, a') position and 8 accumulators per thread, and
// steps over the contraction index b in 16-wide shared-memory tiles of
// bm[v] and a[u]; then it mixes the four products through the gate into the
// same position of the four output blocks (s, t).  Any chi works (ragged
// tiles are zero-padded).

#pragma once

#include <cuda_runtime.h>

namespace aqc {

constexpr int kThetaTile = 16;                          // tile edge and contraction step
constexpr int kTileThreads = kThetaTile * kThetaTile;  // threads of one tile group

struct ThetaTileBuf {
  float b[2][2][kThetaTile][kThetaTile];  // [v][re, im][c][b]
  float a[2][2][kThetaTile][kThetaTile];  // [u][re, im][b][a']
};

// Thread ``t`` (0..255) of a tile group computes W0 at (c0 + t / 16,
// a0 + t % 16) of the four blocks.  ``gate`` is the matrix's 32-float table
// (read after the first barrier, so it may be filled just before the call);
// a/b planes point at the matrix's (2, chi, chi) inputs, w0 planes at its
// (2chi, 2chi) output.  ``active`` false: the group loads zeros and writes
// nothing.  It calls __syncthreads(): every thread of the block calls it
// equally often.
__device__ inline void theta_tile(const float* gate, const float* a_re, const float* a_im,
                                  const float* b_re, const float* b_im, float* w0_re,
                                  float* w0_im, int chi, int c0, int a0, bool active, int t,
                                  ThetaTileBuf& buf) {
  const int tx = t % kThetaTile;
  const int ty = t / kThetaTile;
  const size_t plane = static_cast<size_t>(chi) * chi;
  float m_re[4] = {0.f, 0.f, 0.f, 0.f};  // M_uv at (c0 + ty, a0 + tx), index 2u + v
  float m_im[4] = {0.f, 0.f, 0.f, 0.f};

  for (int k0 = 0; k0 < chi; k0 += kThetaTile) {
    const int bc = c0 + ty, bk = k0 + tx;  // element of bm[v]: row c, column b
    const int ak = k0 + ty, aa = a0 + tx;  // element of a[u]: row b, column a'
    const bool b_ok = active && bc < chi && bk < chi;
    const bool a_ok = active && ak < chi && aa < chi;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const size_t b_at = q * plane + static_cast<size_t>(bc) * chi + bk;
      const size_t a_at = q * plane + static_cast<size_t>(ak) * chi + aa;
      buf.b[q][0][ty][tx] = b_ok ? b_re[b_at] : 0.f;
      buf.b[q][1][ty][tx] = b_ok ? b_im[b_at] : 0.f;
      buf.a[q][0][ty][tx] = a_ok ? a_re[a_at] : 0.f;
      buf.a[q][1][ty][tx] = a_ok ? a_im[a_at] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kThetaTile; ++k) {
      const float br[2] = {buf.b[0][0][ty][k], buf.b[1][0][ty][k]};
      const float bi[2] = {buf.b[0][1][ty][k], buf.b[1][1][ty][k]};
      const float ar[2] = {buf.a[0][0][k][tx], buf.a[1][0][k][tx]};
      const float ai[2] = {buf.a[0][1][k][tx], buf.a[1][1][k][tx]};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          m_re[2 * u + v] += br[v] * ar[u] - bi[v] * ai[u];
          m_im[2 * u + v] += br[v] * ai[u] + bi[v] * ar[u];
        }
      }
    }
    __syncthreads();
  }

  const int c = c0 + ty, a = a0 + tx;
  if (!active || c >= chi || a >= chi) return;
  const int n = 2 * chi;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int tb = 0; tb < 2; ++tb) {
      float acc_re = 0.f, acc_im = 0.f;
#pragma unroll
      for (int uv = 0; uv < 4; ++uv) {
        const float gr = gate[(2 * s + tb) * 4 + uv];
        const float gi = gate[16 + (2 * s + tb) * 4 + uv];
        acc_re += gr * m_re[uv] - gi * m_im[uv];
        acc_im += gr * m_im[uv] + gi * m_re[uv];
      }
      const size_t o = static_cast<size_t>(tb * chi + c) * n + s * chi + a;
      w0_re[o] = acc_re;
      w0_im[o] = acc_im;
    }
  }
}

}  // namespace aqc
