// theta_build.cu — the gated two-site θᵀ planes of a batch of MPS pair
// updates, for sm_90a.
//
// Replaces the Pallas TPU kernel aqc_research_tpu/ops/fused_pair.py:
// theta_build_raw (body _theta_build), pass A of the fused randomized-
// projection pair update, and computes what it computes:
//
//   a[u][b, a'] = g1[u, a', b] lam_l[a'] lam_c[b];  bm[v][c, b] = g2[v, b, c] lam_r[c]
//   M_uv = bm[v] @ a[u]                          (complex chi x chi products)
//   W0[t*chi + c, s*chi + a'] = sum_uv gate[(s,t),(u,v)] M_uv[c, a']
//
// from the λ-scaled transposed Γ planes (B, 2, chi, chi) (re and im of a and
// of bm) and the flat gate table (B, 32): re of the 4x4 gate in [0, 16), im
// in [16, 32).  Outputs are W0's re/im planes (B, 2chi, 2chi).
//
// Arithmetic is true f32 (plain FMA on the CUDA cores, no tensor cores, so
// no TF32): the reference forces precision=HIGHEST because bf16 products
// cost 2e-3 relative error (fused_pair.py:70-78).
//
// Design.  A simple tiled SIMT kernel: a block per (matrix, 16x16 tile of
// (c, a')) computes that tile of all four M_uv (16 real products; each
// thread owns one (c, a') position and 8 accumulators), stepping over the
// contraction index b in 16-wide shared-memory tiles of bm[v] and a[u], and
// then mixes the four products through the gate (read once per block into
// shared memory) into the same position of the four output blocks (s, t).
// Any chi with chi % 8 == 0 works (ragged tiles are zero-padded); there is
// no shared-memory wall, since the tiles do not grow with chi.
//
// Bounds.  At chi = 64 one matrix is ~8.4 MFLOP and ~262 KB of device
// traffic, so a half-layer batch (B ~ 10) is ~1.3 us of f32 work or ~0.8 us
// of traffic on an H100: launch overhead dominates, and the tile loop is not
// tuned.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;  // output tile edge and contraction step

__global__ void __launch_bounds__(kTile * kTile)
theta_build_kernel(const float* __restrict__ gate, const float* __restrict__ a_re,
                   const float* __restrict__ a_im, const float* __restrict__ b_re,
                   const float* __restrict__ b_im, float* __restrict__ w0_re,
                   float* __restrict__ w0_im, int chi) {
  __shared__ float s_gate[32];
  __shared__ float s_b[2][2][kTile][kTile];  // [v][re, im][c][b]
  __shared__ float s_a[2][2][kTile][kTile];  // [u][re, im][b][a']

  const int mat = blockIdx.y;
  const int tiles = (chi + kTile - 1) / kTile;
  const int c0 = (blockIdx.x / tiles) * kTile;
  const int a0 = (blockIdx.x % tiles) * kTile;
  const int tx = threadIdx.x % kTile;
  const int ty = threadIdx.x / kTile;
  if (threadIdx.x < 32) s_gate[threadIdx.x] = gate[static_cast<size_t>(mat) * 32 + threadIdx.x];

  const size_t plane = static_cast<size_t>(chi) * chi;
  const size_t in_base = static_cast<size_t>(mat) * 2 * plane;
  float m_re[4] = {0.f, 0.f, 0.f, 0.f};  // M_uv at (c0 + ty, a0 + tx), index 2u + v
  float m_im[4] = {0.f, 0.f, 0.f, 0.f};

  for (int k0 = 0; k0 < chi; k0 += kTile) {
    const int bc = c0 + ty, bk = k0 + tx;  // element of bm[v]: row c, column b
    const int ak = k0 + ty, aa = a0 + tx;  // element of a[u]: row b, column a'
    const bool b_ok = bc < chi && bk < chi;
    const bool a_ok = ak < chi && aa < chi;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const size_t b_at = in_base + q * plane + static_cast<size_t>(bc) * chi + bk;
      const size_t a_at = in_base + q * plane + static_cast<size_t>(ak) * chi + aa;
      s_b[q][0][ty][tx] = b_ok ? b_re[b_at] : 0.f;
      s_b[q][1][ty][tx] = b_ok ? b_im[b_at] : 0.f;
      s_a[q][0][ty][tx] = a_ok ? a_re[a_at] : 0.f;
      s_a[q][1][ty][tx] = a_ok ? a_im[a_at] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTile; ++k) {
      const float br[2] = {s_b[0][0][ty][k], s_b[1][0][ty][k]};
      const float bi[2] = {s_b[0][1][ty][k], s_b[1][1][ty][k]};
      const float ar[2] = {s_a[0][0][k][tx], s_a[1][0][k][tx]};
      const float ai[2] = {s_a[0][1][k][tx], s_a[1][1][k][tx]};
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
  if (c >= chi || a >= chi) return;
  const size_t out_base = static_cast<size_t>(mat) * 4 * plane;
  const int n = 2 * chi;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      float acc_re = 0.f, acc_im = 0.f;
#pragma unroll
      for (int uv = 0; uv < 4; ++uv) {
        const float gr = s_gate[(2 * s + t) * 4 + uv];
        const float gi = s_gate[16 + (2 * s + t) * 4 + uv];
        acc_re += gr * m_re[uv] - gi * m_im[uv];
        acc_im += gr * m_im[uv] + gi * m_re[uv];
      }
      const size_t o = out_base + static_cast<size_t>(t * chi + c) * n + s * chi + a;
      w0_re[o] = acc_re;
      w0_im[o] = acc_im;
    }
  }
}

}  // namespace

extern "C" {

// Launches one block per (16x16 output tile, matrix) on ``stream``; returns
// the CUDA error code of the launch (0 on success).  Inputs are contiguous
// f32: gate (batch, 32), a/b planes (batch, 2, chi, chi); outputs (batch,
// 2chi, 2chi).
int theta_build_launch(const float* gate, const float* a_re, const float* a_im,
                       const float* b_re, const float* b_im, float* w0_re, float* w0_im,
                       int batch, int chi, void* stream) {
  if (chi < 1 || batch < 1 || batch > 65535) return cudaErrorInvalidValue;
  const int tiles = (chi + kTile - 1) / kTile;
  const dim3 grid(tiles * tiles, batch);
  theta_build_kernel<<<grid, kTile * kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      gate, a_re, a_im, b_re, b_im, w0_re, w0_im, chi);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
