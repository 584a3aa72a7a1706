// theta_tiles.cuh — one output tile of the gated two-site θᵀ planes, shared
// by theta_build.cu (K2: one block per tile) and fused_pair.cu (K4: the
// tile groups of a block, or of a cluster, walk the matrix's tiles).
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
// cost 2e-3 relative error (fused_pair.py:70-78).
//
// Design: a register-blocked tile product.  A group of 256 threads owns a
// kEdge x kEdge output tile; with kMicro = 2 (edge 32: K4, and K2 where the
// batch fills the card) each thread holds a 2x2 micro-tile of positions for
// all four M_uv (32 accumulators).  Per contraction step it then loads 4
// float2 of bm (its two rows, both v, re and im) and 4 float2 of a (its two
// columns, both u, re and im) for 64 FMA: 8 FMA per shared load (2 in the
// earlier one-position loop, which kMicro = 1, edge 16, still is).  The
// contraction runs in k-tiles of 16, copied global -> shared by cp.async
// into two stages, so the copy of k-tile i+1 overlaps the products of k-tile
// i, with one barrier per k-tile.  The copies are
// 4-byte cp.async with zero fill, so any chi works (ragged tiles and k-tiles
// read zeros) at any alignment.  The 4x4 gate mix runs in the epilogue, on
// the registers.
//
// Bounds: 32 chi^3 flop per matrix (the four complex products) against
// 64 chi^2 bytes in and out; operations-bound for chi >~ 16.

#pragma once

#include <cuda_runtime.h>

namespace aqc {

constexpr int kThetaEdge = 32;     // K4's tile edge, 2x2 micro-tiles (K2: theta_build.cu)
constexpr int kThetaK = 16;        // k-tile depth
constexpr int kTileThreads = 256;  // threads of a tile group: (edge / micro)^2

// Two stages of one k-tile of bm (stored transposed, [k][c], rows padded by
// 2 against bank conflicts of the copies) and of a ([k][a']).
template <int kEdge>
struct alignas(16) ThetaTileBufT {
  float b[2][4][kThetaK][kEdge + 2];  // [stage][2v + ri][k][c]
  float a[2][4][kThetaK][kEdge];      // [stage][2u + ri][k][a']
};
using ThetaTileBuf = ThetaTileBufT<kThetaEdge>;

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Thread ``t`` (0 .. 255) of a tile group computes W0 at the kMicro x kMicro
// positions from row c0 + kMicro (t / (kEdge/kMicro)) and column
// a0 + kMicro (t % (kEdge/kMicro)) of the four blocks.  ``gate`` is the
// matrix's 32-float table (read after the first barrier, so it may be
// filled just before the call); a/b planes point at the matrix's (2, chi,
// chi) inputs, w0 planes at its (2chi, 2chi) output.  ``active`` false: the group neither copies nor reads its buffer
// (which may then be any pointer) and writes nothing.  It calls
// __syncthreads(): every thread of the block calls it equally often, with
// the same chi.
template <int kEdge, int kMicro>
__device__ inline void theta_tile(const float* gate, const float* a_re, const float* a_im,
                                  const float* b_re, const float* b_im, float* w0_re,
                                  float* w0_im, int chi, int c0, int a0, bool active, int t,
                                  ThetaTileBufT<kEdge>& buf) {
  constexpr int kSide = kEdge / kMicro;  // threads along a tile edge
  constexpr int kThreads = kSide * kSide;
  constexpr int kCopies = 4 * kThetaK * kEdge / kThreads;  // per operand and thread
  static_assert(kThreads % kThetaK == 0 && kThreads % kEdge == 0, "fixed k / a' per thread");
  const int tx = t % kSide;
  const int ty = t / kSide;
  const size_t plane = static_cast<size_t>(chi) * chi;

  // One k-tile into ``stage``: bm[v] rows c0.. (k contiguous in memory:
  // consecutive threads take consecutive k) and a[u] rows k0.. (a'
  // contiguous).  kThreads is a multiple of kThetaK and of kEdge, so each
  // thread copies one fixed k of bm and one fixed a' of a.  The loop stays
  // rolled: unrolled, the compiler keeps every copy's address live in
  // registers across the k-tiles.
  const int kb = t % kThetaK;
  const int ap = t % kEdge;
  auto copy = [&](int stage, int k0) {
#pragma unroll 1
    for (int i = 0; i < kCopies; ++i) {
      const int idx = t + i * kThreads;
      const int q = idx / (kThetaK * kEdge);  // 2 (v or u) + (re, im)
      const float* b_src = (q & 1) ? b_im : b_re;
      const float* a_src = (q & 1) ? a_im : a_re;
      const int c = (idx / kThetaK) % kEdge;
      const bool b_ok = c0 + c < chi && k0 + kb < chi;
      const size_t b_at = (q >> 1) * plane + static_cast<size_t>(c0 + c) * chi + k0 + kb;
      cp_async4(&buf.b[stage][q][kb][c], b_src + (b_ok ? b_at : 0), b_ok);
      const int k = (idx / kEdge) % kThetaK;
      const bool a_ok = a0 + ap < chi && k0 + k < chi;
      const size_t a_at = (q >> 1) * plane + static_cast<size_t>(k0 + k) * chi + a0 + ap;
      cp_async4(&buf.a[stage][q][k][ap], a_src + (a_ok ? a_at : 0), a_ok);
    }
    cp_async_commit();
  };

  // m_re/m_im[(kMicro i + j) * 4 + 2u + v]: M_uv at (row i, column j) of
  // the micro-tile.
  constexpr int kPos = kMicro * kMicro;
  float m_re[4 * kPos], m_im[4 * kPos];
#pragma unroll
  for (int i = 0; i < 4 * kPos; ++i) m_re[i] = m_im[i] = 0.f;

  const int k_tiles = (chi + kThetaK - 1) / kThetaK;
  if (active) copy(0, 0);
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait_all();
    __syncthreads();  // k-tile kt landed for all; every thread is done with kt - 1
    if (active && kt + 1 < k_tiles) copy((kt + 1) & 1, (kt + 1) * kThetaK);
    if (active) {
      const int st = kt & 1;
#pragma unroll
      for (int k = 0; k < kThetaK; ++k) {
        float bv[4][kMicro], av[4][kMicro];  // [2v + ri][row]; [2u + ri][column]
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if constexpr (kMicro == 2) {
            const float2 b2 = *reinterpret_cast<const float2*>(&buf.b[st][q][k][2 * ty]);
            const float2 a2 = *reinterpret_cast<const float2*>(&buf.a[st][q][k][2 * tx]);
            bv[q][0] = b2.x;
            bv[q][1] = b2.y;
            av[q][0] = a2.x;
            av[q][1] = a2.y;
          } else {
            bv[q][0] = buf.b[st][q][k][ty];
            av[q][0] = buf.a[st][q][k][tx];
          }
        }
#pragma unroll
        for (int i = 0; i < kMicro; ++i) {
#pragma unroll
          for (int j = 0; j < kMicro; ++j) {
#pragma unroll
            for (int u = 0; u < 2; ++u) {
#pragma unroll
              for (int v = 0; v < 2; ++v) {
                const float b_r = bv[2 * v][i], b_i = bv[2 * v + 1][i];
                const float a_r = av[2 * u][j], a_i = av[2 * u + 1][j];
                const int o = (kMicro * i + j) * 4 + 2 * u + v;
                m_re[o] = fmaf(b_r, a_r, m_re[o]);  // plain FMA chains
                m_re[o] = fmaf(-b_i, a_i, m_re[o]);
                m_im[o] = fmaf(b_r, a_i, m_im[o]);
                m_im[o] = fmaf(b_i, a_r, m_im[o]);
              }
            }
          }
        }
      }
    }
  }
  __syncthreads();  // the next call's first copy may overwrite either stage

  if (!active) return;
  const int n = 2 * chi;
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const int c = c0 + kMicro * ty + i, a = a0 + kMicro * tx + j;
      if (c >= chi || a >= chi) continue;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
#pragma unroll
        for (int tb = 0; tb < 2; ++tb) {
          float acc_re = 0.f, acc_im = 0.f;
#pragma unroll
          for (int uv = 0; uv < 4; ++uv) {
            const float gr = gate[(2 * s + tb) * 4 + uv];
            const float gi = gate[16 + (2 * s + tb) * 4 + uv];
            const int o = (kMicro * i + j) * 4 + uv;
            acc_re += gr * m_re[o] - gi * m_im[o];
            acc_im += gr * m_im[o] + gi * m_re[o];
          }
          const size_t o = static_cast<size_t>(tb * chi + c) * n + s * chi + a;
          w0_re[o] = acc_re;
          w0_im[o] = acc_im;
        }
      }
    }
  }
}

}  // namespace aqc
