// theta_build.cu — the gated two-site θᵀ planes of a batch of MPS pair
// updates, for sm_90a.
//
// Replaces the Pallas TPU kernel aqc_research_tpu/ops/fused_pair.py:
// theta_build_raw (body _theta_build), pass A of the fused randomized-
// projection pair update, and computes what it computes: the gated θᵀ
// (the tile loop in theta_tiles.cuh, shared with K4) from the λ-scaled
// transposed Γ planes (B, 2, chi, chi) (re and im of a and of bm) and the
// flat gate table (B, 32): re of the 4x4 gate in [0, 16), im in [16, 32).
// Outputs are W0's re/im planes (B, 2chi, 2chi).
//
// Design.  A block of 256 threads per (matrix, edge x edge tile of (c, a'))
// runs the tile product of theta_tiles.cuh for all four M_uv and mixes them
// through the gate.  The edge is 32, with 2x2 register micro-tiles, where
// those tiles give the card more blocks than SMs (B=14 chi=128: 224
// blocks); else 16 with one position a thread (B=10 chi=64: 160 blocks of 8
// warps, where 2x2 micro-tiles left 2.4 warps per SM and ran slower); the
// wrapper's rule is ops/fused_pair.theta_tile_edge.  Any chi works (ragged
// tiles are zero-filled).
//
// Bounds.  32 chi^3 flop per matrix in f32 on the CUDA cores (B=14 chi=128:
// 0.94 GFLOP, 14 us at 67 TFLOP/s) against 64 chi^2 bytes: operations-bound
// at chi = 128; at chi = 64 (1.3 us of work) the launch dominates.

#include <cuda_runtime.h>

#include "theta_tiles.cuh"

namespace {

// 256 threads a block at both tile shapes (edge 32 with 2x2 micro-tiles,
// edge 16 with one position a thread); at most 128 registers a thread, so
// two blocks of edge 32 share an SM and a half-layer batch runs in one wave.
template <int kEdge, int kMicro>
__global__ void __launch_bounds__(aqc::kTileThreads, kMicro == 2 ? 2 : 4)
theta_build_kernel(const float* __restrict__ gate, const float* __restrict__ a_re,
                   const float* __restrict__ a_im, const float* __restrict__ b_re,
                   const float* __restrict__ b_im, float* __restrict__ w0_re,
                   float* __restrict__ w0_im, int chi) {
  __shared__ float s_gate[32];
  __shared__ aqc::ThetaTileBufT<kEdge> buf;
  static_assert((kEdge / kMicro) * (kEdge / kMicro) == aqc::kTileThreads, "256-thread tiles");

  const int mat = blockIdx.y;
  const int tiles = (chi + kEdge - 1) / kEdge;
  const int c0 = (blockIdx.x / tiles) * kEdge;
  const int a0 = (blockIdx.x % tiles) * kEdge;
  if (threadIdx.x < 32) s_gate[threadIdx.x] = gate[static_cast<size_t>(mat) * 32 + threadIdx.x];

  const size_t in_base = static_cast<size_t>(mat) * 2 * chi * chi;
  const size_t out_base = static_cast<size_t>(mat) * 4 * chi * chi;
  aqc::theta_tile<kEdge, kMicro>(s_gate, a_re + in_base, a_im + in_base, b_re + in_base,
                                 b_im + in_base, w0_re + out_base, w0_im + out_base, chi, c0,
                                 a0, true, threadIdx.x, buf);
}

template <int kEdge, int kMicro>
int launch(const float* gate, const float* a_re, const float* a_im, const float* b_re,
           const float* b_im, float* w0_re, float* w0_im, int batch, int chi,
           cudaStream_t stream) {
  const int tiles = (chi + kEdge - 1) / kEdge;
  const dim3 grid(tiles * tiles, batch);
  theta_build_kernel<kEdge, kMicro><<<grid, aqc::kTileThreads, 0, stream>>>(
      gate, a_re, a_im, b_re, b_im, w0_re, w0_im, chi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches one block per (edge x edge output tile, matrix) on ``stream``;
// ``edge`` is 16 or 32.  Returns the CUDA error code of the launch (0 on
// success).  Inputs are contiguous f32: gate (batch, 32), a/b planes
// (batch, 2, chi, chi); outputs (batch, 2chi, 2chi).
int theta_build_launch(const float* gate, const float* a_re, const float* a_im,
                       const float* b_re, const float* b_im, float* w0_re, float* w0_im,
                       int batch, int chi, int edge, void* stream) {
  if (chi < 1 || batch < 1 || batch > 65535) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (edge == 32)
    return launch<32, 2>(gate, a_re, a_im, b_re, b_im, w0_re, w0_im, batch, chi, s);
  if (edge == 16)
    return launch<16, 1>(gate, a_re, a_im, b_re, b_im, w0_re, w0_im, batch, chi, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
