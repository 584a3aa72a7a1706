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
// Design.  A simple tiled SIMT kernel in true f32: a block per (matrix,
// 16x16 tile of (c, a')) computes that tile of all four M_uv and mixes them
// through the gate (theta_tiles.cuh).  Any chi works (ragged tiles are
// zero-padded); there is no shared-memory wall, since the tiles do not grow
// with chi.
//
// Bounds.  At chi = 64 one matrix is ~8.4 MFLOP and ~262 KB of device
// traffic, so a half-layer batch (B ~ 10) is ~1.3 us of f32 work or ~0.8 us
// of traffic on an H100: launch overhead dominates, and the tile loop is not
// tuned.

#include <cuda_runtime.h>

#include "theta_tiles.cuh"

namespace {

__global__ void __launch_bounds__(aqc::kTileThreads)
theta_build_kernel(const float* __restrict__ gate, const float* __restrict__ a_re,
                   const float* __restrict__ a_im, const float* __restrict__ b_re,
                   const float* __restrict__ b_im, float* __restrict__ w0_re,
                   float* __restrict__ w0_im, int chi) {
  __shared__ float s_gate[32];
  __shared__ aqc::ThetaTileBuf buf;

  const int mat = blockIdx.y;
  const int tiles = (chi + aqc::kThetaTile - 1) / aqc::kThetaTile;
  const int c0 = (blockIdx.x / tiles) * aqc::kThetaTile;
  const int a0 = (blockIdx.x % tiles) * aqc::kThetaTile;
  if (threadIdx.x < 32) s_gate[threadIdx.x] = gate[static_cast<size_t>(mat) * 32 + threadIdx.x];

  const size_t in_base = static_cast<size_t>(mat) * 2 * chi * chi;
  const size_t out_base = static_cast<size_t>(mat) * 4 * chi * chi;
  aqc::theta_tile(s_gate, a_re + in_base, a_im + in_base, b_re + in_base, b_im + in_base,
                  w0_re + out_base, w0_im + out_base, chi, c0, a0, true, threadIdx.x, buf);
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
  const int tiles = (chi + aqc::kThetaTile - 1) / aqc::kThetaTile;
  const dim3 grid(tiles * tiles, batch);
  theta_build_kernel<<<grid, aqc::kTileThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      gate, a_re, a_im, b_re, b_im, w0_re, w0_im, chi);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
