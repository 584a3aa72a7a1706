// tile_probe.cu — the tile-precision probe of the shared-memory tile code,
// for sm_90a.
//
// Replaces the two Pallas TPU compiler probes benchmarks/probe_mosaic_
// precision.py (main, pallas_call at :40: A·B and A·Bᵀ of (128, 128) f32
// at Precision.HIGHEST inside one kernel) and benchmarks/probe_mosaic_ops.py
// (main, pallas_call at :47: over a chunk of two pairs, s·(A·B) through a
// scratch with s from scalar memory, A·Bᵀ, and Aᵀ).  On the TPU they found
// that an in-kernel f32 product truncated its inputs to bf16 (2e-3 relative
// error) unless the kernel asked for HIGHEST.  On this card the same trap is
// TF32: a tensor-core product of f32 inputs keeps 10 mantissa bits.  This
// kernel computes the probes' results with the scheme of theta_tiles.cuh
// (K2, K4), so a check of it against f64 holds that scheme to true f32:
//
//   o_dot[c] = s · (A_c · B_c)   (s read from device memory)
//   o_dgt[c] = A_c · B_cᵀ        (B's rows read as its columns in the copy:
//                                 the layout K4's vh product has)
//   o_tr[c]  = A_cᵀ              (through a padded shared-memory tile)
//
// and P1's pair is the case s = 1, c = 1.
//
// Design.  One block of 256 threads per (32x32 output tile, matrix, form):
// blockIdx.z picks the form.  A product tile gives each thread a 2x2
// micro-tile (4 accumulators, plain FMA chains on the CUDA cores, no tensor
// cores, so no TF32); the contraction runs in k-tiles of 16, copied global
// -> shared by 4-byte cp.async (theta_tiles.cuh's helpers) into two stages,
// so the copy of k-tile i+1 overlaps the products of k-tile i, with one
// barrier per k-tile.  Both operands are stored [k][row or column] with
// rows padded by 2 floats; copies of ragged tiles read zeros, so any n works.
// The transpose tile goes through a 32 x 33 shared array: the padding puts
// the column reads of a warp on 32 distinct banks.  A and B are (c, n, n)
// row-major with any matrix stride (the probe reads pair planes in place).
//
// Bounds.  4 n^3 flop per matrix (two products) on the CUDA cores' 67
// TFLOP/s against 4 bytes x 5 n^2 per matrix at 3.35 TB/s: P2's chunk of two
// at n = 128 is 16.8 MFLOP (0.25 us) and 0.66 MB (0.20 us), so a launch
// (a few us) dominates.  Speed is not the aim: the probe checks precision.

#include <cuda_runtime.h>

#include "theta_tiles.cuh"

namespace {

constexpr int kEdge = 32;                 // output tile edge
constexpr int kDepth = aqc::kThetaK;      // k-tile depth (16)
constexpr int kThreads = aqc::kTileThreads;  // 256: 16 x 16 threads, 2x2 each
constexpr int kSide = kEdge / 2;

struct alignas(16) ProbeBuf {
  float a[2][kDepth][kEdge + 2];  // [stage][k][row of A]
  float b[2][kDepth][kEdge + 2];  // [stage][k][column of the right factor]
};

// One kEdge x kEdge tile (rows r0.., columns c0..) of A·B (kTransB false) or
// A·Bᵀ (true), times ``scale``, into ``out``.  Calls __syncthreads(): every
// thread of the block calls it.
template <bool kTransB>
__device__ void tile_product(const float* __restrict__ a, const float* __restrict__ b,
                             float* __restrict__ out, float scale, int n, int r0, int c0,
                             int t, ProbeBuf& buf) {
  const int tx = t % kSide;
  const int ty = t / kSide;
  constexpr int kCopies = kDepth * kEdge / kThreads;  // 2 per operand and thread

  auto copy = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const int idx = t + i * kThreads;
      // A's rows r0.., k contiguous in memory: consecutive threads take
      // consecutive k.
      const int ar = idx / kDepth, ak = idx % kDepth;
      const bool a_ok = r0 + ar < n && k0 + ak < n;
      const size_t a_at = static_cast<size_t>(r0 + ar) * n + k0 + ak;
      aqc::cp_async4(&buf.a[stage][ak][ar], a + (a_ok ? a_at : 0), a_ok);
      if (kTransB) {
        // Bᵀ[k][j] = B[j][k]: B's rows c0.. are the right factor's columns,
        // read along k (contiguous), as A's rows are.
        const int bj = idx / kDepth, bk = idx % kDepth;
        const bool b_ok = c0 + bj < n && k0 + bk < n;
        const size_t b_at = static_cast<size_t>(c0 + bj) * n + k0 + bk;
        aqc::cp_async4(&buf.b[stage][bk][bj], b + (b_ok ? b_at : 0), b_ok);
      } else {
        // B's rows k0.., columns c0.. contiguous.
        const int bk = idx / kEdge, bj = idx % kEdge;
        const bool b_ok = k0 + bk < n && c0 + bj < n;
        const size_t b_at = static_cast<size_t>(k0 + bk) * n + c0 + bj;
        aqc::cp_async4(&buf.b[stage][bk][bj], b + (b_ok ? b_at : 0), b_ok);
      }
    }
    aqc::cp_async_commit();
  };

  float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  const int k_tiles = (n + kDepth - 1) / kDepth;
  copy(0, 0);
  for (int kt = 0; kt < k_tiles; ++kt) {
    aqc::cp_async_wait_all();
    __syncthreads();  // k-tile kt landed for all; every thread is done with kt - 1
    if (kt + 1 < k_tiles) copy((kt + 1) & 1, (kt + 1) * kDepth);
    const int st = kt & 1;
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      const float2 av = *reinterpret_cast<const float2*>(&buf.a[st][k][2 * ty]);
      const float2 bv = *reinterpret_cast<const float2*>(&buf.b[st][k][2 * tx]);
      acc[0][0] = fmaf(av.x, bv.x, acc[0][0]);
      acc[0][1] = fmaf(av.x, bv.y, acc[0][1]);
      acc[1][0] = fmaf(av.y, bv.x, acc[1][0]);
      acc[1][1] = fmaf(av.y, bv.y, acc[1][1]);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = r0 + 2 * ty + i, c = c0 + 2 * tx + j;
      if (r < n && c < n) out[static_cast<size_t>(r) * n + c] = acc[i][j] * scale;
    }
  }
}

// One kEdge x kEdge tile of Aᵀ: rows r0.. and columns c0.. of A land in
// rows c0.. and columns r0.. of ``out``.  Reads and writes are coalesced
// (consecutive threads on consecutive columns of each).
__device__ void tile_transpose(const float* __restrict__ a, float* __restrict__ out, int n,
                               int r0, int c0, int t, float (*tile)[kEdge + 1]) {
  constexpr int kRowsPerPass = kThreads / kEdge;  // 8
  const int col = t % kEdge;
#pragma unroll
  for (int r = t / kEdge; r < kEdge; r += kRowsPerPass) {
    if (r0 + r < n && c0 + col < n) tile[r][col] = a[static_cast<size_t>(r0 + r) * n + c0 + col];
  }
  __syncthreads();
#pragma unroll
  for (int r = t / kEdge; r < kEdge; r += kRowsPerPass) {
    if (c0 + r < n && r0 + col < n) out[static_cast<size_t>(c0 + r) * n + r0 + col] = tile[col][r];
  }
}

__global__ void __launch_bounds__(kThreads)
tile_probe_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ scale, float* __restrict__ o_dot,
                  float* __restrict__ o_dgt, float* __restrict__ o_tr, int n,
                  long long a_stride, long long b_stride) {
  __shared__ ProbeBuf buf;
  __shared__ float tile[kEdge][kEdge + 1];
  const int tiles = (n + kEdge - 1) / kEdge;
  const int r0 = (blockIdx.x / tiles) * kEdge;
  const int c0 = (blockIdx.x % tiles) * kEdge;
  const int mat = blockIdx.y;
  const float* am = a + mat * a_stride;
  const float* bm = b + mat * b_stride;
  const size_t out_at = static_cast<size_t>(mat) * n * n;
  // blockIdx.z is the same for the whole block, so each branch's barriers
  // are reached by every thread.
  if (blockIdx.z == 0) {
    tile_product<false>(am, bm, o_dot + out_at, *scale, n, r0, c0, threadIdx.x, buf);
  } else if (blockIdx.z == 1) {
    tile_product<true>(am, bm, o_dgt + out_at, 1.f, n, r0, c0, threadIdx.x, buf);
  } else {
    tile_transpose(am, o_tr + out_at, n, r0, c0, threadIdx.x, tile);
  }
}

}  // namespace

extern "C" {

// Launches one block per (32x32 output tile, matrix, form) on ``stream``.
// a, b: ``batch`` row-major (n, n) f32 matrices, ``a_stride`` / ``b_stride``
// floats apart; scale: one f32 in device memory; o_dot, o_dgt, o_tr:
// contiguous (batch, n, n) f32.  Returns the CUDA error code of the launch
// (0 on success).
int tile_probe_launch(const float* a, const float* b, const float* scale, float* o_dot,
                      float* o_dgt, float* o_tr, int batch, int n, long long a_stride,
                      long long b_stride, void* stream) {
  if (n < 1 || batch < 1 || batch > 65535) return cudaErrorInvalidValue;
  const int tiles = (n + kEdge - 1) / kEdge;
  if (static_cast<long long>(tiles) * tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(tiles * tiles, batch, 3);
  tile_probe_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, scale, o_dot, o_dgt, o_tr, n, a_stride, b_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
