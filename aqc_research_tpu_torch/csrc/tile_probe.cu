// tile_probe.cu — the tile-precision probe, for sm_90a: two kernels that
// compute the same three results in three arithmetics.
//
// Replaces the two Pallas TPU compiler probes benchmarks/probe_mosaic_
// precision.py (main, pallas_call at :40: A·B and A·Bᵀ of (128, 128) f32
// at Precision.HIGHEST inside one kernel) and benchmarks/probe_mosaic_ops.py
// (main, pallas_call at :47: over a chunk of two pairs, s·(A·B) through a
// scratch with s from scalar memory, A·Bᵀ, and Aᵀ).  On the TPU they found
// that an in-kernel f32 product truncated its inputs to bf16 (2e-3 relative
// error) unless the kernel asked for HIGHEST.  On this card the same trap is
// TF32: a tensor-core product of f32 inputs keeps 10 mantissa bits.  Both
// kernels compute
//
//   o_dot[c] = s · (A_c · B_c)   (s read from device memory)
//   o_dgt[c] = A_c · B_cᵀ        (B's rows read as its columns in the copy:
//                                 the layout K4's vh product has)
//   o_tr[c]  = A_cᵀ              (through a padded shared-memory tile)
//
// and P1's pair is the case s = 1, c = 1.  The precision modes of the
// wrapper (ops/tile_probes.py) follow the JAX probes' words:
//
//   "fma"      tile_probe_kernel: the scheme of theta_tiles.cuh (K2, K4) on
//              the CUDA cores, true f32; a check of it against f64 holds
//              that scheme to true f32.
//   "highest"  tile_probe_tc_kernel<3>: wgmma in split 3xTF32, the
//              counterpart of HIGHEST: x = big + small with big = rna(x),
//              small = rna(x - big), and A·B = Ab·Bb + Ab·Bs + As·Bb (the
//              small·small term dropped).
//   "default"  tile_probe_tc_kernel<1>: wgmma in one TF32 pass of rna(A)
//              and rna(B), the counterpart of the TPU's default precision.
//
// tile_probe_kernel ("fma").  One block of 256 threads per (32x32 output
// tile, matrix, form): blockIdx.z picks the form.  A product tile gives each
// thread a 2x2 micro-tile (4 accumulators, plain FMA chains on the CUDA
// cores, no tensor cores, so no TF32); the contraction runs in k-tiles of
// 16, copied global -> shared by 4-byte cp.async (theta_tiles.cuh's
// helpers) into two stages, so the copy of k-tile i+1 overlaps the products
// of k-tile i, with one barrier per k-tile.  Both operands are stored
// [k][row or column] with rows padded by 2 floats; copies of ragged tiles
// read zeros, so any n works.  The transpose tile goes through a 32 x 33
// shared array: the padding puts the column reads of a warp on 32 distinct
// banks.  A and B are (c, n, n) row-major with any matrix stride (the probe
// reads pair planes in place).
//
// tile_probe_tc_kernel ("highest", "default").  One CTA of two consumer
// warpgroups (256 threads) per (128x128 output tile, matrix, form); each
// warpgroup owns 64 rows and issues
// wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 with both operands
// in shared memory.  Two warpgroups of N = 128 rather than one of N = 256:
// 64 accumulator registers a thread instead of 128, 256 threads to share
// the conversion pass, and 112 CTAs at the path's (14, 256) where 128x256
// tiles would give 56 on 132 SMs.  The contraction runs in k-tiles of 32
// f32 (128 B):
//   * copies: TMA (cp.async.bulk.tensor.3d) from three tensor maps over the
//     (c, n, n) stacks at their matrix strides: A's and B's rows in
//     128 x 32 boxes with 128-byte swizzle (A, and B of A·Bᵀ), B's columns
//     in 32 x 128 boxes (B of A·B); thread 0 issues both boxes of a k-tile,
//     completing on one mbarrier per stage (expect_tx), in a ring of two
//     raw stages.  cuTensorMapEncodeTiled is a driver-API call, reached
//     through cudaGetDriverEntryPointByVersion, so the link needs no
//     -lcuda.  The swizzle puts the conversion's float4 reads of eight
//     rows on eight distinct bank groups.  (1-D cp.async.bulk copies would
//     take one per 128-byte row: 256 a k-tile instead of 2.);
//   * conversion: every thread reads the raw f32 stage, rounds with
//     cvt.rna.tf32.f32 (fed raw f32 bits the tensor core would truncate
//     the low 13 bits instead) and, for 3xTF32, splits, writing the big
//     and small tiles K-major (wgmma takes .tf32 operands K-major only, so
//     B of A·B is transposed by this pass) as 8-row x 16-byte core matrices
//     without swizzle: core matrix (row group g, k chunk q) at
//     g·1024 + q·128 bytes, so the descriptor's leading byte offset (the
//     next core matrix along K) is 128 and its stride byte offset (the
//     next 8 rows) 1024;
//   * fences: the writers' fence.proxy.async, then wgmma.wait_group 0 (the
//     previous k-tile's products are done with the other operand set),
//     then one barrier; thread 0 refills the raw stage just read; then
//     wgmma.fence, the k-tile's 4 x passes products, commit_group.  The
//     operand tiles are double-buffered, so k-tile i's products run while
//     k-tile i+1 is converted;
//   * sums: each k-tile's 4 x passes products start a fresh tensor-core
//     sum, added to an f32 register sum on the CUDA cores (rounded to
//     nearest) once the k-tile's group is done: the tensor cores'
//     accumulator adds less exactly than f32 rounding to nearest, so it
//     carries one k-tile only;
//   * epilogue: s from device memory, float2 stores straight from the
//     register sums.
// n must be a multiple of 64 (a 128-row tile may be half used: rows and
// columns beyond n arrive as zeros from the tensor maps and are not stored).
// Blocks of the transpose form run tile_probe_kernel's padded-tile
// transpose on one 128 x 129 tile of their region: all its reads before one
// barrier (32 x 33 tiles, one after another, cost a round trip each).
//
// Bounds.  4 n^3 flop per matrix (two products), against 4 bytes x 5 n^2
// per matrix (A and B read once, three results written once) at 3.35 TB/s.
// On the CUDA cores' 67 TFLOP/s P2's chunk of two at n = 128 is 16.8 MFLOP
// (0.25 us) and 0.66 MB (0.20 us), so a launch (a few us) dominates.  On the
// tensor cores at 495 TFLOP/s x passes, the path's (14, 256) is 0.94 GFLOP:
// 5.7 us in 3xTF32 (operations-bound, just above the 5.5 us of its 18.4 MB);
// one pass needs 1.9 us of operations, so it is bytes-bound at 5.5 us.  The
// design reads every operand tile once per CTA into shared memory, converts
// each element once per CTA, keeps the sums in registers, and overlaps the
// copy of k-tile i+2 with the conversion of i+1 and the products of i.  On
// the card the two warpgroups still issue their products and then convert
// in lock step, so the conversion hides little of the products (PERF.md).

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_runtime.h>

#include <cstdint>

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

// One kE x kE tile of Aᵀ (kE = kEdge here; 128, a CTA's region, in the
// tensor-core kernel): rows r0.. and columns c0.. of A land in rows c0..
// and columns r0.. of ``out``.  Reads and writes are coalesced (consecutive
// threads on consecutive columns of each); the tile's padding puts a warp's
// column reads on 32 distinct banks.  A thread's reads all go to registers
// before any store to the tile, so they are in flight together: the tile
// pays one round trip to memory.
template <int kE = kEdge>
__device__ void tile_transpose(const float* __restrict__ a, float* __restrict__ out, int n,
                               int r0, int c0, int t, float (*tile)[kE + 1]) {
  constexpr int kRowsPerPass = kThreads / kE;  // 8 at kEdge
  constexpr int kPerThread = kE / kRowsPerPass;
  const int col = t % kE;
  float v[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int r = t / kE + i * kRowsPerPass;
    v[i] = r0 + r < n && c0 + col < n ? a[static_cast<size_t>(r0 + r) * n + c0 + col] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) tile[t / kE + i * kRowsPerPass][col] = v[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int r = t / kE + i * kRowsPerPass;
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

// ---- Tensor-core kernel ("highest", "default") ------------------------------

constexpr int kTcTile = 128;                // output tile edge of a CTA
constexpr int kTcK = 32;                    // k-tile depth: 32 f32 = 128 B
constexpr int kTcThreads = 256;             // two consumer warpgroups
constexpr int kTcStages = 2;                // raw copy ring
constexpr int kRawFloats = kTcTile * kTcK;  // one raw operand box, 16 KB
constexpr int kOpFloats = kTcTile * kTcK;   // one K-major operand tile, 16 KB
constexpr uint32_t kStageBytes = 2 * kRawFloats * 4;  // A's box and B's box
constexpr uint32_t kLeadBytes = 128;        // next core matrix along K
constexpr uint32_t kStrideBytes = 1024;     // next 8-row core matrix

// Operand tiles of one set: big A, big B, then (3xTF32) small A, small B.
__host__ __device__ constexpr int tc_operands(int passes) { return passes == 3 ? 4 : 2; }

__host__ __device__ constexpr int tc_smem_bytes(int passes) {
  return 4 * (2 * kTcStages * kRawFloats + 2 * tc_operands(passes) * kOpFloats) +
         8 * kTcStages;
}

// Float offset of (row, k chunk q) in a K-major operand tile: core matrix
// (row / 8, q) of 8 rows x 4 f32, rows 16 B apart.
__device__ __forceinline__ int op_at(int row, int q) {
  return (row >> 3) * (kStrideBytes / 4) + q * (kLeadBytes / 4) + (row & 7) * 4;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Spins until the phase of parity ``parity`` completed.  No watchdog: a
// trap on this path, between the products' issue and their wait, makes
// ptxas serialize every wgmma (its C7518 remark).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// The box of ``map`` at element (x, y, z) (x innermost) into shared ``dst``,
// completing on ``bar``; elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load(float* dst, const CUtensorMap* map, int x, int y, int z,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// Writes the operand values of x at ``at`` of the big tile (and of the
// small tile, 3xTF32).
template <int kPasses>
__device__ __forceinline__ void put_split(float4 x, float* big, float* small, int at) {
  const float4 hi = make_float4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z), tf32_rna(x.w));
  *reinterpret_cast<float4*>(big + at) = hi;
  if (kPasses == 3) {
    *reinterpret_cast<float4*>(small + at) =
        make_float4(tf32_rna(x.x - hi.x), tf32_rna(x.y - hi.y), tf32_rna(x.z - hi.z),
                    tf32_rna(x.w - hi.w));
  }
}

// The raw k-tile of one stage -> the K-major operand tiles of one set.  A's
// box (and B's for A·Bᵀ) is [row][k] with 128-byte swizzle: the 16-byte
// chunk q of row r sits at chunk q ^ (r % 8).  B's box for A·B is
// [k][column], unswizzled.
template <int kPasses, bool kTransB>
__device__ void convert_k_tile(const float* raw_a, const float* raw_b, float* set, int t) {
  constexpr int kSetStride = 2 * kOpFloats;  // big tiles, then small tiles
#pragma unroll
  for (int i = 0; i < kOpFloats / 4 / kTcThreads; ++i) {  // 4 float4 per operand
    const int idx = t + i * kTcThreads;
    // Eight consecutive threads: eight rows of one k chunk, eight distinct
    // bank groups through the swizzle.
    const int row = (idx >> 6) * 8 + (idx & 7), q = (idx >> 3) & 7;
    const int at = op_at(row, q), raw_at = row * kTcK + 4 * (q ^ (row & 7));
    put_split<kPasses>(*reinterpret_cast<const float4*>(raw_a + raw_at), set, set + kSetStride, at);
    float4 bx;
    int b_at = at;
    if (kTransB) {
      bx = *reinterpret_cast<const float4*>(raw_b + raw_at);
    } else {
      // Consecutive threads: consecutive columns j of one k chunk.
      const int j = idx & (kTcTile - 1), qb = idx >> 7;
      const float* col = raw_b + 4 * qb * kTcTile + j;
      bx = make_float4(col[0], col[kTcTile], col[2 * kTcTile], col[3 * kTcTile]);
      b_at = op_at(j, qb);
    }
    put_split<kPasses>(bx, set + kOpFloats, set + kSetStride + kOpFloats, b_at);
  }
}

__device__ __forceinline__ uint64_t op_desc(const float* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kLeadBytes >> 4) << 16) |
         (static_cast<uint64_t>(kStrideBytes >> 4) << 32);  // no swizzle, base offset 0
}

// d (64 rows of this warpgroup x 128 columns) = A (64 x 8) · B (8 x 128)
// + (accumulate ? d : 0), both operands K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Ties the accumulators to this point, so that no read of them moves above
// a wait.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// One 128x128 tile (rows r0.., columns c0..) of A·B (kTransB false) or
// A·Bᵀ (true), times ``scale``, into ``out``.  Each k-tile's products start
// a fresh tensor-core sum, which is added to an f32 register sum on the
// CUDA cores (rounded to nearest) once the k-tile is done.  Every thread of
// the block calls it.
template <int kPasses, bool kTransB>
__device__ void tc_product(const CUtensorMap* a_map, const CUtensorMap* b_map, int mat,
                           float* __restrict__ out, const float* __restrict__ scale, int n,
                           int r0, int c0, float* smem) {
  float* raw_a = smem;                                // [stage][row][k] or [k][column]
  float* raw_b = raw_a + kTcStages * kRawFloats;      // [stage][row][k] or [k][column]
  float* sets = raw_b + kTcStages * kRawFloats;       // [set][operand][kOpFloats]
  constexpr int kSetFloats = tc_operands(kPasses) * kOpFloats;
  uint64_t* full = reinterpret_cast<uint64_t*>(sets + 2 * kSetFloats);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, wg = t >> 7;
  const int k_tiles = n / kTcK;

  // Warp 0 (lane 0 issues): A's and B's boxes of k-tile ``kt`` into stage
  // kt % kTcStages (whole boxes always arrive: rows and columns past n as
  // zeros).
  auto load = [&](int kt) {
    if (lane == 0) {
      const int s = kt % kTcStages, k0 = kt * kTcK;
      mbar_expect_tx(&full[s], kStageBytes);
      tma_load(raw_a + s * kRawFloats, a_map, k0, r0, mat, &full[s]);
      if (kTransB) {
        tma_load(raw_b + s * kRawFloats, b_map, k0, c0, mat, &full[s]);
      } else {
        tma_load(raw_b + s * kRawFloats, b_map, c0, k0, mat, &full[s]);
      }
    }
    __syncwarp();
  };

  if (t == 0) {
    for (int s = 0; s < kTcStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 0) {
    for (int kt = 0; kt < kTcStages && kt < k_tiles; ++kt) load(kt);
  }

  float acc[64], part[64];  // the f32 sum; the k-tile's tensor-core sum
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;

  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % kTcStages;
    float* set = sets + (kt & 1) * kSetFloats;
    mbar_wait(&full[s], (kt / kTcStages) & 1);
    convert_k_tile<kPasses, kTransB>(raw_a + s * kRawFloats, raw_b + s * kRawFloats, set, t);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    wgmma_wait_all();  // k-tile kt-1's products are done with the other set
    if (kt > 0) {
      fence_acc(part);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
    }
    __syncthreads();   // set written by all; raw stage s read by all
    if (warp == 0 && kt + kTcStages < k_tiles) load(kt + kTcStages);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcK / 8; ++kk) {  // k8 steps: two core matrices along K
      const int a_at = wg * 64 * (kStrideBytes / 4) / 8 + kk * 2 * (kLeadBytes / 4);
      const int b_at = kk * 2 * (kLeadBytes / 4);
      const uint64_t a_big = op_desc(set + a_at), b_big = op_desc(set + kOpFloats + b_at);
      const int fresh = kk == 0;  // the k-tile's first product
      if (kPasses == 3) {
        const float* small = set + 2 * kOpFloats;
        wgmma_tf32(part, op_desc(small + a_at), b_big, !fresh);
        wgmma_tf32(part, a_big, op_desc(small + kOpFloats + b_at), 1);
        wgmma_tf32(part, a_big, b_big, 1);
      } else {
        wgmma_tf32(part, a_big, b_big, !fresh);
      }
    }
    wgmma_commit();
  }
  wgmma_wait_all();
  fence_acc(part);
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] += part[i];

  // Accumulator fragment: warp w of the warpgroup holds rows 16 w .. 16 w +
  // 15; lane l holds, per 8 columns j, rows l/4 and l/4 + 8 at columns
  // 8 j + 2 (l % 4) and the next.
  const float s = kTransB ? 1.f : __ldg(scale);
  const int row = r0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < kTcTile / 8; ++j) {
    const int col = c0 + 8 * j + 2 * (lane & 3);
    if (col < n) {
      if (row < n)
        *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * n + col) =
            make_float2(acc[4 * j] * s, acc[4 * j + 1] * s);
      if (row + 8 < n)
        *reinterpret_cast<float2*>(out + static_cast<size_t>(row + 8) * n + col) =
            make_float2(acc[4 * j + 2] * s, acc[4 * j + 3] * s);
    }
  }
}

// Tensor maps (3-D: k or column innermost, then rows, then matrices): A's
// and B's rows in [row][k] boxes of 128 x 32 with 128-byte swizzle, B's
// columns in [k][column] boxes of 32 x 128 without.
template <int kPasses>
__global__ void __launch_bounds__(kTcThreads, 1)
tile_probe_tc_kernel(const __grid_constant__ CUtensorMap a_rows,
                     const __grid_constant__ CUtensorMap b_rows,
                     const __grid_constant__ CUtensorMap b_cols, const float* __restrict__ a,
                     const float* __restrict__ scale, float* __restrict__ o_dot,
                     float* __restrict__ o_dgt, float* __restrict__ o_tr, int n,
                     long long a_stride) {
  extern __shared__ __align__(1024) float smem[];  // 128-byte swizzled boxes start here
  const int tiles = (n + kTcTile - 1) / kTcTile;
  const int r0 = (blockIdx.x / tiles) * kTcTile;
  const int c0 = (blockIdx.x % tiles) * kTcTile;
  const int mat = blockIdx.y;
  const size_t out_at = static_cast<size_t>(mat) * n * n;
  // blockIdx.z is the same for the whole block, so each branch's barriers
  // are reached by every thread.
  if (blockIdx.z == 0) {
    tc_product<kPasses, false>(&a_rows, &b_cols, mat, o_dot + out_at, scale, n, r0, c0, smem);
  } else if (blockIdx.z == 1) {
    tc_product<kPasses, true>(&a_rows, &b_rows, mat, o_dgt + out_at, scale, n, r0, c0, smem);
  } else {
    tile_transpose<kTcTile>(a + mat * a_stride, o_tr + out_at, n, r0, c0, threadIdx.x,
                            reinterpret_cast<float (*)[kTcTile + 1]>(smem));
  }
}

// cuTensorMapEncodeTiled, a driver-API call, reached through the runtime so
// the library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map of ``batch`` row-major (n, n) f32 matrices ``stride`` floats apart,
// in boxes of box_x (innermost, along a row) x box_y elements of one matrix.
bool encode_map(EncodeTiled encode, CUtensorMap* map, const float* base, int n, int batch,
                long long stride, uint32_t box_x, uint32_t box_y, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(n) * 4,
                                  static_cast<cuuint64_t>(stride) * 4};
  const cuuint32_t box[3] = {box_x, box_y, 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base), dims, strides,
                box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kPasses>
int tc_launch(const float* a, const float* b, const float* scale, float* o_dot, float* o_dgt,
              float* o_tr, int batch, int n, long long a_stride, long long b_stride,
              cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap a_rows, b_rows, b_cols;
  constexpr auto kSwizzled = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!encode_map(encode, &a_rows, a, n, batch, a_stride, kTcK, kTcTile, kSwizzled) ||
      !encode_map(encode, &b_rows, b, n, batch, b_stride, kTcK, kTcTile, kSwizzled) ||
      !encode_map(encode, &b_cols, b, n, batch, b_stride, kTcTile, kTcK, CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  const int smem = tc_smem_bytes(kPasses);
  const cudaError_t err = cudaFuncSetAttribute(
      tile_probe_tc_kernel<kPasses>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (n + kTcTile - 1) / kTcTile;
  const dim3 grid(tiles * tiles, batch, 3);
  tile_probe_tc_kernel<kPasses><<<grid, kTcThreads, smem, stream>>>(
      a_rows, b_rows, b_cols, a, scale, o_dot, o_dgt, o_tr, n, a_stride);
  return static_cast<int>(cudaGetLastError());
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

// The tensor-core kernel: ``passes`` 3 (split 3xTF32) or 1 (one TF32
// pass), one CTA per (128x128 output tile, matrix, form).  Arguments as
// tile_probe_launch; n a multiple of 64, a and b 16-byte aligned with
// matrix strides a multiple of 4 floats (the tensor maps' alignment).
int tile_probe_tc_launch(const float* a, const float* b, const float* scale, float* o_dot,
                         float* o_dgt, float* o_tr, int batch, int n, long long a_stride,
                         long long b_stride, int passes, void* stream) {
  if (n < 64 || n % 64 != 0 || batch < 1 || batch > 65535) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(a) % 16 != 0 || reinterpret_cast<uintptr_t>(b) % 16 != 0 ||
      a_stride % 4 != 0 || b_stride % 4 != 0)
    return cudaErrorMisalignedAddress;
  const auto s = static_cast<cudaStream_t>(stream);
  if (passes != 3 && passes != 1) return cudaErrorInvalidValue;
  return (passes == 3 ? tc_launch<3> : tc_launch<1>)(a, b, scale, o_dot, o_dgt, o_tr, batch, n,
                                                     a_stride, b_stride, s);
}

}  // extern "C"
