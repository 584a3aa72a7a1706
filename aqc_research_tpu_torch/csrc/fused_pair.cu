// fused_pair.cu — the fused pair update of the jacobi route: θ build,
// adaptive one-sided Jacobi, selection, truncation and both factors of a
// batch of MPS pair updates in one kernel, for sm_90a.
//
// Replaces the Pallas TPU kernel aqc_research_tpu/ops/fused_pair.py:
// _fused_pair_raw (body _fused_kernel_body) and computes what it computes,
// per matrix:
//
//   1. W0 = θᵀ (2chi, 2chi) from the λ-scaled Γ planes and the gate
//      (theta_tiles.cuh, K2's tile loop), kept in device memory for step 5;
//   2. the adaptive Jacobi on a working copy of W0, with L = rows 0..chi-1
//      and R = rows chi..2chi-1 (the JAX seating; on the cluster home the
//      block-cyclic order of block_sweeps.cuh): row j of the rotated planes
//      is (s_j u_j)^T;
//   3. the epilogue shared with K3 (rank_truncate.cuh): row norms, the
//      stable top-chi selection, the 32 eps guard and the discarded-weight
//      rule against the rows' own total weight, lambda and 1/s;
//   4. uᵀ rows = inv * (selected rows);
//   5. vh = inv * conj(uᵀ) @ W0ᵀ.  Row k of the rotated planes is s_k u_k^T,
//      so the recovery uses the NORMALIZED rows and then inv once more: the
//      standard vh = diag(1/s) u^H m (the comment at fused_pair.py:219-222).
//
// Stopping is per matrix, the semantics of the Pallas kernel's chunk = 1;
// its chunk padding has no counterpart.  Every product is true f32 (plain
// FMA, no tensor cores, so no TF32), as the reference forces
// precision=HIGHEST.
//
// Design: where the working planes live decides the kernel (the "home",
// chosen in Python by ops/fused_pair.fused_plane_home, never by trying a
// launch).
//   * shared (2chi <= 160 on an H100): one block of 256 threads per matrix
//     holds the planes in its shared memory and runs seat_sweeps.cuh;
//   * cluster (176 <= 2chi <= 256, every 28-qubit pair update at chi = 128):
//     a thread-block cluster of P = ceil(2chi / 32) CTAs per matrix
//     (ops/fused_pair.fused_cluster_size: 8 at chi = 128, so 14 clusters
//     fill 112 SMs) holds the planes in its shared memory, two blocks of 16
//     rows per CTA (zero rows pad 2chi to 32 P; three block buffers, 96 KB
//     per CTA at 2chi = 256), and runs block_sweeps.cuh: a block-cyclic
//     sweep whose local phases need only a CTA barrier and whose 2P - 1
//     block rounds end in one cluster barrier each.  The θ tiles and the vh
//     tiles go to the CTAs' tile groups in turn; each CTA computes the norms
//     of the rows it holds (pad rows left out), gathers the others' and runs
//     the same selection and rule; the kept uᵀ rows are written by the CTAs
//     that hold them.  W0 and uᵀ pass between CTAs through device memory,
//     behind __threadfence() and a cluster barrier;
//   * global (2chi > 256): one block of 1024 threads per matrix rotates the
//     planes in a scratch pair in device memory (seat_sweeps.cuh).
// Tile groups are 256 threads; their buffers share the dynamic shared
// memory with the planes, which are not live during steps 1 and 5.
//
// Bounds.  The sweeps dominate: 18 n (n-1) n flop per sweep (n = 2chi,
// 0.3 GFLOP per sweep at chi = 128) on the CUDA cores, against each phase's
// latency: a block barrier and the phase's shared-memory traffic, and on the
// cluster home a cluster barrier and 16 rows sent per CTA every 16 phases.
// Steps 1 and 5 are 32chi^3 + 8chi(2chi)^2 flop per matrix (~134 MFLOP at
// chi = 128).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "block_sweeps.cuh"
#include "rank_truncate.cuh"
#include "seat_sweeps.cuh"
#include "theta_tiles.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kT = 16;                                // vh tile edge and contraction step
constexpr int kClusterQ = aqc::kBlockMaxLanes / 32;  // row entries per lane on the cluster path
constexpr int kHomeShared = 0, kHomeCluster = 1, kHomeGlobal = 2;

struct VhTileBuf {
  float ut[2][kT][kT + 1];  // [re, im][i][e], padded against bank conflicts
  float w0[2][kT][kT + 1];  // [re, im][j][e]
};

union alignas(16) TileBuf {
  aqc::ThetaTileBuf theta;
  VhTileBuf vh;
};

constexpr int kTileBufFloats = static_cast<int>(sizeof(TileBuf) / sizeof(float));

// Shared floats ahead of the planes / tile buffers: the sweeps' statistics
// and the epilogue's arrays, rounded up to 16 bytes.
__host__ __device__ constexpr int head_floats(int stats, int n, int chi) {
  return (stats + aqc::rank_truncate_floats(n, chi) + 3) / 4 * 4;
}

__host__ __device__ constexpr int max_int(int a, int b) { return a > b ? a : b; }

// Threads of one CTA of the cluster path: the loop's 16 pair warps, two
// 256-thread tile groups.
constexpr int kClusterThreads = aqc::kBlockThreads;

// Dynamic shared floats of one block per matrix (shared or global home).
__host__ __device__ constexpr int block_smem_floats(int chi, bool smem_planes, int threads) {
  return head_floats(aqc::seat_stats_floats(2 * chi), 2 * chi, chi) +
         max_int(smem_planes ? 2 * (2 * chi) * (2 * chi) : 0,
                 threads / aqc::kTileThreads * kTileBufFloats);
}

// Dynamic shared floats of one CTA of the cluster path: the loop's
// statistics and the epilogue's arrays, then the larger of the block
// buffers (re and im) and the tile groups' buffers.
__host__ __device__ constexpr int cluster_smem_floats(int chi) {
  return head_floats(aqc::kBlockStatsFloats, 2 * chi, chi) +
         max_int(2 * aqc::block_plane_floats(2 * chi), kClusterThreads / aqc::kTileThreads * kTileBufFloats);
}

// Step 1 for one matrix: its θ tiles, taken in turn by the ``groups`` tile
// groups that work on the matrix; this thread is thread t of group
// ``group``, which owns ``buf`` when ``full`` (a partial group of a block
// whose size is no multiple of 256 only joins the barriers).
__device__ inline void theta_step(const float* gate, const float* a_re, const float* a_im,
                                  const float* b_re, const float* b_im, float* w0r, float* w0i,
                                  int chi, int group, int groups, bool full, int t,
                                  TileBuf* buf) {
  constexpr int kE = aqc::kThetaEdge;
  const int tiles = (chi + kE - 1) / kE;
  for (int first = 0; first < tiles * tiles; first += groups) {
    const int tile = first + group;
    const bool active = full && tile < tiles * tiles;
    const int c0 = active ? (tile / tiles) * kE : 0;
    const int a0 = active ? (tile % tiles) * kE : 0;
    aqc::theta_tile<kE, 2>(gate, a_re, a_im, b_re, b_im, w0r, w0i, chi, c0, a0, active, t,
                           buf->theta);
  }
}

// Step 5 for one matrix: vh = inv * conj(uᵀ) @ W0ᵀ in 16x16 output tiles
// (one position per thread), taken in turn by the tile groups as in
// theta_step.  uᵀ and W0 are read from device memory.
__device__ inline void vh_step(const float* utr, const float* uti, const float* w0r,
                               const float* w0i, const float* inv, float* vhr, float* vhi,
                               int chi, int group, int groups, bool full, int t, TileBuf* buf) {
  const int n = 2 * chi;
  const int tx = t % kT, ty = t / kT;
  const int ti = (chi + kT - 1) / kT, tj = (n + kT - 1) / kT;
  VhTileBuf& vb = buf->vh;
  for (int first = 0; first < ti * tj; first += groups) {
    const int tile = first + group;
    const bool active = full && tile < ti * tj;
    const int i0 = active ? (tile / tj) * kT : 0;
    const int j0 = active ? (tile % tj) * kT : 0;
    float acc_re = 0.f, acc_im = 0.f;
    for (int e0 = 0; e0 < n; e0 += kT) {
      if (full) {
        const int e = e0 + tx;
        const bool u_ok = active && i0 + ty < chi && e < n;
        const bool w_ok = active && j0 + ty < n && e < n;
        const size_t u_at = static_cast<size_t>(i0 + ty) * n + e;
        const size_t w_at = static_cast<size_t>(j0 + ty) * n + e;
        vb.ut[0][ty][tx] = u_ok ? utr[u_at] : 0.f;
        vb.ut[1][ty][tx] = u_ok ? uti[u_at] : 0.f;
        vb.w0[0][ty][tx] = w_ok ? w0r[w_at] : 0.f;
        vb.w0[1][ty][tx] = w_ok ? w0i[w_at] : 0.f;
      }
      __syncthreads();
      if (full) {
#pragma unroll
        for (int q = 0; q < kT; ++q) {
          const float ur = vb.ut[0][ty][q], ui = vb.ut[1][ty][q];
          const float wr = vb.w0[0][tx][q], wi = vb.w0[1][tx][q];
          acc_re += ur * wr + ui * wi;  // conj(u) w
          acc_im += ur * wi - ui * wr;
        }
      }
      __syncthreads();
    }
    const int i = i0 + ty, j = j0 + tx;
    if (active && i < chi && j < n) {
      vhr[static_cast<size_t>(i) * n + j] = acc_re * inv[i];
      vhi[static_cast<size_t>(i) * n + j] = acc_im * inv[i];
    }
  }
}

// One block per matrix.  kSmemPlanes: the working planes live in dynamic
// shared memory (one tile group of 256 threads); otherwise in wk_re/wk_im
// in device memory (four groups, 1024 threads).
template <bool kSmemPlanes>
__global__ void __launch_bounds__(kSmemPlanes ? aqc::kSmemThreads : aqc::kMaxThreads)
fused_pair_kernel(const float* __restrict__ gate, const float* __restrict__ a_re,
                  const float* __restrict__ a_im, const float* __restrict__ b_re,
                  const float* __restrict__ b_im, float* w0_re, float* w0_im, float* wk_re,
                  float* wk_im, float* ut_re, float* ut_im, float* __restrict__ vh_re,
                  float* __restrict__ vh_im, float* __restrict__ lam_out,
                  int* __restrict__ sweeps_out, int chi, int max_sweeps, int hybrid, float thr2) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ int s_go;
  __shared__ float s_gate[32];

  const int n = 2 * chi;
  const size_t nn = static_cast<size_t>(n) * n;
  const int mat = blockIdx.x;
  const int groups = blockDim.x / aqc::kTileThreads;
  const int group = threadIdx.x / aqc::kTileThreads;
  const int t = threadIdx.x % aqc::kTileThreads;
  float* w0r = w0_re + mat * nn;
  float* w0i = w0_im + mat * nn;
  float* stats = smem;
  const aqc::RankScratch rs(stats + aqc::seat_stats_floats(n), n, chi);
  float* region = smem + head_floats(aqc::seat_stats_floats(n), n, chi);
  TileBuf* buf = reinterpret_cast<TileBuf*>(region) + group;
  float* w_re = kSmemPlanes ? region : wk_re + mat * nn;
  float* w_im = kSmemPlanes ? region + nn : wk_im + mat * nn;

  // ---- 1. θ build into the retained W0 ----
  if (threadIdx.x < 32) s_gate[threadIdx.x] = gate[static_cast<size_t>(mat) * 32 + threadIdx.x];
  const size_t in_base = static_cast<size_t>(mat) * 2 * chi * chi;
  theta_step(s_gate, a_re + in_base, a_im + in_base, b_re + in_base, b_im + in_base, w0r, w0i,
             chi, group, groups, true, t, buf);
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
  __syncthreads();  // the tile buffers of step 5 overwrite shared planes

  // ---- 5. vh = inv * conj(uᵀ) @ W0ᵀ ----
  vh_step(utr, uti, w0r, w0i, rs.inv, vh_re + out_base, vh_im + out_base, chi, group, groups,
          true, t, buf);
}

// A cluster of ``cluster`` = block_ctas(2chi) CTAs per matrix (blocks
// mat * cluster ..), the planes in their distributed shared memory (the file
// comment).  kStamp: the instantiation that writes block_sweeps.cuh's clock64
// stamps to ``stamps`` (timing only; the path launches the other).
template <bool kStamp>
__global__ void __launch_bounds__(kClusterThreads, 1)
fused_pair_cluster_kernel(const float* __restrict__ gate, const float* __restrict__ a_re,
                          const float* __restrict__ a_im, const float* __restrict__ b_re,
                          const float* __restrict__ b_im, float* w0_re, float* w0_im,
                          float* ut_re, float* ut_im, float* __restrict__ vh_re,
                          float* __restrict__ vh_im, float* __restrict__ lam_out,
                          int* __restrict__ sweeps_out, int chi, int cluster, int max_sweeps,
                          int hybrid, float thr2, long long* stamps) {
  cg::cluster_group grp = cg::this_cluster();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float s_gate[32];

  const int n = 2 * chi;
  const size_t nn = static_cast<size_t>(n) * n;
  const int me = static_cast<int>(grp.block_rank());
  const int mat = blockIdx.x / cluster;
  const int groups = blockDim.x / aqc::kTileThreads;  // tile groups per CTA
  const int group = threadIdx.x / aqc::kTileThreads;
  const int t = threadIdx.x % aqc::kTileThreads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  float* w0r = w0_re + mat * nn;
  float* w0i = w0_im + mat * nn;
  float* stats = smem;
  const aqc::RankScratch rs(stats + aqc::kBlockStatsFloats, n, chi);
  float* region = smem + head_floats(aqc::kBlockStatsFloats, n, chi);
  TileBuf* buf = reinterpret_cast<TileBuf*>(region) + group;
  float* w_re = region;  // block buffers [3][16][n], re then im
  float* w_im = region + aqc::block_plane_floats(n);
  constexpr int kR = aqc::kBlockRows;

  // ---- 1. θ tiles over the cluster's tile groups, into W0 ----
  if (threadIdx.x < 32) s_gate[threadIdx.x] = gate[static_cast<size_t>(mat) * 32 + threadIdx.x];
  const size_t in_base = static_cast<size_t>(mat) * 2 * chi * chi;
  theta_step(s_gate, a_re + in_base, a_im + in_base, b_re + in_base, b_im + in_base, w0r, w0i,
             chi, me * groups + group, cluster * groups, true, t, buf);
  __threadfence();
  grp.sync();  // W0 complete and visible to the cluster

  // ---- 2. this CTA's two blocks of W0 (zero rows past n); the sweeps ----
  int round = 0;
  const aqc::BlockPair first = aqc::block_pair(me, round, cluster);
  for (int side = 0; side < 2; ++side) {
    const int blk = side ? first.b : first.a;
    const int b = side ? aqc::block_buf_b(me, round) : aqc::block_buf_a(me, round);
    float* dre = aqc::block_row(w_re, b, 0, n);
    float* dim = aqc::block_row(w_im, b, 0, n);
    for (int i = threadIdx.x; i < kR * n; i += blockDim.x) {
      const int row = blk * kR + i / n;
      dre[i] = row < n ? w0r[static_cast<size_t>(row) * n + i % n] : 0.f;
      dim[i] = row < n ? w0i[static_cast<size_t>(row) * n + i % n] : 0.f;
    }
  }
  grp.sync();
  const int k = aqc::block_sweeps<kClusterQ, kStamp>(
      w_re, w_im, stats, n, cluster, max_sweeps, hybrid, round,
      kStamp ? stamps + static_cast<size_t>(mat) * max_sweeps * aqc::kStampsPerSweep : nullptr);

  // ---- 3. the norms of the rows held here (pad rows left out), then of
  //         all rows: every CTA ranks the same numbers and applies the same
  //         rule ----
  const aqc::BlockPair held = aqc::block_pair(me, round, cluster);
  const int buf_a = aqc::block_buf_a(me, round), buf_b = aqc::block_buf_b(me, round);
  for (int side = 0; side < 2; ++side) {
    const int blk = side ? held.b : held.a;
    const int b = side ? buf_b : buf_a;
    aqc::row_norms(aqc::block_row(w_re, b, 0, n), aqc::block_row(w_im, b, 0, n),
                   max(0, min(kR, n - blk * kR)), n, rs.s2 + blk * kR);
  }
  grp.sync();  // also ends the other CTAs' reads of the sweeps' statistics
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    bool as_a;
    const int owner = aqc::block_owner(i / kR, round, cluster, as_a);
    if (owner != me) rs.s2[i] = *grp.map_shared_rank(rs.s2 + i, owner);
  }
  __syncthreads();
  aqc::select_truncate(rs, n, chi, true, 0.f, thr2,
                       me == 0 ? lam_out + static_cast<size_t>(mat) * chi : nullptr, nullptr);
  if (me == 0 && threadIdx.x == 0) sweeps_out[mat] = k;

  // ---- 4. the kept uᵀ rows, each from the CTA that holds it (a warp a row) ----
  const size_t out_base = static_cast<size_t>(mat) * chi * n;
  float* utr = ut_re + out_base;
  float* uti = ut_im + out_base;
  for (int row = warp; row < chi; row += nwarps) {
    const int src = rs.sel[row];
    bool as_a;
    if (aqc::block_owner(src / kR, round, cluster, as_a) != me) continue;
    const float* re = aqc::block_row(w_re, as_a ? buf_a : buf_b, src % kR, n);
    const float* im = aqc::block_row(w_im, as_a ? buf_a : buf_b, src % kR, n);
    const float inv = rs.inv[row];
    for (int e = lane; e < n; e += 32) {
      utr[static_cast<size_t>(row) * n + e] = re[e] * inv;
      uti[static_cast<size_t>(row) * n + e] = im[e] * inv;
    }
  }
  __threadfence();
  grp.sync();  // uᵀ visible to the cluster; no CTA reads another's shared memory after this

  // ---- 5. vh tiles over the cluster's tile groups ----
  vh_step(utr, uti, w0r, w0i, rs.inv, vh_re + out_base, vh_im + out_base, chi,
          me * groups + group, cluster * groups, true, t, buf);
}

cudaLaunchConfig_t cluster_config(int batch, int chi, int cluster, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  return aqc::cluster_launch_config(batch, cluster, kClusterThreads,
                                    sizeof(float) * cluster_smem_floats(chi), stream, attr);
}

// Validates a cluster-path shape and opts the kernel into its shared memory.
template <bool kStamp>
cudaError_t prepare_cluster(int chi, int cluster) {
  const int n = 2 * chi;
  if (!aqc::block_shape_ok(n, n, cluster)) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(fused_pair_cluster_kernel<kStamp>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(sizeof(float) * cluster_smem_floats(chi)));
}

template <bool kStamp>
cudaError_t launch_cluster(const float* gate, const float* a_re, const float* a_im,
                           const float* b_re, const float* b_im, float* w0_re, float* w0_im,
                           float* ut_re, float* ut_im, float* vh_re, float* vh_im, float* lam,
                           int* sweeps, int batch, int chi, int cluster, int max_sweeps, int hybrid,
                           float thr2, long long* stamps, cudaStream_t stream) {
  cudaError_t err = prepare_cluster<kStamp>(chi, cluster);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(batch, chi, cluster, stream, attr);
  err = cudaLaunchKernelEx(&cfg, fused_pair_cluster_kernel<kStamp>, gate, a_re, a_im, b_re, b_im,
                           w0_re, w0_im, ut_re, ut_im, vh_re, vh_im, lam, sweeps, chi, cluster,
                           max_sweeps, hybrid, thr2, stamps);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the fused pair update on ``stream``; returns the CUDA error code
// of the launch (0 on success).  Inputs are contiguous f32: gate (batch,
// 32), a/b planes (batch, 2, chi, chi); scratch w0 (batch, 2chi, 2chi) and,
// for the global home, wk (batch, 2chi, 2chi); outputs uᵀ and vh planes
// (batch, chi, 2chi), lam (batch, chi), sweeps (batch,) int32.  ``home``:
// 0 shared (a block per matrix), 1 cluster (``cluster`` = ceil(2chi / 32)
// CTAs per matrix), 2 global.  ``stamps``: null, or on the cluster home
// (batch, max_sweeps, kStampsPerSweep) int64 that the stamped instantiation
// fills (block_sweeps.cuh).
int fused_pair_launch(const float* gate, const float* a_re, const float* a_im,
                      const float* b_re, const float* b_im, float* w0_re, float* w0_im,
                      float* wk_re, float* wk_im, float* ut_re, float* ut_im, float* vh_re,
                      float* vh_im, float* lam, int* sweeps, int batch, int chi, int max_sweeps,
                      int hybrid, float thr2, int home, int cluster, long long* stamps,
                      void* stream) {
  if (chi < 1 || batch < 1) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (home == kHomeCluster) {
    auto launch = stamps == nullptr ? launch_cluster<false> : launch_cluster<true>;
    return static_cast<int>(launch(gate, a_re, a_im, b_re, b_im, w0_re, w0_im, ut_re, ut_im, vh_re,
                                   vh_im, lam, sweeps, batch, chi, cluster, max_sweeps, hybrid,
                                   thr2, stamps, s));
  }
  if (home != kHomeShared && home != kHomeGlobal) return cudaErrorInvalidValue;
  if (stamps != nullptr) return cudaErrorInvalidValue;
  const bool smem_planes = home == kHomeShared;
  if (!smem_planes && (wk_re == nullptr || wk_im == nullptr)) return cudaErrorInvalidValue;
  const int threads = smem_planes ? aqc::kSmemThreads : aqc::kMaxThreads;
  const size_t smem = sizeof(float) * block_smem_floats(chi, smem_planes, threads);
  auto kernel = smem_planes ? fused_pair_kernel<true> : fused_pair_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<batch, threads, smem, s>>>(gate, a_re, a_im, b_re, b_im, w0_re, w0_im, wk_re, wk_im,
                                      ut_re, ut_im, vh_re, vh_im, lam, sweeps, chi, max_sweeps,
                                      hybrid, thr2);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of the cluster path at ``chi`` the card keeps resident
// at once (cudaOccupancyMaxActiveClusters), or minus the CUDA error code.
int fused_pair_cluster_occupancy(int chi, int cluster) {
  cudaError_t err = prepare_cluster<false>(chi, cluster);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(1, chi, cluster, nullptr, attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, fused_pair_cluster_kernel<false>, &cfg);
  return err != cudaSuccess ? -static_cast<int>(err) : clusters;
}

}  // extern "C"
