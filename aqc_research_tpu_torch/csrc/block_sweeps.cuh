// block_sweeps.cuh — the adaptive one-sided complex Jacobi loop of
// seat_sweeps.cuh on a thread-block cluster, in a block-cyclic order: the
// sweep loop of K4's cluster home (fused_pair.cu, 176 <= 2chi <= 256).
//
// Replaces, for K4, the same Pallas loop as seat_sweeps.cuh
// (aqc_research_tpu/ops/pallas_jacobi.py:_adaptive_seat_sweeps).  The
// rotations are its rotations, formula for formula in f32 (plain FMA), and
// a sweep rotates every pair of rows once; the order of the pairs and the
// stopping statistics differ from its Brent-Luk ring, as below.  The plain
// twin is ops/jacobi_kernel.block_jacobi_rows_reference; cluster_sweeps.cuh
// keeps the ring for K1 and K3.
//
// Why.  The ring on a cluster (cluster_sweeps.cuh) ends every one of the
// 2chi - 1 phases of a sweep with a cluster barrier, and a CTA's own work in
// a phase (16 pairs of 256 lanes at chi = 128) is small beside the barrier,
// its release fence over the rows sent to other CTAs and the chain into it.
// This loop keeps the pairs of a round inside one CTA, so 15 of every 16
// phases need only a CTA barrier.
//
// Schedule.  The rows, padded with zero rows to 2 kBlockRows P on a cluster
// of P CTAs, form 2P blocks of kBlockRows = 16 rows: block b holds rows
// 16b .. 16b + 15, in place, all the way.  A sweep is
//   (a) the intra-block round: every CTA rotates every pair inside each of
//       its two blocks, in seat_sweeps.cuh's round-robin order on 16 rows
//       (seat_l / seat_r, rows in place): 15 local phases of 8 + 8 pairs,
//       a warp a pair;
//   (b) 2P - 1 block rounds of the circle method over the 2P blocks.  In
//       round g (counted across sweeps from the kernel's start) CTA c holds
//       the blocks (A, B) = block_pair(c, g, P) and rotates all 16 x 16
//       cross pairs in 16 local phases: in local phase s, warp i pairs row i
//       of A (L) with row (i + s) mod 16 of B (R).  Those pairs are
//       disjoint, so A's row stays in warp i's registers for the whole round
//       and B's rows are read and written in place in shared memory.
// Each unordered pair of rows meets once a sweep: 15 + (2P - 1) 16 =
// 32P - 1 local phases (255 at 2chi = 256, as the ring's phases).
//
// The circle method keeps block 2P - 1 fixed and turns the others; block_pair
// orients it so that between two rounds every CTA keeps B and sends A, one
// block (32 KB at 2chi = 256), to the CTA that holds it in round g + 1: warp
// i stores its row of A straight from its registers into that CTA's free
// buffer, through distributed shared memory, in the round's last local
// phase.  Then one cluster barrier (arrive.release / wait.acquire).  So a
// sweep has 2P - 1 cluster barriers, the last of which also carries the stop
// decision; every local phase ends in a named barrier over the 16 pair warps.
//
// Buffers.  Three block buffers per CTA, re and im planes of
// [3][kBlockRows][r]; the block received at the exchange after round e lies
// in buffer e mod 3, except in CTA 0 (which always keeps the fixed block,
// in buffer 2, and sends the block it received one round before) in buffer
// e mod 2.  So in round g the sender knows the receiver's free buffer, and
// the buffer it fills was emptied into registers (A) before the previous
// barrier.  On entry (g = 0) A lies in buffer 1 and B in buffer 2.
//
// Stopping, per matrix: the "entry" / "hybrid" rule of seat_sweeps.cuh with
// one s_max per sweep, since a CTA sees only its own rows inside a round:
//   s_max^2 = the largest |w_j|^2 over the rows at the sweep's start (a
//       cluster max: over the rows as loaded for the first sweep, then over
//       the rows each warp ends the previous sweep with);
//   for each pair (L, R) rotated in the sweep, with aa = |L|^2, bb = |R|^2
//       and c = <L, R> before its rotation:
//       gate  = "hybrid" ? max(min(aa, bb), (32 eps)^2 s_max^2) : max(aa, bb),
//       ratio = |c| / sqrt(max(s_max^2 gate, 1e-30));
//   resid = the sweep's largest ratio (each warp keeps a running max; one
//       cluster reduction at the sweep's end);
//   the matrix stops after a sweep with resid < kConvTol, or after
//       max_sweeps sweeps.
//
// Bounds.  A local phase reads and writes one row of B a warp (16 rows of r
// lanes, re and im, per CTA: 32 KB each way at r = 256) and does the pair's
// ~36 r flop; an exchange sends 16 rows of A (32 KB) through distributed
// shared memory.  The planes never touch device memory during the sweeps.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster_sweeps.cuh"
#include "seat_sweeps.cuh"

namespace aqc {

constexpr int kBlockRows = 16;                   // rows of a block: a warp per row of A
constexpr int kBlockThreads = 32 * kBlockRows;   // the pair warps of a CTA
constexpr int kBlockBuffers = 3;                 // block buffers per CTA (see Buffers)
constexpr int kBlockMaxCtas = 8;                 // the portable cluster size
constexpr int kBlockMaxLanes = 256;              // r <= 256: 8 entries per lane
constexpr int kBlockBarrier = 1;                 // the named barrier of the pair warps
constexpr int kBlockStatsFloats = 2 * kBlockRows + 2;  // a residual and a norm a warp, the decision
// clock64 stamps of a sweep in the stamped instantiation: its start, the end
// of the intra-block round, then per round the start of its last local phase
// and the end of its exchange.
constexpr int kStampsPerSweep = 2 + 2 * (2 * kBlockMaxCtas - 1);

// CTAs of a cluster on ``rows`` rows: two blocks each.
__host__ __device__ constexpr int block_ctas(int rows) {
  return (rows + 2 * kBlockRows - 1) / (2 * kBlockRows);
}
// Shared floats of one plane's block buffers (rows of r lanes).
__host__ __device__ constexpr int block_plane_floats(int r) { return kBlockBuffers * kBlockRows * r; }
// Whether the loop takes ``rows`` rows of r lanes on ``ctas`` CTAs.
__host__ __device__ constexpr bool block_shape_ok(int rows, int r, int ctas) {
  return rows >= 2 && r >= 1 && r <= kBlockMaxLanes && ctas >= 1 && ctas <= kBlockMaxCtas &&
         ctas == block_ctas(rows);
}

// A CTA's two blocks in a round: a, sent on at the round's end, and b, kept.
struct BlockPair {
  int a, b;
};

// The blocks CTA ``cta`` of ``ctas`` holds in round ``round``.  The circle
// method over 2 ctas blocks: block 2 ctas - 1 fixed, round r = round mod
// (2 ctas - 1) pairs P_k = {r + k, r - k} (mod 2 ctas - 1) for k = 1 ..
// ctas - 1 and P_0 = {r, fixed}.  CTA c holds P_c in even rounds and
// P_f(c) in odd ones, where the involution f (0 -> 0; odd k -> k + 1, or k
// at k = ctas - 1; even k -> k - 1) maps each round's pairs onto the next
// round's so that each keeps one block: P_k keeps r - k (at k = 0 the fixed
// block) and sends r + k where k is 0 or odd, the other way round where k
// is even.
__host__ __device__ inline BlockPair block_pair(int cta, int round, int ctas) {
  const int circle = 2 * ctas - 1;
  const int h = ctas - 1;
  const int r = round % circle;
  int k = cta;
  if ((round & 1) && k > 0) k = (k & 1) ? (k < h ? k + 1 : k) : k - 1;
  const int plus = (r + k) % circle;
  const int minus = k == 0 ? circle : (r - k + circle) % circle;
  return (k == 0 || (k & 1)) ? BlockPair{plus, minus} : BlockPair{minus, plus};
}

// The buffers of a CTA's blocks in round ``round`` (see Buffers), and the
// one a block sent at the round's end lands in.
__host__ __device__ inline int block_buf_a(int cta, int round) {
  return cta == 0 ? (round + 1) % 2 : (round + 1) % 3;
}
__host__ __device__ inline int block_buf_b(int cta, int round) { return cta == 0 ? 2 : (round + 2) % 3; }
__host__ __device__ inline int block_buf_in(int cta, int round) { return cta == 0 ? round % 2 : round % 3; }

// The CTA that holds ``block`` in round ``round``; ``is_a`` says whether as a.
__host__ __device__ inline int block_owner(int block, int round, int ctas, bool& is_a) {
  for (int c = 0; c < ctas; ++c) {
    const BlockPair bp = block_pair(c, round, ctas);
    if (bp.a == block || bp.b == block) {
      is_a = bp.a == block;
      return c;
    }
  }
  is_a = false;
  return -1;
}

// Row ``i`` of block buffer ``buf`` of one plane.
__device__ __forceinline__ float* block_row(float* w, int buf, int i, int r) {
  return w + static_cast<size_t>(buf * kBlockRows + i) * r;
}

__device__ __forceinline__ void pair_warps_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"r"(kBlockBarrier), "r"(kBlockThreads) : "memory");
}

template <int kQ>
__device__ __forceinline__ void load_row(const float* re, const float* im, int r, int lane, float (&x_r)[kQ],
                                         float (&x_i)[kQ]) {
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int e = lane + 32 * q;
    x_r[q] = e < r ? re[e] : 0.f;
    x_i[q] = e < r ? im[e] : 0.f;
  }
}

template <int kQ>
__device__ __forceinline__ void store_row(float* re, float* im, int r, int lane, const float (&x_r)[kQ],
                                          const float (&x_i)[kQ]) {
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int e = lane + 32 * q;
    if (e < r) {
      re[e] = x_r[q];
      im[e] = x_i[q];
    }
  }
}

template <int kQ>
__device__ __forceinline__ float row_norm2(const float (&x_r)[kQ], const float (&x_i)[kQ]) {
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < kQ; ++q) s += x_r[q] * x_r[q] + x_i[q] * x_i[q];
  return warp_sum(s);
}

// One pair's rotation in a warp (seat_sweeps.cuh's formulas; L = a, R = b,
// rows in registers, lane l holding entries l + 32 q); returns the pair's
// ratio of the stopping rule against s_max^2 = ``smax2``.
template <int kQ>
__device__ __forceinline__ float rotate_pair(float (&a_r)[kQ], float (&a_i)[kQ], float (&b_r)[kQ],
                                             float (&b_i)[kQ], float smax2, int hybrid) {
  float aa = 0.f, bb = 0.f, cre = 0.f, cim = 0.f;
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    aa += a_r[q] * a_r[q] + a_i[q] * a_i[q];
    bb += b_r[q] * b_r[q] + b_i[q] * b_i[q];
    cre += a_r[q] * b_r[q] + a_i[q] * b_i[q];
    cim += a_r[q] * b_i[q] - a_i[q] * b_r[q];
  }
  aa = warp_sum(aa);
  bb = warp_sum(bb);
  cre = warp_sum(cre);
  cim = warp_sum(cim);

  const float abs_c = sqrtf(cre * cre + cim * cim);
  const float norm_ab = sqrtf(fmaxf(aa * bb, 1e-30f));
  if (abs_c > kEps32 * norm_ab) {  // an inactive pair's rotation is the identity
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
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const float l_r = cs * a_r[q] - (sn_re * b_r[q] + sn_im * b_i[q]);
      const float l_i = cs * a_i[q] - (sn_re * b_i[q] - sn_im * b_r[q]);
      b_r[q] = sn_re * a_r[q] - sn_im * a_i[q] + cs * b_r[q];
      b_i[q] = sn_re * a_i[q] + sn_im * a_r[q] + cs * b_i[q];
      a_r[q] = l_r;
      a_i[q] = l_i;
    }
  }
  const float floor2 = (32.f * kEps32) * (32.f * kEps32) * smax2;
  const float gate = hybrid ? fmaxf(fminf(aa, bb), floor2) : fmaxf(aa, bb);
  return abs_c / sqrtf(fmaxf(smax2 * gate, 1e-30f));
}

// Runs the adaptive sweeps on the rows spread over the cluster (the file
// comment): ``w_re``/``w_im`` are this CTA's block_plane_floats(r) shared
// floats each, holding on entry the blocks of block_pair(rank, round, ctas)
// in block_buf_a / block_buf_b; ``stats`` holds kBlockStatsFloats shared
// floats.  Every thread of every CTA calls it with blockDim.x ==
// kBlockThreads, 32 kQ >= r, after the blocks are loaded and a cluster
// barrier.  Returns (in every thread) the number of sweeps run, with
// ``round`` advanced past the rounds run, so that the blocks lie where
// block_pair / block_buf_* say for it.  Other CTAs may still read this
// CTA's ``stats`` then: the caller's next cluster barrier must come before
// any CTA overwrites them or exits.  With kStamp, thread 0 of CTA 0 writes
// kStampsPerSweep clock64 stamps a sweep to ``stamps`` (max_sweeps sweeps).
template <int kQ, bool kStamp>
__device__ inline int block_sweeps(float* w_re, float* w_im, float* stats, int r, int ctas, int max_sweeps,
                                   int hybrid, int& round, long long* stamps) {
  namespace cg = cooperative_groups;
  cg::cluster_group grp = cg::this_cluster();
  const int me = static_cast<int>(grp.block_rank());
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int circle = 2 * ctas - 1;
  float* part = stats;                    // [warp][0: residual, 1: row norm^2]
  float* decision = stats + 2 * kBlockRows;  // [0]: go, [1]: s_max^2
  const bool stamper = kStamp && me == 0 && threadIdx.x == 0;
  long long* stamp_at = stamps;
  auto stamp = [&](int i) {
    if (stamper) stamp_at[i] = clock64();
  };

  // Every CTA reduces the same numbers in the same order: the cluster's
  // largest residual and row norm^2 from all warps' parts.
  auto decide = [&](int k) {
    if (warp == 0) {
      float resid = 0.f, smax2 = 0.f;
      for (int i = lane; i < ctas * kBlockRows; i += 32) {
        const float* p = grp.map_shared_rank(part + 2 * (i % kBlockRows), i / kBlockRows);
        resid = fmaxf(resid, p[0]);
        smax2 = fmaxf(smax2, p[1]);
      }
      resid = warp_max(resid);
      smax2 = warp_max(smax2);
      if (lane == 0) {
        decision[0] = (k < max_sweeps) && (resid >= kConvTol) ? 1.f : 0.f;
        decision[1] = smax2;
      }
    }
    __syncthreads();
  };

  float a_r[kQ], a_i[kQ], b_r[kQ], b_i[kQ];
  if (max_sweeps <= 0) return 0;
  {  // s_max^2 of the first sweep: warp i takes row i of both blocks
    load_row(block_row(w_re, block_buf_a(me, round), warp, r), block_row(w_im, block_buf_a(me, round), warp, r),
             r, lane, a_r, a_i);
    load_row(block_row(w_re, block_buf_b(me, round), warp, r), block_row(w_im, block_buf_b(me, round), warp, r),
             r, lane, b_r, b_i);
    const float n2 = fmaxf(row_norm2(a_r, a_i), row_norm2(b_r, b_i));
    if (lane == 0) {
      part[2 * warp] = 0.f;
      part[2 * warp + 1] = n2;
    }
    cluster_arrive();
    cluster_wait();
    decide(0);
  }

  int k = 0;
  bool go = true;
  while (go) {
    const float smax2 = decision[1];
    float worst = 0.f;  // this warp's largest ratio of the sweep (lane-uniform)
    stamp(0);

    // ---- (a) the intra-block round: warp w rotates pair w % 8 of block w / 8 ----
    {
      const int buf = warp < kBlockRows / 2 ? block_buf_a(me, round) : block_buf_b(me, round);
      const int j = warp % (kBlockRows / 2);
      for (int t = 0; t < kBlockRows - 1; ++t) {
        const int li = seat_l(j, t, kBlockRows / 2), ri = seat_r(j, t, kBlockRows / 2);
        float* lre = block_row(w_re, buf, li, r);
        float* lim = block_row(w_im, buf, li, r);
        float* rre = block_row(w_re, buf, ri, r);
        float* rim = block_row(w_im, buf, ri, r);
        load_row(lre, lim, r, lane, a_r, a_i);
        load_row(rre, rim, r, lane, b_r, b_i);
        worst = fmaxf(worst, rotate_pair(a_r, a_i, b_r, b_i, smax2, hybrid));
        store_row(lre, lim, r, lane, a_r, a_i);
        store_row(rre, rim, r, lane, b_r, b_i);
        pair_warps_sync();
      }
    }
    stamp(1);

    // ---- (b) the block rounds ----
    for (int q = 0; q < circle; ++q, ++round) {
      const BlockPair bp = block_pair(me, round, ctas);
      const int buf_b = block_buf_b(me, round);
      load_row(block_row(w_re, block_buf_a(me, round), warp, r), block_row(w_im, block_buf_a(me, round), warp, r),
               r, lane, a_r, a_i);
      for (int s = 0; s < kBlockRows; ++s) {
        const int j = (warp + s) % kBlockRows;
        float* bre = block_row(w_re, buf_b, j, r);
        float* bim = block_row(w_im, buf_b, j, r);
        if (s == kBlockRows - 1) stamp(2 + 2 * q);
        load_row(bre, bim, r, lane, b_r, b_i);
        worst = fmaxf(worst, rotate_pair(a_r, a_i, b_r, b_i, smax2, hybrid));
        store_row(bre, bim, r, lane, b_r, b_i);
        if (s < kBlockRows - 1) pair_warps_sync();
      }
      // The exchange: A's rows into the free buffer of the CTA that holds A next.
      bool as_a;
      const int dest = block_owner(bp.a, round + 1, ctas, as_a);
      const int buf_in = block_buf_in(dest, round);
      store_row(grp.map_shared_rank(block_row(w_re, buf_in, warp, r), dest),
                grp.map_shared_rank(block_row(w_im, buf_in, warp, r), dest), r, lane, a_r, a_i);
      if (q == circle - 1) {  // the sweep's last round: the parts of the stop decision
        const float n2 = fmaxf(row_norm2(a_r, a_i), row_norm2(b_r, b_i));
        if (lane == 0) {
          part[2 * warp] = worst;
          part[2 * warp + 1] = n2;
        }
      }
      cluster_arrive();
      cluster_wait();
      stamp(3 + 2 * q);
    }
    ++k;
    decide(k);
    go = decision[0] != 0.f;
    if (stamper) stamp_at += kStampsPerSweep;
  }
  return k;
}

}  // namespace aqc
