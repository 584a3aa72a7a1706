// cluster_sweeps.cuh — the adaptive one-sided complex Jacobi loop of
// seat_sweeps.cuh on a thread-block cluster: the (c, r) plane pair of one
// matrix is spread over the shared memory of the cluster's CTAs, seat by
// seat, and rows cross between CTAs through distributed shared memory.
// Written for any (4 <= c <= 256, r <= 256) plane pair; used by
// jacobi_rows.cu (K1), rand_tail.cu (K3) and fused_pair.cu (K4), each at the
// shapes where its Python home rule says "cluster".
//
// Replaces the same Pallas loop as seat_sweeps.cuh
// (aqc_research_tpu/ops/pallas_jacobi.py:_adaptive_seat_sweeps) and keeps
// its algorithm: the Brent-Luk order (the same pairs in every phase), the
// rotation formulas term for term, the Gram sums in the same order
// (lane-strided, then the butterfly), per-matrix stopping under "entry"
// and "hybrid".  So it agrees with seat_sweeps.cuh and with the plain twin
// (ops/jacobi_kernel.jacobi_rows_reference) as before, sweep counts
// included.
//
// Design.  Seats by home CTA: CTA q holds the seats L[j] and R[j] for j in
// [q P, q P + P) (P = ceil(c / 2 / cluster)), and warp w of CTA q rotates
// the pair of seat j = q P + w.  Where seat_sweeps.cuh keeps every row in
// place and moves the seating (the closed-form seat map), this loop moves
// the rows as the plain twin does: after its rotation a warp writes the two
// rows straight into the seats they take in the next phase (L[0] stays,
// R[0] -> L[1], L[j] -> L[j+1], L[p-1] -> R[p-1], R[j] -> R[j-1]), in the
// other of two seat buffers.  So every read is local and only the rows that
// cross a CTA boundary, two per CTA, are written to another CTA's shared
// memory: with the rows at home (the seat map) a phase moved ~64 KB per CTA
// through distributed shared memory each way at 2chi = 256, ~7 us a phase
// on an H100.  A full sweep (2p - 1 phases, odd) brings every row back to
// its first seat, in the other buffer.  A warp holds its two rows in
// registers between the Gram entries and the rotation (lane l: entries
// l + 32 q, q < kQ, kQ = cluster_q(r)): one read and one write per phase.
// One cluster barrier (cluster.sync: arrive.release / wait.acquire) ends
// each phase.  The stopping rule needs each phase's s_max^2 over all c/2
// pairs, so every pair warp publishes (aa, bb, |c|) in its CTA's shared
// memory (a ring of four phases, indexed by a phase count that runs across
// sweeps) and one more warp per CTA, the stats warp, reduces all of them
// across the cluster one phase late, as the single-block loop's warp 0
// does.  It arrives at a phase's barrier (barrier.cluster.arrive) before it
// reduces and waits after, so its remote reads stay off the phases'
// critical path; the ring keeps a phase's statistics until three phases
// later.  Every CTA's stats warp reduces the same numbers in the same
// order, so every CTA takes the same stop decision without a broadcast.
//
// Bounds.  A phase is local shared-memory traffic (4 r floats read and
// written per pair), two remote rows per CTA, the stats warp's remote reads
// and a cluster barrier; the rotations' f32 work is ~36 r flop per pair.
// The planes never touch device memory during the sweeps.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "seat_sweeps.cuh"

namespace aqc {

constexpr int kClusterMaxRows = 256;     // c <= 256: at most 4 pairs per lane of the stats warp
constexpr int kClusterMaxLanes = 256;    // r <= 256: at most 8 entries per lane (cluster_q)
constexpr int kClusterMaxThreads = 544;  // 16 pair warps and the stats warp
constexpr int kClusterMaxCtas = 8;       // the portable cluster size
constexpr int kStatsRing = 4;            // phases of statistics kept (see the stats warp)

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Seats of each side per CTA, threads of a CTA (a warp per pair and the
// stats warp: a caller that needs more threads, as K4's tile groups do,
// launches more, and the extra warps only join the barriers), the
// statistics' shared floats and the seat buffers' shared floats (two
// buffers of both sides, re and im) for a cluster of ``cluster`` CTAs on c
// rows of r lanes.
__host__ __device__ constexpr int cluster_pairs_per_cta(int c, int cluster) {
  return (c / 2 + cluster - 1) / cluster;
}
__host__ __device__ constexpr int cluster_threads(int c, int cluster) {
  return 32 * (cluster_pairs_per_cta(c, cluster) + 1);
}
__host__ __device__ constexpr int cluster_stats_floats(int c, int cluster) {
  return kStatsRing * 3 * cluster_pairs_per_cta(c, cluster);
}
__host__ __device__ constexpr int cluster_seat_floats(int c, int r, int cluster) {
  return 2 * 2 * 2 * cluster_pairs_per_cta(c, cluster) * r;
}
// Shared floats of one CTA of a kernel that holds only the statistics,
// ``extra`` floats of its own and the seat buffers, in that order (the
// head rounded up to 16 bytes): K1 and K3.
__host__ __device__ constexpr int cluster_head_floats(int c, int cluster, int extra) {
  return (cluster_stats_floats(c, cluster) + extra + 3) / 4 * 4;
}
__host__ __device__ constexpr int cluster_cta_floats(int c, int r, int cluster, int extra) {
  return cluster_head_floats(c, cluster, extra) + cluster_seat_floats(c, r, cluster);
}
// Row entries per lane of the loop's template (kQ): the smallest of 1, 2,
// 4, 8 with 32 kQ >= r, or 0 past kClusterMaxLanes.
__host__ __device__ constexpr int cluster_q(int r) {
  return r <= 32 ? 1 : r <= 64 ? 2 : r <= 128 ? 4 : r <= kClusterMaxLanes ? 8 : 0;
}
// Whether the loop takes a (c, r) plane pair on ``cluster`` CTAs: even
// 4 <= c <= kClusterMaxRows, a known kQ, 1 to kClusterMaxCtas CTAs of at
// most kClusterMaxThreads threads.
__host__ __device__ constexpr bool cluster_shape_ok(int c, int r, int cluster) {
  return c >= 4 && c % 2 == 0 && c <= kClusterMaxRows && r >= 1 && cluster_q(r) > 0 &&
         cluster >= 1 && cluster <= kClusterMaxCtas &&
         cluster_threads(c, cluster) <= kClusterMaxThreads;
}

// The launch configuration of ``batch`` matrices on clusters of ``cluster``
// CTAs of ``threads`` threads and ``smem`` bytes of dynamic shared memory
// each, for cudaLaunchKernelEx; ``attr`` receives the cluster-dimension
// attribute and must outlive the launch.
inline cudaLaunchConfig_t cluster_launch_config(int batch, int cluster, int threads, size_t smem,
                                                cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The seat slot of one CTA's buffers: plane ``w`` (re or im, each
// [buffer][side][P][r]), buffer b, side 0 (L) or 1 (R), local seat ``slot``.
__device__ __forceinline__ float* seat_slot(float* w, int b, int side, int slot, int pairs_per,
                                            int r) {
  return w + static_cast<size_t>((b * 2 + side) * pairs_per + slot) * r;
}

// Runs the adaptive sweeps on the (c, r) planes spread over the cluster by
// seat: ``w_re``/``w_im`` are this CTA's cluster_seat_floats / 2 floats
// each, with row j (j < c/2) in seat L[j] and row c/2 + j in seat R[j] of
// buffer ``cur`` on entry; ``stats`` holds cluster_stats_floats(c, cluster)
// shared floats and ``go_flag`` one shared int.  Every thread of every CTA
// of the cluster calls it after the seats are loaded and a cluster barrier,
// with blockDim.x >= cluster_threads(c, cluster) and 32 kQ >= r.  It
// returns (in every thread) the number of sweeps run, with every row back
// in its first seat, in buffer ``cur`` (which it updates), after the last
// phase's cluster barrier.  The stats warps may still read other CTAs'
// ``stats`` then: the caller's next cluster barrier must come before any
// CTA overwrites its ``stats`` or exits.
template <int kQ>
__device__ inline int cluster_seat_sweeps(float* w_re, float* w_im, float* stats, int* go_flag,
                                          int c, int r, int cluster, int max_sweeps, int hybrid,
                                          int& cur) {
  namespace cg = cooperative_groups;
  cg::cluster_group grp = cg::this_cluster();
  const int me = static_cast<int>(grp.block_rank());
  const int pairs_per = cluster_pairs_per_cta(c, cluster);
  const int p = c / 2;
  const int phases = 2 * p - 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j = me * pairs_per + warp;  // this warp's seat pair
  const bool pair_warp = warp < pairs_per && j < p;
  const bool stats_warp = warp == pairs_per;
  // Where this warp's rotated rows sit in the next phase: (side, seat).
  const int l_side = j == p - 1 ? 1 : 0;
  const int l_seat = j == 0 ? 0 : (j == p - 1 ? p - 1 : j + 1);
  const int r_seat = j == 0 ? 1 : j - 1;  // R[0] -> L[1], R[j] -> R[j-1]
  const int r_side = j == 0 ? 0 : 1;

  // A seat of buffer b in the CTA that holds it (this CTA: a plain shared
  // address).
  auto seat_at = [&](float* w, int b, int side, int seat) {
    float* local = seat_slot(w, b, side, seat % pairs_per, pairs_per, r);
    const int owner = seat / pairs_per;
    return owner == me ? local : grp.map_shared_rank(local, owner);
  };

  // stats[(slot_of_phase * 3 + q) * pairs_per + slot], q = 0: aa, 1: bb,
  // 2: |c|; a phase's statistics sit in ring slot phase_count % kStatsRing.
  auto phase_residual = [&](int ring) {
    float sa[4], sb[4], sc[4];
    float smax2 = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int jj = lane + 32 * i;
      sa[i] = sb[i] = sc[i] = 0.f;
      if (jj < p) {
        const float* st = grp.map_shared_rank(stats + ring * 3 * pairs_per + jj % pairs_per,
                                              jj / pairs_per);
        sa[i] = st[0];
        sb[i] = st[pairs_per];
        sc[i] = st[2 * pairs_per];
        smax2 = fmaxf(smax2, fmaxf(sa[i], sb[i]));
      }
    }
    smax2 = warp_max(smax2);
    const float floor2 = (32.f * kEps32) * (32.f * kEps32) * smax2;
    float worst = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (lane + 32 * i < p) {
        const float gate = hybrid ? fmaxf(fminf(sa[i], sb[i]), floor2) : fmaxf(sa[i], sb[i]);
        worst = fmaxf(worst, sc[i] / sqrtf(fmaxf(smax2 * gate, 1e-30f)));
      }
    }
    return warp_max(worst);
  };

  int k = 0;
  int phase_count = 0;  // across sweeps: picks the statistics ring slot
  bool go = max_sweeps > 0;
  while (go) {
    float resid = 0.f;  // meaningful in the stats warp only
    for (int t = 0; t < phases; ++t, ++phase_count) {
      const int ring = phase_count % kStatsRing;
      if (pair_warp) {
        const float* lre = seat_slot(w_re, cur, 0, warp, pairs_per, r);
        const float* lim = seat_slot(w_im, cur, 0, warp, pairs_per, r);
        const float* rre = seat_slot(w_re, cur, 1, warp, pairs_per, r);
        const float* rim = seat_slot(w_im, cur, 1, warp, pairs_per, r);
        float a_r[kQ], a_i[kQ], b_r[kQ], b_i[kQ];
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const int e = lane + 32 * q;
          const bool ok = e < r;
          a_r[q] = ok ? lre[e] : 0.f;
          a_i[q] = ok ? lim[e] : 0.f;
          b_r[q] = ok ? rre[e] : 0.f;
          b_i[q] = ok ? rim[e] : 0.f;
        }
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
        const bool active = abs_c > kEps32 * norm_ab;
        if (lane == 0) {
          float* st = stats + ring * 3 * pairs_per + warp;
          st[0] = aa;
          st[pairs_per] = bb;
          st[2 * pairs_per] = abs_c;
        }
        if (active) {  // an inactive pair's rotation is the identity
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
        // Both rows into their next seats, in the other buffer.
        float* nl_re = seat_at(w_re, cur ^ 1, l_side, l_seat);
        float* nl_im = seat_at(w_im, cur ^ 1, l_side, l_seat);
        float* nr_re = seat_at(w_re, cur ^ 1, r_side, r_seat);
        float* nr_im = seat_at(w_im, cur ^ 1, r_side, r_seat);
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const int e = lane + 32 * q;
          if (e < r) {
            nl_re[e] = a_r[q];
            nl_im[e] = a_i[q];
            nr_re[e] = b_r[q];
            nr_im[e] = b_i[q];
          }
        }
      }
      cur ^= 1;
      if (stats_warp) {
        // Arrive first, so the barrier waits for the pair warps only, then
        // reduce phase t - 1 (its slot is rewritten in phase t + 3, which no
        // CTA starts before this warp arrives at the barrier of phase t + 2).
        cluster_arrive();
        if (t > 0) resid = fmaxf(resid, phase_residual((phase_count - 1) % kStatsRing));
        cluster_wait();
      } else {
        grp.sync();
      }
    }
    ++k;
    if (stats_warp) {
      // the sweep's last phase
      resid = fmaxf(resid, phase_residual((phase_count - 1) % kStatsRing));
      if (lane == 0) *go_flag = (k < max_sweeps) && (resid >= kConvTol);
    }
    __syncthreads();
    go = *go_flag;
  }
  return k;
}

}  // namespace aqc
