// householder_qr.cu — the reduced Householder QR of a batch of complex64
// matrices, Q only, for sm_90a: LAPACK's cgeqrf + cungqr in one launch, in
// f32 arithmetic on the CUDA cores.
//
// Replaces no TPU kernel: the JAX package leaves the rand range-finder's
// QR to XLA (jnp.linalg.qr in aqc_research_tpu/ops/rand_svd.py:_orth).  It
// was added because cuSOLVER factors the range-finder's matrices one after
// another (torch.linalg.qr in chunks that stay off cuBLAS's batched geqrf,
// which returns NaN on the zero-padded pair samples): on an H100 at 28
// qubits chi = 128 that took 338 ms of a 505 ms L-BFGS iteration, about
// 640 factorizations of (256, 136), some 0.5 ms each on a few SMs.
//
// What it computes, per matrix Y (n, l), l <= n <= 256: the reflectors of
// cgeqr2 (clarfg's convention: beta = -sign(Re alpha) * norm, real, so Q
// agrees with LAPACK's and cuSOLVER's column for column), then Q = H_0 ...
// H_{l-1} I[:, :l] as cungqr forms it, applying the reflectors kept on chip
// backwards.  Only Q is written to device memory.  Column norms are scaled:
// every CTA scales the column by the power of two that brings its largest
// entry into [1, 2) before the dot products, so columns far below f32's
// normal range (the zero-padded samples reach 1e-23) keep their norm and
// the products stay normal; a column whose largest entry lies below
// 2^-100 gets tau = 0 (H = I), as one whose norm is zero does in LAPACK.
// So Q is finite and orthonormal on rank-deficient samples too.
//
// Bounds.  A (256, 136) matrix is ~62 MFLOP of f32 work (geqr2 and ung2r):
// ~1 us at 67 TFLOP/s over the card, ~0.12 ms on one SM; a half-layer's 14
// such matrices are bound at 0.0130 ms.  Column by column the work is 2 l
// dependent steps, each a reduction over the rows and a rank-one update, so
// a QR that synchronizes its CTAs at every step is bound by the latency of
// a step (the first design: one cluster barrier a step, 272 at (256, 136),
// 0.63 ms on an H100), not by flops or bytes.  One matrix lives in a
// cluster of 1, 2 or 4 CTAs (ops/householder_qr.qr_plan: 4 for a
// half-layer's 13-14 matrices, so each CTA holds at most 64 rows; the
// fewest that hold the rows when the batch's clusters of 4 would not fit
// the card at once), rows dealt out cyclically (row g to CTA g % cluster),
// each CTA holding its rows of every column in shared memory, column-major.
//
// geqrf_ungqr_blocked_kernel<kS, kC, kNB>: LAPACK's blocked cgeqrf (cgeqr2
// on a panel of kNB = 16 or 8 columns, clarft, clarfb) and cungqr backwards
// over the same panels; l below a panel is one ragged panel.  Per panel of
// geqrf:
//   * gather: every CTA writes its rows of the panel's columns, 16 bytes a
//     store, into its segment of a full panel in the shared memory of every
//     CTA of the cluster; one cluster barrier (from the second panel on, the
//     barrier runs while the rest of the previous panel's trailing update
//     does: the panel's own columns are updated first);
//   * every CTA factors the whole panel itself, with __syncthreads only:
//     warp k holds column k at every row and reduces it (clarfg's beta; the
//     norm of the column scaled by a power of two, the largest entry and
//     the norm in one reduction; tau = 0 below 2^-100) while warp k + 1,
//     handed column k by a named barrier, takes its dot with it in the
//     reflector's units, so that after step k's barrier only scalar work
//     stands between v_k and column k + 1's reduction; the warps after k + 1
//     apply H_k^H to their columns, the warps before k take their entry of
//     V^H V, and warp 0 forms T (clarft, forward, columnwise) a column a
//     step.  Every CTA reads the same panel and runs the same code, so every
//     CTA derives the same v, tau and T bit for bit without a broadcast;
//   * V copied into the CTA's rows of the panel's columns, T kept for ungqr;
//   * the trailing columns get H^H = I - V T^H V^H: each CTA takes W =
//     V^H A over its rows into its own shared memory (items of four columns
//     by four of V's); one cluster barrier; every CTA reads the cluster's
//     partial W through distributed shared memory (16 bytes a load), sums
//     them in CTA order, applies T^H, and updates its rows A -= V (T^H W)
//     (items of four columns by 16 rows).
// ungqr starts from Q = I[:, :l] (in place: a panel's columns still hold V
// when the panel comes, and are read as the identity) and applies
// I - V T V^H to Q[:, j0:] for each panel from the last, panel columns
// included: one partial-W exchange and one cluster barrier a panel (two
// partial-W buffers by the panel's parity, the second in the panel's room).
// At (256, 136) and kNB = 16: 9 panels, 26 cluster barriers (9 + 8 in
// geqrf, 9 in ungqr) in place of 272, and 136 CTA-local column steps.  On
// an H100 SXM (700 W), (14, 256, 136) on 4 CTAs a matrix takes 0.36 ms
// (27x the bound): ~43% in the column steps (~2.2k cycles each: the
// reductions' latency and the other warps' updates), the rest in the
// block phases, whose cost is mostly fixed (a cluster barrier ~1.3k cycles,
// the shared-memory passes' latency) and did not fall with 8 CTAs a matrix.
// No atomics: two launches on the same input give the same bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxRows = 256;    // n
constexpr int kMaxCtaRows = 128;  // rows one CTA holds: 8 slots of 16
constexpr int kMaxCluster = 4;    // CTAs of a cluster: 1, 2 or 4
constexpr int kNone = 1 << 20;    // scale exponent of a lane whose entries are all zero

// log2 of a cluster size (1, 2 or 4).
__host__ __device__ constexpr int cluster_shift(int c) { return c == 1 ? 0 : c == 2 ? 1 : 2; }

// Slots of 16 rows a CTA holds (1, 2, 4 or 8), 0 past kMaxCtaRows.
__host__ __device__ constexpr int qr_slots(int rows) {
  return rows <= 16 ? 1 : rows <= 32 ? 2 : rows <= 64 ? 4 : rows <= kMaxCtaRows ? 8 : 0;
}
__host__ __device__ constexpr int cta_rows(int n, int cluster) { return (n + cluster - 1) / cluster; }
// Column stride in complex entries: 16 B of padding keeps the load and store
// of whole rows (consecutive columns) off one bank.
__host__ __device__ constexpr int qr_ld(int slots) { return 16 * slots + 2; }

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
// acc += conj(a) b
__device__ __forceinline__ void cdot_acc(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, fmaf(a.y, b.y, acc.x));
  acc.y = fmaf(a.x, b.y, fmaf(-a.y, b.x, acc.y));
}
// e -= v t
__device__ __forceinline__ void csub_mul(float2& e, float2 v, float2 t) {
  e.x = fmaf(-v.x, t.x, fmaf(v.y, t.y, e.x));
  e.y = fmaf(-v.x, t.y, fmaf(-v.y, t.x, e.y));
}
// 2^k for k <= 127; 0 below f32's normal range, where the terms it scales
// fall below the resolution of the sums they join.
__device__ __forceinline__ float pow2(int k) {
  return k < -126 ? 0.f : __int_as_float((k + 127) << 23);
}

// Writes ``v`` at ``local`` in the shared memory of every CTA of the cluster.
template <int kC, typename T>
__device__ __forceinline__ void publish(cg::cluster_group& grp, T* local, T v) {
  if constexpr (kC == 1) {
    *local = v;
  } else {
#pragma unroll
    for (int c = 0; c < kC; ++c) *grp.map_shared_rank(local, c) = v;
  }
}

// The two halves of a cluster barrier: between them a CTA may work on what
// no other CTA reads or writes.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

constexpr int kMaxPanel = 16;  // panel width kNB: 16 or 8

// Rows of a panel column one lane holds (warp k holds column k at rows
// lane + 32 s), for a cluster holding ``rows`` rows.
__host__ __device__ constexpr int panel_lane_rows(int rows) { return (rows + 31) / 32; }
// A panel column holds the rows of each CTA together (so that a CTA's rows
// go out as whole 16-byte stores), one segment a CTA: its 16 slots rows
// padded so that a warp's rows lane + 32 s fall on distinct banks.
__host__ __device__ constexpr int panel_seg(int slots, int cluster) {
  return 16 * slots + (cluster > 1 ? 16 / cluster : 0);
}
// Row stride of the W buffers: l rounded up to even, for 16-byte loads.
__host__ __device__ constexpr int w_ld(int l) { return l + (l & 1); }
// Dynamic shared memory of one CTA of the blocked kernel: its rows of every
// column, T of every panel, the block coefficients (in the panel's
// factorization: the column handed to the next warp), partial-W buffer 0,
// the panel (geqrf; partial-W buffer 1 in ungqr), V^H V, tau and
// 1 / (alpha - beta) of the panel being factored.
__host__ __device__ constexpr size_t blocked_smem_bytes(int n, int l, int cluster, int nb) {
  const int slots = qr_slots(cta_rows(n, cluster));
  const size_t pld = static_cast<size_t>(cluster) * panel_seg(slots, cluster);  // a panel column
  const size_t wbuf = static_cast<size_t>(nb) * w_ld(l);                        // a W buffer
  const size_t panels = (l + nb - 1) / nb;
  return sizeof(float2) * (static_cast<size_t>(qr_ld(slots)) * l + panels * nb * nb + (pld > wbuf ? pld : wbuf) +
                           wbuf + (nb * pld > wbuf ? nb * pld : wbuf) + nb * nb + 2 * nb);
}

// acc += t w
__device__ __forceinline__ void cmul_acc(float2& acc, float2 t, float2 w) {
  acc.x = fmaf(t.x, w.x, fmaf(-t.y, w.y, acc.x));
  acc.y = fmaf(t.x, w.y, fmaf(t.y, w.x, acc.y));
}
// Sum over the 32 lanes of a warp, the same bits in every lane.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 1; m < 32; m <<= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// One level of a sum over the row lanes that scatters the result: the lane
// with its ``bit`` set keeps entries kH .. 2 kH - 1, the other 0 .. kH - 1,
// each plus its partner's (lane ^ bit) same entry, into acc[0 .. kH).
template <int kH>
__device__ __forceinline__ void fold_rows(float2* acc, bool upper, int bit) {
#pragma unroll
  for (int i = 0; i < kH; ++i) {
    const float2 keep = upper ? acc[i + kH] : acc[i], send = upper ? acc[i] : acc[i + kH];
    acc[i].x = keep.x + __shfl_xor_sync(0xffffffffu, send.x, bit);
    acc[i].y = keep.y + __shfl_xor_sync(0xffffffffu, send.y, bit);
  }
}
// The partial W = V^H A of this CTA's rows into wb[i][k], for columns c0 ..
// l - 1.  An item is four columns (one a row group of eight lanes) by four
// of V's columns, so the warps share a phase evenly; the eight row lanes'
// sums meet by shuffles.
template <int kS, int kC, int kNB>
__device__ __forceinline__ void partial_w(const float2* a, float2* wb, int c0, int l, int ldw, int j0, int nbp,
                                          int warp, int lane) {
  constexpr int kLd = qr_ld(kS);
  constexpr int cs = cluster_shift(kC);
  constexpr int kQ = kNB / 4;
  const int rl = lane & 7, cl = lane >> 3;
  const int p0 = j0 >> (4 + cs);
  const int items = (l - c0 + 3) / 4 * kQ;
  for (int item = warp; item < items; item += kWarps) {
    const int grp = item / kQ, i0 = 4 * (item - grp * kQ);
    const int k = c0 + 4 * grp + cl;
    const bool valid = k < l;
    float2 acc[4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) acc[ii] = make_float2(0.f, 0.f);
    if (valid && i0 < nbp) {
#pragma unroll
      for (int p = 0; p < kS; ++p) {
        if (p < p0) continue;
        const float4 e4 = *reinterpret_cast<const float4*>(a + k * kLd + 16 * p + 2 * rl);
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          if (i0 + ii >= nbp) continue;
          const float4 v4 = *reinterpret_cast<const float4*>(a + (j0 + i0 + ii) * kLd + 16 * p + 2 * rl);
          cdot_acc(acc[ii], make_float2(v4.x, v4.y), make_float2(e4.x, e4.y));
          cdot_acc(acc[ii], make_float2(v4.z, v4.w), make_float2(e4.z, e4.w));
        }
      }
    }
    // Lanes rl, rl ^ 1 end with entry 2 (rl >> 2 & 1) + (rl >> 1 & 1).
    fold_rows<2>(acc, rl & 4, 4);
    fold_rows<1>(acc, rl & 2, 2);
    acc[0].x += __shfl_xor_sync(0xffffffffu, acc[0].x, 1);
    acc[0].y += __shfl_xor_sync(0xffffffffu, acc[0].y, 1);
    const int i = i0 + 2 * ((rl >> 2) & 1) + ((rl >> 1) & 1);
    if (valid && (rl & 1) == 0 && i < nbp) wb[i * ldw + k] = acc[0];
  }
}

// The block coefficients of columns c0 .. l - 1 into wq[i][k]: W = the
// cluster's partial W summed in CTA order (entries i < nbp; 0 past them),
// then T W (kUpper: ungqr) or T^H W (geqrf) in place, each column's two
// halves by two threads once both have read the column.
template <int kNB, int kC, bool kUpper>
__device__ __forceinline__ void block_coeffs(cg::cluster_group& grp, float2* wb, const float2* tp, float2* wq,
                                             int c0, int l, int ldw, int nbp, int me) {
  const int cols = l - c0, pairs = (cols + 1) >> 1;  // c0 is even: pairs of columns are 16-byte aligned
  const float2* parts[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) parts[c] = c == me ? wb : grp.map_shared_rank(wb, c);
  // Two pairs a thread at a time, so that their loads are in flight together.
  for (int base = threadIdx.x; base < kNB * pairs; base += 2 * kThreads) {
    float4 pc[2][kC];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int idx = base + u * kThreads, i = idx / pairs, k = c0 + 2 * (idx - i * pairs);
#pragma unroll
      for (int c = 0; c < kC; ++c)
        pc[u][c] = idx < kNB * pairs && i < nbp ? *reinterpret_cast<const float4*>(parts[c] + i * ldw + k)
                                                : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int idx = base + u * kThreads, i = idx / pairs, k = c0 + 2 * (idx - i * pairs);
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        s.x += pc[u][c].x;
        s.y += pc[u][c].y;
        s.z += pc[u][c].z;
        s.w += pc[u][c].w;
      }
      if (idx < kNB * pairs) *reinterpret_cast<float4*>(wq + i * ldw + k) = s;
    }
  }
  __syncthreads();
  const bool mine = static_cast<int>(threadIdx.x) < 2 * cols;
  const int k = c0 + (threadIdx.x >> 1), i0 = (kNB / 2) * (threadIdx.x & 1);
  float2 w[kNB];
#pragma unroll
  for (int m = 0; m < kNB; ++m) w[m] = mine ? wq[m * ldw + k] : make_float2(0.f, 0.f);
  __syncthreads();
  if (mine) {
#pragma unroll
    for (int ii = 0; ii < kNB / 2; ++ii) {
      const int i = i0 + ii;
      float2 s = make_float2(0.f, 0.f);
#pragma unroll
      for (int m = 0; m < kNB; ++m) {
        if (kUpper ? m >= i : m <= i) {
          const float2 t = kUpper ? tp[i * kNB + m] : tp[m * kNB + i];
          cmul_acc(s, kUpper ? t : make_float2(t.x, -t.y), w[m]);
        }
      }
      wq[i * ldw + k] = s;
    }
  }
}

// A -= V wq at this CTA's rows at and below the panel, for columns c0 ..
// c1 - 1 (kIdentity: the panel's own columns, read as e_k, are written only
// after the barrier that follows, once every warp has read V from them).
// An item is four columns by one slot of 16 rows.  The panel's items come
// first, at most two a warp.
template <int kS, int kC, int kNB, bool kIdentity>
__device__ __forceinline__ void block_update(float2* a, const float2* wq, int c0, int c1, int ldw, int j0, int nbp,
                                             int me, int warp, int lane) {
  constexpr int kLd = qr_ld(kS);
  constexpr int cs = cluster_shift(kC);
  const int rl = lane & 7, cl = lane >> 3;
  const int p0 = j0 >> (4 + cs), jn = j0 + nbp;
  const int slots = kS - p0, items = (c1 - c0 + 3) / 4 * slots;
  float4 held[2];
  int held_at[2] = {-1, -1};
  for (int item = warp; item < items; item += kWarps) {
    const int grp = item / slots, p = p0 + item - grp * slots;
    const int k = c0 + 4 * grp + cl;
    if (k >= c1) continue;
    float2 e[2];
    const bool panel = kIdentity && k < jn;
    if (panel) {
      const int g = (16 * p + 2 * rl) * kC + me;
      e[0] = make_float2(g == k ? 1.f : 0.f, 0.f);
      e[1] = make_float2(g + kC == k ? 1.f : 0.f, 0.f);
    } else {
      const float4 e4 = *reinterpret_cast<const float4*>(a + k * kLd + 16 * p + 2 * rl);
      e[0] = make_float2(e4.x, e4.y);
      e[1] = make_float2(e4.z, e4.w);
    }
#pragma unroll
    for (int i = 0; i < kNB; ++i) {
      if (i >= nbp) continue;
      const float2 w = wq[i * ldw + k];
      const float4 v4 = *reinterpret_cast<const float4*>(a + (j0 + i) * kLd + 16 * p + 2 * rl);
      csub_mul(e[0], make_float2(v4.x, v4.y), w);
      csub_mul(e[1], make_float2(v4.z, v4.w), w);
    }
    const float4 out = make_float4(e[0].x, e[0].y, e[1].x, e[1].y);
    if (panel) {
      if (item == warp) {
        held[0] = out;
        held_at[0] = k * kLd + 16 * p + 2 * rl;
      } else {
        held[1] = out;
        held_at[1] = k * kLd + 16 * p + 2 * rl;
      }
    } else {
      *reinterpret_cast<float4*>(a + k * kLd + 16 * p + 2 * rl) = out;
    }
  }
  if constexpr (kIdentity) {
    __syncthreads();
    if (held_at[0] >= 0) *reinterpret_cast<float4*>(a + held_at[0]) = held[0];
    if (held_at[1] >= 0) *reinterpret_cast<float4*>(a + held_at[1]) = held[1];
  }
}

// Where global row g lies in a panel column (panel_seg).
template <int kC, int kSeg>
__device__ __forceinline__ int panel_pos(int g) {
  constexpr int cs = cluster_shift(kC);
  return (g & (kC - 1)) * kSeg + (g >> cs);
}

// clarfg on the column a warp holds (x at rows lane + 32 s), for the
// reflector of row j: scales the column by the power of two that brings its
// largest entry at rows >= j into [1, 2), takes beta and tau (0 when that
// entry lies below 2^-100 or nothing is left to reflect), and leaves the
// explicit v in x (0 above row j, 1 at it) and in the panel column ``col``
// (panel_pos); tau to ``tau`` and 1 / (alpha - beta) (scaled) to ``inv_out``.
// The largest entry and the norm meet in one reduction: each lane scales
// its rows by its own power of two, and a pair of lanes keeps the smaller
// exponent and rescales the other's sum of squares by powers of two (exact
// short of underflow), so the norm is the one taken after scaling the
// whole column.
template <int kPR, int kS, int kC>
__device__ __forceinline__ void householder_column(float2 (&x)[kPR], int j, int lane, float2* col, float2* tau,
                                                   float2* inv_out) {
  constexpr int kSeg = panel_seg(kS, kC), kRows = 16 * kS * kC;
  float mx = 0.f;
  float2 al = make_float2(0.f, 0.f);
#pragma unroll
  for (int s = 0; s < kPR; ++s) {
    const int g = lane + 32 * s;
    if (g >= j) mx = fmaxf(mx, fmaxf(fabsf(x[s].x), fabsf(x[s].y)));
    if (g == j) al = x[s];
  }
  al.x = __shfl_sync(0xffffffffu, al.x, j & 31);
  al.y = __shfl_sync(0xffffffffu, al.y, j & 31);
  int e = mx > 0.f ? max(-126, 127 - (__float_as_int(mx) >> 23)) : kNone;
  float nn = 0.f, nn1 = 0.f;
  {
    const float sl = e == kNone ? 0.f : pow2(e);
#pragma unroll
    for (int s = 0; s < kPR; ++s) {
      if (lane + 32 * s > j) {
        const float xr = x[s].x * sl, xi = x[s].y * sl;
        if (s & 1) nn1 = fmaf(xr, xr, fmaf(xi, xi, nn1));
        else nn = fmaf(xr, xr, fmaf(xi, xi, nn));
      }
    }
  }
  nn += nn1;
#pragma unroll
  for (int m = 1; m < 32; m <<= 1) {
    const int eo = __shfl_xor_sync(0xffffffffu, e, m);
    const float no = __shfl_xor_sync(0xffffffffu, nn, m);
    const int em = min(e, eo);
    // Both lanes of a pair add the same two products (no contraction): the same bits.
    nn = __fadd_rn(__fmul_rn(nn, pow2(2 * (em - e))), __fmul_rn(no, pow2(2 * (em - eo))));
    e = em;
  }
  // e <= 100: the largest entry lies at or above 2^-100.
  const bool live = e <= 100;
  const float sc = live ? pow2(e) : 0.f, xn2 = nn;
  const float ar = al.x * sc, ai = al.y * sc;
  float2 t = make_float2(0.f, 0.f), inv = make_float2(0.f, 0.f);
  if (live && (xn2 != 0.f || ai != 0.f)) {
    const float r = sqrtf(fmaf(ar, ar, fmaf(ai, ai, xn2)));
    const float beta = ar >= 0.f ? -r : r;
    const float rb = __frcp_rn(beta);
    t = make_float2((beta - ar) * rb, -ai * rb);
    const float dr = ar - beta, di = ai, rdd = __frcp_rn(fmaf(dr, dr, di * di));
    inv = make_float2(dr * rdd, -di * rdd);
  }
#pragma unroll
  for (int s = 0; s < kPR; ++s) {
    const int g = lane + 32 * s;
    x[s] = g > j ? cmul(make_float2(x[s].x * sc, x[s].y * sc), inv) : make_float2(g == j ? 1.f : 0.f, 0.f);
    if (g < kRows) col[panel_pos<kC, kSeg>(g)] = x[s];
  }
  if (lane == 0) {
    *tau = t;
    *inv_out = inv;
  }
}

// The next column's dot with column ``col``'s entries below its pivot row
// j, in the units of that column's reflector: sum_{g > j} conj(x[g] 2^e)
// y[g], e the exponent householder_column takes for the column (of its
// largest entry at rows >= j).  Each lane scales its own rows, and a pair
// of lanes aligns its sums by powers of two, as the norm's reduction does.
// With it the next column's w = v^H y is y[j] + conj(inv) dot (the plain
// twin, ops/householder_qr.householder_qr_reference, forms v and takes
// v^H y: equal to rounding).
template <int kPR, int kS, int kC>
__device__ __forceinline__ float2 scaled_dot(const float2* col, const float2 (&y)[kPR], int j, int lane) {
  constexpr int kSeg = panel_seg(kS, kC), kRows = 16 * kS * kC;
  float2 xk[kPR];
  float mx = 0.f;
#pragma unroll
  for (int s = 0; s < kPR; ++s) {
    const int g = lane + 32 * s;
    xk[s] = g >= j && g < kRows ? col[panel_pos<kC, kSeg>(g)] : make_float2(0.f, 0.f);
    mx = fmaxf(mx, fmaxf(fabsf(xk[s].x), fabsf(xk[s].y)));
  }
  int e = mx > 0.f ? max(-126, 127 - (__float_as_int(mx) >> 23)) : kNone;
  const float sl = e == kNone ? 0.f : pow2(e);
  float2 d = make_float2(0.f, 0.f), d1 = make_float2(0.f, 0.f);
#pragma unroll
  for (int s = 0; s < kPR; ++s)
    if (lane + 32 * s > j) cdot_acc(s & 1 ? d1 : d, make_float2(xk[s].x * sl, xk[s].y * sl), y[s]);
  d.x += d1.x;
  d.y += d1.y;
#pragma unroll
  for (int m = 1; m < 32; m <<= 1) {
    const int eo = __shfl_xor_sync(0xffffffffu, e, m);
    const float ox = __shfl_xor_sync(0xffffffffu, d.x, m), oy = __shfl_xor_sync(0xffffffffu, d.y, m);
    const int em = min(e, eo);
    const float fa = pow2(em - e), fb = pow2(em - eo);
    d.x = __fadd_rn(__fmul_rn(d.x, fa), __fmul_rn(ox, fb));
    d.y = __fadd_rn(__fmul_rn(d.y, fa), __fmul_rn(oy, fb));
    e = em;
  }
  return d;
}

// One matrix per cluster of kC CTAs, kS slots of 16 rows a CTA, panels of
// kNB columns (the file comment).  The panel's lane rows, the unrolled
// loops over the cluster and over a panel's columns follow from the
// template parameters.
template <int kS, int kC, int kNB>
__global__ void __launch_bounds__(kThreads, 1)
geqrf_ungqr_blocked_kernel(const float2* __restrict__ y, float2* __restrict__ q, int n, int l) {
  cg::cluster_group grp = cg::this_cluster();
  extern __shared__ float4 smem4[];
  constexpr int kLd = qr_ld(kS);
  constexpr int cs = cluster_shift(kC);  // kC = 2^cs
  constexpr int kPR = panel_lane_rows(16 * kS * kC);
  constexpr int kSeg = panel_seg(kS, kC), kPld = kC * kSeg;  // a CTA's rows in a panel column; its stride
  constexpr int kRows = 16 * kS * kC;                           // rows the cluster holds
  static_assert(kNB == 8 || kNB == kMaxPanel, "panels of 8 or 16 columns");
  const int me = static_cast<int>(grp.block_rank());
  const size_t mat = blockIdx.x >> cs;
  const int np = (l + kNB - 1) / kNB, ldw = w_ld(l);
  float2* a = reinterpret_cast<float2*>(smem4);     // [l][kLd]: local row r of column k at k kLd + r
  float2* tm = a + static_cast<size_t>(l) * kLd;   // [np][kNB][kNB]: T of each panel, row-major
  float2* wq = tm + np * kNB * kNB;                 // [kNB][ldw] the block coefficients T^H W or T W
  float2* wpart = wq + max(kPld, kNB * ldw);        // [kNB][ldw] partial W, buffer 0
  float2* pan = wpart + kNB * ldw;                  // [kNB][kPld] the panel; partial W buffer 1 in ungqr
  float2* gram = pan + max(kNB * kPld, kNB * ldw);  // [kNB][kNB] V^H V of the panel
  float2* taus = gram + kNB * kNB;                  // [kNB]
  float2* invs = taus + kNB;                        // [kNB] 1 / (alpha - beta), scaled
  float2* xnext = wq;                               // [kPld] in the factorization: column k + 1 after H_k

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto csync = [&]() {
    if constexpr (kC == 1) __syncthreads();
    else grp.sync();
  };

  const float2* ym = y + mat * n * l;
  for (int i = threadIdx.x; i < 16 * kS * l; i += kThreads) {
    const int r = i / l, k = i - r * l;
    const int g = r * kC + me;
    a[k * kLd + r] = g < n ? ym[static_cast<size_t>(g) * l + k] : make_float2(0.f, 0.f);
  }
  __syncthreads();

  // Gather: this CTA's rows of the panel j0 .. j0 + nbp - 1, two rows (16
  // bytes) a store, to its segment of every CTA's panel (pairs wholly above
  // row j0 stay behind; the factorization reads rows >= j0 below n).
  auto gather = [&](int j0, int nbp) {
    for (int i = threadIdx.x; i < 8 * kS * nbp; i += kThreads) {
      const int k = i / (8 * kS), r = 2 * (i - k * (8 * kS));
      if ((r + 1) * kC + me < j0) continue;
      publish<kC>(grp, reinterpret_cast<float4*>(pan + k * kPld + me * kSeg + r),
                  *reinterpret_cast<const float4*>(a + (j0 + k) * kLd + r));
    }
  };

  // ---- geqrf, a panel of columns j0 .. jn - 1 at a time ----
  gather(0, min(kNB, l));
  csync();
  for (int pnl = 0; pnl < np; ++pnl) {
    const int j0 = pnl * kNB, nbp = min(kNB, l - j0), jn = j0 + nbp;
    const int s0 = j0 >> 5;  // a panel lane's rows below s0 lie above the panel

    // Factor the panel: warp k holds column k; step k reduces it, then the
    // warps after k apply H_k^H and the warps before k take (V^H V)[., k];
    // warp 0 also forms column k - 1 of T (clarft: T[r][c] = -tau_c
    // sum_{r <= m < c} T[r][m] (V^H V)[m][c], T[c][c] = tau_c), row r by
    // lane r, whose inputs are complete since step k's barrier.
    float2* tp = tm + pnl * kNB * kNB;
    auto t_column = [&](int c) {
      const int r = lane;
      float2 val = make_float2(0.f, 0.f);
      if (r <= c) {
        const float2 tc = taus[c];
        if (r == c) {
          val = tc;
        } else {
          float2 s = make_float2(0.f, 0.f);
          for (int m = r; m < c; ++m) cmul_acc(s, tp[r * kNB + m], gram[m * kNB + c]);
          val = cmul(make_float2(-tc.x, -tc.y), s);
        }
      }
      tp[r * kNB + c] = val;
    };
    float2 x[kPR];
#pragma unroll
    for (int s = 0; s < kPR; ++s) {
      const int g = lane + 32 * s;
      x[s] = warp < nbp && g >= j0 && g < n ? pan[warp * kPld + panel_pos<kC, kSeg>(g)] : make_float2(0.f, 0.f);
    }
    // Warp k + 1 takes its dot with column k while warp k reduces it (for k
    // = 0 from the gathered column; then from the column warp k hands over
    // after applying H_{k-1}), so that after step k's barrier only scalar
    // work stands between v_k and column k + 1's own reduction.
    float2 dnext = make_float2(0.f, 0.f);
    if (warp == 1 && nbp > 1) dnext = scaled_dot<kPR, kS, kC>(pan, x, j0, lane);
    __syncthreads();  // column 0 is read before warp 0 writes v_0 over it
    for (int k = 0; k < nbp; ++k) {
      const int j = j0 + k;
      if (warp == k) householder_column<kPR, kS, kC>(x, j, lane, pan + k * kPld, taus + k, invs + k);
      __syncthreads();
      if (warp < nbp && warp != k) {
        const float2* vk = pan + k * kPld;
        float2 v[kPR];
#pragma unroll
        for (int s = 0; s < kPR; ++s) {
          const int g = lane + 32 * s;
          v[s] = s >= s0 && g < kRows ? vk[panel_pos<kC, kSeg>(g)] : make_float2(0.f, 0.f);
        }
        float2 w;
        if (warp == k + 1) {
          // w = v_k^H x = x[j] + conj(inv_k) dnext.
          float2 al = make_float2(0.f, 0.f);
#pragma unroll
          for (int s = 0; s < kPR; ++s)
            if (lane + 32 * s == j) al = x[s];
          al.x = __shfl_sync(0xffffffffu, al.x, j & 31);
          al.y = __shfl_sync(0xffffffffu, al.y, j & 31);
          const float2 ik = invs[k];
          w = al;
          cdot_acc(w, ik, dnext);
        } else {
          float2 acc = make_float2(0.f, 0.f), acc1 = make_float2(0.f, 0.f);
#pragma unroll
          for (int s = 0; s < kPR; ++s) {
            if (s < s0) continue;
            if (warp > k) cdot_acc(s & 1 ? acc1 : acc, v[s], x[s]);
            else cdot_acc(s & 1 ? acc1 : acc, x[s], v[s]);
          }
          w.x = warp_sum(acc.x + acc1.x);
          w.y = warp_sum(acc.y + acc1.y);
        }
        if (warp > k) {
          const float2 tk = taus[k];
          const float2 t = cmul(make_float2(tk.x, -tk.y), w);
#pragma unroll
          for (int s = 0; s < kPR; ++s) {
            if (s < s0) continue;
            csub_mul(x[s], v[s], t);
          }
          if (warp == k + 1 && k + 2 < nbp) {
            // Hand column k + 1 (after H_k) to warp k + 2.
#pragma unroll
            for (int s = 0; s < kPR; ++s) {
              const int g = lane + 32 * s;
              if (g < kRows) xnext[panel_pos<kC, kSeg>(g)] = x[s];
            }
            asm volatile("bar.arrive 1, 64;" ::: "memory");
          } else if (warp == k + 2) {
            asm volatile("bar.sync 1, 64;" ::: "memory");
            dnext = scaled_dot<kPR, kS, kC>(xnext, x, j + 1, lane);
          }
        } else {
          if (lane == 0) gram[warp * kNB + k] = w;
          if (warp == 0 && lane < kNB) t_column(k - 1);
        }
      }
    }
    __syncthreads();

    // T's last column (and zeros past a ragged panel) by warp 0; the other
    // warps copy V into this CTA's rows of the panel's columns.
    if (warp == 0) {
      if (lane < kNB) {
        t_column(nbp - 1);
        for (int c = nbp; c < kNB; ++c) tp[lane * kNB + c] = make_float2(0.f, 0.f);
      }
    } else {
      for (int i = threadIdx.x - 32; i < 16 * kS * nbp; i += kThreads - 32) {
        const int k = i / (16 * kS), r = i - k * (16 * kS);
        a[(j0 + k) * kLd + r] = pan[k * kPld + me * kSeg + r];
      }
    }
    __syncthreads();
    if (jn >= l) break;

    // W = V^H A over this CTA's rows of the trailing columns, then the
    // exchange, then A -= V (T^H W).
    partial_w<kS, kC, kNB>(a, wpart, jn, l, ldw, j0, nbp, warp, lane);
    csync();
    block_coeffs<kNB, kC, false>(grp, wpart, tp, wq, jn, l, ldw, nbp, me);
    __syncthreads();
    // The next panel's columns first; then their gather's barrier runs while
    // the rest of the trailing columns are updated.
    const int jn2 = min(jn + kNB, l);
    block_update<kS, kC, kNB, false>(a, wq, jn, jn2, ldw, j0, nbp, me, warp, lane);
    __syncthreads();
    gather(jn, jn2 - jn);
    if constexpr (kC > 1) cluster_arrive();
    block_update<kS, kC, kNB, false>(a, wq, jn2, l, ldw, j0, nbp, me, warp, lane);
    if constexpr (kC > 1) cluster_wait();
    else __syncthreads();
  }

  // ---- ungqr: Q = H_0 ... H_{l-1} I[:, :l], a panel at a time from the
  //      last: Q[:, j0:] -= V (T (V^H Q[:, j0:])), where a panel's own
  //      columns are still e_j (they hold V until the panel's update) ----
  for (int pnl = np - 1; pnl >= 0; --pnl) {
    const int j0 = pnl * kNB, nbp = min(kNB, l - j0), jn = j0 + nbp;
    float2* wb = ((np - 1 - pnl) & 1) ? pan : wpart;
    // The panel's own columns are e_k: W[i][k] = conj(V[k][i]), from the
    // CTA that holds row k.
    for (int idx = threadIdx.x; idx < nbp * nbp; idx += kThreads) {
      const int i = idx / nbp, k = j0 + idx - i * nbp;
      const float2 v = (k & (kC - 1)) == me ? a[(j0 + i) * kLd + (k >> cs)] : make_float2(0.f, 0.f);
      wb[i * ldw + k] = make_float2(v.x, -v.y);
    }
    partial_w<kS, kC, kNB>(a, wb, jn, l, ldw, j0, nbp, warp, lane);
    csync();
    block_coeffs<kNB, kC, true>(grp, wb, tm + pnl * kNB * kNB, wq, j0, l, ldw, nbp, me);
    __syncthreads();
    block_update<kS, kC, kNB, true>(a, wq, j0, l, ldw, j0, nbp, me, warp, lane);
    __syncthreads();
  }

  float2* qm = q + mat * n * l;
  for (int i = threadIdx.x; i < 16 * kS * l; i += kThreads) {
    const int r = i / l, k = i - r * l;
    const int g = r * kC + me;
    if (g < n) qm[static_cast<size_t>(g) * l + k] = a[k * kLd + r];
  }
}

using QrKernel = void (*)(const float2*, float2*, int, int);

template <int kC, int kNB>
QrKernel qr_kernel_of(int slots) {
  switch (slots) {
    case 1: return geqrf_ungqr_blocked_kernel<1, kC, kNB>;
    case 2: return geqrf_ungqr_blocked_kernel<2, kC, kNB>;
    case 4: return geqrf_ungqr_blocked_kernel<4, kC, kNB>;
    case 8:
      if constexpr (kC < 4) return geqrf_ungqr_blocked_kernel<8, kC, kNB>;
      return nullptr;
    default: return nullptr;
  }
}

template <int kNB>
QrKernel qr_kernel_nb(int slots, int cluster) {
  switch (cluster) {
    case 1: return qr_kernel_of<1, kNB>(slots);
    case 2: return qr_kernel_of<2, kNB>(slots);
    case 4: return qr_kernel_of<4, kNB>(slots);
    default: return nullptr;
  }
}

// The instantiation for ``slots`` slots a CTA, ``cluster`` CTAs a matrix (4
// CTAs hold at most 64 rows each) and panels of ``nb`` columns, or nullptr.
QrKernel qr_kernel(int slots, int cluster, int nb) {
  switch (nb) {
    case 8: return qr_kernel_nb<8>(slots, cluster);
    case kMaxPanel: return qr_kernel_nb<kMaxPanel>(slots, cluster);
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Launches the reduced Householder QR of ``batch`` contiguous (n, l)
// complex64 matrices ``y`` (interleaved re, im) on ``stream``, writing Q
// (batch, n, l) to ``q``; returns the CUDA error code of the launch (0 on
// success).  1 <= l <= n <= 256; ``cluster`` CTAs (1, 2 or 4) per
// matrix, each holding at most 128 rows; panels of ``nb`` columns (16 or
// 8; ops/householder_qr.qr_plan).
int householder_qr_launch(const float2* y, float2* q, int batch, int n, int l, int cluster, int nb,
                          void* stream) {
  if (batch < 1 || l < 1 || l > n || n > kMaxRows) return cudaErrorInvalidValue;
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) != 0)
    return cudaErrorInvalidValue;
  const QrKernel kernel = qr_kernel(qr_slots(cta_rows(n, cluster)), cluster, nb);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  const size_t smem = blocked_smem_bytes(n, l, cluster, nb);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, y, q, n, l);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
