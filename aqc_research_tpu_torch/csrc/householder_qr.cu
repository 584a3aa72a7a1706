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
// H_{l-1} I[:, :l] as cung2r forms it, applying the reflectors kept on chip
// backwards.  Only Q is written to device memory.  Column norms are scaled:
// every CTA scales the column by the power of two that brings its largest
// entry into [1, 2) before the dot products, so columns far below f32's
// normal range (the zero-padded samples reach 1e-23) keep their norm and
// the products stay normal; a column whose largest entry lies below
// 2^-100 gets tau = 0 (H = I), as one whose norm is zero does in LAPACK.
// So Q is finite and orthonormal on rank-deficient samples too.
//
// Bounds.  A (256, 136) matrix is ~62 MFLOP of f32 work (geqr2 and ung2r):
// ~1 us at 67 TFLOP/s over the card, ~0.12 ms on one SM.  The work is 2 l
// dependent column steps, each a reduction over the rows and a rank-one
// update, so the kernel is bound by the latency of a step and not by flops
// or bytes.  The design keeps a step to one pass over the trailing columns
// and one barrier:
//   * one matrix per cluster of 1, 2 or 4 CTAs (ops/householder_qr.
//     qr_cluster: 4 for a half-layer's 13-14 matrices, so each CTA holds at
//     most 64 rows; the fewest that hold the rows when the batch would not
//     fit the card at once), rows dealt out cyclically (row g to CTA g %
//     cluster), so the matrices of a batch run at once on their own SMs;
//   * a CTA holds its rows of every column in shared memory, column-major;
//     lane (rl, cl) of a warp holds rows 16 p + 2 rl, 16 p + 2 rl + 1 of
//     one column of a group of four (float4 loads), every warp all rows;
//   * step j's pass applies H_j to the trailing columns and, in the same
//     pass, takes the dot products of the next column with every later one
//     (each lane updates the next column at its rows itself, so every warp
//     has it without a barrier, and its largest entry by a warp max);
//     the partial dots, the partial norm, the scale exponent and the pivot
//     row go to every CTA of the cluster through distributed shared memory,
//     double-buffered by the step's parity; one cluster barrier; then every
//     thread derives beta, tau and w from the same numbers in the same
//     order, so the CTAs agree bit for bit without a broadcast;
//   * Q is formed in place the same way, one barrier a step.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxRows = 256;    // n
constexpr int kMaxCtaRows = 128;  // rows one CTA holds: 8 slots of 16
constexpr int kMaxCluster = 4;    // CTAs of a cluster: 1, 2 or 4
constexpr int kNone = 1 << 20;    // scale exponent of a CTA with nothing above the floor
constexpr float kFloor = 0x1p-100f;

// Slots of 16 rows a CTA holds (1, 2, 4 or 8), 0 past kMaxCtaRows.
__host__ __device__ constexpr int qr_slots(int rows) {
  return rows <= 16 ? 1 : rows <= 32 ? 2 : rows <= 64 ? 4 : rows <= kMaxCtaRows ? 8 : 0;
}
__host__ __device__ constexpr int cta_rows(int n, int cluster) { return (n + cluster - 1) / cluster; }
// Column stride in complex entries: 16 B of padding keeps the load and store
// of whole rows (consecutive columns) off one bank.
__host__ __device__ constexpr int qr_ld(int slots) { return 16 * slots + 2; }
// Dynamic shared memory of one CTA: the columns, tau, the partial dots and
// the pivot row (two buffers each), the partial norms and exponents.
__host__ __device__ constexpr size_t qr_smem_bytes(int n, int l, int cluster) {
  return sizeof(float2) * (static_cast<size_t>(qr_ld(qr_slots(cta_rows(n, cluster)))) * l + l +
                           2 * static_cast<size_t>(cluster) * l + 2 * l) +
         (sizeof(float) + sizeof(int)) * 2 * cluster;
}

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
// Sum and max over the eight row lanes (lane bits 0-2), the same order in
// every warp.
__device__ __forceinline__ float rows_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  return v;
}
__device__ __forceinline__ float rows_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
  return v;
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

// One matrix per cluster of kC CTAs (blocks mat * kC ..), kS slots of 16
// rows a CTA (the file comment).  Both are template parameters: with them
// known the loops over the cluster unroll and the body stays small enough
// for the instruction cache (a runtime cluster size cost 12-22% at the
// path shapes on an H100).
template <int kS, int kC>
__global__ void __launch_bounds__(kThreads, 1)
geqrf_ungqr_cluster_kernel(const float2* __restrict__ y, float2* __restrict__ q, int n, int l) {
  cg::cluster_group grp = cg::this_cluster();
  extern __shared__ float4 smem4[];
  constexpr int kLd = qr_ld(kS);
  constexpr int kR = 2 * kS;  // rows of one lane
  constexpr int cs = kC == 1 ? 0 : kC == 2 ? 1 : 2;  // kC = 2^cs
  const int me = static_cast<int>(grp.block_rank());
  const size_t mat = blockIdx.x >> cs;
  float2* a = reinterpret_cast<float2*>(smem4);  // [l][kLd]: local row r of column k at k kLd + r
  float2* tau = a + static_cast<size_t>(l) * kLd;  // [l]
  float2* part = tau + l;                          // [2][kC][l] partial dots, by step parity
  float2* rowb = part + 2 * kC * l;                 // [2][l] the pivot row
  float* nrm = reinterpret_cast<float*>(rowb + 2 * l);  // [2][kC] partial norms^2 (scaled)
  int* ex = reinterpret_cast<int*>(nrm + 2 * kC);        // [2][kC] scale exponents

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rl = lane & 7, cl = lane >> 3;
  // Groups of four trailing columns go to warps 1, 2, .., 0: warp 0, which
  // also publishes a step's norm and forms Q's next column, takes the last.
  const int first_group = (warp + kWarps - 1) & (kWarps - 1);
  auto sync = [&]() {
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

  // ---- geqr2: pass j applies H_j (j >= 0) and prepares column m = j + 1 ----
  float2 xs[kR];  // the lane's rows of the column being reduced, scaled, zero at rows <= it
  float2 v[kR];   // the lane's rows of the reflector being applied
#pragma unroll
  for (int s = 0; s < kR; ++s) xs[s] = v[s] = make_float2(0.f, 0.f);
  float2 ctau = make_float2(0.f, 0.f);  // conj(tau_j)
  float2 cinv = make_float2(0.f, 0.f);  // conj(1 / (alpha' - beta')), scaled units
  float2 fme = make_float2(0.f, 0.f);   // 2^(E - e_me) / (alpha' - beta'): v from this CTA's xs
  float fac[kC];                        // 2^(E - e_c): CTA c's partials in step j's scale
#pragma unroll
  for (int c = 0; c < kC; ++c) fac[c] = 0.f;

  for (int j = -1; j < l; ++j) {
    const int m = j + 1;
    const int jb = j & 1, mb = m & 1;
    const int p0 = (j + 1) >> (4 + cs);  // slots below p0 hold rows <= j only
    const bool apply = j >= 0 && (ctau.x != 0.f || ctau.y != 0.f);
    // w_k of reflector j: the pivot row plus the CTAs' partial dots, rescaled.
    auto w_of = [&](int k) {
      float2 s = make_float2(0.f, 0.f);
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float2 pc = part[(jb * kC + c) * l + k];
        s.x = fmaf(fac[c], pc.x, s.x);
        s.y = fmaf(fac[c], pc.y, s.y);
      }
      const float2 r = rowb[jb * l + k], d = cmul(s, cinv);
      return make_float2(r.x + d.x, r.y + d.y);
    };
    const bool own_m = (m & (kC - 1)) == me;        // this CTA holds row m,
    const int lm = m >> cs, rl_m = (lm & 15) >> 1;  // as local row lm, in the row lane rl_m

    if (j >= 0) {
#pragma unroll
      for (int s = 0; s < kR; ++s) v[s] = cmul(xs[s], fme);
      if (warp == 0 && cl == 0) {  // column j keeps v below the diagonal (rows <= j: unused)
#pragma unroll
        for (int p = 0; p < kS; ++p) {
          if (p < p0) continue;
          *reinterpret_cast<float4*>(a + j * kLd + 16 * p + 2 * rl) =
              make_float4(v[2 * p].x, v[2 * p].y, v[2 * p + 1].x, v[2 * p + 1].y);
        }
      }
    }
    if (m >= l) break;

    // Column m after H_j, at this lane's rows (every warp: each needs it
    // for its dots); its largest entry over the CTA's rows >= m; scaled;
    // the partial norm of its part below row m (warp 0).
    {
      const float2 t = apply ? cmul(ctau, w_of(m)) : make_float2(0.f, 0.f);
      const int r_gt = m < me ? 0 : ((m - me) >> cs) + 1;     // local rows r >= r_gt lie below m,
      const int r_ge = m <= me ? 0 : (m - me + kC - 1) >> cs;  // r >= r_ge at or below it
      float mx = 0.f;
      float2 alpha = make_float2(0.f, 0.f);
#pragma unroll
      for (int p = 0; p < kS; ++p) {
        if (p < p0) {
          xs[2 * p] = xs[2 * p + 1] = make_float2(0.f, 0.f);
          continue;
        }
        const float4 e4 = *reinterpret_cast<const float4*>(a + m * kLd + 16 * p + 2 * rl);
        float2 e[2] = {make_float2(e4.x, e4.y), make_float2(e4.z, e4.w)};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (apply) csub_mul(e[h], v[2 * p + h], t);
          const int r = 16 * p + 2 * rl + h;
          if (r >= r_ge) mx = fmaxf(mx, fmaxf(fabsf(e[h].x), fabsf(e[h].y)));
          if (r == lm) alpha = e[h];
          xs[2 * p + h] = r >= r_gt ? e[h] : make_float2(0.f, 0.f);
        }
      }
      mx = rows_max(mx);
      // 2^e_me brings mx (normal: mx >= kFloor) into [1, 2), or [1, 4) at
      // the top of the range.
      const int e_me = mx >= kFloor ? max(-126, 127 - (__float_as_int(mx) >> 23)) : kNone;
      const float sc = e_me == kNone ? 0.f : pow2(e_me);
#pragma unroll
      for (int s = 0; s < kR; ++s) {
        xs[s].x *= sc;
        xs[s].y *= sc;
      }
      if (warp == 0) {
        float nn = 0.f, nn1 = 0.f;
#pragma unroll
        for (int s = 0; s < kR; s += 2) {
          nn = fmaf(xs[s].x, xs[s].x, fmaf(xs[s].y, xs[s].y, nn));
          nn1 = fmaf(xs[s + 1].x, xs[s + 1].x, fmaf(xs[s + 1].y, xs[s + 1].y, nn1));
        }
        nn = rows_sum(nn + nn1);
        if (own_m && cl == 0 && rl == rl_m) publish<kC>(grp, rowb + mb * l + m, alpha);
        if (lane == 0) {
          publish<kC>(grp, nrm + mb * kC + me, nn);
          publish<kC>(grp, ex + mb * kC + me, e_me);
        }
      }
    }

    // The trailing columns k > m: H_j, then the dots with column m.
    const int k0 = m + 1, count = l - k0;
    for (int grp4 = first_group; 4 * grp4 < count; grp4 += kWarps) {
      const int k = k0 + 4 * grp4 + cl;
      const bool valid = k < l;
      const float2 t = valid && apply ? cmul(ctau, w_of(k)) : make_float2(0.f, 0.f);
      float2 acc = make_float2(0.f, 0.f), acc1 = make_float2(0.f, 0.f);
      if (valid) {
#pragma unroll
        for (int p = 0; p < kS; ++p) {
          if (p < p0) continue;
          float4* at = reinterpret_cast<float4*>(a + k * kLd + 16 * p + 2 * rl);
          const float4 e4 = *at;
          float2 e[2] = {make_float2(e4.x, e4.y), make_float2(e4.z, e4.w)};
          if (apply) {
            csub_mul(e[0], v[2 * p], t);
            csub_mul(e[1], v[2 * p + 1], t);
            *at = make_float4(e[0].x, e[0].y, e[1].x, e[1].y);
          }
          cdot_acc(acc, xs[2 * p], e[0]);
          cdot_acc(acc1, xs[2 * p + 1], e[1]);
        }
        // The pivot row's entry, from the lane that holds it (its own store).
        if (own_m && rl == rl_m) publish<kC>(grp, rowb + mb * l + k, a[k * kLd + lm]);
      }
      acc.x = rows_sum(acc.x + acc1.x);
      acc.y = rows_sum(acc.y + acc1.y);
      if (valid && rl == 0) publish<kC>(grp, part + (mb * kC + me) * l + k, acc);
    }
    sync();

    // beta, tau and w's scale for step m, from the exchange (every thread).
    {
      int Em = kNone;
#pragma unroll
      for (int c = 0; c < kC; ++c) Em = min(Em, ex[mb * kC + c]);
      ctau = cinv = fme = make_float2(0.f, 0.f);
      if (Em != kNone) {
        float xn2 = 0.f;
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const int ec = ex[mb * kC + c];
          fac[c] = ec == kNone ? 0.f : pow2(Em - ec);
          xn2 = fmaf(nrm[mb * kC + c] * fac[c], fac[c], xn2);
        }
        const int e_me = ex[mb * kC + me];
        const float2 al = rowb[mb * l + m];
        const float s = pow2(Em);
        const float ar = al.x * s, ai = al.y * s;
        if (xn2 != 0.f || ai != 0.f) {
          const float r = sqrtf(fmaf(ar, ar, fmaf(ai, ai, xn2)));
          const float beta = ar >= 0.f ? -r : r;
          const float rb = __frcp_rn(beta);
          ctau = make_float2((beta - ar) * rb, ai * rb);
          const float dr = ar - beta, di = ai, rdd = __frcp_rn(fmaf(dr, dr, di * di));
          cinv = make_float2(dr * rdd, di * rdd);
          if (e_me != kNone) {
            const float f = pow2(Em - e_me);
            fme = make_float2(f * cinv.x, -f * cinv.y);
          }
        }
      }
      if (threadIdx.x == 0) tau[m] = make_float2(ctau.x, -ctau.y);
    }
  }
  __syncthreads();

  // ---- ung2r: pass i applies H_{i+1} (written into column i + 1 of Q) and
  //      takes the dots of v_i with the columns after i ----
  float2 vm[kR];  // the lane's rows of v_{i+1}: 1 at row i + 1, 0 above
  float2 vi[kR];  // the lane's rows of v_i: 1 at row i, 0 above
#pragma unroll
  for (int s = 0; s < kR; ++s) vm[s] = vi[s] = make_float2(0.f, 0.f);
  for (int i = l - 1; i >= -1; --i) {
    const int mq = i + 1;
    const int ib = i & 1, qb = mq & 1;
    const int p0 = (i + 1) >> (4 + cs);  // slots below p0 hold rows <= i only
    if (i >= 0) {
      const int pv = i >> (4 + cs);                        // the slot of row i
      const int r_gt = i < me ? 0 : ((i - me) >> cs) + 1;  // local rows r >= r_gt lie below i
      const int ri = (i & (kC - 1)) == me ? i >> cs : -1;   // row i's local row, if held here
#pragma unroll
      for (int p = 0; p < kS; ++p) {
        if (p < pv) {
          vi[2 * p] = vi[2 * p + 1] = make_float2(0.f, 0.f);
          continue;
        }
        const float4 e4 = *reinterpret_cast<const float4*>(a + i * kLd + 16 * p + 2 * rl);
        const float2 e[2] = {make_float2(e4.x, e4.y), make_float2(e4.z, e4.w)};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * p + 2 * rl + h;
          vi[2 * p + h] = r >= r_gt ? e[h] : make_float2(r == ri ? 1.f : 0.f, 0.f);
        }
      }
    }
    const float2 tm = mq < l ? tau[mq] : make_float2(0.f, 0.f);
    const bool apply = tm.x != 0.f || tm.y != 0.f;

    if (mq < l && warp == 0) {  // column mq of Q: e_mq - tau v_mq; its dot with v_i
      const int rq = (mq & (kC - 1)) == me ? mq >> cs : -1;  // row mq's local row, if held here
      float2 acc = make_float2(0.f, 0.f), acc1 = make_float2(0.f, 0.f);
#pragma unroll
      for (int p = 0; p < kS; ++p) {
        float2 qv[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int s = 2 * p + h;
          qv[h] = make_float2(-(tm.x * vm[s].x - tm.y * vm[s].y), -(tm.x * vm[s].y + tm.y * vm[s].x));
          if (16 * p + 2 * rl + h == rq) qv[h].x += 1.f;
        }
        cdot_acc(acc, vi[2 * p], qv[0]);
        cdot_acc(acc1, vi[2 * p + 1], qv[1]);
        if (cl == 0)
          *reinterpret_cast<float4*>(a + mq * kLd + 16 * p + 2 * rl) =
              make_float4(qv[0].x, qv[0].y, qv[1].x, qv[1].y);
      }
      if (i >= 0) {
        acc.x = rows_sum(acc.x + acc1.x);
        acc.y = rows_sum(acc.y + acc1.y);
        if (lane == 0) publish<kC>(grp, part + (ib * kC + me) * l + mq, acc);
      }
    }

    // The columns k > mq: H_{mq}, then the dots with v_i.
    const int k0 = mq + 1, count = l - k0;
    for (int grp4 = first_group; 4 * grp4 < count; grp4 += kWarps) {
      const int k = k0 + 4 * grp4 + cl;
      const bool valid = k < l;
      float2 t = make_float2(0.f, 0.f);
      if (valid && apply) {
        float2 w = make_float2(0.f, 0.f);
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const float2 pc = part[(qb * kC + c) * l + k];
          w.x += pc.x;
          w.y += pc.y;
        }
        t = cmul(tm, w);
      }
      float2 acc = make_float2(0.f, 0.f), acc1 = make_float2(0.f, 0.f);
      if (valid) {
#pragma unroll
        for (int p = 0; p < kS; ++p) {
          if (p < p0) continue;
          float4* at = reinterpret_cast<float4*>(a + k * kLd + 16 * p + 2 * rl);
          const float4 e4 = *at;
          float2 e[2] = {make_float2(e4.x, e4.y), make_float2(e4.z, e4.w)};
          if (apply) {
            csub_mul(e[0], vm[2 * p], t);
            csub_mul(e[1], vm[2 * p + 1], t);
            *at = make_float4(e[0].x, e[0].y, e[1].x, e[1].y);
          }
          cdot_acc(acc, vi[2 * p], e[0]);
          cdot_acc(acc1, vi[2 * p + 1], e[1]);
        }
      }
      if (i >= 0) {
        acc.x = rows_sum(acc.x + acc1.x);
        acc.y = rows_sum(acc.y + acc1.y);
        if (valid && rl == 0) publish<kC>(grp, part + (ib * kC + me) * l + k, acc);
      }
    }
    if (i >= 0) sync();
#pragma unroll
    for (int s = 0; s < kR; ++s) vm[s] = vi[s];
  }
  __syncthreads();

  float2* qm = q + mat * n * l;
  for (int i = threadIdx.x; i < 16 * kS * l; i += kThreads) {
    const int r = i / l, k = i - r * l;
    const int g = r * kC + me;
    if (g < n) qm[static_cast<size_t>(g) * l + k] = a[k * kLd + r];
  }
}

using QrKernel = void (*)(const float2*, float2*, int, int);

template <int kC>
QrKernel qr_kernel_of(int slots) {
  switch (slots) {
    case 1: return geqrf_ungqr_cluster_kernel<1, kC>;
    case 2: return geqrf_ungqr_cluster_kernel<2, kC>;
    case 4: return geqrf_ungqr_cluster_kernel<4, kC>;
    case 8:
      if constexpr (kC < 4) return geqrf_ungqr_cluster_kernel<8, kC>;
      return nullptr;
    default: return nullptr;
  }
}

// The instantiation for ``slots`` slots a CTA and ``cluster`` CTAs a matrix
// (4 CTAs hold at most 64 rows each), or nullptr.
QrKernel qr_kernel(int slots, int cluster) {
  switch (cluster) {
    case 1: return qr_kernel_of<1>(slots);
    case 2: return qr_kernel_of<2>(slots);
    case 4: return qr_kernel_of<4>(slots);
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Launches the reduced Householder QR of ``batch`` contiguous (n, l)
// complex64 matrices ``y`` (interleaved re, im) on ``stream``, writing Q
// (batch, n, l) to ``q``; returns the CUDA error code of the launch (0 on
// success).  1 <= l <= n <= 256; ``cluster`` CTAs (1, 2 or 4) per
// matrix, each holding at most 128 rows (ops/householder_qr.qr_cluster).
int householder_qr_launch(const float2* y, float2* q, int batch, int n, int l, int cluster,
                          void* stream) {
  if (batch < 1 || l < 1 || l > n || n > kMaxRows) return cudaErrorInvalidValue;
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) != 0)
    return cudaErrorInvalidValue;
  const QrKernel kernel = qr_kernel(qr_slots(cta_rows(n, cluster)), cluster);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  const size_t smem = qr_smem_bytes(n, l, cluster);
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
