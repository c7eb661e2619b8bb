// The trapezoid leg's device body, shared by the per-leg launch
// (spmd_leg.cu: one launch a leg, one block a tile) and the pod engine's
// chained launches (pod.cu: every leg of a direction in one cooperative
// launch, each block looping over tiles).  spmd_leg.cu's note describes the
// array model, the generations, the consumers, the rounding and the design.
//
// leg_tile runs one (y, z) tile and x-chunk of one leg; the norm
// consumer's body with null partials runs as a leg with no consumer.  Its
// loads are
// plain loads (no __ldg, no const __restrict__): in a chained launch a leg
// reads what the previous leg wrote in the same launch, and the read-only
// cache is not coherent with those writes.
//
// The FAS sub_rv epilogue: an up leg below the head of a pod chain writes
// generation S minus rest_v (LegArgs::sub_rv), so the next finer leg's
// prolongation reads v - rest_v as it is (gpusolve_tpu/ops/pallas_spmd.py
// _make_leg(sub_rv=...), :1015-1019).

#pragma once

#include <type_traits>

#include "mg_device.cuh"

namespace {

constexpr int kG = 8;     // ghost slab depth of the fields
constexpr int kGC = 5;    // of the coarse block of a corr-first leg
constexpr int kTY = 16;   // tile rows (even: coarse rows align)
constexpr int kTZ = 32;   // tile columns (even)
constexpr int kCX = 64;   // x-planes a block owns (even)
constexpr int kLegThreads = 256;
// Ring-plane cells a thread fetches: the plane is at most
// (kTY + 2 kG) x (kTZ + 2 kG).
constexpr int kFetch =
    ((kTY + 2 * kG) * (kTZ + 2 * kG) + kLegThreads - 1) / kLegThreads;
constexpr int kMaxS = 5;
constexpr int kSmemMax = 232448;  // bytes a block may use (H100)

constexpr int kNone = 0;
constexpr int kNorm = 1;
constexpr int kRestrict = 2;

struct Src {  // a field of the block and its ghost slabs
  const float* core;
  const float* xlo;
  const float* xhi;
  const float* ylo;
  const float* yhi;
  int bx, by, bz, g;
};

struct LegArgs {
  Src v, f, nv, c;
  float* v_out;
  const float* sub_rv;  // rest_v: v_out = generation S - rest_v (or null)
  double* partials;
  float* fc;
  float* vc;
  float* rvc;
  int bx, by, bz;
  int x0, x1, y0, y1, z0, z1;        // local box
  int gx0, nx, gy0, ny;              // global x / y start and extent
  int S, src_zero, corr, ysplit;
  int cby, cbz;                      // coarse block (cbx = bx / 2)
  int cx0, cx1, cy0, cy1, cz0, cz1;  // coarse box
  int cnx, cny, cnz;                 // coarse global extents
  int X0, Y0, Z0;                    // tiling origins (even)
  int R, PY, PZ;                     // halo radius, ring plane extents
  float inv_h2, alpha, omega, inv_h2c, gamma, pre_fac;
  float val[kMaxTaps];
  int ox[kMaxTaps], oy[kMaxTaps], oz[kMaxTaps];
  int toff[kMaxTaps];  // oy * PZ + oz: a tap's offset in a ring plane
};

// The point arithmetic's constants, copied from the parameters into
// registers once per thread.
struct Coef {
  float val[kMaxTaps];
  int ox[kMaxTaps], toff[kMaxTaps];
  float inv_h2, alpha, omega, gamma, pre_fac;
};

// The field at extended local (p, y, z): the block, its slabs, or 0.
template <bool kSlabs>
__device__ __forceinline__ float src_at(const Src& s, int p, int y, int z,
                                        bool ys) {
  if (z < 0 || z >= s.bz) return 0.0f;
  const bool in_y = y >= 0 && y < s.by;
  if (p >= 0 && p < s.bx) {
    if (in_y) return s.core[((long long)p * s.by + y) * s.bz + z];
    if (!kSlabs || !ys) return 0.0f;
    if (y < 0) {
      if (y < -s.g) return 0.0f;
      return s.ylo[((long long)p * s.g + (y + s.g)) * s.bz + z];
    }
    if (y >= s.by + s.g) return 0.0f;
    return s.yhi[((long long)p * s.g + (y - s.by)) * s.bz + z];
  }
  if (!kSlabs) return 0.0f;
  const int gy = ys ? s.g : 0;
  if (y < -gy || y >= s.by + gy) return 0.0f;
  const long long rows = s.by + 2 * gy;
  if (p < 0) {
    if (p < -s.g) return 0.0f;
    return s.xlo[((long long)(p + s.g) * rows + (y + gy)) * s.bz + z];
  }
  if (p >= s.bx + s.g) return 0.0f;
  return s.xhi[((long long)(p - s.bx) * rows + (y + gy)) * s.bz + z];
}

// P(coarse) at fine extended (p, y, z): coarse p/2 and (p+1)/2 (floor) per
// axis, midpoints along x, then y, then z.
template <bool kSlabs>
__device__ __forceinline__ float prolong_at(const Src& c, bool ys, int p,
                                            int y, int z) {
  const int xa = p >> 1, xb = (p + 1) >> 1;
  const int ya = y >> 1, yb = (y + 1) >> 1;
  float ym[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int zc = (z + q) >> 1;
    const float ma = mid(src_at<kSlabs>(c, xa, ya, zc, ys),
                         src_at<kSlabs>(c, xb, ya, zc, ys));
    const float mb = mid(src_at<kSlabs>(c, xa, yb, zc, ys),
                         src_at<kSlabs>(c, xb, yb, zc, ys));
    ym[q] = mid(ma, mb);
  }
  return mid(ym[0], ym[1]);
}

__device__ __forceinline__ int mod(int q, int n) {
  const int r = q % n;
  return r < 0 ? r + n : r;
}

__device__ __forceinline__ float weigh3(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(0.25f, a), __fmul_rn(0.5f, b)),
                   __fmul_rn(0.25f, c));
}

// Per-tap offsets into a three-plane ring for a point of plane q: the
// slot of plane q + ox, then the in-plane offset oy * PZ + oz.
__device__ __forceinline__ void ring_offsets(int off[kMaxTaps], int q,
                                             int PS, const Coef& k) {
  const int s0 = mod(q - 1, 3) * PS, s1 = mod(q, 3) * PS,
            s2 = mod(q + 1, 3) * PS;
#pragma unroll
  for (int t = 0; t < kMaxTaps; ++t) {
    off[t] = (k.ox[t] < 0 ? s0 : k.ox[t] > 0 ? s2 : s1) + k.toff[t];
  }
}

// A g / h^2 at in-plane cell `cell` of a three-plane ring, in tap order.
// Every tap is loaded before the sum starts, so the loads overlap; the
// host pads a stencil of fewer taps with zero-valued centre taps, whose
// +0 terms leave the sum as it is.
__device__ __forceinline__ float ring_stencil(const float* ring,
                                              const int off[kMaxTaps],
                                              int cell, const Coef& k,
                                              float inv) {
  float g[kMaxTaps];
#pragma unroll
  for (int t = 0; t < kMaxTaps; ++t) g[t] = ring[off[t] + cell];
  float acc = __fmul_rn(k.val[0], g[0]);
#pragma unroll
  for (int t = 1; t < kMaxTaps; ++t) {
    acc = __fadd_rn(acc, __fmul_rn(k.val[t], g[t]));
  }
  return __fmul_rn(acc, inv);
}

template <int M>
__device__ __forceinline__ float sweep_point(float av, float vc, float fv,
                                             float n, const Coef& a) {
  if constexpr (M == kLinear) {
    return __fadd_rn(vc, __fmul_rn(a.omega, __fmul_rn(a.alpha,
                                                      __fsub_rn(fv, av))));
  } else {
    float ex, term, lin;
    if constexpr (M == kNonlinear) {
      ex = expf(vc);
      term = fas_term(vc, ex, a.gamma);
      lin = __fmul_rn(__fmul_rn(a.gamma, __fadd_rn(1.0f, vc)), ex);
    } else {
      ex = expf(n);
      lin = __fmul_rn(__fmul_rn(a.gamma, __fadd_rn(1.0f, n)), ex);
      term = __fmul_rn(lin, vc);
    }
    const float res = __fsub_rn(fv, __fadd_rn(av, term));
    const float denom = __fadd_rn(a.pre_fac, lin);
    return __fadd_rn(vc, __fmul_rn(a.omega, __fdiv_rn(res, denom)));
  }
}

template <int M>
__device__ __forceinline__ float residual_point(float av, float vc, float fv,
                                                float n, const Coef& a) {
  if constexpr (M == kNonlinear) {
    av = __fadd_rn(av, fas_term(vc, expf(vc), a.gamma));
  } else if constexpr (M == kNewton) {
    const float lin0 = __fmul_rn(a.gamma, __fadd_rn(1.0f, n));
    av = __fadd_rn(av, __fmul_rn(__fmul_rn(lin0, vc), expf(n)));
  }
  return __fsub_rn(fv, av);
}

// The consumer's reach past generation S, in cells.
__host__ __device__ constexpr int reach(int mode, int consumer) {
  return consumer == kNone ? 0
         : consumer == kNorm ? 1
         : mode == kNonlinear ? 3 : 2;
}

// One tile of a leg: the (y, z) tile (ty, tz) of the box and x-chunk tx,
// as one block of 256 threads; `sm` is the launch's dynamic shared memory
// and `slot` the tile's index among its launch's (its norm partial).  The
// block's threads call it together; it ends with every thread past its
// last read of shared memory but for the norm's block_sum, so a block
// that runs another tile next must __syncthreads() first.
template <int M, int C, bool kSlabs>
__device__ __forceinline__ void leg_tile(const LegArgs& a, float* sm, int tz,
                                         int ty, int tx, long long slot) {
  constexpr bool kFas = M == kNonlinear && C == kRestrict;
  constexpr int kCPY = kTY / 2 + 2, kCPZ = kTZ / 2 + 2;
  constexpr int kCPS = kCPY * kCPZ;
  constexpr int kCTZ = kTZ / 2, kCTS = (kTY / 2) * kCTZ;
  const int S = a.S, R = a.R, PZ = a.PZ, PS = a.PY * a.PZ;
  // f (and u~) at plane p is read up to step p + S + 1 (the residual),
  // with no barrier before the next step's load: S + 3 slots.
  const int NF = S + 3;
  const bool ys = a.ysplit;
  // Everything the per-cell code reads, in registers.
  const Src sv = a.v, sf = a.f, snv = a.nv, sc = a.c;
  const int gx0 = a.gx0, nx = a.nx, gy0 = a.gy0, ny = a.ny, z0 = a.z0,
            z1 = a.z1, bz = a.bz, by = a.by;
  const bool src_zero = a.src_zero, corr = a.corr;
  // The norm body with no partials to write runs as a leg with no
  // consumer (the pod up chain runs every leg through it).
  const bool norm_on = C == kNorm && a.partials != nullptr;
  float* const v_out = a.v_out;
  const float* const sub_rv = a.sub_rv;
  Coef co;
#pragma unroll
  for (int t = 0; t < kMaxTaps; ++t) {
    co.val[t] = a.val[t];
    co.ox[t] = a.ox[t];
    co.toff[t] = a.toff[t];
  }
  co.inv_h2 = a.inv_h2;
  co.alpha = a.alpha;
  co.omega = a.omega;
  co.gamma = a.gamma;
  co.pre_fac = a.pre_fac;
  float* gen = sm;                      // generation k: 3 planes at 3k
  float* fr = gen + 3 * (S + 1) * PS;   // f ring
  float* nvr = fr + NF * PS;            // u~ ring (NEWTON)
  float* rr = nvr + (M == kNewton ? NF * PS : 0);   // residual ring
  float* rvr = rr + (C == kRestrict ? 3 * PS : 0);  // Rv ring (FAS)
  float* rst = rvr + 3 * kCPS;                      // R(r) staging (FAS)

  const int lo = a.X0 + tx * kCX;
  const int hi = min(lo + kCX, a.x1 + 1) - 1;
  const int ty0 = a.Y0 + ty * kTY;
  const int tz0 = a.Z0 + tz * kTZ;
  const int ry0 = ty0 - R, rz0 = tz0 - R;  // ring plane origin
  // Owned fine cells: chunk and tile within the box.
  const int ox0 = max(lo, a.x0), ox1 = min(hi, a.x1);
  const int oy0 = max(ty0, a.y0), oy1 = min(ty0 + kTY - 1, a.y1);
  const int oz0 = max(tz0, a.z0), oz1 = min(tz0 + kTZ - 1, a.z1);
  // Owned coarse planes: centres 2m in the chunk.
  const int mlo = lo >> 1, mhi = hi >> 1;
  const int cj0 = ty0 >> 1, ck0 = tz0 >> 1;

  auto keep_x = [&](int p) {
    const int gx = gx0 + p;
    return gx >= 1 && gx <= nx;
  };
  auto keep_yz = [&](int y, int z) {
    const int gy = gy0 + y;
    return gy >= 1 && gy <= ny && z >= z0 && z <= z1;
  };
  const int cgx0 = gx0 >> 1, cgy0 = gy0 >> 1, cnx = a.cnx, cny = a.cny,
            cnz = a.cnz;
  const int cx0 = a.cx0, cx1 = a.cx1, cy0 = a.cy0, cy1 = a.cy1,
            cz0 = a.cz0, cz1 = a.cz1;
  auto ckeep = [&](int m, int cj, int ck) {
    const int gx = cgx0 + m, gy = cgy0 + cj;
    return gx >= 1 && gx <= cnx && gy >= 1 && gy <= cny && ck >= 1 &&
           ck <= cnz;
  };
  auto in_cbox = [&](int m, int cj, int ck) {
    return m >= cx0 && m <= cx1 && cj >= cy0 && cj <= cy1 && ck >= cz0 &&
           ck <= cz1;
  };
  // Full weighting at coarse (m, cj, ck) from a three-plane fine ring:
  // x, then y, then z.
  auto restrict_at = [&](const float* ring, int m, int cj, int ck) {
    const int s0 = mod(2 * m - 1, 3) * PS, s1 = mod(2 * m, 3) * PS,
              s2 = mod(2 * m + 1, 3) * PS;
    const int c0 = (2 * cj - 1 - ry0) * PZ + (2 * ck - 1 - rz0);
    float sy3[3];
#pragma unroll
    for (int dz = 0; dz < 3; ++dz) {
      float sx[3];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const int cell = c0 + dy * PZ + dz;
        sx[dy] = weigh3(ring[s0 + cell], ring[s1 + cell], ring[s2 + cell]);
      }
      sy3[dz] = weigh3(sx[0], sx[1], sx[2]);
    }
    return weigh3(sy3[0], sy3[1], sy3[2]);
  };

  // Generation 0, f and u~ of a plane over the whole ring plane, fetched
  // into registers one step ahead, so the loads overlap the step's sweeps.
  float pv[kFetch], pf[kFetch], pn[kFetch];
  auto fetch = [&](int p) {
    const bool kx = keep_x(p);
#pragma unroll
    for (int i = 0; i < kFetch; ++i) {
      const int c = threadIdx.x + i * kLegThreads;
      if (c < PS) {
        const int sy = c / PZ;
        const int y = ry0 + sy, z = rz0 + c - sy * PZ;
        float g0 = 0.0f;
        if (kx && keep_yz(y, z)) {
          g0 = src_zero ? 0.0f : src_at<kSlabs>(sv, p, y, z, ys);
          if (corr) g0 = __fadd_rn(g0, prolong_at<kSlabs>(sc, ys, p, y, z));
        }
        pv[i] = g0;
        pf[i] = src_at<kSlabs>(sf, p, y, z, ys);
        if constexpr (M == kNewton) pn[i] = src_at<kSlabs>(snv, p, y, z, ys);
      }
    }
  };

  // This thread's cells of the ring plane, c = tid + i * kLegThreads
  // (the fetch's), described once: the depth (cells to the plane's edge:
  // generation k covers depth >= k), whether the cell is in the global y/z
  // interior and in the owned tile, and its global y/z offset.
  int info[kFetch], gyz[kFetch];
  constexpr int kKeep = 1 << 8, kOwned = 1 << 9, kValid = 1 << 10;
#pragma unroll
  for (int i = 0; i < kFetch; ++i) {
    const int c = threadIdx.x + i * kLegThreads;
    const int sy = c / PZ, sz = c - sy * PZ;
    const int y = ry0 + sy, z = rz0 + sz;
    const int depth = min(min(sy, a.PY - 1 - sy), min(sz, PZ - 1 - sz));
    info[i] = c < PS ? depth | (keep_yz(y, z) ? kKeep : 0) |
                           (y >= oy0 && y <= oy1 && z >= oz0 && z <= oz1
                                ? kOwned : 0) | kValid
                     : 0;
    gyz[i] = y * bz + z;
  }

  double ss = 0.0;
  int off[kMaxTaps];
  fetch(lo - R);
  for (int p = lo - R; p <= hi + R; ++p) {
    {
      float* g0p = gen + mod(p, 3) * PS;
      float* fp = fr + mod(p, NF) * PS;
      float* np_ = nvr + mod(p, NF) * PS;
#pragma unroll
      for (int i = 0; i < kFetch; ++i) {
        const int c = threadIdx.x + i * kLegThreads;
        if (c < PS) {
          g0p[c] = pv[i];
          fp[c] = pf[i];
          if constexpr (M == kNewton) np_[c] = pn[i];
        }
      }
    }
    __syncthreads();
    if (p < hi + R) fetch(p + 1);

    // Generation k at plane q = p - k over an (R - k)-cell ring.
    for (int k = 1; k <= S; ++k) {
      const int q = p - k, rk = R - k;
      if (q >= lo - rk && q <= hi + rk) {
        const float* src = gen + 3 * (k - 1) * PS;
        float* dst = gen + 3 * k * PS + mod(q, 3) * PS;
        const float* fq = fr + mod(q, NF) * PS;
        const float* nq = nvr + mod(q, NF) * PS;
        const float* sq = src + mod(q, 3) * PS;
        ring_offsets(off, q, PS, co);
        const bool kx = keep_x(q);
        const bool out_plane = k == S && q >= ox0 && q <= ox1;
        float* vq = v_out + (long long)q * by * bz;
        const float* rvq =
            sub_rv ? sub_rv + (long long)q * by * bz : nullptr;
#pragma unroll
        for (int i = 0; i < kFetch; ++i) {
          const int c = threadIdx.x + i * kLegThreads;
          if ((info[i] & kValid) && (info[i] & 0xff) >= k) {
            float out = 0.0f;
            if (kx && (info[i] & kKeep)) {
              const float av = ring_stencil(src, off, c, co, co.inv_h2);
              out = sweep_point<M>(av, sq[c], fq[c],
                                   M == kNewton ? nq[c] : 0.0f, co);
            }
            dst[c] = out;
            if (out_plane && (info[i] & kOwned)) {
              // FAS up legs below the chain's head write v - rest_v, one
              // float32 subtraction, as the per-leg engine's glue does.
              vq[gyz[i]] = sub_rv ? __fsub_rn(out, rvq[gyz[i]]) : out;
            }
          }
        }
      }
      __syncthreads();
    }
    if constexpr (C == kNone) continue;
    if (C == kNorm && !norm_on) continue;

    // The post-sweep residual at plane qr = p - S - 1.
    const float* gs = gen + 3 * S * PS;
    const int qr = p - S - 1;
    const float* fq = fr + mod(qr, NF) * PS;
    const float* nq = nvr + mod(qr, NF) * PS;
    const float* sq = gs + mod(qr, 3) * PS;
    ring_offsets(off, qr, PS, co);
    if constexpr (C == kNorm) {
      if (qr >= ox0 && qr <= ox1) {
#pragma unroll
        for (int i = 0; i < kFetch; ++i) {
          const int c = threadIdx.x + i * kLegThreads;
          if (info[i] & kOwned) {
            const float av = ring_stencil(gs, off, c, co, co.inv_h2);
            const float r = residual_point<M>(
                av, sq[c], fq[c], M == kNewton ? nq[c] : 0.0f, co);
            ss += (double)r * (double)r;
          }
        }
      }
      continue;
    } else {
      // Residual over a one-cell ring, 0 outside the global interior.
      if (qr >= 2 * mlo - 1 && qr <= 2 * mhi + 1) {
        const bool kx = keep_x(qr);
        float* rq = rr + mod(qr, 3) * PS;
#pragma unroll
        for (int i = 0; i < kFetch; ++i) {
          const int c = threadIdx.x + i * kLegThreads;
          if ((info[i] & kValid) && (info[i] & 0xff) >= R - 1) {
            float r = 0.0f;
            if (kx && (info[i] & kKeep)) {
              const float av = ring_stencil(gs, off, c, co, co.inv_h2);
              r = residual_point<M>(av, sq[c], fq[c],
                                    M == kNewton ? nq[c] : 0.0f, co);
            }
            rq[c] = r;
          }
        }
      }
      __syncthreads();
      // R(r) at coarse plane m once residual plane 2m + 1 is in.
      const int mr = (qr - 1) >> 1;
      if ((qr & 1) && mr >= mlo && mr <= mhi) {
        for (int c = threadIdx.x; c < kCTS; c += kLegThreads) {
          const int cj = cj0 + c / kCTZ, ck = ck0 + c % kCTZ;
          if (!in_cbox(mr, cj, ck)) continue;
          const float out = restrict_at(rr, mr, cj, ck);
          if constexpr (kFas) {
            rst[(mr & 1) * kCTS + c] = out;
          } else {
            a.fc[((long long)mr * a.cby + cj) * a.cbz + ck] = out;
          }
        }
      }
      if constexpr (kFas) {
        // Rv at coarse plane m once generation S plane 2m + 1 is in, over
        // the coarse tile and one coarse cell around it.
        const int qs = p - S;
        const int m = (qs - 1) >> 1;
        if ((qs & 1) && m >= mlo - 1 && m <= mhi + 1) {
          float* rvm = rvr + mod(m, 3) * kCPS;
          for (int c = threadIdx.x; c < kCPS; c += kLegThreads) {
            const int dj = c / kCPZ, dk = c % kCPZ;
            const int cj = cj0 - 1 + dj, ck = ck0 - 1 + dk;
            const float out = ckeep(m, cj, ck) ? restrict_at(gs, m, cj, ck)
                                               : 0.0f;
            rvm[c] = out;
            if (m >= mlo && m <= mhi && dj >= 1 && dj <= kTY / 2 &&
                dk >= 1 && dk <= kCTZ && in_cbox(m, cj, ck)) {
              const long long ci = ((long long)m * a.cby + cj) * a.cbz + ck;
              a.vc[ci] = out;
              a.rvc[ci] = out;
            }
          }
          __syncthreads();
          // The tau fold of coarse plane mt = m - 1.
          const int mt = m - 1;
          if (mt >= mlo && mt <= mhi) {
            int coff[kMaxTaps];
            const int s0 = mod(mt - 1, 3) * kCPS, s1 = mod(mt, 3) * kCPS,
                      s2 = mod(mt + 1, 3) * kCPS;
#pragma unroll
            for (int t = 0; t < kMaxTaps; ++t) {
              coff[t] = (a.ox[t] < 0 ? s0 : a.ox[t] > 0 ? s2 : s1) +
                        a.oy[t] * kCPZ + a.oz[t];
            }
            for (int c = threadIdx.x; c < kCTS; c += kLegThreads) {
              const int dj = c / kCTZ, dk = c % kCTZ;
              const int cj = cj0 + dj, ck = ck0 + dk;
              if (!in_cbox(mt, cj, ck)) continue;
              const int cell = (dj + 1) * kCPZ + dk + 1;
              const float av = ring_stencil(rvr, coff, cell, co, a.inv_h2c);
              const float rb = rvr[s1 + cell];
              const float tau = __fadd_rn(av, fas_term(rb, expf(rb),
                                                       co.gamma));
              a.fc[((long long)mt * a.cby + cj) * a.cbz + ck] =
                  __fadd_rn(rst[(mt & 1) * kCTS + c], tau);
            }
          }
        }
      }
      __syncthreads();
    }
  }
  if constexpr (C == kNorm) {
    if (norm_on) {
      const double total = block_sum(ss);
      if (threadIdx.x == 0) {
        a.partials[slot] = total;
      }
    }
  }
}

// Shared-memory floats of a launch.
long long leg_smem_floats(int mode, int consumer, int S, int PS) {
  long long n = (long long)3 * (S + 1) * PS + (long long)(S + 3) * PS;
  if (mode == kNewton) n += (long long)(S + 3) * PS;
  if (consumer == kRestrict) {
    n += 3LL * PS;
    if (mode == kNonlinear) {
      n += 3LL * (kTY / 2 + 2) * (kTZ / 2 + 2) + 2LL * (kTY / 2) * (kTZ / 2);
    }
  }
  return n;
}

Src make_src(const void* const* p, int bx, int by, int bz, int g) {
  Src s;
  s.core = static_cast<const float*>(p[0]);
  s.xlo = static_cast<const float*>(p[1]);
  s.xhi = static_cast<const float*>(p[2]);
  s.ylo = static_cast<const float*>(p[3]);
  s.yhi = static_cast<const float*>(p[4]);
  s.bx = bx;
  s.by = by;
  s.bz = bz;
  s.g = g;
  return s;
}

// The launch geometry from the int arguments (see mg_leg_block): fills
// the tiling and ring fields of `a` and returns the grid.
dim3 leg_geometry(const int* iv, LegArgs& a) {
  const int mode = iv[0], consumer = iv[1];
  a.bx = iv[7];
  a.by = iv[8];
  a.bz = iv[9];
  a.x0 = iv[10];
  a.x1 = iv[11];
  a.y0 = iv[12];
  a.y1 = iv[13];
  a.z0 = iv[14];
  a.z1 = iv[15];
  a.S = iv[4];
  a.X0 = a.x0 & ~1;
  a.Y0 = a.y0 & ~1;
  a.Z0 = a.z0 & ~1;
  a.R = a.S + reach(mode, consumer);
  a.PY = kTY + 2 * a.R;
  a.PZ = kTZ + 2 * a.R;
  return dim3((a.z1 - a.Z0 + kTZ) / kTZ, (a.y1 - a.Y0 + kTY) / kTY,
              (a.x1 - a.X0 + kCX) / kCX);
}

// The leg's arguments from the C interface's arrays (see mg_leg_block):
// fills `a` and returns its grid of tiles; *smem_bytes gets the dynamic
// shared memory of a launch.
dim3 leg_args(const void* const* ptrs, const int* iv, const float* fv,
              const float* tap_val, const int* tap_off3, int ntaps,
              LegArgs& a, long long* smem_bytes) {
  const dim3 grid = leg_geometry(iv, a);
  a.ysplit = iv[3];
  a.src_zero = iv[5];
  a.corr = iv[6];
  a.gx0 = iv[16];
  a.nx = iv[17];
  a.gy0 = iv[18];
  a.ny = iv[19];
  a.cby = iv[20];
  a.cbz = iv[21];
  a.cx0 = iv[22];
  a.cx1 = iv[23];
  a.cy0 = iv[24];
  a.cy1 = iv[25];
  a.cz0 = iv[26];
  a.cz1 = iv[27];
  a.cnx = iv[28];
  a.cny = iv[29];
  a.cnz = iv[30];
  a.v_out = static_cast<float*>(const_cast<void*>(ptrs[0]));
  a.v = make_src(ptrs + 1, a.bx, a.by, a.bz, kG);
  a.f = make_src(ptrs + 6, a.bx, a.by, a.bz, kG);
  a.nv = make_src(ptrs + 11, a.bx, a.by, a.bz, kG);
  a.c = make_src(ptrs + 16, a.bx / 2, a.cby, a.cbz, kGC);
  a.partials = static_cast<double*>(const_cast<void*>(ptrs[21]));
  a.fc = static_cast<float*>(const_cast<void*>(ptrs[22]));
  a.vc = static_cast<float*>(const_cast<void*>(ptrs[23]));
  a.rvc = static_cast<float*>(const_cast<void*>(ptrs[24]));
  a.sub_rv = static_cast<const float*>(ptrs[25]);
  a.inv_h2 = fv[0];
  a.alpha = fv[1];
  a.omega = fv[2];
  a.gamma = fv[3];
  a.pre_fac = fv[4];
  a.inv_h2c = fv[5];
  for (int t = 0; t < kMaxTaps; ++t) {
    a.val[t] = t < ntaps ? tap_val[t] : 0.0f;
    a.ox[t] = t < ntaps ? tap_off3[3 * t] : 0;
    a.oy[t] = t < ntaps ? tap_off3[3 * t + 1] : 0;
    a.oz[t] = t < ntaps ? tap_off3[3 * t + 2] : 0;
    a.toff[t] = a.oy[t] * a.PZ + a.oz[t];
  }
  *smem_bytes = 4 * leg_smem_floats(iv[0], iv[1], a.S, a.PY * a.PZ);
  return grid;
}

// Whether the int arguments name a leg the kernels take.
bool leg_args_ok(const int* iv, int ntaps) {
  return ntaps >= 1 && ntaps <= kMaxTaps && iv[4] >= 1 && iv[4] <= kMaxS &&
         iv[0] >= kLinear && iv[0] <= kNewton && iv[1] >= kNone &&
         iv[1] <= kRestrict;
}

}  // namespace
