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
constexpr int kCX = 128;  // x-planes a block owns (even)
constexpr int kLegThreads = 256;
// Ring-plane cells a thread owns (its slots): the plane is at most
// (kTY + 2 kG) x (kTZ + 2 kG).
constexpr int kSlots =
    ((kTY + 2 * kG) * (kTZ + 2 * kG) + kLegThreads - 1) / kLegThreads;
constexpr int kMaxS = 5;
static_assert(kSlots % 2 == 0, "the sweeps take slots two at a time");
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
  int canon;  // taps (0,0,0), (1,0,0), (-1,0,0), (0,1,0), (0,-1,0),
              // (0,0,1), (0,0,-1), in that order
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

__device__ __forceinline__ int mod(int q, int n) {
  const int r = q % n;
  return r < 0 ? r + n : r;
}

__device__ __forceinline__ float weigh3(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(0.25f, a), __fmul_rn(0.5f, b)),
                   __fmul_rn(0.25f, c));
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

// The planes of generation S's ring: none with no consumer (generation S
// goes only to v_out), three else.
__host__ __device__ constexpr int gen_s_planes(int consumer) {
  return consumer == kNone ? 0 : 3;
}

// Cells of a PY x PZ ring plane at depth d or more (d cells or more from
// its edge): the rectangle [d, PY - d) x [d, PZ - d).
__device__ __forceinline__ int onion_count(int PY, int PZ, int d) {
  return (PY - 2 * d) * (PZ - 2 * d);
}

// The cell (sy, sz) of onion index s < PY * PZ of a ring plane whose
// cells R deep or more are the tile: the tile first (row-major), then the
// ring one cell shallower (its top row, its bottom row, its left and its
// right column), and so on out to depth 0.  So the cells of depth >= d
// are exactly the indices below onion_count(PY, PZ, d).
__device__ __forceinline__ void onion_cell(int s, int PY, int PZ, int R,
                                           int& sy, int& sz) {
  const int tw = PZ - 2 * R;
  if (s < onion_count(PY, PZ, R)) {
    sy = R + s / tw;
    sz = R + s % tw;
    return;
  }
  int d = R - 1;
  while (d > 0 && s >= onion_count(PY, PZ, d)) --d;
  const int j = s - onion_count(PY, PZ, d + 1);
  const int w = PZ - 2 * d, h = PY - 2 * d - 2;
  if (j < w) {
    sy = d;
    sz = d + j;
  } else if (j < 2 * w) {
    sy = PY - 1 - d;
    sz = d + j - w;
  } else if (j < 2 * w + h) {
    sy = d + 1 + j - 2 * w;
    sz = d;
  } else {
    sy = d + 1 + j - 2 * w - h;
    sz = PZ - 1 - d;
  }
}

// A field's plane p, uniform over the block: b0 the block's plane (or,
// with xs, the x slab's), b1 / b2 the lower / upper y slab's (null where
// absent: the plane reads 0).
struct PlaneSrc {
  const float* b0;
  const float* b1;
  const float* b2;
  bool xs;
};

template <bool kSlabs>
__device__ __forceinline__ PlaneSrc plane_src(const Src& s, int p, bool ys) {
  PlaneSrc r{nullptr, nullptr, nullptr, false};
  if (p >= 0 && p < s.bx) {
    r.b0 = s.core + (long long)p * s.by * s.bz;
    if (kSlabs && ys) {
      r.b1 = s.ylo + (long long)p * s.g * s.bz;
      r.b2 = s.yhi + (long long)p * s.g * s.bz;
    }
  } else if (kSlabs) {
    const long long rows = s.by + (ys ? 2 * s.g : 0);
    r.xs = true;
    if (p < 0 && p >= -s.g) {
      r.b0 = s.xlo + (long long)(p + s.g) * rows * s.bz;
    } else if (p >= s.bx && p < s.bx + s.g) {
      r.b0 = s.xhi + (long long)(p - s.bx) * rows * s.bz;
    }
  }
  return r;
}

// The row kinds of a cell: the block's rows, the lower and the upper y
// slab's, or none (reads 0).
constexpr int kRowBlock = 0, kRowYlo = 1, kRowYhi = 2, kRowNone = 3;

// The field of plane `ps` at a cell of row kind `kind` and offset `off`
// in a plane of that kind.  In an x slab's plane (rows -gy..by + gy - 1)
// the cell's offset is off plus xadd[kind]: gy bz for the block's rows, 0
// for the lower y slab's, (by + gy) bz for the upper's.
template <bool kSlabs>
__device__ __forceinline__ float plane_load(const PlaneSrc& ps, int kind,
                                            int off, const int xadd[3]) {
  if (ps.b0 == nullptr || kind == kRowNone) return 0.0f;
  if (kSlabs && ps.xs) {
    return ps.b0[off + (kind == kRowBlock ? xadd[0]
                        : kind == kRowYlo ? xadd[1] : xadd[2])];
  }
  if (kind == kRowBlock) return ps.b0[off];
  if (kSlabs && kind == kRowYlo) return ps.b1[off];
  if (kSlabs && kind == kRowYhi) return ps.b2[off];
  return 0.0f;
}

// The field at (y, z) of plane `ps` of a block (by, bz, slab depth g).
template <bool kSlabs>
__device__ __forceinline__ float cell_load(const PlaneSrc& ps, int y, int z,
                                           int by, int bz, int g, bool ys) {
  if (z < 0 || z >= bz) return 0.0f;
  const int gy = kSlabs && ys ? g : 0;
  if (kSlabs && ps.xs) {
    return ps.b0 != nullptr && y >= -gy && y < by + gy
               ? ps.b0[(y + gy) * bz + z] : 0.0f;
  }
  if (ps.b0 == nullptr) return 0.0f;
  if (y >= 0 && y < by) return ps.b0[y * bz + z];
  if (kSlabs && ys && y < 0 && y >= -g) return ps.b1[(y + g) * bz + z];
  if (kSlabs && ys && y >= by && y < by + g) return ps.b2[(y - by) * bz + z];
  return 0.0f;
}

// One tile of a leg: the (y, z) tile (ty, tz) of the box and x-chunk tx,
// as one block of kLegThreads threads; `sm` is the launch's dynamic shared
// memory and `slot` the tile's index among its launch's (its norm
// partial).  The block's threads call it together; it ends with every
// thread past its last read of shared memory but for the norm's
// block_sum, so a block that runs another tile next must __syncthreads()
// first.
//
// The ring plane's cells are dealt to the threads in onion order (cell s
// of the order to slot s / kLegThreads, of thread s mod kLegThreads, or
// counting backwards in the odd slots: sidx), so the cells of depth >= k
// are the onion indices below onion_count(k): a warp whose cells are all
// shallower than a generation's ring skips it whole.
// A thread owns the same cells in every plane and every generation.  The
// x taps of a face-tap stencil (the only stencils a leg takes) read the
// thread's own cells; only the in-plane taps read other threads' cells,
// and those only of planes finished in an earlier step.  So one barrier a
// step (at its top) orders everything: step p stores generation 0 at
// plane p, computes generation k at plane p - k for k = 1..S, the
// residual at p - S - 1, and the consumers that read a neighbour's cells
// (R(r), R(v), the tau fold) run one step after the planes they read were
// written.  f and u~ are read at the thread's own cells only: rings of
// S + 2 planes (S + 1 without a consumer) that no other thread reads.
template <int M, int C, bool kSlabs, bool kCanon>
__device__ __forceinline__ void leg_tile(const LegArgs& a, float* sm, int tz,
                                         int ty, int tx, long long slot) {
  constexpr bool kFas = M == kNonlinear && C == kRestrict;
  constexpr int kCPY = kTY / 2 + 2, kCPZ = kTZ / 2 + 2;
  constexpr int kCPS = kCPY * kCPZ;
  constexpr int kCTZ = kTZ / 2, kCTS = (kTY / 2) * kCTZ;
  constexpr int kGS = gen_s_planes(C);
  constexpr int kOwnedCells = kTY * kTZ;
  // Two slots at a time but in the generic-tap slab-reading legs, which
  // would spill with the registers of two.
  constexpr bool kPairs = kCanon || !kSlabs;
  const int S = a.S, R = a.R, PY = a.PY, PZ = a.PZ, PS = PY * PZ;
  const int NF = S + (C == kNone ? 1 : 2);
  const bool ys = a.ysplit;
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
  // Generation k < S: a three-plane ring at 3k planes; generation S: kGS
  // planes after them; then the f (and u~) rings of NF planes; for the
  // restriction the residual's two planes (read by their own thread), the
  // x-restricted residual's plane (xr) and in FAS generation S's (xv), the
  // FAS R(v) ring and the R(r) staging.
  float* const gen = sm;
  float* const fr = gen + (3 * S + kGS) * PS;
  float* const nvr = fr + NF * PS;
  float* const rr = nvr + (M == kNewton ? NF * PS : 0);
  float* const xr = rr + 2 * PS;
  float* const xv = xr + PS;
  float* const rvr = xv + (kFas ? PS : 0);
  float* const rst = rvr + 3 * kCPS;
  // Generation k's plane q: its offset in gen.
  auto ring = [&](int k, int q) {
    return (k < S ? 3 * k + mod(q, 3) : 3 * S + mod(q, kGS > 0 ? kGS : 1)) *
           PS;
  };

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
  // Full weighting at coarse (cj, ck), x, then y, then z: its y and z
  // passes over `xp`, the plane of fine cells already weighted along x
  // (planes 2m - 1, 2m, 2m + 1, each cell by its own thread).
  auto restrict_yz = [&](const float* xp, int cj, int ck) {
    const float* c0 = xp + (2 * cj - 1 - ry0) * PZ + (2 * ck - 1 - rz0);
    float sy3[3];
#pragma unroll
    for (int dz = 0; dz < 3; ++dz) {
      sy3[dz] = weigh3(c0[dz], c0[PZ + dz], c0[2 * PZ + dz]);
    }
    return weigh3(sy3[0], sy3[1], sy3[2]);
  };

  // This thread's cells, described once: the cell in the ring plane with
  // whether it is in the global y/z interior and owned (in the tile and
  // the box) and its row kind (info), its offset in a plane of the block
  // or of its y slab (yzo; for an owned cell its offset in v_out's plane).
  constexpr int kCellMask = 0xffff, kKeep = 1 << 16, kOwned = 1 << 17;
  constexpr int kKindShift = 18;
  // Slot i's onion index: the odd slots deal the threads backwards, so
  // the partly filled slots of the generations (their cells of one depth)
  // fall on different warps, and no warp takes every generation's extra
  // slot.
  auto sidx = [](int i) {
    return i * kLegThreads + ((i & 1) ? kLegThreads - 1 - (int)threadIdx.x
                                      : (int)threadIdx.x);
  };
  // ca: the shared address of the cell in gen's first plane, so a plane
  // at offset o (floats from gen) holds the cell at ca + 4 o.
  int info[kSlots], yzo[kSlots];
  unsigned ca[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int s = sidx(i);
    int sy = 0, sz = 0;
    if (s < PS) onion_cell(s, PY, PZ, R, sy, sz);
    ca[i] = smem_addr(gen + sy * PZ + sz);
    const int y = ry0 + sy, z = rz0 + sz;
    const bool zin = z >= 0 && z < bz;
    int kind = kRowNone, off = 0;
    if (zin && y >= 0 && y < by) {
      kind = kRowBlock;
      off = y * bz + z;
    } else if (kSlabs && ys && zin && y < 0 && y >= -kG) {
      kind = kRowYlo;
      off = (y + kG) * bz + z;
    } else if (kSlabs && ys && zin && y >= by && y < by + kG) {
      kind = kRowYhi;
      off = (y - by) * bz + z;
    }
    info[i] = (sy * PZ + sz) | (keep_yz(y, z) ? kKeep : 0) |
              (s < kOwnedCells && y >= oy0 && y <= oy1 && z >= oz0 &&
                       z <= oz1
                   ? kOwned : 0) |
              kind << kKindShift;
    yzo[i] = off;
  }
  const float inv_pz = 1.0f / PZ;
  const int xadd[3] = {ys ? kG * bz : 0, 0, ys ? (by + kG) * bz : 0};

  // Generation 0, f and u~ of plane p at this thread's cells, fetched into
  // registers one step ahead, so the loads overlap the step's sweeps.
  float pv[kSlots], pf_[kSlots], pn[kSlots];
  auto fetch = [&](int p) {
    const bool kx = keep_x(p);
    // The fields' pointers come from the parameters each step, not from
    // registers held across it.
    const PlaneSrc vs = plane_src<kSlabs>(a.v, p, ys);
    const PlaneSrc fs = plane_src<kSlabs>(a.f, p, ys);
    const PlaneSrc ns = plane_src<kSlabs>(a.nv, p, ys);
    // The coarse planes of the prolongation: p / 2 and (p + 1) / 2.
    const Src& sc = a.c;
    const PlaneSrc pa = plane_src<kSlabs>(sc, p >> 1, ys);
    const PlaneSrc pb = plane_src<kSlabs>(sc, (p + 1) >> 1, ys);
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      if (sidx(i) < PS) {
        const int kind = info[i] >> kKindShift & 3;
        float g0 = 0.0f;
        if (kx && (info[i] & kKeep)) {
          g0 = src_zero ? 0.0f
                        : plane_load<kSlabs>(vs, kind, yzo[i], xadd);
          if (corr) {
            // P(coarse): coarse y/2, (y+1)/2 and z/2, (z+1)/2, midpoints
            // along x, then y, then z.
            const int cell = info[i] & kCellMask;
            const int sy = __float2int_rz(((float)cell + 0.5f) * inv_pz);
            const int y = ry0 + sy, z = rz0 + cell - sy * PZ;
            const int ya = y >> 1, yb = (y + 1) >> 1;
            float ym[2];
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const int zc = (z + q) >> 1;
              const float ma = mid(
                  cell_load<kSlabs>(pa, ya, zc, sc.by, sc.bz, sc.g, ys),
                  cell_load<kSlabs>(pb, ya, zc, sc.by, sc.bz, sc.g, ys));
              const float mb = mid(
                  cell_load<kSlabs>(pa, yb, zc, sc.by, sc.bz, sc.g, ys),
                  cell_load<kSlabs>(pb, yb, zc, sc.by, sc.bz, sc.g, ys));
              ym[q] = mid(ma, mb);
            }
            g0 = __fadd_rn(g0, mid(ym[0], ym[1]));
          }
        }
        pv[i] = g0;
        pf_[i] = plane_load<kSlabs>(fs, kind, yzo[i], xadd);
        if constexpr (M == kNewton) {
          pn[i] = plane_load<kSlabs>(ns, kind, yzo[i], xadd);
        }
      }
    }
  };

  // The last step: the FAS tau fold of coarse plane mhi runs two steps
  // after the residual's last plane, R(r) one step after it.
  const int pend =
      C == kRestrict ? max(hi + R, 2 * mhi + S + (kFas ? 5 : 3)) : hi + R;
  double ss = 0.0;
  // A sweep's or the residual's taps as byte offsets from a cell's address
  // in gen's first plane: generation k - 1's planes q - 1, q and q + 1
  // at (s0, s1, s2) floats from gen.
  unsigned dt[kMaxTaps];
  auto tap_offsets = [&](int s0, int s1, int s2) {
#pragma unroll
    for (int t = 0; t < kMaxTaps; ++t) {
      dt[t] = 4u * (unsigned)((co.ox[t] < 0 ? s0 : co.ox[t] > 0 ? s2 : s1) +
                              co.toff[t]);
    }
  };
  const unsigned dpz = 4u * PZ;
  // The value this thread computed at slot i in this step for the
  // generation below (generation 0: the plane it stored): a canonical
  // stencil's x + 1 tap.
  float carry[kSlots];
  // A g / h^2 at slot i of the plane at byte offset dc (its centre value
  // in cv), in tap order: every tap loaded before the sum starts; the host
  // pads a stencil of fewer taps with zero-valued centre taps, whose +0
  // terms leave the sum as it is.  kCanon: the canonical taps, the z
  // neighbours at immediate offsets, x - 1 at dxm, x + 1 from carry.
  auto stencil = [&](int i, unsigned dc, unsigned dxm, float inv,
                     float& cv) {
    float g[kMaxTaps];
    if constexpr (kCanon) {
      const unsigned zm = ca[i] + dc - 4u;
      g[0] = lds_at<4>(zm);
      g[1] = carry[i];
      g[2] = lds(ca[i] + dxm);
      g[3] = lds_at<4>(zm + dpz);
      g[4] = lds_at<4>(zm - dpz);
      g[5] = lds_at<8>(zm);
      g[6] = lds(zm);
      cv = g[0];
    } else {
#pragma unroll
      for (int t = 0; t < kMaxTaps; ++t) g[t] = lds(ca[i] + dt[t]);
      cv = lds(ca[i] + dc);
    }
    float acc = __fmul_rn(co.val[0], g[0]);
#pragma unroll
    for (int t = 1; t < kMaxTaps; ++t) {
      acc = __fadd_rn(acc, __fmul_rn(co.val[t], g[t]));
    }
    return __fmul_rn(acc, inv);
  };
  // mod(p, NF), kept step by step: the f rings' slot of plane p - k is
  // pf - k, plus NF below 0 (k <= NF).
  int pf = mod(lo - R, NF);
  auto fslot = [&](int k) { return pf - k < 0 ? pf - k + NF : pf - k; };

  // Generation k at plane q = p - k over an (R - k)-cell ring: the cells
  // of depth >= k, the slots below nk.  Two slots at a time where both are
  // in the ring, so their loads and arithmetic overlap.
  auto sweeps = [&](int p) {
    for (int k = 1; k <= S; ++k) {
      const int q = p - k, rk = R - k;
      if (q < lo - rk || q > hi + rk) continue;
      const int s0 = ring(k - 1, q - 1), s1 = ring(k - 1, q);
      if (!kCanon) tap_offsets(s0, s1, ring(k - 1, q + 1));
      const unsigned dc = 4u * s1, dxm = 4u * s0, dd = 4u * ring(k, q);
      const unsigned df = 4u * (unsigned)(fr - gen + fslot(k) * PS);
      const unsigned dn = 4u * (unsigned)(nvr - gen + fslot(k) * PS);
      const bool store = C != kNone || k < S;
      const int nk = onion_count(PY, PZ, k);
      const bool kx = keep_x(q);
      const bool out_plane = k == S && q >= ox0 && q <= ox1;
      // FAS: generation S at odd plane 2m + 1 weighted along x with its
      // planes 2m - 1 and 2m, for R(v) at coarse plane m in the next step.
      const int mv = (q - 1) >> 1;
      const bool xstage = kFas && k == S && (q & 1) && mv >= mlo - 1 &&
                          mv <= mhi + 1;
      const unsigned dx2 = 4u * ring(k, q - 2), dx1 = 4u * ring(k, q - 1);
      const unsigned dxv = 4u * (unsigned)(xv - gen);
      float* vq = v_out + (long long)q * by * bz;
      const float* rvq = sub_rv ? sub_rv + (long long)q * by * bz : nullptr;
      // Slots j and j + 1 (N = 2) or slot j alone (N = 1).
      auto sweep = [&](auto n, int j) {
        constexpr int N = decltype(n)::value;
        float out[N];
#pragma unroll
        for (int u = 0; u < N; ++u) {
          const int i = j + u;
          float cv;
          const float av = stencil(i, dc, dxm, co.inv_h2, cv);
          const float o = sweep_point<M>(
              av, cv, lds(ca[i] + df), M == kNewton ? lds(ca[i] + dn) : 0.0f,
              co);
          out[u] = kx && (info[i] & kKeep) ? o : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < N; ++u) {
          const int i = j + u;
          if (store) sts(ca[i] + dd, out[u]);
          if (kCanon) carry[i] = out[u];
          if (xstage) {
            sts(ca[i] + dxv,
                weigh3(lds(ca[i] + dx2), lds(ca[i] + dx1), out[u]));
          }
          if (out_plane && (info[i] & kOwned)) {
            // FAS up legs below the chain's head write v - rest_v, one
            // float32 subtraction, as the per-leg engine's glue does.
            vq[yzo[i]] = sub_rv ? __fsub_rn(out[u], rvq[yzo[i]]) : out[u];
          }
        }
      };
#pragma unroll
      for (int j = 0; j < kSlots; j += 2) {
        if (kPairs && sidx(j + 1) < nk) {
          sweep(std::integral_constant<int, 2>{}, j);
        } else {
          if (sidx(j) < nk) sweep(std::integral_constant<int, 1>{}, j);
          if (!kPairs && sidx(j + 1) < nk) {
            sweep(std::integral_constant<int, 1>{}, j + 1);
          }
        }
      }
    }
  };

  fetch(lo - R);
  for (int p = lo - R; p <= pend; ++p, pf = pf + 1 == NF ? 0 : pf + 1) {
    // The step's one barrier: every cell another thread reads below was
    // written in an earlier step, and no slot written below is one another
    // thread read in the step before.
    __syncthreads();
    if (p <= hi + R) {
      const unsigned g0p = 4u * ring(0, p);
      const unsigned fp = 4u * (unsigned)(fr - gen + pf * PS);
      const unsigned np_ = 4u * (unsigned)(nvr - gen + pf * PS);
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        if (sidx(i) < PS) {
          sts(ca[i] + g0p, pv[i]);
          sts(ca[i] + fp, pf_[i]);
          if constexpr (M == kNewton) sts(ca[i] + np_, pn[i]);
          carry[i] = pv[i];
        }
      }
      if (p < hi + R) fetch(p + 1);
    }
    sweeps(p);
    if constexpr (C == kNone) continue;
    if (C == kNorm && !norm_on) continue;

    // The post-sweep residual at plane qr = p - S - 1 (its x + 1 tap:
    // generation S at p - S, this step's).
    const int qr = p - S - 1;
    const int s0 = ring(S, qr - 1), s1 = ring(S, qr);
    if (!kCanon) tap_offsets(s0, s1, ring(S, qr + 1));
    const unsigned dc = 4u * s1, dxm = 4u * s0;
    const unsigned df = 4u * (unsigned)(fr - gen + fslot(S + 1) * PS);
    const unsigned dn = 4u * (unsigned)(nvr - gen + fslot(S + 1) * PS);
    auto residual = [&](int i) {
      float cv;
      const float av = stencil(i, dc, dxm, co.inv_h2, cv);
      return residual_point<M>(av, cv, lds(ca[i] + df),
                               M == kNewton ? lds(ca[i] + dn) : 0.0f, co);
    };
    if constexpr (C == kNorm) {
      if (qr >= ox0 && qr <= ox1) {
#pragma unroll
        for (int j = 0; j < kSlots; j += 2) {
          if (sidx(j) >= kOwnedCells) continue;
          const float r0 = residual(j), r1 = residual(j + 1);
          if (info[j] & kOwned) ss += (double)r0 * (double)r0;
          if (info[j + 1] & kOwned) ss += (double)r1 * (double)r1;
        }
      }
    } else {
      // Residual over a one-cell ring (depth >= R - 1), 0 outside the
      // global interior.
      if (qr >= 2 * mlo - 1 && qr <= 2 * mhi + 1) {
        const bool kx = keep_x(qr);
        // The residual's planes qr - 2 and qr - 1 (this thread's cells):
        // plane qr goes where qr - 2 was, once read.
        const unsigned dr0 = 4u * (unsigned)(rr - gen + (qr & 1) * PS);
        const unsigned dr1 = 4u * (unsigned)(rr - gen + (~qr & 1) * PS);
        const unsigned dxr = 4u * (unsigned)(xr - gen);
        // Odd plane 2m + 1: weighted along x with planes 2m - 1 and 2m,
        // for R(r) at coarse plane m in the next step.
        const bool xstage = (qr & 1) && qr >= 2 * mlo + 1;
        const int nr = onion_count(PY, PZ, R - 1);
        auto resid = [&](auto n, int j) {
          constexpr int N = decltype(n)::value;
          float out[N];
#pragma unroll
          for (int u = 0; u < N; ++u) {
            const float r = residual(j + u);
            out[u] = kx && (info[j + u] & kKeep) ? r : 0.0f;
          }
#pragma unroll
          for (int u = 0; u < N; ++u) {
            const unsigned c = ca[j + u];
            if (xstage) {
              sts(c + dxr, weigh3(lds(c + dr0), lds(c + dr1), out[u]));
            }
            sts(c + dr0, out[u]);
          }
        };
#pragma unroll
        for (int j = 0; j < kSlots; j += 2) {
          if (kPairs && sidx(j + 1) < nr) {
            resid(std::integral_constant<int, 2>{}, j);
          } else {
            if (sidx(j) < nr) resid(std::integral_constant<int, 1>{}, j);
            if (!kPairs && sidx(j + 1) < nr) {
              resid(std::integral_constant<int, 1>{}, j + 1);
            }
          }
        }
      }
      // R(r) at coarse plane mr: residual plane 2mr + 1 = qr - 1 was
      // weighted along x in the step before.
      const int qd = qr - 1;
      const int mr = (qd - 1) >> 1;
      if ((qd & 1) && mr >= mlo && mr <= mhi) {
        for (int c = threadIdx.x; c < kCTS; c += kLegThreads) {
          const int cj = cj0 + c / kCTZ, ck = ck0 + c % kCTZ;
          if (!in_cbox(mr, cj, ck)) continue;
          const float out = restrict_yz(xr, cj, ck);
          if constexpr (kFas) {
            // Staged for the tau fold two steps on.
            rst[(mr & 1) * kCTS + c] = out;
          } else {
            a.fc[((long long)mr * a.cby + cj) * a.cbz + ck] = out;
          }
        }
      }
      if constexpr (kFas) {
        // Rv at coarse plane m, over the coarse tile and one coarse cell
        // around it: generation S plane 2m + 1 = p - S - 1 was weighted
        // along x in the step before.
        const int qs = p - S - 1;
        const int m = (qs - 1) >> 1;
        if ((qs & 1) && m >= mlo - 1 && m <= mhi + 1) {
          float* rvm = rvr + mod(m, 3) * kCPS;
          for (int c = threadIdx.x; c < kCPS; c += kLegThreads) {
            const int dj = c / kCPZ, dk = c % kCPZ;
            const int cj = cj0 - 1 + dj, ck = ck0 - 1 + dk;
            const float out =
                ckeep(m, cj, ck) ? restrict_yz(xv, cj, ck) : 0.0f;
            rvm[c] = out;
            if (m >= mlo && m <= mhi && dj >= 1 && dj <= kTY / 2 &&
                dk >= 1 && dk <= kCTZ && in_cbox(m, cj, ck)) {
              const long long ci = ((long long)m * a.cby + cj) * a.cbz + ck;
              a.vc[ci] = out;
              a.rvc[ci] = out;
            }
          }
        }
        // The tau fold of coarse plane mt: Rv at plane mt + 1, whose fine
        // plane 2mt + 3 = p - S - 2, was written in the step before.
        const int qt = p - S - 2;
        const int mt = ((qt - 1) >> 1) - 1;
        if ((qt & 1) && mt >= mlo && mt <= mhi) {
          int coff[kMaxTaps];
          const int t0 = mod(mt - 1, 3) * kCPS, t1 = mod(mt, 3) * kCPS,
                    t2 = mod(mt + 1, 3) * kCPS;
#pragma unroll
          for (int t = 0; t < kMaxTaps; ++t) {
            coff[t] = (a.ox[t] < 0 ? t0 : a.ox[t] > 0 ? t2 : t1) +
                      a.oy[t] * kCPZ + a.oz[t];
          }
          // On the threads of the block's other half, beside R(r) on the
          // first (R(r) and the tau fold run in the same steps).
          for (int c = (threadIdx.x + kLegThreads / 2) % kLegThreads;
               c < kCTS; c += kLegThreads) {
            const int dj = c / kCTZ, dk = c % kCTZ;
            const int cj = cj0 + dj, ck = ck0 + dk;
            if (!in_cbox(mt, cj, ck)) continue;
            const int cell = (dj + 1) * kCPZ + dk + 1;
            const float av = ring_stencil(rvr, coff, cell, co, a.inv_h2c);
            const float rb = rvr[t1 + cell];
            const float tau = __fadd_rn(av, fas_term(rb, expf(rb),
                                                     co.gamma));
            a.fc[((long long)mt * a.cby + cj) * a.cbz + ck] =
                __fadd_rn(rst[(mt & 1) * kCTS + c], tau);
          }
        }
      }
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

// Shared-memory floats of a launch: the generations' rings, the f (and
// u~) rings, and for the restriction the residual's two planes and the
// x-restricted plane (FAS two: r and v), the R(v) ring and the R(r)
// staging (leg_tile's layout).
long long leg_smem_floats(int mode, int consumer, int S, int PS) {
  const long long nf = S + (consumer == kNone ? 1 : 2);
  long long n = (long long)(3 * S + gen_s_planes(consumer)) * PS + nf * PS;
  if (mode == kNewton) n += nf * PS;
  if (consumer == kRestrict) {
    n += (mode == kNonlinear ? 4LL : 3LL) * PS;
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
  a.canon = canonical_taps(tap_off3, ntaps);
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
