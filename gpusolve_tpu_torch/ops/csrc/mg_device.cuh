// Device arithmetic shared by the per-op multigrid kernels (multigrid.cu)
// and the whole-V-cycle cooperative kernel (vcycle_fused.cu).
//
// Each point function rounds every product, sum and quotient as its own
// operation (__fmul_rn / __fadd_rn / __fdiv_rn keep nvcc from contracting
// them into FMAs), in the operation order of the plain PyTorch version
// (ops/ref.py, itself the order of gpusolve_tpu/ops/xla.py), with the
// accurate expf, never __expf; never build with --use_fast_math.  Both
// kernels call the same functions, so a V-cycle of the cooperative kernel
// equals the per-op kernels' V-cycle bit for bit.
//
// Loads go through a policy:
//   LdNC     through the read-only cache (__ldg): the per-op kernels'
//            stencil and transfer taps, whose inputs no launch writes, and
//            the cooperative kernel's loads of a field that no op of the
//            cycle writes (level 0's f, NEWTON's u~);
//   LdPlain  plain loads: the cooperative kernel's loads of a field that
//            some op of the cycle writes (the read-only cache is not
//            coherent with writes made during the same launch);
//   LdZero   every v value is 0 without a load: the first sweep of a level
//            that starts from v = 0.
//
// A tile is the box one block of the per-op kernels covers: a 32(z) x 8(y)
// column of threads walking kXCH = 8 x-planes; (bx, by, bz) is that block's
// index and (tz, ty) the thread's.  The per-op kernels pass blockIdx and
// threadIdx; the cooperative kernel walks the same tiles in a grid-stride
// loop.
//
// Array model: a level is a dense (nx+2, ny+2, nz+2) float32 array, z
// contiguous, with a zero halo that no kernel ever writes.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTaps = 7;   // the config format's 7-point stencil
constexpr int kBZ = 32;       // threads along z (contiguous)
constexpr int kBY = 8;        // threads along y
constexpr int kXCH = 8;       // x-planes walked by one block
constexpr int kThreads = kBZ * kBY;
constexpr int kFinThreads = 1024;

// Solver modes, as config.Mode numbers them.
constexpr int kLinear = 0;
constexpr int kNonlinear = 1;
constexpr int kNewton = 2;

struct Taps {
  float val[kMaxTaps];
  // Linear element offset of each tap: |off| <= sx + sy + 1, which fits an
  // int for any plane a card can hold.
  int off[kMaxTaps];
  int n;
};

struct Geom {  // interior dims and strides of one padded level
  int nx, ny, nz;
  long long sx, sy;
};

// The mode's scalars, each rounded once to float32 on the host as the
// plain version's tensor-scalar ops round them.
struct ModeArgs {
  float gamma;
  float pre_fac;  // values[0] / h^2 (the FAS and Newton Jacobi denominator)
};

__host__ __device__ inline Geom make_geom(int nx, int ny, int nz) {
  Geom g;
  g.nx = nx;
  g.ny = ny;
  g.nz = nz;
  g.sy = nz + 2;
  g.sx = (long long)(ny + 2) * (nz + 2);
  return g;
}

// Blocks (tiles) of a stencil or restriction pass over a level.
__host__ __device__ inline dim3 grid_for(const Geom& g) {
  return dim3((g.nz + kBZ - 1) / kBZ, (g.ny + kBY - 1) / kBY,
              (g.nx + kXCH - 1) / kXCH);
}

// Blocks of a prolongation onto fine level fg: one thread per coarse z
// column 0..fnz/2 (see prolong_tile).
__host__ __device__ inline dim3 prolong_grid_for(const Geom& fg) {
  return dim3((fg.nz / 2 + kBZ) / kBZ, (fg.ny + kBY - 1) / kBY,
              (fg.nx + kXCH - 1) / kXCH);
}

inline Taps make_taps(const float* val, const int* off3, int ntaps,
                      const Geom& g) {
  Taps t;
  t.n = ntaps;
  for (int q = 0; q < kMaxTaps; ++q) {
    t.val[q] = q < ntaps ? val[q] : 0.0f;
    t.off[q] = q < ntaps ? (int)(off3[3 * q] * g.sx + off3[3 * q + 1] * g.sy +
                                 off3[3 * q + 2])
                         : 0;
  }
  return t;
}

// Whether the stencil's (x, y, z) tap offsets are the examples' 7-point
// order: centre, x + 1, x - 1, y + 1, y - 1, z + 1, z - 1.
inline bool canonical_taps(const int* off3, int ntaps) {
  static const int kCanon[3 * kMaxTaps] = {
      0, 0, 0, 1, 0, 0, -1, 0, 0, 0, 1, 0, 0, -1, 0, 0, 0, 1, 0, 0, -1};
  bool canon = ntaps == kMaxTaps;
  for (int q = 0; q < 3 * ntaps && canon; ++q) canon = off3[q] == kCanon[q];
  return canon;
}

struct LdNC {
  static __device__ __forceinline__ float tap(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ float at(const float* p) { return *p; }
};

struct LdPlain {
  static __device__ __forceinline__ float tap(const float* p) { return *p; }
  static __device__ __forceinline__ float at(const float* p) { return *p; }
};

struct LdZero {
  static __device__ __forceinline__ float tap(const float*) { return 0.0f; }
  static __device__ __forceinline__ float at(const float*) { return 0.0f; }
};

// A v / h^2 in tap order, tap(k) giving the value at tap k (the first t.n
// taps).  tap is called as the sum needs each value, so a caller that
// loads there keeps its loads in this order.
template <class Tap>
__device__ __forceinline__ float stencil_sum(Tap tap, const Taps& t,
                                             float inv_h2) {
  float acc = __fmul_rn(t.val[0], tap(0));
#pragma unroll
  for (int k = 1; k < kMaxTaps; ++k) {
    if (k < t.n) acc = __fadd_rn(acc, __fmul_rn(t.val[k], tap(k)));
  }
  return __fmul_rn(acc, inv_h2);
}

template <class Ld>
__device__ __forceinline__ float stencil_at(const float* v, long long idx,
                                            const Taps& t, float inv_h2) {
  return stencil_sum([&](int k) { return Ld::tap(v + idx + t.off[k]); }, t,
                     inv_h2);
}

// FAS term gamma * v * e^v, as (gamma * v) * e^v.
__device__ __forceinline__ float fas_term(float v, float ex, float gamma) {
  return __fmul_rn(__fmul_rn(gamma, v), ex);
}

// av = A v / h^2 plus the mode's nonlinear term at a point whose v is vc()
// (and u~ n()), in the plain version's order:
//   NONLINEAR  av + (gamma v) e^v
//   NEWTON     av + ((gamma (1 + n)) v) e^n
// vc and n give their values as the arithmetic needs them (loads stay in
// this order).
template <int M, class VC, class N>
__device__ __forceinline__ float operator_point(float av, VC vc, N n,
                                                float gamma) {
  if constexpr (M == kNonlinear) {
    const float v = vc();
    return __fadd_rn(av, fas_term(v, expf(v), gamma));
  } else if constexpr (M == kNewton) {
    const float nn = n();
    const float lin0 = __fmul_rn(gamma, __fadd_rn(1.0f, nn));
    return __fadd_rn(av, __fmul_rn(__fmul_rn(lin0, vc()), expf(nn)));
  } else {
    return av;
  }
}

template <int M, class Ld>
__device__ __forceinline__ float operator_at(const float* v, const float* nv,
                                             long long idx, const Taps& t,
                                             float inv_h2, float gamma) {
  return operator_point<M>(
      stencil_at<Ld>(v, idx, t, inv_h2), [&] { return Ld::at(v + idx); },
      [&] { return nv[idx]; }, gamma);
}

// Fixed-order block sum of one double per thread; the result is valid in
// thread 0.  A block that calls it again must __syncthreads() first.
__device__ double block_sum(double x) {
  __shared__ double warp_sums[32];
  const int lane = (threadIdx.y * blockDim.x + threadIdx.x) & 31;
  const int warp = (threadIdx.y * blockDim.x + threadIdx.x) >> 5;
  const int nwarps = (blockDim.x * blockDim.y + 31) >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  if (lane == 0) warp_sums[warp] = x;
  __syncthreads();
  double total = 0.0;
  if (warp == 0 && lane == 0) {
    for (int w = 0; w < nwarps; ++w) total += warp_sums[w];
  }
  return total;
}

// The fixed-order float64 sum of the residual's per-tile partials, as
// kFinThreads slots: slot q sums partials q, q + kFinThreads, ... in order,
// then a halving tree adds the slots.  Any block size walks the same
// slots, so the sum is the same bits whichever kernel takes it; the per-op
// finalize kernel (multigrid.cu) walks them as one cluster of blocks in
// the same order.  `s` is kFinThreads doubles of shared memory; the result
// is valid in thread 0.
__device__ __forceinline__ double finalize_sum(const double* partials,
                                               long long n, double* s) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int q = tid; q < kFinThreads; q += nt) {
    double acc = 0.0;
    for (long long t = q; t < n; t += kFinThreads) acc += partials[t];
    s[q] = acc;
  }
  __syncthreads();
  for (int w = kFinThreads / 2; w > 0; w >>= 1) {
    for (int q = tid; q < w; q += nt) s[q] += s[q + w];
    __syncthreads();
  }
  return s[0];
}

// One tile of the residual r = f - (A v / h^2 + mode term), written into r
// when write_r; returns this thread's sum of r^2 over its column, in x
// order (0 outside the interior).  LdF loads f.  kEager: each point's v, u~
// and f are loaded before its arithmetic starts, not as it needs them (the
// cooperative kernel's generic body, which fits its registers so).
template <int M, class Ld, class LdF = LdPlain, bool kEager = false>
__device__ __forceinline__ double residual_tile(
    int bx, int by, int bz, int tz, int ty, const float* v, const float* f,
    const float* nv, float* r, const Geom& g, const Taps& taps,
    float inv_h2, float gamma, bool write_r) {
  const int k = bx * kBZ + tz + 1;
  const int j = by * kBY + ty + 1;
  const int i0 = bz * kXCH + 1;
  const int i1 = min(i0 + kXCH, g.nx + 1);
  double ss = 0.0;
  if (k <= g.nz && j <= g.ny) {
    long long idx = i0 * g.sx + j * g.sy + k;
    for (int i = i0; i < i1; ++i, idx += g.sx) {
      float res;
      if constexpr (kEager) {
        const float av = stencil_at<Ld>(v, idx, taps, inv_h2);
        const float vc = M == kLinear ? 0.0f : Ld::at(v + idx);
        const float n = M == kNewton ? LdNC::tap(nv + idx) : 0.0f;
        res = __fsub_rn(LdF::tap(f + idx),
                        operator_point<M>(av, [&] { return vc; },
                                          [&] { return n; }, gamma));
      } else {
        res = __fsub_rn(LdF::tap(f + idx),
                        operator_at<M, Ld>(v, nv, idx, taps, inv_h2, gamma));
      }
      if (write_r) r[idx] = res;
      ss += (double)res * (double)res;
    }
  }
  return ss;
}

// One damped-Jacobi update at a point whose v is vc(), A v / h^2 av, f
// fv() (and u~ n()), in the order of ops/ref.py::jacobi:
//   LINEAR     v + omega (alpha r),  r = f - av
//   NONLINEAR  ex = e^v; r = f - (av + (gamma v) ex);
//              v + omega (r / (pre_fac + (gamma (1 + v)) ex))
//   NEWTON     ex = e^n; lin = (gamma (1 + n)) ex; r = f - (av + lin v);
//              v + omega (r / (pre_fac + lin))
// Newton's lin * v is ordered otherwise than the Newton residual's term.
// The getters give their values as the arithmetic needs them (loads stay
// in this order).
template <int M, class VC, class FV, class N>
__device__ __forceinline__ float jacobi_point(float av, VC vc, FV fv, N n,
                                              float alpha, float omega,
                                              const ModeArgs& ma) {
  if constexpr (M == kLinear) {
    const float res = __fsub_rn(fv(), av);
    return __fadd_rn(vc(), __fmul_rn(omega, __fmul_rn(alpha, res)));
  } else {
    const float v = vc();
    float ex, term, lin;
    if constexpr (M == kNonlinear) {
      ex = expf(v);
      term = fas_term(v, ex, ma.gamma);
      lin = __fmul_rn(__fmul_rn(ma.gamma, __fadd_rn(1.0f, v)), ex);
    } else {
      const float nn = n();
      ex = expf(nn);
      lin = __fmul_rn(__fmul_rn(ma.gamma, __fadd_rn(1.0f, nn)), ex);
      term = __fmul_rn(lin, v);
    }
    const float res = __fsub_rn(fv(), __fadd_rn(av, term));
    const float denom = __fadd_rn(ma.pre_fac, lin);
    return __fadd_rn(v, __fmul_rn(omega, __fdiv_rn(res, denom)));
  }
}

// One tile of a damped-Jacobi sweep (jacobi_point at every point).  LdF
// and kEager as residual_tile's.  With Ld = LdZero every v value is 0,
// which is what a sweep over a zeroed v reads (+0 everywhere), so the
// result is that sweep's bit for bit; v is then never read, and may be
// v_out.
template <int M, class Ld, class LdF = LdPlain, bool kEager = false>
__device__ __forceinline__ void jacobi_tile(
    int bx, int by, int bz, int tz, int ty, float* v_out, const float* v,
    const float* f, const float* nv, const Geom& g, const Taps& taps,
    float inv_h2, float alpha, float omega, const ModeArgs& ma) {
  const int k = bx * kBZ + tz + 1;
  const int j = by * kBY + ty + 1;
  if (k > g.nz || j > g.ny) return;
  const int i0 = bz * kXCH + 1;
  const int i1 = min(i0 + kXCH, g.nx + 1);
  long long idx = i0 * g.sx + j * g.sy + k;
  for (int i = i0; i < i1; ++i, idx += g.sx) {
    if constexpr (kEager) {
      const float av = stencil_at<Ld>(v, idx, taps, inv_h2);
      const float n = M == kNewton ? LdNC::tap(nv + idx) : 0.0f;
      const float vc = Ld::at(v + idx), fv = LdF::tap(f + idx);
      v_out[idx] = jacobi_point<M>(
          av, [&] { return vc; }, [&] { return fv; }, [&] { return n; },
          alpha, omega, ma);
    } else {
      v_out[idx] = jacobi_point<M>(
          stencil_at<Ld>(v, idx, taps, inv_h2),
          [&] { return Ld::at(v + idx); }, [&] { return LdF::tap(f + idx); },
          [&] { return nv[idx]; }, alpha, omega, ma);
    }
  }
}

// Full weighting at one coarse point, whose fine centre is `center`: fine
// points (2ci+a, 2cj+b, 2ck+c), a, b, c in {-1, 0, 1}, with weight
// 0.125 * w(a) * w(b) * w(c), w(0) = 1, w(+-1) = 0.5, summed in (a, b, c)
// lexicographic order.
template <class Ld>
__device__ __forceinline__ float restrict_at(const float* in,
                                             long long center,
                                             const Geom& fg) {
  const float w1[3] = {0.5f, 1.0f, 0.5f};
  float acc = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b) {
#pragma unroll
      for (int cc = 0; cc < 3; ++cc) {
        const float w = 0.125f * w1[a] * w1[b] * w1[cc];
        const float term = __fmul_rn(
            w, Ld::tap(in + center + (a - 1) * fg.sx + (b - 1) * fg.sy +
                       (cc - 1)));
        acc = (a == 0 && b == 0 && cc == 0) ? term : __fadd_rn(acc, term);
      }
    }
  }
  return acc;
}

// One tile of a restriction onto coarse level c: calls
// out(coarse index, fine centre) for every coarse point of the tile.
template <class Out>
__device__ __forceinline__ void restrict_tile(int bx, int by, int bz, int tz,
                                              int ty, const Geom& c,
                                              const Geom& fg, Out out) {
  const int ck = bx * kBZ + tz + 1;
  const int cj = by * kBY + ty + 1;
  if (ck > c.nz || cj > c.ny) return;
  const int i0 = bz * kXCH + 1;
  const int i1 = min(i0 + kXCH, c.nx + 1);
  for (int ci = i0; ci < i1; ++ci) {
    const long long center = 2LL * ci * fg.sx + 2LL * cj * fg.sy + 2 * ck;
    out(ci * c.sx + cj * c.sy + ck, center);
  }
}

// Shared memory by 32-bit address: a loop that reads many cells at one
// uniform offset from each keeps every cell's address in a register and
// adds the offset, one add a load (trapezoid leg, leg_device.cuh).
// Volatile, so the compiler keeps their order among themselves: a thread
// reads back what it stored to its own cells in the same step.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ float lds(unsigned a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a));
  return v;
}

// The float kOff >= 0 bytes past address a (an immediate offset).
template <int kOff>
__device__ __forceinline__ float lds_at(unsigned a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1+%2];" : "=f"(v) : "r"(a), "n"(kOff));
  return v;
}

__device__ __forceinline__ void sts(unsigned a, float v) {
  asm volatile("st.shared.f32 [%0], %1;" ::"r"(a), "f"(v));
}

__device__ __forceinline__ float mid(float a, float b) {
  return __fadd_rn(__fmul_rn(0.5f, a), __fmul_rn(0.5f, b));
}

// The prolongation's corrections at fine plane i (parity io), fine row j
// (parity jo) for coarse z column kc, whose coarse index at rows (i >> 1,
// j >> 1) is col: yv[dk] is the value at fine z 2 (kc + dk), the x
// midpoints taken first, then y (see prolong_tile).
template <class CV>
__device__ __forceinline__ void prolong_corr(CV cv, long long col, bool io,
                                             bool jo, const Geom& c,
                                             float yv[2]) {
#pragma unroll
  for (int dk = 0; dk < 2; ++dk) {
    // x midpoints at coarse rows jc and jc+1 (the second only when j is
    // odd), then the y midpoint.
    const float a = cv(col + dk);
    const float xa = io ? mid(a, cv(col + c.sx + dk)) : a;
    float yk = xa;
    if (jo) {
      const float b = cv(col + c.sy + dk);
      const float xb = io ? mid(b, cv(col + c.sx + c.sy + dk)) : b;
      yk = mid(xa, xb);
    }
    yv[dk] = yk;
  }
}

// One tile of the prolongation onto fine level fg from coarse level c:
// out(idx, e) receives the correction e at fine index idx.  Fine point
// (i, j, k) gets the reference's 4-pass interpolation in closed form: along
// each axis an even index takes coarse index i/2 and an odd one the
// midpoint of (i-1)/2 and (i+1)/2; the x midpoints are taken first, then
// y, then z, as the passes do.  An odd index next to the upper halo reads
// the coarse halo, which is zero, as the passes' unwritten sites are.  A
// thread owns coarse z column kc and writes fine z points 2kc and 2kc+1,
// which share column kc: half the coarse loads per fine point, and no
// branch on the parity of z.  The parities of i and j are uniform across a
// warp.  cv(q) is the coarse value at linear index q.
template <class CV, class Out>
__device__ __forceinline__ void prolong_tile(int bx, int by, int bz, int tz,
                                             int ty, const Geom& fg,
                                             const Geom& c, CV cv, Out out) {
  const int kc = bx * kBZ + tz;
  const int j = by * kBY + ty + 1;
  if (kc > fg.nz / 2 || j > fg.ny) return;
  const int i0 = bz * kXCH + 1;
  const int i1 = min(i0 + kXCH, fg.nx + 1);
  const int jc = j >> 1;
  const bool jo = j & 1;
  const bool even_ok = kc >= 1, odd_ok = 2 * kc + 1 <= fg.nz;
  long long idx = i0 * fg.sx + j * fg.sy + 2 * kc;
  for (int i = i0; i < i1; ++i, idx += fg.sx) {
    float yv[2];
    prolong_corr(cv, (i >> 1) * c.sx + jc * c.sy + kc, i & 1, jo, c, yv);
    if (even_ok) out(idx, yv[0]);
    if (odd_ok) out(idx + 1, mid(yv[0], yv[1]));
  }
}

// prolong_tile's tile with the fine values added: put(idx, fine(idx) + e)
// at every fine point.  Each plane's coarse and fine values are loaded
// before the plane below it is stored (the cooperative kernel's loads are
// plain, so the compiler keeps them after any store before them).
template <class CV, class Fine, class Put>
__device__ __forceinline__ void prolong_add_tile(int bx, int by, int bz,
                                                 int tz, int ty,
                                                 const Geom& fg,
                                                 const Geom& c, CV cv,
                                                 Fine fine, Put put) {
  const int kc = bx * kBZ + tz;
  const int j = by * kBY + ty + 1;
  if (kc > fg.nz / 2 || j > fg.ny) return;
  const int i0 = bz * kXCH + 1;
  const int i1 = min(i0 + kXCH, fg.nx + 1);
  const int jc = j >> 1;
  const bool jo = j & 1;
  const bool even_ok = kc >= 1, odd_ok = 2 * kc + 1 <= fg.nz;
  long long idx = i0 * fg.sx + j * fg.sy + 2 * kc;
  // Plane i's corrections and fine values (zero where a point is off).
  float yv[2], fe, fo;
  auto load = [&](int i, long long at, float (&y)[2], float& e, float& o) {
    prolong_corr(cv, (i >> 1) * c.sx + jc * c.sy + kc, i & 1, jo, c, y);
    e = even_ok ? fine(at) : 0.0f;
    o = odd_ok ? fine(at + 1) : 0.0f;
  };
  load(i0, idx, yv, fe, fo);
  for (int i = i0; i < i1; ++i, idx += fg.sx) {
    float yn[2] = {0.0f, 0.0f}, ne = 0.0f, no = 0.0f;
    if (i + 1 < i1) load(i + 1, idx + fg.sx, yn, ne, no);
    if (even_ok) put(idx, __fadd_rn(fe, yv[0]));
    if (odd_ok) put(idx + 1, __fadd_rn(fo, mid(yv[0], yv[1])));
    yv[0] = yn[0];
    yv[1] = yn[1];
    fe = ne;
    fo = no;
  }
}

}  // namespace
