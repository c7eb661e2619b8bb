// Shard-local multigrid kernels of the distributed per-leg engine
// (dist/spmd.py), in all three modes (LINEAR, FAS, NEWTON), for Hopper
// (sm_90a).
//
// They replace the TPU kernels of the explicit-halo spmd engine's per-op
// path, gpusolve_tpu/ops/pallas_spmd.py:
//
//   mg_sweep_block             ::_sweep_call (:284): one damped-Jacobi
//                              sweep of a shard's block, out of place
//   mg_residual_block          ::_residual_call (:370): the residual, its
//                              per-block sum r^2, or the sum alone
//   mg_residual_restrict_block ::_res_restrict_call (:628): the residual
//                              restricted along x and z (the y restriction
//                              is glue in dist/spmd.py), the z-restricted
//                              last residual plane for the lower-x fix-up,
//                              and in FAS the same restriction of v
//   mg_prolong_add_block       ::_prolong_add_call (:850): v += P(coarse)
//                              from the x/y ghost-extended coarse block
//
// Array model: a shard's block of a level is a dense (bx, by, bz) float32
// array, z contiguous, with no stored halo.  Its neighbours' face planes
// arrive as four ghost faces from the exchange (dist/spmd.py): x faces
// (by, bz) below and above, y faces (bx, bz).  z is never split (the engine
// folds a z mesh axis into y), so a z tap outside the block reads 0, the
// Dirichlet boundary.  Every launch covers the shard's interior bounds box
// (inclusive local bounds from the host), never the whole block: the
// mesh-aware allocation pads the 511^3 level-0 block to 640^3, 1.95 times
// the 513^3 padded grid.  Cells outside the box are never written, so a
// buffer that starts zeroed stays zero there, as the engine needs.
//
// Ghost taps: a point strictly inside the block reads its taps through
// mg_device.cuh's stencil_at (linear offsets); a point on a block face reads
// each tap through tap_at, which takes the ghost face where the tap leaves
// the block.  Both sum the same taps in the same order, so the two paths
// round alike.  The kernels are templated on kFaces: the host launches the
// face-aware instantiation only when the box reaches the block's outer
// layer (a shard with a lower neighbour), so a box strictly inside its
// block (every shard of the one-rank mesh) runs the per-op kernels' loop
// with no face test and their register budget.  Only face taps are taken
// (the engine refuses a stencil with corner or edge taps).
//
// Bound: bytes, as the per-op kernels of multigrid.cu (under 2 flops per
// byte).  Design: the per-op kernels' tile, a 32(z) x 8(y) column of
// threads walking 8 x-planes, over the box, at their 40 registers (6
// blocks per SM).  residual_restrict walks 8 coarse x-planes a block and
// keeps the residual of the shared odd plane in registers, so each fine
// residual is evaluated ~1.5 times (the z neighbours' shared plane); r
// never reaches device memory.  The prolongation gives each thread one
// coarse z column and the two fine points it feeds, as prolong_add does.
//
// Rounding: every product, sum and quotient rounded as its own operation,
// in the order of the plain versions (ops/spmd_kernels.py, which call
// ops/ref.py's point formulas), the accurate expf.  The transfers take the
// weights 0.25, 0.5, 0.25 left to right; the prolongation's midpoints are
// mid(a, b) = 0.5a + 0.5b along x, then y, then z.
//
// Every entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError().

#include <type_traits>

#include "mg_device.cuh"

namespace {

constexpr int kMinBlocks = 6;         // 40 registers, as multigrid.cu
constexpr int kRestrictMinBlocks = 4;  // 64: the restriction's six r values

struct Block {  // a shard's block: extents and strides
  int bx, by, bz;
  long long sx, sy;
};

struct Box {  // inclusive local bounds of the cells a launch writes
  int x0, x1, y0, y1, z0, z1;
};

struct Faces {  // ghost faces: x (by, bz) below / above, y (bx, bz)
  const float* xlo;
  const float* xhi;
  const float* ylo;
  const float* yhi;
};

struct Offs {  // the stencil's (x, y, z) tap offsets, in tap order
  int ox[kMaxTaps], oy[kMaxTaps], oz[kMaxTaps];
};

inline Block make_block(int bx, int by, int bz) {
  Block b;
  b.bx = bx;
  b.by = by;
  b.bz = bz;
  b.sy = bz;
  b.sx = (long long)by * bz;
  return b;
}

inline Taps block_taps(const float* val, const int* off3, int ntaps,
                       const Block& b) {
  Geom g;
  g.nx = b.bx;
  g.ny = b.by;
  g.nz = b.bz;
  g.sx = b.sx;
  g.sy = b.sy;
  return make_taps(val, off3, ntaps, g);
}

inline Offs make_offs(const int* off3, int ntaps) {
  Offs o;
  for (int q = 0; q < kMaxTaps; ++q) {
    o.ox[q] = q < ntaps ? off3[3 * q] : 0;
    o.oy[q] = q < ntaps ? off3[3 * q + 1] : 0;
    o.oz[q] = q < ntaps ? off3[3 * q + 2] : 0;
  }
  return o;
}

// v at local (i, j, k), at most one coordinate one cell outside the block:
// there the ghost face, or 0 past a z end.
__device__ __forceinline__ float tap_at(const float* v, const Faces& g,
                                        const Block& b, int i, int j, int k) {
  if (k < 0 || k >= b.bz) return 0.0f;
  if (i < 0) return __ldg(g.xlo + (long long)j * b.bz + k);
  if (i >= b.bx) return __ldg(g.xhi + (long long)j * b.bz + k);
  if (j < 0) return __ldg(g.ylo + (long long)i * b.bz + k);
  if (j >= b.by) return __ldg(g.yhi + (long long)i * b.bz + k);
  return __ldg(v + i * b.sx + j * b.sy + k);
}

// A v / h^2 at local (i, j, k) (linear index idx): stencil_at inside the
// block, the ghost-aware loader on its faces (kFaces only); the same taps
// in the same order either way.
template <bool kFaces>
__device__ __forceinline__ float av_at(const float* v, long long idx, int i,
                                       int j, int k, const Faces& g,
                                       const Block& b, const Taps& t,
                                       const Offs& o, float inv_h2) {
  if (!kFaces || (i >= 1 && i <= b.bx - 2 && j >= 1 && j <= b.by - 2 &&
                  k >= 1 && k <= b.bz - 2)) {
    return stencil_at<LdNC>(v, idx, t, inv_h2);
  }
  float acc =
      __fmul_rn(t.val[0], tap_at(v, g, b, i + o.ox[0], j + o.oy[0],
                                 k + o.oz[0]));
#pragma unroll
  for (int q = 1; q < kMaxTaps; ++q) {
    if (q < t.n) {
      acc = __fadd_rn(acc, __fmul_rn(t.val[q],
                                     tap_at(v, g, b, i + o.ox[q],
                                            j + o.oy[q], k + o.oz[q])));
    }
  }
  return __fmul_rn(acc, inv_h2);
}

// r = f - (A v / h^2 + mode term) at one point, as operator_at orders it.
template <int M, bool kFaces>
__device__ __forceinline__ float residual_at(const float* v, const float* f,
                                             const float* nv, long long idx,
                                             int i, int j, int k,
                                             const Faces& g, const Block& b,
                                             const Taps& t, const Offs& o,
                                             float inv_h2, float gamma) {
  float a = av_at<kFaces>(v, idx, i, j, k, g, b, t, o, inv_h2);
  if constexpr (M == kNonlinear) {
    const float vc = __ldg(v + idx);
    a = __fadd_rn(a, fas_term(vc, expf(vc), gamma));
  } else if constexpr (M == kNewton) {
    const float n = __ldg(nv + idx);
    const float lin0 = __fmul_rn(gamma, __fadd_rn(1.0f, n));
    a = __fadd_rn(a, __fmul_rn(__fmul_rn(lin0, __ldg(v + idx)), expf(n)));
  }
  return __fsub_rn(__ldg(f + idx), a);
}

__device__ __forceinline__ float weigh3(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(0.25f, a), __fmul_rn(0.5f, b)),
                   __fmul_rn(0.25f, c));
}

// One sweep over the box, out of place, in jacobi_tile's arithmetic.
template <int M, bool kFaces>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
sweep_block_kernel(float* __restrict__ v_out, const float* __restrict__ v,
                   const float* __restrict__ f, const float* __restrict__ nv,
                   Faces g, Block b, Box box, Taps t, Offs o, float inv_h2,
                   float alpha, float omega, ModeArgs ma) {
  const int k = box.z0 + blockIdx.x * kBZ + threadIdx.x;
  const int j = box.y0 + blockIdx.y * kBY + threadIdx.y;
  if (k > box.z1 || j > box.y1) return;
  const int i0 = box.x0 + blockIdx.z * kXCH;
  const int i1 = min(i0 + kXCH, box.x1 + 1);
  long long idx = i0 * b.sx + j * b.sy + k;
  for (int i = i0; i < i1; ++i, idx += b.sx) {
    const float av = av_at<kFaces>(v, idx, i, j, k, g, b, t, o, inv_h2);
    const float vc = __ldg(v + idx);
    if constexpr (M == kLinear) {
      const float res = __fsub_rn(__ldg(f + idx), av);
      v_out[idx] = __fadd_rn(vc, __fmul_rn(omega, __fmul_rn(alpha, res)));
    } else {
      float ex, term, lin;
      if constexpr (M == kNonlinear) {
        ex = expf(vc);
        term = fas_term(vc, ex, ma.gamma);
        lin = __fmul_rn(__fmul_rn(ma.gamma, __fadd_rn(1.0f, vc)), ex);
      } else {
        const float n = __ldg(nv + idx);
        ex = expf(n);
        lin = __fmul_rn(__fmul_rn(ma.gamma, __fadd_rn(1.0f, n)), ex);
        term = __fmul_rn(lin, vc);
      }
      const float res = __fsub_rn(__ldg(f + idx), __fadd_rn(av, term));
      const float denom = __fadd_rn(ma.pre_fac, lin);
      v_out[idx] = __fadd_rn(vc, __fmul_rn(omega, __fdiv_rn(res, denom)));
    }
  }
}

// The residual over the box into r (when write_r) and each block's sum of
// r^2 in float64 into partials (when given), in x order per thread, then
// block_sum's fixed order, as residual_kernel.
template <int M, bool kFaces>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
residual_block_kernel(float* __restrict__ r, double* __restrict__ partials,
                      const float* __restrict__ v, const float* __restrict__ f,
                      const float* __restrict__ nv, Faces g, Block b, Box box,
                      Taps t, Offs o, float inv_h2, float gamma, int write_r) {
  const int k = box.z0 + blockIdx.x * kBZ + threadIdx.x;
  const int j = box.y0 + blockIdx.y * kBY + threadIdx.y;
  const int i0 = box.x0 + blockIdx.z * kXCH;
  const int i1 = min(i0 + kXCH, box.x1 + 1);
  double ss = 0.0;
  if (k <= box.z1 && j <= box.y1) {
    long long idx = i0 * b.sx + j * b.sy + k;
    for (int i = i0; i < i1; ++i, idx += b.sx) {
      const float res = residual_at<M, kFaces>(v, f, nv, idx, i, j, k, g,
                                               b, t, o, inv_h2, gamma);
      if (write_r) r[idx] = res;
      ss += (double)res * (double)res;
    }
  }
  if (partials != nullptr) {
    const double total = block_sum(ss);
    if (threadIdx.x == 0 && threadIdx.y == 0) {
      partials[blockIdx.x +
               gridDim.x * (blockIdx.y + (long long)gridDim.y * blockIdx.z)] =
          total;
    }
  }
}

// The residual of plane p at fine z 2kc-1, 2kc, 2kc+1 (0 outside the box).
template <int M, bool kFaces>
__device__ __forceinline__ void residual_triple(
    float out[3], int p, int j, int kc, const float* v, const float* f,
    const float* nv, const Faces& g, const Block& b, const Box& box,
    const Taps& t, const Offs& o, float inv_h2, float gamma) {
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const int k = 2 * kc - 1 + d;
    if (p >= box.x0 && p <= box.x1 && k >= box.z0 && k <= box.z1) {
      const long long idx = p * b.sx + j * b.sy + k;
      out[d] = residual_at<M, kFaces>(v, f, nv, idx, p, j, k, g, b, t, o,
                                      inv_h2, gamma);
    } else {
      out[d] = 0.0f;
    }
  }
}

// v of plane p (-1: the lower x ghost face) at fine z 2kc-1..2kc+1.
__device__ __forceinline__ void v_triple(float out[3], int p, int j, int kc,
                                         const float* v, const Faces& g,
                                         const Block& b) {
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const int k = 2 * kc - 1 + d;
    out[d] = p < 0 ? __ldg(g.xlo + (long long)j * b.bz + k)
                   : __ldg(v + p * b.sx + j * b.sy + k);
  }
}

// Coarse x-planes m0..m1 (a block walks 8), fine rows of the box, coarse z
// 1..cnz.  Coarse plane m reads r planes 2m-1, 2m, 2m+1; plane -1 is 0
// here (the caller adds 0.25 r_last_z of the lower x neighbour).  Outputs
// xzr, xzv (cbx, by, cbz); rlast (by, cbz), written by the walk that
// computes plane bx-1.  FAS: the same restriction of v, plane -1 the lower
// x ghost face.
template <int M, bool kFaces>
__global__ void __launch_bounds__(kThreads, kRestrictMinBlocks)
residual_restrict_kernel(float* __restrict__ xzr, float* __restrict__ rlast,
                         float* __restrict__ xzv, const float* __restrict__ v,
                         const float* __restrict__ f,
                         const float* __restrict__ nv, Faces g, Block b,
                         Box box, int m0, int m1, int cnz, int cbz, Taps t,
                         Offs o, float inv_h2, float gamma) {
  constexpr bool kFas = M == kNonlinear;
  const int kc = 1 + blockIdx.x * kBZ + threadIdx.x;
  const int j = box.y0 + blockIdx.y * kBY + threadIdx.y;
  if (kc > cnz || j > box.y1) return;
  const int ma = m0 + blockIdx.z * kXCH;
  const int mb = min(ma + kXCH, m1 + 1);
  const long long cs = (long long)b.by * cbz;
  const long long cidx = (long long)j * cbz + kc;
  float prev[3], c0[3], c1[3];
  if (2 * ma - 1 >= 0) {
    residual_triple<M, kFaces>(prev, 2 * ma - 1, j, kc, v, f, nv, g, b, box,
                               t, o, inv_h2, gamma);
  } else {
    prev[0] = prev[1] = prev[2] = 0.0f;
  }
  float vprev[3];
  if constexpr (kFas) v_triple(vprev, 2 * ma - 1, j, kc, v, g, b);
  for (int m = ma; m < mb; ++m) {
    residual_triple<M, kFaces>(c0, 2 * m, j, kc, v, f, nv, g, b, box, t, o,
                               inv_h2, gamma);
    residual_triple<M, kFaces>(c1, 2 * m + 1, j, kc, v, f, nv, g, b, box, t,
                               o, inv_h2, gamma);
    float sx[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) sx[d] = weigh3(prev[d], c0[d], c1[d]);
    xzr[m * cs + cidx] = weigh3(sx[0], sx[1], sx[2]);
    if (2 * m + 1 == b.bx - 1) {
      rlast[cidx] = weigh3(c1[0], c1[1], c1[2]);
    }
    if constexpr (kFas) {
      float w0[3], w1[3];
      v_triple(w0, 2 * m, j, kc, v, g, b);
      v_triple(w1, 2 * m + 1, j, kc, v, g, b);
#pragma unroll
      for (int d = 0; d < 3; ++d) sx[d] = weigh3(vprev[d], w0[d], w1[d]);
      xzv[m * cs + cidx] = weigh3(sx[0], sx[1], sx[2]);
#pragma unroll
      for (int d = 0; d < 3; ++d) vprev[d] = w1[d];
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) prev[d] = c1[d];
  }
}

// v += P(casm) over the box, in place.  casm is the coarse block with one
// ghost cell on each x and y face, (cbx+2, cyp, czp), its z axis in padded
// global coordinates.  Fine p reads casm (p+2)/2 and (p+3)/2 along x and
// y, coarse k/2 and (k+1)/2 along z, at 0.5 each; an even index reads one
// value twice, and mid(a, a) = a.  Midpoints along x first, then y, then z.
// A thread owns coarse z column kc and writes fine z 2kc and 2kc+1 (those
// in the box), which share it.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
prolong_add_block_kernel(float* __restrict__ v, const float* __restrict__ c,
                         Block b, Box box, int cyp, int czp) {
  const int kc = (box.z0 >> 1) + blockIdx.x * kBZ + threadIdx.x;
  const int j = box.y0 + blockIdx.y * kBY + threadIdx.y;
  if (kc > (box.z1 >> 1) || j > box.y1) return;
  const bool even_ok = 2 * kc >= box.z0;
  const bool odd_ok = 2 * kc + 1 <= box.z1;
  const int i0 = box.x0 + blockIdx.z * kXCH;
  const int i1 = min(i0 + kXCH, box.x1 + 1);
  const long long csx = (long long)cyp * czp;
  const long long ra = (long long)((j + 2) >> 1) * czp + kc;
  const long long rb = (long long)((j + 3) >> 1) * czp + kc;
  long long idx = i0 * b.sx + j * b.sy + 2 * kc;
  for (int i = i0; i < i1; ++i, idx += b.sx) {
    const long long pa = ((i + 2) >> 1) * csx, pb = ((i + 3) >> 1) * csx;
    float yk[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (q == 1 && !odd_ok) break;
      const float xa = mid(__ldg(c + pa + ra + q), __ldg(c + pb + ra + q));
      const float xb = mid(__ldg(c + pa + rb + q), __ldg(c + pb + rb + q));
      yk[q] = mid(xa, xb);
    }
    if (even_ok) v[idx] = __fadd_rn(v[idx], mid(yk[0], yk[0]));
    if (odd_ok) v[idx + 1] = __fadd_rn(v[idx + 1], mid(yk[0], yk[1]));
  }
}

// Whether a launch over the box reads a ghost face: the box reaches the
// block's outer layer (z ends included).
bool reads_faces(const Box& box, const Block& b) {
  return box.x0 < 1 || box.x1 > b.bx - 2 || box.y0 < 1 ||
         box.y1 > b.by - 2 || box.z0 < 1 || box.z1 > b.bz - 2;
}

// Calls launch(mode constant, faces constant) for the runtime pair; an
// unknown mode is cudaErrorInvalidValue.
template <class F>
int dispatch(int mode, bool faces, F&& launch) {
  auto with_faces = [&](auto m) {
    if (faces) {
      launch(m, std::true_type{});
    } else {
      launch(m, std::false_type{});
    }
  };
  switch (mode) {
    case kLinear:
      with_faces(std::integral_constant<int, kLinear>{});
      break;
    case kNonlinear:
      with_faces(std::integral_constant<int, kNonlinear>{});
      break;
    case kNewton:
      with_faces(std::integral_constant<int, kNewton>{});
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

dim3 box_grid(const Box& box) {
  return dim3((box.z1 - box.z0 + kBZ) / kBZ, (box.y1 - box.y0 + kBY) / kBY,
              (box.x1 - box.x0 + kXCH) / kXCH);
}

}  // namespace

extern "C" {

// Blocks of a launch over a box of (nx, ny, nz) cells (the partials of
// mg_residual_block).
long long mg_box_blocks(int nx, int ny, int nz) {
  return (long long)((nz + kBZ - 1) / kBZ) * ((ny + kBY - 1) / kBY) *
         ((nx + kXCH - 1) / kXCH);
}

// mode: 0 LINEAR, 1 NONLINEAR, 2 NEWTON (nv is read only by NEWTON).
int mg_sweep_block(float* v_out, const float* v, const float* f,
                   const float* nv, const float* gxlo, const float* gxhi,
                   const float* gylo, const float* gyhi, int bx, int by,
                   int bz, int x0, int x1, int y0, int y1, int z0, int z1,
                   const float* tap_val, const int* tap_off3, int ntaps,
                   float inv_h2, float alpha, float omega, float gamma,
                   float pre_fac, int mode, cudaStream_t stream) {
  const Block b = make_block(bx, by, bz);
  const Box box{x0, x1, y0, y1, z0, z1};
  const Faces g{gxlo, gxhi, gylo, gyhi};
  const Taps t = block_taps(tap_val, tap_off3, ntaps, b);
  const Offs o = make_offs(tap_off3, ntaps);
  const ModeArgs ma{gamma, pre_fac};
  const dim3 grid = box_grid(box), block(kBZ, kBY);
  return dispatch(mode, reads_faces(box, b), [&](auto m, auto fc) {
    sweep_block_kernel<decltype(m)::value, decltype(fc)::value>
        <<<grid, block, 0, stream>>>(v_out, v, f, nv, g, b, box, t, o,
                                     inv_h2, alpha, omega, ma);
  });
}

// r may be null (write_r 0), partials null (no norm).
int mg_residual_block(float* r, double* partials, const float* v,
                      const float* f, const float* nv, const float* gxlo,
                      const float* gxhi, const float* gylo,
                      const float* gyhi, int bx, int by, int bz, int x0,
                      int x1, int y0, int y1, int z0, int z1,
                      const float* tap_val, const int* tap_off3, int ntaps,
                      float inv_h2, float gamma, int mode, int write_r,
                      cudaStream_t stream) {
  const Block b = make_block(bx, by, bz);
  const Box box{x0, x1, y0, y1, z0, z1};
  const Faces g{gxlo, gxhi, gylo, gyhi};
  const Taps t = block_taps(tap_val, tap_off3, ntaps, b);
  const Offs o = make_offs(tap_off3, ntaps);
  const dim3 grid = box_grid(box), block(kBZ, kBY);
  return dispatch(mode, reads_faces(box, b), [&](auto m, auto fc) {
    residual_block_kernel<decltype(m)::value, decltype(fc)::value>
        <<<grid, block, 0, stream>>>(r, partials, v, f, nv, g, b, box, t, o,
                                     inv_h2, gamma, write_r);
  });
}

// Coarse planes m0..m1; xzv is written in NONLINEAR mode only.
int mg_residual_restrict_block(
    float* xzr, float* rlast, float* xzv, const float* v, const float* f,
    const float* nv, const float* gxlo, const float* gxhi, const float* gylo,
    const float* gyhi, int bx, int by, int bz, int x0, int x1, int y0,
    int y1, int z0, int z1, int m0, int m1, int cnz, int cbz,
    const float* tap_val, const int* tap_off3, int ntaps, float inv_h2,
    float gamma, int mode, cudaStream_t stream) {
  const Block b = make_block(bx, by, bz);
  const Box box{x0, x1, y0, y1, z0, z1};
  const Faces g{gxlo, gxhi, gylo, gyhi};
  const Taps t = block_taps(tap_val, tap_off3, ntaps, b);
  const Offs o = make_offs(tap_off3, ntaps);
  const dim3 grid((cnz + kBZ - 1) / kBZ, (y1 - y0 + kBY) / kBY,
                  (m1 - m0 + kXCH) / kXCH);
  const dim3 block(kBZ, kBY);
  return dispatch(mode, reads_faces(box, b), [&](auto m, auto fc) {
    residual_restrict_kernel<decltype(m)::value, decltype(fc)::value>
        <<<grid, block, 0, stream>>>(xzr, rlast, xzv, v, f, nv, g, b, box,
                                     m0, m1, cnz, cbz, t, o, inv_h2, gamma);
  });
}

int mg_prolong_add_block(float* v, const float* casm, int bx, int by, int bz,
                         int x0, int x1, int y0, int y1, int z0, int z1,
                         int cyp, int czp, cudaStream_t stream) {
  const Block b = make_block(bx, by, bz);
  const Box box{x0, x1, y0, y1, z0, z1};
  const dim3 grid(((z1 >> 1) - (z0 >> 1) + kBZ) / kBZ, (y1 - y0 + kBY) / kBY,
                  (x1 - x0 + kXCH) / kXCH);
  prolong_add_block_kernel<<<grid, dim3(kBZ, kBY), 0, stream>>>(
      v, casm, b, box, cyp, czp);
  return (int)cudaGetLastError();
}

}  // extern "C"
