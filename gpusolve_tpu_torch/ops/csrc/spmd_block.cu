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
// byte).  Design: the sweep and the residual take the per-op kernels'
// tile, a 32(z) x 8(y) column of threads walking 8 x-planes, over the box,
// at their 40 registers (6 blocks per SM).  The prolongation gives each
// thread one coarse z column and the two fine points it feeds, as
// prolong_add does.
//
// residual_restrict reads v, f (and u~) once and writes a quarter of a
// field, so its bound is its loads.  A thread per coarse z column would
// evaluate each fine residual ~1.5 times (the odd z point its neighbour
// shares) and load each tap at half use (lanes two floats apart).  So
// each lane takes a pair of consecutive fine z, and the planes stream
// along x through a shared-memory ring with cp.async, two planes ahead of
// the one in use: each value of v is read once from device memory per
// block, each fine residual is computed once (a block's tile overlaps the
// next one by one fine z column, 1/62), the x weighting stays in
// registers and the z weighting takes the next lane's first value; FAS
// weighs v from the same ring.  r never reaches device memory.  Its cost
// is instructions more than bytes (~70 % of the byte bound at 511^3): a
// pair shares its loads of the in-line taps (8-byte loads), and each cell
// of a plane is one cp.async from a base the block computes once.
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

constexpr int kMinBlocks = 6;  // 40 registers, as multigrid.cu

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

// cp.async of 4 bytes from global src to shared address dst.
__device__ __forceinline__ void cp_async4(unsigned dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Waits until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// residual_restrict's tile: 8 warps, each on one fine row; a warp's lane
// l on the fine z pair kbase + 2l, kbase + 2l + 1 (lane 31's second point
// computes nothing), so a block covers kRRCz coarse z columns of kRRRows
// fine rows and walks x chunk by chunk.  Its ring holds v planes (the rows
// and z columns of the tile with a one-cell halo), f and NEWTON's u~ (the
// tile's cells), kRRDepth planes loaded ahead of the one in use.  A ring
// row keeps fine z kbase - 1 + c at c + 1, so each lane's pair is 8-byte
// aligned.
constexpr int kRRThreads = 256;
constexpr int kRRRows = kRRThreads / 32;
constexpr int kRRCz = 31;
constexpr int kRRCols = 2 * kRRCz + 3;            // 65 fine z of v a row
constexpr int kRRW = kRRCols + 1;                 // a ring row: 66 floats
constexpr int kRRCells = (kRRRows + 2) * kRRCols;  // v cells of a plane
constexpr int kRRVPlane = ((kRRRows + 2) * kRRW + 3) & ~3;
constexpr int kRRFPlane = kRRRows * 64;  // f / u~ plane, 64 floats a row
constexpr int kRRDepth = 2;
constexpr int kRRSlots = kRRDepth + 3;  // planes p-1, p, p+1 and in flight
constexpr int kRRVCells = (kRRCells + kRRThreads - 1) / kRRThreads;
constexpr int kRRMinBlocks = 4;  // 64 registers: the most without a spill

// Floats of one ring slot (a v plane, f, NEWTON's u~) and bytes of the
// ring, the kernel's dynamic shared memory (at most the 48 KB a launch
// takes without an opt-in).
__host__ __device__ constexpr int rr_slot_floats(int mode) {
  return kRRVPlane + (mode == kNewton ? 2 : 1) * kRRFPlane;
}

constexpr int rr_smem_bytes(int mode) {
  return 4 * kRRSlots * rr_slot_floats(mode);
}
static_assert(rr_smem_bytes(kNewton) <= 48 * 1024, "ring too large");

// The stencil for residual_restrict: values, x offsets, and each tap's
// offset in a ring plane (oy kRRW + oz).
struct RTaps {
  float val[kMaxTaps];
  int ox[kMaxTaps], toff[kMaxTaps];
  int n;
};

inline RTaps make_rtaps(const float* val, const int* off3, int ntaps) {
  RTaps t;
  t.n = ntaps;
  for (int q = 0; q < kMaxTaps; ++q) {
    t.val[q] = q < ntaps ? val[q] : 0.0f;
    t.ox[q] = q < ntaps ? off3[3 * q] : 0;
    t.toff[q] = q < ntaps ? off3[3 * q + 1] * kRRW + off3[3 * q + 2] : 0;
  }
  return t;
}

// Coarse x-planes m0..m1, xc a block (blockIdx.z), fine rows of the box,
// coarse z 1..cnz.  Coarse plane m reads r planes 2m-1, 2m, 2m+1; plane -1
// is 0 here (the caller adds 0.25 r_last_z of the lower x neighbour).
// Outputs xzr, xzv (cbx, by, cbz); rlast (by, cbz), written by the walk
// that computes plane bx-1.  FAS: the same restriction of v, plane -1 the
// lower x ghost face.
//
// A block streams the v planes 2ma-2 .. 2mb of its chunk through the ring
// (cp.async, each value read once from device memory; taps that leave the
// block read the ghost faces, a z tap past the block 0), computes each
// fine residual of planes 2ma-1 .. 2mb-1 once, weighs it along x in
// registers (the odd plane carried to the next coarse plane) and along z
// in the lane and its upper neighbour (__shfl_down_sync); FAS restricts v
// from the same ring cells.  kCanon: the canonical taps, each pair's five
// in-line taps as 8-byte loads; else the taps by their offsets, in tap
// order.
template <int M, bool kFaces, bool kCanon>
__global__ void __launch_bounds__(kRRThreads, kRRMinBlocks)
residual_restrict_kernel(float* __restrict__ xzr, float* __restrict__ rlast,
                         float* __restrict__ xzv, const float* __restrict__ v,
                         const float* __restrict__ f,
                         const float* __restrict__ nv, Faces g, Block b,
                         Box box, int m0, int m1, int cnz, int cbz, int xc,
                         RTaps t, float inv_h2, float gamma) {
  constexpr bool kFas = M == kNonlinear;
  constexpr int kSlot = rr_slot_floats(M);
  extern __shared__ __align__(16) float ring[];

  const int kca = 1 + blockIdx.x * kRRCz;  // the block's first coarse z
  const int y_t = box.y0 + blockIdx.y * kRRRows;
  const int ma = m0 + blockIdx.z * xc;
  const int mb = min(ma + xc, m1 + 1);
  if (kca > cnz || y_t > box.y1 || ma > m1) return;
  const int kbase = 2 * kca - 1;  // lane 0's first fine z
  const int tid = threadIdx.x, w = tid >> 5, l = tid & 31;
  const int j = y_t + w, k = kbase + 2 * l;  // this thread's row and pair

  // The ring starts at 0: a cell that no plane writes (past the block
  // along y or z) reads 0.  A cell a plane leaves as the plane before it
  // wrote it (a y ghost row at an x ghost plane, f outside the box) feeds
  // only points outside the box.
  for (int c = tid; c < kRRSlots * kSlot; c += kRRThreads) ring[c] = 0.0f;
  __syncthreads();

  // This thread's v cells of a ring plane (c = tid + q kRRThreads, row
  // c / kRRCols): kind 1 a row of the block (its x ghost planes are the x
  // faces), 2 / 3 the lower / upper y ghost face (kFaces), 0 none; yz the
  // cell's offset in a plane of v, of an x face, or (2, 3) of a y face;
  // vs its index in a ring plane.
  int vkind[kRRVCells], vyz[kRRVCells], vs[kRRVCells];
#pragma unroll
  for (int q = 0; q < kRRVCells; ++q) {
    const int c = tid + q * kRRThreads;
    const int row = c / kRRCols, col = c - row * kRRCols;
    const int jr = y_t - 1 + row, kr = kbase - 1 + col;
    const bool in = c < kRRCells && kr < b.bz;
    const bool ghost = kFaces && in && (jr == -1 || jr == b.by);
    vkind[q] = in && jr >= 0 && jr < b.by ? 1 : ghost ? (jr < 0 ? 2 : 3) : 0;
    vyz[q] = ghost ? kr : jr * b.bz + kr;
    vs[q] = row * kRRW + col + 1;
  }
  // Whether each of this thread's points is in the box (lane 31's second
  // is no point), and the pair's offset in a plane of f.
  bool fok[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    fok[e] = 2 * l + e < 2 * kRRCz + 1 && j <= box.y1 && k + e >= box.z0 &&
             k + e <= box.z1;
  }
  const int foff = j * b.bz + k;
  const unsigned ring_a = smem_addr(ring);
  const int fcell = w * 64 + 2 * l;          // the pair in an f plane
  const int cell = (1 + w) * kRRW + 2 * l + 2;  // the pair in a v plane

  // Plane i into ring slot s: a plane of the block (v, f, u~), or an x
  // ghost face (the block's rows); nothing past those.  Each cell's source
  // is the plane's base (uniform) plus the cell's offset.
  auto load_plane = [&](int i, int s) {
    const unsigned d = ring_a + 4u * (unsigned)(s * kSlot);
    if ((unsigned)i < (unsigned)b.bx) {
      const long long ioff = (long long)i * b.sx;
      const float* vpl = v + ioff;
#pragma unroll
      for (int q = 0; q < kRRVCells; ++q) {
        if (vkind[q] == 1) {
          cp_async4(d + 4u * vs[q], vpl + vyz[q]);
        } else if (kFaces && vkind[q] > 1) {
          cp_async4(d + 4u * vs[q], (vkind[q] == 2 ? g.ylo : g.yhi) +
                                        (long long)i * b.bz + vyz[q]);
        }
      }
      if (i >= box.x0 && i <= box.x1) {
        const unsigned df = d + 4u * (unsigned)(kRRVPlane + fcell);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (fok[e]) {
            cp_async4(df + 4u * e, f + ioff + foff + e);
            if constexpr (M == kNewton) {
              cp_async4(df + 4u * (kRRFPlane + e), nv + ioff + foff + e);
            }
          }
        }
      }
    } else if (i == -1 || i == b.bx) {
      const float* xf = i < 0 ? g.xlo : g.xhi;
#pragma unroll
      for (int q = 0; q < kRRVCells; ++q) {
        if (vkind[q] == 1) cp_async4(d + 4u * vs[q], xf + vyz[q]);
      }
    }
  };

  // Planes qlo .. qhi go through the ring, plane q in slot
  // (q - qlo) mod kRRSlots; each step issues the plane kRRDepth + 1 past
  // the one it computes.
  const int qlo = 2 * ma - 2, qhi = 2 * mb;
  int q_next = qlo, s_next = 0;
  auto issue = [&]() {
    if (q_next <= qhi) load_plane(q_next, s_next);
    cp_async_commit();
    ++q_next;
    s_next = s_next + 1 == kRRSlots ? 0 : s_next + 1;
  };
#pragma unroll
  for (int d = 0; d < kRRDepth + 2; ++d) issue();

  // The residual of plane p at this thread's pair (0 outside the box) and
  // v there; sc is plane p's slot.
  int sc = 1;
  auto step = [&](int p, float2& res, float2& cv) {
    cp_async_wait<kRRDepth - 1>();  // plane p + 1 has landed
    __syncthreads();                // everyone's, and slot p - 2 is free
    issue();
    const int sm = sc == 0 ? kRRSlots - 1 : sc - 1;
    const int sp = sc + 1 == kRRSlots ? 0 : sc + 1;
    const float* v0 = ring + sc * kSlot + cell;
    const float* f0 = ring + sc * kSlot + kRRVPlane + fcell;
    const float2 c = *reinterpret_cast<const float2*>(v0);
    float a0, a1;
    if constexpr (kCanon) {
      auto pair = [](const float* q) {
        return *reinterpret_cast<const float2*>(q);
      };
      const float2 xp = pair(ring + sp * kSlot + cell);
      const float2 xm = pair(ring + sm * kSlot + cell);
      const float2 yp = pair(v0 + kRRW), ym = pair(v0 - kRRW);
      const float g0[kMaxTaps] = {c.x, xp.x, xm.x, yp.x, ym.x, c.y, v0[-1]};
      const float g1[kMaxTaps] = {c.y, xp.y, xm.y, yp.y, ym.y, v0[2], c.x};
      a0 = __fmul_rn(t.val[0], g0[0]);
      a1 = __fmul_rn(t.val[0], g1[0]);
#pragma unroll
      for (int q = 1; q < kMaxTaps; ++q) {
        a0 = __fadd_rn(a0, __fmul_rn(t.val[q], g0[q]));
        a1 = __fadd_rn(a1, __fmul_rn(t.val[q], g1[q]));
      }
    } else {
      auto tap = [&](int q) {
        return ring + (t.ox[q] < 0 ? sm : t.ox[q] > 0 ? sp : sc) * kSlot +
               t.toff[q] + cell;
      };
      a0 = __fmul_rn(t.val[0], tap(0)[0]);
      a1 = __fmul_rn(t.val[0], tap(0)[1]);
#pragma unroll
      for (int q = 1; q < kMaxTaps; ++q) {
        if (q < t.n) {
          a0 = __fadd_rn(a0, __fmul_rn(t.val[q], tap(q)[0]));
          a1 = __fadd_rn(a1, __fmul_rn(t.val[q], tap(q)[1]));
        }
      }
    }
    const float2 fv = *reinterpret_cast<const float2*>(f0);
    float2 n = make_float2(0.0f, 0.0f);
    if constexpr (M == kNewton) {
      n = *reinterpret_cast<const float2*>(f0 + kRRFPlane);
    }
    // f - (A v / h^2 + the mode term), as residual_at orders it.  Every
    // lane evaluates (the ring holds finite values everywhere); points
    // outside the box keep 0.
    auto point = [&](float acc, float vc, float fq, float nq) {
      return __fsub_rn(fq, operator_point<M>(
                               __fmul_rn(acc, inv_h2), [&] { return vc; },
                               [&] { return nq; }, gamma));
    };
    const bool xin = p >= box.x0 && p <= box.x1;
    const float r0 = point(a0, c.x, fv.x, n.x);
    const float r1 = point(a1, c.y, fv.y, n.y);
    res = make_float2(xin && fok[0] ? r0 : 0.0f, xin && fok[1] ? r1 : 0.0f);
    cv = c;
    sc = sp;
  };

  const long long cs = (long long)b.by * cbz;
  const int kc = kca + l;
  // weigh3 along z of the pair x and the next lane's first value into out
  // at the lanes that own a coarse z column of the box's rows.
  auto put_z = [&](float2 x, float* out) {
    const float x2 = __shfl_down_sync(0xffffffffu, x.x, 1);
    if (l < kRRCz && kc <= cnz && j <= box.y1) {
      out[(long long)j * cbz + kc] = weigh3(x.x, x.y, x2);
    }
  };
  auto wx = [](float2 a, float2 b, float2 c) {
    return make_float2(weigh3(a.x, b.x, c.x), weigh3(a.y, b.y, c.y));
  };
  float2 rprev, vprev, re, ve, ro, vo;
  step(2 * ma - 1, rprev, vprev);
  for (int m = ma; m < mb; ++m) {
    step(2 * m, re, ve);
    step(2 * m + 1, ro, vo);
    put_z(wx(rprev, re, ro), xzr + m * cs);
    if (2 * m + 1 == b.bx - 1) put_z(ro, rlast);
    if constexpr (kFas) put_z(wx(vprev, ve, vo), xzv + m * cs);
    rprev = ro;
    vprev = vo;
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

// Coarse planes m0..m1, xc a block; xzv is written in NONLINEAR mode only.
int mg_residual_restrict_block(
    float* xzr, float* rlast, float* xzv, const float* v, const float* f,
    const float* nv, const float* gxlo, const float* gxhi, const float* gylo,
    const float* gyhi, int bx, int by, int bz, int x0, int x1, int y0,
    int y1, int z0, int z1, int m0, int m1, int cnz, int cbz, int xc,
    const float* tap_val, const int* tap_off3, int ntaps, float inv_h2,
    float gamma, int mode, cudaStream_t stream) {
  if (xc < 1) return (int)cudaErrorInvalidValue;
  const Block b = make_block(bx, by, bz);
  const Box box{x0, x1, y0, y1, z0, z1};
  const Faces g{gxlo, gxhi, gylo, gyhi};
  const RTaps t = make_rtaps(tap_val, tap_off3, ntaps);
  const bool canon = canonical_taps(tap_off3, ntaps);
  const dim3 grid((cnz + kRRCz - 1) / kRRCz, (y1 - y0 + kRRRows) / kRRRows,
                  (m1 - m0 + xc) / xc);
  return dispatch(mode, reads_faces(box, b), [&](auto m, auto fc) {
    constexpr int M = decltype(m)::value;
    constexpr bool F = decltype(fc)::value;
    auto launch = [&](auto kernel) {
      kernel<<<grid, kRRThreads, rr_smem_bytes(M), stream>>>(
          xzr, rlast, xzv, v, f, nv, g, b, box, m0, m1, cnz, cbz, xc, t,
          inv_h2, gamma);
    };
    if (canon) {
      launch(residual_restrict_kernel<M, F, true>);
    } else {
      launch(residual_restrict_kernel<M, F, false>);
    }
  });
}

// *out: the blocks of residual_restrict_kernel (the mode's face-free,
// canonical-tap instantiation) the current device holds at once, by the
// occupancy calculator: blocks an SM times its SMs.
int mg_residual_restrict_resident(int mode, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return (int)err;
  const int rc = dispatch(mode, false, [&](auto m, auto) {
    constexpr int M = decltype(m)::value;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, residual_restrict_kernel<M, false, true>, kRRThreads,
        rr_smem_bytes(M));
  });
  *out = per_sm * sms;
  return rc != 0 ? rc : (int)err;
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
