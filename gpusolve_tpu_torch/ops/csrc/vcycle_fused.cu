// One whole multigrid V-cycle of any mode (LINEAR, FAS, NEWTON) in ONE
// cooperative launch, for Hopper (sm_90a).
//
// Replaces gpusolve_tpu/ops/pallas_vcycle.py::_vcycle_call, the TPU's v1
// whole-cycle kernel.  The host (ops/vcycle_fused.py) builds the cycle's
// static schedule, the TPU kernel's, and passes it as a table of ops: kind,
// level and which of the level's two buffers (the one holding v at the
// start of the cycle, or its spare) each op reads and writes.  The level
// table (buffer pointers, geometry, stencil, scalars) rides in the kernel
// parameters.  Every block walks the ops in order; each op is a grid-stride
// loop over the per-op kernels' tiles (mg_device.cuh), and a grid-wide
// barrier (cooperative_groups::this_grid().sync()) follows each op.
//
// Bound: bytes, as the per-op kernels (each op streams its fields once at a
// few flops per point).  The design moves the same bytes as the per-op
// cycle, less the coarse-level zero fill: a level that starts from v = 0
// takes its first sweep without reading v (LdZero).  What it must do is run
// each op at its per-op kernel's speed, inside one launch:
//
//   * Fixed levels.  Levels 0 and 1 (nearly all the bytes) with the
//     canonical taps (the examples' 7-point order, kCanonOff) run bodies
//     compiled for that level and for each choice of buffers (by_buffer):
//     every pointer, stride and tap value is a constant-bank operand and
//     uniform across the block, as in a per-op kernel, where an index into
//     the level table costs registers and instructions on every load.  Any
//     other level, and any other tap order, runs one body that indexes the
//     table (run_op<M, -1>).
//   * Loads.  Level 0's f and NEWTON's u~ are written by no op of the
//     cycle (launch() in ops/vcycle_fused.py refuses fields that
//     overlap), so they go through the read-only cache (LdNC, __ldg),
//     which is safe only for data no thread writes while the kernel runs.
//     v, r, the coarse levels' f and FAS's rest_v are written by some op,
//     and a read-only load of them could return a line cached before a
//     grid barrier; so they are plain loads, and no field pointer is
//     __restrict__, which would let the compiler make a plain load of a
//     field it sees no store to a read-only one (dropping it changed
//     neither the SASS's read-only load count nor any op's time).  So
//     the fixed sweeps and residuals (canon_tile) read each value of v
//     once, carry x - 1 and the centre in registers and load the next
//     plane's x + 1 tap and f before the store, in program order, and the
//     fixed prolongation loads a plane ahead (prolong_add_tile).
//   * Registers.  Each mode runs at the most blocks an SM with which no
//     path spills (kVMinBlocks): LINEAR 6 blocks of 256 threads (40
//     registers), NEWTON 5 (48), FAS 4 (64).  The op loop keeps its state
//     in shared memory, not in registers through the ops; the body that
//     indexes the level table loads each point's values before its
//     arithmetic (jacobi_tile and residual_tile with kEager); the norm,
//     which carries a per-tile sum, runs on level 0's fixed operands
//     whatever the taps (norm0), not in that body.  With these they fit.
//     (ptxas's choices move with the code's shape: with the coarse tail's
//     second copy of the op dispatch taken out, and nothing else changed,
//     FAS and NEWTON spilled 900 and 360 bytes; spilling, FAS's cycle ran
//     1.24x slower on an H100.)
//   * Barriers.  From the first level whose passes are one tile (7^3 on
//     2^k - 1 grids, tail_level in ops/vcycle_fused.py) block 0 runs the
//     rest of the cycle, down and back up, with __syncthreads between ops,
//     while the other blocks wait at one grid barrier: 43-46 of a V(6,6)
//     cycle's ops at 511^3, 0.2-0.5 % of its time on an H100.  (A cluster
//     of 8 blocks with barrier.cluster would cost the cooperative grid
//     blocks: a launch of 8-block clusters holds fewer resident blocks
//     than the SMs do; and these levels are one tile, one block's work.)
//     The norm's per-tile partials take one block barrier a tile, not two
//     (partials_add).
//   * Tile order.  The transfers' passes (restriction, tau fold,
//     prolongation) take each block's tiles past its first from a
//     per-op counter as blocks come free (for_tiles_dyn): a level-0
//     prolongation 0.58 -> 0.46 ms, a restriction 0.234 -> 0.217
//     (LINEAR, 511^3, H100 80GB HBM3).  The other ops keep the
//     round-robin deal: with the counter on every op ptxas spilled and
//     the sweeps ran slower.
//
// Rounding: the per-op kernels' point functions (mg_device.cuh:
// stencil_sum, jacobi_point, operator_point, restrict_at, prolong_corr),
// each product and sum its own __f*_rn, in the same order, so every field
// equals the per-op cycle's bit for bit, and the norm too: the final
// level-0 residual writes each tile's partial at the index residual_kernel
// uses, summed as block_sum sums a tile, and block 0 sums them as
// finalize_kernel does.  The TPU kernel rounds otherwise (taps that share
// a coefficient summed before the multiply, (omega alpha) f for a
// zero-start sweep, a Kahan sum of plane sums); the port keeps its own
// order throughout.
//
// FAS: the up leg prolongs v - rest_v computed on the fly and leaves the
// coarse v as it is, as the TPU kernel does (the per-op cycle subtracts in
// place instead).  The tau fold f_c = R(r) + A_c(rest_v) is one op, rounded
// as the per-op restrict + apply_fas.
//
// The launch needs every block resident (cudaLaunchCooperativeKernel); a
// grid larger than that fails with cudaErrorCooperativeLaunchTooLarge and
// the wrapper raises.  Grid: SMs x the occupancy calculator's blocks per
// SM.  grid.sync() needs <cooperative_groups.h> but no relocatable device
// code with the CUDA 12 toolkit.

#include <cooperative_groups.h>

#include <type_traits>

#include "mg_device.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLevels = 16;
// Blocks of 256 threads an SM, each mode's most with which ptxas spills
// nothing: LINEAR 6 (40 registers), NEWTON 5 (48), FAS 4 (64; at 5 its
// coarse levels' transfers spill).
template <int M>
constexpr int kVMinBlocks = M == kLinear ? 6 : M == kNewton ? 5 : 4;

// Op kinds; ops/vcycle_fused.py numbers them the same.  An op is int4
// {kind, level, a, b}:
//   ZERO      v buffer a of level = 0 (a zero start with no sweep)
//   SMOOTH0   sweep from v = 0 into buffer a
//   SMOOTH    sweep from buffer a into the other one (b = 1 - a)
//   RESIDUAL  r of v in buffer a into the other one (b = 1 - a)
//   RESTRICT  coarse f = R(buffer a)                    (LINEAR, NEWTON)
//   RESTRICTV coarse v buffer 0 = coarse rest_v = R(buffer a)      (FAS)
//   FASF      coarse f = R(buffer a) + A_c(coarse rest_v)          (FAS)
//   PROLONG   level-1 buffer 1-b = level-1 buffer b + P(coarse buffer a
//             [- rest_v in FAS]); `level` is the coarse level
//   NORM      level-0 residual of v in buffer a: per-tile sums of r^2
//   FINALIZE  block 0: the sum of the partials into norm_out
// The host passes the coarse tail as a range of the table (tail_range in
// ops/vcycle_fused.py).
enum : int {
  kOpZero = 0,
  kOpSmooth0 = 1,
  kOpSmooth = 2,
  kOpResidual = 3,
  kOpRestrict = 4,
  kOpRestrictV = 5,
  kOpFasF = 6,
  kOpProlong = 7,
  kOpNorm = 8,
  kOpFinalize = 9,
};

struct Level {
  float* buf[2];  // [0]: holds v when the cycle starts; [1]: its spare
  float* f;
  float* aux;     // newton_v (NEWTON), rest_v (FAS), else null
  Geom g;
  Taps taps;
  float inv_h2, alpha, pre_fac;
};

struct Args {
  Level lv[kMaxLevels];
  float omega, gamma;
  double* partials;  // one per level-0 tile
  float* norm_out;   // sum r^2 of the final residual, float32
  unsigned* tile_ctr;  // one tile counter per op, 0 at the launch
  int tail_begin, tail_end;  // the coarse tail: ops [begin, end), block 0
  int canon;  // the taps are the canonical 7-point order (kCanonOff)
};

// The canonical tap order, the examples' 7-point stencil: the centre, x + 1,
// x - 1, y + 1, y - 1, z + 1, z - 1 (as (x, y, z) offsets).
constexpr int kCanonOff[3 * kMaxTaps] = {0, 0, 0, 1, 0, 0, -1, 0, 0, 0, 1,
                                         0, 0, -1, 0, 0, 0, 1, 0, 0, -1};

// The taps an op of level L evaluates.  kC: the canonical order, its
// offsets made from L's strides here (the z neighbours fold into the
// loads' immediate offsets, the others are uniform) and all seven taps
// present; the same values and order as L.taps.
template <bool kC>
__device__ __forceinline__ Taps op_taps(const Level& L) {
  if constexpr (kC) {
    Taps t;
    t.n = kMaxTaps;
#pragma unroll
    for (int q = 0; q < kMaxTaps; ++q) t.val[q] = L.taps.val[q];
    const int sx = (int)L.g.sx, sy = (int)L.g.sy;
    t.off[0] = 0;
    t.off[1] = sx;
    t.off[2] = -sx;
    t.off[3] = sy;
    t.off[4] = -sy;
    t.off[5] = 1;
    t.off[6] = -1;
    return t;
  } else {
    return L.taps;
  }
}

// Which tiles of a pass a block takes: first, first + stride, ...  The
// whole grid deals them round-robin (blockIdx.x, gridDim.x); the coarse
// tail's one block takes them all (0, 1).
struct Deal {
  unsigned first, stride;
};

// This op's tile counter (thread 0 points it at the op's slot of
// Args::tile_ctr before the op) and the next tile of a block's two
// latest tiles, in shared memory.
__device__ __forceinline__ unsigned*& op_counter() {
  __shared__ unsigned* ctr;
  return ctr;
}
__device__ __forceinline__ unsigned* next_tile() {
  __shared__ unsigned next[2];
  return next;
}

// for_tiles with the tiles past each block's first taken from the op's
// counter as blocks come free, not dealt round-robin: the transfers'
// passes.  Thread 0 takes the block's next tile while the block works on
// this one; a block barrier a tile publishes it, and a block writes a
// slot of next_tile again only past the next tile's barrier.  Passes of
// no more tiles than blocks, and the coarse tail's, are dealt as in
// for_tiles.
template <class Body>
__device__ __forceinline__ void for_tiles_dyn(const dim3 gr, const Deal d,
                                              Body body) {
  const unsigned n = gr.x * gr.y * gr.z;
  unsigned t = d.first;
  if (d.stride == 1 || n <= d.stride) {
    for (; t < n; t += d.stride) {
      const unsigned rest = t / gr.x;
      body(t, t % gr.x, rest % gr.y, rest / gr.y);
    }
    return;
  }
  unsigned* ctr = op_counter();
  int s = 0;
  while (t < n) {
    if (threadIdx.x == 0) next_tile()[s] = d.stride + atomicAdd(ctr, 1u);
    const unsigned rest = t / gr.x;
    body(t, t % gr.x, rest % gr.y, rest / gr.y);
    __syncthreads();
    t = next_tile()[s];
    s ^= 1;
  }
}

// Calls body(t, bx, by, bz) for this block's tiles of a pass over grid gr.
template <class Body>
__device__ __forceinline__ void for_tiles(const dim3 gr, const Deal d,
                                          Body body) {
  const unsigned n = gr.x * gr.y * gr.z;
  for (unsigned t = d.first; t < n; t += d.stride) {
    const unsigned rest = t / gr.x;
    body(t, t % gr.x, rest % gr.y, rest / gr.y);
  }
}

// The stencil tile (bx, by, bz) of an op over the canonical taps
// (kCanonOff), plane by plane as jacobi_tile and residual_tile walk it,
// each value of v read once: plane i's x - 1 and centre taps are plane
// i - 1's centre and x + 1 taps, kept in registers, and plane i + 1's x + 1
// tap and f, the lines no earlier plane brought into L1, are loaded before
// plane i is stored.  (v is read with plain loads, which the compiler keeps
// after any store before them.)  point(idx, g, fv, n) gets the point's
// taps in tap order, its f and u~ (NEWTON).
template <int M, class LdF, class Point>
__device__ __forceinline__ void canon_tile(int bx, int by, int bz, int tz,
                                           int ty, const float* v,
                                           const float* f, const float* nv,
                                           const Geom& gm, Point point) {
  const int k = bx * kBZ + tz + 1;
  const int j = by * kBY + ty + 1;
  if (k > gm.nz || j > gm.ny) return;
  const int i0 = bz * kXCH + 1;
  const int i1 = min(i0 + kXCH, gm.nx + 1);
  long long idx = i0 * gm.sx + j * gm.sy + k;
  float xm = v[idx - gm.sx], c = v[idx], xp = v[idx + gm.sx];
  float fv = LdF::tap(f + idx);
  for (int i = i0; i < i1; ++i, idx += gm.sx) {
    const float g[kMaxTaps] = {c,
                               xp,
                               xm,
                               v[idx + gm.sy],
                               v[idx - gm.sy],
                               v[idx + 1],
                               v[idx - 1]};
    float n = 0.0f;
    if constexpr (M == kNewton) n = LdNC::tap(nv + idx);
    const float fi = fv;
    xm = c;
    c = xp;
    if (i + 1 < i1) {
      xp = v[idx + 2 * gm.sx];
      fv = LdF::tap(f + idx + gm.sx);
    }
    point(idx, g, fi, n);
  }
}

// A v / h^2 plus the mode term at a point of canon_tile: its taps g (g[0]
// its v) and u~ n.
template <int M>
__device__ __forceinline__ float canon_operator(const float* g, float n,
                                                const Taps& taps,
                                                float inv_h2, float gamma) {
  return operator_point<M>(
      stencil_sum([&](int k) { return g[k]; }, taps, inv_h2),
      [&] { return g[0]; }, [&] { return n; }, gamma);
}

// The op bodies.  Within one op no buffer it writes is one it reads
// (ops/vcycle_fused.py); the pointers are not __restrict__ all the same
// (see Loads in the note above).  LdF is the load policy of f; kC: the
// canonical taps (canon_tile), taps then holds their values.

template <int M, class Ld, class LdF, bool kC>
__device__ __forceinline__ void smooth_op(float* d, const float* s,
                                          const float* f, const float* nv,
                                          const Level& L, const Taps& taps,
                                          float omega, float gamma, int tz,
                                          int ty, const Deal dl) {
  const ModeArgs ma{gamma, L.pre_fac};
  const dim3 gr = grid_for(L.g);
  if constexpr (kC) {
    for_tiles(gr, dl, [&](unsigned, int bx, int by, int bz) {
      canon_tile<M, LdF>(
          bx, by, bz, tz, ty, s, f, nv, L.g,
          [&](long long idx, const float* g, float fv, float n) {
            d[idx] = jacobi_point<M>(
                stencil_sum([&](int k) { return g[k]; }, taps, L.inv_h2),
                [&] { return g[0]; }, [&] { return fv; }, [&] { return n; },
                L.alpha, omega, ma);
          });
    });
  } else {
    for_tiles(gr, dl, [&](unsigned, int bx, int by, int bz) {
      jacobi_tile<M, Ld, LdF, true>(bx, by, bz, tz, ty, d, s, f, nv, L.g,
                                    taps, L.inv_h2, L.alpha, omega, ma);
    });
  }
}

template <int M, class LdF, bool kC>
__device__ __forceinline__ void residual_op(float* r, const float* v,
                                            const float* f, const float* nv,
                                            const Level& L, const Taps& taps,
                                            float gamma, int tz, int ty,
                                            const Deal dl) {
  const dim3 gr = grid_for(L.g);
  if constexpr (kC) {
    for_tiles(gr, dl, [&](unsigned, int bx, int by, int bz) {
      canon_tile<M, LdF>(
          bx, by, bz, tz, ty, v, f, nv, L.g,
          [&](long long idx, const float* g, float fv, float n) {
            r[idx] = __fsub_rn(fv, canon_operator<M>(g, n, taps, L.inv_h2,
                                                     gamma));
          });
    });
  } else {
    for_tiles(gr, dl, [&](unsigned, int bx, int by, int bz) {
      residual_tile<M, LdPlain, LdF, true>(bx, by, bz, tz, ty, v, f, nv, r,
                                           L.g, taps, L.inv_h2, gamma, true);
    });
  }
}

// partials[t] = the block's sum of ss, in block_sum's order: each warp's
// shuffle tree, then the warp sums added in warp order onto 0.0.  A
// block's successive tiles take alternate slots (slot), so one barrier a
// tile does: a warp writes a slot again only past the next tile's
// barrier, which thread 0 reaches after it has read the slot.
__device__ __forceinline__ void partials_add(double* partials, unsigned t,
                                             double ss, int slot) {
  constexpr int kWarps = kThreads / 32;
  __shared__ double ws[2][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_down_sync(0xffffffffu, ss, o);
  if (lane == 0) ws[slot][warp] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    double total = 0.0;
    for (int w = 0; w < kWarps; ++w) total += ws[slot][w];
    partials[t] = total;
  }
}

template <int M, class LdF, bool kC>
__device__ __forceinline__ void norm_op(double* partials, const float* v,
                                        const float* f, const float* nv,
                                        const Level& L, const Taps& taps,
                                        float gamma, int tz, int ty,
                                        const Deal dl) {
  int slot = 0;
  for_tiles(grid_for(L.g), dl, [&](unsigned t, int bx, int by, int bz) {
    double ss = 0.0;
    if constexpr (kC) {
      canon_tile<M, LdF>(
          bx, by, bz, tz, ty, v, f, nv, L.g,
          [&](long long, const float* g, float fv, float n) {
            const float res = __fsub_rn(
                fv, canon_operator<M>(g, n, taps, L.inv_h2, gamma));
            ss += (double)res * (double)res;
          });
    } else {
      ss = residual_tile<M, LdPlain, LdF, true>(bx, by, bz, tz, ty, v, f, nv,
                                                nullptr, L.g, taps, L.inv_h2,
                                                gamma, false);
    }
    partials_add(partials, t, ss, slot);
    slot ^= 1;
  });
}

__device__ __forceinline__ void zero_op(float* d, const Geom& g, int tz, int ty,
                                        const Deal dl) {
  for_tiles(grid_for(g), dl, [&](unsigned, int bx, int by, int bz) {
    const int k = bx * kBZ + tz + 1;
    const int j = by * kBY + ty + 1;
    if (k > g.nz || j > g.ny) return;
    const int i1 = min(bz * kXCH + 1 + kXCH, g.nx + 1);
    for (int i = bz * kXCH + 1; i < i1; ++i) d[i * g.sx + j * g.sy + k] = 0.0f;
  });
}

// out = R(in); out2 too when given (FAS: the coarse v and rest_v).
__device__ __forceinline__ void restrict_op(float* out, float* out2,
                                            const float* in, const Geom& c,
                                            const Geom& fg, int tz, int ty,
                                            const Deal dl) {
  for_tiles_dyn(grid_for(c), dl, [&](unsigned, int bx, int by, int bz) {
    restrict_tile(bx, by, bz, tz, ty, c, fg,
                  [&](long long cidx, long long center) {
                    const float acc = restrict_at<LdPlain>(in, center, fg);
                    out[cidx] = acc;
                    if (out2 != nullptr) out2[cidx] = acc;
                  });
  });
}

// The FAS tau fold: out = R(in) + A_c(rv), rounded as restrict + apply_fas.
__device__ __forceinline__ void fas_f_op(float* out, const float* in,
                                         const float* rv, const Level& C,
                                         const Taps& ctaps, const Geom& fg,
                                         float gamma, int tz, int ty,
                                         const Deal dl) {
  for_tiles_dyn(grid_for(C.g), dl, [&](unsigned, int bx, int by, int bz) {
    restrict_tile(bx, by, bz, tz, ty, C.g, fg,
                  [&](long long cidx, long long center) {
                    const float rr = restrict_at<LdPlain>(in, center, fg);
                    out[cidx] = __fadd_rn(
                        rr, operator_at<kNonlinear, LdPlain>(
                                rv, nullptr, cidx, ctaps, C.inv_h2, gamma));
                  });
  });
}

// d = fv + P(cv [- rv in FAS]).  kAhead: each plane's values loaded
// before the plane below it is stored (prolong_add_tile): the fixed levels,
// and LINEAR's coarse levels too; FAS's and NEWTON's coarse levels keep
// prolong_tile's fewer live values (with the other, their kernels spill).
template <int M, bool kAhead>
__device__ __forceinline__ void prolong_op(float* d, const float* fv,
                                           const float* cv, const float* rv,
                                           const Geom& fg, const Geom& c,
                                           int tz, int ty, const Deal dl) {
  auto coarse = [&](long long q) {
    if constexpr (M == kNonlinear) {
      return __fsub_rn(cv[q], rv[q]);
    } else {
      return cv[q];
    }
  };
  const dim3 gr = prolong_grid_for(fg);
  for_tiles_dyn(gr, dl, [&](unsigned, int bx, int by, int bz) {
    if constexpr (kAhead) {
      prolong_add_tile(
          bx, by, bz, tz, ty, fg, c, coarse,
          [&](long long idx) { return fv[idx]; },
          [&](long long idx, float x) { d[idx] = x; });
    } else {
      prolong_tile(bx, by, bz, tz, ty, fg, c, coarse,
                   [&](long long idx, float e) {
                     d[idx] = __fadd_rn(fv[idx], e);
                   });
    }
  });
}

// Calls fn(buffer z of level L, its other buffer).  Where the level is
// fixed (K >= 0) each of the two calls reads its pointers at fixed offsets
// of the kernel parameters, so they are uniform across the block, as the
// per-op kernels' are, and so is every tap address made from them.
template <int K, class Fn>
__device__ __forceinline__ void by_buffer(const Level& L, int z, Fn&& fn) {
  if constexpr (K >= 0) {
    if (z == 0) {
      fn(L.buf[0], L.buf[1]);
    } else {
      fn(L.buf[1], L.buf[0]);
    }
  } else {
    fn(L.buf[z], L.buf[1 - z]);
  }
}

// One op whose fine level is K (0 or 1: the level's fields and geometry
// are read at fixed offsets of the kernel parameters, as the per-op
// kernels read theirs), or fl when K < 0.  The fine level of a
// prolongation is the one below its coarse level op.y.  kC: the taps are
// the canonical order (op_taps).
template <int M, int K>
__device__ __forceinline__ void run_op(const int4 op, const Args& a, int fl,
                                       int tz, int ty, const Deal dl) {
  constexpr bool kC = K >= 0;
  const int l = K >= 0 ? K : fl;
  const Level& L = a.lv[l];
  // The coarse level, for the transfers (never past the table: a
  // transfer's fine level is not the last).
  const Level& C = a.lv[min(l + 1, kMaxLevels - 1)];
  // Level 0's f is written by no op of the cycle: the read-only cache.
  using LdF = std::conditional_t<K == 0, LdNC, LdPlain>;
  switch (op.x) {
    case kOpZero:
      zero_op(L.buf[op.z], L.g, tz, ty, dl);
      break;
    case kOpSmooth0: {
      float* d = L.buf[op.z];
      smooth_op<M, LdZero, LdF, false>(d, d, L.f, L.aux, L, L.taps, a.omega,
                                       a.gamma, tz, ty, dl);
      break;
    }
    case kOpSmooth:
      by_buffer<K>(L, op.z, [&](const float* s, float* d) {
        smooth_op<M, LdPlain, LdF, kC>(d, s, L.f, L.aux, L, op_taps<kC>(L),
                                       a.omega, a.gamma, tz, ty, dl);
      });
      break;
    case kOpResidual:
      by_buffer<K>(L, op.z, [&](const float* v, float* r) {
        residual_op<M, LdF, kC>(r, v, L.f, L.aux, L, op_taps<kC>(L), a.gamma,
                                tz, ty, dl);
      });
      break;
    case kOpRestrict:
      by_buffer<K>(L, op.z, [&](const float* in, float*) {
        restrict_op(C.f, nullptr, in, C.g, L.g, tz, ty, dl);
      });
      break;
    case kOpRestrictV:
      if constexpr (M == kNonlinear) {
        by_buffer<K>(L, op.z, [&](const float* in, float*) {
          restrict_op(C.buf[0], C.aux, in, C.g, L.g, tz, ty, dl);
        });
      }
      break;
    case kOpFasF:
      if constexpr (M == kNonlinear) {
        by_buffer<K>(L, op.z, [&](const float* in, float*) {
          fas_f_op(C.f, in, C.aux, C, op_taps<kC>(C), L.g, a.gamma, tz, ty,
                   dl);
        });
      }
      break;
    case kOpProlong:
      by_buffer<K>(L, op.w, [&](const float* fv, float* d) {
        by_buffer<K>(C, op.z, [&](const float* cv, float*) {
          prolong_op<M, kC || M == kLinear>(d, fv, cv, C.aux, L.g, C.g, tz,
                                            ty, dl);
        });
      });
      break;
    default:
      break;
  }
}

// The final level-0 residual's per-tile sums of r^2, with the canonical
// taps or any others: level 0's fields, geometry and taps are read at
// fixed offsets of the kernel parameters, as in run_op<M, 0>.
template <int M>
__device__ __forceinline__ void norm0(const int4 op, const Args& a, int tz,
                                      int ty, const Deal dl) {
  const Level& L = a.lv[0];
  by_buffer<0>(L, op.z, [&](const float* v, float*) {
    if (a.canon) {
      norm_op<M, LdNC, true>(a.partials, v, L.f, L.aux, L, op_taps<true>(L),
                             a.gamma, tz, ty, dl);
    } else {
      norm_op<M, LdNC, false>(a.partials, v, L.f, L.aux, L, L.taps, a.gamma,
                              tz, ty, dl);
    }
  });
}

// Levels 0 and 1 with the canonical taps run their fixed-level bodies;
// every other op runs the body that indexes the level table, but the norm
// and its sum, which are level 0's whatever the taps.
template <int M>
__device__ __forceinline__ void dispatch(const int4 op, const Args& a, int tz,
                                         int ty, const Deal dl) {
  const int fl = op.x == kOpProlong ? op.y - 1 : op.y;
  if (op.x == kOpNorm) {
    norm0<M>(op, a, tz, ty, dl);
  } else if (op.x == kOpFinalize) {
    if (blockIdx.x == 0) {
      __shared__ double s[kFinThreads];
      const dim3 gr = grid_for(a.lv[0].g);
      const double total =
          finalize_sum(a.partials, (long long)gr.x * gr.y * gr.z, s);
      if (threadIdx.x == 0) *a.norm_out = (float)total;
    }
  } else if (fl == 0 && a.canon) {
    run_op<M, 0>(op, a, 0, tz, ty, dl);
  } else if (fl == 1 && a.canon) {
    run_op<M, 1>(op, a, 1, tz, ty, dl);
  } else {
    run_op<M, -1>(op, a, fl, tz, ty, dl);
  }
}

template <int M>
__global__ void __launch_bounds__(kThreads, kVMinBlocks<M>)
vcycle_kernel(const int4* __restrict__ ops, int nops,
              const __grid_constant__ Args a) {
  // The op loop's state is kept in shared memory, not in registers
  // through the ops: the op to run next, and the barrier after this one
  // (0 none, 1 the block's, within the tail, 2 the grid's).  Thread 0
  // writes each before a barrier that every thread passes after reading
  // the old value.
  __shared__ int next_op, barrier_kind;
  const int tz = threadIdx.x % kBZ, ty = threadIdx.x / kBZ;
  if (threadIdx.x == 0) next_op = 0;
  __syncthreads();
  for (;;) {
    const int q = next_op;
    if (q >= nops) break;
    const bool tail = q >= a.tail_begin && q < a.tail_end;
    const int4 op = ops[q];
    if (threadIdx.x == 0) op_counter() = a.tile_ctr + q;
    __syncthreads();  // every thread has read next_op and barrier_kind
    if (threadIdx.x == 0) {
      next_op = q + 1;
      barrier_kind = q + 1 == nops                      ? 0
                     : tail && q + 1 < a.tail_end ? 1
                                                        : 2;
    }
    if (!tail) {
      dispatch<M>(op, a, tz, ty, Deal{blockIdx.x, gridDim.x});
    } else if (blockIdx.x == 0) {
      dispatch<M>(op, a, tz, ty, Deal{0, 1});
    }
    __syncthreads();  // thread 0's writes are seen
    const int kind = barrier_kind;
    if (kind == 2) {
      cg::this_grid().sync();
    } else if (kind == 1) {
      __syncthreads();
    }
  }
}

// The cooperative grid: SMs x the resident blocks per SM the occupancy
// calculator gives for this instantiation.
template <int M>
cudaError_t coop_grid(int* grid) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  }
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, vcycle_kernel<M>, kThreads, 0);
  }
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *grid = sms * per_sm;
  return cudaSuccess;
}

template <int M>
int launch(const int4* ops, int nops, Args& a, cudaStream_t stream) {
  int blocks = 0;
  cudaError_t e = coop_grid<M>(&blocks);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {(void*)&ops, (void*)&nops, (void*)&a};
  e = cudaLaunchCooperativeKernel((const void*)vcycle_kernel<M>,
                                  dim3(blocks), dim3(kThreads), args, 0,
                                  stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The grid mg_vcycle_fused launches for `mode`, into *grid.
int mg_vcycle_fused_grid(int mode, int* grid) {
  switch (mode) {
    case kLinear:
      return (int)coop_grid<kLinear>(grid);
    case kNonlinear:
      return (int)coop_grid<kNonlinear>(grid);
    case kNewton:
      return (int)coop_grid<kNewton>(grid);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// One launch over an op table.  ops: device int32 (nops, 4).  Per level l
// (host arrays): ptrs[4l..4l+3] = the buffer holding v, its spare, f, aux
// (0 for none); dims[3l..3l+2] = interior dims; scal[3l..3l+2] = 1/h^2,
// h^2/values[0], values[0]/h^2.  Ops [tail_begin, tail_end) run on block
// 0.  partials: device float64, one per level-0 tile (mg_residual_blocks);
// tile_ctr: device uint32, one per op, zeros; norm_out: device float32.
// mode: 0 LINEAR, 1 NONLINEAR, 2 NEWTON.
int mg_vcycle_fused(const int* ops, int nops, int tail_begin, int tail_end,
                    int mode, int nlev, const long long* ptrs,
                    const int* dims, const float* scal,
                    const float* tap_val, const int* tap_off3, int ntaps,
                    float omega, float gamma, double* partials,
                    unsigned* tile_ctr, float* norm_out,
                    cudaStream_t stream) {
  if (nlev < 1 || nlev > kMaxLevels || nops < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Args a = {};
  for (int l = 0; l < nlev; ++l) {
    Level& L = a.lv[l];
    L.buf[0] = reinterpret_cast<float*>(ptrs[4 * l]);
    L.buf[1] = reinterpret_cast<float*>(ptrs[4 * l + 1]);
    L.f = reinterpret_cast<float*>(ptrs[4 * l + 2]);
    L.aux = reinterpret_cast<float*>(ptrs[4 * l + 3]);
    L.g = make_geom(dims[3 * l], dims[3 * l + 1], dims[3 * l + 2]);
    L.taps = make_taps(tap_val, tap_off3, ntaps, L.g);
    L.inv_h2 = scal[3 * l];
    L.alpha = scal[3 * l + 1];
    L.pre_fac = scal[3 * l + 2];
  }
  a.omega = omega;
  a.gamma = gamma;
  a.partials = partials;
  a.norm_out = norm_out;
  a.tile_ctr = tile_ctr;
  a.tail_begin = tail_begin;
  a.tail_end = tail_end;
  a.canon = ntaps == kMaxTaps;
  for (int t = 0; t < 3 * ntaps; ++t) {
    a.canon = a.canon && tap_off3[t] == kCanonOff[t];
  }
  const int4* op4 = reinterpret_cast<const int4*>(ops);
  switch (mode) {
    case kLinear:
      return launch<kLinear>(op4, nops, a, stream);
    case kNonlinear:
      return launch<kNonlinear>(op4, nops, a, stream);
    case kNewton:
      return launch<kNewton>(op4, nops, a, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
