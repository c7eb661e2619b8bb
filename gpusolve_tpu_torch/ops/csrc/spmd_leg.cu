// The trapezoid leg of the distributed per-leg engine (dist/spmd.py): all
// S damped-Jacobi sweeps of one leg of a shard's block in one launch, in
// all three modes (LINEAR, FAS, NEWTON), for Hopper (sm_90a).
//
// It replaces gpusolve_tpu/ops/pallas_spmd.py::_multi_sweep_call (:1847),
// whose body is _make_leg (:1015): the communication-avoiding leg, whose
// ghost slabs are exchanged once per leg, not once per sweep.
//
// Array model: ops/spmd_leg.py's.  A field of a shard's block is a dense
// (bx, by, bz) float32 array, z contiguous, with ghost slabs G = 8 planes
// deep: x slabs (G, by [+ 2G under a y split], bz) below and above, and
// under a y split y slabs (bx, G, bz).  The extended block covers local x
// in [-G, bx + G) and, under a y split, y in [-G, by + G); anything past it
// (and past z in [0, bz)) reads 0.  On the one-rank mesh every slab is zero
// and the kSlabs = false instantiations read none.  The coarse block of the
// corr-first up leg has slabs GC = 5 deep.
//
// Generation 0 is v (0 for src_zero; v + P(coarse) for the corr-first leg),
// generation k one damped-Jacobi sweep of generation k - 1; every
// generation is 0 outside the GLOBAL interior (the ghost cells are the
// neighbour's real cells), so generation k is exact G - k cells into the
// ghost zone and S sweeps with one exchange equal S exchange-separated
// sweeps.  Generation S is written to v_out over the local box.  The
// consumers: the Sigma r^2 of the post-sweep residual over the box in
// float64 partials per block (norm); the post-sweep residual, zero outside
// the global interior, restricted along x, then y, then z (weights 0.25,
// 0.5, 0.25) into the coarse f over the coarse box, and in FAS the same
// restriction of v into the coarse v and rest_v, and the tau fold
// f_c = R(r) + (A Rv / h_c^2 + (gamma Rv) e^Rv), Rv zero outside the coarse
// global interior (restrict).
//
// Bound: bytes by the table (reads v, f, NEWTON also u~, once per leg and
// writes v: 12 or 16 B per point, the coarse outputs 0.5-1.5 B more;
// ~17-45 flops per point per sweep).  Measured (PERF.md), the leg is
// bound by instruction issue and by how well its warps hide latency, not
// by bytes; the design spends its instructions on the sweeps.
// 2.5-D temporal blocking: a block of kLegThreads threads owns a kTY x
// kTZ (y, z) tile of the box and a chunk of kCX x-planes, and marches
// along x through the chunk and R = S + e planes either side (e = 0 no
// consumer, 1 norm, 2 restrict, 3 FAS restrict: the consumer's reach past
// generation S), over the tile and an R-cell ring around it.  Shared
// memory holds a three-plane ring per generation 0..S-1 and for
// generation S where a consumer reads it, rings of f (and u~) that only
// their own thread reads, and for the restriction the residual's last two
// planes (their own thread's), the plane of the residual weighted along x
// (FAS: of generation S too), the FAS restricted-v ring and a staging
// pair for R(r).  The ring plane's cells are dealt to the threads in
// onion order (the tile first, then each ring of cells one shallower),
// odd slots counting the threads backwards, so generation k, computed
// over the cells of depth >= k, is a prefix of every thread's slots, a
// warp outside it skips it whole, and the partly filled slots of the
// generations fall on different warps.  A thread keeps its cells for the
// whole leg, described once (ring cell and its shared address, interior
// and ownership bits, its offset in the block's and the slabs' planes),
// so generation 0, f and u~ of the next plane are loaded with one offset
// and no per-cell branch on the slabs, into registers a step ahead, and
// a tap is one add to the cell's address.  A face-tap stencil's x taps
// read the thread's own cells, and every in-plane tap a plane finished in
// an earlier step, so each step has one barrier: it stores plane p of
// generation 0, f and u~, computes generation k at plane p - k for k =
// 1..S (two slots at a time, so their loads overlap), the residual at
// p - S - 1, and the restriction's parts that read other threads' cells
// (its y and z passes, the tau fold) one step after their planes were
// written.  The examples' tap order (centre, x + 1, x - 1, y + 1, y - 1,
// z + 1, z - 1) is a template case: its z taps are immediate offsets and
// its x + 1 tap the value the thread just computed.  The ring cells are
// recomputed by the neighbouring tiles too; the generations never reach
// device memory.
//
// Rounding: every product, sum and quotient as its own operation, in the
// order of the plain version (ops/spmd_leg.py, through ops/ref.py's point
// formulas) and the accurate expf, as spmd_block.cu.  The prolongation's
// midpoints are mid(a, b) = 0.5a + 0.5b along x, then y, then z.
//
// The leg's body is leg_tile (leg_device.cuh), which the pod engine's
// chained launches (pod.cu) run too; here one block runs one tile.  The
// entry point launches on the given stream, allocates nothing and returns
// cudaGetLastError().

#include "leg_device.cuh"

namespace {

// One launch a leg, one block a tile.  Two blocks an SM, so at most 128
// registers: the S = 3 legs of every mode fit two blocks' shared memory.
// kCanon: the canonical tap order (LegArgs::canon), read from registers
// and immediate offsets; else the taps by their offsets.
template <int M, int C, bool kSlabs, bool kCanon>
__global__ void __launch_bounds__(kLegThreads, 2)
leg_kernel(const __grid_constant__ LegArgs a) {
  extern __shared__ float sm[];
  leg_tile<M, C, kSlabs, kCanon>(
      a, sm, blockIdx.x, blockIdx.y, blockIdx.z,
      blockIdx.x + gridDim.x * (blockIdx.y + (long long)gridDim.y *
                                                 blockIdx.z));
}

template <class F>
int dispatch(int mode, int consumer, bool slabs, bool canon, F&& launch) {
  auto with_c = [&](auto m) {
    auto with_s = [&](auto mm, auto c) {
      auto with_k = [&](auto s) {
        if (canon) return launch(mm, c, s, std::true_type{});
        return launch(mm, c, s, std::false_type{});
      };
      if (slabs) return with_k(std::true_type{});
      return with_k(std::false_type{});
    };
    switch (consumer) {
      case kNone:
        return with_s(m, std::integral_constant<int, kNone>{});
      case kNorm:
        return with_s(m, std::integral_constant<int, kNorm>{});
      case kRestrict:
        return with_s(m, std::integral_constant<int, kRestrict>{});
      default:
        return (int)cudaErrorInvalidValue;
    }
  };
  switch (mode) {
    case kLinear:
      return with_c(std::integral_constant<int, kLinear>{});
    case kNonlinear:
      return with_c(std::integral_constant<int, kNonlinear>{});
    case kNewton:
      return with_c(std::integral_constant<int, kNewton>{});
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// out: grid x, y, z and the shared-memory bytes of a launch with these
// int arguments.
int mg_leg_grid(const int* iv, long long* out) {
  LegArgs a;
  const dim3 grid = leg_geometry(iv, a);
  out[0] = grid.x;
  out[1] = grid.y;
  out[2] = grid.z;
  out[3] = 4 * leg_smem_floats(iv[0], iv[1], a.S, a.PY * a.PZ);
  return 0;
}

// *out: the blocks an SM holds of the leg kernel these int arguments name
// (mode, consumer, slabs; the canonical taps) at its launch's shared
// memory, by the occupancy calculator.
int mg_leg_occupancy(const int* iv, int* out) {
  LegArgs a;
  leg_geometry(iv, a);
  const long long smem = 4 * leg_smem_floats(iv[0], iv[1], a.S, a.PY * a.PZ);
  return dispatch(iv[0], iv[1], iv[2] != 0, true,
                  [&](auto m, auto c, auto s, auto k) {
    auto kernel =
        leg_kernel<decltype(m)::value, decltype(c)::value, decltype(s)::value,
                   decltype(k)::value>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, kernel, kLegThreads, (size_t)smem);
  });
}

// ptrs (26): v_out; v, f, nv, coarse v, each followed by its slabs xlo,
// xhi, ylo, yhi (null where absent); partials, coarse f, coarse v, coarse
// rest_v; rest_v to subtract from the output (FAS sub_rv) or null.
// iv (31): mode, consumer (0 none, 1 norm, 2 restrict), slabs, ysplit, S,
// src_zero, corr, bx, by, bz, box (6), gx0, nx, gy0, ny, cby, cbz,
// coarse box (6), cnx, cny, cnz.
// fv (6): 1/h^2, alpha = h^2/values[0], omega, gamma, values[0]/h^2,
// 1/h_c^2.
int mg_leg_block(const void* const* ptrs, const int* iv, const float* fv,
                 const float* tap_val, const int* tap_off3, int ntaps,
                 cudaStream_t stream) {
  if (!leg_args_ok(iv, ntaps)) return (int)cudaErrorInvalidValue;
  LegArgs a;
  long long smem = 0;
  const dim3 grid =
      leg_args(ptrs, iv, fv, tap_val, tap_off3, ntaps, a, &smem);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  return dispatch(iv[0], iv[1], iv[2] != 0, a.canon != 0,
                  [&](auto m, auto c, auto s, auto k) {
    auto kernel =
        leg_kernel<decltype(m)::value, decltype(c)::value, decltype(s)::value,
                   decltype(k)::value>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    // All of L1 that can be shared memory, so several blocks fit an SM.
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kLegThreads, smem, stream>>>(a);
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
