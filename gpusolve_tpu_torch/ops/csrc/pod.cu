// The pod engine's two chained kernels (dist/pod.py), for Hopper (sm_90a):
// every distributed down leg of a V-cycle in one cooperative launch, and
// every up leg in another, in all three modes (LINEAR, FAS, NEWTON).
//
// They replace gpusolve_tpu/ops/pallas_pod.py::_pod_down_call (:494, used
// by pod_down :707) and ::_pod_up_call (:741, used by pod_up :968), which
// chain the per-leg engine's leg emitters (_make_leg) in one Pallas
// launch per direction.  Here the legs are the per-leg kernel's body,
// leg_tile (leg_device.cuh), so a chain computes what the same legs
// launched one by one compute, bit for bit:
//
//   down, pod_kernel<M, false>: legs a..npod-1, each with the
//     restriction consumer: S pre-sweeps, the residual, its x/y/z
//     restriction into the next level's f (FAS: R(v) into its v and
//     rest_v, and the tau fold); each leg's coarse outputs are the next
//     leg's inputs;
//   up, pod_kernel<M, true>: legs npod-1..a, each corr-first: the
//     prolongation of the coarser block added first, then T post-sweeps;
//     FAS legs below the chain's head write v - rest_v (the sub_rv
//     epilogue); the level-0 leg gives the cycle's Sigma r^2 (float64
//     partials, one per tile, for finalize).
//
// Design.  One cooperative launch of SMs x the resident blocks per SM (the
// occupancy calculator's, at the chain's largest dynamic shared memory):
// every block walks the tiles of leg 0 in a grid-stride loop, a grid-wide
// barrier (cooperative_groups::this_grid().sync()) closes the leg, and so
// on down the chain.  A chain of one leg (the one-rank plan's depth 1)
// needs no barrier: it launches one block a tile, as the per-leg kernel,
// and runs at its leg's speed.  The body reads the leg's parameters as
// constant operands only at a fixed offset: the chain's largest leg
// (level a, the one-rank plan's only leg) runs from such a copy, the
// others through a call.  Measured on the card, a second inlined body or
// parameters at a run-time offset made the largest leg markedly slower
// (spills at the 128-register cap).  Every chain, NEWTON's down chain
// too, runs two blocks an SM since the leg's rings fit two blocks' shared
// memory.  A leg reads what the previous one wrote in this
// launch, so every global load is a plain load (leg_device.cuh).  No leg
// writes what it reads: each leg's v goes to the level's spare buffer, as
// in the per-leg engine (the TPU kernel updates v in place, relying on
// its sequential grid; blocks here run in no order, so a tile could
// overwrite planes a neighbouring tile has still to read).  The level
// table rides in the kernel parameters (over 4 KB: CUDA 12.1's large
// kernel parameters).  A grid that cannot be resident fails and the
// wrapper raises.
//
// Bound: bytes by the table, as the legs (PERF.md); measured, the legs are
// bound by instruction issue and latency, and so is the chain.  Only the
// one-rank mesh runs here: the TPU kernels' in-kernel exchange between
// legs writes the neighbours' memory and waits for it inside the launch,
// which waits for a machine with two cards (ROADMAP Queue 2, rows 12-14
// across cards), so every leg reads no slab.
//
// The entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError().

#include <cooperative_groups.h>

#include "leg_device.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxPod = 8;  // legs in one chain (ops/pod.py MAX_LEGS)

struct PodArgs {
  LegArgs lv[kMaxPod];
  LegArgs head;  // a copy of the chain's largest leg, lv[head_index]
  int head_index;
  int tiles_z[kMaxPod], tiles_y[kMaxPod], tiles_x[kMaxPod];
  int n;
};
static_assert(sizeof(PodArgs) <= 32764, "kernel parameters over 32764 B");

// One leg's tiles in a grid-stride loop, the body inlined: `a` is a
// parameter at a fixed offset, so the body reads its fields as constant
// operands, as the per-leg kernel does.  The up chain runs every leg
// through the norm body, whose norm a leg without partials skips
// (leg_device.cuh), so the kernel holds one body: two bodies in one
// kernel share its 128 registers, and spill.
template <int M, bool kUp, bool kCanon>
__device__ __forceinline__ void run_leg(const LegArgs& a, float* sm, int gz,
                                        int gy, int nt) {
  for (int t = blockIdx.x; t < nt; t += gridDim.x) {
    leg_tile<M, kUp ? kNorm : kRestrict, false, kCanon>(
        a, sm, t % gz, (t / gz) % gy, t / (gz * gy), t);
    __syncthreads();  // the next tile reuses shared memory
  }
}

// The other legs of a longer chain: their parameters sit at an offset
// known only at run time, so each tile is a call, whose body keeps its
// registers to itself (the inlined head pays for a second inlined body
// in spills).
template <int M, bool kUp, bool kCanon>
__device__ __noinline__ void tile_call(const LegArgs& a, float* sm, int tz,
                                       int ty, int tx, int t) {
  leg_tile<M, kUp ? kNorm : kRestrict, false, kCanon>(a, sm, tz, ty, tx, t);
}

// The chain.  kUp: the up legs, corr-first, the last with the norm;
// else the down legs, with the restriction.  kSingle: a chain of one leg
// (the one-rank plan's depth 1), which needs no loop over legs.  Two
// blocks an SM, as the per-leg kernel.
template <int M, bool kUp, bool kSingle, bool kCanon>
__global__ void __launch_bounds__(kLegThreads, 2)
pod_kernel(const __grid_constant__ PodArgs p) {
  extern __shared__ float sm[];
  if constexpr (kSingle) {
    // One block a tile, as the per-leg launch: a chain of one leg needs
    // no grid barrier, and a block that loops over tiles keeps the body's
    // loop-invariant values live across it (spills at the 128-register
    // cap).
    leg_tile<M, kUp ? kNorm : kRestrict, false, kCanon>(
        p.lv[0], sm, blockIdx.x, blockIdx.y, blockIdx.z,
        blockIdx.x + gridDim.x * (blockIdx.y + (long long)gridDim.y *
                                                   blockIdx.z));
  } else {
    cg::grid_group grid = cg::this_grid();
    for (int i = 0; i < p.n; ++i) {
      const int gz = p.tiles_z[i], gy = p.tiles_y[i];
      const int nt = gz * gy * p.tiles_x[i];
      if (i == p.head_index) {
        run_leg<M, kUp, kCanon>(p.head, sm, gz, gy, nt);
      } else {
        for (int t = blockIdx.x; t < nt; t += gridDim.x) {
          tile_call<M, kUp, kCanon>(p.lv[i], sm, t % gz, (t / gz) % gy,
                            t / (gz * gy), t);
          __syncthreads();
        }
      }
      if (i + 1 < p.n) grid.sync();
    }
  }
}

template <int M, bool kCanon>
void* kernel_of(bool up, bool single) {
  if (up) {
    return single ? (void*)pod_kernel<M, true, true, kCanon>
                  : (void*)pod_kernel<M, true, false, kCanon>;
  }
  return single ? (void*)pod_kernel<M, false, true, kCanon>
                : (void*)pod_kernel<M, false, false, kCanon>;
}

// kCanon: the canonical tap order (LegArgs::canon).
template <bool kCanon>
void* pick_mode(int mode, bool up, bool single) {
  switch (mode) {
    case kLinear:
      return kernel_of<kLinear, kCanon>(up, single);
    case kNonlinear:
      return kernel_of<kNonlinear, kCanon>(up, single);
    case kNewton:
      return kernel_of<kNewton, kCanon>(up, single);
    default:
      return nullptr;
  }
}

void* pick(int mode, bool up, bool single, bool canon) {
  return canon ? pick_mode<true>(mode, up, single)
               : pick_mode<false>(mode, up, single);
}

// The cooperative grid of a chain at `smem` bytes of dynamic shared
// memory: out[0] blocks, out[1] blocks per SM.
cudaError_t coop_grid(const void* kernel, long long smem, long long* out) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  }
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  }
  if (e == cudaSuccess) {
    // All of L1 that can be shared memory, so several blocks fit an SM.
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kLegThreads, smem);
  }
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  out[0] = (long long)sms * per_sm;
  out[1] = per_sm;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// One chain of n legs in one cooperative launch.  up: 0 the down chain
// (every leg with the restriction consumer), 1 the up chain (every leg
// corr-first, no consumer but the norm).  Per leg i, in launch order, the
// arrays of mg_leg_block (spmd_leg.cu): ptrs[26 i .. 26 i + 25],
// iv[31 i .. 31 i + 30], fv[6 i .. 6 i + 5]; every leg of one mode and
// with no slab.  info (out): blocks, blocks per SM, dynamic shared memory
// bytes.
int mg_pod_chain(int up, int n, const void* const* ptrs, const int* iv,
                 const float* fv, const float* tap_val, const int* tap_off3,
                 int ntaps, long long* info, cudaStream_t stream) {
  if (n < 1 || n > kMaxPod) return (int)cudaErrorInvalidValue;
  const int mode = iv[0];
  PodArgs p = {};
  p.n = n;
  long long smem = 0;
  for (int i = 0; i < n; ++i) {
    const int* li = iv + 31 * i;
    // Every up leg corr-first, the norm only on the last; every down leg
    // with the restriction.
    const bool ok = leg_args_ok(li, ntaps) && li[0] == mode && li[2] == 0 &&
                    (up ? li[6] == 1 && li[1] != kRestrict &&
                              (i == n - 1 || li[1] == kNone)
                        : li[6] == 0 && li[1] == kRestrict);
    if (!ok) return (int)cudaErrorInvalidValue;
    long long s = 0;
    const dim3 g = leg_args(ptrs + 26 * i, li, fv + 6 * i, tap_val, tap_off3,
                            ntaps, p.lv[i], &s);
    p.tiles_z[i] = g.x;
    p.tiles_y[i] = g.y;
    p.tiles_x[i] = g.z;
    if (i == (up ? n - 1 : 0)) {  // the largest leg: level a
      p.head = p.lv[i];
      p.head_index = i;
    }
    smem = s > smem ? s : smem;
  }
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  void* kernel = pick(mode, up != 0, n == 1, p.lv[0].canon != 0);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  long long grid[2];
  cudaError_t e = coop_grid(kernel, smem, grid);
  if (e != cudaSuccess) return (int)e;
  info[1] = grid[1];
  info[2] = smem;
  void* args[] = {(void*)&p};
  if (n == 1) {
    const dim3 tiles(p.tiles_z[0], p.tiles_y[0], p.tiles_x[0]);
    info[0] = (long long)tiles.x * tiles.y * tiles.z;
    e = cudaLaunchKernel(kernel, tiles, dim3(kLegThreads), args,
                         (size_t)smem, stream);
  } else {
    info[0] = grid[0];
    e = cudaLaunchCooperativeKernel(kernel, dim3((unsigned)grid[0]),
                                    dim3(kLegThreads), args, (size_t)smem,
                                    stream);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
