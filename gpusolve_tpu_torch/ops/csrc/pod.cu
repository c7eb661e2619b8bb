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
// bound by instruction issue and latency, and so is the chain.
//
// On a multi-rank mesh (pod_kernel<..., kX = true>) the chain exchanges
// the legs' ghost slabs between ranks inside the launch, as the TPU
// kernels do (_emit_barrier, _emit_exchange, pallas_pod.py:225-444): each
// rank's receive buffers and flag words are one allocation of its own
// that its neighbours open over CUDA IPC (ops/pod.py ChainPeers), so a
// rank writes its face planes straight into its neighbours' buffers, on
// one card (the same L2) or across cards.  The launch starts with a
// neighbour barrier: one thread writes the launch's epoch (a 64-bit count
// that grows with every launch, so no flag is ever reset) into each
// neighbour's start word and waits for theirs, so no rank writes a buffer
// its neighbour's previous launch still reads.  Each exchange step then
// runs: every block copies its share of the face rows into the peers'
// buffers (a warp a row) and fences at system scope; grid.sync(); one
// thread fences, stores the epoch with release semantics at system scope
// into each neighbour's word of the step and spins on its own words with
// acquire loads; grid.sync().  The first grid.sync() of a step is the
// one that closes the previous leg (or the start barrier's).  A phase
// (the sets read by the leg it precedes: phase 0 the chain's inputs, a
// later phase the fresh outputs of the previous leg) is one x step, or
// under a y split a y step and then an x step whose slabs carry the y
// slabs just received (the corner forwarding of the two-stage exchange).
// The global edges' buffers are never written and stay zero, the
// Dirichlet ghosts.  Every leg runs the slab-reading body of the per-leg
// kernel, inlined once, on a copy of its parameters in shared memory, so
// the chain equals its legs launched one by one through leg_block with
// the host exchange, bit for bit.  Every wait reads %globaltimer and, past the wrapper's limit,
// writes the wait's number into host-mapped memory and traps, so the
// launch fails and the wrapper raises; nothing falls back.  The one-rank
// instantiations (kX = false) are as before.
//
// The entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError().

#include <cooperative_groups.h>

#include <cstring>
#include <type_traits>

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

// Blocks an SM of the multi-rank chains: their one inlined body, looping
// over tiles, holds a leg's parameters in registers across the loop (at
// two blocks an SM, 128 registers, it spilled 140-1138 bytes; at one,
// 168-215 registers and no spill).
constexpr int kRanksBlocks = 1;
constexpr int kMaxSteps = 2 * kMaxPod;  // exchange steps in one chain
constexpr int kMaxXJobs = 320;          // row copies in one chain

// One copy of an exchange step: `rows` rows of bz floats, rpp rows a
// plane; row r = q rpp + y reads src + q sps + y bz and writes
// dst + q dps + y bz.  row0: its first row among its step's.
struct XJob {
  float* dst;
  const float* src;
  int rows, rpp, sps, dps, bz, row0;
};

struct XStep {
  int leg;   // the leg it precedes
  int axis;  // 0: x (words from -x, +x), 1: y (from -y, +y)
  int job0, njobs, rows;
};

// The exchange of a chain on a multi-rank mesh.  Flag words (64-bit):
// four start words, then four a step, each the word of one neighbour
// (-x, +x, -y, +y).
struct Exch {
  unsigned long long epoch;
  long long limit_ns;
  unsigned long long* flags;    // this rank's
  unsigned long long* peer[4];  // the neighbours' (null: none)
  long long* waits;             // ns: the start barrier, then each step
  int* status;                  // host-mapped: 1 + the wait that timed out
  int nsteps;
  XStep step[kMaxSteps];
  XJob job[kMaxXJobs];
};

struct PodXArgs : PodArgs {
  Exch x;
};
static_assert(sizeof(PodXArgs) <= 32764, "kernel parameters over 32764 B");

template <bool kX>
using PodParams = std::conditional_t<kX, PodXArgs, PodArgs>;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void store_release_sys(unsigned long long* p,
                                                  unsigned long long v) {
  asm volatile("st.release.sys.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire_sys(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// One thread: the epoch into words `word` of the neighbours d0..d1-1 (the
// word that names this rank as their neighbour: d ^ 1), then a wait for
// this rank's own words from them; its time into waits[slot].  Past the
// limit: slot + 1 into the host-mapped status word, then a trap.
__device__ __forceinline__ void neighbour_wait(const Exch& x, int word, int d0,
                                            int d1, int slot) {
  const unsigned long long t0 = global_ns();
  __threadfence_system();
  for (int d = d0; d < d1; ++d) {
    if (x.peer[d] != nullptr) {
      store_release_sys(x.peer[d] + word + (d ^ 1), x.epoch);
    }
  }
  for (int d = d0; d < d1; ++d) {
    if (x.peer[d] == nullptr) continue;
    while (load_acquire_sys(x.flags + word + d) < x.epoch) {
      if ((long long)(global_ns() - t0) > x.limit_ns) {
        *(volatile int*)x.status = slot + 1;
        __threadfence_system();
        __trap();
      }
      __nanosleep(200);
    }
  }
  x.waits[slot] = (long long)(global_ns() - t0);
}

// Exchange step s, by every thread of the grid: the rows, a warp a row,
// then the flags.
__device__ __forceinline__ void exchange_step(const Exch& x, int s) {
  cg::grid_group grid = cg::this_grid();
  const XStep& st = x.step[s];
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const long long nw = (long long)gridDim.x * warps;
  int j = st.job0;
  for (long long r = (long long)blockIdx.x * warps + (threadIdx.x >> 5);
       r < st.rows; r += nw) {
    while (j + 1 < st.job0 + st.njobs && r >= x.job[j + 1].row0) ++j;
    const XJob& b = x.job[j];
    const int rr = (int)(r - b.row0);
    const int q = rr / b.rpp, y = rr - q * b.rpp;
    const float* src = b.src + (long long)q * b.sps + (long long)y * b.bz;
    float* dst = b.dst + (long long)q * b.dps + (long long)y * b.bz;
    for (int z = lane; z < b.bz; z += 32) dst[z] = src[z];
  }
  __syncthreads();
  if (threadIdx.x == 0) __threadfence_system();
  grid.sync();
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    neighbour_wait(x, 4 + 4 * s, 2 * st.axis, 2 * st.axis + 2, s + 1);
  }
  grid.sync();
}

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
// (the one-rank plan's depth 1), which needs no loop over legs.  kX: a
// multi-rank mesh, the exchange between ranks in the launch (never
// kSingle), one block an SM (kRanksBlocks); else two blocks an SM, as
// the per-leg kernel.
template <int M, bool kUp, bool kSingle, bool kCanon, bool kX = false>
__global__ void __launch_bounds__(kLegThreads, kX ? kRanksBlocks : 2)
pod_kernel(const __grid_constant__ PodParams<kX> p) {
  extern __shared__ float sm[];
  if constexpr (kX) {
    // Each leg's parameters are copied into shared memory at a fixed
    // address, so the one inlined body reads every leg's fields at fixed
    // offsets (through a call, or from the parameters at a run-time
    // offset, the body spilled).
    __shared__ LegArgs la;
    cg::grid_group grid = cg::this_grid();
    if (blockIdx.x == 0 && threadIdx.x == 0) neighbour_wait(p.x, 0, 0, 4, 0);
    grid.sync();
    int s = 0;
    for (int i = 0; i < p.n; ++i) {
      for (; s < p.x.nsteps && p.x.step[s].leg == i; ++s) {
        exchange_step(p.x, s);
      }
      const int* from = reinterpret_cast<const int*>(&p.lv[i]);
      int* to = reinterpret_cast<int*>(&la);
      for (int w = threadIdx.x; w < (int)(sizeof(LegArgs) / 4);
           w += blockDim.x) {
        to[w] = from[w];
      }
      __syncthreads();
      const int gz = p.tiles_z[i], gy = p.tiles_y[i];
      const int nt = gz * gy * p.tiles_x[i];
      for (int t = blockIdx.x; t < nt; t += gridDim.x) {
        leg_tile<M, kUp ? kNorm : kRestrict, true, kCanon>(
            la, sm, t % gz, (t / gz) % gy, t / (gz * gy), t);
        __syncthreads();
      }
      if (i + 1 < p.n) grid.sync();
    }
  } else if constexpr (kSingle) {
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

// The multi-rank chains: pod_kernel<M, up, false, canon, true>.
template <int M>
void* kernel_x(bool up, bool canon) {
  if (up) {
    return canon ? (void*)pod_kernel<M, true, false, true, true>
                 : (void*)pod_kernel<M, true, false, false, true>;
  }
  return canon ? (void*)pod_kernel<M, false, false, true, true>
               : (void*)pod_kernel<M, false, false, false, true>;
}

void* pick_x(int mode, bool up, bool canon) {
  switch (mode) {
    case kLinear:
      return kernel_x<kLinear>(up, canon);
    case kNonlinear:
      return kernel_x<kNonlinear>(up, canon);
    case kNewton:
      return kernel_x<kNewton>(up, canon);
    default:
      return nullptr;
  }
}

bool fits_int(long long v) { return v >= 0 && v <= 0x7fffffffLL; }

// The exchange table (ops/pod.ChainPeers.table) into x: epoch, limit_ns,
// flags, 4 neighbour flag pointers, waits, status, nsteps, njobs; per
// step leg, axis, job0, njobs, rows; per job dst, src, rows, rpp, sps,
// dps, bz, row0.  False where it does not hold together.
bool exch_args(const long long* v, int nv, int nlegs, Exch& x) {
  if (nv < 11) return false;
  x.epoch = (unsigned long long)v[0];
  x.limit_ns = v[1];
  x.flags = reinterpret_cast<unsigned long long*>(v[2]);
  for (int d = 0; d < 4; ++d) {
    x.peer[d] = reinterpret_cast<unsigned long long*>(v[3 + d]);
  }
  x.waits = reinterpret_cast<long long*>(v[7]);
  x.status = reinterpret_cast<int*>(v[8]);
  const long long ns = v[9], nj = v[10];
  if (ns < 1 || ns > kMaxSteps || nj < 1 || nj > kMaxXJobs ||
      nv != 11 + 5 * ns + 8 * nj || x.flags == nullptr ||
      x.waits == nullptr || x.status == nullptr || x.epoch == 0) {
    return false;
  }
  x.nsteps = (int)ns;
  const long long* sv = v + 11;
  const long long* jv = sv + 5 * ns;
  int prev_leg = 0, next_job = 0;
  for (int s = 0; s < ns; ++s, sv += 5) {
    XStep& st = x.step[s];
    if (sv[0] < prev_leg || sv[0] >= nlegs || (sv[1] != 0 && sv[1] != 1) ||
        sv[2] != next_job || sv[3] < 0 || sv[2] + sv[3] > nj ||
        !fits_int(sv[4])) {
      return false;
    }
    st.leg = prev_leg = (int)sv[0];
    st.axis = (int)sv[1];
    st.job0 = (int)sv[2];
    st.njobs = (int)sv[3];
    st.rows = (int)sv[4];
    next_job = st.job0 + st.njobs;
    long long row = 0;
    for (int j = st.job0; j < next_job; ++j) {
      const long long* b = jv + 8 * j;
      XJob& job = x.job[j];
      if (b[0] == 0 || b[1] == 0 || !fits_int(b[2]) || b[3] < 1 ||
          !fits_int(b[3]) || !fits_int(b[4]) || !fits_int(b[5]) ||
          b[6] < 1 || !fits_int(b[6]) || b[7] != row) {
        return false;
      }
      job.dst = reinterpret_cast<float*>(b[0]);
      job.src = reinterpret_cast<const float*>(b[1]);
      job.rows = (int)b[2];
      job.rpp = (int)b[3];
      job.sps = (int)b[4];
      job.dps = (int)b[5];
      job.bz = (int)b[6];
      job.row0 = (int)b[7];
      row += b[2];
    }
    if (row != st.rows) return false;
  }
  return next_job == nj;
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
// iv[31 i .. 31 i + 30], fv[6 i .. 6 i + 5]; every leg of one mode.  xv
// (nxv values): the exchange table of a multi-rank mesh (exch_args), whose
// legs read their slabs from the receive buffers; null on the one-rank
// mesh, whose legs read no slab.  info (out): blocks, blocks per SM,
// dynamic shared memory bytes.
int mg_pod_chain(int up, int n, const void* const* ptrs, const int* iv,
                 const float* fv, const float* tap_val, const int* tap_off3,
                 int ntaps, long long* info, const long long* xv, int nxv,
                 cudaStream_t stream) {
  if (n < 1 || n > kMaxPod) return (int)cudaErrorInvalidValue;
  const int mode = iv[0];
  const bool multi = xv != nullptr;
  PodXArgs p;
  memset(&p, 0, sizeof p);
  p.n = n;
  long long smem = 0;
  for (int i = 0; i < n; ++i) {
    const int* li = iv + 31 * i;
    // Every up leg corr-first, the norm only on the last; every down leg
    // with the restriction; slabs on a multi-rank mesh only, of one split.
    const bool ok = leg_args_ok(li, ntaps) && li[0] == mode &&
                    li[2] == (int)multi && li[3] == iv[3] &&
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
  if (multi && !exch_args(xv, nxv, n, p.x)) return (int)cudaErrorInvalidValue;
  const bool canon = p.lv[0].canon != 0;
  void* kernel = multi ? pick_x(mode, up != 0, canon)
                       : pick(mode, up != 0, n == 1, canon);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  long long grid[2];
  cudaError_t e = coop_grid(kernel, smem, grid);
  if (e != cudaSuccess) return (int)e;
  info[1] = grid[1];
  info[2] = smem;
  if (multi) {
    void* args[] = {(void*)&p};
    info[0] = grid[0];
    e = cudaLaunchCooperativeKernel(kernel, dim3((unsigned)grid[0]),
                                    dim3(kLegThreads), args, (size_t)smem,
                                    stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  PodArgs& q = p;  // the one-rank kernels take the table alone
  void* args[] = {(void*)&q};
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

// Host memory the device writes (the multi-rank chains' status word):
// *host for the host, *dev for a kernel.
int mg_host_alloc(long long bytes, void** host, void** dev) {
  cudaError_t e = cudaHostAlloc(host, (size_t)bytes,
                                cudaHostAllocMapped | cudaHostAllocPortable);
  if (e != cudaSuccess) return (int)e;
  memset(*host, 0, (size_t)bytes);
  return (int)cudaHostGetDevicePointer(dev, *host, 0);
}

int mg_host_free(void* host) { return (int)cudaFreeHost(host); }

}  // extern "C"
