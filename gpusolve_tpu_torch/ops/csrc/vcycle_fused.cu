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
// barrier (cooperative_groups::this_grid().sync()) separates every pair of
// ops.  So the ~80 launches of a per-op V(3,3) cycle at 511^3 become one
// launch with ~80 barriers; the coarse levels, a few tiles each, leave most
// blocks waiting at those barriers.
//
// Bound: bytes, as the per-op kernels (each op streams its fields once at a
// few flops per point).  The design moves the same bytes as the per-op
// cycle, less the coarse-level zero fill: a level that starts from v = 0
// takes its first sweep without reading v (LdZero), as the TPU kernel's
// specialised first sweep does.
//
// Rounding: the per-op kernels' point functions (mg_device.cuh), so every
// field equals the per-op cycle's bit for bit, and the norm too: the final
// level-0 residual writes each tile's partial at the index residual_kernel
// uses, and block 0 sums them as finalize_kernel does.  The TPU kernel
// rounds otherwise (taps that share a coefficient summed before the
// multiply, (omega alpha) f for a zero-start sweep, a Kahan sum of plane
// sums); the port keeps its own order throughout.
//
// FAS: the up leg prolongs v - rest_v computed on the fly and leaves the
// coarse v as it is, as the TPU kernel does (the per-op cycle subtracts in
// place instead).  The tau fold f_c = R(r) + A_c(rest_v) is one op, rounded
// as the per-op restrict + apply_fas.
//
// The launch needs every block resident (cudaLaunchCooperativeKernel); a
// grid larger than that fails with cudaErrorCooperativeLaunchTooLarge and
// the wrapper raises.  Grid: SMs x the occupancy calculator's blocks per
// SM, 256 threads a block.  grid.sync() needs <cooperative_groups.h> but no
// relocatable device code with the CUDA 12 toolkit.

#include <cooperative_groups.h>

#include "mg_device.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLevels = 16;
// As the per-op kernels: at most 40 registers, 6 blocks of 256 threads per
// SM.  LINEAR fits without spills; FAS and Newton spill a little.  At 64
// registers (4 blocks per SM) nothing spills, and the cycle is no faster.
constexpr int kVMinBlocks = 6;

// Op kinds; ops/vcycle_fused.py numbers them the same.  An op is int4
// {kind, level, a, b}:
//   ZERO      v buffer a of level = 0 (a zero start with no sweep)
//   SMOOTH0   sweep from v = 0 into buffer a
//   SMOOTH    sweep from buffer a into buffer b
//   RESIDUAL  r of v in buffer a into buffer b
//   RESTRICT  coarse f = R(buffer a)                    (LINEAR, NEWTON)
//   RESTRICTV coarse v buffer 0 = coarse rest_v = R(buffer a)      (FAS)
//   FASF      coarse f = R(buffer a) + A_c(coarse rest_v)          (FAS)
//   PROLONG   level-1 buffer 1-b = level-1 buffer b + P(coarse buffer a
//             [- rest_v in FAS]); `level` is the coarse level
//   NORM      level-0 residual of v in buffer a: per-tile sums of r^2
//   FINALIZE  block 0: the sum of the partials into norm_out
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
};

// Calls body(t, bx, by, bz) for this block's tiles of a pass over grid gr.
template <class Body>
__device__ __forceinline__ void for_tiles(const dim3 gr, Body body) {
  const unsigned n = gr.x * gr.y * gr.z;
  for (unsigned t = blockIdx.x; t < n; t += gridDim.x) {
    const unsigned rest = t / gr.x;
    body(t, t % gr.x, rest % gr.y, rest / gr.y);
  }
}

template <int M>
__device__ __forceinline__ void run_op(const int4 op, const Args& a, int tz,
                                       int ty) {
  const Level& L = a.lv[op.y];
  const ModeArgs ma{a.gamma, L.pre_fac};
  switch (op.x) {
    case kOpZero: {
      float* d = L.buf[op.z];
      for_tiles(grid_for(L.g), [&](unsigned, int bx, int by, int bz) {
        const int k = bx * kBZ + tz + 1;
        const int j = by * kBY + ty + 1;
        if (k > L.g.nz || j > L.g.ny) return;
        const int i1 = min(bz * kXCH + 1 + kXCH, L.g.nx + 1);
        for (int i = bz * kXCH + 1; i < i1; ++i) {
          d[i * L.g.sx + j * L.g.sy + k] = 0.0f;
        }
      });
      break;
    }
    case kOpSmooth0: {
      float* d = L.buf[op.z];
      for_tiles(grid_for(L.g), [&](unsigned, int bx, int by, int bz) {
        jacobi_tile<M, LdZero>(bx, by, bz, tz, ty, d, d, L.f, L.aux, L.g,
                               L.taps, L.inv_h2, L.alpha, a.omega, ma);
      });
      break;
    }
    case kOpSmooth: {
      const float* s = L.buf[op.z];
      float* d = L.buf[op.w];
      for_tiles(grid_for(L.g), [&](unsigned, int bx, int by, int bz) {
        jacobi_tile<M, LdPlain>(bx, by, bz, tz, ty, d, s, L.f, L.aux, L.g,
                                L.taps, L.inv_h2, L.alpha, a.omega, ma);
      });
      break;
    }
    case kOpResidual: {
      const float* v = L.buf[op.z];
      float* r = L.buf[op.w];
      for_tiles(grid_for(L.g), [&](unsigned, int bx, int by, int bz) {
        residual_tile<M, LdPlain>(bx, by, bz, tz, ty, v, L.f, L.aux, r, L.g,
                                  L.taps, L.inv_h2, a.gamma, true);
      });
      break;
    }
    case kOpRestrict: {
      const Level& C = a.lv[op.y + 1];
      const float* in = L.buf[op.z];
      for_tiles(grid_for(C.g), [&](unsigned, int bx, int by, int bz) {
        restrict_tile(bx, by, bz, tz, ty, C.g, L.g,
                      [&](long long cidx, long long center) {
                        C.f[cidx] = restrict_at<LdPlain>(in, center, L.g);
                      });
      });
      break;
    }
    case kOpRestrictV: {
      if constexpr (M == kNonlinear) {
        const Level& C = a.lv[op.y + 1];
        const float* in = L.buf[op.z];
        for_tiles(grid_for(C.g), [&](unsigned, int bx, int by, int bz) {
          restrict_tile(bx, by, bz, tz, ty, C.g, L.g,
                        [&](long long cidx, long long center) {
                          const float acc =
                              restrict_at<LdPlain>(in, center, L.g);
                          C.buf[0][cidx] = acc;
                          C.aux[cidx] = acc;
                        });
        });
      }
      break;
    }
    case kOpFasF: {
      if constexpr (M == kNonlinear) {
        const Level& C = a.lv[op.y + 1];
        const float* in = L.buf[op.z];
        for_tiles(grid_for(C.g), [&](unsigned, int bx, int by, int bz) {
          restrict_tile(
              bx, by, bz, tz, ty, C.g, L.g,
              [&](long long cidx, long long center) {
                const float rr = restrict_at<LdPlain>(in, center, L.g);
                C.f[cidx] = __fadd_rn(
                    rr, operator_at<kNonlinear, LdPlain>(
                            C.aux, nullptr, cidx, C.taps, C.inv_h2, a.gamma));
              });
        });
      }
      break;
    }
    case kOpProlong: {
      const Level& F = a.lv[op.y - 1];
      const float* cv = L.buf[op.z];
      const float* rv = L.aux;
      const float* fv = F.buf[op.w];
      float* d = F.buf[1 - op.w];
      for_tiles(prolong_grid_for(F.g), [&](unsigned, int bx, int by,
                                           int bz) {
        prolong_tile(
            bx, by, bz, tz, ty, F.g, L.g,
            [&](long long q) {
              if constexpr (M == kNonlinear) {
                return __fsub_rn(cv[q], rv[q]);
              } else {
                return cv[q];
              }
            },
            [&](long long idx, float e) { d[idx] = __fadd_rn(fv[idx], e); });
      });
      break;
    }
    case kOpNorm: {
      const float* v = L.buf[op.z];
      for_tiles(grid_for(L.g), [&](unsigned t, int bx, int by, int bz) {
        const double ss = residual_tile<M, LdPlain>(
            bx, by, bz, tz, ty, v, L.f, L.aux, nullptr, L.g, L.taps,
            L.inv_h2, a.gamma, false);
        const double total = block_sum(ss);
        if (threadIdx.x == 0) a.partials[t] = total;
        __syncthreads();  // block_sum's shared slots are reused next tile
      });
      break;
    }
    case kOpFinalize: {
      if (blockIdx.x == 0) {
        __shared__ double s[kFinThreads];
        const dim3 gr = grid_for(a.lv[0].g);
        const double total =
            finalize_sum(a.partials, (long long)gr.x * gr.y * gr.z, s);
        if (threadIdx.x == 0) *a.norm_out = (float)total;
      }
      break;
    }
    default:
      break;
  }
}

template <int M>
__global__ void __launch_bounds__(kThreads, kVMinBlocks)
vcycle_kernel(const int4* __restrict__ ops, int nops, Args a) {
  cg::grid_group grid = cg::this_grid();
  const int tz = threadIdx.x % kBZ, ty = threadIdx.x / kBZ;
  for (int q = 0; q < nops; ++q) {
    run_op<M>(ops[q], a, tz, ty);
    if (q + 1 < nops) grid.sync();
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
// h^2/values[0], values[0]/h^2.  partials: device float64, one per level-0
// tile (mg_residual_blocks); norm_out: device float32.  mode: 0 LINEAR, 1
// NONLINEAR, 2 NEWTON.
int mg_vcycle_fused(const int* ops, int nops, int mode, int nlev,
                    const long long* ptrs, const int* dims, const float* scal,
                    const float* tap_val, const int* tap_off3, int ntaps,
                    float omega, float gamma, double* partials,
                    float* norm_out, cudaStream_t stream) {
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
