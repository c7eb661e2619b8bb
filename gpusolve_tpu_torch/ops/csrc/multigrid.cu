// Multigrid kernels of the V/W/F cycle in all three modes (LINEAR, FAS,
// NEWTON), for Hopper (sm_90a).
//
// They replace the TPU kernels of the single-device solve:
// gpusolve_tpu/ops/pallas_kernels.py::_jacobi_call, ::_residual_call (the
// residual, its norm and the FAS operator), ::_restrict_call, ::_prolong_call
// and gpusolve_tpu/ops/pallas_vcycle2.py::_vcycle2_call (the whole batch of
// cycles).  The host launches the batch level by level (ops/
// vcycle_batch.py), each level visit as the fused legs of mg_legs.cu where
// they run, else as these per-op kernels:
//
//   mg_residual       r = f - (A v / h^2 + mode term), optional r write,
//                     per-block sum r^2
//   mg_finalize       one cluster of 8 blocks: sum the partials, write
//                     norms[i], set done
//   mg_jacobi         one damped-Jacobi sweep, out of place, per mode
//   mg_restrict_zero  coarse f = 27-point full weighting of r; coarse v = 0
//   mg_restrict       out = full weighting of a fine field (FAS R(r), R(v)
//                     into coarse v and rest_v at once; Newton R(u~))
//   mg_prolong_add    v += P(coarse v), trilinear, in place
//   mg_apply_fas      out += A v / h^2 + gamma v e^v (the FAS tau fold)
//   mg_subtract       v -= w (FAS: coarse v -= rest_v before prolongation)
//
// and the device-batched Newton outer loop's steps (solver/newton.py,
// _newton_batch), which the JAX package runs as XLA glue around its
// whole-batch kernel (gpusolve_tpu/solver/newton.py:174-199: lax.cond,
// the threshold arithmetic, newton_v + v):
//
//   mg_finalize_dev_thr  mg_finalize with the stop threshold read from a
//                        device float (the inner solve's, which the
//                        previous step's gate writes)
//   mg_newton_zero       level 0's v = 0, gated by the outer flag
//   mg_newton_update     u~ += v, v picked on the device from the two
//                        buffers the smoother ping-pongs, gated
//   mg_newton_gate       one thread: the outer norm, the outer stop, the
//                        next step's inner threshold and inner flag
//
// Array model (mg_device.cuh): a dense (nx+2, ny+2, nz+2) float32 array
// per level, z contiguous, with a zero halo that no kernel ever writes.
//
// Bound: every kernel streams its fields once and does a handful of flops
// per point (under 2 flops per byte even with expf's ~20), far below the
// card's flop-per-byte ridge, so each is bound by device-memory bytes.  The
// design moves each field once per op: a block covers a 32(z) x 8(y) column
// and walks XCH x-planes, so the +-x taps of one plane were loaded by the
// block's previous plane and hit in L1, and the +-y/+-z taps hit in L1 from
// the neighbouring threads' loads.  The sweeps of a leg fused into one pass
// (the TPU kernel's wavefront) are mg_legs.cu's; these kernels run the
// coarsest level and the visits the legs refuse.
//
// Early stop: every kernel takes the device flag `done` and returns at once
// when it is set; mg_finalize sets it when thr >= 0 and sum r^2 <= thr.  So
// the host can enqueue a whole batch of cycles with no sync, and the cycles
// after the stop write nothing, as in the TPU kernel.
//
// Rounding: the point arithmetic lives in mg_device.cuh, shared with the
// whole-V-cycle kernel (vcycle_fused.cu): every product, sum and quotient
// rounded as its own operation in ops/ref.py's order, the accurate expf.
// So the fields agree with the plain versions bit for bit wherever expf and
// torch.exp on the card agree.  Only the norm differs: it is summed in
// float64 in a fixed order (deterministic) and rounded to float32 once.
//
// The residual and the sweep are templated on the mode, so the LINEAR
// instantiations carry no nonlinear code and keep their registers.
//
// Every entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_pipeline.h>

#include <cstdint>

#include "mg_device.cuh"

namespace cg = cooperative_groups;

namespace {

// Stencil kernels keep to 40 registers (6 blocks, 1536 threads per SM):
// at 80 registers the unrolled taps held 3 blocks per SM and reached a
// quarter of the byte bound.
constexpr int kMinBlocks = 6;

// finalize: one cluster of kFinCluster blocks, each owning kFinBlock of
// the kFinThreads slots; a block copies kFinRows rows of its slots'
// partials at a time into shared memory, in kFinGroups groups it waits for
// in turn.
constexpr int kFinCluster = 8;
constexpr int kFinBlock = kFinThreads / kFinCluster;
constexpr int kFinRows = 64;
constexpr int kFinGroups = 4;
constexpr int kFinStageBytes = kFinRows * kFinBlock * (int)sizeof(double);
static_assert(kFinBlock == 128, "finalize's warp-0 tail adds 4 slots a lane");

// subtract: groups of 4 floats (one 16-byte vector where v and w are
// 16-byte aligned), kSubBatch groups a thread, one x-plane a grid row;
// its 2 * kSubBatch vectors in registers need more than the stencil
// kernels' 40 registers, and 4 blocks an SM keep 128 KB in flight.
constexpr int kSubBatch = 4;
constexpr int kSubMinBlocks = 4;

template <int M>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
residual_kernel(const float* __restrict__ v, const float* __restrict__ f,
                const float* __restrict__ nv, float* __restrict__ r,
                double* __restrict__ partials, const int* __restrict__ done,
                Geom g, Taps taps, float inv_h2, float gamma, int write_r) {
  if (*done) return;
  const double ss = residual_tile<M, LdNC>(
      blockIdx.x, blockIdx.y, blockIdx.z, threadIdx.x, threadIdx.y, v, f, nv,
      r, g, taps, inv_h2, gamma, write_r);
  if (partials != nullptr) {
    const double total = block_sum(ss);
    if (threadIdx.x == 0 && threadIdx.y == 0) {
      partials[blockIdx.x +
               gridDim.x * (blockIdx.y + (long long)gridDim.y * blockIdx.z)] =
          total;
    }
  }
}

// The FAS operator A v / h^2 + gamma v e^v (the residual kernel's
// apply_mode, no f), added onto out: the tau fold f_c = R(r) + A_c(R v),
// rounded as f_next + a_coarse (onto a zero out it is the operator
// itself).  Each point reads and writes only its own out value, so out may
// be the coarse f that holds R(r).
__global__ void __launch_bounds__(kThreads, kMinBlocks)
apply_fas_kernel(float* out, const float* __restrict__ v,
                 const int* __restrict__ done, Geom g, Taps taps,
                 float inv_h2, float gamma) {
  if (*done) return;
  const int k = blockIdx.x * kBZ + threadIdx.x + 1;
  const int j = blockIdx.y * kBY + threadIdx.y + 1;
  if (k > g.nz || j > g.ny) return;
  const int i0 = blockIdx.z * kXCH + 1;
  const int i1 = min(i0 + kXCH, g.nx + 1);
  long long idx = i0 * g.sx + j * g.sy + k;
  for (int i = i0; i < i1; ++i, idx += g.sx) {
    const float a =
        operator_at<kNonlinear, LdNC>(v, nullptr, idx, taps, inv_h2, gamma);
    out[idx] = __fadd_rn(out[idx], a);
  }
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// Rows r0, r0 + kFinThreads, ... (kFinRows of them) of this block's
// slots into stage, as 16-byte cp.async in kFinGroups commit groups:
// thread tid copies pair tid % kPairs of rows 2k + tid / kPairs.  kWhole:
// every row lies below n, so each copy is a pointer plus a constant.
// Else past the end the copy fills +0.0, which leaves a slot's sum as it
// is (it starts at +0.0, so it is never -0.0).
template <bool kWhole>
__device__ __forceinline__ void finalize_copy(double* stage,
                                              const double* partials,
                                              long long r0, long long n,
                                              int tid) {
  constexpr int kPairs = kFinBlock / 2;
  constexpr int kPer = kFinRows / kFinGroups;
  const long long t0 =
      r0 + (long long)(tid / kPairs) * kFinThreads + 2 * (tid % kPairs);
  double* dst = stage + (tid / kPairs) * kFinBlock + 2 * (tid % kPairs);
#pragma unroll
  for (int k = 0; k < kFinRows / 2; ++k) {
    const long long t = t0 + 2LL * k * kFinThreads;
    double* d = dst + 2 * k * kFinBlock;
    if (kWhole || t + 1 < n) {
      __pipeline_memcpy_async(d, partials + t, 2 * sizeof(double));
    } else {
      if (t < n) {
        __pipeline_memcpy_async(d, partials + t, sizeof(double));
      } else {
        d[0] = 0.0;
      }
      d[1] = 0.0;
    }
    if (2 * (k + 1) % kPer == 0) __pipeline_commit();
  }
}

// The norm as one thread-block cluster of kFinCluster blocks (the
// portable cluster size) of kFinBlock threads, in finalize_sum's order
// (mg_device.cuh), which v1's kernel keeps: slot q sums partials q,
// q + kFinThreads, ... in order, then the halving tree s[q] += s[q + w]
// for w = kFinThreads/2 ... 1, rounded once to float32.  Bound: latency.
// One block of kFinThreads used to walk the slots on one SM, each thread
// with one dependent load after another.  Here block b owns slots
// kFinBlock*b ...: a row of its partials (kFinBlock doubles, 1 KB) is
// contiguous, so its threads copy kFinRows rows into shared memory as
// 16-byte cp.async (no registers held: all in flight at once), and each
// thread adds its slot's column in order as each group of rows lands.
// Eight SMs pull the partials at once.  Then each block writes its slot
// sums into block 0's shared memory (distributed shared memory), one
// cluster barrier, and block 0 runs the tree: w = 512, 256, 128 pair
// slots that one thread holds (in registers), w = 64 and 32 in warp 0,
// w < 32 as shuffles; the pairs and operand order are the tree's.  Every
// block reads the same done flag at entry, so all return or none does (a
// block that left alone would leave the others at the cluster barrier).
//
// kDevThr: the threshold is read from *thr_dev (written by an earlier
// kernel on the stream: the Newton gate), else it is `thr`.
template <bool kDevThr>
__global__ void __cluster_dims__(kFinCluster, 1, 1)
__launch_bounds__(kFinBlock)
finalize_kernel(const double* __restrict__ partials, long long n,
                float* __restrict__ out, float thr,
                const float* __restrict__ thr_dev, int* done) {
  if (*done) return;
  extern __shared__ __align__(16) double stage[];  // kFinRows x kFinBlock
  __shared__ double s[kFinThreads];
  cg::cluster_group cluster = cg::this_cluster();
  // Every block must have started before another writes its shared
  // memory: arrive now, wait before the writes.
  cluster_arrive_relaxed();
  const int tid = threadIdx.x;
  const int rank = (int)cluster.block_rank();
  constexpr int kPer = kFinRows / kFinGroups;  // rows a group
  double acc = 0.0;
  for (long long r0 = (long long)kFinBlock * rank; r0 < n;
       r0 += (long long)kFinRows * kFinThreads) {
    if (r0 + (long long)(kFinRows - 1) * kFinThreads + kFinBlock <= n) {
      finalize_copy<true>(stage, partials, r0, n, tid);
    } else {
      finalize_copy<false>(stage, partials, r0, n, tid);
    }
#pragma unroll
    for (int grp = 0; grp < kFinGroups; ++grp) {
      __pipeline_wait_prior(kFinGroups - 1 - grp);
      __syncthreads();  // the group's rows, copied by every thread
#pragma unroll
      for (int b = grp * kPer; b < (grp + 1) * kPer; ++b) {
        acc += stage[b * kFinBlock + tid];
      }
    }
    __syncthreads();  // all reads done before the next rows land
  }
  cluster_wait();
  cluster.map_shared_rank(s, 0)[kFinBlock * rank + tid] = acc;
  cluster.sync();
  if (rank != 0) return;
  double y[kFinCluster];  // slots kFinBlock * r + tid
#pragma unroll
  for (int r = 0; r < kFinCluster; ++r) y[r] = s[kFinBlock * r + tid];
#pragma unroll
  for (int h = kFinCluster / 2; h > 0; h /= 2) {  // w = kFinBlock * h
#pragma unroll
    for (int r = 0; r < h; ++r) y[r] += y[r + h];
  }
  __syncthreads();  // every slot read before s[tid] is overwritten
  s[tid] = y[0];
  __syncthreads();
  if (tid < 32) {
    // w = 64 and 32, then w = 16 ... 1 (lane q: s[q] + s[q + w]).
    double x = (s[tid] + s[tid + 64]) + (s[tid + 32] + s[tid + 96]);
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) x += __shfl_down_sync(0xffffffffu, x, w);
    if (tid == 0) {
      const float ss = (float)x;
      *out = ss;
      const float t = kDevThr ? *thr_dev : thr;
      if (t >= 0.0f && ss <= t) *done = 1;
    }
  }
}

// One sweep, out of place (mg_device.cuh: jacobi_tile).
template <int M>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
jacobi_kernel(float* __restrict__ v_out, const float* __restrict__ v,
              const float* __restrict__ f, const float* __restrict__ nv,
              const int* __restrict__ done, Geom g, Taps taps, float inv_h2,
              float alpha, float omega, ModeArgs ma) {
  if (*done) return;
  jacobi_tile<M, LdNC>(blockIdx.x, blockIdx.y, blockIdx.z, threadIdx.x,
                       threadIdx.y, v_out, v, f, nv, g, taps, inv_h2, alpha,
                       omega, ma);
}

// kZero: out0 = R(in) and out1 = 0 (the LINEAR/Newton coarse start);
// else out0 = R(in) and, when out1 is given, out1 = R(in) as well (FAS
// R(v) into coarse v and rest_v in one pass).
template <bool kZero>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
restrict_kernel(float* __restrict__ out0, float* __restrict__ out1,
                const float* __restrict__ in, const int* __restrict__ done,
                Geom c, Geom fg) {
  if (*done) return;
  restrict_tile(blockIdx.x, blockIdx.y, blockIdx.z, threadIdx.x, threadIdx.y,
                c, fg, [&](long long cidx, long long center) {
                  const float acc = restrict_at<LdNC>(in, center, fg);
                  out0[cidx] = acc;
                  if constexpr (kZero) {
                    out1[cidx] = 0.0f;
                  } else {
                    if (out1 != nullptr) out1[cidx] = acc;
                  }
                });
}

// vf += P(vc), in place (each point reads only its own fine v).
__global__ void __launch_bounds__(kThreads, kMinBlocks)
prolong_add_kernel(float* __restrict__ vf, const float* __restrict__ vc,
                   const int* __restrict__ done, Geom fg, Geom c) {
  if (*done) return;
  prolong_tile(
      blockIdx.x, blockIdx.y, blockIdx.z, threadIdx.x, threadIdx.y, fg, c,
      [&](long long q) { return __ldg(vc + q); },
      [&](long long idx, float e) { vf[idx] = __fadd_rn(vf[idx], e); });
}

// v -= w over the interior, in place: the FAS coarse v - rest_v that the
// prolongation then reads (each point touches only itself).  Bound:
// bytes.  The pass is flat, as a copy's: grid row i - 1 covers x-plane
// i from its first interior point to its last in groups of 4 floats
// (element 4q ... 4q + 3 of the array), consecutive threads on
// consecutive groups, each thread loading its kSubBatch groups of v and w
// (16-byte vectors where kVec, 128 bytes in flight a thread) before any
// store.  A group's points outside the interior (the row ends, the halo
// rows between two planes' interiors) are read but never written: the
// halo is not written, so the pod engine's tail root and the spmd
// engine's replicated levels keep theirs.  Two planes' interiors lie
// 2 nz + 7 >= 9 points apart, so no group belongs to two grid rows.  v is
// __restrict__: the wrapper refuses v and w that share any memory.
// The same pass adds (the Newton update u~ += v) or stores zeros (the
// Newton step's zero start of level 0's v, which reads nothing).
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* p) {
  if constexpr (kVec) {
    return *reinterpret_cast<const float4*>(p);
  } else {
    return make_float4(p[0], p[1], p[2], p[3]);
  }
}

enum FlatOp { kFlatSub, kFlatAdd, kFlatZero };

template <int kOp>
__device__ __forceinline__ float flat_op(float a, float b) {
  if constexpr (kOp == kFlatSub) return __fsub_rn(a, b);
  if constexpr (kOp == kFlatAdd) return __fadd_rn(a, b);
  return 0.0f;
}

template <bool kVec, int kOp>
__device__ __forceinline__ void flat_pass(float* __restrict__ v,
                                          const float* __restrict__ w,
                                          const Geom& g) {
  const int i = blockIdx.y + 1;
  const long long plane = i * g.sx;
  const long long first = (plane + g.sy + 1) >> 2;
  const long long last = (plane + g.ny * g.sy + g.nz) >> 2;
  const long long q0 =
      first + (long long)blockIdx.x * kThreads * kSubBatch + threadIdx.x;
  float4 a[kSubBatch], b[kSubBatch];
  if constexpr (kOp != kFlatZero) {
#pragma unroll
    for (int m = 0; m < kSubBatch; ++m) {
      const long long q = q0 + m * kThreads;
      if (q <= last) {
        a[m] = load4<kVec>(v + 4 * q);
        b[m] = load4<kVec>(w + 4 * q);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kSubBatch; ++m) {
    const long long q = q0 + m * kThreads;
    if (q > last) continue;
    float4 d = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if constexpr (kOp != kFlatZero) {
      d = make_float4(
          flat_op<kOp>(a[m].x, b[m].x), flat_op<kOp>(a[m].y, b[m].y),
          flat_op<kOp>(a[m].z, b[m].z), flat_op<kOp>(a[m].w, b[m].w));
    }
    // (j, k) of the group's first point within plane i.
    const int rel = (int)(4 * q - plane);
    int j = rel / (int)g.sy;
    int k = rel - j * (int)g.sy;
    if (kVec && k >= 1 && k + 3 <= g.nz && j >= 1 && j <= g.ny) {
      *reinterpret_cast<float4*>(v + 4 * q) = d;
      continue;
    }
    const float dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (j >= 1 && j <= g.ny && k >= 1 && k <= g.nz) v[4 * q + c] = dv[c];
      if (++k == (int)g.sy) {
        k = 0;
        ++j;
      }
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, kSubMinBlocks)
subtract_kernel(float* __restrict__ v, const float* __restrict__ w,
                const int* __restrict__ done, Geom g) {
  if (*done) return;
  flat_pass<kVec, kFlatSub>(v, w, g);
}

// Level 0's v = 0 over the interior, unless the outer flag is set: the
// zero start of a Newton step's inner solve (solver/newton.py,
// _prepare_find_error).  Gated so that a step after the outer stop keeps
// the v the last executed step left.  Bound: bytes (writes v once).
template <bool kVec>
__global__ void __launch_bounds__(kThreads, kSubMinBlocks)
newton_zero_kernel(float* __restrict__ v, const int* __restrict__ done,
                   Geom g) {
  if (*done) return;
  flat_pass<kVec, kFlatZero>(v, nullptr, g);
}

// u~ += v over the interior, unless the outer flag is set.  Which buffer
// holds v depends on how many inner cycles ran, which only the device
// knows: every thread counts the executed entries of the step's row of
// inner norms (those not -1; ncyc floats, L1 hits after the first warp)
// and takes vb where bit c of b_mask is set, else va.  Bound: bytes
// (reads u~ and v, writes u~: 12 B a point).
template <bool kVec>
__global__ void __launch_bounds__(kThreads, kSubMinBlocks)
newton_update_kernel(float* __restrict__ nv, const float* va,
                     const float* vb, const float* __restrict__ norms,
                     int ncyc, unsigned b_mask,
                     const int* __restrict__ done, Geom g) {
  if (*done) return;
  int c = 0;
  for (int q = 0; q < ncyc; ++q) c += norms[q] != -1.0f;
  flat_pass<kVec, kFlatAdd>(nv, (b_mask >> c) & 1u ? vb : va, g);
}

// The outer gate of the batched Newton loop (gpusolve_tpu/solver/
// newton.py:176-179, :194-199), one thread.  Seed (ss null): clear both flags and
// write the first step's inner threshold from the host's ||F|| `fn`.
// Else, unless the outer flag is set: res = sqrtf(sum F^2) into *res_out,
// outer flag = (res >= 0 && res <= thr_outer), the inner flag the next
// step starts from = the outer flag, and the next step's inner threshold
// from res.  The inner threshold is the JAX loop's float32 formula,
// (f32(fn) * 0.1f)^2 moved up 2 ulps: each product rounded on its own
// (no fma), IEEE sqrtf and nextafterf (no fast-math flag), so it equals
// numpy's float32 result bit for bit.  Bound: latency (a few words).
__global__ void __launch_bounds__(1)
newton_gate_kernel(const float* __restrict__ ss, float fn, float thr_outer,
                   float* __restrict__ res_out, int* __restrict__ odone,
                   int* __restrict__ idone, float* __restrict__ thr_in) {
  float res = fn;
  int d = 0;
  if (ss != nullptr) {
    if (*odone) return;
    res = sqrtf(*ss);
    *res_out = res;
    d = (res >= 0.0f && res <= thr_outer) ? 1 : 0;
  }
  *odone = d;
  *idone = d;
  const float inf = __int_as_float(0x7f800000);
  float t = __fmul_rn(res, 0.1f);
  t = __fmul_rn(t, t);
  *thr_in = nextafterf(nextafterf(t, inf), inf);
}

// The grid of a flat pass over (nx, ny, nz): one x-plane a grid row, its
// interior span, ny * (nz + 2) - 2 points, in groups of 4 floats that
// may start and end inside a group.
dim3 flat_grid(const Geom& g) {
  const long long groups = (g.ny * g.sy + 6) / 4 + 1;
  return dim3((unsigned)((groups + kThreads * kSubBatch - 1) /
                         (kThreads * kSubBatch)), g.nx);
}

bool aligned16(const void* a, const void* b = nullptr,
               const void* c = nullptr) {
  return (((uintptr_t)a | (uintptr_t)b | (uintptr_t)c) & 15) == 0;
}

}  // namespace

extern "C" {

// Number of blocks (and so of partial sums) mg_residual launches.
long long mg_residual_blocks(int nx, int ny, int nz) {
  const dim3 gr = grid_for(make_geom(nx, ny, nz));
  return (long long)gr.x * gr.y * gr.z;
}

const char* mg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// mode: 0 LINEAR, 1 NONLINEAR, 2 NEWTON (nv is read only by NEWTON).
int mg_residual(const float* v, const float* f, const float* nv, float* r,
                double* partials, const int* done, int nx, int ny, int nz,
                const float* tap_val, const int* tap_off3, int ntaps,
                float inv_h2, float gamma, int mode, int write_r,
                cudaStream_t stream) {
  const Geom g = make_geom(nx, ny, nz);
  const Taps t = make_taps(tap_val, tap_off3, ntaps, g);
  const dim3 grid = grid_for(g), block(kBZ, kBY);
  switch (mode) {
    case kLinear:
      residual_kernel<kLinear><<<grid, block, 0, stream>>>(
          v, f, nv, r, partials, done, g, t, inv_h2, gamma, write_r);
      break;
    case kNonlinear:
      residual_kernel<kNonlinear><<<grid, block, 0, stream>>>(
          v, f, nv, r, partials, done, g, t, inv_h2, gamma, write_r);
      break;
    case kNewton:
      residual_kernel<kNewton><<<grid, block, 0, stream>>>(
          v, f, nv, r, partials, done, g, t, inv_h2, gamma, write_r);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int mg_apply_fas(float* out, const float* v, const int* done, int nx, int ny,
                 int nz, const float* tap_val, const int* tap_off3, int ntaps,
                 float inv_h2, float gamma, cudaStream_t stream) {
  const Geom g = make_geom(nx, ny, nz);
  apply_fas_kernel<<<grid_for(g), dim3(kBZ, kBY), 0, stream>>>(
      out, v, done, g, make_taps(tap_val, tap_off3, ntaps, g), inv_h2,
      gamma);
  return (int)cudaGetLastError();
}

// The dynamic shared memory of a finalize block (its staged partials).
int mg_finalize_stage_bytes() { return kFinStageBytes; }

// One cluster of kFinCluster blocks; a refused cluster launch returns its
// error like any other.
int mg_finalize(const double* partials, long long n, float* out, float thr,
                int* done, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      finalize_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kFinStageBytes);
  if (e != cudaSuccess) return (int)e;
  finalize_kernel<false><<<kFinCluster, kFinBlock, kFinStageBytes, stream>>>(
      partials, n, out, thr, nullptr, done);
  return (int)cudaGetLastError();
}

// mg_finalize with the threshold read from the device float *thr.
int mg_finalize_dev_thr(const double* partials, long long n, float* out,
                        const float* thr, int* done, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      finalize_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kFinStageBytes);
  if (e != cudaSuccess) return (int)e;
  finalize_kernel<true><<<kFinCluster, kFinBlock, kFinStageBytes, stream>>>(
      partials, n, out, -1.0f, thr, done);
  return (int)cudaGetLastError();
}

int mg_jacobi(float* v_out, const float* v, const float* f, const float* nv,
              const int* done, int nx, int ny, int nz, const float* tap_val,
              const int* tap_off3, int ntaps, float inv_h2, float alpha,
              float omega, float gamma, float pre_fac, int mode,
              cudaStream_t stream) {
  const Geom g = make_geom(nx, ny, nz);
  const Taps t = make_taps(tap_val, tap_off3, ntaps, g);
  const dim3 grid = grid_for(g), block(kBZ, kBY);
  const ModeArgs ma{gamma, pre_fac};
  switch (mode) {
    case kLinear:
      jacobi_kernel<kLinear><<<grid, block, 0, stream>>>(
          v_out, v, f, nv, done, g, t, inv_h2, alpha, omega, ma);
      break;
    case kNonlinear:
      jacobi_kernel<kNonlinear><<<grid, block, 0, stream>>>(
          v_out, v, f, nv, done, g, t, inv_h2, alpha, omega, ma);
      break;
    case kNewton:
      jacobi_kernel<kNewton><<<grid, block, 0, stream>>>(
          v_out, v, f, nv, done, g, t, inv_h2, alpha, omega, ma);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int mg_restrict_zero(float* fc, float* vc, const float* rf, const int* done,
                     int cnx, int cny, int cnz, int fnx, int fny, int fnz,
                     cudaStream_t stream) {
  const Geom c = make_geom(cnx, cny, cnz);
  restrict_kernel<true><<<grid_for(c), dim3(kBZ, kBY), 0, stream>>>(
      fc, vc, rf, done, c, make_geom(fnx, fny, fnz));
  return (int)cudaGetLastError();
}

// out1 may be null (one output).
int mg_restrict(float* out0, float* out1, const float* in, const int* done,
                int cnx, int cny, int cnz, int fnx, int fny, int fnz,
                cudaStream_t stream) {
  const Geom c = make_geom(cnx, cny, cnz);
  restrict_kernel<false><<<grid_for(c), dim3(kBZ, kBY), 0, stream>>>(
      out0, out1, in, done, c, make_geom(fnx, fny, fnz));
  return (int)cudaGetLastError();
}

int mg_prolong_add(float* vf, const float* vc, const int* done, int fnx,
                   int fny, int fnz, int cnx, int cny, int cnz,
                   cudaStream_t stream) {
  const Geom fg = make_geom(fnx, fny, fnz);
  prolong_add_kernel<<<prolong_grid_for(fg), dim3(kBZ, kBY), 0, stream>>>(
      vf, vc, done, fg, make_geom(cnx, cny, cnz));
  return (int)cudaGetLastError();
}

int mg_subtract(float* v, const float* w, const int* done, int nx, int ny,
                int nz, cudaStream_t stream) {
  const Geom g = make_geom(nx, ny, nz);
  const dim3 grid = flat_grid(g);
  if (aligned16(v, w)) {
    subtract_kernel<true><<<grid, kThreads, 0, stream>>>(v, w, done, g);
  } else {
    subtract_kernel<false><<<grid, kThreads, 0, stream>>>(v, w, done, g);
  }
  return (int)cudaGetLastError();
}

int mg_newton_zero(float* v, const int* done, int nx, int ny, int nz,
                   cudaStream_t stream) {
  const Geom g = make_geom(nx, ny, nz);
  const dim3 grid = flat_grid(g);
  if (aligned16(v)) {
    newton_zero_kernel<true><<<grid, kThreads, 0, stream>>>(v, done, g);
  } else {
    newton_zero_kernel<false><<<grid, kThreads, 0, stream>>>(v, done, g);
  }
  return (int)cudaGetLastError();
}

// norms: the step's ncyc inner norms (-1 where a cycle did not run); bit
// c of b_mask set: v is in vb after c cycles, else in va.
int mg_newton_update(float* nv, const float* va, const float* vb,
                     const float* norms, int ncyc, unsigned b_mask,
                     const int* done, int nx, int ny, int nz,
                     cudaStream_t stream) {
  const Geom g = make_geom(nx, ny, nz);
  const dim3 grid = flat_grid(g);
  if (aligned16(nv, va, vb)) {
    newton_update_kernel<true><<<grid, kThreads, 0, stream>>>(
        nv, va, vb, norms, ncyc, b_mask, done, g);
  } else {
    newton_update_kernel<false><<<grid, kThreads, 0, stream>>>(
        nv, va, vb, norms, ncyc, b_mask, done, g);
  }
  return (int)cudaGetLastError();
}

// ss null: the seed (see newton_gate_kernel); res_out may then be null.
int mg_newton_gate(const float* ss, float fn, float thr_outer,
                   float* res_out, int* odone, int* idone, float* thr_in,
                   cudaStream_t stream) {
  newton_gate_kernel<<<1, 1, 0, stream>>>(ss, fn, thr_outer, res_out, odone,
                                           idone, thr_in);
  return (int)cudaGetLastError();
}

}  // extern "C"
