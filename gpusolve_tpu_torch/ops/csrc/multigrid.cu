// Multigrid kernels of the V/W/F cycle in all three modes (LINEAR, FAS,
// NEWTON), for Hopper (sm_90a).
//
// They replace the TPU kernels of the single-device solve:
// gpusolve_tpu/ops/pallas_kernels.py::_jacobi_call, ::_residual_call (the
// residual, its norm and the FAS operator), ::_restrict_call, ::_prolong_call
// and gpusolve_tpu/ops/pallas_vcycle2.py::_vcycle2_call (the whole batch of
// cycles).  The batch is built here from per-op kernels that the host
// launches level by level (ops/vcycle_batch.py):
//
//   mg_residual       r = f - (A v / h^2 + mode term), optional r write,
//                     per-block sum r^2
//   mg_finalize       one block: sum the partials, write norms[i], set done
//   mg_jacobi         one damped-Jacobi sweep, out of place, per mode
//   mg_restrict_zero  coarse f = 27-point full weighting of r; coarse v = 0
//   mg_restrict       out = full weighting of a fine field (FAS R(r), R(v)
//                     into coarse v and rest_v at once; Newton R(u~))
//   mg_prolong_add    v += P(coarse v), trilinear, in place
//   mg_apply_fas      out += A v / h^2 + gamma v e^v (the FAS tau fold)
//   mg_subtract       v -= w (FAS: coarse v -= rest_v before prolongation)
//
// Array model: a level is a dense (nx+2, ny+2, nz+2) float32 array, z
// contiguous, with a zero halo that no kernel ever writes.
//
// Bound: every kernel streams its fields once and does a handful of flops
// per point (under 2 flops per byte even with expf's ~20), far below the
// card's flop-per-byte ridge, so each is bound by device-memory bytes.  The
// design moves each field once per op: a block covers a 32(z) x 8(y) column
// and walks XCH x-planes, so the +-x taps of one plane were loaded by the
// block's previous plane and hit in L1, and the +-y/+-z taps hit in L1 from
// the neighbouring threads' loads.  Fusing the sweeps of a leg into one pass
// (2.5-D temporal blocking, the TPU kernel's wavefront) is later work.
//
// Early stop: every kernel takes the device flag `done` and returns at once
// when it is set; mg_finalize sets it when thr >= 0 and sum r^2 <= thr.  So
// the host can enqueue a whole batch of cycles with no sync, and the cycles
// after the stop write nothing, as in the TPU kernel.
//
// Rounding: every product, sum and quotient is rounded as its own operation
// (__fmul_rn / __fadd_rn / __fdiv_rn keep nvcc from contracting them into
// FMAs), in the operation order of the plain PyTorch version (ops/ref.py,
// itself the order of gpusolve_tpu/ops/xla.py), and e^x is the accurate
// expf, never __expf; never build with --use_fast_math.  So the fields
// agree with the plain versions bit for bit wherever expf and torch.exp on
// the card agree.  Only the norm differs: it is summed in float64 in a
// fixed order (deterministic) and rounded to float32 once.
//
// The residual and the sweep are templated on the mode, so the LINEAR
// instantiations carry no nonlinear code and keep their registers.
//
// Every entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError().

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

Geom make_geom(int nx, int ny, int nz) {
  Geom g;
  g.nx = nx;
  g.ny = ny;
  g.nz = nz;
  g.sy = nz + 2;
  g.sx = (long long)(ny + 2) * (nz + 2);
  return g;
}

dim3 grid_for(const Geom& g) {
  return dim3((g.nz + kBZ - 1) / kBZ, (g.ny + kBY - 1) / kBY,
              (g.nx + kXCH - 1) / kXCH);
}

__device__ __forceinline__ float stencil_at(const float* __restrict__ v,
                                            long long idx, const Taps& t,
                                            float inv_h2) {
  float acc = __fmul_rn(t.val[0], __ldg(v + idx + t.off[0]));
#pragma unroll
  for (int k = 1; k < kMaxTaps; ++k) {
    if (k < t.n) {
      acc = __fadd_rn(acc, __fmul_rn(t.val[k], __ldg(v + idx + t.off[k])));
    }
  }
  return __fmul_rn(acc, inv_h2);
}

// FAS term gamma * v * e^v, as (gamma * v) * e^v.
__device__ __forceinline__ float fas_term(float v, float ex, float gamma) {
  return __fmul_rn(__fmul_rn(gamma, v), ex);
}

// A v / h^2 plus the mode's nonlinear term, in the plain version's order:
//   NONLINEAR  av + (gamma v) e^v
//   NEWTON     av + ((gamma (1 + nv)) v) e^nv
template <int M>
__device__ __forceinline__ float operator_at(const float* __restrict__ v,
                                             const float* __restrict__ nv,
                                             long long idx, const Taps& t,
                                             float inv_h2, float gamma) {
  const float av = stencil_at(v, idx, t, inv_h2);
  if constexpr (M == kNonlinear) {
    const float vc = v[idx];
    return __fadd_rn(av, fas_term(vc, expf(vc), gamma));
  } else if constexpr (M == kNewton) {
    const float n = nv[idx];
    const float lin0 = __fmul_rn(gamma, __fadd_rn(1.0f, n));
    return __fadd_rn(av, __fmul_rn(__fmul_rn(lin0, v[idx]), expf(n)));
  } else {
    return av;
  }
}

// Fixed-order block sum of one double per thread; the result is valid in
// thread 0.
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

// Stencil kernels keep to 40 registers (6 blocks, 1536 threads per SM):
// at 80 registers the unrolled taps held 3 blocks per SM and reached a
// quarter of the byte bound.
constexpr int kMinBlocks = 6;

template <int M>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
residual_kernel(const float* __restrict__ v, const float* __restrict__ f,
                const float* __restrict__ nv, float* __restrict__ r,
                double* __restrict__ partials, const int* __restrict__ done,
                Geom g, Taps taps, float inv_h2, float gamma, int write_r) {
  if (*done) return;
  const int k = blockIdx.x * kBZ + threadIdx.x + 1;
  const int j = blockIdx.y * kBY + threadIdx.y + 1;
  const int i0 = blockIdx.z * kXCH + 1;
  const int i1 = min(i0 + kXCH, g.nx + 1);
  double ss = 0.0;
  if (k <= g.nz && j <= g.ny) {
    long long idx = i0 * g.sx + j * g.sy + k;
    for (int i = i0; i < i1; ++i, idx += g.sx) {
      const float res = __fsub_rn(
          f[idx], operator_at<M>(v, nv, idx, taps, inv_h2, gamma));
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
        operator_at<kNonlinear>(v, nullptr, idx, taps, inv_h2, gamma);
    out[idx] = __fadd_rn(out[idx], a);
  }
}

__global__ void __launch_bounds__(kFinThreads)
finalize_kernel(const double* __restrict__ partials, long long n,
                float* __restrict__ out, float thr, int* done) {
  if (*done) return;
  __shared__ double s[kFinThreads];
  double acc = 0.0;
  for (long long t = threadIdx.x; t < n; t += kFinThreads) acc += partials[t];
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int w = kFinThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) s[threadIdx.x] += s[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float ss = (float)s[0];
    *out = ss;
    if (thr >= 0.0f && ss <= thr) *done = 1;
  }
}

// One sweep, in the order of ops/ref.py::jacobi:
//   LINEAR     v + omega (alpha r),  r = f - av
//   NONLINEAR  ex = e^v; r = f - (av + (gamma v) ex);
//              v + omega (r / (pre_fac + (gamma (1 + v)) ex))
//   NEWTON     ex = e^nv; lin = (gamma (1 + nv)) ex; r = f - (av + lin v);
//              v + omega (r / (pre_fac + lin))
// Newton's lin * v is ordered otherwise than the Newton residual's term.
template <int M>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
jacobi_kernel(float* __restrict__ v_out, const float* __restrict__ v,
              const float* __restrict__ f, const float* __restrict__ nv,
              const int* __restrict__ done, Geom g, Taps taps, float inv_h2,
              float alpha, float omega, ModeArgs ma) {
  if (*done) return;
  const int k = blockIdx.x * kBZ + threadIdx.x + 1;
  const int j = blockIdx.y * kBY + threadIdx.y + 1;
  if (k > g.nz || j > g.ny) return;
  const int i0 = blockIdx.z * kXCH + 1;
  const int i1 = min(i0 + kXCH, g.nx + 1);
  long long idx = i0 * g.sx + j * g.sy + k;
  for (int i = i0; i < i1; ++i, idx += g.sx) {
    const float av = stencil_at(v, idx, taps, inv_h2);
    if constexpr (M == kLinear) {
      const float res = __fsub_rn(f[idx], av);
      v_out[idx] = __fadd_rn(v[idx], __fmul_rn(omega, __fmul_rn(alpha, res)));
    } else {
      const float vc = v[idx];
      float ex, term, lin;
      if constexpr (M == kNonlinear) {
        ex = expf(vc);
        term = fas_term(vc, ex, ma.gamma);
        lin = __fmul_rn(__fmul_rn(ma.gamma, __fadd_rn(1.0f, vc)), ex);
      } else {
        const float n = nv[idx];
        ex = expf(n);
        lin = __fmul_rn(__fmul_rn(ma.gamma, __fadd_rn(1.0f, n)), ex);
        term = __fmul_rn(lin, vc);
      }
      const float res = __fsub_rn(f[idx], __fadd_rn(av, term));
      const float denom = __fadd_rn(ma.pre_fac, lin);
      v_out[idx] = __fadd_rn(vc, __fmul_rn(omega, __fdiv_rn(res, denom)));
    }
  }
}

// Coarse point (ci, cj, ck) takes fine points (2ci+a, 2cj+b, 2ck+c),
// a, b, c in {-1, 0, 1}, with weight 0.125 * w(a) * w(b) * w(c),
// w(0) = 1, w(+-1) = 0.5, summed in (a, b, c) lexicographic order.
// kZero: out0 = R(in) and out1 = 0 (the LINEAR/Newton coarse start);
// else out0 = R(in) and, when out1 is given, out1 = R(in) as well (FAS
// R(v) into coarse v and rest_v in one pass).
template <bool kZero>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
restrict_kernel(float* __restrict__ out0, float* __restrict__ out1,
                const float* __restrict__ in, const int* __restrict__ done,
                Geom c, Geom fg) {
  if (*done) return;
  const int ck = blockIdx.x * kBZ + threadIdx.x + 1;
  const int cj = blockIdx.y * kBY + threadIdx.y + 1;
  if (ck > c.nz || cj > c.ny) return;
  const int i0 = blockIdx.z * kXCH + 1;
  const int i1 = min(i0 + kXCH, c.nx + 1);
  const float w1[3] = {0.5f, 1.0f, 0.5f};
  for (int ci = i0; ci < i1; ++ci) {
    const long long center = 2LL * ci * fg.sx + 2LL * cj * fg.sy + 2 * ck;
    float acc = 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b) {
#pragma unroll
        for (int cc = 0; cc < 3; ++cc) {
          const float w = 0.125f * w1[a] * w1[b] * w1[cc];
          const float term = __fmul_rn(
              w, __ldg(in + center + (a - 1) * fg.sx + (b - 1) * fg.sy +
                       (cc - 1)));
          acc = (a == 0 && b == 0 && cc == 0) ? term : __fadd_rn(acc, term);
        }
      }
    }
    const long long cidx = ci * c.sx + cj * c.sy + ck;
    out0[cidx] = acc;
    if constexpr (kZero) {
      out1[cidx] = 0.0f;
    } else {
      if (out1 != nullptr) out1[cidx] = acc;
    }
  }
}

__device__ __forceinline__ float mid(float a, float b) {
  return __fadd_rn(__fmul_rn(0.5f, a), __fmul_rn(0.5f, b));
}

// Fine point (i, j, k) gets the reference's 4-pass interpolation in closed
// form: along each axis an even index takes coarse index i/2 and an odd one
// the midpoint of (i-1)/2 and (i+1)/2; the x midpoints are taken first,
// then y, then z, as the passes do.  An odd index next to the upper halo
// reads the coarse halo, which is zero, as the passes' unwritten sites are.
// A thread owns coarse z column kc and writes fine z points 2kc and 2kc+1,
// which share column kc: half the coarse loads per fine point, and no
// branch on the parity of z (PERF.md, PR 2).  The parities of i and j are
// uniform across a warp.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
prolong_add_kernel(float* __restrict__ vf, const float* __restrict__ vc,
                   const int* __restrict__ done, Geom fg, Geom c) {
  if (*done) return;
  const int kc = blockIdx.x * kBZ + threadIdx.x;
  const int j = blockIdx.y * kBY + threadIdx.y + 1;
  if (kc > fg.nz / 2 || j > fg.ny) return;
  const int i0 = blockIdx.z * kXCH + 1;
  const int i1 = min(i0 + kXCH, fg.nx + 1);
  const int jc = j >> 1;
  const bool jo = j & 1;
  const bool even_ok = kc >= 1, odd_ok = 2 * kc + 1 <= fg.nz;
  long long idx = i0 * fg.sx + j * fg.sy + 2 * kc;
  for (int i = i0; i < i1; ++i, idx += fg.sx) {
    const bool io = i & 1;
    const float* col = vc + (i >> 1) * c.sx + jc * c.sy + kc;
    float yv[2];
#pragma unroll
    for (int dk = 0; dk < 2; ++dk) {
      // x midpoints at coarse rows jc and jc+1 (the second only when j is
      // odd), then the y midpoint.
      const float a = __ldg(col + dk);
      const float xa = io ? mid(a, __ldg(col + c.sx + dk)) : a;
      float yk = xa;
      if (jo) {
        const float b = __ldg(col + c.sy + dk);
        const float xb = io ? mid(b, __ldg(col + c.sx + c.sy + dk)) : b;
        yk = mid(xa, xb);
      }
      yv[dk] = yk;
    }
    if (even_ok) vf[idx] = __fadd_rn(vf[idx], yv[0]);
    if (odd_ok) vf[idx + 1] = __fadd_rn(vf[idx + 1], mid(yv[0], yv[1]));
  }
}

// v -= w over the interior, in place: the FAS coarse v - rest_v that the
// prolongation then reads (each point touches only itself).
__global__ void __launch_bounds__(kThreads, kMinBlocks)
subtract_kernel(float* v, const float* __restrict__ w,
                const int* __restrict__ done, Geom g) {
  if (*done) return;
  const int k = blockIdx.x * kBZ + threadIdx.x + 1;
  const int j = blockIdx.y * kBY + threadIdx.y + 1;
  if (k > g.nz || j > g.ny) return;
  const int i0 = blockIdx.z * kXCH + 1;
  const int i1 = min(i0 + kXCH, g.nx + 1);
  long long idx = i0 * g.sx + j * g.sy + k;
  for (int i = i0; i < i1; ++i, idx += g.sx) {
    v[idx] = __fsub_rn(v[idx], w[idx]);
  }
}

Taps make_taps(const float* val, const int* off3, int ntaps, const Geom& g) {
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

int mg_finalize(const double* partials, long long n, float* out, float thr,
                int* done, cudaStream_t stream) {
  finalize_kernel<<<1, kFinThreads, 0, stream>>>(partials, n, out, thr, done);
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
  // One thread per coarse z column 0..fnz/2 (see the kernel).
  const dim3 grid((fnz / 2 + kBZ) / kBZ, (fny + kBY - 1) / kBY,
                  (fnx + kXCH - 1) / kXCH);
  prolong_add_kernel<<<grid, dim3(kBZ, kBY), 0, stream>>>(
      vf, vc, done, fg, make_geom(cnx, cny, cnz));
  return (int)cudaGetLastError();
}

int mg_subtract(float* v, const float* w, const int* done, int nx, int ny,
                int nz, cudaStream_t stream) {
  const Geom g = make_geom(nx, ny, nz);
  subtract_kernel<<<grid_for(g), dim3(kBZ, kBY), 0, stream>>>(v, w, done, g);
  return (int)cudaGetLastError();
}

}  // extern "C"
