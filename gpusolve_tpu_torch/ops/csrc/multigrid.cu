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
// Array model (mg_device.cuh): a dense (nx+2, ny+2, nz+2) float32 array
// per level, z contiguous, with a zero halo that no kernel ever writes.
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

#include "mg_device.cuh"

namespace {

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

__global__ void __launch_bounds__(kFinThreads)
finalize_kernel(const double* __restrict__ partials, long long n,
                float* __restrict__ out, float thr, int* done) {
  if (*done) return;
  __shared__ double s[kFinThreads];
  const double total = finalize_sum(partials, n, s);
  if (threadIdx.x == 0) {
    const float ss = (float)total;
    *out = ss;
    if (thr >= 0.0f && ss <= thr) *done = 1;
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
  prolong_add_kernel<<<prolong_grid_for(fg), dim3(kBZ, kBY), 0, stream>>>(
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
