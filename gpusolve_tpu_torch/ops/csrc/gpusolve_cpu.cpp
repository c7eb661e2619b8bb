// gpusolve_cpu — native CPU backend of the gpusolve_tpu framework.
//
// Role parity: the reference ships a CPU/OpenMP solver target
// (GpuSolve-cpu; numerics in src/cpu/CpuSolver.cpp, src/cpu/NewtonSolver.cpp,
// grid setup src/cpu/CpuGridData.cpp).  This is a fresh C++17 implementation
// of the same numerics with a C ABI so the Python framework loads it via
// ctypes — it serves as a fast host-side backend (`--backend cpu-native`)
// and as a second, independent implementation for cross-checking.
//
// Implementation style is deliberately its own: a single translation unit,
// flat C-style entry points, pointer-walking inner loops over contiguous z
// runs (auto-vectorizable), and a caller-owned workspace — not a translation
// of the reference's class structure.
//
// Build:  g++ -O3 -march=native -fopenmp -std=c++17 -shared -fPIC \
//             gpusolve_cpu.cpp -o libgpusolve_cpu.so

#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

constexpr int kModeLinear = 0;
constexpr int kModeNonlinear = 1;
constexpr int kModeNewton = 2;

struct Config {
    std::int64_t maxiter;
    double tol;
    std::int64_t dim[3];
    int mode;
    std::int64_t pre_smooth;
    std::int64_t post_smooth;
    double omega;
    double gamma;
    double stencil_values[7];
    std::int64_t stencil_off[7][3];  // (x, y, z) per tap
};

// One multigrid level: padded (n+2)^3 fields, z contiguous.
struct Level {
    std::int64_t n[3];   // interior dims
    std::int64_t s[3];   // padded strides: s[0] = plane, s[1] = row, s[2] = 1
    double h;
    std::vector<double> v, f, r, rest_v, newton_v;

    std::int64_t padded() const {
        return (n[0] + 2) * (n[1] + 2) * (n[2] + 2);
    }
    std::int64_t at(std::int64_t x, std::int64_t y, std::int64_t z) const {
        return x * s[0] + y * s[1] + z;
    }
};

struct Hierarchy {
    Config cfg;
    std::vector<Level> levels;
    std::vector<double> newton_f;
};

void build_levels(Hierarchy& H) {
    const auto& d = H.cfg.dim;
    std::int64_t mind = std::min(std::min(d[0], d[1]), d[2]);
    int nlev = (int)std::floor(std::log((double)mind) / std::log(2.0)) + 1;
    H.levels.resize(nlev);
    for (int l = 0; l < nlev; ++l) {
        Level& L = H.levels[l];
        for (int a = 0; a < 3; ++a)
            L.n[a] = l == 0 ? d[a] : H.levels[l - 1].n[a] / 2;
        L.s[2] = 1;
        L.s[1] = L.n[2] + 2;
        L.s[0] = (L.n[1] + 2) * (L.n[2] + 2);
        L.h = 1.0 / (double)(L.n[1] + 1);
        L.v.assign(L.padded(), 0.0);
        L.f.assign(L.padded(), 0.0);
        L.r.assign(L.padded(), 0.0);
        L.rest_v.assign(L.padded(), 0.0);
        L.newton_v.assign(L.padded(), 0.0);
    }
}

// Analytic RHS fills — device convention (interior only, zero boundary),
// matching gpusolve_tpu.grid.{linear_rhs,nonlinear_rhs}.
void fill_rhs(Hierarchy& H) {
    Level& L = H.levels[0];
    const double h = 1.0 / (double)(H.cfg.dim[1] + 1);
    auto f0 = [](double t) {
        double q = t * (t - 1.0);
        return 100.0 * q * q * q * q;
    };
    auto f2 = [](double t) {
        return 100.0 * 4.0 * (t - 1.0) * (t - 1.0) * t * t *
               (14.0 * t * t - 14.0 * t + 3.0);
    };
#pragma omp parallel for collapse(2)
    for (std::int64_t x = 1; x <= L.n[0]; ++x) {
        for (std::int64_t y = 1; y <= L.n[1]; ++y) {
            double* row = &L.f[L.at(x, y, 1)];
            for (std::int64_t z = 1; z <= L.n[2]; ++z) {
                double val;
                if (H.cfg.mode == kModeLinear) {
                    double px = (double)(x - 1) * h;
                    double py = (double)(y - 1) * h;
                    double pz = (double)(z - 1) * h;
                    val = -(f2(px) * f0(py) * f0(pz) +
                            f0(px) * f2(py) * f0(pz) +
                            f0(px) * f0(py) * f2(pz));
                } else {
                    double px = (double)x * h, py = (double)y * h,
                           pz = (double)z * h;
                    double gx = px - px * px, gy = py - py * py,
                           gz = pz - pz * pz;
                    double prod = gx * gy * gz;
                    val = 2.0 * (gy * gz + gx * gz + gx * gy) +
                          H.cfg.gamma * prod * std::exp(prod);
                }
                row[z - 1] = val;
            }
        }
    }
}

// Residual r = f - (A·v/h² + mode term); returns Σ r² over the interior.
// Reference math: src/cpu/CpuSolver.cpp:45-83.
double residual_pass(Hierarchy& H, Level& L, bool write_r) {
    const Config& C = H.cfg;
    const double inv_h2 = 1.0 / (L.h * L.h);
    double sumsq = 0.0;
#pragma omp parallel for collapse(2) reduction(+ : sumsq)
    for (std::int64_t x = 1; x <= L.n[0]; ++x) {
        for (std::int64_t y = 1; y <= L.n[1]; ++y) {
            const double* fp = &L.f[L.at(x, y, 0)];
            const double* vc = &L.v[L.at(x, y, 0)];
            const double* nv = &L.newton_v[L.at(x, y, 0)];
            double* rp = &L.r[L.at(x, y, 0)];
            // Precompute tap base pointers once per row.
            const double* tap[7];
            for (int t = 0; t < 7; ++t)
                tap[t] = &L.v[L.at(x + C.stencil_off[t][0],
                                   y + C.stencil_off[t][1],
                                   C.stencil_off[t][2])];
            for (std::int64_t z = 1; z <= L.n[2]; ++z) {
                double acc = 0.0;
                for (int t = 0; t < 7; ++t)
                    acc += C.stencil_values[t] * tap[t][z];
                acc *= inv_h2;
                if (C.mode == kModeNewton) {
                    double ex = std::exp(nv[z]);
                    acc += C.gamma * (1.0 + nv[z]) * vc[z] * ex;
                } else if (C.mode == kModeNonlinear) {
                    acc += C.gamma * vc[z] * std::exp(vc[z]);
                }
                double rr = fp[z] - acc;
                if (write_r) rp[z] = rr;
                sumsq += rr * rr;
            }
        }
    }
    return sumsq;
}

// Damped Jacobi sweeps — single fused pass per sweep writing a ping-pong
// buffer (bit-identical to the reference's two-pass residual-then-update
// structure, src/cpu/CpuSolver.cpp:141-179: Jacobi reads only OLD v, and
// the per-point expression/rounding order is unchanged; the fusion halves
// the smoother's memory traffic, which dominates the CPU backend).  The
// residual scratch r serves as the ping buffer; its value is dead here
// (every consumer recomputes r after smoothing), and for odd sweep counts
// the result lands in r and the two vectors swap in O(1).
void jacobi_pingpong(Hierarchy& H, Level& L, std::int64_t sweeps) {
    const Config& C = H.cfg;
    const double inv_h2 = 1.0 / (L.h * L.h);
    const double pre_fac = C.stencil_values[0] / (L.h * L.h);
    const double alpha = (L.h * L.h) / C.stencil_values[0];
    for (std::int64_t it = 0; it < sweeps; ++it) {
        const std::vector<double>& src = (it % 2 == 0) ? L.v : L.r;
        std::vector<double>& dst = (it % 2 == 0) ? L.r : L.v;
#pragma omp parallel for collapse(2)
        for (std::int64_t x = 1; x <= L.n[0]; ++x) {
            for (std::int64_t y = 1; y <= L.n[1]; ++y) {
                const double* fp = &L.f[L.at(x, y, 0)];
                const double* vc = &src[L.at(x, y, 0)];
                const double* nv = &L.newton_v[L.at(x, y, 0)];
                double* out = &dst[L.at(x, y, 0)];
                const double* tap[7];
                for (int t = 0; t < 7; ++t)
                    tap[t] = &src[L.at(x + C.stencil_off[t][0],
                                       y + C.stencil_off[t][1],
                                       C.stencil_off[t][2])];
                for (std::int64_t z = 1; z <= L.n[2]; ++z) {
                    double acc = 0.0;
                    for (int t = 0; t < 7; ++t)
                        acc += C.stencil_values[t] * tap[t][z];
                    acc *= inv_h2;
                    if (C.mode == kModeNewton) {
                        double ex = std::exp(nv[z]);
                        acc += C.gamma * (1.0 + nv[z]) * vc[z] * ex;
                    } else if (C.mode == kModeNonlinear) {
                        acc += C.gamma * vc[z] * std::exp(vc[z]);
                    }
                    double rr = fp[z] - acc;
                    if (C.mode == kModeLinear) {
                        out[z] = vc[z] + C.omega * (alpha * rr);
                    } else {
                        double lin_pt =
                            C.mode == kModeNewton ? nv[z] : vc[z];
                        double ex = std::exp(lin_pt);
                        double denom =
                            pre_fac + C.gamma * (1.0 + lin_pt) * ex;
                        out[z] = vc[z] + C.omega * (rr / denom);
                    }
                }
            }
        }
    }
    if (sweeps % 2 != 0) std::swap(L.v, L.r);
}

// Temporal (trapezoid) blocking of the Jacobi sweeps: ALL S sweeps of a
// smoothing leg in ONE streaming pass — the host-side counterpart of the
// TPU backend's communication-avoiding trapezoid kernel
// (gpusolve_tpu/ops/pallas_spmd.multi_sweep_block).  Memory traffic per leg
// drops from S·(read v,f + write v) to ~1·(read v,f + write v): sweep s's
// planes live in small per-tile ring strips that stay cache-resident.
//
// Bit-identical to jacobi_pingpong: Jacobi reads only the previous sweep's
// values, the per-point expression/rounding order is byte-for-byte the same
// loop body, and tile-boundary ghost generations are *recomputed* (the same
// arithmetic on the same inputs), never approximated.
//
// Geometry: tiles over (x, y); sweep s (1-based) is computed on the tile
// grown by (S−s) cells in x and y (clamped to the interior) so the final
// sweep exactly covers the tile.  Ring strips hold 3 x-planes per
// intermediate sweep, each (tile_y + 2S + 2) rows tall with permanent-zero
// z/y halo rows; x-planes outside the interior read a shared zero strip —
// identical to the padded arrays' zero Dirichlet halo.
void jacobi_fused(Hierarchy& H, Level& L, std::int64_t S) {
    const Config& C = H.cfg;
    const double inv_h2 = 1.0 / (L.h * L.h);
    const double pre_fac = C.stencil_values[0] / (L.h * L.h);
    const double alpha = (L.h * L.h) / C.stencil_values[0];
    const std::int64_t nx = L.n[0], ny = L.n[1], nz = L.n[2];
    const std::int64_t zrow = nz + 2;

    // Strip height sized so one strip is ~STRIP_KB (working set: 3(S-1)
    // ring strips + the streaming v/f windows must stay cache-resident).
    static const std::int64_t strip_kb = [] {
        const char* e = std::getenv("GPUSOLVE_CPU_STRIP_KB");
        return e ? std::atoll(e) : 32;
    }();
    std::int64_t hmax =
        std::max<std::int64_t>(2 * S + 3, strip_kb * 128 / zrow);
    std::int64_t yb =
        std::min<std::int64_t>(ny, std::max<std::int64_t>(4, hmax - 2 * S - 2));
    std::int64_t nyb = (ny + yb - 1) / yb;
#if defined(_OPENMP)
    int nth = omp_get_max_threads();
#else
    int nth = 1;
#endif
    std::int64_t xb = std::max<std::int64_t>(
        4 * S, (nx + (std::int64_t)nth - 1) / (std::int64_t)nth);
    std::int64_t nxb = (nx + xb - 1) / xb;
    const std::int64_t ntiles = nxb * nyb;

#pragma omp parallel
    {
        std::vector<double> ring;
        std::vector<double> zstrip;
#pragma omp for schedule(dynamic)
        for (std::int64_t tile = 0; tile < ntiles; ++tile) {
            const std::int64_t bx0 = 1 + (tile / nyb) * xb;
            const std::int64_t bx1 = std::min(nx + 1, bx0 + xb);
            const std::int64_t by0 = 1 + (tile % nyb) * yb;
            const std::int64_t by1 = std::min(ny + 1, by0 + yb);
            const std::int64_t ybase = by0 - S - 1;
            const std::int64_t hs = (by1 - by0) + 2 * S + 2;
            const std::int64_t strip_sz = hs * zrow;
            ring.assign((std::size_t)((S - 1) * 3 * strip_sz), 0.0);
            zstrip.assign((std::size_t)strip_sz, 0.0);

            auto strip = [&](std::int64_t s, std::int64_t x) {
                return &ring[(std::size_t)(((s - 1) * 3 + (x % 3 + 3) % 3) *
                                           strip_sz)];
            };
            auto plane_of = [&](std::int64_t s,
                                std::int64_t x) -> const double* {
                if (x < 1 || x > nx) return zstrip.data();
                return strip(s, x);
            };
            auto xrange = [&](std::int64_t s) {
                const std::int64_t g = S - s;
                return std::pair<std::int64_t, std::int64_t>(
                    std::max<std::int64_t>(1, bx0 - g),
                    std::min<std::int64_t>(nx, bx1 - 1 + g));
            };
            auto yrange = [&](std::int64_t s) {
                const std::int64_t g = S - s;
                return std::pair<std::int64_t, std::int64_t>(
                    std::max<std::int64_t>(1, by0 - g),
                    std::min<std::int64_t>(ny, by1 - 1 + g));
            };

            auto compute = [&](std::int64_t s, std::int64_t xs) {
                const auto yr = yrange(s);
                for (std::int64_t y = yr.first; y <= yr.second; ++y) {
                    const double* fp = &L.f[L.at(xs, y, 0)];
                    const double* nv = &L.newton_v[L.at(xs, y, 0)];
                    const double* tap[7];
                    const double* vc;
                    if (s == 1) {
                        for (int t = 0; t < 7; ++t)
                            tap[t] = &L.v[L.at(xs + C.stencil_off[t][0],
                                               y + C.stencil_off[t][1],
                                               C.stencil_off[t][2])];
                        vc = &L.v[L.at(xs, y, 0)];
                    } else {
                        for (int t = 0; t < 7; ++t)
                            tap[t] = plane_of(s - 1,
                                              xs + C.stencil_off[t][0]) +
                                     (y + C.stencil_off[t][1] - ybase) *
                                         zrow +
                                     C.stencil_off[t][2];
                        vc = plane_of(s - 1, xs) + (y - ybase) * zrow;
                    }
                    double* out = s == S ? &L.r[L.at(xs, y, 0)]
                                         : strip(s, xs) + (y - ybase) * zrow;
                    for (std::int64_t z = 1; z <= nz; ++z) {
                        double acc = 0.0;
                        for (int t = 0; t < 7; ++t)
                            acc += C.stencil_values[t] * tap[t][z];
                        acc *= inv_h2;
                        if (C.mode == kModeNewton) {
                            double ex = std::exp(nv[z]);
                            acc += C.gamma * (1.0 + nv[z]) * vc[z] * ex;
                        } else if (C.mode == kModeNonlinear) {
                            acc += C.gamma * vc[z] * std::exp(vc[z]);
                        }
                        double rr = fp[z] - acc;
                        if (C.mode == kModeLinear) {
                            out[z] = vc[z] + C.omega * (alpha * rr);
                        } else {
                            double lin_pt =
                                C.mode == kModeNewton ? nv[z] : vc[z];
                            double ex = std::exp(lin_pt);
                            double denom =
                                pre_fac + C.gamma * (1.0 + lin_pt) * ex;
                            out[z] = vc[z] + C.omega * (rr / denom);
                        }
                    }
                }
            };

            const auto x1r = xrange(1);
            for (std::int64_t x = x1r.first; x <= x1r.second + S - 1; ++x) {
                for (std::int64_t s = 1; s <= S; ++s) {
                    const std::int64_t xs = x - (s - 1);
                    const auto xr = xrange(s);
                    if (xs >= xr.first && xs <= xr.second) compute(s, xs);
                }
            }
        }
    }
    // The final sweep landed in the scratch buffer; swap it in (values are
    // identical to the ping-pong path's, only the buffer identity differs).
    std::swap(L.v, L.r);
}

bool fuse_disabled() {
    static const bool off = std::getenv("GPUSOLVE_CPU_NO_FUSE") != nullptr;
    return off;
}

void jacobi(Hierarchy& H, Level& L, std::int64_t sweeps) {
    // The fused pass pays ghost recompute 2(S-1) planes/rows per tile edge;
    // profitable for multi-sweep legs on levels with enough extent.
    // GPUSOLVE_CPU_NO_FUSE=1 forces the ping-pong path (bit-identity is
    // asserted by tests/test_cpu_native.py).
    if (!fuse_disabled() && sweeps >= 2 && sweeps <= 6 &&
        L.n[0] >= 4 * sweeps && L.n[1] >= 4 && L.n[2] >= 16) {
        jacobi_fused(H, L, sweeps);
    } else {
        jacobi_pingpong(H, L, sweeps);
    }
}

// FAS tau correction: f += A(v)/h² + γ v e^v over the interior — the
// operator application (reference: src/cpu/CpuSolver.cpp:182-209) fused
// with the `f += r` consumer (src/cpu/CpuSolver.cpp:110-112); identical
// rounding (the materialised r was exact) with no r round-trip.
void apply_stencil_fas_add(Hierarchy& H, Level& L,
                           const std::vector<double>& v) {
    const Config& C = H.cfg;
    const double inv_h2 = 1.0 / (L.h * L.h);
#pragma omp parallel for collapse(2)
    for (std::int64_t x = 1; x <= L.n[0]; ++x) {
        for (std::int64_t y = 1; y <= L.n[1]; ++y) {
            const double* tap[7];
            for (int t = 0; t < 7; ++t)
                tap[t] = &v[L.at(x + C.stencil_off[t][0],
                                 y + C.stencil_off[t][1],
                                 C.stencil_off[t][2])];
            const double* vc = &v[L.at(x, y, 0)];
            double* fp = &L.f[L.at(x, y, 0)];
            for (std::int64_t z = 1; z <= L.n[2]; ++z) {
                double acc = 0.0;
                for (int t = 0; t < 7; ++t)
                    acc += C.stencil_values[t] * tap[t][z];
                fp[z] += acc * inv_h2 + C.gamma * vc[z] * std::exp(vc[z]);
            }
        }
    }
}

// 27-point full-weighting restriction fine -> coarse interior
// (reference: src/cpu/CpuSolver.cpp:211-238).
void restrict_fw(const Level& LF, const std::vector<double>& fine,
                 const Level& LC, std::vector<double>& coarse) {
#pragma omp parallel for collapse(2)
    for (std::int64_t x = 1; x <= LC.n[0]; ++x) {
        for (std::int64_t y = 1; y <= LC.n[1]; ++y) {
            double* out = &coarse[LC.at(x, y, 0)];
            for (std::int64_t z = 1; z <= LC.n[2]; ++z) {
                double acc = 0.0;
                for (int dx = -1; dx <= 1; ++dx) {
                    double wx = dx == 0 ? 0.5 : 0.25;
                    for (int dy = -1; dy <= 1; ++dy) {
                        double wy = dy == 0 ? 0.5 : 0.25;
                        const double* frow =
                            &fine[LF.at(2 * x + dx, 2 * y + dy, 2 * z)];
                        acc += wx * wy *
                               (0.25 * frow[-1] + 0.5 * frow[0] +
                                0.25 * frow[1]);
                    }
                }
                out[z] = acc;
            }
        }
    }
}

// Trilinear prolongation of LC.v added directly onto LF.v — the unified
// per-axis formula e[p] = 0.5·(R[p+1] + R[p+2]) with
// R = element-repeat(coarse, 2), which equals the reference's 4-pass scheme
// (src/cpu/CpuSolver.cpp:240-290) with zero Dirichlet halos; fused with the
// `v += e` consumer (src/cpu/CpuSolver.cpp:130-132), eliminating the
// materialised correction field entirely (one read + one write of fine v
// instead of write e, read v+e, write v).  Bit-identical: the stored e was
// the exact value added, and e is zero outside the interior (every tap
// resolves to the zero coarse halo there), so interior-only adds suffice.
// Expressed directly: fine padded index m even -> coarse[m/2]; m odd ->
// (coarse[(m-1)/2] + coarse[(m+1)/2]) / 2.
void prolongate_add(const Level& LC, Level& LF) {
#pragma omp parallel for
    for (std::int64_t x = 1; x <= LF.n[0]; ++x) {
        const bool xe = (x % 2) == 0;
        for (std::int64_t y = 1; y <= LF.n[1]; ++y) {
            const bool ye = (y % 2) == 0;
            double* vrow = &LF.v[LF.at(x, y, 0)];
            for (std::int64_t z = 1; z <= LF.n[2]; ++z) {
                const bool ze = (z % 2) == 0;
                double acc = 0.0;
                for (int dx = xe ? 0 : -1; dx <= (xe ? 0 : 1); dx += 2)
                    for (int dy = ye ? 0 : -1; dy <= (ye ? 0 : 1); dy += 2)
                        for (int dz = ze ? 0 : -1; dz <= (ze ? 0 : 1);
                             dz += 2)
                            acc += LC.v[LC.at((x + dx) / 2, (y + dy) / 2,
                                              (z + dz) / 2)];
                double w = 1.0;
                if (!xe) w *= 0.5;
                if (!ye) w *= 0.5;
                if (!ze) w *= 0.5;
                vrow[z] += acc * w;
            }
        }
    }
}

double vcycle(Hierarchy& H) {
    const Config& C = H.cfg;
    int nlev = (int)H.levels.size();
    bool fas = C.mode == kModeNonlinear;
    for (int l = 0; l < nlev - 1; ++l) {
        Level& L = H.levels[l];
        Level& N = H.levels[l + 1];
        jacobi(H, L, C.pre_smooth);
        residual_pass(H, L, true);
        restrict_fw(L, L.r, N, N.f);
        if (!fas) {
            std::fill(N.v.begin(), N.v.end(), 0.0);
        } else {
            restrict_fw(L, L.v, N, N.rest_v);
            N.v = N.rest_v;
            apply_stencil_fas_add(H, N, N.rest_v);
        }
    }
    jacobi(H, H.levels[nlev - 1], C.pre_smooth + C.post_smooth);
    for (int l = nlev - 1; l > 0; --l) {
        Level& L = H.levels[l];
        Level& P = H.levels[l - 1];
        if (fas) {
            const std::int64_t np = L.padded();
#pragma omp parallel for
            for (std::int64_t i = 0; i < np; ++i) L.v[i] -= L.rest_v[i];
        }
        prolongate_add(L, P);
        jacobi(H, P, C.post_smooth);
    }
    // The final residual's field is dead (the next consumer of r is the
    // smoother's ping buffer, written before read) — norm only.
    return std::sqrt(residual_pass(H, H.levels[0], false));
}

// Linear/FAS solve loop (reference: src/cpu/CpuSolver.cpp:12-43).
// history must hold maxiter+1 doubles; cycle_ms (nullable) receives the
// measured wall ms per executed cycle (maxiter doubles) — the counterpart of
// the reference's per-cycle Timer::start/stop (src/Timer.cpp:7-27).
// Returns the cycle count executed.
std::int64_t solve_loop(Hierarchy& H, double* history,
                        double* cycle_ms = nullptr) {
    double initial = std::sqrt(residual_pass(H, H.levels[0], true));
    history[0] = initial;
    std::int64_t i = 0;
    for (; i < H.cfg.maxiter; ++i) {
        auto t0 = std::chrono::steady_clock::now();
        double res = vcycle(H);
        if (cycle_ms) {
            std::chrono::duration<double, std::milli> dt =
                std::chrono::steady_clock::now() - t0;
            cycle_ms[i] = dt.count();
        }
        history[i + 1] = res;
        if (res <= initial / (1.0 / H.cfg.tol)) {
            ++i;
            break;
        }
    }
    return i;
}

// Newton residual F = newton_f − (A·ũ + γ ũ e^ũ) into level-0 f; returns ‖F‖
// (reference: src/cpu/NewtonSolver.cpp:48-81).
double comp_f(Hierarchy& H) {
    Level& L = H.levels[0];
    const Config& C = H.cfg;
    const double inv_h2 = 1.0 / (L.h * L.h);
    double sumsq = 0.0;
#pragma omp parallel for collapse(2) reduction(+ : sumsq)
    for (std::int64_t x = 1; x <= L.n[0]; ++x) {
        for (std::int64_t y = 1; y <= L.n[1]; ++y) {
            const double* tap[7];
            for (int t = 0; t < 7; ++t)
                tap[t] = &L.newton_v[L.at(x + C.stencil_off[t][0],
                                          y + C.stencil_off[t][1],
                                          C.stencil_off[t][2])];
            const double* nv = &L.newton_v[L.at(x, y, 0)];
            const double* nf = &H.newton_f[L.at(x, y, 0)];
            double* fp = &L.f[L.at(x, y, 0)];
            for (std::int64_t z = 1; z <= L.n[2]; ++z) {
                double acc = 0.0;
                for (int t = 0; t < 7; ++t)
                    acc += C.stencil_values[t] * tap[t][z];
                acc = acc * inv_h2 +
                      C.gamma * nv[z] * std::exp(nv[z]);
                double F = nf[z] - acc;
                fp[z] = F;
                sumsq += F * F;
            }
        }
    }
    return std::sqrt(sumsq);
}

// Outer Newton loop (reference: src/cpu/NewtonSolver.cpp:10-44,83-108).
std::int64_t newton_loop(Hierarchy& H, double* history,
                         double* cycle_ms = nullptr) {
    H.newton_f = H.levels[0].f;
    double initial = comp_f(H);
    history[0] = initial;
    std::int64_t i = 0;
    for (; i < H.cfg.maxiter; ++i) {
        auto t0 = std::chrono::steady_clock::now();
        comp_f(H);
        std::fill(H.levels[0].v.begin(), H.levels[0].v.end(), 0.0);
        // findError: restrict ũ to levels 1..L-2 (never the coarsest).
        for (std::size_t l = 1; l + 1 < H.levels.size(); ++l)
            restrict_fw(H.levels[l - 1], H.levels[l - 1].newton_v,
                        H.levels[l], H.levels[l].newton_v);
        Config saved = H.cfg;
        H.cfg.maxiter = 10;
        H.cfg.tol = 0.1;
        std::vector<double> inner_hist(12);
        solve_loop(H, inner_hist.data());
        H.cfg = saved;
        Level& L0 = H.levels[0];
        for (std::int64_t k = 0; k < L0.padded(); ++k)
            L0.newton_v[k] += L0.v[k];
        double res = comp_f(H);
        if (cycle_ms) {
            std::chrono::duration<double, std::milli> dt =
                std::chrono::steady_clock::now() - t0;
            cycle_ms[i] = dt.count();
        }
        history[i + 1] = res;
        if (res <= initial / (1.0 / H.cfg.tol)) {
            ++i;
            break;
        }
    }
    return i;
}

}  // namespace

extern "C" {

// Solve the configured problem.  out_solution receives the padded
// (n+2)^3 finest-level solution (v, or newton_v in mode 2); out_history
// receives maxiter+1 residuals (entry 0 = initial); out_cycle_ms (nullable)
// receives per-iteration wall-clock ms (maxiter doubles).  Returns the
// number of iterations executed, or -1 on error.
std::int64_t gpusolve_cpu_solve(const Config* cfg, double* out_solution,
                                double* out_history,
                                double* out_cycle_ms) {
    if (!cfg || !out_solution || !out_history) return -1;
    if (cfg->mode < 0 || cfg->mode > 2) return -1;
    Hierarchy H;
    H.cfg = *cfg;
    build_levels(H);
    fill_rhs(H);
    std::int64_t iters =
        cfg->mode == kModeNewton
            ? newton_loop(H, out_history, out_cycle_ms)
            : solve_loop(H, out_history, out_cycle_ms);
    const Level& L0 = H.levels[0];
    const std::vector<double>& sol =
        cfg->mode == kModeNewton ? L0.newton_v : L0.v;
    std::memcpy(out_solution, sol.data(), sizeof(double) * L0.padded());
    return iters;
}

int gpusolve_cpu_num_threads() {
#if defined(_OPENMP)
    return omp_get_max_threads();
#else
    return 1;
#endif
}

}  // extern "C"
