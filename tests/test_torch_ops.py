"""The port's plain ops (``ops/ref.py``) against the JAX package's
``ops/xla.py`` in all three modes, the kernel wrappers' CPU path, and one
interpret-mode case of the Pallas residual kernel.

Inputs are made with numpy from a seed; the JAX side gets them in its
(8, 8, 128)-rounded allocation, the port in its dense (n+2)³ one.
Tolerances: float64 agrees to rtol 1e-12; float32 to rtol 1e-5 with an
atol of 1e-5·max|want| (XLA's CPU code and PyTorch's round differently)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gpusolve_tpu.config import GridParams as JParams
from gpusolve_tpu.config import Stencil as JStencil
from gpusolve_tpu.grid import alloc_shape
from gpusolve_tpu.ops import pallas_kernels as pk
from gpusolve_tpu.ops import xla
from gpusolve_tpu_torch.config import GridParams, Mode, Stencil
from gpusolve_tpu_torch.ops import dispatch, kernels, ref

MODES = [Mode.LINEAR, Mode.NONLINEAR, Mode.NEWTON]
DTYPES = ["float32", "float64"]
DIMS = [(16, 16, 16), (31, 15, 63)]
TOL = {"float32": 1e-5, "float64": 1e-12}

# A non-symmetric stencil with a diagonal tap: the ops must honour the
# config's values and offsets, not assume the 7-point Laplacian.
SKEW = dict(
    values=(6.5, -1.25, -0.75, -1.0, -1.0, -0.5, -1.5),
    offsets=((0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 1),
             (0, 0, 1), (-1, -1, 0)),
)


def params_pair(mode, dims, dtype, skew=False):
    st = SKEW if skew else None
    kw = dict(
        maxiter=1, tol=1e-5, grid_dim=dims, mode=int(mode),
        pre_smoothing=3, post_smoothing=3, omega=0.8, gamma=1.0,
        dtype=dtype, print_progress=False,
    )
    pj = JParams(
        stencil=JStencil(**st) if st else JStencil.poisson_7pt(),
        backend="xla", **kw,
    )
    pt = GridParams(
        stencil=Stencil(**st) if st else Stencil.poisson_7pt(), **kw
    )
    return pj, pt


# One jit per op: much cheaper on the CPU than eager op-by-op dispatch.
J_RESIDUAL = jax.jit(xla.residual, static_argnums=(2, 3, 4))
J_JACOBI = jax.jit(xla.jacobi, static_argnums=(2, 3, 4, 5))
J_FAS = jax.jit(xla.apply_stencil_fas, static_argnums=(1, 2, 3))
J_RESTRICT = jax.jit(xla.restrict_full_weighting, static_argnums=(1, 2, 3))
J_INTERP = jax.jit(xla.interpolate, static_argnums=(1, 2, 3))


def rand_field(rng, dims, dtype, scale=1.0):
    a = np.zeros(tuple(d + 2 for d in dims), dtype)
    a[1:-1, 1:-1, 1:-1] = rng.standard_normal(dims) * scale
    return a


def to_jax(a, dims):
    full = np.zeros(alloc_shape(dims), a.dtype)
    full[: a.shape[0], : a.shape[1], : a.shape[2]] = a
    return jnp.asarray(full)


def crop(x, dims):
    return np.asarray(x)[: dims[0] + 2, : dims[1] + 2, : dims[2] + 2]


def assert_close(got, want, dtype):
    want = np.asarray(want)
    tol = TOL[dtype]
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=tol, atol=tol * scale
    )


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dims", DIMS)
def test_residual_jacobi_fas(dims, mode, dtype):
    rng = np.random.default_rng(1)
    pj, pt = params_pair(mode, dims, dtype, skew=dims == DIMS[1])
    h = pt.level_h(0)
    v = rand_field(rng, dims, dtype, 0.5)
    f = rand_field(rng, dims, dtype, 100.0)
    nv = rand_field(rng, dims, dtype, 0.3) if mode == Mode.NEWTON else None
    jv, jf = to_jax(v, dims), to_jax(f, dims)
    jnv = to_jax(nv, dims) if nv is not None else None
    tv, tf = torch.from_numpy(v), torch.from_numpy(f)
    tnv = torch.from_numpy(nv) if nv is not None else None

    want_r, want_ss = J_RESIDUAL(jv, jf, dims, pj, h, jnv)
    got_r, got_ss = ref.residual(tv, tf, dims, pt, h, newton_v=tnv)
    assert_close(got_r, crop(want_r, dims), dtype)
    assert float(got_ss) == pytest.approx(float(want_ss), rel=TOL[dtype])

    want_v = J_JACOBI(jv, jf, dims, pj, h, 2, jnv)
    got_v = ref.jacobi(tv, tf, dims, pt, h, 2, newton_v=tnv)
    assert_close(got_v, crop(want_v, dims), dtype)

    if mode == Mode.NONLINEAR:
        want_a = J_FAS(jv, dims, pj, h)
        got_a = ref.apply_stencil_fas(tv, dims, pt, h)
        assert_close(got_a, crop(want_a, dims), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dims", DIMS)
def test_transfers(dims, dtype):
    rng = np.random.default_rng(2)
    cdims = tuple(d // 2 for d in dims)
    fine = rand_field(rng, dims, dtype)
    coarse = rand_field(rng, cdims, dtype)
    cshape = tuple(d + 2 for d in cdims)
    fshape = tuple(d + 2 for d in dims)

    want = J_RESTRICT(
        to_jax(fine, dims), dims, cdims, alloc_shape(cdims)
    )
    got = ref.restrict_full_weighting(
        torch.from_numpy(fine), dims, cdims, cshape
    )
    assert_close(got, crop(want, cdims), dtype)

    want_e = J_INTERP(
        to_jax(coarse, cdims), cdims, dims, alloc_shape(dims)
    )
    got_e = ref.interpolate(torch.from_numpy(coarse), cdims, dims, fshape)
    assert_close(got_e, crop(want_e, dims), dtype)
    got_p = ref.prolong_add(
        torch.from_numpy(fine), torch.from_numpy(coarse), cdims, dims
    )
    assert_close(got_p, fine + crop(want_e, dims), dtype)


def test_residual_matches_pallas_interpret():
    """The port's residual against the Pallas kernel _residual_call run in
    interpret mode, as tests/test_pallas.py runs it."""
    rng = np.random.default_rng(3)
    dims = (15, 15, 15)
    pj, pt = params_pair(Mode.LINEAR, dims, "float32")
    h = pt.level_h(0)
    v = rand_field(rng, dims, np.float32)
    f = rand_field(rng, dims, np.float32)
    dead = to_jax(rand_field(rng, dims, np.float32, 9.0), dims)
    want_r, want_ss = pk.residual(
        dead, to_jax(v, dims), to_jax(f, dims), dims, pj, h,
        with_norm=True, interpret=True,
    )
    r = torch.zeros_like(torch.from_numpy(v))
    ss = torch.empty(1)
    dispatch.residual_op(
        r, torch.from_numpy(v), torch.from_numpy(f), dims, pt, h,
        norm_out=ss,
    )
    want_r = crop(want_r, dims)
    np.testing.assert_allclose(
        r.numpy(), want_r, rtol=2e-5, atol=2e-6 * np.abs(want_r).max()
    )
    assert float(ss[0]) == pytest.approx(float(want_ss), rel=1e-5)


@pytest.mark.parametrize("dims", [(16, 16, 16), (31, 15, 63)])
def test_wrappers_cpu_path_in_place(dims):
    """On CPU tensors every kernel wrapper runs its plain version with the
    kernel's contract: outputs in place, interiors only, ``done`` obeyed."""
    rng = np.random.default_rng(4)
    _, pt = params_pair(Mode.LINEAR, dims, "float32", skew=True)
    h = pt.level_h(0)
    cdims = tuple(d // 2 for d in dims)
    v = torch.from_numpy(rand_field(rng, dims, np.float32))
    f = torch.from_numpy(rand_field(rng, dims, np.float32, 50.0))
    out = torch.zeros_like(v)
    kernels.jacobi_sweep(out, v, f, dims, pt, h)
    assert torch.equal(out, ref.jacobi(v, f, dims, pt, h, 1))

    r = torch.zeros_like(v)
    parts = kernels.residual(r, v, f, dims, pt, h, with_norm=True)
    want_r, want_ss = ref.residual(v, f, dims, pt, h)
    assert torch.equal(r, want_r) and parts.dtype == torch.float64
    norms = torch.full((3,), -1.0)
    done = torch.zeros(1, dtype=torch.int32)
    kernels.finalize(parts, norms[1:2], float(want_ss) * 2, done)
    assert float(norms[1]) == pytest.approx(float(want_ss), rel=1e-6)
    assert norms[0] == -1 and norms[2] == -1 and int(done[0]) == 1

    # With done set, nothing is written.
    before = [t.clone() for t in (out, r, norms)]
    kernels.jacobi_sweep(out, f, v, dims, pt, h, done)
    kernels.residual(r, f, v, dims, pt, h, done=done)
    kernels.finalize(parts, norms[2:3], -1.0, done)
    for a, b in zip(before, (out, r, norms)):
        assert torch.equal(a, b)

    fc = torch.from_numpy(rand_field(rng, cdims, np.float32))  # stale
    vc = fc.clone()
    kernels.restrict_zero(fc, vc, r, dims, cdims)
    assert torch.equal(
        fc, ref.restrict_full_weighting(r, dims, cdims, fc.shape)
    )
    assert not vc.any()
    vc = torch.from_numpy(rand_field(rng, cdims, np.float32))
    v2 = v.clone()
    kernels.prolong_add(v2, vc, dims, cdims)
    assert torch.equal(v2, ref.prolong_add(v, vc, cdims, dims))
    assert all(n == 0 for n in kernels.launches.values())


def test_dispatch_backend_rules():
    """auto and ref run the plain ops on CPU tensors; cuda raises."""
    dims = (15, 15, 15)
    _, pt = params_pair(Mode.LINEAR, dims, "float32")
    rng = np.random.default_rng(5)
    v = torch.from_numpy(rand_field(rng, dims, np.float32))
    f = torch.from_numpy(rand_field(rng, dims, np.float32))
    want = ref.jacobi(v, f, dims, pt, pt.h, 2)
    for backend in ("auto", "ref"):
        got, spare = dispatch.smooth(
            v.clone(), f, torch.zeros_like(v), dims,
            pt.replace(backend=backend), pt.h, 2,
        )
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        dispatch.smooth(
            v, f, torch.zeros_like(v), dims, pt.replace(backend="cuda"),
            pt.h, 1,
        )


def test_kernel_wrappers_reject_non_linear():
    """The wrappers took LINEAR only before FAS and Newton were ported; a
    NEWTON sweep or residual now needs ũ: without newton_v the wrapper
    raises, with it the wrapper runs the Newton op."""
    dims = (15, 15, 15)
    _, pt = params_pair(Mode.NEWTON, dims, "float32")
    rng = np.random.default_rng(6)
    v, f = (torch.from_numpy(rand_field(rng, dims, np.float32, s))
            for s in (0.5, 50.0))
    nv = torch.from_numpy(rand_field(rng, dims, np.float32, 0.3))
    out = torch.zeros_like(v)
    with pytest.raises(ValueError, match="newton_v"):
        kernels.jacobi_sweep(out, v, f, dims, pt, 0.1)
    with pytest.raises(ValueError, match="newton_v"):
        kernels.residual(out, v, f, dims, pt, 0.1)
    kernels.jacobi_sweep(out, v, f, dims, pt, 0.1, newton_v=nv)
    assert torch.equal(out, ref.jacobi(v, f, dims, pt, 0.1, 1, newton_v=nv))
