"""The port's NONLINEAR (FAS) mode against the JAX package on the CPU: the
kernel wrappers' CPU path in FAS and Newton against the JAX package's
dispatch ops (XLA backend), the FAS operator, Newton sweep and restriction
against their Pallas kernels in interpret mode, FAS V/W/F cycles, one
batch against the Pallas whole-batch kernel in interpret mode, the solve,
and the CLI in mode 1.

Inputs are made with numpy from a seed.  Tolerances: single ops agree to
rtol 1e-5 with an atol of 1e-5·max|want| (XLA's CPU code and PyTorch round
e^x and single ops differently, by an ulp or so); cycle norms and fields
to rel 2e-4 with atol 2e-5·max|v|, the float32 cycle tolerance of
tests/test_vcycle2.py, since the residual, a difference of nearly equal
terms, grows those roundings as it falls."""

import functools
import os
import re

import jax
import numpy as np
import pytest
import torch

import gpusolve_tpu as gs
from gpusolve_tpu.grid import alloc_shape
from gpusolve_tpu.ops import dispatch as jops
from gpusolve_tpu.ops import pallas_kernels as pk
from gpusolve_tpu.ops import pallas_vcycle2 as pv2
from gpusolve_tpu.solver import vcycle as jvc
from gpusolve_tpu_torch import cli
from gpusolve_tpu_torch import config as tcfg
from gpusolve_tpu_torch import grid as tgrid
from gpusolve_tpu_torch import interop
from gpusolve_tpu_torch.ops import kernels, vcycle_batch
from gpusolve_tpu_torch.solver import vcycle as tvc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OP_TOL = 1e-5
CYCLE_TOL = 2e-4

SKEW = dict(
    values=(6.5, -1.25, -0.75, -1.0, -1.0, -0.5, -1.5),
    offsets=((0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 1),
             (0, 0, 1), (-1, -1, 0)),
)


def params_pair(dims, mode=1, skew=False, **kw):
    base = dict(
        maxiter=3, tol=1e-12, grid_dim=dims, mode=mode, pre_smoothing=3,
        post_smoothing=3, omega=0.8, gamma=1.0, dtype="float32",
        print_progress=False,
    )
    base.update(kw)
    pj = gs.GridParams(
        stencil=gs.Stencil(**SKEW) if skew else gs.Stencil.poisson_7pt(),
        backend="xla", **base,
    )
    pt = tcfg.GridParams(
        stencil=tcfg.Stencil(**SKEW) if skew else tcfg.Stencil.poisson_7pt(),
        **base,
    )
    return pj, pt


def rand_field(rng, dims, scale=1.0):
    a = np.zeros(tuple(d + 2 for d in dims), np.float32)
    a[1:-1, 1:-1, 1:-1] = rng.standard_normal(dims) * scale
    return a


def to_jax(a, dims):
    full = np.zeros(alloc_shape(dims), a.dtype)
    full[: a.shape[0], : a.shape[1], : a.shape[2]] = a
    return jax.numpy.asarray(full)


def crop(x, dims):
    return np.asarray(x)[: dims[0] + 2, : dims[1] + 2, : dims[2] + 2]


def assert_close(got, want, tol=OP_TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=tol, atol=tol * np.abs(want).max()
    )


def halo_zero(t):
    a = t.numpy()
    return not (a[0].any() or a[-1].any() or a[:, 0].any()
                or a[:, -1].any() or a[:, :, 0].any() or a[:, :, -1].any())


@functools.lru_cache(maxsize=None)
def jitted(name):
    """The JAX package's dispatch ops, jitted once (cheaper on the CPU than
    eager dispatch)."""
    if name == "residual":
        return jax.jit(jops.residual_op, static_argnums=(3, 4, 5, 7))
    if name == "smooth":
        return jax.jit(jops.smooth, static_argnums=(3, 4, 5, 6))
    if name == "restrict":
        return jax.jit(jops.restrict_op, static_argnums=(2, 3, 4))
    return jax.jit(jops.apply_stencil_fas, static_argnums=(1, 2, 3))


@pytest.mark.parametrize("mode", [tcfg.Mode.NONLINEAR, tcfg.Mode.NEWTON])
def test_wrappers_cpu_path_match_jax_dispatch(mode):
    """Each kernel wrapper on CPU tensors (its plain version) against the
    JAX package's dispatch op on the XLA backend, written in place with
    the halo left zero, in FAS and Newton mode on a skewed stencil."""
    rng = np.random.default_rng(11)
    dims = (15, 7, 31)
    cdims = tuple(d // 2 for d in dims)
    pj, pt = params_pair(dims, mode=int(mode), skew=True)
    h = pt.level_h(0)
    v = rand_field(rng, dims, 0.5)
    f = rand_field(rng, dims, 50.0)
    nv = rand_field(rng, dims, 0.3)
    jv, jf, jnv = (to_jax(a, dims) for a in (v, f, nv))
    tv, tf, tnv = (torch.from_numpy(a) for a in (v, f, nv))
    newton = mode == tcfg.Mode.NEWTON
    jn = jnv if newton else None
    tn = tnv if newton else None

    r = torch.from_numpy(rand_field(rng, dims))  # stale, zero halo
    parts = kernels.residual(r, tv, tf, dims, pt, h, with_norm=True,
                             newton_v=tn)
    want_r, want_ss = jitted("residual")(jv, jv, jf, dims, pj, h, jn, True)
    assert_close(r, crop(want_r, dims))
    assert halo_zero(r)
    ss = torch.empty(1)
    kernels.finalize(parts, ss)
    assert float(ss[0]) == pytest.approx(float(want_ss), rel=OP_TOL)

    out = torch.from_numpy(rand_field(rng, dims))
    kernels.jacobi_sweep(out, tv, tf, dims, pt, h, newton_v=tn)
    want_v, _ = jitted("smooth")(jv, jf, jv, dims, pj, h, 1, jn)
    assert_close(out, crop(want_v, dims))
    assert halo_zero(out)

    o1 = torch.from_numpy(rand_field(rng, cdims))
    o2 = torch.from_numpy(rand_field(rng, cdims))
    kernels.restrict(o1, tv, dims, cdims, out2=o2)
    want_c = jitted("restrict")(to_jax(rand_field(rng, cdims), cdims), jv,
                                dims, cdims, pj)
    assert_close(o1, crop(want_c, cdims))
    assert torch.equal(o1, o2) and halo_zero(o1)

    if not newton:
        # Onto zero: the operator itself; onto f: the tau fold f + A(v).
        a = torch.zeros_like(tv)
        kernels.apply_fas(a, tv, dims, pt, h)
        want_a = jitted("apply")(jv, dims, pj, h)
        assert_close(a, crop(want_a, dims))
        acc = tf.clone()
        kernels.apply_fas(acc, tv, dims, pt, h)
        assert_close(acc, f + crop(want_a, dims))
        assert halo_zero(acc)

        c = torch.from_numpy(rand_field(rng, cdims))
        w = torch.from_numpy(rand_field(rng, cdims))
        want_s = c.numpy() - w.numpy()
        kernels.subtract(c, w, cdims)
        np.testing.assert_array_equal(c.numpy(), want_s)
    assert all(n == 0 for n in kernels.launches.values())


def test_fas_ops_match_pallas_interpret():
    """apply_stencil_fas, the Newton jacobi_sweep and
    restrict_full_weighting against their Pallas kernels run in interpret
    mode at 15³, as tests/test_pallas.py runs them."""
    rng = np.random.default_rng(12)
    dims = (15, 15, 15)
    cdims = (7, 7, 7)
    pj, pt = params_pair(dims)
    h = pt.level_h(0)
    v, f, nv = (rand_field(rng, dims, s) for s in (0.5, 50.0, 0.3))
    dead = to_jax(rand_field(rng, dims, 9.0), dims)

    want = pk.apply_stencil_fas(dead, to_jax(v, dims), dims, pj, h,
                                interpret=True)
    got = torch.zeros(tuple(d + 2 for d in dims))
    kernels.apply_fas(got, torch.from_numpy(v), dims, pt, h)
    assert_close(got, crop(want, dims))

    pjn, ptn = params_pair(dims, mode=2)
    want = pk.jacobi_sweep(dead, to_jax(v, dims), to_jax(f, dims), dims,
                           pjn, h, newton_v=to_jax(nv, dims), interpret=True)
    got = torch.zeros_like(got)
    kernels.jacobi_sweep(got, torch.from_numpy(v), torch.from_numpy(f), dims,
                         ptn, h, newton_v=torch.from_numpy(nv))
    assert_close(got, crop(want, dims))

    cdead = to_jax(rand_field(rng, cdims, 9.0), cdims)
    want = pk.restrict_full_weighting(cdead, to_jax(nv, dims), cdims,
                                      interpret=True)
    got = torch.zeros(tuple(d + 2 for d in cdims))
    kernels.restrict(got, torch.from_numpy(nv), dims, cdims)
    assert_close(got, crop(want, cdims))


def jax_cycles(pj, n):
    state = gs.build_grid(pj)
    tp = jvc.trace_params(pj)
    hist = []
    for _ in range(n):
        state, res = jvc.vcycle(state, params=tp, shardings=None)
        hist.append(float(res))
    return state, hist


def assert_v_close(got, want):
    scale = np.abs(want).max() + 1e-30
    np.testing.assert_allclose(got, want, rtol=CYCLE_TOL,
                               atol=0.1 * CYCLE_TOL * scale)


@pytest.mark.parametrize("cycle", ["V", "W", "F"])
def test_fas_cycles_match_jax(cycle):
    """Two FAS cycles of each schedule against jvc.vcycle at 15³: norms,
    the finest v, rest_v, and the coarse v left as v − rest_v, as in JAX.
    A coarse v is a difference of two near-equal fields, so its atol is
    2e-4 of those fields' scale (max|rest_v|), not of its own."""
    dims = (15, 15, 15)
    pj, pt = params_pair(dims, cycle_type=cycle)
    jstate, want = jax_cycles(pj, 2)
    state = tgrid.build_grid(pt, device="cpu")
    got = [tvc.vcycle(state, pt)[1] for _ in range(2)]
    assert got == pytest.approx(want, rel=CYCLE_TOL)
    assert_v_close(state.levels[0].v.numpy(), crop(jstate.levels[0].v, dims))
    for d, lvl, jl in zip(pt.level_dims()[1:], state.levels[1:],
                          jstate.levels[1:]):
        rest_v = crop(jl.rest_v, d)
        assert_v_close(lvl.rest_v.numpy(), rest_v)
        np.testing.assert_allclose(
            lvl.v.numpy(), crop(jl.v, d), rtol=CYCLE_TOL,
            atol=CYCLE_TOL * np.abs(rest_v).max(),
        )


def test_fas_batch_matches_pallas_vcycle2_interpret():
    """Two FAS cycles in one batch against _vcycle2_call in interpret mode
    at 15³, the smallest size tests/test_vcycle2.py runs it at (the cost
    is the kernel's trace, which grows with the levels).  The v2 kernel
    rounds FAS as rr_lin − γ·v·eᵛ, the port as XLA does, so only to
    tolerance."""
    dims = (15, 15, 15)
    pj, pt = params_pair(dims)
    jstate = gs.build_grid(pj)
    fields, norms = pv2.vcycle2_fused(
        jstate.levels, pj, max_cycles=2, interpret=True
    )
    state = tgrid.build_grid(pt, device="cpu")
    got = vcycle_batch.run(state, pt, maxk=2)
    np.testing.assert_allclose(got, np.asarray(norms), rtol=CYCLE_TOL)
    assert_v_close(state.levels[0].v.numpy(),
                   crop(np.asarray(fields[0][0]), dims))


def test_fas_batch_early_stop_restores_state():
    """A device early stop after cycle 2 of 4 leaves every level's v, f and
    rest_v as two cycles leave them; pre + post odd checks that the
    ping-pong of the skipped cycles is undone."""
    _, pt = params_pair((15, 15, 15), pre_smoothing=2, post_smoothing=1)
    two = tgrid.build_grid(pt, device="cpu")
    want = vcycle_batch.run(two, pt, maxk=2)
    thr = float(np.float32((want[0] + want[1]) / 2))
    state = tgrid.build_grid(pt, device="cpu")
    norms = vcycle_batch.run(state, pt, maxk=4, thr=thr)
    np.testing.assert_array_equal(norms[:2], want)
    assert norms[2] == -1.0 and norms[3] == -1.0
    for a, b in zip(state.levels, two.levels):
        assert torch.equal(a.v, b.v) and torch.equal(a.f, b.f)
        assert torch.equal(a.rest_v, b.rest_v)


def test_fas_launch_counts_formula():
    _, pt = params_pair((511, 511, 511))
    counts = vcycle_batch.launches_per_cycle(pt)
    assert counts == {
        "finalize": 1, "jacobi_sweep_fas": 6, "down_leg_fas": 8,
        "up_leg_fas": 8, "apply_fas": 8, "subtract": 8,
    }
    assert sum(counts.values()) == 39
    w = vcycle_batch.launches_per_cycle(pt.replace(cycle_type="W"))
    assert w["down_leg_fas"] == 255 and w["subtract"] == 255
    # Past the sweep cap each visit runs the per-op schedule.
    p66 = pt.replace(pre_smoothing=6, post_smoothing=6)
    counts = vcycle_batch.launches_per_cycle(p66)
    assert counts == {
        "residual_fas": 9, "finalize": 1, "jacobi_sweep_fas": 108,
        "restrict": 16, "apply_fas": 8, "subtract": 8, "prolong_add": 8,
    }
    w = vcycle_batch.launches_per_cycle(p66.replace(cycle_type="W"))
    assert w["restrict"] == 2 * 255 and w["subtract"] == 255


def test_fas_solve_matches_jax_solve():
    """The FAS solve at 31³ against gs.solve: the same iteration count and
    history.  tol 2e-3 stops well above the float32 floor."""
    dims = (31, 31, 31)
    pj, pt = params_pair(dims, maxiter=20, tol=2e-3)
    _, want = gs.solve(gs.build_grid(pj), pj)
    state, got = tvc.solve(tgrid.build_grid(pt, device="cpu"), pt,
                           check_every=4)
    assert len(got) == len(want) < 21
    assert got == pytest.approx(want, rel=CYCLE_TOL)


def test_fas_from_jax_state_via_interop():
    """interop carries rest_v across: one FAS cycle from a JAX state after
    one cycle, in both packages, agrees."""
    dims = (15, 15, 15)
    pj, pt = params_pair(dims)
    jstate, _ = jax_cycles(pj, 1)
    fields = [
        {"v": np.asarray(lvl.v), "f": np.asarray(lvl.f),
         "rest_v": np.asarray(lvl.rest_v)}
        for lvl in jstate.levels
    ]
    state = interop.state_from_numpy(pt, fields, device="cpu")
    for d, lvl, src in zip(pt.level_dims(), state.levels, fields):
        np.testing.assert_array_equal(lvl.rest_v.numpy(),
                                      crop(src["rest_v"], d))
    _, want = jvc.vcycle(jstate, params=jvc.trace_params(pj), shardings=None)
    _, got = tvc.vcycle(state, pt)
    assert got == pytest.approx(float(want), rel=CYCLE_TOL)


def test_cli_mode1_lines_and_validate(tmp_path, capsys):
    toks = open(os.path.join(ROOT, "examples", "nonlinear_127.conf")).read()
    toks = toks.split()
    toks[0] = "6"
    toks[2:5] = ["15", "15", "15"]
    path = tmp_path / "nl.conf"
    path.write_text(" ".join(toks))
    assert cli.main([str(path), "--platform", "cpu", "--validate"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[1] == "Solving nonlinear problem"
    assert re.match(r"^Inital residual: \S+$", out[2])
    iters = [re.match(r"^iter: (\d+) residual: (\S+) Took \d+ms", ln)
             for ln in out[3:-1]]
    assert iters and all(iters)
    m = re.match(r"^max-abs error vs analytic solution: (\S+)$", out[-1])
    # O(h²) discretisation error at h = 1/16 after 6 FAS cycles.
    assert m and float(m.group(1)) < 5e-3
