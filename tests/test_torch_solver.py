"""The port's cycle, batch runner and solve loop against the JAX package:
its XLA V/W/F cycle, the Pallas whole-batch kernel in interpret mode, its
solve loop, and the float64 oracle.

Tolerances: per-cycle residual norms agree to rel 2e-4 and the finest v to
rtol 2e-4 with atol 2e-5·max|v| (the float32 mega-kernel-vs-XLA tolerance
of tests/test_vcycle2.py): XLA's CPU code and PyTorch round single ops
differently, and the residual, a difference of nearly equal terms, grows
those roundings as it falls.  The float64 solve agrees with the oracle to
rtol 1e-10."""

import numpy as np
import pytest
import torch

import gpusolve_tpu as gs
import oracle
from gpusolve_tpu.ops import pallas_vcycle2 as pv2
from gpusolve_tpu.solver import vcycle as jvc
from gpusolve_tpu_torch import config as tcfg
from gpusolve_tpu_torch import grid as tgrid
from gpusolve_tpu_torch.ops import kernels, vcycle_batch
from gpusolve_tpu_torch.solver import newton as tnewton
from gpusolve_tpu_torch.solver import vcycle as tvc


def params_pair(dims, **kw):
    base = dict(
        maxiter=3, tol=1e-12, grid_dim=dims, mode=0, pre_smoothing=3,
        post_smoothing=3, omega=0.8, gamma=1.0, dtype="float32",
        print_progress=False,
    )
    base.update(kw)
    pj = gs.GridParams(
        stencil=gs.Stencil.poisson_7pt(), backend="xla", **base
    )
    pt = tcfg.GridParams(stencil=tcfg.Stencil.poisson_7pt(), **base)
    return pj, pt


def jax_cycles(pj, n):
    state = gs.build_grid(pj)
    tp = jvc.trace_params(pj)
    hist = []
    for _ in range(n):
        state, res = jvc.vcycle(state, params=tp, shardings=None)
        hist.append(float(res))
    return state, hist


def crop0(jstate, dims):
    return np.asarray(jstate.levels[0].v)[
        : dims[0] + 2, : dims[1] + 2, : dims[2] + 2
    ]


def assert_v_close(got, want):
    scale = np.abs(want).max() + 1e-30
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5 * scale)


@pytest.mark.parametrize("cycle", ["V", "W", "F"])
def test_cycles_match_jax(cycle):
    dims = (15, 15, 15)
    pj, pt = params_pair(dims, cycle_type=cycle)
    jstate, want = jax_cycles(pj, 3)
    state = tgrid.build_grid(pt, device="cpu")
    got = []
    for _ in range(3):
        state, res = tvc.vcycle(state, pt)
        got.append(res)
    assert got == pytest.approx(want, rel=2e-4)
    assert_v_close(state.levels[0].v.numpy(), crop0(jstate, dims))


def test_batch_matches_pallas_vcycle2_interpret():
    """The batch runner against _vcycle2_call in interpret mode: 2 cycles in
    one launch."""
    dims = (15, 15, 15)
    pj, pt = params_pair(dims)
    jstate = gs.build_grid(pj)
    fields, norms = pv2.vcycle2_fused(
        jstate.levels, pj, max_cycles=2, interpret=True
    )
    state = tgrid.build_grid(pt, device="cpu")
    got = vcycle_batch.run(state, pt, maxk=2)
    np.testing.assert_allclose(got, np.asarray(norms), rtol=2e-4)
    want_v = np.asarray(fields[0][0])[:17, :17, :17]
    assert_v_close(state.levels[0].v.numpy(), want_v)


@pytest.mark.parametrize("pre, post", [(3, 3), (2, 1)])
def test_batch_early_stop_and_ncycles(pre, post):
    """As tests/test_vcycle2.py:134-157: a threshold between the cycle-1 and
    cycle-2 norms stops the batch after cycle 2 (later norms −1) and leaves
    the state exactly as two cycles leave it; ``ncyc < maxk`` runs exactly
    ``ncyc`` cycles.  pre + post odd checks that the v/spare ping-pong is
    undone for the skipped cycles."""
    _, pt = params_pair((15, 15, 15), pre_smoothing=pre, post_smoothing=post)
    two = tgrid.build_grid(pt, device="cpu")
    want = vcycle_batch.run(two, pt, maxk=2)
    thr = float(np.float32((want[0] + want[1]) / 2))

    state = tgrid.build_grid(pt, device="cpu")
    norms = vcycle_batch.run(state, pt, maxk=4, thr=thr)
    assert norms[0] > thr and norms[1] <= thr
    assert norms[2] == -1.0 and norms[3] == -1.0
    np.testing.assert_array_equal(norms[:2], want)
    for a, b in zip(state.levels, two.levels):
        assert torch.equal(a.v, b.v) and torch.equal(a.f, b.f)

    state3 = tgrid.build_grid(pt, device="cpu")
    norms3 = vcycle_batch.run(state3, pt, maxk=4, ncyc=3)
    assert (norms3[:3] >= 0).all() and norms3[3] == -1.0
    np.testing.assert_array_equal(norms3[:2], want)


def test_launch_counts_formula():
    _, pt = params_pair((511, 511, 511))
    assert pt.num_levels == 9
    # V(3,3): a down and an up leg at each of the 8 non-coarsest visits,
    # the coarsest's 6 sweeps, the finalize of level 0's up-leg norm.
    counts = vcycle_batch.launches_per_cycle(pt)
    assert counts == {
        "finalize": 1, "jacobi_sweep": 6, "down_leg": 8, "up_leg": 8,
    }
    assert sum(counts.values()) == 23
    w = vcycle_batch.launches_per_cycle(pt.replace(cycle_type="W"))
    assert w["jacobi_sweep"] == 6 * 256 and w["up_leg"] == 255
    # Past the sweep cap each visit runs the per-op schedule.
    p66 = pt.replace(pre_smoothing=6, post_smoothing=6)
    counts = vcycle_batch.launches_per_cycle(p66)
    assert counts == {
        "residual": 9, "finalize": 1, "jacobi_sweep": 108,
        "restrict_zero": 8, "prolong_add": 8,
    }
    w = vcycle_batch.launches_per_cycle(p66.replace(cycle_type="W"))
    assert w["jacobi_sweep"] == 12 * 511 and w["prolong_add"] == 255


def test_solve_matches_jax_solve():
    """A full solve at 31³: the same iteration count and history.  tol 2e-3
    stops at ~1.3e-3·initial, well above the float32 floor (~5e-5·initial
    at 31³).  Nearer the floor the two packages' per-op roundings, which
    differ by ~2e-5 in absolute terms on every cycle here, dominate: at
    tol 1e-4 the last norms differ by 6e-4 and 5e-3 relative."""
    dims = (31, 31, 31)
    pj, pt = params_pair(dims, maxiter=20, tol=2e-3)
    _, want = gs.solve(gs.build_grid(pj), pj)
    state = tgrid.build_grid(pt, device="cpu")
    state, got = tvc.solve(state, pt, check_every=4)
    assert len(got) == len(want) < 21
    assert got == pytest.approx(want, rel=2e-4)


def test_solve_history_independent_of_batching():
    _, pt = params_pair((15, 15, 15), maxiter=9, tol=1e-4)
    runs = []
    for k in (1, 4, 20):
        state = tgrid.build_grid(pt, device="cpu")
        state, hist = tvc.solve(state, pt, check_every=k)
        runs.append((hist, state.levels[0].v.clone()))
    for hist, v in runs[1:]:
        assert hist == runs[0][0]
        assert torch.equal(v, runs[0][1])
    assert len(runs[0][0]) < 10  # stopped by tol, not maxiter


def test_solve_resume_keeps_initial_threshold():
    _, pt = params_pair((15, 15, 15), maxiter=9, tol=1e-4)
    state, full = tvc.solve(tgrid.build_grid(pt, device="cpu"), pt)
    part = tgrid.build_grid(pt, device="cpu")
    part, head = tvc.solve(part, pt.replace(maxiter=2))
    part, tail = tvc.solve(
        part, pt.replace(maxiter=7), initial_residual=head[0]
    )
    assert head + tail == full


def test_float64_solve_matches_oracle():
    dims = (15, 15, 15)
    pj, pt = params_pair(dims, maxiter=5, tol=1e-8, dtype="float64")
    want = oracle.solve(oracle.OracleGrid(pj))
    state = tgrid.build_grid(pt, device="cpu")
    state, got = tvc.solve(state, pt, check_every=2)
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_progress_lines(capsys):
    _, pt = params_pair((15, 15, 15), maxiter=2, print_progress=True)
    tvc.solve(tgrid.build_grid(pt, device="cpu"), pt, check_every=2)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("Inital residual: ")
    for i, line in enumerate(lines[1:]):
        assert line.startswith(f"iter: {i} residual: ") and " Took " in line
    # The timer's counters ride on the first line after the batch's sync.
    assert "sumBuffer: " in lines[1] and "sumBuffer" not in lines[2]
    assert len(lines) == 3


@pytest.mark.parametrize("mode", [1, 2])
def test_other_modes_not_ported(mode):
    """Modes 1 and 2, which the LINEAR slice rejected, run now: FAS through
    solve, Newton through newton_solve, each falling every step."""
    _, pt = params_pair((15, 15, 15), mode=mode)
    state = tgrid.build_grid(pt, device="cpu")
    run = tvc.solve if mode == 1 else tnewton.newton_solve
    state, hist = run(state, pt)
    assert len(hist) == 4
    assert all(b < a / 4 for a, b in zip(hist, hist[1:]))


def test_cpu_solve_launches_no_kernel():
    kernels.reset_launches()
    _, pt = params_pair((15, 15, 15), maxiter=2)
    tvc.solve(tgrid.build_grid(pt, device="cpu"), pt)
    assert all(n == 0 for n in kernels.launches.values())
