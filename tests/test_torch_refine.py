"""The port's mixed-precision refinement (solver/refine.py) on the CPU,
against the JAX package's ``solve_refine`` (x64 is on in conftest.py) and
the float64 oracle (tests/oracle.py), at 15³ in LINEAR and NEWTON.

Tolerances: the initial residual to rel 1e-12 (both are the float64 norm
of the same RHS); later outer residuals to rel 5e-3 while they stay above
1e-12 of the initial (each outer step is set by a float32 inner solve,
and the two packages' float32 cycles round differently, by ~1e-3 relative
on these residuals), a factor 2 below that (the float64 floor); the
solutions to 1e-10·max|u| of each other and to 1e-8·max|u| of the
oracle's converged float64 solve (tests/test_refine.py's bound)."""

import numpy as np
import pytest

import gpusolve_tpu as gs
import oracle
from gpusolve_tpu.solver.refine import solve_refine as jax_solve_refine
from gpusolve_tpu_torch import config as tcfg
from gpusolve_tpu_torch.config import Mode
from gpusolve_tpu_torch.solver import refine as trefine
from gpusolve_tpu_torch.solver import vcycle as tvc


def params_pair(mode, dims=(15, 15, 15), **kw):
    base = dict(
        maxiter=4, tol=1e-11, grid_dim=dims, mode=mode, pre_smoothing=3,
        post_smoothing=3, omega=0.8, gamma=1.0, dtype="float32",
        print_progress=False,
    )
    base.update(kw)
    pj = gs.GridParams(
        stencil=gs.Stencil.poisson_7pt(), backend="xla", **base
    )
    pt = tcfg.GridParams(stencil=tcfg.Stencil.poisson_7pt(), **base)
    return pj, pt


def oracle_solution(pj):
    po = pj.replace(maxiter=60, tol=1e-13, dtype="float64")
    g = oracle.OracleGrid(po)
    if po.mode == Mode.NEWTON:
        oracle.newton_solve(g)
        return g.levels[0].newton_v
    oracle.solve(g)
    return g.levels[0].v


@pytest.mark.parametrize("mode", [Mode.LINEAR, Mode.NEWTON],
                         ids=lambda m: m.name)
def test_refine_matches_jax_and_oracle(mode):
    pj, pt = params_pair(mode)
    u_j, want = jax_solve_refine(pj)
    u, got = trefine.solve_refine(pt, device="cpu")
    assert len(got) == len(want)
    assert got[0] == pytest.approx(want[0], rel=1e-12)
    for g, w in zip(got[1:], want[1:]):
        if w >= 1e-12 * want[0]:
            assert g == pytest.approx(w, rel=5e-3)
        else:
            assert w / 2 <= g <= 2 * w
    assert got[-1] <= got[0] * 1e-11  # far below the float32 floor
    nx, ny, nz = pt.grid_dim
    u = u.numpy()
    u_j = np.asarray(u_j)[: nx + 2, : ny + 2, : nz + 2]
    scale = np.abs(u_j).max()
    assert np.abs(u - u_j).max() <= 1e-10 * scale
    u_ref = oracle_solution(pj)
    assert np.abs(u - u_ref).max() <= 1e-8 * np.abs(u_ref).max()


def test_refine_inner_solves_take_the_v1_engine(monkeypatch):
    """At V(6,6) the inner float32 solves go through ``solve`` to the v1
    engine where the gates allow it (opened here for CPU tensors), with
    the same result as the batch engine's inner solves."""
    _, pt = params_pair(Mode.NEWTON, pre_smoothing=6, post_smoothing=6,
                        maxiter=3)
    u_batch, h_batch = trefine.solve_refine(pt, device="cpu")
    engines = []
    solve = tvc.solve

    def spy(state, params, **kw):
        engines.append(tvc.engine(params, state.device))
        return solve(state, params, **kw)

    monkeypatch.setattr(
        tvc, "_fused_capable",
        lambda p, device: p.backend != "ref" and p.dtype == "float32",
    )
    monkeypatch.setattr(tvc, "solve", spy)
    u, h = trefine.solve_refine(pt, device="cpu")
    assert engines == ["v1"] * 3
    assert h == h_batch
    assert (u == u_batch).all()


def test_refine_rejects_f64_inner():
    _, pt = params_pair(Mode.LINEAR, dtype="float64")
    with pytest.raises(ValueError, match="float32"):
        trefine.solve_refine(pt, device="cpu")
