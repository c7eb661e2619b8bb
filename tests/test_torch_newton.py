"""The port's NEWTON mode against the JAX package on the CPU: the newton_f
repair and comp_f, ũ's restriction and the coarsest-level quirk, one
inner batch against the Pallas whole-batch kernel in interpret mode, the
outer loop against gs.newton_solve (float32) and the float64 oracle, a
resume from a JAX state carried across by interop, and the CLI in mode 2
with --validate and --dump.

Inputs are made with numpy from a seed.  Tolerances: the RHS to rtol 1e-6
(the two packages' device formulas round differently, as in
tests/test_torch_grid.py); single ops to rtol 1e-5 with atol
1e-5·max|want|; cycle and Newton-step norms and fields to rel 2e-4 (atol
2e-5·max|v|), compared above the float32 floor only (at 15³ that floor is
~3e-6 of the initial residual, and the last Newton norms beneath ~1e-4 of
it part by up to 25 %); float64 against the oracle to rtol 1e-10."""

import dataclasses
import os
import re

import jax
import numpy as np
import pytest
import torch

import gpusolve_tpu as gs
import oracle
from gpusolve_tpu.ops import pallas_vcycle2 as pv2
from gpusolve_tpu.solver import newton as jnewton
from gpusolve_tpu.solver import vcycle as jvc
from gpusolve_tpu.utils import dump as jdump
from gpusolve_tpu_torch import cli
from gpusolve_tpu_torch import config as tcfg
from gpusolve_tpu_torch import grid as tgrid
from gpusolve_tpu_torch import interop
from gpusolve_tpu_torch.ops import kernels, vcycle_batch
from gpusolve_tpu_torch.solver import newton as tnewton
from gpusolve_tpu_torch.utils import dump as tdump

import gpusolve_tpu_torch as gt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CYCLE_TOL = 2e-4


def params_pair(dims, **kw):
    base = dict(
        maxiter=3, tol=1e-12, grid_dim=dims, mode=2, pre_smoothing=3,
        post_smoothing=3, omega=0.8, gamma=1.0, dtype="float32",
        print_progress=False,
    )
    base.update(kw)
    pj = gs.GridParams(
        stencil=gs.Stencil.poisson_7pt(), backend="xla", **base
    )
    pt = tcfg.GridParams(stencil=tcfg.Stencil.poisson_7pt(), **base)
    return pj, pt


def crop(x, dims):
    return np.asarray(x)[: dims[0] + 2, : dims[1] + 2, : dims[2] + 2]


def jax_fields(jstate):
    """Writable numpy copies of the JAX state's level fields."""
    return [
        {"v": np.array(lvl.v), "f": np.array(lvl.f),
         "newton_v": np.array(lvl.newton_v)}
        for lvl in jstate.levels
    ]


def from_jax(pt, jstate):
    return interop.state_from_numpy(
        pt, jax_fields(jstate), device="cpu",
        newton_f=np.asarray(jstate.newton_f),
    )


def with_levels(jstate, fields):
    """The JAX state with the given numpy fields put into its levels."""
    levels = list(jstate.levels)
    for i, fl in enumerate(fields):
        levels[i] = dataclasses.replace(
            levels[i], **{k: jax.numpy.asarray(a) for k, a in fl.items()}
        )
    return dataclasses.replace(jstate, levels=tuple(levels))


def test_newton_f_repair_and_comp_f():
    """newton_f is a tensor of its own: comp_f writes F into level 0's f
    and leaves newton_f equal to the finest RHS and to JAX's newton_f."""
    dims = (15, 15, 15)
    pj, pt = params_pair(dims)
    state = tgrid.build_grid(pt, device="cpu")
    rhs = state.levels[0].f.clone()
    assert state.newton_f.data_ptr() != state.levels[0].f.data_ptr()
    rng = np.random.default_rng(21)
    nv = state.levels[0].newton_v
    nv[1:-1, 1:-1, 1:-1] = torch.from_numpy(
        (0.1 * rng.standard_normal(dims)).astype(np.float32)
    )
    res = tnewton.comp_f(state, pt)
    assert torch.equal(state.newton_f, rhs)
    assert not torch.equal(state.levels[0].f, rhs)

    jstate = gs.build_grid(pj)
    want_nf = crop(jstate.newton_f, dims)
    np.testing.assert_allclose(state.newton_f.numpy(), want_nf, rtol=1e-6,
                               atol=1e-6 * np.abs(want_nf).max())
    full = np.zeros(jstate.levels[0].newton_v.shape, np.float32)
    full[: dims[0] + 2, : dims[1] + 2, : dims[2] + 2] = nv.numpy()
    jstate = with_levels(jstate, [{"newton_v": full}])
    jstate, want = jnewton.comp_f(jstate, params=jvc.trace_params(pj))
    assert res == pytest.approx(float(want), rel=1e-5)
    want_f = crop(jstate.levels[0].f, dims)
    np.testing.assert_allclose(state.levels[0].f.numpy(), want_f,
                               rtol=1e-5, atol=1e-5 * np.abs(want_f).max())


def test_prepare_restricts_to_all_but_the_coarsest():
    """_prepare_find_error zeroes the finest v and restricts ũ into levels
    1..L−2; the coarsest ũ stays zero (a reference quirk kept), as in the
    JAX package."""
    dims = (31, 31, 31)
    pj, pt = params_pair(dims)
    rng = np.random.default_rng(22)
    jstate = gs.build_grid(pj)
    fields = jax_fields(jstate)
    fields[0]["v"][1:32, 1:32, 1:32] = rng.standard_normal(dims)
    fields[0]["newton_v"][1:32, 1:32, 1:32] = 0.3 * rng.standard_normal(dims)
    state = interop.state_from_numpy(pt, fields, device="cpu",
                                     newton_f=np.asarray(jstate.newton_f))
    jstate = with_levels(jstate, fields)
    tnewton._prepare_find_error(state, pt)
    jstate = jnewton._prepare_find_error(jstate, params=jvc.trace_params(pj))
    assert not state.levels[0].v.any()
    assert not state.levels[-1].newton_v.any()
    for d, lvl, jl in zip(pt.level_dims()[1:-1], state.levels[1:-1],
                          jstate.levels[1:-1]):
        assert lvl.newton_v.any()
        want = crop(jl.newton_v, d)
        np.testing.assert_allclose(lvl.newton_v.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_newton_batch_matches_pallas_vcycle2_interpret():
    """Two inner NEWTON cycles in one batch, with a nonzero ũ on every
    level, against _vcycle2_call in interpret mode at 15³, the smallest
    size tests/test_vcycle2.py runs it at (the cost is the kernel's trace,
    which grows with the levels), both from the same state."""
    dims = (15, 15, 15)
    pj, pt = params_pair(dims)
    rng = np.random.default_rng(7)
    jstate = gs.build_grid(pj)
    seeded = []
    for d, lvl in zip(pj.level_dims(), jstate.levels):
        nv = np.zeros(lvl.v.shape, np.float32)
        nv[1 : d[0] + 1, 1 : d[1] + 1, 1 : d[2] + 1] = (
            0.2 * rng.standard_normal(d)
        )
        seeded.append({"newton_v": nv})
    jstate = with_levels(jstate, seeded)
    state = from_jax(pt, jstate)
    fields, norms = pv2.vcycle2_fused(
        jstate.levels, pj, max_cycles=2, interpret=True
    )
    got = vcycle_batch.run(state, pt, maxk=2)
    np.testing.assert_allclose(got, np.asarray(norms), rtol=CYCLE_TOL)
    want_v = crop(np.asarray(fields[0][0]), dims)
    np.testing.assert_allclose(state.levels[0].v.numpy(), want_v,
                               rtol=CYCLE_TOL,
                               atol=0.1 * CYCLE_TOL * np.abs(want_v).max())


@pytest.mark.parametrize("dims", [(15, 15, 15), (15, 7, 31)])
def test_newton_solve_matches_jax(dims):
    """The outer loop against gs.newton_solve: the same steps and norms.
    tol 2e-3 stops after two steps, above the float32 floor."""
    pj, pt = params_pair(dims, maxiter=5, tol=2e-3)
    _, want = gs.newton_solve(gs.build_grid(pj), pj)
    kernels.reset_launches()
    state, got = gt.newton_solve(tgrid.build_grid(pt, device="cpu"), pt)
    assert len(got) == len(want) < 6
    assert got == pytest.approx(want, rel=CYCLE_TOL)
    assert all(n == 0 for n in kernels.launches.values())


@pytest.mark.parametrize("dims, maxiter", [((15, 15, 15), 5),
                                           ((15, 7, 31), 3)])
def test_newton_float64_matches_oracle(dims, maxiter):
    pj, pt = params_pair(dims, maxiter=maxiter, tol=1e-5, dtype="float64")
    want = oracle.newton_solve(oracle.OracleGrid(pj))
    _, got = gt.newton_solve(tgrid.build_grid(pt, device="cpu"), pt)
    assert len(got) == len(want)
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_newton_resume_from_jax_state():
    """A JAX state after one Newton step, carried across by interop with
    its own newton_f (its level-0 f holds F, not the RHS), resumes in both
    packages to the same next step."""
    dims = (15, 15, 15)
    pj, pt = params_pair(dims, maxiter=1)
    jstate, head = gs.newton_solve(gs.build_grid(pj), pj)
    state = from_jax(pt, jstate)
    np.testing.assert_array_equal(state.newton_f.numpy(),
                                  crop(jstate.newton_f, dims))
    _, want = gs.newton_solve(jstate, pj, initial_residual=head[0])
    _, got = gt.newton_solve(state, pt, initial_residual=head[0])
    assert len(got) == len(want) == 1
    assert got == pytest.approx(want, rel=CYCLE_TOL)


def test_newton_solve_rejects_other_modes():
    _, pt = params_pair((7, 7, 7), mode=1)
    with pytest.raises(ValueError, match="NEWTON"):
        gt.newton_solve(tgrid.build_grid(pt, device="cpu"), pt)


def test_cli_mode2_validate_and_dump(tmp_path, capsys):
    toks = open(os.path.join(ROOT, "examples", "newton_127.conf")).read()
    toks = toks.split()
    toks[0] = "3"
    toks[2:5] = ["15", "15", "15"]
    conf = tmp_path / "newton.conf"
    conf.write_text(" ".join(toks))
    out_path = tmp_path / "u.txt"
    assert cli.main([str(conf), "--platform", "cpu", "--validate",
                     "--dump", str(out_path)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[1] == "Solving newton problem"
    assert re.match(r"^Inital newton residual: \S+$", out[2])
    steps = [re.match(r"^newton iter: (\d+) residual: (\S+) Took \d+ms", ln)
             for ln in out[3:-2]]
    assert steps and all(steps)
    assert [int(m.group(1)) for m in steps] == list(range(len(steps)))
    assert out[-2] == f"Dumped solution to {out_path}"
    m = re.match(r"^max-abs error vs analytic solution: (\S+)$", out[-1])
    # O(h²) discretisation error at h = 1/16 after 3 Newton steps.
    assert m and float(m.group(1)) < 5e-3

    # The dump is the solution, in the JAX package's dump_field text.
    pt = tcfg.parse_config(str(conf), print_progress=False)
    state, _ = gt.newton_solve(tgrid.build_grid(pt, device="cpu"), pt)
    u = state.levels[0].newton_v.numpy()
    jdump.dump_field(u, str(tmp_path / "jax.txt"))
    assert out_path.read_text() == (tmp_path / "jax.txt").read_text()
    np.testing.assert_array_equal(tdump.load_dump(str(out_path)), u)
    assert tdump.compare_analytic(u, pt.h) == jdump.compare_analytic(u, pt.h)
    assert float(m.group(1)) == pytest.approx(
        tdump.compare_analytic(u, pt.h), rel=1e-5
    )


def test_cli_validate_linear_message(tmp_path, capsys):
    toks = open(os.path.join(ROOT, "examples", "linear_127.conf")).read()
    toks = toks.split()
    toks[0] = "1"
    toks[2:5] = ["7", "7", "7"]
    conf = tmp_path / "lin.conf"
    conf.write_text(" ".join(toks))
    assert cli.main([str(conf), "--platform", "cpu", "--validate"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "--validate only applies to nonlinear/newton modes"
