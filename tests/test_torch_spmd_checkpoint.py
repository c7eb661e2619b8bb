"""The distributed engines' checkpoints and refinement on the CPU
(utils/checkpoint.save_state_spmd / load_state_spmd,
solver/refine.solve_refine_spmd, and the CLI's --save-state, --load-state
and --refine with --mesh), on the one-rank mesh in float32:

  * a round trip through each plan of the per-leg engine (the replicated
    tail, ``tail="pv2"``, and the classic plan, ``tail="off"``) and the
    pod engine, in LINEAR, FAS and NEWTON: the resumed history continues
    the uninterrupted one bit for bit (``h1 + h2 == h_full``);
  * a checkpoint of one plan refused by the other (the fingerprint holds
    the plan's allocation), and one the JAX package's spmd engine wrote
    (its TPU allocation), with the reference's message;
  * ``solve_refine_spmd`` against the float64 oracle, with the tolerances
    of tests/test_refine.py::test_refine_spmd_engine_matches_oracle;
  * the CLI with --mesh 1,1,1: --save-state then --load-state resuming to
    the uninterrupted history, and --refine.

Each rank's blocks gathered to rank 0 and cut back out is held on two
gloo ranks in tests/test_torch_spmd_tail.py.
"""

import os
import re

import numpy as np
import pytest

import gpusolve_tpu_torch as gt
import oracle
from gpusolve_tpu_torch import cli
from gpusolve_tpu_torch.dist import spmd as tsp
from gpusolve_tpu_torch.solver.refine import solve_refine_spmd
from gpusolve_tpu_torch.utils import checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(ROOT, "examples", "linear_127.conf")


def _params(mode, dims=(31, 31, 31), maxiter=4, **kw):
    base = dict(maxiter=maxiter, tol=1e-30, grid_dim=dims, mode=mode,
                pre_smoothing=2, post_smoothing=2, omega=0.8, gamma=1.0,
                print_progress=False, dtype="float32")
    base.update(kw)
    return gt.GridParams(stencil=gt.Stencil.poisson_7pt(), **base)


def _run(params, mesh, engine, state=None, plan=None, initial=None,
         newton_f=None):
    fuse, tail = engine
    kw = dict(cutoff=3, fuse=fuse, tail=tail, state=state, plan=plan,
              initial_residual=initial)
    if params.mode == gt.Mode.NEWTON:
        return gt.newton_solve_spmd(params, mesh, newton_f=newton_f, **kw)
    return gt.solve_spmd(params, mesh, **kw)


ENGINES = {"tail": ("leg", "pv2"), "classic": ("leg", "off"),
           "pod": ("pod", "off")}


@pytest.mark.parametrize("mode", [0, 1, 2], ids=["linear", "fas", "newton"])
@pytest.mark.parametrize("name", list(ENGINES))
def test_checkpoint_round_trip(tmp_path, name, mode):
    """k steps, saved; loaded into a new engine of the same plan, the rest:
    the uninterrupted history, bit for bit."""
    mesh = gt.make_mesh((1, 1, 1), device="cpu")
    fuse, tail = ENGINES[name]
    total, head = (3, 1) if mode == 2 else (4, 2)
    _, full, plan = _run(_params(mode, maxiter=total), mesh, ENGINES[name])
    assert (plan.tail_pv2 is not None) == (name == "tail")
    p = _params(mode, maxiter=head)
    state, h1, plan = _run(p, mesh, ENGINES[name])
    path = str(tmp_path / "ck.npz")
    checkpoint.save_state_spmd(
        path, state, plan, p, f"spmd/{fuse}", iteration=head, history=h1,
        newton_f=plan.newton_f if mode == 2 else None, mesh=mesh)
    rest = _params(mode, maxiter=total - head)
    eng = tsp.build_spmd_solver(rest, mesh, 3, fuse=fuse, tail=tail)
    st, it, h0, nf = checkpoint.load_state_spmd(
        path, rest, eng.plan, f"spmd/{fuse}", mesh=mesh)
    assert it == head and h0 == h1 and (nf is not None) == (mode == 2)
    _, h2, _ = _run(rest, mesh, ENGINES[name], state=st, plan=eng.plan,
                    initial=h0[0], newton_f=nf)
    assert h0 + h2 == full


def test_checkpoint_refuses_other_plan(tmp_path):
    """The fingerprint holds the plan's allocation: a tail-plan checkpoint
    refuses the classic plan and the other way round."""
    mesh = gt.make_mesh((1, 1, 1), device="cpu")
    p = _params(0, maxiter=1)
    paths = {}
    for name in ("tail", "classic"):
        state, hist, plan = _run(p, mesh, ENGINES[name])
        paths[name] = str(tmp_path / f"{name}.npz")
        checkpoint.save_state_spmd(paths[name], state, plan, p, "spmd/leg",
                                   history=hist, mesh=mesh)
    for saved, other in (("tail", "classic"), ("classic", "tail")):
        eng = tsp.build_spmd_solver(p, mesh, 3, tail=ENGINES[other][1])
        with pytest.raises(ValueError, match="different problem/mesh/engine"):
            checkpoint.load_state_spmd(paths[saved], p, eng.plan, "spmd/leg",
                                       mesh=mesh)


def test_checkpoint_refuses_jax_file(tmp_path):
    """A checkpoint of the JAX package's spmd engine (its TPU allocation)
    is refused, with the reference's message."""
    import jax.numpy as jnp
    from gpusolve_tpu.config import GridParams, Stencil
    from gpusolve_tpu.dist import spmd as jsp
    from gpusolve_tpu.utils import checkpoint as jck

    kw = dict(maxiter=1, tol=1e-30, grid_dim=(31, 31, 31), mode=0,
              pre_smoothing=2, post_smoothing=2, omega=0.8, gamma=1.0,
              print_progress=False, dtype="float32")
    jplan = jsp.SpmdPlan(GridParams(stencil=Stencil.poisson_7pt(), **kw),
                         (1, 1, 1), 3)
    path = str(tmp_path / "jax.npz")
    jck.save_state_spmd(
        path, [jnp.zeros(a) for a in jplan.alloc for _ in "vf"], jplan,
        GridParams(stencil=Stencil.poisson_7pt(), **kw), "spmd/leg")
    mesh = gt.make_mesh((1, 1, 1), device="cpu")
    eng = tsp.build_spmd_solver(_params(0, maxiter=1), mesh, 3, tail="off")
    with pytest.raises(ValueError, match="different problem/mesh/engine"):
        checkpoint.load_state_spmd(path, _params(0, maxiter=1), eng.plan,
                                   "spmd/leg", mesh=mesh)


def _oracle_solution(p):
    po = p.replace(maxiter=60, tol=1e-13, dtype="float64")
    g = oracle.OracleGrid(po)
    if po.mode != gt.Mode.LINEAR:
        oracle.newton_solve(g)
        return g.levels[0].newton_v
    oracle.solve(g)
    return g.levels[0].v


@pytest.mark.parametrize("mode,engine", [
    (0, "tail"), (1, "classic"), (1, "pod"),
], ids=["linear-tail", "nonlinear-classic", "nonlinear-pod"])
def test_refine_spmd_matches_oracle(mode, engine):
    """Float64 outer defect, float32 inner solves on the distributed
    engine: the residual falls below 1e-11 of the initial and the solution
    is within 1e-8·max|u| of the oracle's converged float64 solve."""
    import gpusolve_tpu as gs

    fuse, tail = ENGINES[engine]
    p = _params(mode, (15, 15, 15), maxiter=12, tol=1e-11, pre_smoothing=3,
                post_smoothing=3)
    mesh = gt.make_mesh((1, 1, 1), device="cpu")
    u, hist = solve_refine_spmd(p, mesh, cutoff=2, fuse=fuse, tail=tail)
    assert hist[-1] <= hist[0] * 1e-11
    pj = gs.GridParams(stencil=gs.Stencil.poisson_7pt(), maxiter=12,
                       tol=1e-11, grid_dim=(15, 15, 15), mode=mode,
                       pre_smoothing=3, post_smoothing=3, omega=0.8,
                       gamma=1.0, dtype="float32", print_progress=False)
    u_ref = _oracle_solution(pj)
    assert np.abs(u.numpy() - u_ref).max() <= 1e-8 * np.abs(u_ref).max()


@pytest.fixture
def conf(tmp_path):
    def make(mode, maxiter, tol="1e-30"):
        toks = open(CONF).read().split()
        toks[0], toks[1], toks[5] = str(maxiter), tol, str(mode)
        toks[2:5] = ["31", "31", "31"]
        path = tmp_path / f"m{mode}_{maxiter}.conf"
        path.write_text(" ".join(toks))
        return str(path)

    return make


def test_cli_mesh_checkpoint_and_refine(conf, tmp_path, capsys):
    """--mesh 1,1,1 (--fuse leg): 2 cycles saved, then 2 resumed, give the
    4-cycle run's history; --refine reaches 1e-10 of the initial
    residual."""
    base = ["--mesh", "1,1,1", "--platform", "cpu", "--fuse", "leg",
            "--quiet"]
    head, tail, full = (str(tmp_path / f"{n}.npz")
                        for n in ("head", "tail", "full"))
    assert cli.main([conf(1, 2), *base, "--save-state", head]) == 0
    assert cli.main([conf(1, 2), *base, "--load-state", head,
                     "--save-state", tail]) == 0
    assert f"Resumed from {head} (iteration 2)" in capsys.readouterr().out
    assert cli.main([conf(1, 4), *base, "--save-state", full]) == 0
    with np.load(tail) as t, np.load(full) as f:
        assert int(t["__iteration__"]) == int(f["__iteration__"]) == 4
        assert np.array_equal(t["__history__"], f["__history__"])
    capsys.readouterr()
    assert cli.main([conf(0, 8, "1e-10"), "--mesh", "1,1,1", "--platform",
                     "cpu", "--refine"]) == 0
    out = capsys.readouterr().out
    res = [float(x) for x in re.findall(r"residual: (\S+)", out)]
    assert res[-1] <= res[0] * 1e-10
