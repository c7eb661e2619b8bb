"""The port's pod engine (gpusolve_tpu_torch/dist/pod.py, ``fuse="pod"``)
on the CPU against the JAX package:

  * on the one-rank (1, 1, 1) mesh in this process, LINEAR, FAS and Newton
    V-cycles and LINEAR W and F, at the engine's own depth (1) and at an
    explicit depth 2, against the JAX per-leg engine (``local_backend=
    "xla"``) in float64 to rtol 1e-10: the same V-cycle, chained;
  * on two gloo ranks, (2, 1, 1) (x slabs) and (1, 2, 1) (y slabs) at
    31³ and depth 2, one spawn for the module, against the JAX per-leg
    engine on the same virtual mesh in float64 to rtol 1e-10;
  * the JAX pod engine itself (its Pallas kernels in interpret mode) at
    15³ LINEAR in float32 on (1, 1, 1), to rtol 5e-4 as tests/test_pod.py
    holds it against the per-leg engine; and one cycle from one seeded
    state carried across by ``interop.pod_state_from_numpy``;
  * the CLI: ``--fuse pod``, ``--fuse auto -> pod``, ``--fuse leg``.

The JAX package is imported inside the functions that use it, so the
spawned ranks import torch only.
"""

import functools
import os
import re
import time

import numpy as np
import pytest
import torch

import gpusolve_tpu_torch as gt
from gpusolve_tpu_torch import cli, interop
from gpusolve_tpu_torch.dist import pod as tpod
from gpusolve_tpu_torch.dist import spmd as tsp
from gpusolve_tpu_torch.ops import kernels

RTOL = 1e-10
WORLD = 2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(ROOT, "examples", "linear_127.conf")


def _kw(mode, dims, cycle="V", maxiter=4, dtype="float64"):
    return dict(maxiter=maxiter, tol=1e-30, grid_dim=dims, mode=mode,
                pre_smoothing=2, post_smoothing=2, omega=0.8, gamma=1.0,
                print_progress=False, dtype=dtype, cycle_type=cycle)


def _tparams(mode, dims, cycle="V", maxiter=4, dtype="float64"):
    return gt.GridParams(stencil=gt.Stencil.poisson_7pt(),
                         **_kw(mode, dims, cycle, maxiter, dtype))


@functools.lru_cache(maxsize=None)
def _jax_leg(mesh_shape, mode, dims, cycle):
    """The JAX per-leg engine's history and gathered solution (each
    configuration compiles once per module run)."""
    from gpusolve_tpu.config import GridParams, Stencil
    from gpusolve_tpu.dist import spmd as jsp
    from gpusolve_tpu.dist.mesh import make_mesh

    params = GridParams(stencil=Stencil.poisson_7pt(),
                        **_kw(mode, dims, cycle))
    mesh = make_mesh(mesh_shape)
    run = jsp.newton_solve_spmd if mode == 2 else jsp.solve_spmd
    state, hist, plan = run(params, mesh, cutoff=2, local_backend="xla")
    sol = jsp.gather_solution(state, plan, mesh, which=2 if mode == 2 else 0)
    return np.asarray(hist), sol


def _close(got, want, what, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=rtol * np.abs(want).max(), err_msg=what)


def _pod_solve(params, mesh, npod=None):
    plan = None if npod is None else tpod.PodPlan(params, mesh.shape, npod)
    run = gt.newton_solve_spmd if params.mode == gt.Mode.NEWTON \
        else gt.solve_spmd
    return run(params, mesh, cutoff=2, fuse="pod", plan=plan)


# ---------------------------------------------------------------------------
# One rank
# ---------------------------------------------------------------------------

ONE_RANK = {
    "linear": (0, (15, 15, 15), "V"),
    "fas": (1, (15, 15, 15), "V"),
    "newton": (2, (15, 15, 15), "V"),
    "w": (0, (15, 15, 15), "W"),
    "f": (0, (15, 15, 15), "F"),
}


@pytest.mark.parametrize("npod", [None, 2], ids=["own-depth", "npod2"])
@pytest.mark.parametrize("name", list(ONE_RANK))
def test_one_rank_matches_jax_leg_engine(name, npod):
    mode, dims, cycle = ONE_RANK[name]
    mesh = gt.make_mesh((1, 1, 1), device="cpu")
    kernels.reset_launches()
    state, hist, plan = _pod_solve(_tparams(mode, dims, cycle), mesh, npod)
    assert isinstance(plan, tpod.PodPlan)
    assert plan.npod == (npod or 1) and plan.tail_in_place
    want_hist, want_sol = _jax_leg((1, 1, 1), mode, dims, cycle)
    _close(hist, want_hist, f"{name} history")
    sol = tsp.gather_solution(state, plan, mesh, which=2 if mode == 2 else 0)
    _close(sol, want_sol, f"{name} solution")
    # Zero on the halo; the CPU tensors ran the plain chains.
    assert not sol[0].any() and not sol[-1].any() and not sol[:, :, 0].any()
    assert all(n == 0 for n in kernels.launches.values())


def test_spmd_entry_points_take_fuse_pod():
    """build_spmd_solver and solve_spmd dispatch fuse='pod' to the pod
    engine (as gpusolve_tpu/dist/spmd.py:598-601 does), the per-leg engine
    otherwise; an engine built for a pod plan is reused by the solve."""
    mesh = gt.make_mesh((1, 1, 1), device="cpu")
    params = _tparams(0, (15, 15, 15), maxiter=2)
    eng = tsp.build_spmd_solver(params, mesh, fuse="pod")
    assert isinstance(eng, tpod.PodEngine) and eng.npod == 1
    assert not isinstance(tsp.build_spmd_solver(params, mesh),
                          tpod.PodEngine)
    _, _, plan = gt.solve_spmd(params, mesh, fuse="pod", plan=eng.plan)
    assert plan is eng.plan and plan._engine is eng
    assert gt.choose_npod(params, (1, 1)) == 1
    assert gt.PodPlan is tpod.PodPlan and gt.build_pod_solver


# ---------------------------------------------------------------------------
# Two gloo ranks
# ---------------------------------------------------------------------------

# name -> (mesh, mode, dims, cycle, npod)
RANK_CASES = {
    "x-linear": ((2, 1, 1), 0, (31, 31, 31), "V", 2),
    "x-fas": ((2, 1, 1), 1, (31, 31, 31), "V", 2),
    "y-linear": ((1, 2, 1), 0, (31, 31, 31), "V", 2),
}


def _rank_main(rank, store_path, out_dir):
    torch.set_num_threads(1)
    store = torch.distributed.FileStore(store_path, WORLD)
    torch.distributed.init_process_group(
        "gloo", store=store, rank=rank, world_size=WORLD
    )
    try:
        for name, (shape, mode, dims, cycle, npod) in RANK_CASES.items():
            mesh = gt.make_mesh(shape, device="cpu")
            state, hist, plan = _pod_solve(_tparams(mode, dims, cycle), mesh,
                                           npod)
            sol = tsp.gather_solution(state, plan, mesh)
            if rank == 0:
                np.savez(os.path.join(out_dir, f"{name}.npz"),
                         hist=np.asarray(hist), sol=sol, npod=plan.npod)
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("pod")
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(str(out / "store"), str(out)), nprocs=WORLD,
        join=False, start_method="spawn",
    )
    deadline = time.monotonic() + 600
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            pytest.fail("the pod ranks did not finish")
    results = {}
    for name in RANK_CASES:
        with np.load(out / f"{name}.npz") as f:
            results[name] = (f["hist"], f["sol"], int(f["npod"]))
    return results


@pytest.mark.parametrize("name", list(RANK_CASES))
def test_ranks_match_jax_leg_engine(ranks, name):
    shape, mode, dims, cycle, npod = RANK_CASES[name]
    hist, sol, got_npod = ranks[name]
    assert got_npod == npod
    want_hist, want_sol = _jax_leg(shape, mode, dims, cycle)
    _close(hist, want_hist, f"{name} history")
    _close(sol, want_sol, f"{name} solution")


# ---------------------------------------------------------------------------
# The JAX pod engine itself
# ---------------------------------------------------------------------------


def test_matches_jax_pod_engine_and_interop():
    """The JAX pod engine (its Pallas kernels in interpret mode) at 15³
    LINEAR in float32 on (1, 1, 1): the first cycle's norm to rtol 5e-4
    (tests/test_pod.py's tolerance between its two engines); then one
    cycle from one seeded state, carried into the port by
    pod_state_from_numpy, level 0's v to 5e-4 of its largest value; the
    state carried back by pod_state_to_numpy equals the JAX arrays."""
    import jax

    from gpusolve_tpu.config import GridParams, Stencil
    from gpusolve_tpu.dist import pod as jpod
    from gpusolve_tpu.dist.mesh import make_mesh

    dims = (15, 15, 15)
    kw = _kw(0, dims, maxiter=1, dtype="float32")
    jparams = GridParams(stencil=Stencil.poisson_7pt(), **kw)
    init_fn, cycle_fn, jplan = jpod.build_pod_solver(
        jparams, make_mesh((1, 1, 1)), cutoff=2
    )
    st = cycle_fn(*init_fn())
    params = _tparams(0, dims, maxiter=1, dtype="float32")
    mesh = gt.make_mesh((1, 1, 1), device="cpu")
    _, hist, plan = _pod_solve(params, mesh)
    assert plan.npod == jplan.npod == 1
    np.testing.assert_allclose(hist[1], float(st[-1]), rtol=5e-4)

    # One cycle from one seeded state.
    rng = np.random.default_rng(11)
    arrays = []
    for l, d in enumerate(plan.dims):
        shape = tuple(np.asarray(st[2 * l]).shape)
        for scale in (0.05, 100.0):
            a = np.zeros(shape, np.float32)
            a[1:d[0] + 1, 1:d[1] + 1, 1:d[2] + 1] = \
                rng.standard_normal(d).astype(np.float32) * scale
            arrays.append(a)
    out = cycle_fn(*[jax.numpy.asarray(a) for a in arrays])
    state = interop.pod_state_from_numpy(params, plan, arrays, mesh)
    shapes = [a.shape for a in arrays[::2]]
    back = interop.pod_state_to_numpy(state, params, plan, shapes, mesh)
    assert all(np.array_equal(a, b) for a, b in zip(back, arrays))
    ss = torch.empty(1)
    plan._engine.cycle(state, ss)
    got = interop.pod_state_to_numpy(state, params, plan, shapes, mesh)[0]
    want = np.asarray(out[0])
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=5e-4 * np.abs(want).max())
    np.testing.assert_allclose(np.sqrt(float(ss[0])), float(out[-1]),
                               rtol=5e-4)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

LINE = re.compile(r"^iter: (\d+) residual: (\S+) Took (\d+)ms")


def _conf(tmp_path, mode=0, dims=(15, 15, 15), maxiter=3):
    toks = open(CONF).read().split()
    toks[0] = str(maxiter)
    toks[2:5] = [str(d) for d in dims]
    toks[5] = str(mode)
    path = tmp_path / f"m{mode}.conf"
    path.write_text(" ".join(toks))
    return str(path)


@pytest.mark.parametrize("fuse,engine", [
    ("auto", "pod"), ("pod", "pod"), ("leg", "leg"),
])
def test_cli_fuse(tmp_path, capsys, fuse, engine):
    """--mesh 1,1,1 with --fuse auto resolves to the pod engine and says
    so under --explain-backend (the JAX CLI's line); --fuse pod runs it;
    --fuse leg keeps the per-leg engine; each prints the reference's
    progress lines and the same history."""
    path = _conf(tmp_path)
    assert cli.main([path, "--mesh", "1,1,1", "--platform", "cpu",
                     "--explain-backend", "--fuse", fuse]) == 0
    out, err = capsys.readouterr()
    lines = out.splitlines()
    assert lines[1] == "Solving linear problem"
    assert lines[2].startswith("Inital residual: ")
    iters = [LINE.match(ln) for ln in lines[3:]]
    assert len(iters) == 3 and all(iters)
    assert f"backend: dist-engine=spmd fuse={engine} halo=ppermute" in err
    if fuse == "auto":
        assert "backend: fuse=auto -> pod" in err
    assert ("backend: pod depth 1" in err) == (engine == "pod")
    params = gt.parse_config(path, print_progress=False)
    want = gt.solve(gt.build_grid(params, device="cpu"), params)[1]
    res = [float(m.group(2)) for m in iters]
    np.testing.assert_allclose(res, want[1:], rtol=1e-4)


def test_cli_fuse_auto_reasons(tmp_path, capsys):
    """--fuse auto keeps the per-leg engine, with the reason, where the
    pod engine cannot run: --backend ref (the plain ops), a geometry no
    pod depth passes (pre-smoothing past the leg's sweep cap)."""
    path = _conf(tmp_path, maxiter=1)
    assert cli.main([path, "--mesh", "1,1,1", "--platform", "cpu",
                     "--explain-backend", "--backend", "ref"]) == 0
    assert "fuse=auto -> leg (--backend ref" in capsys.readouterr().err
    toks = open(path).read().split()
    toks[6] = "6"  # pre-smoothing
    path6 = tmp_path / "pre6.conf"
    path6.write_text(" ".join(toks))
    assert cli.main([str(path6), "--mesh", "1,1,1", "--platform", "cpu",
                     "--explain-backend"]) == 0
    assert "fuse=auto -> leg (geometry/mode outside the pod gates)" in \
        capsys.readouterr().err
