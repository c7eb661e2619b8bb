"""The per-leg engine's replicated tail (``tail="pv2"``, the JAX package's
default plan on its accelerator; dist/spmd.py) on the CPU, in float32:

  * the plan: ``_choose_tail_nd``'s depth pinned at 511³ on four meshes,
    ``tail="auto"`` keeping the classic plan on the CPU, V(6,6) keeping it
    under ``tail="pv2"`` (the batch engine's sweep cap, as the
    reference's eligibility), the junction legs' gates, the tail visits
    of a W cycle, and --explain-backend's lines for the tail plan;
  * ``launches_per_cycle`` of the tail plan against the launches a cycle
    makes (the engine's kernel route forced on CPU tensors, each
    wrapper's plain version counted), with the junction legs accepted and
    with the up leg refused (V(5,5): the corr-first leg takes 4 sweeps);
  * the tail plan against the classic plan (``tail="off"``) on the one
    rank mesh in LINEAR, FAS and NEWTON, a W cycle and a refused junction
    gate, to rtol 2e-3 and atol 1e-6·h₀ (h₀ the initial residual: the two
    plans restrict in other orders, and the float32 histories part by
    rounding);
  * two gloo ranks, one spawn: the (2, 1, 1) mesh in the three modes and
    the y-split (1, 2, 1) mesh against the classic plan, the JAX package's
    own ``tail="pv2"`` solve (31³ LINEAR, the one JAX tail solve here)
    fed the same seeded state through ``interop``, and a checkpoint round
    trip through the tail plan, each rank's blocks gathered to rank 0 and
    cut back out, bit for bit.

The JAX package is imported inside the functions that use it, so the
spawned ranks import torch only.
"""

import functools
import os
import time

import numpy as np
import pytest
import torch

import gpusolve_tpu_torch as gt
from gpusolve_tpu_torch import interop
from gpusolve_tpu_torch.dist import spmd as tsp
from gpusolve_tpu_torch.ops import kernels, rdma
from gpusolve_tpu_torch.ops import spmd_kernels as sk
from gpusolve_tpu_torch.ops import spmd_leg as sl
from gpusolve_tpu_torch.utils import checkpoint

RTOL, ATOL = 2e-3, 1e-6
WORLD = 2
JAX_CASE = dict(mode=0, dims=(31, 31, 31), cutoff=4, maxiter=2, seed=5)


def _kw(mode, dims, cycle="V", maxiter=4, pre=2, post=2):
    return dict(maxiter=maxiter, tol=1e-30, grid_dim=dims, mode=mode,
                pre_smoothing=pre, post_smoothing=post, omega=0.8,
                gamma=1.0, print_progress=False, dtype="float32",
                cycle_type=cycle)


def _params(mode, dims=(31, 31, 31), cycle="V", maxiter=4, pre=2, post=2):
    return gt.GridParams(stencil=gt.Stencil.poisson_7pt(),
                         **_kw(mode, dims, cycle, maxiter, pre, post))


def _cpu_mesh():
    return gt.make_mesh((1, 1, 1), device="cpu")


def _solve(params, mesh, tail, cutoff=3, state=None, plan=None,
           initial_residual=None):
    if params.mode == gt.Mode.NEWTON:
        return gt.newton_solve_spmd(params, mesh, cutoff=cutoff, tail=tail,
                                    state=state, plan=plan,
                                    initial_residual=initial_residual)
    return gt.solve_spmd(params, mesh, cutoff=cutoff, tail=tail, state=state,
                         plan=plan, initial_residual=initial_residual)


def _agree(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got, want)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * want[0],
                               err_msg=what)


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

# mesh -> (tail depth, classic depth) at 511³ V(3,3), cutoff 4.
DEPTHS_511 = {(1, 1, 1): (1, 7), (2, 1, 1): (2, 6), (4, 1, 1): (2, 5),
              (2, 2, 1): (3, 6)}


@pytest.mark.parametrize("mesh_shape", list(DEPTHS_511))
def test_choose_tail_nd_511(mesh_shape):
    """``_choose_tail_nd`` on the port's dense volumes at 511³: one rank
    takes depth 1 (the 514³ block halving to the 257³ root, the tail in
    place); larger meshes go deeper, ending at levels whose blocks are
    small beside the tail every rank runs whole."""
    p = _params(0, (511, 511, 511), pre=3, post=3)
    tail_nd, classic_nd = DEPTHS_511[mesh_shape]
    classic = tsp.SpmdPlan(p, mesh_shape, 4)
    assert classic.n_dist == classic_nd and classic.tail_pv2 is None
    assert tsp._choose_tail_nd(p, mesh_shape, 4, classic.n_dist) == tail_nd
    plan = tsp.SpmdPlan(p, mesh_shape, 4, force_nd=tail_nd)
    assert plan.n_dist == tail_nd
    assert plan.tail_pv2 == tuple(n + 2 for n in plan.dims[tail_nd])
    assert plan.tail_in_place == (mesh_shape == (1, 1, 1))
    if mesh_shape == (1, 1, 1):
        assert plan.block == [(514, 514, 514)]
        assert plan.shape(1) == (257, 257, 257)
    # Every leg runs, the junction's both ways.
    assert plan.fused_down_levels == tuple(range(tail_nd))
    assert plan.fused_up_levels == tuple(range(1, tail_nd + 1))


def test_tail_engages_where_asked():
    """``tail="auto"`` keeps the classic plan on the CPU (the kernels do
    not run there); ``"pv2"`` engages the tail in float32 only and not
    with ``local_backend="xla"``, as the reference; V(6,6) keeps the
    classic plan under ``"pv2"`` (the batch engine's sweep cap refuses
    the tail's cycle); ``"off"`` is the classic plan."""
    mesh = _cpu_mesh()
    p = _params(0)
    for kw, engaged in (({"tail": "auto"}, False), ({"tail": "off"}, False),
                        ({"tail": "pv2"}, True),
                        ({"tail": "pv2", "local_backend": "xla"}, False)):
        eng = tsp.build_spmd_solver(p, mesh, 3, **kw)
        assert (eng.plan.tail_pv2 is not None) == engaged, kw
    eng = tsp.build_spmd_solver(p.replace(dtype="float64"), mesh, 3,
                                tail="pv2")
    assert eng.plan.tail_pv2 is None
    v66 = p.replace(pre_smoothing=6, post_smoothing=6)
    classic = tsp.SpmdPlan(v66, (1, 1, 1), 3)
    assert tsp._choose_tail_nd(v66, (1, 1, 1), 3, classic.n_dist) is None
    eng = tsp.build_spmd_solver(v66, mesh, 3, tail="pv2")
    assert eng.plan.tail_pv2 is None and eng.plan.n_dist == classic.n_dist
    # The engine is cached on the plan per tail form.
    eng = tsp.build_spmd_solver(p, mesh, 3, tail="pv2")
    assert tsp._engine(p, mesh, 3, eng.plan, "auto", tail="pv2") is eng
    assert tsp._engine(p, mesh, 3, eng.plan, "auto", tail="off") is not eng


def test_tail_visits_w_cycle():
    """A W cycle's two visits of the tail: the first fresh (after the
    junction's restriction), the second continuing from it."""
    plan = tsp.SpmdPlan(_params(0, cycle="W"), (1, 1, 1), 3, force_nd=1)
    visits = list(plan.visits("W"))
    assert visits == [("down", 0, False, "W"), ("tail", 1, True, "W"),
                      ("tail", 1, False, "W"), ("up", 1, False, "W")]
    f = tsp.SpmdPlan(_params(0, cycle="F"), (1, 1, 1), 3, force_nd=1)
    assert [v for v in f.visits("F") if v[0] == "tail"] == [
        ("tail", 1, True, "F"), ("tail", 1, False, "V")]


@pytest.mark.parametrize("post,refused", [(2, None),
                                           (5, "fused-up refused: 5 sweeps")])
def test_explain_backend_tail_lines(post, refused):
    """--explain-backend's lines for the tail plan: the reference's
    replicated-tail line, worded for the batch engine, and a refused
    junction gate named on its level's line."""
    from gpusolve_tpu_torch import cli

    p = _params(0, pre=post, post=post)
    eng = tsp.build_spmd_solver(p, _cpu_mesh(), 3, tail="pv2")
    args = cli.build_argparser().parse_args(["x.conf", "--fuse", "leg"])
    lines = []
    cli._spmd_notes(p, eng, args, lines.extend)
    assert ("replicated tail: ONE batch-engine cycle a visit from level 1 "
            "(ops/vcycle_batch.run_tail; direct layout (17, 17, 17), in "
            "place on the boundary block)") in lines
    level0 = [ln for ln in lines if ln.startswith("level 0: ")]
    assert len(level0) == 1
    if refused is None:
        assert level0[0].endswith("(fused-down, fused-up)")
    else:
        assert "(fused-down); " + refused in level0[0]


# ---------------------------------------------------------------------------
# Launch counts
# ---------------------------------------------------------------------------

PLAIN = {
    kernels: ("jacobi_sweep", "residual", "restrict_zero", "restrict",
              "prolong_add", "apply_fas", "subtract", "finalize",
              "down_leg", "up_leg"),
    sl: ("leg_block",),
    sk: ("sweep_block", "residual_block", "residual_restrict_block",
         "prolong_add_block"),
    rdma: ("rdma_exchange",),
}


def _base(name):
    """The kernel of a launch counter's name (``residual_fas`` ->
    ``residual``)."""
    for base in (name.removesuffix("_fas"), name.removesuffix("_newton")):
        if base != name and base in kernels.KERNELS:
            return base
    return name


@pytest.mark.parametrize("mode,cycle,post,halo", [
    (0, "V", 2, "ppermute"), (1, "V", 2, "ppermute"), (2, "V", 2, "rdma"),
    (1, "W", 2, "ppermute"), (0, "V", 5, "ppermute"),
], ids=["linear", "fas", "newton-rdma", "fas-w", "linear-v55"])
def test_launches_per_cycle_counted(monkeypatch, mode, cycle, post, halo):
    """One cycle of the tail plan on the engine's kernel route (forced on
    CPU tensors, so each wrapper runs its plain version, counted here)
    makes the launches ``launches_per_cycle`` counts: the junction legs
    (the FAS up leg after a ``subtract``), one batch-engine cycle of the
    tail a visit, the finalize; at V(5,5) the junction's up leg is
    refused and runs per op (``prolong_add_block``, then its sweeps as one
    leg with the norm)."""
    p = _params(mode, (15, 15, 15), cycle, pre=post, post=post)
    eng = tsp.SpmdEngine(p, _cpu_mesh(), 3, halo=halo, tail="pv2")
    assert eng.plan.n_dist == 1 and eng.plan.tail_pv2 is not None
    assert eng.plan.fused_down_levels == (0,)
    assert eng.plan.fused_up_levels == ((1,) if post <= 4 else ())
    eng.plain_reason = None
    state = eng.init_state()
    out = torch.empty(1)
    eng.cycle(state, out)  # the first cycle of a Newton step reads ũ = 0
    counted = {}
    depth = [0]  # the plain ops a plain leg runs inside it are no launch
    for mod, names in PLAIN.items():
        for name in names:
            fn = getattr(mod, f"{name}_plain")

            def count(*a, _fn=fn, _name=name, **k):
                if depth[0] == 0:
                    counted[_name] = counted.get(_name, 0) + 1
                depth[0] += 1
                try:
                    return _fn(*a, **k)
                finally:
                    depth[0] -= 1

            monkeypatch.setattr(mod, f"{name}_plain", count)
    eng.cycle(state, out)
    want = {}
    for name, n in tsp.launches_per_cycle(eng.plan).items():
        want[_base(name)] = want.get(_base(name), 0) + n
    assert counted == want


# ---------------------------------------------------------------------------
# The tail plan against the classic plan, one rank
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,cycle,post", [
    (0, "V", 2), (1, "V", 2), (2, "V", 2), (0, "W", 2), (1, "V", 5),
], ids=["linear", "fas", "newton", "linear-w", "fas-v55"])
def test_one_rank_tail_matches_classic(mode, cycle, post):
    """The tail plan's history against the classic plan's at 31³: every
    mode, a W cycle (the second tail visit continues from the first),
    and V(5,5), whose junction up leg is refused and runs per op."""
    p = _params(mode, cycle=cycle, maxiter=3 if mode == 2 else 4, pre=post,
                post=post)
    mesh = _cpu_mesh()
    _, got, plan = _solve(p, mesh, "pv2")
    _, want, classic = _solve(p, mesh, "off")
    assert plan.n_dist == 1 and classic.n_dist > 1
    assert plan.fused_down_levels == (0,)
    assert plan.fused_up_levels == ((1,) if post <= 4 else ())
    _agree(got, want, f"mode {mode} {cycle} V({post},{post})")


# ---------------------------------------------------------------------------
# Two gloo ranks
# ---------------------------------------------------------------------------

# name -> (mesh, mode, dims, cutoff, depth); each solves with the tail (at
# _choose_tail_nd's depth, 1 at these sizes, or the depth given, through a
# plan passed in) and with the classic plan.
RANK_CASES = {
    "x-linear": ((2, 1, 1), 0, (31, 31, 31), 3, None),
    "x-fas": ((2, 1, 1), 1, (31, 31, 31), 3, None),
    "x-newton": ((2, 1, 1), 2, (31, 31, 31), 3, None),
    "y-linear": ((1, 2, 1), 0, (31, 31, 31), 3, None),
    "x-fas-depth2": ((2, 1, 1), 1, (31, 31, 31), 3, 2),
}


@functools.lru_cache(maxsize=None)
def _seeded_jax_state():
    """The JAX tail plan's initial state at the JAX case, level 0's v
    seeded in its interior (numpy arrays), the JAX plan's depth and its
    params."""
    from gpusolve_tpu.config import GridParams, Stencil
    from gpusolve_tpu.dist import spmd as jsp
    from gpusolve_tpu.dist.mesh import make_mesh

    c = JAX_CASE
    params = GridParams(stencil=Stencil.poisson_7pt(),
                        **_kw(c["mode"], c["dims"], maxiter=c["maxiter"]))
    init_fn, _, plan = jsp.build_spmd_solver(
        params, make_mesh((2, 1, 1)), c["cutoff"], tail="pv2")
    arrays = [np.array(a) for a in init_fn()]
    nx, ny, nz = c["dims"]
    rng = np.random.default_rng(c["seed"])
    arrays[0][1:nx + 1, 1:ny + 1, 1:nz + 1] = rng.normal(
        scale=0.05, size=(nx, ny, nz)).astype(np.float32)
    return arrays, plan.n_dist, params


@functools.lru_cache(maxsize=None)
def _jax_tail_history():
    from gpusolve_tpu.dist import spmd as jsp
    from gpusolve_tpu.dist.mesh import make_mesh

    arrays, _, params = _seeded_jax_state()
    _, hist, plan = jsp.solve_spmd(
        params, make_mesh((2, 1, 1)), JAX_CASE["cutoff"],
        state=tuple(arrays), tail="pv2")
    assert plan.tail_pv2 is not None
    return np.asarray(hist)


def _rank_main(rank, store_path, out_dir):
    torch.set_num_threads(1)
    store = torch.distributed.FileStore(store_path, WORLD)
    torch.distributed.init_process_group(
        "gloo", store=store, rank=rank, world_size=WORLD
    )
    try:
        out = {}
        for name, (shape, mode, dims, cutoff, nd) in RANK_CASES.items():
            mesh = gt.make_mesh(shape, device="cpu")
            p = _params(mode, dims, maxiter=3 if mode == 2 else 4)
            plan = None
            if nd is not None:
                eng = tsp.SpmdEngine(p, mesh, cutoff, tail="pv2", plan=(
                    tsp.SpmdPlan(p, shape, cutoff, force_nd=nd)))
                plan = eng.plan
                plan._engine = eng
            _, tail, plan = _solve(p, mesh, "pv2", cutoff, plan=plan)
            assert nd is None or plan.n_dist == nd
            _, classic, cplan = _solve(p, mesh, "off", cutoff)
            out[name] = np.asarray(tail)
            out[name + "/classic"] = np.asarray(classic)
            out[name + "/plan"] = np.asarray(
                [plan.n_dist, cplan.n_dist, int(plan.tail_in_place)]
                + list(plan.fused_down_levels) + [-1]
                + list(plan.fused_up_levels))
        # The JAX package's seeded tail-plan state, through interop.
        mesh = gt.make_mesh((2, 1, 1), device="cpu")
        c = JAX_CASE
        p = _params(c["mode"], c["dims"], maxiter=c["maxiter"])
        with np.load(os.path.join(out_dir, "jax_state.npz")) as z:
            arrays = [z[f"a{i}"] for i in range(len(z.files))]
        eng = tsp.build_spmd_solver(p, mesh, c["cutoff"], tail="pv2")
        state = interop.spmd_state_from_numpy(p, eng.plan, arrays, mesh)
        _, hist, plan = gt.solve_spmd(p, mesh, c["cutoff"], state=state,
                                      plan=eng.plan, tail="pv2")
        out["jax"] = np.asarray(hist)
        out["jax/depth"] = np.asarray(plan.n_dist)
        # A checkpoint round trip through the tail plan: 2 cycles, saved
        # and loaded, 2 more, against 4 straight.
        p = _params(1, (31, 31, 31), maxiter=4)
        _, full, _ = gt.solve_spmd(p, mesh, 3, tail="pv2")
        eng = tsp.build_spmd_solver(p, mesh, 3, tail="pv2")
        st, h1, plan = gt.solve_spmd(p.replace(maxiter=2), mesh, 3,
                                     tail="pv2")
        path = os.path.join(out_dir, "ck.npz")
        checkpoint.save_state_spmd(path, st, plan, p, "spmd/leg",
                                   iteration=2, history=h1, mesh=mesh)
        st2, it, h0, _ = checkpoint.load_state_spmd(path, p, eng.plan,
                                                    "spmd/leg", mesh=mesh)
        _, h2, _ = gt.solve_spmd(p.replace(maxiter=2), mesh, 3, state=st2,
                                 plan=eng.plan, initial_residual=h0[0],
                                 tail="pv2")
        out["ck"] = np.asarray(h0 + h2)
        out["ck/full"] = np.asarray(full)
        if rank == 0:
            np.savez(os.path.join(out_dir, "ranks.npz"), **out)
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks' results, spawned once; the JAX tail solve runs here
    while the ranks work."""
    out = tmp_path_factory.mktemp("tail")
    arrays, jax_depth, _ = _seeded_jax_state()
    np.savez(out / "jax_state.npz",
             **{f"a{i}": a for i, a in enumerate(arrays)})
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(str(out / "store"), str(out)), nprocs=WORLD,
        join=False, start_method="spawn",
    )
    jax_hist = _jax_tail_history()
    deadline = time.monotonic() + 600
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.terminate()
            pytest.fail("the ranks did not finish")
    with np.load(out / "ranks.npz") as z:
        res = {k: z[k] for k in z.files}
    res["jax/want"], res["jax/want_depth"] = jax_hist, jax_depth
    return res


@pytest.mark.parametrize("name", list(RANK_CASES))
def test_ranks_tail_matches_classic(ranks, name):
    """On two ranks (x split, y split) every leg runs, the junction's both
    ways, each rank's halved block gathered into the root and its window
    cut back out; the history agrees with the classic plan's."""
    info = [int(x) for x in ranks[name + "/plan"]]
    nd, classic_nd, in_place = info[:3]
    down = tuple(info[3:info.index(-1)])
    up = tuple(info[info.index(-1) + 1:])
    assert nd >= 1 and classic_nd > nd and not in_place
    assert down == tuple(range(nd)) and up == tuple(range(1, nd + 1))
    _agree(ranks[name], ranks[name + "/classic"], name)


def test_ranks_tail_matches_jax(ranks):
    """The port's tail plan on (2, 1, 1) gloo ranks and the JAX package's
    ``tail="pv2"`` (its pv2 tail in interpret mode) pick the same depth
    and, from the same seeded state, agree."""
    assert int(ranks["jax/depth"]) == ranks["jax/want_depth"] == 1
    _agree(ranks["jax"], ranks["jax/want"], "port vs JAX tail plan")


def test_ranks_checkpoint_round_trip(ranks):
    """2 cycles, a checkpoint (each rank's blocks gathered to rank 0) and
    its load (cut back out), 2 more: the 4-cycle history, bit for bit."""
    assert np.array_equal(ranks["ck"], ranks["ck/full"]), (
        ranks["ck"], ranks["ck/full"])
