"""The port's distributed per-leg engine (gpusolve_tpu_torch/dist) against
the JAX package's explicit spmd engine (gpusolve_tpu/dist/spmd.py, its
XLA local path) on the same mesh, in float64 to rtol 1e-10:

  * ``SpmdPlan`` field by field (pure Python);
  * a (1, 1, 1) mesh in this process, LINEAR, FAS and Newton;
  * (2, 2, 1), (1, 2, 2) and (4, 1, 1) meshes (the second folds z into
    y) on 4 gloo ranks, with the trapezoid legs engaged wherever the plan's
    gates allow (y-split slabs on the first two, x slabs only on the
    third): one ``torch.multiprocessing`` spawn per mesh runs every case
    (LINEAR, FAS, Newton, W and F cycles, ``check_every=3``) and returns
    the histories and gathered solutions, which are held against the JAX
    engine and the port's own single-device solve; the (2, 2, 1) spawn
    also runs V(6,6) on the per-op kernel route (the wrappers' plain
    versions on CPU tensors) and on the plain route;
  * ``halo="rdma"`` in the same spawns (the cases named ``*_rdma``): on
    (4, 1, 1) the legs' x slabs through ``ops/rdma.rdma_exchange``, whose
    plain version runs on CPU tensors, bit-identical to ``halo="ppermute"``;
    on (2, 2, 1) the y split leaves ``plan.rdma_active`` False; and the
    plain exchange of two seeded fields on the (4, 1, 1) ranks against
    JAX's ``pallas_spmd.rdma_exchange`` in interpret mode, exactly;
  * the interop converters, and a port solve resumed from a JAX state.

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
from gpusolve_tpu_torch.dist import mesh as tmesh
from gpusolve_tpu_torch.dist import spmd as tsp
from gpusolve_tpu_torch.ops import kernels, rdma

RTOL = 1e-10
WORLD = 4
# name -> (mode, dims, cycle, cutoff, check_every), per mesh.  Each case
# distributes two levels or more, so the fused residual-restriction, the
# junction and the replicated levels all run.  A name ending in "_rdma"
# runs halo="rdma" (else "ppermute"); RDMA_BASE names its ppermute twin.
CASES = {
    (2, 2, 1): {
        "linear": (0, (31, 31, 31), "V", 4, 1),
        "linear_k3": (0, (31, 31, 31), "V", 4, 3),
        "fas": (1, (15, 15, 15), "V", 3, 1),
        "newton": (2, (15, 15, 15), "V", 3, 1),
        "w": (0, (15, 15, 15), "W", 3, 1),
        "f_fas": (1, (15, 15, 15), "F", 3, 1),
    },
    (1, 2, 2): {
        "linear": (0, (15, 31, 15), "V", 4, 1),
        "newton": (2, (15, 31, 15), "V", 3, 1),
    },
    (4, 1, 1): {
        "linear": (0, (63, 63, 63), "V", 3, 1),
        "fas": (1, (31, 31, 31), "V", 3, 1),
    },
}
RDMA_BASE = {(4, 1, 1): ("linear", "fas"), (2, 2, 1): ("fas",)}
for _m, _names in RDMA_BASE.items():
    for _n in _names:
        CASES[_m][f"{_n}_rdma"] = CASES[_m][_n]
# The plain exchange's fields on the (4, 1, 1) ranks: each rank's block of
# two seeded (4·16, 8, 128) arrays (the smallest shape JAX's
# rdma_exchange takes), slabs 8 planes deep.
EXCHANGE_BLOCK, EXCHANGE_G = (16, 8, 128), 8


# The card's per-op route on CPU tensors, in the (2, 2, 1) spawn: name ->
# (mode, dims, cutoff), at V(6,6), past the legs' sweep cap, so every
# distributed level runs per op; the engine's kernel path forced, so the
# kernels' wrappers run their plain versions (CPU tensors) and the per-op
# glue (the y restriction, the lower-x fix-up, the FAS tau) runs across
# ranks as on the card.
ROUTE_CASES = {
    "linear_v66": (0, (31, 31, 31), 4),
    "fas_v66": (1, (15, 15, 15), 3),
}


def _kw(mode, dims, cycle="V", maxiter=4):
    return dict(maxiter=maxiter, tol=1e-30, grid_dim=dims, mode=mode,
                pre_smoothing=2, post_smoothing=2, omega=0.8, gamma=1.0,
                print_progress=False, dtype="float64", cycle_type=cycle)


def _tparams(mode, dims, cycle="V", maxiter=4):
    return gt.GridParams(stencil=gt.Stencil.poisson_7pt(),
                         **_kw(mode, dims, cycle, maxiter))


def _port_solve(params, mesh, cutoff, check_every=1, halo="ppermute"):
    if params.mode == gt.Mode.NEWTON:
        return gt.newton_solve_spmd(params, mesh, cutoff=cutoff,
                                    check_every=check_every, halo=halo)
    return gt.solve_spmd(params, mesh, cutoff=cutoff,
                         check_every=check_every, halo=halo)


def _exchange_fields(m):
    """The two seeded global arrays of the plain exchange check."""
    bx, by, bz = EXCHANGE_BLOCK
    rng = np.random.default_rng(0)
    return [rng.normal(size=(m * bx, by, bz)).astype(np.float32)
            for _ in range(2)]


# A 7-point stencil with one (1, 1, 0) edge tap in place of a face tap.
CORNER = ((6.0, -1.0, -1.0, -1.0, -1.0, -1.0, -1.0),
          ((0, 0, 0), (1, 1, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
           (0, 0, 1), (0, 0, -1)))


@functools.lru_cache(maxsize=None)
def _jax_run(mesh_shape, mode, dims, cycle, cutoff, maxiter=4,
             stencil=None):
    """The JAX engine's history and gathered solution (cached per
    module run: each configuration compiles once)."""
    from gpusolve_tpu.config import GridParams, Stencil
    from gpusolve_tpu.dist import spmd as jsp
    from gpusolve_tpu.dist.mesh import make_mesh

    st = Stencil.poisson_7pt() if stencil is None else Stencil(
        values=stencil[0], offsets=stencil[1])
    params = GridParams(stencil=st, **_kw(mode, dims, cycle, maxiter))
    mesh = make_mesh(mesh_shape)
    run = jsp.newton_solve_spmd if mode == 2 else jsp.solve_spmd
    state, hist, plan = run(params, mesh, cutoff=cutoff,
                            local_backend="xla")
    sol = jsp.gather_solution(state, plan, mesh, which=2 if mode == 2 else 0)
    return np.asarray(hist), sol


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=RTOL * np.abs(want).max(), err_msg=what)


# ---------------------------------------------------------------------------
# The plan and the mesh
# ---------------------------------------------------------------------------


# The port's leg gates per plan: (fused_down_levels, fused_up_levels).
# The JAX engine's own values are the TPU's (its tiling gates), so these
# are the port's gates at each geometry.
FUSED = {
    ((31, 31, 31), (2, 2, 1), 4): ((0,), (1,)),
    ((15, 15, 15), (2, 2, 1), 3): ((0,), (1,)),
    ((15, 31, 15), (1, 2, 2), 4): ((), ()),
    ((511, 511, 511), (1, 1, 1), 4): ((0, 1, 2, 3, 4, 5), (1, 2, 3, 4, 5, 6)),
    ((127, 63, 255), (2, 2, 2), 4): ((0,), (1,)),
    ((63, 63, 63), (4, 1, 1), 2): ((0, 1), (1, 2)),
}


@pytest.mark.parametrize("dims,mesh_shape,cutoff", list(FUSED))
def test_plan_matches_jax(dims, mesh_shape, cutoff):
    from gpusolve_tpu.config import GridParams, Stencil
    from gpusolve_tpu.dist.spmd import SpmdPlan

    kw = _kw(0, dims)
    jp = SpmdPlan(GridParams(stencil=Stencil.poisson_7pt(), **kw),
                  mesh_shape, cutoff)
    tp = gt.SpmdPlan(_tparams(0, dims), mesh_shape, cutoff)
    assert tp.n_dist == jp.n_dist and tp.nlev == jp.nlev
    assert tp.mesh_shape == jp.mesh_shape
    assert tp.device_mesh == jp.device_mesh and tp.names == jp.names
    assert tp.alloc[:tp.n_dist] == jp.alloc[:jp.n_dist]
    assert tp.block == jp.block and tp.dims == jp.dims
    # Replicated levels: the port's dense padded layout.
    assert tp.alloc[tp.n_dist:] == [tuple(n + 2 for n in d)
                                   for d in tp.dims[tp.n_dist:]]
    assert (tp.fused_down_levels, tp.fused_up_levels) == \
        FUSED[dims, mesh_shape, cutoff]
    # local_backend="xla" runs the per-op path: no leg.
    xla = gt.SpmdPlan(_tparams(0, dims), mesh_shape, cutoff, "xla")
    assert xla.fused_down_levels == () and xla.fused_up_levels == ()


def test_factor_devices_and_mesh_errors():
    from gpusolve_tpu.dist.mesh import factor_devices

    for n in (1, 2, 4, 6, 8, 12, 16):
        assert tmesh.factor_devices(n) == factor_devices(n)
    mesh = gt.make_mesh((1, 1, 1), device="cpu")
    assert mesh.coords == (0, 0, 0) and mesh.group is None
    with pytest.raises(ValueError, match="torchrun"):
        gt.make_mesh((2, 1, 1), device="cpu")
    assert tmesh.coords_of(5, (2, 2, 2)) == (1, 0, 1)
    # A stencil with an edge tap runs on the spmd engine (the plain ops
    # over the assembled block, no leg), as the JAX engine's assembled-halo
    # path: the histories agree to rtol 1e-10 in float64.
    corner = _tparams(0, (15, 15, 15)).replace(stencil=gt.Stencil(
        values=CORNER[0], offsets=CORNER[1]
    ))
    state, hist, plan = gt.solve_spmd(corner, mesh, cutoff=3)
    assert plan.fused_down_levels == () and plan.fused_up_levels == ()
    want_hist, want_sol = _jax_run((1, 1, 1), 0, (15, 15, 15), "V", 3,
                                   stencil=CORNER)
    _close(hist, want_hist, "edge-tap history")
    _close(tsp.gather_solution(state, plan, mesh), want_sol,
           "edge-tap solution")


KEYWORDS = [
    ({}, None), ({"local_backend": "pallas"}, None),
    ({"local_backend": "xla"}, None), ({"tail": "off"}, None),
    ({"halo": "ppermute", "fuse": "leg", "tail": "auto"}, None),
    ({"fuse": "pod"}, None),
    ({"halo": "rdma"}, None),
    ({"tail": "pv2"}, None),
    ({"fuse": "wide"}, "fuse must be 'leg' or 'pod'"),
    ({"halo": "nccl"}, "halo must be 'ppermute' or 'rdma'"),
    ({"tail": "on"}, "tail must be 'auto', 'pv2' or 'off'"),
    ({"local_backend": "cuda"}, "local_backend must be one of"),
]


@pytest.mark.parametrize("kw,error", KEYWORDS,
                         ids=[f"{k}" for k, _ in KEYWORDS])
def test_spmd_keywords(kw, error):
    """build_spmd_solver, solve_spmd and newton_solve_spmd take the
    reference's local_backend, halo, fuse and tail keywords: every value
    runs (``"xla"`` without legs; ``fuse="pod"`` the pod engine, every pod
    level on legs; ``tail="pv2"`` in float64 the classic plan, as the
    reference's tail takes float32 only), unknown values raise
    ValueError."""
    mesh = gt.make_mesh((1, 1, 1), device="cpu")
    lin, newt = _tparams(0, (15, 15, 15), maxiter=1), \
        _tparams(2, (15, 15, 15), maxiter=1)
    calls = (
        lambda: tsp.build_spmd_solver(lin, mesh, 3, **kw),
        lambda: gt.solve_spmd(lin, mesh, cutoff=3, **kw),
        lambda: gt.newton_solve_spmd(newt, mesh, cutoff=3, **kw),
    )
    if error is not None:
        for call in calls:
            with pytest.raises(ValueError, match=error):
                call()
        return
    eng = calls[0]()
    legs = kw.get("local_backend") != "xla"
    assert bool(eng.plan.fused_down_levels) == legs
    _, hist, _ = calls[1]()
    want, _ = _jax_run((1, 1, 1), 0, (15, 15, 15), "V", 3, maxiter=1)
    _close(hist, want, f"{kw} history")
    _, nhist, _ = calls[2]()
    assert len(nhist) == 2 and nhist[1] < nhist[0]


# ---------------------------------------------------------------------------
# One rank
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,dims", [
    (1, (15, 15, 15)), (2, (15, 15, 15)), (0, (31, 31, 31)),
], ids=["fas15", "newton15", "linear31"])
def test_one_rank_matches_jax(mode, dims):
    mesh = gt.make_mesh((1, 1, 1), device="cpu")
    kernels.reset_launches()
    state, hist, plan = _port_solve(_tparams(mode, dims), mesh, 3)
    want_hist, want_sol = _jax_run((1, 1, 1), mode, dims, "V", 3)
    _close(hist, want_hist, "history")
    sol = tsp.gather_solution(state, plan, mesh, which=2 if mode == 2 else 0)
    _close(sol, want_sol, "solution")
    assert all(n == 0 for n in kernels.launches.values())


def test_interop_round_trip_and_resume():
    """A JAX state after two cycles goes into the port's blocks (on the
    one-rank mesh, and each rank's block of a (2, 2, 1) mesh) and back to
    the JAX arrays; the port then runs two more cycles from it and
    matches the JAX engine's uninterrupted four."""
    from gpusolve_tpu.config import GridParams, Stencil
    from gpusolve_tpu.dist import spmd as jsp
    from gpusolve_tpu.dist.mesh import make_mesh

    dims, cutoff = (15, 15, 15), 3
    jparams = GridParams(stencil=Stencil.poisson_7pt(),
                         **_kw(1, dims, maxiter=2))
    jstate, jhist, jplan = jsp.solve_spmd(
        jparams, make_mesh((1, 1, 1)), cutoff=cutoff, local_backend="xla"
    )
    arrays = [np.asarray(a) for a in jstate]
    params = _tparams(1, dims, maxiter=2)
    mesh = gt.make_mesh((1, 1, 1), device="cpu")
    plan = gt.SpmdPlan(params, (1, 1, 1), cutoff)
    state = interop.spmd_state_from_numpy(params, plan, arrays, mesh)
    back = interop.spmd_state_to_numpy(state, params, plan)
    assert len(back) == len(arrays)
    for a, b in zip(back, arrays):
        assert a.shape == b.shape and np.array_equal(a, b)

    # Each rank's block of a (2, 2, 1) mesh, from the same global arrays.
    plan4 = gt.SpmdPlan(params, (2, 2, 1), cutoff)
    jplan4 = jsp.SpmdPlan(jparams, (2, 2, 1), cutoff)
    rng = np.random.default_rng(3)
    glob = [rng.standard_normal(s) for s in jplan4.alloc[:plan4.n_dist]
            for _ in "vfr"]
    repl = [np.zeros(interop.jax_alloc_shape(d))
            for d in plan4.dims[plan4.n_dist:] for _ in "vfr"]
    for rank in range(WORLD):
        m = tmesh.Mesh((2, 2, 1), tmesh.coords_of(rank, (2, 2, 1)), rank,
                       None, torch.device("cpu"))
        st = interop.spmd_state_from_numpy(params, plan4, glob + repl, m)
        out = interop.spmd_state_to_numpy(st, params, plan4)
        dx, dy = plan4.data_coords(m.coords)
        for l in range(plan4.n_dist):
            bx, by, _ = plan4.block[l]
            for i in range(3):
                want = glob[3 * l + i][dx * bx:(dx + 1) * bx,
                                       dy * by:(dy + 1) * by]
                assert np.array_equal(out[3 * l + i], want)

    # Resume: two more cycles from the JAX state.
    _, more, _ = gt.solve_spmd(params, mesh, cutoff=cutoff, state=state,
                               plan=plan, initial_residual=jhist[0])
    want_hist, _ = _jax_run((1, 1, 1), 1, dims, "V", cutoff)
    _close(np.asarray(jhist[1:] + more), want_hist[1:], "resumed")


# ---------------------------------------------------------------------------
# Four gloo ranks
# ---------------------------------------------------------------------------


def _rank_main(rank, mesh_shape, store_path, out_dir):
    torch.set_num_threads(1)
    store = torch.distributed.FileStore(store_path, WORLD)
    torch.distributed.init_process_group(
        "gloo", store=store, rank=rank, world_size=WORLD
    )
    try:
        mesh = gt.make_mesh(mesh_shape, device="cpu")
        for name, (mode, dims, cycle, cutoff, k) in CASES[mesh_shape].items():
            halo = "rdma" if name.endswith("_rdma") else "ppermute"
            state, hist, plan = _port_solve(
                _tparams(mode, dims, cycle), mesh, cutoff, k, halo
            )
            sol = tsp.gather_solution(state, plan, mesh,
                                      which=2 if mode == 2 else 0)
            if rank == 0:
                np.savez(os.path.join(out_dir, f"{name}.npz"),
                         hist=np.asarray(hist), sol=sol,
                         launched=sum(kernels.launches.values()),
                         n_dist=plan.n_dist,
                         fused=np.asarray(plan.fused_down_levels + (-1,)),
                         rdma=plan.rdma_active)
        if mesh_shape == (4, 1, 1):
            # The wrapper on CPU tensors runs the plain exchange.
            bx = EXCHANGE_BLOCK[0]
            ex = tsp._Exchange(mesh, gt.SpmdPlan(
                _tparams(0, (63, 63, 63)), mesh_shape, 3))
            blocks = [torch.from_numpy(a[rank * bx:(rank + 1) * bx].copy())
                      for a in _exchange_fields(WORLD)]
            got = rdma.rdma_exchange(blocks, ex, EXCHANGE_G)
            np.savez(os.path.join(out_dir, f"exchange{rank}.npz"),
                     slabs=np.stack([t.numpy() for lo, hi, _, _ in got
                                     for t in (lo, hi)]))
        for name, (mode, dims, cutoff) in (
            ROUTE_CASES.items() if mesh_shape == (2, 2, 1) else ()
        ):
            params = _tparams(mode, dims).replace(pre_smoothing=6,
                                                  post_smoothing=6)
            eng = tsp.SpmdEngine(params, mesh, cutoff)
            eng.plain_reason = None
            eng.plan._engine = eng
            _, hist, plan = gt.solve_spmd(params, mesh, cutoff=cutoff,
                                          plan=eng.plan)
            assert plan._engine is eng
            _, plain, _ = gt.solve_spmd(params, mesh, cutoff=cutoff)
            if rank == 0:
                np.savez(os.path.join(out_dir, f"{name}.npz"),
                         hist=np.asarray(hist), plain=np.asarray(plain),
                         forms=np.asarray([plan.down_form(l)
                                           for l in range(plan.n_dist)]))
        # No rank tears its connections down while a peer still reads.
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()


def _spawn(mesh_shape, out):
    """Every case of one mesh on 4 gloo ranks; rank 0's results."""
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(mesh_shape, str(out / "store"), str(out)),
        nprocs=WORLD, join=False, start_method="spawn",
    )
    deadline = time.monotonic() + 600
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            pytest.fail(f"the {mesh_shape} ranks did not finish")
    results = {}
    for name in CASES[mesh_shape]:
        with np.load(out / f"{name}.npz") as f:
            results[name] = (f["hist"], f["sol"], int(f["launched"]),
                             int(f["n_dist"]), tuple(f["fused"][:-1]),
                             bool(f["rdma"]))
    if mesh_shape == (4, 1, 1):
        results["exchange"] = []
        for rank in range(WORLD):
            with np.load(out / f"exchange{rank}.npz") as f:
                results["exchange"].append(f["slabs"])
    for name in ROUTE_CASES if mesh_shape == (2, 2, 1) else ():
        with np.load(out / f"{name}.npz") as f:
            results[name] = (f["hist"], f["plain"], tuple(f["forms"]))
    return results


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``ranks(mesh_shape)``: the mesh's results, spawned once."""
    cache = {}

    def get(mesh_shape):
        if mesh_shape not in cache:
            cache[mesh_shape] = _spawn(
                mesh_shape, tmp_path_factory.mktemp("spmd")
            )
        return cache[mesh_shape]

    return get


RANK_CASES = [(m, name) for m, cases in CASES.items() for name in cases]
RANK_IDS = [f"{'x'.join(map(str, m))}-{name}" for m, name in RANK_CASES]


@pytest.mark.parametrize("mesh_shape,name", RANK_CASES, ids=RANK_IDS)
def test_ranks_match_jax(ranks, mesh_shape, name):
    mode, dims, cycle, cutoff, _ = CASES[mesh_shape][name]
    hist, sol, launched, n_dist, fused, _ = ranks(mesh_shape)[name]
    want_hist, want_sol = _jax_run(mesh_shape, mode, dims, cycle, cutoff)
    _close(hist, want_hist, f"{name} history")
    _close(sol, want_sol, f"{name} solution")
    assert launched == 0  # CPU tensors run the plain versions
    # The legs ran wherever a level below the junction exists.
    assert fused == tuple(range(n_dist - 1)), fused


@pytest.mark.parametrize("mesh_shape,name", RANK_CASES, ids=RANK_IDS)
def test_ranks_match_single_device(ranks, mesh_shape, name):
    """The same configuration on the port's single-device solve: the
    distributed cycle is the single-device cycle, so the histories agree
    to float64 rounding."""
    mode, dims, cycle, _, _ = CASES[mesh_shape][name]
    params = _tparams(mode, dims, cycle)
    state = gt.build_grid(params, device="cpu")
    if mode == 2:
        _, want = gt.newton_solve(state, params)
    else:
        _, want = gt.solve(state, params)
    _close(ranks(mesh_shape)[name][0], want, f"{name} vs single device")


@pytest.mark.parametrize("name", list(ROUTE_CASES))
def test_ranks_kernel_route(ranks, name):
    """The engine's per-op kernel route on (2, 2, 1) ranks (the wrappers'
    plain versions on CPU tensors, the glue between them exchanging across
    ranks) and its plain route over the assembled block both match the
    port's single-device solve at V(6,6) to rtol 1e-10 in float64."""
    mode, dims, _ = ROUTE_CASES[name]
    hist, plain, forms = ranks((2, 2, 1))[name]
    assert forms[0] == "ops" and forms[-1] == "junction", forms
    params = _tparams(mode, dims).replace(pre_smoothing=6, post_smoothing=6)
    _, want = gt.solve(gt.build_grid(params, device="cpu"), params)
    _close(hist, want, f"{name} kernel route vs single device")
    _close(plain, want, f"{name} plain route vs single device")


RDMA_CASES = [(m, f"{n}_rdma") for m, names in RDMA_BASE.items()
              for n in names]


@pytest.mark.parametrize(
    "mesh_shape,name", RDMA_CASES,
    ids=[f"{'x'.join(map(str, m))}-{name}" for m, name in RDMA_CASES])
def test_ranks_rdma_matches_ppermute(ranks, mesh_shape, name):
    """halo="rdma" gives the ppermute history bit for bit: on (4, 1, 1)
    the legs' x slabs come through the rdma exchange (its plain version
    on CPU tensors); under the (2, 2, 1) y split ``plan.rdma_active`` is
    False and the two-stage exchange runs, as the JAX engine's
    ``use_rdma``."""
    res = ranks(mesh_shape)
    hist, _, _, _, _, active = res[name]
    base, _, _, _, _, base_active = res[name.removesuffix("_rdma")]
    assert active == (mesh_shape[1] == 1) and not base_active
    assert np.array_equal(hist, base), (hist, base)


def test_ranks_rdma_exchange_matches_jax(ranks):
    """The plain exchange on the (4, 1, 1) gloo ranks equals JAX's
    ``pallas_spmd.rdma_exchange`` (interpret mode, the 4-device virtual
    mesh) exactly: per field the lower neighbour's last and the upper
    neighbour's first 8 planes, zeros at the global edges."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from gpusolve_tpu.dist.mesh import make_mesh
    from gpusolve_tpu.dist.spmd import _shard_map, interpret_sync_capacity
    from gpusolve_tpu.ops import pallas_spmd

    if interpret_sync_capacity() < WORLD:
        pytest.skip("4-device in-kernel RDMA exceeds host sync capacity")
    g, (_, _, bz) = EXCHANGE_G, EXCHANGE_BLOCK
    a, b = (jnp.asarray(x) for x in _exchange_fields(WORLD))

    def body(u, w):
        idx = jax.lax.axis_index("x").astype(jnp.int32).reshape(1, 1)
        return tuple(pallas_spmd.rdma_exchange([u, w], idx, g, bz, WORLD,
                                               interpret=True))

    f = jax.jit(_shard_map(body, mesh=make_mesh((WORLD, 1, 1)),
                           in_specs=(P("x"), P("x")),
                           out_specs=tuple([P("x")] * 4)))
    want = [np.asarray(o).reshape((WORLD, g) + EXCHANGE_BLOCK[1:])
            for o in f(a, b)]
    got = ranks((4, 1, 1))["exchange"]
    for rank in range(WORLD):
        for i in range(4):
            assert np.array_equal(got[rank][i], want[i][rank]), (rank, i)
