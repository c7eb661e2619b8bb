"""The port's GSPMD engine (gpusolve_tpu_torch/dist/sharding.py, dist/gspmd.py
and ``shardings=`` on solve, newton_solve and solve_refine) on the CPU:

  * ``level_shardings``' decisions against the JAX function's ``.spec`` on
    the conftest's 8 virtual devices, and every rank's block against the
    ``ceil(n/m)`` split (pure Python);
  * on the one-rank (1,1,1) mesh in this process, every mode against
    the single-device per-op schedule, bit for bit (the path the card
    runs), the fetch a view there, and every op on a 15³ field cut into
    the (2,2,1) boxes by the engine's own box functions, put back
    together, bit for bit against the op on the whole field;
  * 8 gloo ranks, spawned once (``torch.multiprocessing``, a FileStore),
    run every multi-rank case: (2,2,2) at 15³ with cutoff 2 (LINEAR and
    FAS V(3,3), LINEAR W(1,1) and F(1,1), Newton maxiter 2), the uneven
    split (15,31,15) on (2,4,1), and (17,15,15) on (8,1,1), whose last
    blocks are empty; ``solve_refine(shardings=…)`` in LINEAR and NEWTON; a
    checkpoint written on the mesh and one read onto it.  Histories are
    held against the JAX gspmd engine on the same mesh (float64, rtol
    1e-12; its solves run in threads while the ranks run), the gathered
    fields against the port's single-device plain run (LINEAR bit for
    bit, FAS and NEWTON to 1e-12), every rank's tensors against the
    ``ceil(n/m) + 2`` box, the refinement against the float64 oracle
    (tests/test_refine.py's bounds), and the checkpoints against the
    uninterrupted single-device run.

The JAX package is imported inside the functions that use it, so the
spawned ranks import torch only.
"""

import concurrent.futures
import os
import time

import numpy as np
import pytest
import torch

import gpusolve_tpu_torch as gt
from gpusolve_tpu_torch import config as tcfg
from gpusolve_tpu_torch.config import Mode
from gpusolve_tpu_torch.dist import gspmd
from gpusolve_tpu_torch.dist import sharding as tsh
from gpusolve_tpu_torch.dist.mesh import Mesh, coords_of
from gpusolve_tpu_torch.ops import dispatch, ref

WORLD = 8
RTOL = 1e-12
CUTOFF = 2
# name -> (mesh, mode, dims, cycle, maxiter, sweeps); JAX_CASES are held
# against the JAX gspmd engine too (W and F at one sweep a side: the JAX
# package compiles each sweep of their unrolled recursion, at half the
# cost of three).
CASES = {
    "linear": ((2, 2, 2), 0, (15, 15, 15), "V", 3, 3),
    "fas": ((2, 2, 2), 1, (15, 15, 15), "V", 3, 3),
    "w": ((2, 2, 2), 0, (15, 15, 15), "W", 3, 1),
    "f": ((2, 2, 2), 0, (15, 15, 15), "F", 3, 1),
    "newton": ((2, 2, 2), 2, (15, 15, 15), "V", 2, 3),
    "uneven": ((2, 4, 1), 0, (15, 31, 15), "V", 3, 3),
    "empty_blocks": ((8, 1, 1), 0, (17, 15, 15), "V", 3, 3),
}
JAX_CASES = ("linear", "fas", "w", "f", "newton", "uneven")
REFINE = {"refine_linear": 0, "refine_newton": 2}
# Checkpoints: (mode, cycles before, cycles after).
CHECKPOINT = {"ck_linear": (0, 2, 2), "ck_newton": (2, 1, 1)}


def _kw(mode, dims, cycle="V", maxiter=3, sweeps=3, dtype="float64"):
    return dict(
        maxiter=maxiter, tol=1e-5, grid_dim=dims, mode=Mode(mode),
        pre_smoothing=sweeps, post_smoothing=sweeps, omega=0.8, gamma=1.0,
        dtype=dtype, print_progress=False, cycle_type=cycle,
    )


def _tparams(*args, **kw):
    return tcfg.GridParams(stencil=tcfg.Stencil.poisson_7pt(),
                           **_kw(*args, **kw))


def _jparams(*args, **kw):
    import gpusolve_tpu as gs

    return gs.GridParams(stencil=gs.Stencil.poisson_7pt(), **_kw(*args, **kw))


def _refine_params(mode):
    return _tparams(mode, (15, 15, 15), maxiter=12,
                    dtype="float32").replace(tol=1e-11)


def _solver(mode):
    return gt.newton_solve if Mode(mode) == Mode.NEWTON else gt.solve


def _field(state, mode):
    lvl = state.levels[0]
    return lvl.newton_v if Mode(mode) == Mode.NEWTON else lvl.v


def _single(name):
    """The port's single-device plain run of a case: state and history."""
    _, mode, *case = CASES[name]
    p = _tparams(mode, *case)
    return _solver(mode)(gt.build_grid(p, device="cpu"), p)


def _fake_mesh(shape, coords):
    return Mesh(tuple(shape), tuple(coords), 0, None, torch.device("cpu"))


# ---------------------------------------------------------------------------
# The placement policy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dims,shape,cutoff", [
    ((31, 31, 31), (2, 2, 2), 4),
    ((31, 31, 31), (2, 2, 2), 2),
    ((15, 31, 15), (2, 4, 1), 2),
])
def test_level_shardings_match_jax(dims, shape, cutoff):
    """Blocked or replicated, level by level, as the JAX function decides;
    every rank's block is its ``ceil(n/m)`` share, the blocks tile each
    blocked level, and a replicated level is whole on every rank."""
    from gpusolve_tpu.dist import level_shardings as jax_level_shardings
    from gpusolve_tpu.dist import make_mesh as jax_make_mesh

    want = [tuple(sh.spec) for sh in jax_level_shardings(
        _jparams(0, dims), jax_make_mesh(shape), coarse_cutoff=cutoff)]
    p = _tparams(0, dims)
    got = None
    for r in range(int(np.prod(shape))):
        shs = tsh.level_shardings(p, _fake_mesh(shape, coords_of(r, shape)),
                                  cutoff)
        assert [sh.spec for sh in shs] == want
        got = shs
        for sh in shs:
            if not sh.blocked:
                assert sh.box is None and sh.local_dims == sh.dims
                continue
            for n, m, (lo, hi) in zip(sh.dims, shape, sh.box):
                assert hi - lo <= -(-n // m)
    for sh in got:
        if sh.blocked:
            cover = np.zeros(sh.dims, dtype=int)
            for box in sh.padded_boxes():
                cover[tuple(slice(lo - 1, hi - 1) for lo, hi in box)] += 1
            assert (cover == 1).all()
    assert hash(got) == hash(got)


# ---------------------------------------------------------------------------
# One rank, in this process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_one_rank_is_the_per_op_schedule(mode, dtype):
    """On the (1,1,1) mesh the engine runs the single-device per-op
    schedule on the state's own tensors: every level's fields and the
    history bit for bit (W and F run the same ops: the gloo cases hold
    them)."""
    mesh = gt.make_mesh((1, 1, 1), device="cpu")
    p = _tparams(mode, (15, 15, 15), "V", 2, dtype=dtype)
    want_state, want = _solver(mode)(gt.build_grid(p, device="cpu"), p)
    shs = gt.level_shardings(p, mesh, CUTOFF)
    state = gt.build_grid(p, device="cpu")
    ptrs = [lvl.f.data_ptr() for lvl in state.levels]
    state, got = _solver(mode)(state, p, shardings=shs)
    assert got == want
    assert [lvl.f.data_ptr() for lvl in state.levels] == ptrs
    for a, b in zip(state.levels, want_state.levels):
        for name in ("v", "f", "rest_v", "newton_v"):
            if getattr(a, name) is not None:
                assert torch.equal(getattr(a, name), getattr(b, name))


def test_one_rank_fetch_is_a_view():
    p = _tparams(0, (15, 15, 15))
    shs = gt.level_shardings(p, gt.make_mesh((1, 1, 1), device="cpu"), 2)
    t = torch.randn(17, 17, 17, dtype=torch.float64)
    got = gspmd.halo(t, shs[0])
    assert got.data_ptr() == t.data_ptr() and got.shape == t.shape
    fine, coarse = gspmd.prolong_boxes(shs[0], (0, 0, 0))
    assert fine == ((0, 17),) * 3 and coarse == ((0, 9),) * 3
    got = gspmd.fetch(t, shs[0], lambda c: gspmd.restrict_box(shs[1], c))
    assert got.data_ptr() == t.data_ptr() and got.shape == t.shape


def _carve(shape, whole, part):
    """Each rank's part of a (shape) split, ``part(coords)`` giving the
    block (padded global indices) and its values, put back together:
    bit for bit ``whole``, the op on the whole fields."""
    out = torch.zeros_like(whole)
    for r in range(int(np.prod(shape))):
        block, values = part(coords_of(r, shape))
        out[tuple(slice(lo, hi) for lo, hi in block)] = values
    assert torch.equal(out, whole)


def test_carved_ops_match_the_whole_field():
    """A 15³ field cut into (2,2,1) boxes by the engine's box functions
    (the split, the stencil box, the restriction's and the prolongation's
    boxes), windowed from the whole fields with the neighbours' points as
    ghosts: the sweep and the residual in every mode, the restriction and
    the prolongation on each box, put back together, are the ops on the
    whole fields, bit for bit."""
    shape = (2, 2, 1)
    gen = torch.Generator().manual_seed(7)

    def rand(dims):
        t = torch.zeros(tuple(d + 2 for d in dims), dtype=torch.float64)
        ref.interior(t, dims).copy_(
            0.3 * torch.randn(dims, generator=gen, dtype=torch.float64))
        return t

    for mode in (0, 1, 2):
        p = _tparams(mode, (15, 15, 15))
        h = p.level_h(0)
        dims, cdims = p.level_dims()[:2]
        v, f, nv, vc = rand(dims), rand(dims), rand(dims), rand(cdims)

        def level(coords, lev):
            return tsh.level_shardings(p, _fake_mesh(shape, coords), 2)[lev]

        def sweep(dims_, v_, f_, nv_):
            out = torch.zeros_like(v_)
            dispatch.smooth(v_, f_, out, dims_, p, h, 1, None, nv_)
            return out

        def resid(dims_, v_, f_, nv_):
            out = torch.zeros_like(v_)
            dispatch.residual_op(out, v_, f_, dims_, p, h, newton_v=nv_)
            return out

        for op in (sweep, resid):
            def part(coords, op=op):
                sh = level(coords, 0)
                box = gspmd.storage(sh)
                res = op(sh.local_dims,
                         *(gspmd.window(t, box).clone() for t in (v, f, nv)))
                return (tuple((lo + 1, hi - 1) for lo, hi in box),
                        ref.interior(res, sh.local_dims))

            _carve(shape, op(dims, v, f, nv), part)

        def restricted(coords):
            shc = level(coords, 1)
            cd = shc.local_dims
            out = torch.zeros(tuple(d + 2 for d in cd), dtype=torch.float64)
            fine = gspmd.window(v, gspmd.restrict_box(shc, coords)).clone()
            dispatch.restrict_op(out, fine, tuple(2 * d + 1 for d in cd), cd,
                                 p)
            return (tuple((lo + 1, hi + 1) for lo, hi in shc.box),
                    ref.interior(out, cd))

        whole = torch.zeros_like(vc)
        dispatch.restrict_op(whole, v, dims, cdims, p)
        _carve(shape, whole, restricted)

        def prolonged(coords):
            shf = level(coords, 0)
            fbox, cbox = gspmd.prolong_boxes(shf, coords)
            fine = gspmd.window(v, fbox).clone()
            dispatch.prolong_add_op(fine, gspmd.window(vc, cbox).clone(),
                                    gspmd._dims(cbox), gspmd._dims(fbox), p)
            block = tuple((lo + 1, hi + 1) for lo, hi in shf.box)
            return block, fine[tuple(slice(lo - o, hi - o) for (lo, hi), (o, _)
                                     in zip(block, fbox))]

        whole = v.clone()
        dispatch.prolong_add_op(whole, vc, cdims, dims, p)
        _carve(shape, whole, prolonged)


# ---------------------------------------------------------------------------
# Eight gloo ranks
# ---------------------------------------------------------------------------


def _rank_main(rank, store_path, out_dir):
    torch.set_num_threads(1)
    store = torch.distributed.FileStore(store_path, WORLD)
    torch.distributed.init_process_group(
        "gloo", store=store, rank=rank, world_size=WORLD
    )
    try:
        for name, (shape, mode, *case) in CASES.items():
            p = _tparams(mode, *case)
            mesh = gt.make_mesh(shape, device="cpu")
            shs = gt.level_shardings(p, mesh, CUTOFF)
            state, hist = _solver(mode)(gt.build_grid(p, device="cpu"), p,
                                        shardings=shs)
            whole = tsh.gather_state(state)
            shapes = [None] * WORLD
            torch.distributed.all_gather_object(
                shapes, [tuple(lvl.v.shape) for lvl in state.levels])
            if rank == 0:
                np.savez(os.path.join(out_dir, f"{name}.npz"),
                         hist=np.asarray(hist),
                         sol=_field(whole, mode).numpy(),
                         shapes=np.asarray(shapes))
        mesh = gt.make_mesh((2, 2, 2), device="cpu")
        for name, mode in REFINE.items():
            p = _refine_params(mode)
            shs = gt.level_shardings(p, mesh)
            u, hist = gt.solve_refine(p, shardings=shs)
            u = tsh.gather_field(u, shs[0])
            if rank == 0:
                np.savez(os.path.join(out_dir, f"{name}.npz"),
                         hist=np.asarray(hist), u=u.numpy())
        from gpusolve_tpu_torch.utils import checkpoint

        for name, (mode, before, after) in CHECKPOINT.items():
            p = _tparams(mode, (15, 15, 15), maxiter=before)
            shs = gt.level_shardings(p, mesh, CUTOFF)
            state, hist = _solver(mode)(gt.build_grid(p, device="cpu"), p,
                                        shardings=shs)
            checkpoint.save_state(os.path.join(out_dir, f"{name}_mesh.npz"),
                                  state, p, iteration=len(hist) - 1,
                                  history=hist)
            # The other way round: a single-device checkpoint resumed here.
            state, _, head = checkpoint.load_state(
                os.path.join(out_dir, f"{name}_one.npz"), p, shardings=shs)
            _, more = _solver(mode)(state, p.replace(maxiter=after),
                                    initial_residual=head[0])
            if rank == 0:
                np.save(os.path.join(out_dir, f"{name}_resumed.npy"),
                        np.asarray(head + more))
        # No rank tears its connections down while a peer still reads.
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()


def _jax_history(name):
    """The JAX gspmd engine's history of a case, on the same mesh of the
    conftest's virtual devices."""
    import gpusolve_tpu as gs
    from gpusolve_tpu.dist import level_shardings, make_mesh, shard_state

    shape, mode, *case = CASES[name]
    p = _jparams(mode, *case)
    shs = level_shardings(p, make_mesh(shape), coarse_cutoff=CUTOFF)
    solve = gs.newton_solve if Mode(mode) == Mode.NEWTON else gs.solve
    _, hist = solve(shard_state(gs.build_grid(p), shs), p, shardings=shs)
    return np.asarray(hist)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every multi-rank case on 8 gloo ranks, and the JAX engine's
    histories computed meanwhile."""
    out = tmp_path_factory.mktemp("gspmd")
    for name, (mode, before, after) in CHECKPOINT.items():
        p = _tparams(mode, (15, 15, 15), maxiter=before)
        state, hist = _solver(mode)(gt.build_grid(p, device="cpu"), p)
        from gpusolve_tpu_torch.utils import checkpoint

        checkpoint.save_state(str(out / f"{name}_one.npz"), state, p,
                              iteration=len(hist) - 1, history=hist)
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(str(out / "store"), str(out)), nprocs=WORLD,
        join=False, start_method="spawn",
    )
    with concurrent.futures.ThreadPoolExecutor(len(JAX_CASES)) as ex:
        jax_hist = dict(zip(JAX_CASES, ex.map(_jax_history, JAX_CASES)))
    deadline = time.monotonic() + 600
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.terminate()
            pytest.fail("the gloo ranks did not finish")
    results = {}
    for name in list(CASES) + list(REFINE):
        with np.load(out / f"{name}.npz") as f:
            results[name] = {k: f[k] for k in f.files}
    for name in CHECKPOINT:
        results[name] = (str(out / f"{name}_mesh.npz"),
                         np.load(out / f"{name}_resumed.npy"))
    return results, jax_hist


@pytest.mark.parametrize("name", JAX_CASES)
def test_gloo_histories_match_jax_gspmd(ranks, name):
    results, jax_hist = ranks
    np.testing.assert_allclose(results[name]["hist"], jax_hist[name],
                               rtol=RTOL)


@pytest.mark.parametrize("name", list(CASES))
def test_gloo_fields_match_single_device(ranks, name):
    """The gathered solution against the port's single-device plain run:
    LINEAR bit for bit (every point by the same taps in the same order),
    FAS and NEWTON to 1e-12 (the CPU's vector and scalar e^x may differ
    in the last bit); the histories to rounding (the norm's sum crosses
    ranks)."""
    results, _ = ranks
    mode = CASES[name][1]
    state, hist = _single(name)
    want = _field(state, mode).numpy()
    got = results[name]["sol"]
    if mode == 0:
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max())
    np.testing.assert_allclose(results[name]["hist"], hist, rtol=RTOL)


@pytest.mark.parametrize("name", list(CASES))
def test_gloo_blocks_within_their_box(ranks, name):
    """Every rank's tensor of a blocked level is at most ``ceil(n/m) + 2``
    points an axis (its block and ghost frame); a replicated level's is
    the whole level."""
    results, _ = ranks
    shape, mode, *case = CASES[name]
    p = _tparams(mode, *case)
    shs = tsh.level_shardings(p, _fake_mesh(shape, (0, 0, 0)), CUTOFF)
    shapes = results[name]["shapes"]  # (rank, level, axis)
    assert shapes.shape == (WORLD, len(shs), 3)
    for lev, sh in enumerate(shs):
        for ax, (n, m) in enumerate(zip(sh.dims, shape)):
            cap = -(-n // m) + 2 if sh.blocked else n + 2
            assert shapes[:, lev, ax].max() <= cap
            if not sh.blocked:
                assert (shapes[:, lev, ax] == n + 2).all()


@pytest.mark.parametrize("name", list(REFINE))
def test_gloo_refine_matches_oracle(ranks, name):
    """solve_refine(shardings=…) on (2,2,2) reaches the float64 oracle as
    the single-device refinement does (tests/test_refine.py:118-134)."""
    import gpusolve_tpu as gs
    import oracle

    results, _ = ranks
    hist, u = results[name]["hist"], results[name]["u"]
    assert hist[-1] <= hist[0] * 1e-11
    po = gs.GridParams(stencil=gs.Stencil.poisson_7pt(), **_kw(
        REFINE[name], (15, 15, 15), maxiter=60)).replace(tol=1e-13)
    g = oracle.OracleGrid(po)
    if po.mode == Mode.NEWTON:
        oracle.newton_solve(g)
        u_ref = g.levels[0].newton_v
    else:
        oracle.solve(g)
        u_ref = g.levels[0].v
    assert np.max(np.abs(u - u_ref)) <= 1e-8 * np.max(np.abs(u_ref))


@pytest.mark.parametrize("name", list(CHECKPOINT))
def test_gloo_checkpoint_round_trips(ranks, name):
    """A checkpoint written on the (2,2,2) mesh resumes on one device, and
    a single-device one on the mesh, each to the uninterrupted run's
    history."""
    from gpusolve_tpu_torch.utils import checkpoint

    results, _ = ranks
    path, resumed_on_mesh = results[name]
    mode, before, after = CHECKPOINT[name]
    p = _tparams(mode, (15, 15, 15), maxiter=before + after)
    _, want = _solver(mode)(gt.build_grid(p, device="cpu"), p)
    state, it, head = checkpoint.load_state(path, p, device="cpu")
    assert it == before and len(head) == before + 1
    _, more = _solver(mode)(state, p.replace(maxiter=after),
                            initial_residual=head[0])
    np.testing.assert_allclose(head + more, want, rtol=RTOL)
    np.testing.assert_allclose(resumed_on_mesh, want, rtol=RTOL)
