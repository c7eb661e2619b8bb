"""The pod chains' exchange between ranks (gpusolve_tpu_torch/ops/pod.py
``ChainLayout`` / ``ChainPeers``, csrc/pod.cu's multi-rank chains) on the
CPU, where no kernel runs:

  * the exchange sets and steps of a chain, for x, y and x+y splits, in
    the three modes, at depths 1-3, against the ``(tensor shape, depth)``
    calls the plain chain's host ``exchange`` makes, and their phases
    (the TPU kernels' phase 0 and mid-chain exchanges);
  * the row copies a launch makes (the kernel's copy loop run on the host,
    over in-process ranks' allocations), phase by phase, against the slabs
    of the host exchange, corners included;
  * ``--fuse auto`` on a multi-rank mesh (now the card's too) against the
    JAX CLI's choice;
  * the plain chains on a (2, 2, 1) gloo mesh (corners) at 31³, depth 2,
    LINEAR and NEWTON, against the JAX per-leg engine on the same virtual
    mesh in float64 to rtol 1e-10 (tests/test_torch_pod.py covers x-only
    and y-only); four ranks spawned once for the module.
"""

import ctypes
import os
import threading
import time

import numpy as np
import pytest
import torch

import gpusolve_tpu_torch as gt
from gpusolve_tpu_torch import cli
from gpusolve_tpu_torch.config import Mode
from gpusolve_tpu_torch.dist import pod as tpod
from gpusolve_tpu_torch.dist import spmd as tsp
from gpusolve_tpu_torch.dist.mesh import Mesh, coords_of
from gpusolve_tpu_torch.ops import pod as PD
from gpusolve_tpu_torch.ops import spmd_leg as sl

from test_torch_pod import _close, _jax_leg, _pod_solve, _tparams

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLITS = {"x": (2, 1, 1), "y": (1, 2, 1), "xy": (2, 2, 1)}
ORDER = {"f": 0, "v": 1, "nv": 2, "c": 3}


def _engine(params, shape, rank, npod):
    """One rank's pod engine on a mesh with no process group: the chains'
    legs are built, no collective is called."""
    mesh = Mesh(shape, coords_of(rank, shape), rank, None,
                torch.device("cpu"))
    return tpod.PodEngine(params, mesh, npod=npod)


def _legs(eng, state, up):
    levels = list(state.levels)
    if up:
        return eng.up_legs(0, levels, eng._root_coarse(levels[eng.npod]))
    return eng.down_legs(0, levels)


@pytest.mark.parametrize("npod", [1, 2, 3])
@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("split", list(SPLITS))
def test_sets_are_the_plain_exchange(monkeypatch, split, mode, npod):
    shape = SPLITS[split]
    params = _tparams(mode, (63, 63, 63))
    eng = _engine(params, shape, 0, npod)
    state = eng.init_state()
    ys = shape[1] > 1
    calls = []

    def exchange(t, g):
        calls.append((tuple(t.shape), g))
        bx, by, bz = t.shape
        xs = t.new_zeros((g, by + 2 * g if ys else by, bz))
        ysl = t.new_zeros((bx, g, bz)) if ys else None
        return xs, xs, ysl, ysl

    # The calls are what matters here, not the legs' arithmetic.
    monkeypatch.setattr(sl, "leg_block_plain", lambda *a, **k: None)
    for up in (False, True):
        legs = _legs(eng, state, up)
        calls.clear()
        (PD.pod_up_plain if up else PD.pod_down_plain)(
            legs, params, 2, exchange)
        sets = PD.exchange_sets(legs, params)
        by_leg = sorted(sets, key=lambda x: (x.leg, ORDER[x.name]))
        assert [(x.shape, x.g) for x in by_leg] == calls
        for x in sets:
            fresh = x.name == "c" if up else x.name == "f" or (
                x.name == "v" and mode == Mode.NONLINEAR)
            assert x.phase == (x.leg if fresh and x.leg > 0 else 0), x
        axes = [ax for ax in (1, 0) if shape[ax] > 1]
        assert PD.exchange_steps(sets, shape[:2]) == [
            (ph, ax) for ph in range(npod) for ax in axes]
        lay = PD.ChainLayout(legs, params, shape[:2])
        assert lay.nbytes % 256 == 0 and len(lay.offsets) == len(sets)


def _run_copies(steps, jobs, phase):
    """The kernel's copy loop on the host: each row of each job of the
    steps of ``phase``, in step order."""
    for leg, _, job0, n, _ in steps:
        if leg != phase:
            continue
        for dst, src, rows, rpp, sps, dps, bz, _ in jobs[job0:job0 + n]:
            for r in range(rows):
                q, y = divmod(r, rpp)
                ctypes.memmove(dst + 4 * (q * dps + y * bz),
                               src + 4 * (q * sps + y * bz), 4 * bz)


def _expected(blocks, dcs, mxy, g, ys):
    """Every rank's slabs of one field by the host exchange's rule: the
    blocks placed on the global grid with g zero cells around it."""
    bx, by, bz = blocks[0].shape
    grid = blocks[0].new_zeros((mxy[0] * bx + 2 * g, mxy[1] * by + 2 * g,
                                bz))
    for t, (dx, dy) in zip(blocks, dcs):
        grid[g + dx * bx:g + (dx + 1) * bx, g + dy * by:g + (dy + 1) * by] = t
    out = []
    for dx, dy in dcs:
        x0, y0 = g + dx * bx, g + dy * by
        yr = slice(y0 - g, y0 + by + g) if ys else slice(y0, y0 + by)
        d = {"xlo": grid[x0 - g:x0, yr], "xhi": grid[x0 + bx:x0 + bx + g, yr]}
        if ys:
            d["ylo"] = grid[x0:x0 + bx, y0 - g:y0]
            d["yhi"] = grid[x0:x0 + bx, y0 + by:y0 + by + g]
        out.append(d)
    return out


@pytest.mark.parametrize("up", [False, True], ids=["down", "up"])
@pytest.mark.parametrize("mode", [1, 2])
@pytest.mark.parametrize("split", list(SPLITS))
def test_copies_give_the_host_exchange_slabs(split, mode, up):
    """Each rank's receive buffers after a phase's steps (the row copies
    of ``ChainLayout.copies`` into the neighbours' allocations, y before
    x) hold the host exchange's slabs of every set of the phase, the
    diagonal neighbours' corners and the zero global edges included."""
    shape = SPLITS[split]
    mxy, ys = shape[:2], shape[1] > 1
    params = _tparams(mode, (31, 31, 31), dtype="float32")
    m = shape[0] * shape[1]
    engs = [_engine(params, shape, r, 2) for r in range(m)]
    dcs = [e.ex.dc for e in engs]
    legs = [_legs(e, e.init_state(), up) for e in engs]
    lays = [PD.ChainLayout(lg, params, mxy) for lg in legs]
    mems = [torch.full((lay.nbytes // 4,), float("nan")) for lay in lays]
    bases = [mem.data_ptr() for mem in mems]
    for mem, lay in zip(mems, lays):  # zero, as the allocation starts
        for parts in lay.views(mem).values():
            for t in parts.values():
                t.zero_()
    rank_at = {dc: r for r, dc in enumerate(dcs)}
    peers = []
    for dx, dy in dcs:
        near = {(0, -1): (dx - 1, dy), (0, 1): (dx + 1, dy),
                (1, -1): (dx, dy - 1), (1, 1): (dx, dy + 1)}
        peers.append({k: bases[rank_at[c]] for k, c in near.items()
                      if c in rank_at})
    gen = torch.Generator().manual_seed(7)
    fields = [{(i, n): t for i, leg in enumerate(lg)
               for n, t, _ in PD._leg_fields(leg, params.mode)}
              for lg in legs]
    for phase in sorted({x.phase for x in lays[0].sets}):
        sets = [x for x in lays[0].sets if x.phase == phase]
        for f in fields:  # new contents: a stale slab would show
            for x in sets:
                t = f[(x.leg, x.name)]
                t.copy_(torch.randn(t.shape, generator=gen))
        copies = [lay.copies(lg, b, p)
                  for lay, lg, b, p in zip(lays, legs, bases, peers)]
        for ax in (1, 0):  # every rank's y step, then every rank's x step
            for (steps, jobs) in copies:
                _run_copies([s for s in steps if s[1] == ax], jobs, phase)
        for x in sets:
            want = _expected([f[(x.leg, x.name)] for f in fields], dcs, mxy,
                             x.g, ys)
            for r, (lay, mem) in enumerate(zip(lays, mems)):
                got = lay.views(mem)[(x.leg, x.name)]
                assert set(got) == set(want[r])
                for part, t in got.items():
                    assert torch.equal(t, want[r][part]), (r, x, part)


# ---------------------------------------------------------------------------
# --fuse auto on a multi-rank mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("conf", ["linear", "nonlinear", "newton"])
def test_fuse_auto_matches_jax_cli(conf):
    """``_pod_refusal`` (device-free: a multi-rank CUDA mesh is no reason
    any more) gives pod exactly where the JAX CLI's choice does on its
    accelerator (gpusolve_tpu/cli.py:378-409: --halo, --backend, then
    choose_npod's gates), on meshes of 2 to 8 ranks at 127³ and up, and
    of up to 4 at 63³; below that the port's legs refuse blocks the JAX
    package's take (a block at least a slab deep and 16 cells along x)."""
    import gpusolve_tpu as jgs
    from gpusolve_tpu.dist.pod import choose_npod

    path = os.path.join(ROOT, "examples", f"{conf}_127.conf")
    small = ((2, 1, 1), (1, 2, 1), (2, 2, 1), (4, 1, 1))
    for dims in ((511, 511, 511), (255, 255, 255), (127, 127, 127),
                 (63, 63, 63)):
        for extra in ({}, {"pre_smoothing": 6}, {"post_smoothing": 5}):
            p = gt.parse_config(path, grid_dim=dims, **extra)
            jp = jgs.parse_config(path, grid_dim=dims, **extra)
            for shape in small + (((2, 2, 2), (8, 1, 1), (1, 1, 1))
                                  if dims[0] > 63 else ()):
                folded = (shape[0], shape[1] * shape[2])
                want = choose_npod(jp, folded) is not None
                got = cli._pod_refusal(p, shape, "ppermute")
                assert (got is None) == want, (conf, dims, extra, shape, got)
                assert cli._pod_refusal(p, shape, "rdma") is not None
                assert cli._pod_refusal(p.replace(backend="ref"), shape,
                                        "ppermute") is not None


# ---------------------------------------------------------------------------
# Four gloo ranks: the plain chains with corners
# ---------------------------------------------------------------------------

RANK_CASES = {
    "xy-linear": ((2, 2, 1), 0, (31, 31, 31), "V", 2),
    "xy-newton": ((2, 2, 1), 2, (31, 31, 31), "V", 2),
}
WORLD = 4


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
            sol = tsp.gather_solution(state, plan, mesh,
                                      which=2 if mode == 2 else 0)
            if rank == 0:
                np.savez(os.path.join(out_dir, f"{name}.npz"),
                         hist=np.asarray(hist), sol=sol, npod=plan.npod)
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("pod_ranks")
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(str(out / "store"), str(out)), nprocs=WORLD,
        join=False, start_method="spawn",
    )
    # The JAX per-leg engine's histories meanwhile (each compiles once).
    jax_done = threading.Thread(target=lambda: [
        _jax_leg(shape, mode, dims, cycle)
        for shape, mode, dims, cycle, _ in RANK_CASES.values()])
    jax_done.start()
    deadline = time.monotonic() + 600
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            pytest.fail("the pod ranks did not finish")
    jax_done.join()
    results = {}
    for name in RANK_CASES:
        with np.load(out / f"{name}.npz") as f:
            results[name] = (f["hist"], f["sol"], int(f["npod"]))
    return results


@pytest.mark.parametrize("name", list(RANK_CASES))
def test_corner_ranks_match_jax_leg_engine(ranks, name):
    shape, mode, dims, cycle, npod = RANK_CASES[name]
    hist, sol, got_npod = ranks[name]
    assert got_npod == npod
    want_hist, want_sol = _jax_leg(shape, mode, dims, cycle)
    _close(hist, want_hist, f"{name} history")
    _close(sol, want_sol, f"{name} solution")
