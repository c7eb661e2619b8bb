"""The pod engine's chained legs (gpusolve_tpu_torch/ops/pod.py) on the CPU:

  * ``pod_down_plain`` / ``pod_up_plain`` equal the same legs run one by
    one through ``leg_block_plain``, exactly, in all three modes, on the
    one-rank plans of 15³ and (33, 17, 9) grids at depths 1 and 2 (the FAS
    up chain's ``sub_rv`` below its head included);
  * on a (2, 1, 1) plan at depth 2, each rank's chain, with its slabs
    exchanged between legs (two threads standing in for two ranks), equals
    the legs run rank by rank with slabs cut from the whole field;
  * the JAX package's ``pallas_pod.pod_down`` / ``pod_up`` (interpret
    mode, a one-device mesh) against the plain chains at 15³ LINEAR, in
    float32, across the two packages' layouts;
  * the geometry (``pod_levels``, ``choose_npod``), ``_linearize`` against
    the JAX package's, the refusals, and ``launches_per_cycle``.

The kernels themselves run on the card only (``chip_smoke.py`` holds them
against these plain versions bit for bit).
"""

import threading

import numpy as np
import pytest
import torch

import gpusolve_tpu_torch as gt
from gpusolve_tpu_torch import cli
from gpusolve_tpu_torch.dist import pod as tpod
from gpusolve_tpu_torch.dist import spmd as tsp
from gpusolve_tpu_torch.dist.mesh import Mesh
from gpusolve_tpu_torch.ops import kernels
from gpusolve_tpu_torch.ops import pod as PD
from gpusolve_tpu_torch.ops import spmd_kernels as sk
from gpusolve_tpu_torch.ops import spmd_leg as sl

CPU = torch.device("cpu")


def _params(mode, dims, dtype="float32", cycle="V", **kw):
    base = dict(maxiter=2, tol=1e-30, grid_dim=dims, mode=mode,
                pre_smoothing=2, post_smoothing=2, omega=0.8, gamma=1.0,
                print_progress=False, dtype=dtype, cycle_type=cycle)
    base.update(kw)
    return gt.GridParams(stencil=gt.Stencil.poisson_7pt(), **base)


def _mesh(shape=(1, 1, 1), rank=0):
    from gpusolve_tpu_torch.dist.mesh import coords_of

    return Mesh(shape, coords_of(rank, shape), rank, None, CPU)


def _seed(eng, state, seed):
    """Seeded v, f, ũ and rest_v on levels 0..npod of ``state``, zero
    outside each box."""
    rng = np.random.default_rng(seed)
    for l in range(eng.npod + 1):
        lvl, box = state.levels[l], eng.boxes[l]
        for name, scale in (("v", 0.05), ("f", 100.0), ("newton_v", 0.3),
                            ("rest_v", 0.05)):
            t = getattr(lvl, name)
            if t is None:
                continue
            t[sk.box_slices(box)] = torch.from_numpy(
                rng.standard_normal(sk.box_dims(box), dtype=np.float32)
                * np.float32(scale)
            )
    return state


def _fields(state, npod):
    return [t for lvl in state.levels[:npod + 1]
            for t in (lvl.v, lvl.r, lvl.f, lvl.rest_v) if t is not None]


def _legs(eng, levels, up):
    return (eng.up_legs(0, levels, levels[eng.npod].v) if up
            else eng.down_legs(0, levels))


CASES = [(dims, npod) for dims in ((15, 15, 15), (33, 17, 9))
         for npod in (1, 2)]


@pytest.mark.parametrize("mode", [0, 1, 2], ids=["linear", "fas", "newton"])
@pytest.mark.parametrize("dims,npod", CASES,
                         ids=[f"{d[0]}x{d[1]}x{d[2]}-npod{n}"
                              for d, n in CASES])
def test_plain_chains_equal_their_legs(mode, dims, npod):
    p = _params(mode, dims)
    eng = tpod.build_pod_solver(p, _mesh(), npod=npod)
    assert eng.plan.tail_in_place
    for up in (False, True):
        S = p.post_smoothing if up else p.pre_smoothing
        a = _seed(eng, eng.init_state(), 5)
        b = _seed(eng, eng.init_state(), 5)
        chain = PD.pod_up_plain if up else PD.pod_down_plain
        pa = chain(_legs(eng, list(a.levels), up), p, S)
        pb = None
        for leg in _legs(eng, list(b.levels), up):
            out = sl.leg_block_plain(leg.v_out, leg.v, leg.f, None, leg.box,
                                     leg.glob, p, leg.h, S, **leg.kwargs())
            pb = out if out is not None else pb
        for x, y in zip(_fields(a, npod), _fields(b, npod)):
            assert torch.equal(x, y)
        assert (pa is None) == (not up) and (pb is None) == (not up)
        if up:
            assert torch.equal(pa, pb)
    # The wrappers take the plain version on CPU tensors: no launch.
    kernels.reset_launches()
    st = _seed(eng, eng.init_state(), 5)
    PD.pod_down(_legs(eng, list(st.levels), False), p, p.pre_smoothing)
    assert PD.pod_up(_legs(eng, list(st.levels), True), p,
                     p.post_smoothing) is not None
    assert all(n == 0 for n in kernels.launches.values())


class _Board:
    """Two threads standing in for two x-neighbour ranks: each exchange
    posts this rank's block and takes the neighbours' faces, as
    ``_Exchange.slabs`` does on an x-split mesh."""

    def __init__(self, n):
        self.n = n
        self.slot = [None] * n
        self.barrier = threading.Barrier(n)

    def exchange(self, rank):
        def slabs(t, g):
            self.slot[rank] = t.clone()
            self.barrier.wait()
            lo = self.slot[rank - 1] if rank > 0 else None
            hi = self.slot[rank + 1] if rank < self.n - 1 else None
            z = torch.zeros((g,) + tuple(t.shape[1:]), dtype=t.dtype)
            out = (z if lo is None else lo[-g:].clone(),
                   z if hi is None else hi[:g].clone(), None, None)
            self.barrier.wait()
            return out

        return slabs


@pytest.mark.parametrize("mode", [0, 1, 2], ids=["linear", "fas", "newton"])
def test_carved_chains_equal_whole_field_legs(mode):
    """A (2, 1, 1) plan at depth 2 (31³): each rank's chain with its slabs
    exchanged between the legs equals the same legs run rank by rank, leg
    after leg, with slabs cut from the whole field (``dist/spmd._window``)
    as the exchange delivers them; both chains, exactly.  The boundary
    block is each rank's own buffer here (the down chain's last outputs,
    the up chain's first coarse block)."""
    dims, npod, shape = (31, 31, 31), 2, (2, 1, 1)
    p = _params(mode, dims)
    plan = tpod.PodPlan(p, shape, npod)
    rng = np.random.default_rng(9)
    glob = []  # per level 0..npod, per field: the whole level, x-stacked
    for l in range(npod + 1):
        b, n = plan.shape(l), plan.dims[l]
        full = {}
        for name, scale in (("v", 0.05), ("f", 100.0), ("newton_v", 0.3),
                            ("rest_v", 0.05)):
            a = torch.zeros((2 * b[0],) + b[1:])
            a[1:n[0] + 1, 1:n[1] + 1, 1:n[2] + 1] = torch.from_numpy(
                rng.standard_normal(n, dtype=np.float32) * np.float32(scale))
            full[name] = a
        glob.append(full)

    def seeded(r):
        """Rank r's engine and state: its blocks of the whole levels."""
        eng = tpod.PodEngine(p, _mesh(shape, r), npod=npod)
        st = eng.init_state()
        blocks = [st.levels[l] for l in range(npod)]
        for l, lvl in enumerate(blocks):
            bx = plan.shape(l)[0]
            for name in ("v", "f", "newton_v", "rest_v"):
                t = getattr(lvl, name)
                if t is not None:
                    t.copy_(glob[l][name][r * bx:(r + 1) * bx])
        bx = plan.shape(npod)[0]
        bnd = eng._boundary()
        bnd[0].copy_(glob[npod]["v"][r * bx:(r + 1) * bx])
        return eng, st, blocks + [bnd]

    def legs_of(eng, st, up):
        levels = list(st.levels)
        return (eng.up_legs(0, levels, eng._boundary()[0]) if up
                else eng.down_legs(0, levels))

    def flat(blocks):
        out = []
        for lvl in blocks[:-1]:
            out += [t for t in (lvl.v, lvl.r, lvl.f, lvl.rest_v)
                    if t is not None]
        return out + list(blocks[-1])

    def cut(g, r, bx, dep):
        xs = (dep,) + tuple(g.shape[1:])
        return (tsp._window(g, (r * bx - dep, 0, 0), xs),
                tsp._window(g, ((r + 1) * bx, 0, 0), xs), None, None)

    for up in (False, True):
        S = p.post_smoothing if up else p.pre_smoothing
        got = [seeded(r) for r in (0, 1)]
        want = [seeded(r) for r in (0, 1)]
        board = _Board(2)
        chain = PD.pod_up_plain if up else PD.pod_down_plain
        parts = [None, None]

        def run(r):
            eng, st, _ = got[r]
            parts[r] = chain(legs_of(eng, st, up), p, S, board.exchange(r))

        threads = [threading.Thread(target=run, args=(r,)) for r in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        # The reference: leg i on both ranks, slabs cut from the whole
        # level as it stands after leg i − 1.
        legs = [legs_of(eng, st, up) for eng, st, _ in want]
        wparts = [None, None]
        for i in range(len(legs[0])):
            whole = {}
            for key in ("v", "f", "newton_v", "coarse"):
                ts = [getattr(legs[r][i], key) for r in (0, 1)]
                if ts[0] is not None:
                    whole[key] = (torch.cat(ts, dim=0), ts[0].shape[0])
            for r in (0, 1):
                leg = legs[r][i]
                slabs = {"f": cut(whole["f"][0], r, whole["f"][1], sl.G)}
                if not leg.src_zero:
                    slabs["v"] = cut(whole["v"][0], r, whole["v"][1], sl.G)
                if mode == 2:
                    slabs["nv"] = cut(whole["newton_v"][0], r,
                                      whole["newton_v"][1], sl.G)
                cs = None
                if leg.coarse is not None:
                    cs = cut(whole["coarse"][0], r, whole["coarse"][1],
                             sl.GC)
                out = sl.leg_block_plain(
                    leg.v_out, leg.v, leg.f, slabs, leg.box, leg.glob, p,
                    leg.h, S, **leg.kwargs(cs),
                )
                wparts[r] = out if out is not None else wparts[r]
        for r in (0, 1):
            for x, y in zip(flat(got[r][2]), flat(want[r][2])):
                assert torch.equal(x, y), (up, r)
            if up:
                assert torch.equal(parts[r], wparts[r])


def test_plain_chains_match_jax_pod_kernels():
    """JAX's pallas_pod.pod_down / pod_up (interpret mode, a one-device
    mesh, 15³ LINEAR, depth 1) against the plain chains on the same
    interior cells, in float32: the fields to atol 1e-5·max|f| scaled as
    the outputs are, Σr² to rtol 1e-5.  The two round differently (the
    TPU kernels' MXU transfers, their sums of shared coefficients)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from gpusolve_tpu.config import GridParams, Stencil
    from gpusolve_tpu.dist.mesh import make_mesh
    from gpusolve_tpu.dist.spmd import _shard_map
    from gpusolve_tpu.ops import pallas_pod

    dims = (15, 15, 15)
    jp = GridParams(stencil=Stencil.poisson_7pt(), maxiter=2, tol=1e-30,
                    grid_dim=dims, mode=0, pre_smoothing=2, post_smoothing=2,
                    omega=0.8, gamma=1.0, print_progress=False,
                    dtype="float32")
    levels = pallas_pod.pod_levels(jp, (1, 1), 1)
    p = _params(0, dims)
    eng = tpod.build_pod_solver(p, _mesh(), npod=1)
    st = _seed(eng, eng.init_state(), 3)
    lv0, root = st.levels[0], st.levels[1]

    def to_jax(t, l):
        a = np.zeros(levels[l][:3], np.float32)
        n = levels[l][3:]
        a[1:n[0] + 1, 1:n[1] + 1, 1:n[2] + 1] = \
            t[1:n[0] + 1, 1:n[1] + 1, 1:n[2] + 1].numpy()
        return jnp.asarray(a)

    b0 = jnp.asarray(np.array([[1, 15, 1, 15, 1, 15, 0, 15, 0, 15, 0, 0]],
                              np.int32))
    my = jnp.zeros((1, 2), jnp.int32)
    mesh = make_mesh((1, 1, 1))

    def down(v0, f0):
        return pallas_pod.pod_down(v0, f0, [], [b0], my, levels, jp,
                                   (1, 1, 1), interpret=True)[0]

    def up(v0, f0, cvb):
        z2 = jnp.zeros((8,) + levels[1][1:3], jnp.float32)
        vups, pss = pallas_pod.pod_up([v0], [f0], [], [None], cvb, (z2, z2),
                                      [b0], my, levels, jp, (1, 1, 1),
                                      interpret=True)
        return vups[0], pss

    smap = jax.jit(_shard_map(down, mesh=mesh, in_specs=(P(), P()),
                              out_specs=(P(), P()), check_rep=False))
    jv, jfc = (np.asarray(x) for x in smap(to_jax(lv0.v, 0),
                                           to_jax(lv0.f, 0)))
    umap = jax.jit(_shard_map(up, mesh=mesh, in_specs=(P(), P(), P()),
                              out_specs=(P(), P()), check_rep=False))
    ju, jss = (np.asarray(x) for x in umap(to_jax(lv0.v, 0),
                                           to_jax(lv0.f, 0),
                                           to_jax(root.v, 1)))
    # The port: the up chain from the same seeded state, then the down.
    up_state = _seed(eng, eng.init_state(), 3)
    part = PD.pod_up_plain(_legs(eng, list(up_state.levels), True), p, 2)
    PD.pod_down_plain(_legs(eng, list(st.levels), False), p, 2)
    fmax = float(lv0.f.abs().max())
    inner = (slice(1, 16),) * 3
    cin = (slice(1, 8),) * 3
    np.testing.assert_allclose(lv0.r[inner].numpy(), jv[inner], rtol=0,
                               atol=1e-5 * fmax * (1.0 / 16) ** 2)
    np.testing.assert_allclose(root.f[cin].numpy(), jfc[cin], rtol=1e-5,
                               atol=1e-5 * fmax)
    np.testing.assert_allclose(up_state.levels[0].r[inner].numpy(),
                               ju[inner], rtol=0,
                               atol=1e-5 * fmax * (1.0 / 16) ** 2)
    np.testing.assert_allclose(float(part.sum()), float(jss), rtol=1e-5)


# ---------------------------------------------------------------------------
# Geometry, schedule, refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [15, 31, 63, 127, 511])
def test_one_rank_depth_and_layout(n):
    """On one rank choose_npod picks depth 1 (as the JAX package does);
    x halves exactly down the chain and the boundary block is the tail's
    (n+2)³, so the tail runs in place; the blocks cover every level."""
    p = _params(0, (n, n, n))
    assert tpod.choose_npod(p, (1, 1)) == 1
    for npod in range(1, min(4, p.num_levels)):
        plan = tpod.PodPlan(p, (1, 1, 1), npod)
        assert plan.refusal() is None and plan.tail_in_place
        for l in range(npod):
            assert plan.levels[l][0] == 2 * plan.levels[l + 1][0]
            assert all(b % 2 == 0 for b in plan.levels[l][:2])
        assert plan.shape(npod) == tuple(d + 2 for d in plan.dims[npod])
        for l in range(npod + 1):
            assert all(b >= d + 1 for b, d in zip(plan.shape(l),
                                                  plan.dims[l]))
    assert PD.pod_levels(p, (1, 1), 0) is None
    assert PD.pod_levels(p, (1, 1), p.num_levels) is None


def test_mesh_depths_and_refusals():
    """On (2, 1) and (1, 2) data meshes the split axis halves exactly; a
    corner-tap stencil has no pod depth and the engine refuses it (as
    tests/test_pod.py's JAX engine does); pre/post past the legs' caps
    are refused; a multi-rank CUDA mesh is no refusal (its chains
    exchange in the launch): --fuse auto takes pod there."""
    p = _params(0, (31, 31, 31))
    for mesh_xy in ((2, 1), (1, 2)):
        plan = tpod.PodPlan(p, mesh_xy + (1,), 2)
        ax = 0 if mesh_xy[0] > 1 else 1
        assert [lv[ax] for lv in plan.levels] == [20, 10, 5]
        assert not plan.tail_in_place and plan.refusal() is None
    corner = p.replace(stencil=gt.Stencil(
        values=(6.0, -1.0, -1.0, -1.0, -1.0, -1.0, -1.0),
        offsets=((0, 0, 0), (1, 1, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
                 (0, 0, 1), (0, 0, -1)),
    ))
    assert tpod.choose_npod(corner, (1, 1)) is None
    with pytest.raises(ValueError, match="no pod depth"):
        tpod.build_pod_solver(corner, _mesh())
    with pytest.raises(ValueError, match="edge or corner taps"):
        tpod.build_pod_solver(corner, _mesh(), npod=1)
    assert "sweeps" in tpod.PodPlan(p.replace(post_smoothing=5), (1, 1, 1),
                                    1).refusal()
    assert tpod.pod_supported(p, (2, 1), 2)
    assert not tpod.pod_supported(p, (1, 1), p.num_levels)
    assert not tpod.pod_supported(corner, (1, 1), 1)
    assert tpod.choose_npod(p.replace(pre_smoothing=6), (1, 1)) is None
    assert cli._pod_refusal(p, (2, 1, 1), "ppermute") is None


@pytest.mark.parametrize("cycle", ["V", "W", "F"])
def test_linearize_matches_jax(cycle):
    from gpusolve_tpu.dist.pod import _linearize

    for npod in (1, 2, 3):
        assert tpod._linearize(cycle, npod) == _linearize(cycle, npod)


def test_launches_per_cycle():
    """One pod_down and one pod_up a V-cycle, the tail's fused legs
    without its norm, FAS one subtract for the boundary; W and F by
    their groups."""
    lin = tpod.PodPlan(_params(0, (511, 511, 511), pre_smoothing=3,
                               post_smoothing=3), (1, 1, 1), 1)
    assert tpod.launches_per_cycle(lin) == {
        "pod_down": 1, "jacobi_sweep": 6, "down_leg": 7, "up_leg": 7,
        "pod_up": 1, "finalize": 1,
    }
    fas = tpod.PodPlan(_params(1, (511, 511, 511), pre_smoothing=3,
                               post_smoothing=3), (1, 1, 1), 3)
    assert tpod.launches_per_cycle(fas) == {
        "pod_down_fas": 1, "jacobi_sweep_fas": 6, "down_leg_fas": 5,
        "up_leg_fas": 5, "apply_fas": 5, "subtract": 6, "pod_up_fas": 1,
        "finalize": 1,
    }
    w = tpod.PodPlan(_params(2, (63, 63, 63), cycle="W"), (1, 1, 1), 2)
    counts = tpod.launches_per_cycle(w)
    assert counts["pod_down_newton"] == 2 and counts["pod_up_newton"] == 2
    assert counts["down_leg_newton"] == counts["up_leg_newton"] == 28
