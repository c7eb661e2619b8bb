"""The port's v1 whole-cycle engine on the CPU: the schedule against the
JAX package's ``_vcycle_call``, the plain version (``vcycle_fused_plain``,
the CUDA kernel's oracle) against the JAX XLA V-cycle and against the
port's batch engine, the engine choice against the JAX package's gates,
and ``solve``'s per-cycle v1 loop against the JAX package's ``solve``.

Inputs are made with numpy from a seed.  Tolerances: against the JAX
package, norms to rel 2e-4 and level-0 v to rtol 2e-4 with atol
2e-5·max|v| (v1's own tolerance against XLA, tests/test_pallas.py:205-240;
XLA's CPU code and PyTorch round single ops differently).  Against the
port's batch engine, bit for bit: both run the same plain ops in the same
order; in FAS the batch subtracts rest_v from each coarse v in place and
v1 does not, so coarse v is compared as v − rest_v.

The JAX v1 kernel itself is not run: in interpret mode it takes 40-75 s a
case on one core.  JAX V-cycles are compiled once per configuration (~4 s
each), so the JAX comparison runs at (31,15,63) V(6,6) and 15³ V(3,3) in
the three modes, not at the other two pairings of shape and smoothing;
the bit-for-bit comparison with the batch engine, which the other port
tests hold against JAX at V(3,3), covers 15³ and (31,15,63) at V(3,3) and
V(6,6)."""

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpusolve_tpu as gs
from gpusolve_tpu.ops import pallas_vcycle as pv
from gpusolve_tpu.solver import vcycle as jvc
from gpusolve_tpu_torch import config as tcfg
from gpusolve_tpu_torch import grid as tgrid
from gpusolve_tpu_torch import interop
from gpusolve_tpu_torch.config import Mode
from gpusolve_tpu_torch.ops import kernels, vcycle_batch
from gpusolve_tpu_torch.ops import vcycle_fused as vf
from gpusolve_tpu_torch.solver import vcycle as tvc

SHAPES = [(15, 15, 15), (31, 15, 63)]
SWEEPS = [(3, 3), (6, 6)]


def params_pair(dims, mode=0, pre=6, post=6, **kw):
    base = dict(
        maxiter=3, tol=1e-12, grid_dim=dims, mode=mode, pre_smoothing=pre,
        post_smoothing=post, omega=0.8, gamma=1.0, dtype="float32",
        print_progress=False,
    )
    base.update(kw)
    pj = gs.GridParams(
        stencil=gs.Stencil.poisson_7pt(), backend="xla", **base
    )
    pt = tcfg.GridParams(stencil=tcfg.Stencil.poisson_7pt(), **base)
    return pj, pt


def seeded_pair(pj, pt, seed=7):
    """The JAX state and the port state with the same seeded level-0 v
    (scale 0.05) and, in NEWTON, ũ (scale 0.2)."""
    jstate = gs.build_grid(pj)
    rng = np.random.default_rng(seed)
    dims = pj.grid_dim
    fields = [
        {k: np.array(getattr(lvl, k)) for k in ("v", "f", "rest_v",
                                                 "newton_v")
         if getattr(lvl, k) is not None}
        for lvl in jstate.levels
    ]
    inner = (slice(1, dims[0] + 1), slice(1, dims[1] + 1),
             slice(1, dims[2] + 1))
    fields[0]["v"][inner] = rng.standard_normal(dims, np.float32) * 0.05
    if pt.mode == Mode.NEWTON:
        fields[0]["newton_v"][inner] = (
            rng.standard_normal(dims, np.float32) * 0.2
        )
    levels = tuple(
        dataclasses.replace(lvl, **{k: jnp.asarray(a) for k, a in f.items()})
        for lvl, f in zip(jstate.levels, fields)
    )
    jstate = dataclasses.replace(jstate, levels=levels)
    nf = None if jstate.newton_f is None else np.asarray(jstate.newton_f)
    tstate = interop.state_from_numpy(pt, fields, device="cpu", newton_f=nf)
    return jstate, tstate


def crop(x, dims):
    return np.asarray(x)[: dims[0] + 2, : dims[1] + 2, : dims[2] + 2]


@pytest.mark.parametrize(
    "dims, sweeps, mode",
    list(itertools.product([(15, 15, 15), (63, 63, 63)],
                           [(3, 3), (6, 6), (2, 5), (0, 4)], list(Mode))),
)
def test_schedule_final_locs_match_jax(dims, sweeps, mode):
    """The schedule leaves v in the buffers the TPU kernel reports."""
    pj, pt = params_pair(dims, mode, *sweeps)
    key = (pj.stencil.values, pj.stencil.offsets, pj.mode, pj.omega,
           pj.gamma, *sweeps)
    _, want = pv._vcycle_call(key, pj.level_dims(), "float32", True)
    ops, got = vf.schedule(pt.num_levels, Mode(mode), *sweeps)
    assert got == want
    kinds = [op[0] for op in ops]
    assert kinds[-2:] == [vf.NORM, vf.FINALIZE]
    # A coarse level that starts from zero with no sweep is zeroed instead
    # of read stale (the TPU kernel reads the previous cycle's v there).
    assert (vf.ZERO in kinds) == (sweeps[0] == 0 and mode != Mode.NONLINEAR)


@pytest.mark.parametrize(
    "dims, sweeps, mode",
    [(d, s, m) for d, s in [((31, 15, 63), (6, 6)), ((15, 15, 15), (3, 3))]
     for m in Mode],
)
def test_plain_v1_matches_jax_vcycle(dims, sweeps, mode):
    pj, pt = params_pair(dims, mode, *sweeps)
    jstate, tstate = seeded_pair(pj, pt)
    want_state, want_res = jvc.vcycle(
        jstate, params=jvc.trace_params(pj), shardings=None
    )
    sumsq = vf.vcycle_fused_plain(tstate.levels, pt)
    got_res = float(np.sqrt(np.float32(sumsq[0])))
    assert got_res == pytest.approx(float(want_res), rel=2e-4)
    want_v = crop(want_state.levels[0].v, dims)
    scale = np.abs(want_v).max()
    np.testing.assert_allclose(
        tstate.levels[0].v.numpy(), want_v, rtol=2e-4, atol=2e-5 * scale
    )


@pytest.mark.parametrize(
    "dims, sweeps, mode", list(itertools.product(SHAPES, SWEEPS, list(Mode)))
)
def test_plain_v1_equals_batch_cycle(dims, sweeps, mode):
    """Two cycles of the plain v1 and of the batch engine (maxk=1) from
    the same state: the norms and fields bit for bit."""
    _, pt = params_pair(dims, mode, *sweeps)
    a = tgrid.build_grid(pt, device="cpu")
    b = tgrid.build_grid(pt, device="cpu")
    rng = np.random.default_rng(3)
    nv = torch.from_numpy(rng.standard_normal(dims, np.float32) * 0.2)
    for s in (a, b):
        if mode == Mode.NEWTON:
            s.levels[0].newton_v[1:-1, 1:-1, 1:-1] = nv
    for _ in range(2):
        got = vf.vcycle_fused_plain(a.levels, pt)
        want = vcycle_batch.run(b, pt, maxk=1)
        assert float(got[0]) == float(want[0])
        for i, (la, lb) in enumerate(zip(a.levels, b.levels)):
            assert torch.equal(la.f, lb.f)
            if mode == Mode.NONLINEAR:
                assert torch.equal(la.rest_v, lb.rest_v)
                va = la.v - la.rest_v if i > 0 else la.v
                assert torch.equal(va, lb.v)
            else:
                assert torch.equal(la.v, lb.v)


@pytest.mark.parametrize("mode", [Mode.LINEAR, Mode.NEWTON],
                         ids=lambda m: m.name)
def test_zero_start_without_sweeps(mode):
    """pre = 0: the v each coarse residual reads is zero (a ZERO op), as
    the batch engine's zero fill leaves it, though the coarse levels start
    from nonzero values."""
    _, pt = params_pair((15, 15, 15), mode, 0, 3)
    a = tgrid.build_grid(pt, device="cpu")
    b = tgrid.build_grid(pt, device="cpu")
    for s in (a, b):
        for lvl in s.levels[1:]:
            lvl.v[1:-1, 1:-1, 1:-1] = 5.0  # stale coarse values
    for _ in range(2):
        got = vf.vcycle_fused_plain(a.levels, pt)
        want = vcycle_batch.run(b, pt, maxk=1)
        assert float(got[0]) == float(want[0])
        assert torch.equal(a.levels[0].v, b.levels[0].v)


def test_cpu_wrapper_runs_plain_and_counts_nothing():
    _, pt = params_pair((15, 15, 15), Mode.LINEAR)
    a = tgrid.build_grid(pt, device="cpu")
    b = tgrid.build_grid(pt, device="cpu")
    kernels.reset_launches()
    got = vf.vcycle_fused(a.levels, pt)
    want = vf.vcycle_fused_plain(b.levels, pt)
    assert float(got[0]) == float(want[0])
    assert torch.equal(a.levels[0].v, b.levels[0].v)
    assert kernels.launches[vf.NAME] == 0


def _routing_cases():
    dims = (63, 63, 63)
    return [
        # (dims, pre, post, cycle, dtype, port answer on a CUDA device)
        (dims, 3, 3, "V", "float32", "batch"),
        (dims, 6, 6, "V", "float32", "v1"),
        (dims, 6, 6, "W", "float32", "batch"),
        (dims, 3, 3, "V", "float64", "plain"),
        (dims, 2, 6, "V", "float32", "v1"),
        ((31, 31, 31), 6, 6, "V", "float32", "batch"),  # under 48³
    ]


@pytest.mark.parametrize("dims, pre, post, cycle, dtype, engine",
                         _routing_cases())
def test_routing_matches_jax_gates(dims, pre, post, cycle, dtype, engine):
    """use_fused2/use_fused against the JAX package's with
    backend="pallas" (its "on TPU"), the port on a CUDA device."""
    pj, pt = params_pair(dims, 0, pre, post, cycle_type=cycle, dtype=dtype)
    pj = pj.replace(backend="pallas")
    assert tvc.use_fused2(pt, "cuda") == jvc.use_fused2(pj, None)
    assert tvc.use_fused(pt, "cuda") == jvc.use_fused(pj, None)
    assert tvc.engine(pt, "cuda") == engine
    assert tvc.engine(pt, "cpu") == "plain"
    assert tvc.engine(pt.replace(backend="ref"), "cuda") == "plain"


@pytest.mark.parametrize(
    "dims, pre, post, jax_gate",
    [
        ((60, 63, 63), 3, 3, "8-chunkable"),
        ((255, 255, 3), 3, 3, "coarsest level too large"),
    ],
)
def test_layout_gates_not_ported(dims, pre, post, jax_gate):
    """A configuration the JAX package sends to v1 only for a TPU layout
    gate of its v2 kernel runs the batch engine in the port."""
    from gpusolve_tpu.ops import pallas_vcycle2 as pv2

    pj, pt = params_pair(dims, 0, pre, post)
    pj = pj.replace(backend="pallas")
    assert jax_gate in pv2.unsupported_reason(pj)
    assert not jvc.use_fused2(pj, None) and jvc.use_fused(pj, None)
    assert tvc.use_fused2(pt, "cuda")
    assert tvc.engine(pt, "cuda") == "batch"
    assert tvc.engine_note(pt, "cuda") is None


def test_solve_v1_loop_matches_jax_solve(monkeypatch):
    """solve at V(6,6) through the per-cycle v1 loop (the device gate
    opened for CPU tensors, so the plain v1 runs) against the JAX
    package's solve, and bit for bit against the port's batch engine."""
    dims = (31, 15, 63)
    pj, pt = params_pair(dims, Mode.LINEAR, maxiter=20, tol=2e-3)
    _, want = gs.solve(gs.build_grid(pj), pj)
    batch_state, batch = tvc.solve(
        tgrid.build_grid(pt, device="cpu"), pt, check_every=4
    )
    monkeypatch.setattr(
        tvc, "_fused_capable",
        lambda p, device: p.backend != "ref" and p.dtype == "float32",
    )
    assert tvc.engine(pt, "cpu") == "v1"
    state, got = tvc.solve(tgrid.build_grid(pt, device="cpu"), pt)
    assert len(got) == len(want) < 21
    assert got == pytest.approx(want, rel=2e-4)
    assert got == batch
    assert torch.equal(state.levels[0].v, batch_state.levels[0].v)


@pytest.mark.parametrize("grid, split", [
    ((15, 15, 15), 1), ((31, 31, 31), 2), ((31, 15, 63), 2),
    ((47, 47, 47), 3), ((127, 127, 127), 4), ((511, 511, 511), 6),
])
def test_tail_level(grid, split):
    """The coarse tail starts at the first level from which every level
    is one tile (32 z x 8 y x 8 x points): 7³ for 2^k − 1 grids, 5³ for
    47³."""
    _, pt = params_pair(grid)
    dims = pt.level_dims()
    assert vf.tail_level(dims) == split
    assert [vf.tiles(d) == 1 for d in dims] == [
        lvl >= split for lvl in range(len(dims))
    ]


def test_tail_level_edges():
    """No tail when the coarsest level is more than a tile; a tile is 32
    points along z and 8 along x and y."""
    assert vf.tail_level([(63, 63, 63), (31, 31, 31)]) is None
    assert vf.tiles((8, 8, 32)) == 1
    assert vf.tiles((8, 8, 33)) == vf.tiles((9, 8, 32)) == 2
    assert vf.tiles((8, 9, 32)) == 2
    assert vf.tail_level([(16, 8, 64), (8, 4, 32), (4, 2, 16)]) == 1
    assert vf.tail_level([(8, 8, 32)]) == 0


@pytest.mark.parametrize("mode", list(Mode), ids=lambda m: m.name)
@pytest.mark.parametrize("grid", [(15, 15, 15), (47, 47, 47)])
def test_mark_tail(grid, mode):
    """The coarse tail's range starts at the restriction into the split
    level and covers every op down to the coarsest and back up to the
    split level's last post-sweep; the cycle's table is the schedule as
    it is."""
    _, pt = params_pair(grid, mode)
    ops, _ = vf.schedule(pt.num_levels, mode, 6, 6)
    split = vf.tail_level(pt.level_dims())
    table, _, (begin, end) = vf._schedule_for(pt)
    assert table == ops
    assert (begin, end) == vf.tail_range(ops, split)
    run = ops[begin:end]
    assert run[0][0] in (vf.RESTRICT, vf.RESTRICT_V)
    assert run[0][1] == split - 1
    assert run[-1][:2] == (vf.SMOOTH, split)
    assert ops[end][:2] == (vf.PROLONG, split)
    assert min(op[1] for op in run) >= split - 1
    assert vf.tail_range(ops, None) == (0, 0)


# Taps that are not the canonical 7-point order: the CUDA kernel runs
# them through the body that indexes the level table (the norm included),
# and chip_smoke.py holds it against this plain version with them.
STENCILS = {
    "reordered": tcfg.Stencil(
        values=(6.2, -1.1, -0.9, -1.05, -0.97, -1.0, -1.13),
        offsets=((0, 0, 0), (0, 0, -1), (0, 1, 0), (-1, 0, 0), (0, 0, 1),
                 (1, 0, 0), (0, -1, 0)),
    ),
    "five": tcfg.Stencil(
        values=(4.0, -1.0, -1.0, -1.0, -1.0),
        offsets=((0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0)),
    ),
}


def _two_cycles_equal_batch(pt, seed):
    """Two cycles of the plain v1 and of the batch engine from the same
    seeded level-0 v (and ũ), bit for bit (FAS coarse v as v − rest_v)."""
    dims = pt.grid_dim
    a = tgrid.build_grid(pt, device="cpu")
    b = tgrid.build_grid(pt, device="cpu")
    rng = np.random.default_rng(seed)
    v0 = torch.from_numpy(rng.standard_normal(dims, np.float32) * 0.05)
    for s in (a, b):
        s.levels[0].v[1:-1, 1:-1, 1:-1] = v0
        if pt.mode == Mode.NEWTON:
            s.levels[0].newton_v[1:-1, 1:-1, 1:-1] = v0 * 4
    for _ in range(2):
        got = vf.vcycle_fused_plain(a.levels, pt)
        want = vcycle_batch.run(b, pt, maxk=1)
        assert float(got[0]) == float(want[0])
        for i, (la, lb) in enumerate(zip(a.levels, b.levels)):
            va = la.v - la.rest_v if pt.mode == Mode.NONLINEAR and i else la.v
            assert torch.equal(va, lb.v) and torch.equal(la.f, lb.f)


@pytest.mark.parametrize("mode", list(Mode), ids=lambda m: m.name)
def test_plain_v1_tail_at_odd_level_equals_batch_cycle(mode):
    """47³ V(6,6), whose tail starts at 5³ (odd, not a multiple of 8):
    two cycles of the plain v1 and of the batch engine, bit for bit (FAS
    coarse v as v − rest_v)."""
    _, pt = params_pair((47, 47, 47), mode)
    assert vf.tail_level(pt.level_dims()) == 3
    _two_cycles_equal_batch(pt, 5)


def test_plain_v1_tail_at_odd_level_matches_jax_vcycle():
    """47³ V(6,6) LINEAR against the JAX package's vcycle, with the
    tolerances of test_plain_v1_matches_jax_vcycle."""
    dims = (47, 47, 47)
    pj, pt = params_pair(dims, Mode.LINEAR)
    jstate, tstate = seeded_pair(pj, pt)
    want_state, want_res = jvc.vcycle(
        jstate, params=jvc.trace_params(pj), shardings=None
    )
    sumsq = vf.vcycle_fused_plain(tstate.levels, pt)
    got_res = float(np.sqrt(np.float32(sumsq[0])))
    assert got_res == pytest.approx(float(want_res), rel=2e-4)
    want_v = crop(want_state.levels[0].v, dims)
    scale = np.abs(want_v).max()
    np.testing.assert_allclose(
        tstate.levels[0].v.numpy(), want_v, rtol=2e-4, atol=2e-5 * scale
    )


@pytest.mark.parametrize("mode", list(Mode), ids=lambda m: m.name)
@pytest.mark.parametrize("taps", list(STENCILS))
@pytest.mark.parametrize("dims", [(15, 15, 15), (33, 17, 9)])
def test_plain_v1_other_taps_equals_batch_cycle(dims, taps, mode):
    """The taps reordered, and five taps, at the shapes chip_smoke.py runs
    them: two cycles of the plain v1 and of the batch engine, bit for
    bit."""
    _, pt = params_pair(dims, mode)
    _two_cycles_equal_batch(pt.replace(stencil=STENCILS[taps]), 11)
