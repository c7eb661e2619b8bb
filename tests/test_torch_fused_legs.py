"""The batch engine's fused legs (ops/kernels.py ``down_leg`` / ``up_leg``,
csrc/mg_legs.cu) on the CPU, where each runs its plain version.

  * ``down_leg_plain`` / ``up_leg_plain`` against the per-op schedule they
    replace (the dispatch ops the batch engine ran before them, on the
    plain ops), bit for bit, in the three modes at S = 1, 2, 3;
  * the batch engine on the legs against the JAX package's whole-batch
    kernel (``pv2.vcycle2_fused``, interpret mode) in each mode, rtol 2e-4
    as tests/test_torch_solver.py;
  * the early stop with pre + post odd on the legs: the state after the
    stop is the state after the executed cycles;
  * the batched Newton loop's choice of level 0's v buffer (one buffer on
    the legs, two on a per-op schedule with odd sweeps), against the
    per-step loop bit for bit;
  * ``launches_per_cycle`` against the ops a cycle calls (each plain op
    counted once, the plain ops inside a plain leg not);
  * the port's ``__all__`` against the JAX package's.

Inputs are made with numpy from a seed.  On the card chip_smoke.py holds
each leg's kernel against its plain version."""

import numpy as np
import pytest
import torch

import gpusolve_tpu as gs
import gpusolve_tpu.dist as jdist
from gpusolve_tpu.ops import pallas_vcycle2 as pv2
import gpusolve_tpu_torch as gt
import gpusolve_tpu_torch.dist as tdist
from gpusolve_tpu_torch import config as tcfg
from gpusolve_tpu_torch import grid as tgrid
from gpusolve_tpu_torch.ops import dispatch as ops
from gpusolve_tpu_torch.ops import kernels, ref, vcycle_batch
from gpusolve_tpu_torch.solver import vcycle as tvc
from test_torch_newton_batch import fields, seeded_state, solve_counted

CYCLE_TOL = 2e-4
F32 = np.float32
# A stencil with an edge tap: the legs refuse it, so each visit runs the
# per-op schedule.
EDGE = tcfg.Stencil(
    values=(6.5, -1.0, -1.0, -1.0, -1.0, -1.0, -1.0),
    offsets=((0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
             (0, 0, 1), (1, 1, 0)),
)


def params(dims=(15, 15, 15), **kw):
    base = dict(
        maxiter=3, tol=1e-12, grid_dim=dims, mode=0, pre_smoothing=3,
        post_smoothing=3, omega=0.8, gamma=1.0, dtype="float32",
        print_progress=False,
    )
    base.update(kw)
    return tcfg.GridParams(stencil=tcfg.Stencil.poisson_7pt(), **base)


def jax_params(dims=(15, 15, 15), **kw):
    base = dict(
        maxiter=3, tol=1e-12, grid_dim=dims, mode=0, pre_smoothing=3,
        post_smoothing=3, omega=0.8, gamma=1.0, dtype="float32",
        print_progress=False,
    )
    base.update(kw)
    return gs.GridParams(stencil=gs.Stencil.poisson_7pt(), backend="xla",
                         **base)


def field(dims, rng, scale):
    a = torch.zeros(tuple(d + 2 for d in dims))
    ref.interior(a, dims).copy_(
        torch.from_numpy((scale * rng.standard_normal(dims)).astype(F32)))
    return a


def leg_inputs(mode, dims, seed):
    rng = np.random.default_rng(seed)
    cd = tuple(d // 2 for d in dims)
    return dict(
        v=field(dims, rng, 0.5), f=field(dims, rng, 50.0),
        nv=field(dims, rng, 0.3) if mode == 2 else None,
        vc=field(cd, rng, 0.5), cd=cd,
    )


# ---------------------------------------------------------------------------
# The plain legs against the per-op schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", [0, 1, 2], ids=["linear", "fas", "newton"])
@pytest.mark.parametrize("sweeps", [1, 2, 3])
def test_down_leg_plain_is_per_op_visit(mode, sweeps):
    dims = (33, 17, 9)
    p = params(dims, mode=mode)
    x = leg_inputs(mode, dims, 100 * mode + sweeps)
    h = p.level_h(0)
    fas = mode == 1
    got = [torch.full_like(x["v"], 7.0)] + [
        torch.full_like(x["vc"], 3.0) for _ in range(3)]
    kernels.down_leg_plain(got[0], x["v"], x["f"], got[1], got[2], dims,
                           x["cd"], p, h, sweeps, None, x["nv"],
                           got[3] if fas else None)
    # The per-op visit: sweeps ping-ponging with the spare, the residual
    # into the spare, the restriction(s).
    want = [t.clone() for t in (torch.full_like(x["v"], 7.0),) + tuple(
        torch.full_like(x["vc"], 3.0) for _ in range(3))]
    v, spare = ops.smooth(x["v"].clone(), x["f"], torch.zeros_like(x["v"]),
                          dims, p, h, sweeps, None, x["nv"])
    r = torch.zeros_like(v)
    ops.residual_op(r, v, x["f"], dims, p, h, newton_v=x["nv"])
    if fas:
        ops.restrict_op(want[1], r, dims, x["cd"], p)
        ops.restrict_op(want[2], v, dims, x["cd"], p, out2=want[3])
    else:
        ops.restrict_zero_op(want[1], want[2], r, dims, x["cd"], p)
    ref.interior(want[0], dims).copy_(ref.interior(v, dims))
    for name, a, b in zip(("v", "f_coarse", "v_coarse", "rest_v"), got,
                          want):
        assert torch.equal(a, b), name
    assert (got[0][0] == 7.0).all()  # the halo is not written


@pytest.mark.parametrize("mode", [0, 1, 2], ids=["linear", "fas", "newton"])
@pytest.mark.parametrize("sweeps", [1, 2, 3])
def test_up_leg_plain_is_per_op_visit(mode, sweeps):
    dims = (33, 17, 9)
    p = params(dims, mode=mode)
    x = leg_inputs(mode, dims, 200 + 100 * mode + sweeps)
    h = p.level_h(0)
    out = torch.full_like(x["v"], 5.0)
    partials = kernels.up_leg_plain(out, x["v"], x["vc"], x["f"], dims,
                                    x["cd"], p, h, sweeps, None, x["nv"],
                                    with_norm=True)
    v = x["v"].clone()
    ops.prolong_add_op(v, x["vc"], x["cd"], dims, p)
    v, _ = ops.smooth(v, x["f"], torch.zeros_like(v), dims, p, h, sweeps,
                      None, x["nv"])
    assert torch.equal(ref.interior(out, dims), ref.interior(v, dims))
    assert (out[0] == 5.0).all()
    norm = torch.empty(1)
    ops.residual_op(None, v, x["f"], dims, p, h, write_r=False,
                    norm_out=norm, newton_v=x["nv"])
    got = torch.empty(1)
    kernels.finalize_plain(partials, got)
    assert torch.equal(got, norm)
    assert kernels.up_leg_plain(out, x["v"], x["vc"], x["f"], dims, x["cd"],
                                p, h, sweeps, None, x["nv"]) is None


def test_leg_gates():
    """1..5 sweeps and face taps; a set ``done`` writes nothing."""
    p = params()
    assert kernels.legs_take(p.stencil, 1) and kernels.legs_take(p.stencil, 5)
    assert not kernels.legs_take(p.stencil, 0)
    assert not kernels.legs_take(p.stencil, 6)
    assert not kernels.legs_take(EDGE, 3)
    assert vcycle_batch.legs(p.replace(pre_smoothing=6)) == (False, True)
    with pytest.raises(ValueError, match="face taps"):
        kernels.down_leg_plain(*[None] * 7, p, 1.0, 6)
    dims = (15, 15, 15)
    x = leg_inputs(0, dims, 5)
    done = torch.ones(1, dtype=torch.int32)
    out = torch.full_like(x["v"], 7.0)
    fc = torch.full_like(x["vc"], 3.0)
    kernels.down_leg_plain(out, x["v"], x["f"], fc, fc.clone(), dims,
                           x["cd"], p, 1.0, 3, done)
    part = kernels.up_leg_plain(out, x["v"], x["vc"], x["f"], dims, x["cd"],
                                p, 1.0, 3, done, with_norm=True)
    assert (out == 7.0).all() and (fc == 3.0).all() and part.item() == 0.0


# ---------------------------------------------------------------------------
# The batch engine on the legs against the JAX package's v2 kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", [0, 1, 2], ids=["linear", "fas", "newton"])
def test_batch_on_legs_matches_pallas_vcycle2_interpret(mode, monkeypatch):
    dims = (15, 15, 15)
    pj, pt = jax_params(dims, mode=mode), params(dims, mode=mode)
    if mode == 2:
        from test_torch_newton import from_jax, with_levels

        rng = np.random.default_rng(7)
        jstate = gs.build_grid(pj)
        seeded = []
        for d, lvl in zip(pj.level_dims(), jstate.levels):
            nv = np.zeros(lvl.v.shape, F32)
            nv[1:d[0] + 1, 1:d[1] + 1, 1:d[2] + 1] = (
                0.2 * rng.standard_normal(d))
            seeded.append({"newton_v": nv})
        jstate = with_levels(jstate, seeded)
        state = from_jax(pt, jstate)
    else:
        jstate = gs.build_grid(pj)
        state = tgrid.build_grid(pt, device="cpu")
    calls = []
    for name in ("down_leg", "up_leg"):
        fn = getattr(kernels, f"{name}_plain")
        monkeypatch.setattr(kernels, f"{name}_plain",
                            lambda *a, _f=fn, _n=name, **k:
                            calls.append(_n) or _f(*a, **k))
    fields_j, norms = pv2.vcycle2_fused(jstate.levels, pj, max_cycles=2,
                                       interpret=True)
    got = vcycle_batch.run(state, pt, maxk=2)
    # 15³ has 4 levels: 3 non-coarsest visits a cycle, 2 cycles.
    assert calls.count("down_leg") == calls.count("up_leg") == 6
    np.testing.assert_allclose(got, np.asarray(norms), rtol=CYCLE_TOL)
    want = np.asarray(fields_j[0][0])[:17, :17, :17]
    np.testing.assert_allclose(
        state.levels[0].v.numpy(), want, rtol=CYCLE_TOL,
        atol=0.1 * CYCLE_TOL * np.abs(want).max())


# ---------------------------------------------------------------------------
# The early stop with pre + post odd
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", [0, 1, 2], ids=["linear", "fas", "newton"])
def test_early_stop_odd_sweeps_on_legs(mode):
    """V(2,1) on the legs: a threshold between the cycle-1 and cycle-2
    norms stops a batch of 4 after cycle 2; every level's v, f, rest_v and
    ũ equal two cycles' (the coarsest level still trades its buffers)."""
    p = params(mode=mode, pre_smoothing=2, post_smoothing=1)
    two = seeded_state(p) if mode == 2 else tgrid.build_grid(p, "cpu")
    want = vcycle_batch.run(two, p, maxk=2)
    thr = float(F32((want[0] + want[1]) / 2))
    state = seeded_state(p) if mode == 2 else tgrid.build_grid(p, "cpu")
    held = []
    norms = torch.full((4,), -1.0)
    done = torch.zeros(1, dtype=torch.int32)
    held.append([(lvl.v, lvl.r) for lvl in state.levels])
    vcycle_batch.enqueue(state.levels, p, 4, norms, done, held, thr)
    got = norms.numpy()
    assert got[0] > thr and got[1] <= thr and (got[2:] == -1.0).all()
    np.testing.assert_array_equal(got[:2], want)
    # Level 0 (and every non-coarsest level) ends each cycle in its buffer.
    for lev in range(len(state.levels) - 1):
        assert all(h[lev][0] is held[0][lev][0] for h in held)
    vcycle_batch.hand_over(state.levels, held, 2)
    for a, b in zip(state.levels, two.levels):
        for n in ("v", "f", "rest_v", "newton_v"):
            x, y = getattr(a, n), getattr(b, n)
            assert (x is None) == (y is None)
            if x is not None:
                assert torch.equal(x, y), n


# ---------------------------------------------------------------------------
# The batched Newton loop's buffer choice
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stencil", ["canonical", "edge"])
def test_newton_batched_buffer_choice(stencil, monkeypatch):
    """V(2,1) Newton, batched (K = 3) against the per-step loop, bit for
    bit: on the legs level 0's v stays in one buffer; with an edge tap
    each visit runs the per-op schedule and its 3 sweeps move v to the
    spare every cycle, so ``newton_update`` picks between two buffers."""
    monkeypatch.setattr(tvc, "_fused_capable", lambda p, device: True)
    p = params(mode=2, maxiter=4, tol=1e-3, pre_smoothing=2,
               post_smoothing=1)
    if stencil == "edge":
        p = p.replace(stencil=EDGE)
    picked = []
    upd = kernels.newton_update_plain

    def spy(nv, v_after, norms, dims, done):
        picked.append(len({id(t) for t in v_after}))
        return upd(nv, v_after, norms, dims, done)

    monkeypatch.setattr(kernels, "newton_update_plain", spy)
    ref_state, want, _ = solve_counted(seeded_state(p), p)
    state, got, _ = solve_counted(seeded_state(p), p, check_every=3)
    assert got == want and len(got) > 2
    assert set(picked) == ({1} if stencil == "canonical" else {2})
    for (n, i, a), (_, _, b) in zip(fields(state), fields(ref_state)):
        assert torch.equal(a, b), f"level {i} {n}"


# ---------------------------------------------------------------------------
# launches_per_cycle
# ---------------------------------------------------------------------------

PLAIN = ("jacobi_sweep", "residual", "restrict_zero", "restrict",
         "prolong_add", "apply_fas", "subtract", "finalize", "down_leg",
         "up_leg")


def _base(name):
    for base in (name.removesuffix("_fas"), name.removesuffix("_newton")):
        if base != name and base in kernels.KERNELS:
            return base
    return name


@pytest.mark.parametrize("mode,cycle,pre,post,edge", [
    (0, "V", 3, 3, False), (1, "V", 3, 3, False), (2, "V", 2, 1, False),
    (1, "W", 3, 3, False), (0, "F", 1, 5, False), (0, "V", 6, 2, False),
    (1, "V", 2, 6, False), (0, "V", 3, 3, True),
])
def test_launches_per_cycle_counts(monkeypatch, mode, cycle, pre, post,
                                   edge):
    p = params(mode=mode, cycle_type=cycle, pre_smoothing=pre,
               post_smoothing=post)
    if edge:
        p = p.replace(stencil=EDGE)
    state = seeded_state(p) if mode == 2 else tgrid.build_grid(p, "cpu")
    counted, depth = {}, [0]
    for name in PLAIN:
        fn = getattr(kernels, f"{name}_plain")

        def count(*a, _fn=fn, _name=name, **k):
            if depth[0] == 0:
                counted[_name] = counted.get(_name, 0) + 1
            depth[0] += 1
            try:
                return _fn(*a, **k)
            finally:
                depth[0] -= 1

        monkeypatch.setattr(kernels, f"{name}_plain", count)
    vcycle_batch.run(state, p, maxk=1)
    want = {}
    for name, n in vcycle_batch.launches_per_cycle(p).items():
        want[_base(name)] = want.get(_base(name), 0) + n
    assert counted == want


# ---------------------------------------------------------------------------
# The public names
# ---------------------------------------------------------------------------

# The JAX package's distributed names the port has not yet: none since the
# GSPMD engine (dist/sharding.py) and the multi-host helpers were ported.
WAITING = set()


def test_all_matches_jax_package():
    assert set(gs.__all__) <= set(gt.__all__)
    for name in gt.__all__:
        assert hasattr(gt, name), name
    assert callable(gt.solve_refine)
    missing = set(jdist.__all__) - set(tdist.__all__)
    assert missing == WAITING
    assert set(jdist.__all__) <= set(tdist.__all__)
