"""The port's device-batched Newton outer loop (solver/newton.py,
``_newton_batch`` / ``_newton_solve_batched``) on the CPU: against the JAX
package's batched loop (``newton_solve(check_every=3)``, its whole-batch
kernel in interpret mode), against the port's own per-step loop bit for
bit, and the plain versions of the loop's kernels on edge inputs.

The batched loop runs where the batch engine runs on the kernels; on the
CPU ``_fused_capable`` is patched open on both sides (as
tests/test_round5.py opens it on the JAX side), so the port's batched loop
runs the kernels' plain versions.  Inputs are made with numpy from a seed.
Tolerances: against the JAX package CYCLE_TOL of tests/test_torch_newton.py
(rel 2e-4, fields with atol 0.1·CYCLE_TOL·max|want|, norms above the
float32 floor, 1e-4 of the initial residual at 15³); against the per-step
loop, bit for bit: the history and every level's v, f and newton_v (r is
scratch: the two loops may leave different spares in it)."""

import math

import numpy as np
import pytest
import torch

import gpusolve_tpu as gs
from gpusolve_tpu.solver import vcycle as jvc
from gpusolve_tpu_torch import config as tcfg
from gpusolve_tpu_torch import grid as tgrid
from gpusolve_tpu_torch import interop
from gpusolve_tpu_torch.ops import kernels, vcycle_batch
from gpusolve_tpu_torch.solver import newton as tnewton
from gpusolve_tpu_torch.solver import vcycle as tvc
from test_torch_newton import CYCLE_TOL

import gpusolve_tpu_torch as gt

DIMS = (15, 15, 15)
F32 = np.float32


def params(**kw):
    base = dict(
        maxiter=3, tol=1e-12, grid_dim=DIMS, mode=2, pre_smoothing=3,
        post_smoothing=3, omega=0.8, gamma=1.0, dtype="float32",
        print_progress=False,
    )
    base.update(kw)
    return tcfg.GridParams(stencil=tcfg.Stencil.poisson_7pt(), **base)


def seeded_state(p, seed=31):
    """A CPU state with level 0's ũ seeded at scale 0.05."""
    state = tgrid.build_grid(p, device="cpu")
    rng = np.random.default_rng(seed)
    state.levels[0].newton_v[1:-1, 1:-1, 1:-1] = torch.from_numpy(
        (0.05 * rng.standard_normal(p.grid_dim)).astype(F32)
    )
    return state


def fields(state):
    return [(n, i, getattr(lvl, n)) for i, lvl in enumerate(state.levels)
            for n in ("v", "f", "newton_v")]


@pytest.fixture
def batched(monkeypatch):
    """Open the batched loop on CPU tensors."""
    monkeypatch.setattr(tvc, "_fused_capable", lambda p, device: True)


def solve_counted(state, p, **kw):
    """newton_solve, with the host reads it made and the kernel launches
    (none on the CPU)."""
    kernels.reset_launches()
    r0 = vcycle_batch.host_reads
    state, hist = gt.newton_solve(state, p, **kw)
    assert all(n == 0 for n in kernels.launches.values())
    return state, hist, vcycle_batch.host_reads - r0


# ---------------------------------------------------------------------------
# (a) against the JAX package's batched loop
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_batched():
    """The JAX package's newton_solve(check_every=3) at 15³, maxiter 3,
    V(3,3), its whole-batch kernel in interpret mode (~12 s): run once."""
    pj = gs.GridParams(
        maxiter=3, tol=1e-12, grid_dim=DIMS, mode=gs.Mode.NEWTON,
        pre_smoothing=3, post_smoothing=3, omega=0.8, gamma=1.0,
        stencil=gs.Stencil.poisson_7pt(), dtype="float32",
        print_progress=False,
    )
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvc, "_fused_capable", lambda p, s: True)
        jstate, hist = gs.newton_solve(gs.build_grid(pj), pj, check_every=3)
    nv = np.asarray(jstate.levels[0].newton_v)[: DIMS[0] + 2,
                                               : DIMS[1] + 2, : DIMS[2] + 2]
    return hist, nv


def test_batched_matches_jax_batched(jax_batched, batched):
    want, want_nv = jax_batched
    p = params()
    state, got, reads = solve_counted(
        tgrid.build_grid(p, device="cpu"), p, check_every=3
    )
    assert reads == 2  # the initial F, one batch
    assert len(got) == len(want) == 4
    above = [i for i, w in enumerate(want) if w >= 1e-4 * want[0]]
    assert len(above) >= 3
    np.testing.assert_allclose(np.asarray(got)[above],
                               np.asarray(want)[above], rtol=CYCLE_TOL)
    np.testing.assert_allclose(
        state.levels[0].newton_v.numpy(), want_nv, rtol=CYCLE_TOL,
        atol=0.1 * CYCLE_TOL * np.abs(want_nv).max(),
    )


# ---------------------------------------------------------------------------
# (b) against the port's own per-step loop, bit for bit
# ---------------------------------------------------------------------------

CASES = {
    "V(3,3)": (dict(), 3),
    "V(2,1)": (dict(pre_smoothing=2, post_smoothing=1), 3),
    "W": (dict(cycle_type="W"), 3),
    "stop mid-batch": (dict(maxiter=8, tol=1e-3), 8),
    "stop at a batch's end": (dict(maxiter=8, tol=1e-3), 3),
    "V(2,1) stop mid-batch": (
        dict(maxiter=8, tol=1e-3, pre_smoothing=2, post_smoothing=1), 8),
}


@pytest.mark.parametrize("case", list(CASES))
def test_batched_equals_per_step(case, batched):
    kw, k = CASES[case]
    p = params(**kw)
    ref, want, ref_reads = solve_counted(seeded_state(p), p)
    state, got, reads = solve_counted(seeded_state(p), p, check_every=k)
    steps = len(want) - 1
    assert got == want
    assert ref_reads == 1 + 2 * steps
    assert reads == 1 + math.ceil(steps / k)
    if "stop" in case:
        assert steps < p.maxiter
        assert (steps % k != 0) == ("mid-batch" in case)
    for (n, i, a), (_, _, b) in zip(fields(state), fields(ref)):
        assert torch.equal(a, b), f"level {i} {n}"


def test_batched_resume_equals_per_step(batched):
    """The resume entry (``initial_residual`` given): the batch's comp_f
    first, then the same steps as the per-step loop."""
    p = params(maxiter=1)
    head_state, head = gt.newton_solve(seeded_state(p), p)
    p = params(maxiter=4)
    copies = []
    for _ in range(2):
        fl = [{n: getattr(lvl, n).numpy().copy()
               for n in ("v", "f", "newton_v")}
              for lvl in head_state.levels]
        copies.append(interop.state_from_numpy(
            p, fl, device="cpu",
            newton_f=head_state.newton_f.numpy().copy()))
    ref, want, _ = solve_counted(copies[0], p, initial_residual=head[0])
    state, got, reads = solve_counted(copies[1], p, initial_residual=head[0],
                                      check_every=3)
    assert len(got) == 4 and got == want
    assert reads == 1 + 2  # the resume's comp_f, two batches
    for (n, i, a), (_, _, b) in zip(fields(state), fields(ref)):
        assert torch.equal(a, b), f"level {i} {n}"


def test_check_every_keeps_per_step_loop_off_the_kernels():
    """Where the batch engine does not run on the kernels (here: CPU
    tensors, unpatched) ``check_every`` leaves the per-step loop."""
    p = params(maxiter=2)
    _, hist, reads = solve_counted(seeded_state(p), p, check_every=2)
    assert reads == 1 + 2 * 2 and len(hist) == 3


# ---------------------------------------------------------------------------
# (c) the loop's kernels' plain versions on edge inputs
# ---------------------------------------------------------------------------


def numpy_inner_threshold(fn):
    """gpusolve_tpu/solver/newton.py:176-179 in numpy float32."""
    t = (F32(fn) * F32(0.1)) ** 2
    t = np.nextafter(t, F32(np.inf), dtype=F32)
    return np.nextafter(t, F32(np.inf), dtype=F32)


def gate_words(odone=0, idone=0, thr_in=-5.0, res=-1.0):
    i32 = torch.int32
    return (torch.tensor([odone], dtype=i32), torch.tensor([idone], dtype=i32),
            torch.tensor([thr_in]), torch.tensor([res]))


@pytest.mark.filterwarnings("ignore:overflow encountered")
def test_gate_threshold_matches_numpy_float32():
    """The inner threshold from ‖F‖ bit for bit against numpy's float32
    formula, over norms whose squares underflow, round and overflow."""
    rng = np.random.default_rng(5)
    fns = np.concatenate([
        rng.random(200) * 10.0 ** rng.integers(-30, 30, 200),
        [0.0, 1.0, 2253.0, 7.33, 1e-38, 3.4e38, np.inf],
    ]).astype(F32)
    for fn in fns:
        od, idn, thr_in, _ = gate_words(1, 1)
        kernels.newton_gate_plain(None, float(fn), 0.5, None, od, idn,
                                  thr_in)
        want = numpy_inner_threshold(fn)
        assert thr_in.numpy()[0].tobytes() == want.tobytes(), fn
        assert kernels.inner_threshold(fn).tobytes() == want.tobytes()
        assert int(od) == 0 and int(idn) == 0


def test_gate_stops_at_thr_outer_exactly():
    """The stop is ``res <= thr_outer``: set at res equal to it, clear one
    ulp above; res is ΣF²'s float32 root, correctly rounded (26.888361's
    is one a 1-ulp-off root would miss)."""
    thr_outer = F32(0.25)
    up = np.nextafter(thr_outer, F32(1), dtype=F32)
    for ss, res_want, stop in ((thr_outer * thr_outer, thr_outer, 1),
                               (up * up, up, 0),
                               (F32(0.0), F32(0.0), 1),
                               (F32(26.888361), F32(5.185399), 0)):
        od, idn, thr_in, res = gate_words()
        kernels.newton_gate_plain(torch.tensor([ss]), 0.0, float(thr_outer),
                                  res, od, idn, thr_in)
        assert res.numpy()[0] == res_want == np.sqrt(F32(ss))
        assert int(od) == int(idn) == stop
        assert thr_in.numpy()[0] == numpy_inner_threshold(res_want)


def test_gate_writes_nothing_when_done():
    od, idn, thr_in, res = gate_words(odone=1, idone=1)
    kernels.newton_gate_plain(torch.tensor([4.0]), 0.0, 1e9, res, od, idn,
                              thr_in)
    assert (int(od), int(idn), float(thr_in), float(res)) == (1, 1, -5.0,
                                                              -1.0)


def test_finalize_dev_thr_plain():
    parts = torch.tensor([0.5, 0.25], dtype=torch.float64)
    for thr, stop in ((0.75, 1), (float(np.nextafter(F32(0.75), F32(0))), 0),
                      (-1.0, 0)):
        out = torch.tensor([-1.0])
        done = torch.zeros(1, dtype=torch.int32)
        kernels.finalize_dev_thr_plain(parts, out, torch.tensor([thr]), done)
        assert float(out) == 0.75 and int(done) == stop
    out = torch.tensor([-1.0])
    done = torch.ones(1, dtype=torch.int32)
    kernels.finalize_dev_thr_plain(parts, out, torch.tensor([1.0]), done)
    assert float(out) == -1.0 and int(done) == 1


def padded_field(rng, dims, halo=float("nan")):
    a = torch.full(tuple(d + 2 for d in dims), halo)
    a[1:-1, 1:-1, 1:-1] = torch.from_numpy(
        rng.standard_normal(dims).astype(F32))
    return a


def test_newton_zero_plain():
    dims = (5, 3, 4)
    rng = np.random.default_rng(8)
    v = padded_field(rng, dims)
    before = v.clone()
    kernels.newton_zero_plain(v, dims, torch.ones(1, dtype=torch.int32))
    assert torch.equal(v.nan_to_num(), before.nan_to_num())
    kernels.newton_zero_plain(v, dims, torch.zeros(1, dtype=torch.int32))
    assert not v[1:-1, 1:-1, 1:-1].any()
    assert v.isnan().sum() == before.isnan().sum()  # the halo kept


@pytest.mark.parametrize("ran", [0, 1, 3, 10])
def test_newton_update_plain_picks_v(ran):
    """v after c cycles alternates between two buffers (odd parity); the
    update adds the one that holds it after the cycles that ran (the
    norms that are not −1), and nothing when the flag is set."""
    dims = (5, 3, 4)
    rng = np.random.default_rng(9 + ran)
    va, vb = padded_field(rng, dims, 0.0), padded_field(rng, dims, 0.0)
    v_after = [va if c % 2 == 0 else vb for c in range(11)]
    norms = torch.full((10,), -1.0)
    norms[:ran] = torch.from_numpy(rng.random(ran).astype(F32))
    nv = padded_field(rng, dims)
    want = nv.clone()
    want[1:-1, 1:-1, 1:-1] += v_after[ran][1:-1, 1:-1, 1:-1]
    kept = nv.clone()
    kernels.newton_update_plain(nv, v_after, norms, dims,
                                torch.ones(1, dtype=torch.int32))
    assert torch.equal(nv.nan_to_num(), kept.nan_to_num())
    kernels.newton_update(nv, v_after, norms, dims,
                          torch.zeros(1, dtype=torch.int32))
    assert torch.equal(nv.nan_to_num(), want.nan_to_num())
    a, b, mask = kernels._two_buffers(v_after)
    assert a is va and b is vb and mask == 0b01010101010
    with pytest.raises(ValueError, match="two buffers"):
        kernels._two_buffers([va, vb, nv])
