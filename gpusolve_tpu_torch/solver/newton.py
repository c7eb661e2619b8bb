"""Outer Newton iteration for ``−Δu + γ·u·eᵘ = f`` (mode 2).

The counterpart of ``gpusolve_tpu/solver/newton.py``.  Each outer step
solves the Jacobian system ``J(ũ)·e = F(ũ)`` with a short inner multigrid
solve (maxiter 10, tol 0.1) whose sweeps and residuals read the frozen
linearisation point ũ (each level's ``newton_v``), then updates ``ũ += e``.
The solution accumulates in level 0's ``newton_v``.

Reference quirks kept as the JAX package keeps them:
  * ũ is restricted to levels 1..L−2 only, never the coarsest, whose
    ``newton_v`` stays zero, so its sweeps linearise about zero;
  * the outer residual is F's norm after each step, and the stop test is
    ``res <= initial / (1.0 / tol)`` written verbatim.

Two outer loops, chosen as the JAX package chooses (its
``newton_solve``, :320-324):
  * the device-batched loop (``_newton_batch``, ``_newton_solve_batched``)
    for ``check_every=K > 1`` where the batch engine runs on the kernels
    (``vc.use_fused2``): up to K outer steps enqueued with no host read
    between them, every op gated by a device flag that the step's gate
    kernel sets at the outer stop, and one read a batch of the outer norms
    (and the inner ones, which say where each level's v lies);
  * elsewhere the per-step loop, which reads F's norm on the host once a
    step and the inner solve's norms once more.
Both leave the same history and the same state.  Under ``shardings``
(the GSPMD engine) the per-step loop runs on the sharded ops, as the JAX
package's does.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from gpusolve_tpu_torch.config import GridParams, Mode
from gpusolve_tpu_torch.dist import gspmd
from gpusolve_tpu_torch.grid import GridState
from gpusolve_tpu_torch.ops import kernels, vcycle_batch
from gpusolve_tpu_torch.solver import vcycle as vc
from gpusolve_tpu_torch.utils.timer import Timer

INNER_MAXITER = 10
INNER_TOL = 0.1


def _enqueue_comp_f(
    state: GridState,
    params: GridParams,
    sumsq: torch.Tensor,
    done: Optional[torch.Tensor] = None,
) -> None:
    """F into level 0's f and ΣF² into ``sumsq``, unless ``done`` is
    set."""
    lvl = state.levels[0]
    gspmd.ops_for(state).residual_op(
        lvl.f, lvl.newton_v, state.newton_f, params.level_dims()[0],
        params.replace(mode=Mode.NONLINEAR), params.level_h(0),
        norm_out=sumsq, done=done,
    )


def comp_f(
    state: GridState, params: GridParams, timer: Optional[Timer] = None
) -> float:
    """The nonlinear residual ``F = newton_f − (A·ũ/h² + γ·ũ·e^ũ)`` on the
    finest level, written into level 0's f; returns ‖F‖₂ (one host sync,
    timed as ``sumBuffer`` when a timer is given).  It is the NONLINEAR
    residual at v = ũ against the original RHS."""
    sumsq = state.levels[0].v.new_empty(1)
    _enqueue_comp_f(state, params, sumsq)
    return float(np.sqrt(vcycle_batch.read_host(sumsq, timer)[0]))


def _restrict_newton_v(
    state: GridState, params: GridParams, done=None
) -> None:
    """Restrict ũ down to levels 1..L−2; the coarsest level's ũ is never
    restricted (a reference quirk)."""
    levels = state.levels
    dims = params.level_dims()
    ops = gspmd.ops_for(state)
    for i in range(1, len(levels) - 1):
        ops.restrict_op(
            levels[i].newton_v, levels[i - 1].newton_v, dims[i - 1],
            dims[i], params, done,
        )


def _prepare_find_error(state: GridState, params: GridParams) -> None:
    """Zero the finest v and restrict ũ down to levels 1..L−2."""
    state.levels[0].v.zero_()
    _restrict_newton_v(state, params)


def _update_newton_v(state: GridState) -> None:
    """ũ += v on the finest level (both halos are zero at the domain's
    boundary; a placed state's ghosts are fetched anew before a read)."""
    lvl = state.levels[0]
    lvl.newton_v.add_(lvl.v)


def _inner_params(params: GridParams) -> GridParams:
    return params.replace(
        maxiter=INNER_MAXITER, tol=INNER_TOL, print_progress=False
    )


def find_error(
    state: GridState,
    params: GridParams,
    timer: Optional[Timer] = None,
    f_norm: Optional[float] = None,
) -> List[float]:
    """Solve ``J(ũ)·e = F`` with the short inner multigrid solve and update
    ũ, in place; returns the inner solve's residual history.  ``f_norm``
    is ‖F‖₂ from the preceding :func:`comp_f`: the inner system starts at
    e = 0, so its initial residual is F and the solve needs no pass of its
    own to measure it.

    The inner stop threshold is taken on the host, in float64 and then
    rounded to float32 with a 2-ulp up-bias (``solver/vcycle.py``), as the
    JAX package's per-step loop does; the device-batched loop rounds it on
    the device in float32, as the JAX package's does
    (``kernels.inner_threshold``)."""
    _prepare_find_error(state, params)
    inner = _inner_params(params)
    _, history = vc.solve(
        state, inner, timer=timer, initial_residual=f_norm,
        check_every=inner.maxiter,
    )
    _update_newton_v(state)
    return history


class _BatchBuffers:
    """The device words of a batch of up to ``k`` steps: the (k, 10) inner
    norms and the k outer norms (−1 where not run), read in one piece;
    ΣF², the inner threshold; the outer and inner flags."""

    def __init__(self, k: int, device) -> None:
        self.k = k
        n = k * INNER_MAXITER
        self.vals = torch.empty(n + k + 2, dtype=torch.float32,
                                device=device)
        self.read = self.vals[: n + k]
        self.norms = self.vals[:n].view(k, INNER_MAXITER)
        self.outer = self.vals[n : n + k]
        self.ss = self.vals[n + k : n + k + 1]
        self.thr_in = self.vals[n + k + 1 :]
        flags = torch.empty(2, dtype=torch.int32, device=device)
        self.odone, self.idone = flags[0:1], flags[1:2]


def _newton_batch(
    state: GridState,
    params: GridParams,
    nsteps: int,
    fn: float,
    thr_outer: float,
    buf: _BatchBuffers,
) -> List[List[List[Tuple[torch.Tensor, torch.Tensor]]]]:
    """Enqueue ``nsteps`` outer Newton steps with no host read (JAX:
    ``_newton_batch``, gpusolve_tpu/solver/newton.py:144-200).

    Entry contract: level 0's f holds F(ũ) and ``fn`` is its norm.  The
    seed clears both flags and writes the first inner threshold from
    ``fn``.  Each step, every op gated by the outer flag (or by the inner
    flag, which starts each step equal to it): zero level 0's v, restrict
    ũ into levels 1..L−2, 10 inner cycles (their norms into the step's
    row, the inner stop on the device threshold), ũ += v (v picked on the
    device), F and ΣF², then the gate: ‖F‖ into the step's outer slot, the
    outer stop ``res <= thr_outer``, the next step's inner threshold and
    inner flag.  A step after the outer stop writes nothing, so the state
    stays where the per-step loop stops.

    Returns, for each step, the levels' ``(v, r)`` after c of its inner
    cycles (c = 0 … 10), for the hand-over after the read."""
    levels = state.levels
    inner = _inner_params(params)
    dims0 = params.level_dims()[0]
    odone, idone, thr_in = buf.odone, buf.idone, buf.thr_in
    kernels.newton_gate(None, fn, thr_outer, None, odone, idone, thr_in)
    steps = []
    for s in range(nsteps):
        held = [[(lvl.v, lvl.r) for lvl in levels]]
        kernels.newton_zero(levels[0].v, dims0, odone)
        _restrict_newton_v(state, params, odone)
        vcycle_batch.enqueue(
            levels, inner, INNER_MAXITER, buf.norms[s], idone, held, thr_in
        )
        kernels.newton_update(
            levels[0].newton_v, [h[0][0] for h in held], buf.norms[s],
            dims0, odone,
        )
        _enqueue_comp_f(state, params, buf.ss, odone)
        kernels.newton_gate(
            buf.ss, 0.0, thr_outer, buf.outer[s : s + 1], odone, idone,
            thr_in,
        )
        steps.append(held)
    return steps


def _read_batch(
    buf: _BatchBuffers, timer: Optional[Timer]
) -> Tuple[np.ndarray, np.ndarray]:
    """The batch's one host read: the (k, 10) inner norms and the k outer
    norms, −1 where not run."""
    arr = vcycle_batch.read_host(buf.read, timer)
    n = buf.k * INNER_MAXITER
    return arr[:n].reshape(buf.k, INNER_MAXITER), arr[n:]


def _newton_solve_batched(
    state: GridState,
    params: GridParams,
    timer: Optional[Timer],
    initial: float,
    history: List[float],
    fn: Optional[float],
    k: int,
) -> Tuple[GridState, List[float]]:
    """The outer loop with batches of up to ``k`` steps and one host read
    a batch (JAX: ``_newton_solve_batched``, :203-275).  The device gate
    uses the host's stop threshold in float32 moved up 2 ulps, so it stops
    whenever the host would; the host re-checks each returned norm with
    the verbatim test, so batching changes how many steps share a read,
    not the history or the state."""
    thr = np.float32(initial / (1.0 / params.tol))
    inf = np.float32(np.inf)
    thr = np.nextafter(np.nextafter(thr, inf, dtype=np.float32), inf,
                       dtype=np.float32)
    if fn is None:
        # The resume entry: level 0's f is stale, so run the comp_f the
        # per-step loop would.
        fn = comp_f(state, params)
    buf = _BatchBuffers(k, state.device)
    i = 0
    done = False
    while i < params.maxiter and not done:
        m = min(k, params.maxiter - i)
        t0 = time.perf_counter()
        buf.read.fill_(-1.0)
        steps = _newton_batch(state, params, m, fn, float(thr), buf)
        norms, outer = _read_batch(buf, timer)
        batch_ms = (time.perf_counter() - t0) * 1000.0
        # A step ran where its slot is not −1 (≥ 0, or NaN where F is not
        # finite, which the per-step loop records too); step 0 always runs.
        ran = [s for s in range(m) if outer[s] != -1.0]
        if not ran:
            raise RuntimeError("a Newton batch returned no executed step")
        last = ran[-1]
        vcycle_batch.hand_over(
            state.levels, steps[last],
            int(np.count_nonzero(norms[last] != -1.0)),
        )
        per_ms = int(batch_ms / len(ran))
        for s in ran:
            res = float(outer[s])
            history.append(res)
            if params.print_progress:
                line = f"newton iter: {i} residual: {res:.6g} Took {per_ms}ms"
                if timer is not None:
                    line += timer.suffix()
                print(line)
            i += 1
            fn = res
            if res <= initial / (1.0 / params.tol):
                done = True
                break
    return state, history


def newton_solve(
    state: GridState,
    params: GridParams,
    shardings: Optional[tuple] = None,
    timer: Optional[Timer] = None,
    initial_residual: Optional[float] = None,
    check_every: int = 1,
) -> Tuple[GridState, List[float]]:
    """Outer Newton loop until ``res <= initial/(1/tol)`` or ``maxiter``.

    Returns the state (updated in place; the solution is level 0's
    ``newton_v``) and the outer residual history ``[initial, res_0, ...]``.

    ``initial_residual``: when given (a resumed run), the stop threshold
    uses it, the history omits the leading entry, and the first step
    recomputes F, since level 0's f may be stale.

    ``check_every=K > 1`` runs up to K outer steps per host read where the
    batch engine runs on the kernels (``vc.use_fused2``), as the JAX
    package does; elsewhere (the plain ops, float64, the v1 engine) the
    per-step loop runs.  The history and the state do not depend on it.

    ``shardings`` (``dist.level_shardings``): the GSPMD engine's per-step
    loop; a whole state is placed first, and the placed state is
    returned (``vc.solve``).
    """
    state = vc.placed(state, shardings)
    if params.mode != Mode.NEWTON:
        raise ValueError(
            f"newton_solve runs NEWTON mode, got {params.mode.name}"
        )
    if state.newton_f is None:
        raise ValueError("the state has no newton_f: build it in NEWTON mode")
    if timer is None and params.print_progress:
        timer = Timer()

    fn = None
    if initial_residual is None:
        initial = comp_f(state, params)
        if params.print_progress:
            print(f"Inital newton residual: {initial:.6g}")
        history = [initial]
        fn = initial  # level 0's f holds F; its norm seeds the first step
    else:
        initial = float(initial_residual)
        history = []

    if check_every > 1 and state.shardings is None and \
            vc.use_fused2(params, state.device):
        return _newton_solve_batched(
            state, params, timer, initial, history, fn,
            max(1, min(check_every, params.maxiter)),
        )

    for i in range(params.maxiter):
        t0 = time.perf_counter()
        if fn is None:
            fn = comp_f(state, params)
        find_error(state, params, timer=timer, f_norm=fn)
        res = comp_f(state, params, timer)
        history.append(res)
        if params.print_progress:
            ms = int((time.perf_counter() - t0) * 1000)
            line = f"newton iter: {i} residual: {res:.6g} Took {ms}ms"
            if timer is not None:
                line += timer.suffix()
            print(line)
        fn = res  # F of the new ũ is in level 0's f for the next step
        if res <= initial / (1.0 / params.tol):
            break
    return state, history
