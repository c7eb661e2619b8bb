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

The outer loop reads F's norm on the host once per step (the inner solve
reads its batch's norms once more), as the JAX package's unbatched loop
does; the history is the same as its device-batched loop's
(``_newton_batch``), which is not ported yet.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np

from gpusolve_tpu_torch.config import GridParams, Mode
from gpusolve_tpu_torch.grid import GridState
from gpusolve_tpu_torch.ops import dispatch as ops
from gpusolve_tpu_torch.solver import vcycle as vc
from gpusolve_tpu_torch.utils.timer import Timer

INNER_MAXITER = 10
INNER_TOL = 0.1


def comp_f(
    state: GridState, params: GridParams, timer: Optional[Timer] = None
) -> float:
    """The nonlinear residual ``F = newton_f − (A·ũ/h² + γ·ũ·e^ũ)`` on the
    finest level, written into level 0's f; returns ‖F‖₂ (one host sync,
    timed as ``sumBuffer`` when a timer is given).  It is the NONLINEAR
    residual at v = ũ against the original RHS."""
    lvl = state.levels[0]
    sumsq = lvl.v.new_empty(1)
    ops.residual_op(
        lvl.f, lvl.newton_v, state.newton_f, params.level_dims()[0],
        params.replace(mode=Mode.NONLINEAR), params.level_h(0),
        norm_out=sumsq,
    )
    if timer is not None:
        with timer.section("sumBuffer"):
            ss = sumsq.cpu().numpy()[0]
    else:
        ss = sumsq.cpu().numpy()[0]
    return float(np.sqrt(ss))


def _prepare_find_error(state: GridState, params: GridParams) -> None:
    """Zero the finest v and restrict ũ down to levels 1..L−2; the
    coarsest level's ũ is never restricted (a reference quirk)."""
    levels = state.levels
    levels[0].v.zero_()
    dims = params.level_dims()
    for i in range(1, len(levels) - 1):
        ops.restrict_op(
            levels[i].newton_v, levels[i - 1].newton_v, dims[i - 1],
            dims[i], params,
        )


def _update_newton_v(state: GridState) -> None:
    """ũ += v on the finest level (both halos are zero)."""
    lvl = state.levels[0]
    lvl.newton_v.add_(lvl.v)


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
    JAX package's per-step loop does; its device-batched loop rounds it on
    the device in float32 (gpusolve_tpu/solver/newton.py:163-166)."""
    _prepare_find_error(state, params)
    inner = params.replace(
        maxiter=INNER_MAXITER, tol=INNER_TOL, print_progress=False
    )
    _, history = vc.solve(
        state, inner, timer=timer, initial_residual=f_norm,
        check_every=inner.maxiter,
    )
    _update_newton_v(state)
    return history


def newton_solve(
    state: GridState,
    params: GridParams,
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

    ``check_every`` is taken for the JAX package's signature; the outer
    loop checks every step on the host, and its history does not depend
    on batching.
    """
    del check_every
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
