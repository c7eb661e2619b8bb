"""Multigrid cycle, residual norm and the solve loop (LINEAR and FAS; the
inner solve of NEWTON).

The counterpart of ``gpusolve_tpu/solver/vcycle.py``.  ``solve`` always
runs the batched loop of the JAX package's ``_solve_fused2``: batches of up
to ``check_every`` cycles (``ops/vcycle_batch.run``), each with an early
stop on the device and one host sync, followed by a host re-check of every
returned norm with the reference's stop test, written verbatim as
``res <= initial / (1.0 / tol)``.  The device threshold is that test
squared, biased up by 2 ulps, so the device stops whenever the host would;
batching changes neither the residual history nor the final state, only
how many cycles share a sync.

The cycle (V, W or F) is the recursion ``cycle_at`` in
``ops/vcycle_batch.py``: the coarsest level is smoothed only (pre + post
sweeps); a coarse v starts at zero on each visit of its parent (LINEAR,
NEWTON) or at the restricted fine v (FAS).  NEWTON's outer loop, which
runs this solve as its inner linear solve, is ``solver/newton.py``.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np

from gpusolve_tpu_torch.config import GridParams
from gpusolve_tpu_torch.grid import GridState
from gpusolve_tpu_torch.ops import dispatch as ops
from gpusolve_tpu_torch.ops import vcycle_batch
from gpusolve_tpu_torch.utils.timer import Timer


def _np_dtype(state: GridState):
    return np.dtype(str(state.levels[0].v.dtype).removeprefix("torch."))


def vcycle(state: GridState, params: GridParams) -> Tuple[GridState, float]:
    """One cycle of ``params.cycle_type``; returns the state (updated in
    place) and the finest-level residual norm."""
    norms = vcycle_batch.run(state, params, maxk=1)
    return state, float(np.sqrt(norms[0]))


def residual_norm(
    state: GridState, params: GridParams
) -> Tuple[GridState, float]:
    """The mode's residual at the finest level, stored in level 0's r, and
    its norm."""
    lvl = state.levels[0]
    sumsq = lvl.v.new_empty(1)
    ops.residual_op(
        lvl.r, lvl.v, lvl.f, params.level_dims()[0], params,
        params.level_h(0), norm_out=sumsq, newton_v=lvl.newton_v,
    )
    return state, float(np.sqrt(sumsq.cpu().numpy()[0]))


def _solve_batched(
    state: GridState,
    params: GridParams,
    timer: Optional[Timer],
    initial: float,
    history: List[float],
    check_every: int,
) -> Tuple[GridState, List[float]]:
    """Batches of up to ``check_every`` cycles with the early stop on the
    device, then the verbatim host stop test on every returned norm."""
    dt = _np_dtype(state)
    k = max(1, min(check_every, params.maxiter))
    thr = dt.type((initial / (1.0 / params.tol)) ** 2)
    thr = np.nextafter(
        np.nextafter(thr, dt.type(np.inf), dtype=dt),
        dt.type(np.inf), dtype=dt,
    )
    i = 0
    done = False
    while i < params.maxiter and not done:
        m = min(k, params.maxiter - i)
        t0 = time.perf_counter()
        arr = vcycle_batch.run(
            state, params, maxk=k, ncyc=m, thr=float(thr), timer=timer
        )
        batch_ms = (time.perf_counter() - t0) * 1000.0
        executed = [float(x) for x in arr if x >= 0.0]
        if not executed:  # defensive: a batch runs at least one cycle
            break
        per_ms = int(batch_ms / len(executed))
        for x in executed:
            res = float(np.sqrt(dt.type(x)))
            history.append(res)
            if params.print_progress:
                line = f"iter: {i} residual: {res:.6g} Took {per_ms}ms"
                if timer is not None:
                    line += timer.suffix()
                print(line)
            i += 1
            if res <= initial / (1.0 / params.tol):
                done = True
                break
    return state, history


def solve(
    state: GridState,
    params: GridParams,
    timer: Optional[Timer] = None,
    initial_residual: Optional[float] = None,
    check_every: int = 1,
) -> Tuple[GridState, List[float]]:
    """Iterate cycles until ``res <= initialResidual·tol`` or ``maxiter``.

    Returns the final state (updated in place) and the residual history
    ``[initial, res_0, res_1, ...]``.

    ``initial_residual``: when given (a resumed run), the stop threshold
    uses it instead of recomputing one from the state, so the resumed solve
    stops exactly where the uninterrupted run would, and the history omits
    the leading initial entry.
    """
    if timer is None and params.print_progress:
        timer = Timer()
    if initial_residual is None:
        state, initial = residual_norm(state, params)
        if params.print_progress:
            print(f"Inital residual: {initial:.6g}")
        history = [initial]
    else:
        initial = float(initial_residual)
        history = []
    return _solve_batched(state, params, timer, initial, history, check_every)
