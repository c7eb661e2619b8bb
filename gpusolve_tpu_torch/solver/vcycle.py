"""Multigrid cycle, residual norm, the engine choice and the solve loop
(LINEAR and FAS; the inner solve of NEWTON).

The counterpart of ``gpusolve_tpu/solver/vcycle.py``.  ``solve`` picks one
of the JAX package's engines, by its gates (``use_fused2``,
``use_fused``):

  * the batch engine, the counterpart of the TPU's v2 whole-batch kernel
    (``_solve_fused2``): batches of up to ``check_every`` cycles
    (``ops/vcycle_batch.run``), each level visit as two fused legs (the
    v2 kernel's streamed passes; per op where pre or post lies outside
    1..5 or a tap is off the faces: ``legs_note``), each batch with an
    early stop on the device and one host sync, followed by a host re-check of every returned norm with
    the reference's stop test, written verbatim as
    ``res <= initial / (1.0 / tol)``.  The device threshold is that test
    squared, biased up by 2 ulps, so the device stops whenever the host
    would; batching changes neither the residual history nor the final
    state, only how many cycles share a sync;
  * the v1 whole-cycle kernel (``ops/vcycle_fused``), one cooperative
    launch per V-cycle, for the V-cycles the batch engine's sweep cap
    refuses (pre or post > 5): the JAX package's per-cycle loop, one host
    sync a cycle and the same stop test; ``check_every`` does not apply.

Off the kernels (CPU tensors, ``backend="ref"``, float64, grids under
48³, W/F cycles past the sweep cap) the batch engine runs: on the plain
ops, or on the per-op kernels where the JAX package would run its per-op
path.  The TPU layout gates of the v2 kernel (the 8-chunkable x extent,
the Mosaic pass cap, the VMEM budget, the coarsest level's residency) are
not ported: a configuration the JAX package sends to v1 only for one of
them runs the batch engine here (``--explain-backend`` says so).

Under ``shardings`` (the GSPMD engine, ``dist/gspmd.py``) the same
cycle runs on the sharded ops, per op, in the JAX package's per-cycle
loop: one host read a cycle and the verbatim stop test; ``check_every``
does not apply.

The cycle (V, W or F) is the recursion ``cycle_at`` in
``ops/vcycle_batch.py``: the coarsest level is smoothed only (pre + post
sweeps); a coarse v starts at zero on each visit of its parent (LINEAR,
NEWTON) or at the restricted fine v (FAS).  NEWTON's outer loop, which
runs this solve as its inner linear solve, is ``solver/newton.py``.
"""

from __future__ import annotations

import math
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from gpusolve_tpu_torch.config import GridParams
from gpusolve_tpu_torch.dist import gspmd
from gpusolve_tpu_torch.dist.sharding import shard_state
from gpusolve_tpu_torch.grid import GridState
from gpusolve_tpu_torch.ops import dispatch as ops
from gpusolve_tpu_torch.ops import vcycle_batch
from gpusolve_tpu_torch.ops import vcycle_fused as v1
from gpusolve_tpu_torch.utils.timer import Timer

# The JAX package's gates (gpusolve_tpu/solver/vcycle.py:191,
# gpusolve_tpu/ops/pallas_vcycle2.py:241-245).
FUSED_MIN_POINTS = 48 ** 3
V2_SWEEP_CAP = 5


def _np_dtype(state: GridState):
    return np.dtype(str(state.levels[0].v.dtype).removeprefix("torch."))


def _fused_capable(params: GridParams, device) -> bool:
    """The JAX package's gates on its fused kernels that are about the
    algorithm or the engine: the kernels run (``ops.plain_reason``: not
    ``backend="ref"``, float32, on a CUDA device, the JAX package's "on
    TPU") and the grid has at least 48³ points.  Its shardings gate is
    ``solve``'s: a placed state runs the GSPMD engine's per-cycle loop."""
    if ops.plain_reason(params, device, params.dtype) is not None:
        return False
    return math.prod(params.grid_dim) >= FUSED_MIN_POINTS


def v2_unsupported_reason(params: GridParams) -> Optional[str]:
    """None when the batch engine (the v2 kernel's counterpart) takes the
    configuration, else the gate, worded as the JAX package words it: v2's
    per-leg sweep cap is ported, its TPU layout gates are not."""
    if params.pre_smoothing > V2_SWEEP_CAP or \
            params.post_smoothing > V2_SWEEP_CAP:
        return (
            f"pre/post smoothing {params.pre_smoothing}/"
            f"{params.post_smoothing} exceeds the per-leg sweep cap "
            f"({V2_SWEEP_CAP})"
        )
    return None


def use_fused2(params: GridParams, device) -> bool:
    """The batch engine on the kernels, in the place of the JAX package's
    wavefront whole-batch kernel."""
    return (
        _fused_capable(params, device)
        and v2_unsupported_reason(params) is None
    )


def use_fused(params: GridParams, device) -> bool:
    """The v1 whole-cycle kernel: where the batch engine's sweep cap
    refuses a V-cycle."""
    return _fused_capable(params, device) and v1.supported(params)


def engine(params: GridParams, device) -> str:
    """The engine ``solve`` runs: ``"batch"`` on the per-op kernels,
    ``"v1"`` (one cooperative launch per V-cycle), or ``"plain"`` (the
    batch engine on the plain ops: CPU tensors, ``backend="ref"`` or
    float64)."""
    if use_fused2(params, device):
        return "batch"
    if use_fused(params, device):
        return "v1"
    if ops.plain_reason(params, device, params.dtype) is not None:
        return "plain"
    return "batch"


def engine_note(params: GridParams, device) -> Optional[str]:
    """Why a configuration runs without the fused engines' fast path (the
    JAX package's stderr note), or None."""
    if use_fused2(params, device):
        return None
    if _fused_capable(params, device):
        return v2_unsupported_reason(params)
    if ops.plain_reason(params, device, params.dtype) == "float64":
        return (
            f"dtype {params.dtype} (the CUDA kernels are float32; float64 "
            "runs the plain ops on the card)"
        )
    return None


def legs_note(params: GridParams) -> str:
    """How the batch engine runs a visit of a non-coarsest level: the two
    fused legs (``ops/csrc/mg_legs.cu``), or, for a half they refuse, the
    per-op schedule and why."""
    down, up = vcycle_batch.legs(params)
    if down and up:
        return ("level visit: fused down and up legs (down_leg, up_leg; "
                "ops/csrc/mg_legs.cu), the coarsest level's sweeps per op")
    faces = all(sum(abs(o) for o in off) <= 1
                for off in params.stencil.offsets)
    halves = []
    for name, fused, n in (("down", down, params.pre_smoothing),
                           ("up", up, params.post_smoothing)):
        if fused:
            halves.append(f"{name} leg fused")
        else:
            why = (f"{n} sweeps, outside 1..{V2_SWEEP_CAP}" if faces else
                   "a stencil tap off the faces")
            halves.append(f"{name} leg per op ({why})")
    return "level visit: " + ", ".join(halves)


def vcycle_fused(
    state: GridState, params: GridParams
) -> Tuple[GridState, torch.Tensor]:
    """One V-cycle as one launch of the whole-cycle kernel; returns the
    state (updated in place) and the finest-level Σr² on the device."""
    return state, v1.vcycle_fused(state.levels, params)


def vcycle(state: GridState, params: GridParams) -> Tuple[GridState, float]:
    """One cycle of ``params.cycle_type``; returns the state (updated in
    place) and the finest-level residual norm."""
    norms = vcycle_batch.run(state, params, maxk=1,
                             ops=gspmd.ops_for(state))
    return state, float(np.sqrt(norms[0]))


def placed(state: GridState, shardings) -> GridState:
    """``state`` under ``shardings``: a whole state is placed
    (``dist/sharding.shard_state``); a placed one must carry them."""
    if shardings is None:
        return state
    if state.shardings is None:
        return shard_state(state, shardings)
    if tuple(state.shardings) != tuple(shardings):
        raise ValueError("the state is placed by other shardings")
    return state


def residual_norm(
    state: GridState, params: GridParams, shardings=None
) -> Tuple[GridState, float]:
    """The mode's residual at the finest level, stored in level 0's r, and
    its norm (under ``shardings``, over every rank's block)."""
    state = placed(state, shardings)
    lvl = state.levels[0]
    sumsq = lvl.v.new_empty(1)
    gspmd.ops_for(state).residual_op(
        lvl.r, lvl.v, lvl.f, params.level_dims()[0], params,
        params.level_h(0), norm_out=sumsq, newton_v=lvl.newton_v,
    )
    return state, float(np.sqrt(vcycle_batch.read_host(sumsq)[0]))


def _solve_batched(
    state: GridState,
    params: GridParams,
    timer: Optional[Timer],
    initial: float,
    history: List[float],
    check_every: int,
) -> Tuple[GridState, List[float]]:
    """Batches of up to ``check_every`` cycles with the early stop on the
    device, then the verbatim host stop test on every returned norm.  A
    placed state runs batches of one cycle on the sharded ops, with no
    stop on the device: the JAX package's per-cycle loop."""
    dt = _np_dtype(state)
    cycle_ops = gspmd.ops_for(state)
    placed_state = state.shardings is not None
    k = 1 if placed_state else max(1, min(check_every, params.maxiter))
    thr = dt.type((initial / (1.0 / params.tol)) ** 2)
    thr = np.nextafter(
        np.nextafter(thr, dt.type(np.inf), dtype=dt),
        dt.type(np.inf), dtype=dt,
    )
    thr = -1.0 if placed_state else float(thr)
    i = 0
    done = False
    while i < params.maxiter and not done:
        m = min(k, params.maxiter - i)
        t0 = time.perf_counter()
        arr = vcycle_batch.run(
            state, params, maxk=k, ncyc=m, thr=thr, timer=timer,
            ops=cycle_ops,
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


def _solve_per_cycle(
    state: GridState,
    params: GridParams,
    timer: Optional[Timer],
    initial: float,
    history: List[float],
) -> Tuple[GridState, List[float]]:
    """The JAX package's per-cycle loop on the v1 kernel: one launch and
    one host sync a cycle, the verbatim stop test."""
    dt = _np_dtype(state)
    for i in range(params.maxiter):
        t0 = time.perf_counter()
        state, sumsq = vcycle_fused(state, params)
        ss = vcycle_batch.read_host(sumsq, timer)[0]
        res = float(np.sqrt(dt.type(ss)))
        history.append(res)
        if params.print_progress:
            ms = int((time.perf_counter() - t0) * 1000)
            line = f"iter: {i} residual: {res:.6g} Took {ms}ms"
            if timer is not None:
                line += timer.suffix()
            print(line)
        if res <= initial / (1.0 / params.tol):
            break
    return state, history


def solve(
    state: GridState,
    params: GridParams,
    shardings: Optional[tuple] = None,
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

    ``check_every``: cycles per host sync on the batch engine; the v1
    engine syncs once a cycle (see the module note).

    ``shardings`` (``dist.level_shardings``): the GSPMD engine; a whole
    state is placed first, and the placed state is returned.  A state
    placed already runs it with no ``shardings`` given.
    """
    state = placed(state, shardings)
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
    if state.shardings is None and engine(params, state.device) == "v1":
        return _solve_per_cycle(state, params, timer, initial, history)
    return _solve_batched(state, params, timer, initial, history, check_every)
