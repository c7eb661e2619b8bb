"""A batch of up to ``maxk`` multigrid cycles with an early stop on the
device: the counterpart of ``gpusolve_tpu/ops/pallas_vcycle2.py``
(``vcycle2_fused`` :1452, ``batch_call`` :1506).

The TPU package runs the batch as one Pallas launch.  Here the host
enqueues every op of every cycle (V, W or F; LINEAR, FAS or NEWTON) on the
current stream without waiting, and the early stop lives on the device:
every kernel reads the batch's ``done`` flag and returns at once when it is
set, and the finalize kernel of each cycle writes that cycle's Σr² into
``norms[i]`` and sets ``done`` when ``thr >= 0 and Σr² <= thr``.  Cycles after the stop
write nothing, so the levels stay as the last executed cycle left them and
their norms stay −1.  The host reads the norms once, at the end of the
batch.

On CPU tensors, or with ``backend="ref"``, the same function runs the plain
ops, which read ``done`` on the host.

State is updated in place: the legs and the smoother write each level's v
out of place into its spare buffer r, and the two trade roles, so the host
tracks which tensor holds v after every cycle and, once the norms show how
many cycles ran, hands each level the tensors it held after the last
executed cycle.  Every other field (f, rest_v, newton_v) keeps its
tensor, and the ops of skipped cycles write none of them.  ``enqueue``
and ``hand_over`` are ``run``'s halves around its read; the batched Newton
loop (``solver/newton.py``) calls them around a read of its own.

A visit of a non-coarsest level i is two fused legs (``ops/csrc/
mg_legs.cu``, the structure of the TPU's whole-batch kernel: one streamed
pass a leg), where ``legs`` allows (pre, resp. post, within the v2 sweep
cap of 1..5 sweeps, a stencil of face taps); per mode (JAX: gpusolve_tpu/
solver/vcycle.py:86-148):
  * LINEAR, NEWTON: the down leg (pre-sweeps, the residual, R(r) into the
    coarse f, the coarse v zeroed; the smoothed v into the spare buffer),
    the coarse visits, the up leg (v += P(coarse v), post-sweeps, back
    into the buffer the down leg read, so level i's v ends each visit
    where it began).  NEWTON's legs read each level's frozen ũ.
  * NONLINEAR (FAS): the down leg with R(v) into the coarse v and rest_v
    in place of the zero start, the tau fold f_c += A_c(R v)
    (``apply_fas``), the coarse visits, coarse v −= rest_v
    (``subtract``), the up leg.  A coarse v never starts from zero.
  * Level 0's up leg also writes the residual's per-block Σr² for the
    cycle's ``finalize``.
A half the legs refuse runs the per-op schedule instead: pre-sweeps, the
residual, the restriction(s); or the prolongation and post-sweeps (and a
norm-only residual at level 0).  The coarsest level runs pre + post
sweeps.  A repeated coarse visit (W, F) continues from the v the previous
visit left.

``run_tail`` is the batch as the pod engine's replicated tail runs it
(``dist/pod.py``; ``batch_call`` with ``ncyc`` cycles, ``thr = −1``,
``zero_start`` and ``alloc0``, ``pallas_vcycle2.py:281-316``,
``:1506-1508``): a fixed number of cycles on the levels below the pod,
no norm and no stop.  Its root is the pod's boundary block: on one rank
the pod lays that block out as ``(n+2)³``, this engine's layout, so the
tail runs on it in place and needs no ``alloc0``; on a larger mesh the
pod engine gathers it into that layout (one embed).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from gpusolve_tpu_torch.config import GridParams, Mode
from gpusolve_tpu_torch.grid import GridLevel, GridState
from gpusolve_tpu_torch.ops import dispatch
from gpusolve_tpu_torch.ops import kernels

_SUBCYCLES = {"V": ("V",), "W": ("W", "W"), "F": ("F", "V")}


def level_visits(nlev: int, cycle_type: str) -> List[int]:
    """Visits of each level per outer cycle: V -> 1, F -> l+1, W -> 2^l."""
    visits = [1] * nlev
    for lev in range(1, nlev):
        if cycle_type == "W":
            visits[lev] = 2 * visits[lev - 1]
        elif cycle_type == "F":
            visits[lev] = visits[lev - 1] + 1
    return visits


def legs(params: GridParams) -> Tuple[bool, bool]:
    """Whether a visit of a non-coarsest level runs the fused down leg and
    the fused up leg (``kernels.legs_take``: pre, resp. post, within 1..5
    sweeps, the v2 sweep cap, and a stencil of face taps); else that half
    of the visit runs the per-op schedule."""
    return (kernels.legs_take(params.stencil, params.pre_smoothing),
            kernels.legs_take(params.stencil, params.post_smoothing))


def launches_per_cycle(params: GridParams, norm: bool = True) -> dict:
    """Kernel launches one cycle makes, by kernel (the count the launch
    counters must show), for the cycle's mode.  Each visit of a
    non-coarsest level runs one ``down_leg`` (else pre sweeps, one
    residual and its restriction: LINEAR and NEWTON one
    ``restrict_zero``, FAS two ``restrict``) and one ``up_leg`` (else one
    ``prolong_add`` and post sweeps); FAS adds one ``apply_fas`` and one
    ``subtract`` a visit.  Each visit of the coarsest runs pre + post
    sweeps.  With ``norm`` (not in ``run_tail``) the cycle ends with the
    finalize, its partials from level 0's up leg, or from a norm-only
    residual where level 0 runs no up leg."""
    nlev = params.num_levels
    visits = level_visits(nlev, params.cycle_type)
    down, up = legs(params)
    pre, post = params.pre_smoothing, params.post_smoothing
    inner = sum(visits[:-1])
    fas = params.mode == Mode.NONLINEAR
    sweeps = (pre + post) * visits[-1] + inner * (
        (0 if down else pre) + (0 if up else post))
    norm_residual = int(norm and not (up and nlev > 1))
    counts = {
        kernels.variant("residual", params.mode):
            (0 if down else inner) + norm_residual,
        "finalize": int(norm),
        kernels.variant("jacobi_sweep", params.mode): sweeps,
        kernels.variant("down_leg", params.mode): inner if down else 0,
        kernels.variant("up_leg", params.mode): inner if up else 0,
        "prolong_add": 0 if up else inner,
    }
    if fas:
        counts.update(restrict=0 if down else 2 * inner, apply_fas=inner,
                      subtract=inner)
    else:
        counts["restrict_zero"] = 0 if down else inner
    return {k: n for k, n in counts.items() if n}


def _cycle(
    levels: List[GridLevel],
    params: GridParams,
    done: torch.Tensor,
    norm_out: Optional[torch.Tensor] = None,
    thr=-1.0,
    ops=dispatch,
) -> None:
    """One cycle of ``params.cycle_type`` rooted at the finest level; with
    ``norm_out`` its finest-level Σr² into it (``done`` set when ``thr``
    is met), from level 0's up leg where that leg is fused.  ``ops``:
    ``ops/dispatch``, or the GSPMD engine's sharded ops
    (``dist/gspmd.ShardedOps``), which run every visit per op."""
    nlev = len(levels)
    dims = params.level_dims()
    hs = [params.level_h(i) for i in range(nlev)]
    fas = params.mode == Mode.NONLINEAR
    pre, post = params.pre_smoothing, params.post_smoothing
    down_fused, up_fused = legs(params) if ops is dispatch else (False, False)

    def smooth_level(i: int, n_iter: int) -> None:
        lvl = levels[i]
        lvl.v, lvl.r = ops.smooth(
            lvl.v, lvl.f, lvl.r, dims[i], params, hs[i], n_iter, done,
            lvl.newton_v,
        )

    def down(i: int) -> None:
        """Pre-smooth, the residual restricted into the coarse RHS, the
        coarse start."""
        lvl, nxt = levels[i], levels[i + 1]
        if down_fused:
            # The smoothed v goes into the spare buffer, which becomes v.
            ops.down_leg_op(
                lvl.r, lvl.v, lvl.f, nxt.f, nxt.v, dims[i], dims[i + 1],
                params, hs[i], pre, done, lvl.newton_v,
                nxt.rest_v if fas else None,
            )
            lvl.v, lvl.r = lvl.r, lvl.v
        else:
            smooth_level(i, pre)
            ops.residual_op(
                lvl.r, lvl.v, lvl.f, dims[i], params, hs[i], done=done,
                newton_v=lvl.newton_v,
            )
            if fas:
                ops.restrict_op(nxt.f, lvl.r, dims[i], dims[i + 1], params,
                                done)
                ops.restrict_op(
                    nxt.v, lvl.v, dims[i], dims[i + 1], params, done,
                    out2=nxt.rest_v,
                )
            else:
                ops.restrict_zero_op(
                    nxt.f, nxt.v, lvl.r, dims[i], dims[i + 1], params, done
                )
        if fas:
            # Tau correction: the coarse v starts at R(v), kept in rest_v,
            # and the coarse operator applied to it joins the coarse RHS.
            ops.apply_fas_op(
                nxt.f, nxt.v, dims[i + 1], params, hs[i + 1], done
            )

    def up(i: int, norm: bool) -> bool:
        """Prolong the coarse correction into v, post-smooth; returns
        whether the norm was taken (``norm``: level 0's fused up leg)."""
        lvl, nxt = levels[i], levels[i + 1]
        if fas:
            ops.subtract_op(nxt.v, nxt.rest_v, dims[i + 1], params, done)
        if up_fused:
            ops.up_leg_op(
                lvl.r, lvl.v, nxt.v, lvl.f, dims[i], dims[i + 1], params,
                hs[i], post, done, lvl.newton_v,
                norm_out if norm else None, thr,
            )
            lvl.v, lvl.r = lvl.r, lvl.v
            return norm
        ops.prolong_add_op(
            lvl.v, nxt.v, dims[i + 1], dims[i], params, done
        )
        smooth_level(i, post)
        return False

    def cycle_at(i: int, kind: str) -> bool:
        if i == nlev - 1:
            # Coarsest level: smoothing only, no direct solve.
            smooth_level(i, pre + post)
            return False
        down(i)
        for sub in _SUBCYCLES[kind]:
            cycle_at(i + 1, sub)
        return up(i, i == 0 and norm_out is not None)

    if cycle_at(0, params.cycle_type) or norm_out is None:
        return
    lvl0 = levels[0]
    ops.residual_op(
        None, lvl0.v, lvl0.f, dims[0], params, hs[0], write_r=False,
        norm_out=norm_out, thr=thr, done=done, newton_v=lvl0.newton_v,
    )


def run_tail(
    levels: List[GridLevel],
    params: GridParams,
    n: int,
    *,
    zero_start: bool = False,
    done: Optional[torch.Tensor] = None,
) -> None:
    """``n`` cycles of ``params.cycle_type`` on ``levels`` (root first;
    ``params`` the root's grid) in place, with no norm and no stop.

    ``zero_start``: the first cycle's root starts from v = 0, as the first
    visit after a restriction does (LINEAR and NEWTON); the root's v is
    zeroed here (one fill) and read as zero.  Refused in FAS, whose coarse
    v starts at R(v), as the reference refuses it
    (``pallas_vcycle2.py:316-317``).  ``done``: the flag every op reads,
    never set here; pass one to keep the ops from making their own."""
    if zero_start:
        if params.mode == Mode.NONLINEAR:
            raise ValueError(
                "zero_start is refused in NONLINEAR (FAS) mode: the coarse "
                "v starts at R(v)"
            )
        levels[0].v.zero_()
    for _ in range(n):
        _cycle(levels, params, done)


# Host reads of device values by the solve loops, one sync each: the
# batch's norms here, the initial residual and v1's per-cycle norm
# (solver/vcycle.py), comp_f's ‖F‖ and the Newton batch's vector
# (solver/newton.py).
host_reads = 0


def read_host(t: torch.Tensor, timer=None) -> np.ndarray:
    """``t`` on the host, as numpy: one sync, counted in ``host_reads`` and
    timed as ``sumBuffer`` when a timer is given."""
    global host_reads
    host_reads += 1
    if timer is None:
        return t.cpu().numpy()
    with timer.section("sumBuffer"):
        return t.cpu().numpy()


def enqueue(
    levels: List[GridLevel],
    params: GridParams,
    n: int,
    norms: torch.Tensor,
    done: torch.Tensor,
    held: List[List[Tuple[torch.Tensor, torch.Tensor]]],
    thr=-1.0,
    ops=dispatch,
) -> None:
    """Enqueue ``n`` cycles on ``levels`` in place, with no host read:
    cycle i's finest-level Σr² into ``norms[i]``, and ``done`` set by its
    finalize when ``thr`` (a float, or a one-element float32 tensor on the
    device) is met; every op of every cycle reads ``done``.  After each
    cycle appends each level's ``(v, r)`` to ``held``, so ``held[c]`` (from
    the caller's entry for c = 0) is what the levels hold after c
    cycles.  ``ops`` as :func:`_cycle` takes it."""
    for i in range(n):
        _cycle(levels, params, done, norms[i : i + 1], thr, ops)
        held.append([(lvl.v, lvl.r) for lvl in levels])


def hand_over(
    levels: List[GridLevel],
    held: List[List[Tuple[torch.Tensor, torch.Tensor]]],
    executed: int,
) -> None:
    """Give each level the ``(v, r)`` it held after ``executed`` cycles."""
    for lvl, (v, r) in zip(levels, held[executed]):
        lvl.v, lvl.r = v, r


def run(
    state: GridState,
    params: GridParams,
    maxk: int,
    ncyc: Optional[int] = None,
    thr: float = -1.0,
    timer=None,
    ops=dispatch,
) -> np.ndarray:
    """Run up to ``min(ncyc, maxk)`` cycles on ``state`` in place.

    Returns the ``(maxk,)`` vector of per-cycle finest-level Σr² in the
    working dtype, −1 for cycles not executed (stopped by
    ``Σr² <= thr`` with ``thr >= 0``, or beyond ``ncyc``).  The one host
    sync of the batch is the read of this vector (timed as ``sumBuffer``
    when a timer is given).  ``ops`` as :func:`_cycle` takes it."""
    levels = list(state.levels)
    lvl0 = levels[0]
    n = maxk if ncyc is None else min(ncyc, maxk)
    norms = torch.full((maxk,), -1.0, dtype=lvl0.v.dtype, device=lvl0.v.device)
    done = torch.zeros(1, dtype=torch.int32, device=lvl0.v.device)
    held = [[(lvl.v, lvl.r) for lvl in levels]]
    enqueue(levels, params, n, norms, done, held, thr, ops)
    out = read_host(norms, timer)
    hand_over(levels, held, int(np.count_nonzero(out != -1.0)))
    return out
