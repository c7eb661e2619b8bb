"""Mixed-precision iterative refinement: float64-accurate solves at float32
multigrid speed.  The port of ``gpusolve_tpu/solver/refine.py``
(``_params32``, ``_hi_residual``, ``_inject``, ``_accumulate``, ``hi_rhs``,
``solve_refine``, :69-252).

Only the O(N) outer defect and the accumulation run in float64, as the
port's plain ops (on the card they run in its native float64); every cycle
of the inner solves runs in float32 through ``solve``, and so on the CUDA
kernels (the batch engine, or v1 for more than 5 sweeps):

LINEAR mode, classical iterative refinement:
    r = f − A·u/h²            float64
    solve  A·e = r/s          float32 multigrid, s = ‖r‖₂
    u += s·e                  float64

NONLINEAR / NEWTON modes, inexact-Newton defect correction on
``−Δu + γ·u·eᵘ = f``:
    F = f − (A·u/h² + γ·u·eᵘ)   float64
    solve  J(u)·e = F/s          float32 NEWTON-mode multigrid, frozen u
                                 restricted to levels 1..L−2, never the
                                 coarsest (``newton._prepare_find_error``)
    u += s·e                     float64

The scaling ``s = ‖r‖₂`` keeps the inner problem O(1) as the defect
shrinks.  ``solve_refine_spmd`` is the distributed variant
(``gpusolve_tpu/solver/refine.py:255-410``): the inner float32 solves on
the spmd engine (``dist/spmd.py`` per leg, in either plan, or
``dist/pod.py``), the float64 outer defect on the plain ops over the
whole finest level, which every rank holds; each outer step injects this
rank's block of the scaled defect (and Newton's linearisation point) into
the engine's level 0 and gathers the correction back.  ``solve_refine``
with ``shardings`` runs the inner solves on the GSPMD engine
(``dist/gspmd.py``), the float64 outer arrays on level 0's placement
(``gpusolve_tpu/solver/refine.py:144-200``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import torch

from gpusolve_tpu_torch.config import GridParams, Mode
from gpusolve_tpu_torch.dist import gspmd
from gpusolve_tpu_torch.dist.sharding import place_rhs
from gpusolve_tpu_torch.grid import GridLevel, GridState, _device_rhs
from gpusolve_tpu_torch.grid import build_grid, resolve_device
from gpusolve_tpu_torch.ops import ref
from gpusolve_tpu_torch.solver import newton as newton_mod
from gpusolve_tpu_torch.solver import vcycle as vc
from gpusolve_tpu_torch.utils.timer import Timer


def _params32(params: GridParams, inner_iters: int,
              inner_tol: float) -> GridParams:
    """The inner float32 solver's configuration: non-linear modes solve
    the Jacobian correction system, NEWTON-mode multigrid with the frozen
    linearisation point."""
    mode32 = Mode.LINEAR if params.mode == Mode.LINEAR else Mode.NEWTON
    return params.replace(
        dtype="float32", mode=mode32, maxiter=inner_iters, tol=inner_tol,
        print_progress=False,
    )


def _hi_residual(
    u: torch.Tensor, f: torch.Tensor, params: GridParams, sh0=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The float64 defect and its L2 norm (a 0-d tensor) on the finest
    level: LINEAR r = f − A·u/h², other modes the full nonlinear residual
    F = f − (A·u/h² + γ·u·eᵘ), the NONLINEAR residual at v = u.  With
    ``sh0`` (level 0's placement) u and f are this rank's tensors of the
    level: u's ghosts are fetched, and the norm sums every rank's block."""
    p = params if params.mode == Mode.LINEAR else params.replace(
        mode=Mode.NONLINEAR
    )
    if sh0 is None:
        dims = params.level_dims()[0]
    else:
        gspmd.halo(u, sh0)
        dims = sh0.local_dims
    r, sumsq = ref.residual(u, f, dims, p, params.level_h(0))
    if sh0 is not None:
        sumsq = gspmd.all_sum(sumsq.reshape(1), sh0)[0]
    return r, torch.sqrt(sumsq)


def _inject(lvl0: GridLevel, r_hi: torch.Tensor, s: torch.Tensor,
            u_hi: torch.Tensor, dims, newton: bool) -> None:
    """Per-outer prep of the inner level 0, in place: the scaled float32
    RHS, the zeroed correction and (Newton) the frozen float32
    linearisation point."""
    ref.interior(lvl0.f, dims).copy_(
        (ref.interior(r_hi, dims) / s).to(torch.float32)
    )
    lvl0.v.zero_()
    if newton:
        lvl0.newton_v.copy_(u_hi.to(torch.float32))


def _accumulate(u_hi: torch.Tensor, e32: torch.Tensor, s: torch.Tensor,
                dims) -> None:
    """u += s·e over the interior, in float64, in place."""
    ref.interior(u_hi, dims).add_(
        s * ref.interior(e32, dims).to(u_hi.dtype)
    )


def hi_rhs(params: GridParams, device) -> torch.Tensor:
    """The finest-level RHS in float64, filled on the device with the
    formula and order of the JAX package's ``grid._device_rhs``."""
    return _device_rhs(params, torch.float64, device)


def solve_refine(
    params: GridParams,
    inner_tol: float = 1e-3,
    inner_iters: int = 20,
    timer: Optional[Timer] = None,
    state32: Optional[GridState] = None,
    device=None,
    shardings: Optional[tuple] = None,
) -> Tuple[torch.Tensor, List[float]]:
    """Iterate float64 defect → float32 multigrid correction until
    ``res <= initial/(1/tol)`` (the reference's stop test) or
    ``params.maxiter`` outer steps.

    Returns ``(u, history)``: the float64 solution on the finest level
    (padded, on the device) and the float64 residual-norm history
    ``[initial, res_0, ...]``.  ``params.maxiter``/``params.tol`` govern
    the outer iteration; ``inner_tol``/``inner_iters`` the float32
    multigrid solve of each correction equation.  ``device`` defaults to
    CUDA (or ``state32``'s device).

    ``shardings`` (``dist.level_shardings`` of the float32 params): the
    inner solves on the GSPMD engine, on the mesh's device; u and the
    RHS are this rank's tensors of level 0 (``dist.sharding.gather_field``
    assembles u on rank 0).
    """
    if params.dtype != "float32":
        raise ValueError(
            "solve_refine's storage dtype is the inner dtype and must be "
            f"float32 (got {params.dtype}); for pure-f64 runs use "
            "--dtype float64 without --refine"
        )
    if timer is None and params.print_progress:
        timer = Timer()
    dims = params.level_dims()[0]
    newton = params.mode != Mode.LINEAR

    p32 = _params32(params, inner_iters, inner_tol)
    sh0 = None
    if shardings is not None:
        sh0 = shardings[0]
        device = sh0.mesh.device
        dims = sh0.local_dims
    if state32 is None:
        state32 = build_grid(p32, device=device)
    state32 = vc.placed(state32, shardings)
    # The inner Jacobian solves never read newton_f (only the outer
    # newton_solve does).
    state32 = dataclasses.replace(state32, newton_f=None)
    dev = state32.device if device is None else resolve_device(device)

    u = torch.zeros(tuple(d + 2 for d in dims), dtype=torch.float64,
                    device=dev)
    if sh0 is None:
        f_hi = hi_rhs(params, dev)
    else:
        f_hi = place_rhs(params, sh0, torch.float64, dev)

    r_hi, res = _hi_residual(u, f_hi, params, sh0)
    initial = float(res)
    word = "newton iter" if params.mode == Mode.NEWTON else "iter"
    if params.print_progress:
        name = "newton residual" if params.mode == Mode.NEWTON else "residual"
        print(f"Inital {name}: {initial:.6g}")
    history = [initial]

    for i in range(params.maxiter):
        t0 = time.perf_counter()
        s = res
        lvl0 = state32.levels[0]
        _inject(lvl0, r_hi, s, u, dims, newton)
        if newton:
            # ũ to levels 1..L−2, never the coarsest (the reference quirk).
            newton_mod._prepare_find_error(state32, p32)
        state32, _ = vc.solve(
            state32, p32, timer=timer, check_every=inner_iters
        )
        _accumulate(u, state32.levels[0].v, s, dims)
        r_hi, res = _hi_residual(u, f_hi, params, sh0)
        if timer is not None:
            with timer.section("sumBuffer"):
                res_f = float(res)
        else:
            res_f = float(res)
        history.append(res_f)
        if params.print_progress:
            ms = int((time.perf_counter() - t0) * 1000)
            line = f"{word}: {i} residual: {res_f:.6g} Took {ms}ms"
            if timer is not None:
                line += timer.suffix()
            print(line)
        if res_f <= initial / (1.0 / params.tol):
            break
    return u, history


def solve_refine_spmd(
    params: GridParams,
    mesh,
    inner_tol: float = 1e-3,
    inner_iters: int = 20,
    timer: Optional[Timer] = None,
    local_backend: str = "auto",
    halo: str = "ppermute",
    fuse: str = "leg",
    cutoff: int = 4,
    tail: str = "auto",
) -> Tuple[torch.Tensor, List[float]]:
    """``solve_refine`` with the inner float32 solves on the distributed
    engine of ``mesh`` (``local_backend``, ``halo``, ``fuse`` and ``tail``
    as ``dist/spmd.solve_spmd`` takes them).  Returns ``(u, history)`` as
    ``solve_refine``: u on every rank, on the mesh's device."""
    from gpusolve_tpu_torch.dist import spmd

    if params.dtype != "float32":
        raise ValueError(
            "solve_refine's storage dtype is the inner dtype and must be "
            f"float32 (got {params.dtype})"
        )
    if timer is None and params.print_progress:
        timer = Timer()
    dims = params.level_dims()[0]
    newton = params.mode != Mode.LINEAR
    p32 = _params32(params, inner_iters, inner_tol)
    eng = spmd.build_spmd_solver(p32, mesh, cutoff, local_backend, halo,
                                 fuse, tail)
    plan = eng.plan
    # The inner Jacobian solves never read newton_f.
    state = dataclasses.replace(eng.init_state(), newton_f=None)
    dev = mesh.device
    dx, dy = eng.ex.dc
    b0 = plan.shape(0)
    start = (dx * b0[0], dy * b0[1], 0)

    u = torch.zeros(tuple(d + 2 for d in dims), dtype=torch.float64,
                    device=dev)
    f_hi = hi_rhs(params, dev)
    r_hi, res = _hi_residual(u, f_hi, params)
    initial = float(res)
    word = "newton iter" if params.mode == Mode.NEWTON else "iter"
    if params.print_progress:
        name = "newton residual" if params.mode == Mode.NEWTON else "residual"
        print(f"Inital {name}: {initial:.6g}")
    history = [initial]

    for i in range(params.maxiter):
        t0 = time.perf_counter()
        s = res
        # This rank's block of the scaled float32 RHS (and ũ), zero
        # outside the interior; every correction restarts from zero.
        levels = state.levels
        rhs = torch.zeros_like(u, dtype=torch.float32)
        ref.interior(rhs, dims).copy_(
            (ref.interior(r_hi, dims) / s).to(torch.float32))
        levels[0].f.copy_(spmd._window(rhs, start, b0))
        for lvl in levels:
            lvl.v.zero_()
        if newton:
            lin = torch.zeros_like(rhs)
            ref.interior(lin, dims).copy_(
                ref.interior(u, dims).to(torch.float32))
            levels[0].newton_v.copy_(spmd._window(lin, start, b0))
            # ũ to levels 1..L−2, never the coarsest.
            eng.restrict_newton_v(state)
        state, _, _ = spmd.solve_spmd(
            p32, mesh, cutoff, state=state, plan=plan,
            local_backend=local_backend, check_every=inner_iters,
            halo=halo, fuse=fuse, timer=timer, tail=tail,
        )
        _accumulate(u, spmd.gather_field(state, plan, mesh), s, dims)
        r_hi, res = _hi_residual(u, f_hi, params)
        if timer is not None:
            with timer.section("sumBuffer"):
                res_f = float(res)
        else:
            res_f = float(res)
        history.append(res_f)
        if params.print_progress:
            ms = int((time.perf_counter() - t0) * 1000)
            line = f"{word}: {i} residual: {res_f:.6g} Took {ms}ms"
            if timer is not None:
                line += timer.suffix()
            print(line)
        if res_f <= initial / (1.0 / params.tol):
            break
    return u, history
