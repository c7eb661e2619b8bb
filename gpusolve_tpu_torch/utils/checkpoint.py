"""Checkpoint / resume of solver state: the port of
``gpusolve_tpu/utils/checkpoint.py`` (``_fingerprint``, ``save_state``,
``load_state``, :27-97; ``_spmd_fingerprint``, ``save_state_spmd``,
``load_state_spmd``, :112-166).

A compressed ``.npz`` of every level's ``v`` (and ``newton_v`` in Newton
mode), level 0's ``f``, Newton's ``newton_f``, the configuration's
fingerprint and the progress (``__iteration__``, ``__history__``): the same
keys and the same fingerprint string as the JAX package's.  The port writes
its fields at its padded ``(nx+2, ny+2, nz+2)`` shape; ``load_state`` also
reads a file the JAX package wrote, whose fields carry its ``(8, 8, 128)``
allocation rounding, and crops them (``interop.crop``).

A cycle's inputs are level 0's v and f (and ũ, newton_f in Newton mode):
every coarse v is restarted and every coarse f rewritten by the cycle, so
a resumed solve, given the original run's initial residual for its stop
test, repeats the uninterrupted run's remaining iterations exactly.

A state of the GSPMD engine (placed by ``dist/sharding.shard_state``)
saves and loads in the same single-device format, as the JAX package's
global arrays do: ``save_state`` gathers every level to rank 0, which
writes; ``load_state(..., shardings=)`` reads the file on every rank and
places it.  So a GSPMD checkpoint resumes on one device, and the other
way round.

The distributed engines (``dist/spmd.py``, per leg in either plan, and
``dist/pod.py``) checkpoint with ``save_state_spmd``: the JAX package's
keys (``s_0``, ``s_1``, ... the flat per-level ``v, f`` and the mode's
third field, FAS rest_v or Newton ũ; ``newton_f``) and its fingerprint
form, keyed on the mesh, the engine tag (``spmd/leg``, ``spmd/pod``) and
the plan's allocation, the port's.  So a tail plan's checkpoint refuses
a classic plan and the other way round, and a file the JAX package's
spmd engines wrote (its TPU allocation) is refused too.  Each rank's
blocks are gathered to rank 0, which writes the file; on load every rank
cuts its own blocks back out.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from gpusolve_tpu_torch import interop
from gpusolve_tpu_torch.config import GridParams, Mode
from gpusolve_tpu_torch.grid import GridState, build_grid

_FORMAT_VERSION = 1


def _fingerprint(params: GridParams) -> str:
    return (
        f"v{_FORMAT_VERSION};dims={params.grid_dim};mode={int(params.mode)};"
        f"stencil={params.stencil.values}{params.stencil.offsets};"
        f"omega={params.omega};gamma={params.gamma}"
    )


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_state(
    path: str,
    state: GridState,
    params: GridParams,
    iteration: int = 0,
    history: Optional[List[float]] = None,
) -> None:
    """Write the solver state (all levels' v, plus newton_v/newton_f in
    Newton mode) and progress metadata.  A placed state is gathered to
    rank 0, which writes (collective)."""
    if state.shardings is not None:
        from gpusolve_tpu_torch.dist.sharding import gather_state

        mesh = state.shardings[0].mesh
        whole = gather_state(state)
        if mesh.rank == 0:
            save_state(path, whole, params, iteration, history)
        if mesh.size > 1:
            # No rank reads the file before it is written.
            torch.distributed.barrier(group=mesh.group)
        return
    arrays = {}
    for l, lvl in enumerate(state.levels):
        arrays[f"v_{l}"] = _host(lvl.v)
        if lvl.newton_v is not None:
            arrays[f"newton_v_{l}"] = _host(lvl.newton_v)
    arrays["f_0"] = _host(state.levels[0].f)
    if state.newton_f is not None:
        arrays["newton_f"] = _host(state.newton_f)
    np.savez_compressed(
        path,
        __fingerprint__=np.array(_fingerprint(params)),
        __iteration__=np.array(iteration),
        __history__=np.array(history if history else [], dtype=np.float64),
        **arrays,
    )


def _fill(dst: torch.Tensor, arr: np.ndarray, dims) -> None:
    """Copy a saved field into a state tensor: as it is at the padded
    shape, cropped when the JAX package's allocation wrote it."""
    if tuple(arr.shape) != tuple(dst.shape):
        arr = interop.crop(arr, dims)
    dst.copy_(torch.from_numpy(np.ascontiguousarray(arr)))


def load_state(path: str, params: GridParams, device=None, shardings=None):
    """Rebuild a GridState from a checkpoint on ``device`` (default CUDA),
    placed by ``shardings`` when given (on the mesh's device).  Returns
    ``(state, iteration, history)``.  Raises ValueError on a configuration
    mismatch."""
    if shardings is not None:
        from gpusolve_tpu_torch.dist.sharding import shard_state

        state, iteration, history = load_state(
            path, params, shardings[0].mesh.device)
        return shard_state(state, shardings), iteration, history
    with np.load(path, allow_pickle=False) as z:
        fp = str(z["__fingerprint__"])
        if fp != _fingerprint(params):
            raise ValueError(
                "checkpoint was written for a different problem "
                f"configuration:\n  saved: {fp}\n  "
                f"current: {_fingerprint(params)}"
            )
        state = build_grid(params, device=device)
        dims = params.level_dims()
        for l, lvl in enumerate(state.levels):
            _fill(lvl.v, z[f"v_{l}"], dims[l])
            if f"newton_v_{l}" in z and lvl.newton_v is not None:
                _fill(lvl.newton_v, z[f"newton_v_{l}"], dims[l])
        _fill(state.levels[0].f, z["f_0"], dims[0])
        if "newton_f" in z and state.newton_f is not None:
            _fill(state.newton_f, z["newton_f"], dims[0])
        iteration = int(z["__iteration__"])
        history = [float(h) for h in z["__history__"]]
    return state, iteration, history


# ---------------------------------------------------------------------------
# The distributed engines' checkpoints
# ---------------------------------------------------------------------------


def _spmd_fingerprint(params: GridParams, plan, engine: str) -> str:
    shapes = ";".join(str(tuple(a)) for a in plan.alloc)
    return (
        f"{_fingerprint(params)};mesh={plan.mesh_shape};engine={engine};"
        f"alloc={shapes}"
    )


def _spmd_fields(state: GridState, params: GridParams):
    """The flat per-level fields a checkpoint keeps: ``v, f`` and the
    mode's third field (FAS rest_v, Newton ũ)."""
    out = []
    for lvl in state.levels:
        out += [lvl.v, lvl.f]
        if params.mode == Mode.NONLINEAR:
            out.append(lvl.rest_v)
        elif params.mode == Mode.NEWTON:
            out.append(lvl.newton_v)
    return out


def save_state_spmd(
    path: str,
    state: GridState,
    plan,
    params: GridParams,
    engine: str,
    iteration: int = 0,
    history: Optional[List[float]] = None,
    newton_f: Optional[torch.Tensor] = None,
    *,
    mesh,
) -> None:
    """Write a distributed state (and, in Newton mode, the original RHS
    ``newton_f``: level 0's f holds F between outer steps): each
    distributed level's blocks gathered over ``mesh`` into the plan's
    global allocation, the replicated levels as every rank holds them.
    Collective: every rank calls it, rank 0 writes."""
    from gpusolve_tpu_torch.dist.spmd import _Exchange

    ex = _Exchange(mesh, plan)
    per = len(_spmd_fields(state, params)) // plan.nlev
    arrays = {}
    for i, t in enumerate(_spmd_fields(state, params)):
        arrays[f"s_{i}"] = _host(ex.assemble(t) if i // per < plan.n_dist
                                 else t)
    if newton_f is not None:
        arrays["newton_f"] = _host(ex.assemble(newton_f))
    if mesh.rank == 0:
        np.savez_compressed(
            path,
            __fingerprint__=np.array(_spmd_fingerprint(params, plan, engine)),
            __iteration__=np.array(iteration),
            __history__=np.array(history if history else [],
                                 dtype=np.float64),
            **arrays,
        )
    if mesh.size > 1:
        # No rank reads the file before it is written.
        torch.distributed.barrier(group=mesh.group)


def load_state_spmd(path: str, params: GridParams, plan, engine: str, *,
                    mesh):
    """Rebuild this rank's distributed state from a checkpoint, for the
    engine whose ``plan`` it is.  Returns ``(state, iteration, history,
    newton_f)``.  Raises ValueError on a configuration, mesh, engine or
    plan mismatch (the reference's message)."""
    with np.load(path, allow_pickle=False) as z:
        fp = str(z["__fingerprint__"])
        want = _spmd_fingerprint(params, plan, engine)
        if fp != want:
            raise ValueError(
                "checkpoint was written for a different problem/mesh/"
                f"engine configuration:\n  saved: {fp}\n  current: {want}"
            )
        n = sum(1 for k in z.files if k.startswith("s_"))
        arrays = [z[f"s_{i}"] for i in range(n)]
        newton_f = z["newton_f"] if "newton_f" in z.files else None
        iteration = int(z["__iteration__"])
        history = [float(h) for h in z["__history__"]]
    state = interop.spmd_blocks_from_numpy(params, plan, arrays, mesh,
                                           newton_f)
    return state, iteration, history, state.newton_f
