"""Checkpoint / resume of solver state: the port of
``gpusolve_tpu/utils/checkpoint.py`` (``_fingerprint``, ``save_state``,
``load_state``, :27-97).

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
test, repeats the uninterrupted run's remaining iterations exactly.  The
distributed engines' checkpoints (``save_state_spmd``) wait for those
engines (ROADMAP Queue 1 item 3(a)).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from gpusolve_tpu_torch import interop
from gpusolve_tpu_torch.config import GridParams
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
    Newton mode) and progress metadata."""
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


def load_state(path: str, params: GridParams, device=None):
    """Rebuild a GridState from a checkpoint on ``device`` (default CUDA).
    Returns ``(state, iteration, history)``.  Raises ValueError on a
    configuration mismatch."""
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
