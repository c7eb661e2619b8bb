"""Carry level fields between the JAX package and the port.

The JAX package allocates each level as ``(8, 8, 128)``-rounded arrays
(its ``grid.alloc_shape``) whose cells outside the padded region
``(n+2)³`` are zero; the port allocates exactly ``(n+2)³``.  These helpers
take the JAX fields as numpy arrays (``np.asarray`` of the JAX arrays; this
module imports no JAX), crop them, and back.  ``spmd_state_from_numpy``
and ``spmd_state_to_numpy`` do the same for the distributed engines'
states: each distributed level's global array is cut into this rank's
block; a tail plan's state (``SpmdPlan(force_nd=...)``, whose
distributed allocation and tail root are laid out differently in the two
packages) goes by interior cells.  ``pod_state_from_numpy`` and
``pod_state_to_numpy`` carry the pod engine's state (``dist/pod.py``)
across by interior cells: the two packages lay the pod levels out
differently, but each places a level's global cell i at index i of its
global array.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from gpusolve_tpu_torch.config import GridParams, Mode
from gpusolve_tpu_torch.grid import (
    GridLevel,
    GridState,
    resolve_device,
    torch_dtype,
)

Dims = Tuple[int, int, int]


def jax_alloc_shape(dims: Dims) -> Tuple[int, int, int]:
    """The JAX package's allocation of a level with interior ``dims``: x
    and y of the padded extent rounded up to 8, z up to 128."""
    nx, ny, nz = dims

    def up(n, m):
        return -(-n // m) * m

    return (up(nx + 2, 8), up(ny + 2, 8), up(nz + 2, 128))


def crop(arr: np.ndarray, dims: Dims) -> np.ndarray:
    """The padded region ``(n+2)³`` of a JAX-allocated field; raises if any
    cell outside it is nonzero."""
    px, py, pz = (d + 2 for d in dims)
    if any(a < p for a, p in zip(arr.shape, (px, py, pz))):
        raise ValueError(
            f"array of shape {arr.shape} is smaller than the padded extent "
            f"{(px, py, pz)}"
        )
    outside = arr.copy()
    outside[:px, :py, :pz] = 0
    if np.any(outside != 0):
        raise ValueError(
            "nonzero values outside the padded region: not a JAX-allocated "
            "level field"
        )
    return arr[:px, :py, :pz]


def _fields(params: GridParams) -> Tuple[str, ...]:
    extra = {Mode.NONLINEAR: ("rest_v",), Mode.NEWTON: ("newton_v",)}
    return ("v", "f", "r") + extra.get(params.mode, ())


def state_from_numpy(
    params: GridParams,
    levels: Sequence[Mapping[str, np.ndarray]],
    device=None,
    newton_f: Optional[np.ndarray] = None,
) -> GridState:
    """A port ``GridState`` from per-level JAX fields.  Each mapping holds
    the level's fields by name (``v``, ``f`` and, by mode, ``rest_v`` or
    ``newton_v``); a missing ``r`` starts at zero.

    NEWTON needs the JAX state's ``newton_f`` as its own argument: after a
    ``comp_f`` the JAX level-0 ``f`` holds F, not the RHS."""
    device = resolve_device(device)
    dtype = torch_dtype(params.dtype)
    dims = params.level_dims()
    if len(levels) != len(dims):
        raise ValueError(
            f"{len(levels)} levels given, the configuration has {len(dims)}"
        )
    out = []
    for d, fields in zip(dims, levels):
        kw = {}
        for name in _fields(params):
            arr = fields.get(name)
            if arr is None:
                if name != "r":
                    raise ValueError(f"level field {name!r} missing")
                kw[name] = torch.zeros(
                    tuple(n + 2 for n in d), dtype=dtype, device=device
                )
                continue
            kw[name] = _to_torch(arr, d, device, dtype)
        out.append(GridLevel(**kw))
    nf = None
    if params.mode == Mode.NEWTON:
        if newton_f is None:
            raise ValueError("NEWTON mode needs the JAX state's newton_f")
        nf = _to_torch(newton_f, dims[0], device, dtype)
    return GridState(levels=tuple(out), newton_f=nf)


def _to_torch(arr, dims: Dims, device, dtype) -> torch.Tensor:
    return torch.from_numpy(
        np.ascontiguousarray(crop(np.asarray(arr), dims))
    ).to(device=device, dtype=dtype)


def _third(params: GridParams) -> Optional[str]:
    return {Mode.NONLINEAR: "rest_v", Mode.NEWTON: "newton_v"}.get(
        params.mode
    )


def _block_of(arr: np.ndarray, plan, l: int, coords) -> np.ndarray:
    """This rank's block of a distributed level's global array."""
    dc = plan.data_coords(coords) + (0,)
    b = plan.block[l]
    if tuple(arr.shape) != tuple(plan.alloc[l]):
        raise ValueError(
            f"level {l} array of shape {arr.shape}, the plan allocates "
            f"{plan.alloc[l]}"
        )
    return arr[tuple(slice(c * n, (c + 1) * n) for c, n in zip(dc, b))]


def spmd_state_from_numpy(
    params: GridParams,
    plan,
    arrays: Sequence[np.ndarray],
    mesh,
    newton_f: Optional[np.ndarray] = None,
) -> GridState:
    """A state of the port's distributed engine for this rank of ``mesh``
    from the JAX spmd engine's flat state (``np.asarray`` of each array):
    per level ``v, f`` and the mode's third field (FAS rest_v, Newton ũ).
    A distributed level's global array (the plan's ``alloc``) is sliced
    into this rank's block; a replicated level is cropped from the JAX
    allocation to ``(n+2)³``.  A tail plan's state (JAX's ``tail="pv2"``:
    its TPU-granular allocation and its root ``alloc0_j``, the gathered
    halved blocks with a 128-lane z) goes by interior cells, as
    ``pod_state_from_numpy``.  NEWTON takes the JAX ``plan.newton_f``."""
    if plan.tail_pv2 is not None:
        return pod_state_from_numpy(params, plan, arrays, mesh, newton_f)
    return spmd_blocks_from_numpy(params, plan, arrays, mesh, newton_f)


def spmd_blocks_from_numpy(
    params: GridParams,
    plan,
    arrays: Sequence[np.ndarray],
    mesh,
    newton_f: Optional[np.ndarray] = None,
) -> GridState:
    """This rank's distributed state from global arrays in ``plan``'s own
    allocation (flat per level ``v, f`` and the mode's third field): each
    distributed level's array sliced into this rank's block, each
    replicated level cropped to ``(n+2)³``; ``newton_f`` in level 0's
    global allocation.  The layout a classic JAX plan shares with the
    port, and the one the port's spmd checkpoints hold for any plan."""
    dtype = torch_dtype(params.dtype)
    names = ("v", "f") + ((_third(params),) if _third(params) else ())
    if len(arrays) != len(names) * plan.nlev:
        raise ValueError(
            f"{len(arrays)} arrays given, the plan has {plan.nlev} levels "
            f"of {len(names)}"
        )

    def conv(arr, l):
        arr = np.asarray(arr)
        if l < plan.n_dist:
            a = _block_of(arr, plan, l, mesh.coords)
        else:
            a = crop(arr, plan.dims[l])
        return torch.from_numpy(np.array(a)).to(
            device=mesh.device, dtype=dtype
        )

    levels = []
    for l in range(plan.nlev):
        fields = {name: conv(arrays[len(names) * l + i], l)
                  for i, name in enumerate(names)}
        fields["r"] = torch.zeros_like(fields["v"])
        levels.append(GridLevel(**fields))
    nf = None
    if params.mode == Mode.NEWTON:
        if newton_f is None:
            raise ValueError("NEWTON mode needs newton_f")
        nf = conv(newton_f, 0)
    return GridState(levels=tuple(levels), newton_f=nf)


def spmd_state_to_numpy(state: GridState, params: GridParams,
                        plan) -> List[np.ndarray]:
    """The flat per-level ``v, f`` (and third field) of a classic-plan
    distributed state: this rank's blocks of the distributed levels, the
    replicated levels in the JAX package's allocation, zero beyond the
    padded region.  (A tail plan's state goes back by interior cells:
    ``pod_state_to_numpy`` with the JAX plan's shapes.)"""
    names = ("v", "f") + ((_third(params),) if _third(params) else ())
    out = []
    for l, lvl in enumerate(state.levels):
        for name in names:
            a = getattr(lvl, name).detach().cpu().numpy()
            if l >= plan.n_dist:
                full = np.zeros(jax_alloc_shape(plan.dims[l]), dtype=a.dtype)
                full[: a.shape[0], : a.shape[1], : a.shape[2]] = a
                a = full
            out.append(a)
    return out


def state_to_numpy(
    state: GridState, params: GridParams
) -> List[Dict[str, np.ndarray]]:
    """Per-level numpy fields of a port state in the JAX package's
    allocation, zero beyond the padded region."""
    out = []
    for d, lvl in zip(params.level_dims(), state.levels):
        fields = {}
        for name in _fields(params):
            a = getattr(lvl, name).detach().cpu().numpy()
            full = np.zeros(jax_alloc_shape(d), dtype=a.dtype)
            full[: a.shape[0], : a.shape[1], : a.shape[2]] = a
            fields[name] = full
        out.append(fields)
    return out


def _interior(arr: np.ndarray, dims: Dims) -> np.ndarray:
    """The padded ``(n+2)³`` field of a global level array whose cell i
    sits at index i: its interior cells, zero around them."""
    nx, ny, nz = dims
    out = np.zeros((nx + 2, ny + 2, nz + 2), dtype=arr.dtype)
    out[1:nx + 1, 1:ny + 1, 1:nz + 1] = arr[1:nx + 1, 1:ny + 1, 1:nz + 1]
    return out


def pod_state_from_numpy(
    params: GridParams,
    plan,
    arrays: Sequence[np.ndarray],
    mesh,
    newton_f: Optional[np.ndarray] = None,
) -> GridState:
    """A pod engine state (``dist/pod.PodPlan``; also a tail plan's) for
    this rank of ``mesh`` from the JAX pod engine's flat state (``np.asarray`` of each array,
    ``gpusolve_tpu/dist/pod.py`` ``local_init``'s layout): per level ``v,
    f`` and the mode's third field (FAS rest_v, Newton ũ), the pod levels
    in the TPU's pod blocks, then the tail levels.  Each level's interior
    cells go into this rank's block (the pod levels; the tail's root and
    the tail levels are ``(n+2)³``).  NEWTON takes ``newton_f``, the
    original right-hand side, in level 0's global layout."""
    from gpusolve_tpu_torch.dist.spmd import _window

    dtype = torch_dtype(params.dtype)
    names = ("v", "f") + ((_third(params),) if _third(params) else ())
    if len(arrays) != len(names) * plan.nlev:
        raise ValueError(
            f"{len(arrays)} arrays given, the plan has {plan.nlev} levels "
            f"of {len(names)}"
        )
    dc = plan.data_coords(mesh.coords) + (0,)

    def conv(arr, l):
        full = torch.from_numpy(_interior(np.asarray(arr), plan.dims[l]))
        if l < plan.n_dist:
            b = plan.block[l]
            full = _window(full, tuple(c * n for c, n in zip(dc, b)), b)
        return full.to(device=mesh.device, dtype=dtype)

    levels = []
    for l in range(plan.nlev):
        fields = {name: conv(arrays[len(names) * l + i], l)
                  for i, name in enumerate(names)}
        fields["r"] = torch.zeros_like(fields["v"])
        levels.append(GridLevel(**fields))
    nf = None
    if params.mode == Mode.NEWTON:
        if newton_f is None:
            raise ValueError("NEWTON mode needs the original newton_f")
        nf = conv(newton_f, 0)
    return GridState(levels=tuple(levels), newton_f=nf)


def pod_state_to_numpy(state: GridState, params: GridParams, plan,
                       shapes: Sequence[Tuple[int, int, int]],
                       mesh) -> List[np.ndarray]:
    """The flat per-level ``v, f`` (and third field) of a pod engine
    state in the JAX pod engine's layout: ``shapes[l]`` is level l's
    global array shape there; this rank's interior cells of each level at
    their global indices, zero elsewhere."""
    names = ("v", "f") + ((_third(params),) if _third(params) else ())
    dc = plan.data_coords(mesh.coords) + (0,)
    out = []
    for l, lvl in enumerate(state.levels):
        nx, ny, nz = plan.dims[l]
        for name in names:
            a = getattr(lvl, name).detach().cpu().numpy()
            full = np.zeros(shapes[l], dtype=a.dtype)
            if l < plan.n_dist:
                x0, x1, y0, y1, z0, z1 = plan.box(l, mesh.coords)
                gx, gy = dc[0] * a.shape[0], dc[1] * a.shape[1]
                full[gx + x0:gx + x1 + 1, gy + y0:gy + y1 + 1, z0:z1 + 1] = \
                    a[x0:x1 + 1, y0:y1 + 1, z0:z1 + 1]
            else:
                full[1:nx + 1, 1:ny + 1, 1:nz + 1] = \
                    a[1:nx + 1, 1:ny + 1, 1:nz + 1]
            out.append(full)
    return out
