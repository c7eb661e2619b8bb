"""Grid level hierarchy and analytic right-hand side, on torch tensors.

The counterpart of ``gpusolve_tpu/grid.py``.  Each multigrid level is a set
of dense, contiguous tensors of shape ``(nx+2, ny+2, nz+2)``: axis order
(x, y, z) with z contiguous, and a one-cell halo on every face that holds
the zero Dirichlet boundary.  Every cell outside the interior is zero
forever; every op writes interiors only.  The TPU package's (8, 8, 128)
allocation rounding is a TPU tiling rule and is not carried over.

Fields per level: ``v`` (solution / correction), ``f`` (RHS:
the analytic RHS on level 0, the restricted residual below) and ``r``
(residual scratch and the smoother's ping-pong partner).  The interpolated
correction ``e`` of the reference is fused away: the prolongation adds into
``v`` directly.  ``rest_v`` (FAS) and ``newton_v`` (Newton) are allocated
for those modes only.  Newton's ``newton_f``, the original finest RHS, is a
tensor of its own: the ops write in place, and every Newton step writes F
into level 0's f, so an alias of that f would lose the RHS.

Analytic RHS:
  * linear mode:    f(x,y,z) = -(f2(x)f0(y)f0(z) + f0(x)f2(y)f0(z)
                                 + f0(x)f0(y)f2(z)),  f0(t)=100 t^4 (t-1)^4,
                    at x=(i-1)h for padded interior index i
  * nonlinear/Newton: f = 2((y-y²)(z-z²)+(x-x²)(z-z²)+(x-x²)(y-y²))
                        + γ (x-x²)(y-y²)(z-z²) e^{(x-x²)(y-y²)(z-z²)},
                    at x=i·h for padded interior index i
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from gpusolve_tpu_torch.config import GridParams, Mode

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(
            f"dtype must be 'float32' or 'float64', got {name!r}"
        ) from None


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the one asked for, else CUDA.

    With no device given and no CUDA present this raises; the port never
    falls back to the CPU by itself (pass ``device="cpu"`` for that)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the host"
        )
    return torch.device("cuda")


@dataclasses.dataclass
class GridLevel:
    """One multigrid level's padded field tensors."""

    v: torch.Tensor
    f: torch.Tensor
    r: torch.Tensor
    rest_v: Optional[torch.Tensor] = None
    newton_v: Optional[torch.Tensor] = None


@dataclasses.dataclass
class GridState:
    """The level hierarchy plus Newton's saved original RHS.

    ``shardings``: None for a state on one device; for a state placed by
    ``dist.sharding.shard_state``, one ``LevelSharding`` per level, and
    each level's tensors are this rank's block of it with a ghost frame
    (a replicated level whole)."""

    levels: Tuple[GridLevel, ...]
    newton_f: Optional[torch.Tensor] = None
    shardings: Optional[tuple] = None

    @property
    def device(self) -> torch.device:
        return self.levels[0].v.device


def _f0(t):
    """100·t⁴(t−1)⁴."""
    return 100.0 * (t * (t - 1.0)) ** 4


def _f2(t):
    """Second derivative of f0."""
    return 100.0 * 4.0 * (t - 1.0) * (t - 1.0) * t * t * (
        14.0 * t * t - 14.0 * t + 3.0
    )


def linear_rhs(dims: Tuple[int, int, int], h: float) -> np.ndarray:
    """Padded RHS cube for the linear Poisson problem, float64 on the host.

    Interior padded index i corresponds to coordinate (i-1)·h; the halo is
    0."""
    nx, ny, nz = dims
    out = np.zeros((nx + 2, ny + 2, nz + 2), dtype=np.float64)
    x = (np.arange(1, nx + 1, dtype=np.float64) - 1.0) * h
    y = (np.arange(1, ny + 1, dtype=np.float64) - 1.0) * h
    z = (np.arange(1, nz + 1, dtype=np.float64) - 1.0) * h
    X, Y, Z = np.meshgrid(x, y, z, indexing="ij")
    out[1:-1, 1:-1, 1:-1] = -(
        _f2(X) * _f0(Y) * _f0(Z)
        + _f0(X) * _f2(Y) * _f0(Z)
        + _f0(X) * _f0(Y) * _f2(Z)
    )
    return out


def nonlinear_rhs(
    dims: Tuple[int, int, int], h: float, gamma: float
) -> np.ndarray:
    """Padded RHS cube for ``-Δu + γ·u·e^u = f``, float64 on the host.

    Interior padded index i corresponds to coordinate i·h; the halo is 0
    (the exact solution is u = (x-x²)(y-y²)(z-z²))."""
    nx, ny, nz = dims
    out = np.zeros((nx + 2, ny + 2, nz + 2), dtype=np.float64)
    x = np.arange(1, nx + 1, dtype=np.float64) * h
    y = np.arange(1, ny + 1, dtype=np.float64) * h
    z = np.arange(1, nz + 1, dtype=np.float64) * h
    X, Y, Z = np.meshgrid(x, y, z, indexing="ij")
    gx = X - X * X
    gy = Y - Y * Y
    gz = Z - Z * Z
    prod = gx * gy * gz
    out[1:-1, 1:-1, 1:-1] = (
        2.0 * (gy * gz + gx * gz + gx * gy) + gamma * prod * np.exp(prod)
    )
    return out


def rhs_values(params: GridParams, x, y, z) -> torch.Tensor:
    """The analytic RHS at broadcastable coordinate tensors ``x, y, z``,
    with the formula and operation order of
    ``gpusolve_tpu.grid._device_rhs``."""
    if params.mode == Mode.LINEAR:
        def f0(t):
            # (s·s)·(s·s): the order XLA gives an integer power of 4.
            s = t * (t - 1.0)
            s2 = s * s
            return 100.0 * (s2 * s2)

        return -(
            _f2(x) * f0(y) * f0(z)
            + f0(x) * _f2(y) * f0(z)
            + f0(x) * f0(y) * _f2(z)
        )
    gx, gy, gz = x - x * x, y - y * y, z - z * z
    prod = gx * gy * gz
    return (
        2.0 * (gy * gz + gx * gz + gx * gy)
        + params.gamma * prod * torch.exp(prod)
    )


def _device_rhs(params: GridParams, dtype, device, start=(1, 1, 1),
                dims=None) -> torch.Tensor:
    """The finest RHS computed on the device in the working dtype; a
    grid-sized host array never crosses to the card.  ``start`` and
    ``dims``: the box of padded global indices whose values fill the
    result's interior (default: the whole grid), each point computed as
    the whole grid computes it."""
    nx, ny, nz = params.grid_dim if dims is None else dims
    h = params.h
    off = -1.0 if params.mode == Mode.LINEAR else 0.0

    def coord(s, n):
        return (torch.arange(s, s + n, dtype=dtype, device=device) + off) * h

    out = torch.zeros((nx + 2, ny + 2, nz + 2), dtype=dtype, device=device)
    out[1:-1, 1:-1, 1:-1] = rhs_values(
        params, coord(start[0], nx)[:, None, None],
        coord(start[1], ny)[None, :, None], coord(start[2], nz)[None, None, :],
    )
    return out


def build_grid(params: GridParams, device=None) -> GridState:
    """Allocate the level hierarchy and fill the finest-level RHS.

    ``device`` defaults to CUDA and raises when there is none.  float32
    fills the RHS on the device; float64 takes the host float64 formula,
    exact against the float64 oracle, as the JAX package does."""
    device = resolve_device(device)
    dtype = torch_dtype(params.dtype)
    levels = []
    for i, (nx, ny, nz) in enumerate(params.level_dims()):
        shape = (nx + 2, ny + 2, nz + 2)

        def zeros() -> torch.Tensor:
            return torch.zeros(shape, dtype=dtype, device=device)

        if i > 0:
            f = zeros()
        elif dtype == torch.float64:
            if params.mode == Mode.LINEAR:
                f_np = linear_rhs(params.grid_dim, params.h)
            else:
                f_np = nonlinear_rhs(params.grid_dim, params.h, params.gamma)
            f = torch.from_numpy(f_np).to(device)
        else:
            f = _device_rhs(params, dtype, device)
        levels.append(
            GridLevel(
                v=zeros(),
                f=f,
                r=zeros(),
                rest_v=zeros() if params.mode == Mode.NONLINEAR else None,
                newton_v=zeros() if params.mode == Mode.NEWTON else None,
            )
        )
    newton_f = levels[0].f.clone() if params.mode == Mode.NEWTON else None
    return GridState(levels=tuple(levels), newton_f=newton_f)
