"""Problem configuration: stencil, grid parameters, config-file parsing.

The port's own copy of ``gpusolve_tpu/config.py`` (that module is pure
Python, but importing it runs ``gpusolve_tpu/__init__.py``, which imports
jax).  The 14-line positional format, ``Mode``, ``Stencil`` and
``GridParams`` with ``level_dims``/``level_h`` are the same, field for field
and message for message, so a config parses to equal values in both
packages.

One field differs: ``backend`` takes ``"auto" | "ref" | "cuda" |
"cpu-native"``.
  * ``auto`` — the CUDA kernels for CUDA tensors, the plain PyTorch ops for
    CPU tensors;
  * ``ref``  — the plain PyTorch ops on any device (the oracle path);
  * ``cuda`` — the CUDA kernels; a CPU tensor raises;
  * ``cpu-native`` — the C++ host solver in float64
    (``cpu_native.solve_native``, ``--backend cpu-native``); the device
    solvers refuse it.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Tuple

BACKENDS = ("auto", "ref", "cuda", "cpu-native")


class Mode(enum.IntEnum):
    """Solver mode (config line 6)."""

    LINEAR = 0
    NONLINEAR = 1
    NEWTON = 2


@dataclasses.dataclass(frozen=True)
class Stencil:
    """A structured-sparse operator template.

    ``values[i]`` multiplies the grid point at relative offset
    ``offsets[i]``; only radius-1 offsets make sense with the 1-cell halo.
    ``values[0]`` is treated as the diagonal by the smoother.
    """

    values: Tuple[float, ...]
    offsets: Tuple[Tuple[int, int, int], ...]

    def __post_init__(self) -> None:
        if len(self.values) != len(self.offsets):
            raise ValueError(
                f"stencil has {len(self.values)} values but "
                f"{len(self.offsets)} offsets"
            )
        for off in self.offsets:
            if len(off) != 3:
                raise ValueError(f"stencil offset {off!r} is not 3-D")
            if any(abs(o) > 1 for o in off):
                raise ValueError(
                    f"stencil offset {off!r} exceeds the radius-1 halo"
                )

    @property
    def diag(self) -> float:
        """The diagonal coefficient (assumed at index 0)."""
        return self.values[0]

    @staticmethod
    def poisson_7pt() -> "Stencil":
        """The standard 7-point Laplacian of the example configs."""
        return Stencil(
            values=(6.0, -1.0, -1.0, -1.0, -1.0, -1.0, -1.0),
            offsets=(
                (0, 0, 0),
                (1, 0, 0),
                (-1, 0, 0),
                (0, 1, 0),
                (0, -1, 0),
                (0, 0, 1),
                (0, 0, -1),
            ),
        )


@dataclasses.dataclass(frozen=True)
class GridParams:
    """Full problem description (frozen, so instances hash)."""

    maxiter: int
    tol: float
    grid_dim: Tuple[int, int, int]
    mode: Mode
    pre_smoothing: int
    post_smoothing: int
    omega: float
    gamma: float
    stencil: Stencil
    print_progress: bool = True
    dtype: str = "float32"  # "float32" | "float64" (float64: plain ops only)
    backend: str = "auto"  # one of BACKENDS, see the module note
    # "V" recurses once per level, "W" twice, "F" F-then-V.  Each coarse
    # visit continues from the previous visit's v; every visit restricts
    # afresh and starts its own coarser v anew (at zero, or at the
    # restricted v in FAS), so one outer cycle is one stop-test iteration
    # whatever the schedule.
    cycle_type: str = "V"

    def __post_init__(self) -> None:
        object.__setattr__(self, "mode", Mode(self.mode))
        if self.cycle_type not in ("V", "W", "F"):
            raise ValueError(
                f"cycle_type must be 'V', 'W' or 'F', got "
                f"{self.cycle_type!r}"
            )
        if self.backend not in BACKENDS:
            raise ValueError(
                f"backend must be one of {', '.join(BACKENDS)}, got "
                f"{self.backend!r}"
            )

    @property
    def h(self) -> float:
        """Finest-level mesh width ``1/(gridDim_y + 1)``."""
        return 1.0 / (self.grid_dim[1] + 1)

    @property
    def num_levels(self) -> int:
        """``floor(log2(min dim)) + 1``."""
        return int(math.floor(math.log(min(self.grid_dim)) / math.log(2.0))) + 1

    def level_dims(self) -> Tuple[Tuple[int, int, int], ...]:
        """Interior dims per level; each coarser level halves every dim."""
        dims = [self.grid_dim]
        for _ in range(1, self.num_levels):
            px, py, pz = dims[-1]
            dims.append((px // 2, py // 2, pz // 2))
        return tuple(dims)

    def level_h(self, level: int) -> float:
        """Mesh width of a level: ``1/(levelDim_y + 1)``."""
        return 1.0 / (self.level_dims()[level][1] + 1)

    def replace(self, **kw) -> "GridParams":
        return dataclasses.replace(self, **kw)

    @property
    def properly_nested(self) -> bool:
        """True when every coarsening step satisfies fine = 2·coarse+1 per
        axis (dims of the form m·2^k−1), so coarse grid points coincide with
        fine ones.  Other sizes give misaligned coarse grids, on which the
        cycle may diverge, in the reference and here alike."""
        ds = self.level_dims()
        return all(
            f == 2 * c + 1
            for fine, coarse in zip(ds, ds[1:])
            for f, c in zip(fine, coarse)
        )


def parse_config_text(text: str, **overrides) -> GridParams:
    """Parse the 14-line whitespace-separated config format.

    Token order: maxiter, tol, dimX, dimY, dimZ, mode, preSmoothing,
    postSmoothing, omega, gamma, 7 stencil values, 7 x-offsets, 7 y-offsets,
    7 z-offsets.  Tokens are read from a flat whitespace-separated stream,
    so line structure is cosmetic.
    """
    toks = text.split()
    if len(toks) < 10 + 7 * 4:
        raise ValueError(
            f"config has {len(toks)} tokens, expected {10 + 7 * 4}"
        )
    it = iter(toks)

    def nxt(cast):
        return cast(next(it))

    maxiter = nxt(int)
    tol = nxt(float)
    dim = (nxt(int), nxt(int), nxt(int))
    mode_raw = nxt(int)
    try:
        mode = Mode(mode_raw)
    except ValueError:
        raise ValueError(f"Invalid mode {mode_raw} (expected 0, 1 or 2)")
    pre = nxt(int)
    post = nxt(int)
    omega = nxt(float)
    gamma = nxt(float)
    values = tuple(nxt(float) for _ in range(7))
    xoff = [nxt(int) for _ in range(7)]
    yoff = [nxt(int) for _ in range(7)]
    zoff = [nxt(int) for _ in range(7)]
    stencil = Stencil(values=values, offsets=tuple(zip(xoff, yoff, zoff)))

    params = GridParams(
        maxiter=maxiter,
        tol=tol,
        grid_dim=dim,
        mode=mode,
        pre_smoothing=pre,
        post_smoothing=post,
        omega=omega,
        gamma=gamma,
        stencil=stencil,
    )
    if overrides:
        params = params.replace(**overrides)
    return params


def parse_config(path: str, **overrides) -> GridParams:
    """Load a config file in the 14-line format."""
    with open(path, "r") as f:
        return parse_config_text(f.read(), **overrides)
