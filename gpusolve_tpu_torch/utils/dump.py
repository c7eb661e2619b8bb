"""Field dump and validation against the analytic solution.

The port's own copy of ``gpusolve_tpu/utils/dump.py`` (pure numpy; that
module is not imported, because importing ``gpusolve_tpu`` imports jax).
``dump_field`` writes the text format of the reference's ``Vector3::dump``:
a ``xDim yDim zDim`` header line followed by one ``x y z value`` line per
padded grid point, which the reference's plotter reads.
``compare_analytic`` is the in-process form of the plotter's overlay
against the exact solution ``u = (x-x²)(y-y²)(z-z²)``.
"""

from __future__ import annotations

import numpy as np


def dump_field(arr, path: str) -> None:
    """Write a padded 3-D field in Vector3::dump text format."""
    a = np.asarray(arr)
    if a.ndim != 3:
        raise ValueError(f"expected a 3-D field, got {a.ndim} dimensions")
    with open(path, "w") as out:
        out.write(f"{a.shape[0]} {a.shape[1]} {a.shape[2]}\n")
        for x in range(a.shape[0]):
            for y in range(a.shape[1]):
                for z in range(a.shape[2]):
                    out.write(f"{x} {y} {z} {a[x, y, z]:.17g}\n")


def load_dump(path: str) -> np.ndarray:
    """Read a Vector3::dump text file back."""
    with open(path, "r") as f:
        dims = tuple(int(t) for t in f.readline().split())
        mesh = np.zeros(dims)
        for line in f:
            parts = line.split()
            mesh[int(parts[0]), int(parts[1]), int(parts[2])] = float(parts[3])
    return mesh


def analytic_solution(padded_shape, h: float) -> np.ndarray:
    """Exact solution of the nonlinear/Newton problem on the padded grid:
    u = (x-x²)(y-y²)(z-z²) at coordinates index·h."""
    nx, ny, nz = padded_shape
    x = (np.arange(nx) * h)[:, None, None]
    y = (np.arange(ny) * h)[None, :, None]
    z = (np.arange(nz) * h)[None, None, :]
    return (x - x * x) * (y - y * y) * (z - z * z)


def compare_analytic(arr, h: float) -> float:
    """Max-abs error of a padded solution field vs the analytic solution."""
    a = np.asarray(arr)
    return float(np.max(np.abs(a - analytic_solution(a.shape, h))))
