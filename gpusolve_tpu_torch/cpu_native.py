"""ctypes bridge to the C++/OpenMP host solver (``ops/csrc/gpusolve_cpu.cpp``).

The port's counterpart of ``gpusolve_tpu/cpu_native.py``: a native,
OpenMP-parallel float64 solver of the same numerics, in all three modes.
It serves as ``--backend cpu-native`` on the CLI and as the independent
float64 golden that the parity check (``scripts/parity.py``) holds the
card's engines against: it needs no JAX and no card, only g++ with
OpenMP, which the card's machine has for nvcc.

The source is the port's own copy of ``csrc/gpusolve_cpu.cpp``, byte for
byte.  It is compiled with g++ at first use into
``gpusolve_tpu_torch/build/``, named by a hash of the source, the flags
and the host CPU; a missing compiler or OpenMP raises, nothing falls
back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from gpusolve_tpu_torch.config import GridParams

SOURCE = Path(__file__).resolve().parent / "ops" / "csrc" / "gpusolve_cpu.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "build"
GXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-std=c++17", "-shared",
             "-fPIC")
STRIP_ENV = "GPUSOLVE_CPU_STRIP_KB"

_lib = None


class _CConfig(ctypes.Structure):
    _fields_ = [
        ("maxiter", ctypes.c_int64),
        ("tol", ctypes.c_double),
        ("dim", ctypes.c_int64 * 3),
        ("mode", ctypes.c_int),
        ("pre_smooth", ctypes.c_int64),
        ("post_smooth", ctypes.c_int64),
        ("omega", ctypes.c_double),
        ("gamma", ctypes.c_double),
        ("stencil_values", ctypes.c_double * 7),
        ("stencil_off", (ctypes.c_int64 * 3) * 7),
    ]


def available() -> bool:
    """True when the library builds and loads here."""
    try:
        _load()
    except (OSError, subprocess.CalledProcessError):
        return False
    return True


def seed_strip_kb() -> None:
    """Set the smoother's strip budget from the tuning table
    (``utils/tuning.current().cpu_strip_kb``) unless the environment
    already sets it.  The C++ code reads it once, at its first fused
    sweep (``gpusolve_cpu.cpp`` ``jacobi_fused``), so this runs before any
    solve."""
    if STRIP_ENV not in os.environ:
        from gpusolve_tpu_torch.utils import tuning

        os.environ[STRIP_ENV] = str(tuning.current().cpu_strip_kb)


def _host_cpu() -> bytes:
    """The host CPU's model and flags: ``-march=native`` builds for them,
    so a build directory copied to another machine builds anew there."""
    try:
        with open("/proc/cpuinfo", "rb") as fh:
            return b"".join(ln for ln in fh
                            if ln.startswith((b"model name", b"flags")))
    except OSError:
        return b""


def library_path() -> Path:
    """The built library's path, keyed by a hash of the source, the
    flags and the host CPU."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    h.update(_host_cpu())
    return BUILD_DIR / f"libgpusolve_cpu_{h.hexdigest()[:16]}.so"


def _load():
    global _lib
    if _lib is not None:
        return _lib
    seed_strip_kb()
    so_path = library_path()
    if not so_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # Per-PID temporary file and an atomic rename: processes racing
        # on a fresh source hash never write into one file.
        tmp = f"{so_path}.{os.getpid()}.tmp"
        subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", tmp],
                       check=True, capture_output=True)
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(str(so_path))
    lib.gpusolve_cpu_solve.restype = ctypes.c_int64
    lib.gpusolve_cpu_solve.argtypes = [
        ctypes.POINTER(_CConfig),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.gpusolve_cpu_num_threads.restype = ctypes.c_int
    lib.gpusolve_cpu_num_threads.argtypes = []
    _lib = lib
    return lib


def _to_cconfig(params: GridParams) -> _CConfig:
    if len(params.stencil.values) > 7:
        raise ValueError(
            f"the host solver takes at most 7 stencil taps, got "
            f"{len(params.stencil.values)}"
        )
    cfg = _CConfig()
    cfg.maxiter = params.maxiter
    cfg.tol = params.tol
    for i, d in enumerate(params.grid_dim):
        cfg.dim[i] = d
    cfg.mode = int(params.mode)
    cfg.pre_smooth = params.pre_smoothing
    cfg.post_smooth = params.post_smoothing
    cfg.omega = params.omega
    cfg.gamma = params.gamma
    for i, v in enumerate(params.stencil.values):
        cfg.stencil_values[i] = v
    for i, off in enumerate(params.stencil.offsets):
        for a in range(3):
            cfg.stencil_off[i][a] = off[a]
    return cfg


def solve_native(params: GridParams, with_times: bool = False):
    """The whole solve (any mode) in float64 on the host.  Returns the
    padded ``(n+2)³`` float64 solution field (level 0's ``newton_v`` in
    NEWTON mode) and the residual history ``[initial, res_0, ...]``; with
    ``with_times`` also each iteration's measured wall ms (the reference's
    per-cycle timer).  ``params.dtype`` and ``params.backend`` are not
    read: the solver is float64 throughout."""
    lib = _load()
    cfg = _to_cconfig(params)
    nx, ny, nz = params.grid_dim
    sol = np.zeros((nx + 2, ny + 2, nz + 2), dtype=np.float64)
    hist = np.zeros(params.maxiter + 1, dtype=np.float64)
    times = np.zeros(max(1, params.maxiter), dtype=np.float64)
    ptr = ctypes.POINTER(ctypes.c_double)
    iters = lib.gpusolve_cpu_solve(
        ctypes.byref(cfg), sol.ctypes.data_as(ptr),
        hist.ctypes.data_as(ptr), times.ctypes.data_as(ptr),
    )
    if iters < 0:
        raise RuntimeError("gpusolve_cpu_solve failed")
    history = [float(h) for h in hist[: iters + 1]]
    if with_times:
        return sol, history, [float(t) for t in times[:iters]]
    return sol, history


def num_threads() -> int:
    """The OpenMP threads the solver runs on."""
    return int(_load().gpusolve_cpu_num_threads())
