"""The CUDA kernels of the multigrid cycle (LINEAR, FAS and NEWTON): build,
binding, wrappers, and the plain PyTorch version beside each.

The kernels live in ``csrc/``: the per-op kernels in ``multigrid.cu``, the
whole-V-cycle cooperative kernel in ``vcycle_fused.cu`` (its wrapper is
``ops/vcycle_fused.py``), the batch engine's fused legs in ``mg_legs.cu``
(wrappers below), the distributed engine's shard-local kernels in
``spmd_block.cu`` (their wrappers are ``ops/spmd_kernels.py``), their
trapezoid leg in ``spmd_leg.cu`` (its wrapper is ``ops/spmd_leg.py``; its
body in ``leg_device.cuh``), the pod engine's chains of legs in
``pod.cu`` (``ops/pod.py``), the in-kernel halo exchange and its CUDA IPC
helpers in ``rdma_exchange.cu`` (``ops/rdma.py``), their shared point
arithmetic in ``mg_device.cuh``.  On first use each source is
compiled with ``nvcc
-gencode arch=compute_90a,code=sm_90a``, the sources in parallel, and
linked into one shared library with a plain C interface under
``gpusolve_tpu_torch/build/``, loaded with ``ctypes``; nothing is built
when this module is imported.

Every wrapper:
  * takes the output buffers from the caller and writes them in place (the
    kernels allocate nothing; the wrapper allocates scratch with
    ``torch.empty``), and writes interiors only, so zero halos stay zero;
  * takes an optional ``done`` flag (an int32 tensor of one element): a
    kernel returns at once when it is set, which is how a batch of cycles
    stops on the device (``vcycle_batch``);
  * on a CPU tensor runs its plain version, which has the same contract and
    reads ``done`` on the host; on a CUDA tensor it checks device, dtype,
    shape and contiguity, launches on the current stream, raises on any
    launch error, and adds one to ``launches[name]``.

The residual and the sweep are one kernel templated on the mode; each mode
counts under its own name (``residual``, ``residual_fas``,
``residual_newton``, and so for ``jacobi_sweep``).  NEWTON reads the frozen
linearisation point ``newton_v`` (ũ), which its wrappers require.

Each plain version computes the same function with ``ops/ref.py``, writes
the same cells (interiors only) and rounds every field value as its kernel
does; ``chip_smoke.py`` holds each kernel against it on the card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from gpusolve_tpu_torch.config import GridParams, Mode, Stencil
from gpusolve_tpu_torch.ops import ref

Dims = Tuple[int, int, int]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (
    CSRC / "multigrid.cu", CSRC / "vcycle_fused.cu", CSRC / "spmd_block.cu",
    CSRC / "spmd_leg.cu", CSRC / "pod.cu", CSRC / "rdma_exchange.cu",
    CSRC / "mg_legs.cu",
)
HEADERS = (CSRC / "mg_device.cuh", CSRC / "leg_device.cuh")
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_SUFFIX = {Mode.LINEAR: "", Mode.NONLINEAR: "_fas", Mode.NEWTON: "_newton"}
KERNELS = (
    "residual", "residual_fas", "residual_newton", "finalize",
    "jacobi_sweep", "jacobi_sweep_fas", "jacobi_sweep_newton",
    "restrict_zero", "restrict", "prolong_add", "apply_fas", "subtract",
    "finalize_dev_thr", "newton_zero", "newton_update", "newton_gate",
    "vcycle_fused",
    "sweep_block", "sweep_block_fas", "sweep_block_newton",
    "residual_block", "residual_block_fas", "residual_block_newton",
    "residual_restrict_block", "residual_restrict_block_fas",
    "residual_restrict_block_newton", "prolong_add_block",
    "leg_block", "leg_block_fas", "leg_block_newton",
    "pod_down", "pod_down_fas", "pod_down_newton",
    "pod_up", "pod_up_fas", "pod_up_newton",
    "pod_down_ranks", "pod_down_ranks_fas", "pod_down_ranks_newton",
    "pod_up_ranks", "pod_up_ranks_fas", "pod_up_ranks_newton",
    "rdma_exchange",
    "down_leg", "down_leg_fas", "down_leg_newton",
    "up_leg", "up_leg_fas", "up_leg_newton",
)
# Launches of each kernel since the last reset_launches(): only the CUDA
# launches count, never the plain versions.
launches = {name: 0 for name in KERNELS}


def reset_launches() -> None:
    for name in KERNELS:
        launches[name] = 0


def variant(base: str, mode: Mode) -> str:
    """The counter name of a mode-templated kernel, e.g. ``residual_fas``."""
    return base + _SUFFIX[Mode(mode)]


# ---------------------------------------------------------------------------
# Build and binding
# ---------------------------------------------------------------------------

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.isfile(default):
        return default
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
        "CUDA kernels are compiled on first use"
    )


def _library_path() -> Path:
    """The built library's path, keyed by a hash of the sources and flags
    so an edited source builds anew."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*SOURCES, *HEADERS):
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmultigrid-{h.hexdigest()[:16]}.so"


def _run(procs) -> str:
    """Wait for every compiler process; raise on the first failure.
    Returns their messages."""
    log = []
    failed = None
    for cmd, proc in procs:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, out)
    if failed is not None:
        cmd, rc, out = failed
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}")
    return "".join(log)


def build() -> Tuple[Path, str]:
    """Compile the kernels if they are not built yet: one nvcc per source,
    all started together, then one link.  Returns the library path and the
    compiler's messages (ptxas register and spill counts), or an empty
    string when the library was already there."""
    out = _library_path()
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = f"{out.name}.{os.getpid()}"
    objs = [BUILD_DIR / f"{stem}.{src.stem}.o" for src in SOURCES]
    nvcc = _nvcc()
    procs = []
    for src, obj in zip(SOURCES, objs):
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    tmp = BUILD_DIR / f"{stem}.tmp"
    try:
        log = _run(procs)
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        log += _run([(cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))])
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out, log


def _bind(path: Path):
    lib = ctypes.CDLL(str(path))
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    sig = {
        "mg_residual_blocks": ([i, i, i], ll),
        "mg_error_string": ([i], ctypes.c_char_p),
        "mg_residual": (
            [p, p, p, p, p, p, i, i, i, p, p, i, f, f, i, i, p], i
        ),
        "mg_apply_fas": ([p, p, p, i, i, i, p, p, i, f, f, p], i),
        "mg_finalize": ([p, ll, p, f, p, p], i),
        "mg_finalize_stage_bytes": ([], i),
        "mg_jacobi": (
            [p, p, p, p, p, i, i, i, p, p, i, f, f, f, f, f, i, p], i
        ),
        "mg_restrict_zero": ([p, p, p, p, i, i, i, i, i, i, p], i),
        "mg_restrict": ([p, p, p, p, i, i, i, i, i, i, p], i),
        "mg_prolong_add": ([p, p, p, i, i, i, i, i, i, p], i),
        "mg_subtract": ([p, p, p, i, i, i, p], i),
        "mg_finalize_dev_thr": ([p, ll, p, p, p, p], i),
        "mg_newton_zero": ([p, p, i, i, i, p], i),
        "mg_newton_update": (
            [p, p, p, p, i, ctypes.c_uint, p, i, i, i, p], i
        ),
        "mg_newton_gate": ([p, f, f, p, p, p, p, p], i),
        "mg_vcycle_fused": (
            [p, i, i, i, i, i, p, p, p, p, p, i, f, f, p, p, p, p], i
        ),
        "mg_vcycle_fused_grid": ([i, p], i),
        "mg_box_blocks": ([i, i, i], ll),
        "mg_sweep_block": (
            [p] * 8 + [i] * 9 + [p, p, i, f, f, f, f, f, i, p], i
        ),
        "mg_residual_block": (
            [p] * 9 + [i] * 9 + [p, p, i, f, f, i, i, p], i
        ),
        "mg_residual_restrict_block": (
            [p] * 10 + [i] * 14 + [p, p, i, f, f, i, p], i
        ),
        "mg_residual_restrict_resident": ([i, p], i),
        "mg_prolong_add_block": ([p, p] + [i] * 11 + [p], i),
        "mg_leg_grid": ([p, p], i),
        "mg_leg_occupancy": ([p, p], i),
        "mg_leg_block": ([p, p, p, p, p, i, p], i),
        "mg_pod_chain": ([i, i, p, p, p, p, p, i, p, p, i, p], i),
        "mg_host_alloc": ([ll, p, p], i),
        "mg_host_free": ([p], i),
        "mg_rdma_exchange": ([p, p, p, i, p], i),
        "mg_ipc_alloc": ([i, ll, p], i),
        "mg_ipc_free": ([i, p], i),
        "mg_ipc_handle_size": ([], i),
        "mg_ipc_handle": ([i, p, p], i),
        "mg_ipc_open": ([i, p, p], i),
        "mg_ipc_close": ([i, p], i),
        "mg_leg_plan": ([i, i, i, i, i, p], i),
        "mg_up_leg_blocks": ([i, i, i, i], ll),
        "mg_leg_exact_walks": ([p, i], i),
        "mg_down_leg": (
            [p] * 8 + [i, i, i, p, p, i, f, f, f, f, f, i, i, p], i
        ),
        "mg_up_leg": (
            [p] * 7 + [i, i, i, p, p, i, f, f, f, f, f, i, i, p], i
        ),
    }
    for name, (args, res) in sig.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = res
    return lib


def lib():
    """The loaded kernel library, built on first call."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = _bind(build()[0])
        return _lib


def _check_rc(rc: int, name: str) -> None:
    if rc != 0:
        msg = lib().mg_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg}")


class _Taps:
    """The stencil as the C interface takes it: values and (x, y, z)
    offsets in host arrays that live as long as this object."""

    def __init__(self, stencil: Stencil) -> None:
        n = len(stencil.values)
        if n == 0 or n > 7:
            raise ValueError(f"stencil has {n} taps; the kernels take 1..7")
        self.n = n
        self.val = (ctypes.c_float * n)(*stencil.values)
        self.off = (ctypes.c_int * (3 * n))(
            *[o for off in stencil.offsets for o in off]
        )


@functools.lru_cache(maxsize=None)
def _taps(stencil: Stencil) -> _Taps:
    return _Taps(stencil)


# ---------------------------------------------------------------------------
# Checks
# ---------------------------------------------------------------------------


def _padded(dims: Dims) -> Tuple[int, int, int]:
    return (dims[0] + 2, dims[1] + 2, dims[2] + 2)


def _check(t: torch.Tensor, what: str, shape, device, dtype=torch.float32):
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{what} has shape {tuple(t.shape)}, expected {tuple(shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{what} is not contiguous")


def _cuda_device(t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor, got one on {t.device}")
    if t.device.index != torch.cuda.current_device():
        raise ValueError(
            f"tensor on {t.device} but the current device is "
            f"cuda:{torch.cuda.current_device()}"
        )
    return t.device


def _check_halving(fine_dims: Dims, coarse_dims: Dims) -> None:
    if any(c != fd // 2 for fd, c in zip(fine_dims, coarse_dims)):
        raise ValueError(
            f"coarse dims {coarse_dims} are not the halving of {fine_dims}"
        )


def _newton_v_for(params: GridParams, newton_v):
    """ũ when the mode reads it (NEWTON, where it is required), else
    None."""
    if params.mode != Mode.NEWTON:
        return None
    if newton_v is None:
        raise ValueError("NEWTON mode needs newton_v (the frozen ũ)")
    return newton_v


# One zero flag per device for the launches given no ``done``.  Only the
# finalize kernels and the Newton gate write a flag: ``finalize`` only
# with a stop threshold, which it refuses without a flag of the caller's,
# ``finalize_dev_thr`` and ``newton_gate`` only into flags the caller
# passes (they take no default): so this one stays 0.
_zero_done = {}


def _done_or_zero(done: Optional[torch.Tensor], device) -> torch.Tensor:
    if done is None:
        flag = _zero_done.get(device)
        if flag is None:
            flag = torch.zeros(1, dtype=torch.int32, device=device)
            _zero_done[device] = flag
        return flag
    _check(done, "done", (1,), device, torch.int32)
    return done


def _is_done(done: Optional[torch.Tensor]) -> bool:
    return done is not None and bool(done.item())


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


# ---------------------------------------------------------------------------
# residual — replaces gpusolve_tpu/ops/pallas_kernels.py::_residual_call
# (:292) in all three modes.  Bound: bytes (reads v and f, NEWTON also ũ,
# writes r: 12 B/point with r, 16 with ũ, 8 B/point norm-only; ~15 flops,
# ~40 with expf).  Design: one thread per (y, z) column walks 8 x-planes so
# neighbour taps hit in L1; Σr² is reduced in float64 per block into
# `partials` (one double per block, fixed order) for `finalize`, instead of
# the TPU kernel's sequential Kahan chain, which a parallel grid cannot
# carry.  The mode is a template parameter, so the LINEAR instantiation
# carries no nonlinear code.
# ---------------------------------------------------------------------------


def residual_plain(
    r_out, v, f, dims, params, h, *, write_r=True, with_norm=False,
    done=None, newton_v=None,
) -> Optional[torch.Tensor]:
    """Plain version of :func:`residual`: the partials are one float64
    Σr²."""
    nv = _newton_v_for(params, newton_v)
    if _is_done(done):
        return v.new_zeros(1, dtype=torch.float64) if with_norm else None
    r, _ = ref.residual(v, f, dims, params, h, newton_v=nv)
    if write_r:
        ref.interior(r_out, dims).copy_(ref.interior(r, dims))
    if not with_norm:
        return None
    r_int = ref.interior(r, dims).to(torch.float64)
    return torch.sum(r_int * r_int).reshape(1)


def residual(
    r_out: Optional[torch.Tensor],
    v: torch.Tensor,
    f: torch.Tensor,
    dims: Dims,
    params: GridParams,
    h: float,
    *,
    write_r: bool = True,
    with_norm: bool = False,
    done: Optional[torch.Tensor] = None,
    newton_v: Optional[torch.Tensor] = None,
) -> Optional[torch.Tensor]:
    """``r = f − (A·v/h² + mode term)`` over the interior (LINEAR: no term,
    NONLINEAR: γ·v·eᵛ, NEWTON: γ·(1+ũ)·v·e^ũ), written into ``r_out`` when
    ``write_r``.  With ``with_norm`` returns the float64 partial sums of r²
    that :func:`finalize` reduces; else None."""
    if v.device.type == "cpu":
        return residual_plain(
            r_out, v, f, dims, params, h, write_r=write_r,
            with_norm=with_norm, done=done, newton_v=newton_v,
        )
    nv = _newton_v_for(params, newton_v)
    dev = _cuda_device(v)
    shape = _padded(dims)
    _check(v, "v", shape, dev)
    _check(f, "f", shape, dev)
    if nv is not None:
        _check(nv, "newton_v", shape, dev)
    if write_r:
        _check(r_out, "r_out", shape, dev)
        inputs = [v.data_ptr(), f.data_ptr()]
        if nv is not None:
            inputs.append(nv.data_ptr())
        if r_out.data_ptr() in inputs:
            raise ValueError("r_out must not alias v, f or newton_v")
    done = _done_or_zero(done, dev)
    L = lib()
    partials = None
    if with_norm:
        partials = torch.empty(
            L.mg_residual_blocks(*dims), dtype=torch.float64, device=dev
        )
    t = _taps(params.stencil)
    rc = L.mg_residual(
        v.data_ptr(), f.data_ptr(), nv.data_ptr() if nv is not None else None,
        r_out.data_ptr() if write_r else None,
        partials.data_ptr() if with_norm else None, done.data_ptr(),
        *dims, t.val, t.off, t.n, 1.0 / (h * h), params.gamma,
        int(params.mode), int(write_r), _stream(dev),
    )
    name = variant("residual", params.mode)
    _check_rc(rc, name)
    launches[name] += 1
    return partials


# ---------------------------------------------------------------------------
# apply_fas — replaces the apply_mode variant of
# gpusolve_tpu/ops/pallas_kernels.py::_residual_call (:292, used by
# apply_stencil_fas) and the FAS tau fold of
# gpusolve_tpu/ops/pallas_vcycle2.py::_vcycle2_call (:1338-1340).  Bound:
# bytes (reads v, reads and writes out: 12 B/point).  Design: the
# residual's thread walk, adding onto the coarse f that holds R(r), so the
# tau correction costs no extra field.
# ---------------------------------------------------------------------------


def apply_fas_plain(out, v, dims, params, h, done=None):
    """Plain version of :func:`apply_fas`."""
    if _is_done(done):
        return
    a = ref.interior(ref.apply_stencil_fas(v, dims, params, h), dims)
    ref.interior(out, dims).add_(a)


def apply_fas(
    out: torch.Tensor,
    v: torch.Tensor,
    dims: Dims,
    params: GridParams,
    h: float,
    done: Optional[torch.Tensor] = None,
) -> None:
    """``out += A(v)/h² + γ·v·eᵛ`` over the interior: the tau fold
    ``f_c = R(r) + A_c(R v)``, rounded as that sum; onto a zero ``out``,
    the FAS operator itself."""
    if v.device.type == "cpu":
        return apply_fas_plain(out, v, dims, params, h, done)
    dev = _cuda_device(v)
    shape = _padded(dims)
    _check(out, "out", shape, dev)
    _check(v, "v", shape, dev)
    if out.data_ptr() == v.data_ptr():
        raise ValueError("out must not alias v")
    done = _done_or_zero(done, dev)
    t = _taps(params.stencil)
    rc = lib().mg_apply_fas(
        out.data_ptr(), v.data_ptr(), done.data_ptr(), *dims, t.val, t.off,
        t.n, 1.0 / (h * h), params.gamma, _stream(dev),
    )
    _check_rc(rc, "apply_fas")
    launches["apply_fas"] += 1


# ---------------------------------------------------------------------------
# finalize — replaces the norm output and in-kernel early stop of
# gpusolve_tpu/ops/pallas_vcycle2.py::_vcycle2_call (cycle_body, :1370) and
# the Σr² scalar of _residual_call.  Bound: latency (the partials are one
# double per residual block, 512 KB at 511³: a few µs of one SM's L2
# bandwidth).  Design: one thread-block cluster of 8 blocks × 128 threads
# sums the partials in float64 in a fixed order (1024 slots, each summed
# in order from rows that 16-byte cp.async copies land in shared memory,
# all in flight at once; then a halving tree in block 0 over the slot sums
# the blocks write into its shared memory), rounds once to float32,
# writes ``out[0]`` and sets ``done`` when ``thr >= 0 and sumsq <= thr``.
# ``finalize_slots_plain`` reproduces that order on the CPU;
# ``finalize_plain`` (``torch.sum``) is the plain version the CPU path
# runs.
# ---------------------------------------------------------------------------

FIN_SLOTS = 1024  # mg_device.cuh kFinThreads


def finalize_slots_plain(partials: torch.Tensor) -> torch.Tensor:
    """Σ partials in float64 in the finalize kernel's order: slot q sums
    partials q, q + 1024, ... in order, then ``s[q] += s[q + w]`` for
    w = 512 … 1; returns ``s[0]`` (a float64 scalar tensor, on the CPU).
    The kernel rounds it once to float32."""
    p = partials.detach().to("cpu", torch.float64).reshape(-1)
    rows = -(-p.numel() // FIN_SLOTS)
    # Trailing +0.0 leaves every slot's sum as it is: a slot sum starts
    # at +0.0 and so is never −0.0.
    padded = torch.zeros(rows * FIN_SLOTS, dtype=torch.float64)
    padded[:p.numel()] = p
    s = torch.zeros(FIN_SLOTS, dtype=torch.float64)
    for row in padded.reshape(rows, FIN_SLOTS):
        s = s + row
    while s.numel() > 1:
        w = s.numel() // 2
        s = s[:w] + s[w:]
    return s[0]


def finalize_plain(partials, out, thr=-1.0, done=None) -> None:
    """Plain version of :func:`finalize`."""
    if _is_done(done):
        return
    ss = torch.sum(partials).to(out.dtype)
    out.copy_(ss.reshape(1))
    if thr >= 0.0 and done is not None:
        done.copy_((ss <= thr).to(torch.int32).reshape(1))


def finalize(
    partials: torch.Tensor,
    out: torch.Tensor,
    thr: float = -1.0,
    done: Optional[torch.Tensor] = None,
) -> None:
    """``out[0] = float32(Σ partials)``; set ``done`` when ``thr >= 0`` and
    the sum is ``<= thr``.  ``out`` may be a one-element view into a longer
    vector (the batch's per-cycle norms)."""
    if partials.device.type == "cpu":
        return finalize_plain(partials, out, thr, done)
    dev = _cuda_device(partials)
    _check(partials, "partials", None, dev, torch.float64)
    if partials.data_ptr() % 16:
        raise ValueError("partials must start on a 16-byte boundary (the "
                         "kernel copies them 16 bytes at a time)")
    _check(out, "out", (1,), dev)
    if thr >= 0.0 and done is None:
        raise ValueError("a stop threshold needs a done flag to set")
    done = _done_or_zero(done, dev)
    rc = lib().mg_finalize(
        partials.data_ptr(), partials.numel(), out.data_ptr(), thr,
        done.data_ptr(), _stream(dev),
    )
    _check_rc(rc, "finalize")
    launches["finalize"] += 1


# ---------------------------------------------------------------------------
# jacobi_sweep — replaces the sweeps of
# gpusolve_tpu/ops/pallas_vcycle2.py::_vcycle2_call (jacobi_plane, :421;
# the Newton ũ stream `snv`, :432-444) and
# gpusolve_tpu/ops/pallas_kernels.py::_jacobi_call (:172), in all three
# modes.  Bound: bytes (reads v and f, NEWTON also ũ, writes v_out: 12 or
# 16 B/point; ~17 flops, ~45 with expf and the division).  Design: out of
# place into the level's spare buffer (the dispatch.smooth ping-pong), with
# the residual's thread walk; one pass per sweep.  The batch engine fuses
# a leg's sweeps into one pass (down_leg / up_leg below); this kernel runs
# the coarsest level's sweeps and the legs the gate refuses.
# ---------------------------------------------------------------------------


def jacobi_sweep_plain(
    v_out, v, f, dims, params, h, done=None, newton_v=None
) -> None:
    """Plain version of :func:`jacobi_sweep`."""
    nv = _newton_v_for(params, newton_v)
    if _is_done(done):
        return
    new_v = ref.jacobi(v, f, dims, params, h, 1, newton_v=nv)
    ref.interior(v_out, dims).copy_(ref.interior(new_v, dims))


def jacobi_sweep(
    v_out: torch.Tensor,
    v: torch.Tensor,
    f: torch.Tensor,
    dims: Dims,
    params: GridParams,
    h: float,
    done: Optional[torch.Tensor] = None,
    newton_v: Optional[torch.Tensor] = None,
) -> None:
    """One damped-Jacobi sweep over the interior of ``v_out``:
    LINEAR ``v + ω·(α·r)``, ``α = h²/values[0]``; NONLINEAR
    ``v + ω·r/(s₀/h² + γ(1+v)eᵛ)``; NEWTON ``v + ω·r/(s₀/h² + γ(1+ũ)e^ũ)``
    with r the mode's residual."""
    if v.device.type == "cpu":
        return jacobi_sweep_plain(
            v_out, v, f, dims, params, h, done, newton_v
        )
    nv = _newton_v_for(params, newton_v)
    dev = _cuda_device(v)
    shape = _padded(dims)
    for name, t in (("v_out", v_out), ("v", v), ("f", f)):
        _check(t, name, shape, dev)
    inputs = [v.data_ptr(), f.data_ptr()]
    if nv is not None:
        _check(nv, "newton_v", shape, dev)
        inputs.append(nv.data_ptr())
    if v_out.data_ptr() in inputs:
        raise ValueError("v_out must not alias v, f or newton_v")
    done = _done_or_zero(done, dev)
    t = _taps(params.stencil)
    rc = lib().mg_jacobi(
        v_out.data_ptr(), v.data_ptr(), f.data_ptr(),
        nv.data_ptr() if nv is not None else None, done.data_ptr(),
        *dims, t.val, t.off, t.n, 1.0 / (h * h),
        (h * h) / params.stencil.diag, params.omega, params.gamma,
        params.stencil.diag / (h * h), int(params.mode), _stream(dev),
    )
    name = variant("jacobi_sweep", params.mode)
    _check_rc(rc, name)
    launches[name] += 1


# ---------------------------------------------------------------------------
# restrict_zero — replaces the restrict consumer of
# gpusolve_tpu/ops/pallas_vcycle2.py::_vcycle2_call (restrict_yz, :484) and
# gpusolve_tpu/ops/pallas_kernels.py::_restrict_call (:526) for the LINEAR
# and NEWTON coarse start, with the coarse v zero fill fused in.  Bound:
# bytes (reads the fine r once, writes coarse f and v: 5 B per fine point).
# Design: one thread per coarse point gathers its 27 fine taps, most of
# which neighbouring threads also load (L1 hits); the zero fill rides along
# so coarse v costs no pass.
# ---------------------------------------------------------------------------


def restrict_zero_plain(
    f_coarse, v_coarse, r_fine, fine_dims, coarse_dims, done=None
) -> None:
    """Plain version of :func:`restrict_zero`."""
    if _is_done(done):
        return
    fc = ref.restrict_full_weighting(
        r_fine, fine_dims, coarse_dims, f_coarse.shape
    )
    ref.interior(f_coarse, coarse_dims).copy_(ref.interior(fc, coarse_dims))
    ref.interior(v_coarse, coarse_dims).zero_()


def restrict_zero(
    f_coarse: torch.Tensor,
    v_coarse: torch.Tensor,
    r_fine: torch.Tensor,
    fine_dims: Dims,
    coarse_dims: Dims,
    done: Optional[torch.Tensor] = None,
) -> None:
    """27-point full weighting of ``r_fine`` into the interior of
    ``f_coarse``; the interior of ``v_coarse`` is set to zero."""
    if r_fine.device.type == "cpu":
        return restrict_zero_plain(
            f_coarse, v_coarse, r_fine, fine_dims, coarse_dims, done
        )
    dev = _cuda_device(r_fine)
    _check(r_fine, "r_fine", _padded(fine_dims), dev)
    _check(f_coarse, "f_coarse", _padded(coarse_dims), dev)
    _check(v_coarse, "v_coarse", _padded(coarse_dims), dev)
    if f_coarse.data_ptr() == v_coarse.data_ptr():
        raise ValueError("f_coarse and v_coarse must be distinct")
    _check_halving(fine_dims, coarse_dims)
    done = _done_or_zero(done, dev)
    rc = lib().mg_restrict_zero(
        f_coarse.data_ptr(), v_coarse.data_ptr(), r_fine.data_ptr(),
        done.data_ptr(), *coarse_dims, *fine_dims, _stream(dev),
    )
    _check_rc(rc, "restrict_zero")
    launches["restrict_zero"] += 1


# ---------------------------------------------------------------------------
# restrict — replaces gpusolve_tpu/ops/pallas_kernels.py::_restrict_call
# (:526) where no zero fill follows: the FAS restrictions of
# gpusolve_tpu/ops/pallas_vcycle2.py::_vcycle2_call (R(r) into coarse f,
# R(v) into coarse v and rest_v, :634-640) and Newton's R(ũ) into levels
# 1..L−2 (gpusolve_tpu/solver/newton.py:62-80).  Bound: bytes (reads the
# fine field once, writes one or two coarse fields: 4.5 or 5 B per fine
# point).  Design: restrict_zero's gather; a second output takes the same
# value in the same pass, so FAS's two copies of R(v) cost one read.
# ---------------------------------------------------------------------------


def restrict_plain(
    out, fine, fine_dims, coarse_dims, done=None, out2=None
) -> None:
    """Plain version of :func:`restrict`."""
    if _is_done(done):
        return
    rc = ref.interior(
        ref.restrict_full_weighting(fine, fine_dims, coarse_dims, out.shape),
        coarse_dims,
    )
    for o in (out, out2):
        if o is not None:
            ref.interior(o, coarse_dims).copy_(rc)


def restrict(
    out: torch.Tensor,
    fine: torch.Tensor,
    fine_dims: Dims,
    coarse_dims: Dims,
    done: Optional[torch.Tensor] = None,
    out2: Optional[torch.Tensor] = None,
) -> None:
    """27-point full weighting of ``fine`` into the interior of ``out``
    (and of ``out2`` when given)."""
    if fine.device.type == "cpu":
        return restrict_plain(out, fine, fine_dims, coarse_dims, done, out2)
    dev = _cuda_device(fine)
    _check(fine, "fine", _padded(fine_dims), dev)
    _check(out, "out", _padded(coarse_dims), dev)
    if out2 is not None:
        _check(out2, "out2", _padded(coarse_dims), dev)
        if out2.data_ptr() == out.data_ptr():
            raise ValueError("out and out2 must be distinct")
    _check_halving(fine_dims, coarse_dims)
    done = _done_or_zero(done, dev)
    rc = lib().mg_restrict(
        out.data_ptr(), out2.data_ptr() if out2 is not None else None,
        fine.data_ptr(), done.data_ptr(), *coarse_dims, *fine_dims,
        _stream(dev),
    )
    _check_rc(rc, "restrict")
    launches["restrict"] += 1


# ---------------------------------------------------------------------------
# prolong_add — replaces the prolongation + correction of
# gpusolve_tpu/ops/pallas_vcycle2.py::_vcycle2_call (prolong_yz, :499) and
# gpusolve_tpu/ops/pallas_kernels.py::_prolong_call (:613).  Bound: bytes
# (reads and writes fine v, reads the ⅛-size coarse v: 8.5 B per fine
# point).  Design: in place (each point reads only its own fine v); one
# thread per coarse z column evaluates the reference's 4-pass interpolation
# in closed form for the two fine z points the column feeds, from up to 8
# coarse values, which neighbouring threads share through L1.
# ---------------------------------------------------------------------------


def prolong_add_plain(
    v_fine, v_coarse, fine_dims, coarse_dims, done=None
) -> None:
    """Plain version of :func:`prolong_add`."""
    if _is_done(done):
        return
    new_v = ref.prolong_add(v_fine, v_coarse, coarse_dims, fine_dims)
    ref.interior(v_fine, fine_dims).copy_(ref.interior(new_v, fine_dims))


def prolong_add(
    v_fine: torch.Tensor,
    v_coarse: torch.Tensor,
    fine_dims: Dims,
    coarse_dims: Dims,
    done: Optional[torch.Tensor] = None,
) -> None:
    """``v_fine += P(v_coarse)`` over the interior, trilinear, in place."""
    if v_fine.device.type == "cpu":
        return prolong_add_plain(
            v_fine, v_coarse, fine_dims, coarse_dims, done
        )
    dev = _cuda_device(v_fine)
    _check(v_fine, "v_fine", _padded(fine_dims), dev)
    _check(v_coarse, "v_coarse", _padded(coarse_dims), dev)
    _check_halving(fine_dims, coarse_dims)
    done = _done_or_zero(done, dev)
    rc = lib().mg_prolong_add(
        v_fine.data_ptr(), v_coarse.data_ptr(), done.data_ptr(),
        *fine_dims, *coarse_dims, _stream(dev),
    )
    _check_rc(rc, "prolong_add")
    launches["prolong_add"] += 1


# ---------------------------------------------------------------------------
# subtract — replaces the FAS `v −= restV` of
# gpusolve_tpu/ops/pallas_vcycle2.py::_vcycle2_call (:527-528): the coarse
# v becomes v − rest_v before the prolongation reads it, and keeps that
# value, as in the JAX cycle.  Bound: bytes (reads v and w, writes v: 12
# B/point of the coarse level, ⅛ of the fine).  Design: in place, a flat
# pass over each x-plane's interior span in groups of 4 floats (16-byte
# vectors where v and w are 16-byte aligned), each thread loading 4
# groups of v and of w before it stores, the points outside the interior
# masked out of the stores (v is ``__restrict__``, hence the refusal of
# any overlap of v and w); a fold into prolong_add could not leave the
# coarse state, since its threads share coarse values.
# ---------------------------------------------------------------------------


def _span(t: torch.Tensor) -> Tuple[int, int]:
    """The byte range [start, end) a tensor's elements lie in."""
    start = t.data_ptr()
    if t.numel() == 0:
        return start, start
    last = sum((n - 1) * st for n, st in zip(t.shape, t.stride()))
    return start, start + (last + 1) * t.element_size()


def _refuse_overlap(v: torch.Tensor, w: torch.Tensor) -> None:
    if v.device != w.device:
        return
    (a0, a1), (b0, b1) = _span(v), _span(w)
    if a0 < b1 and b0 < a1:
        raise ValueError("v and w must not share memory")


def subtract_plain(v, w, dims, done=None) -> None:
    """Plain version of :func:`subtract`."""
    _refuse_overlap(v, w)
    if _is_done(done):
        return
    ref.interior(v, dims).sub_(ref.interior(w, dims))


def subtract(
    v: torch.Tensor,
    w: torch.Tensor,
    dims: Dims,
    done: Optional[torch.Tensor] = None,
) -> None:
    """``v −= w`` over the interior, in place; ``v`` and ``w`` share no
    memory."""
    _refuse_overlap(v, w)
    if v.device.type == "cpu":
        return subtract_plain(v, w, dims, done)
    dev = _cuda_device(v)
    _check(v, "v", _padded(dims), dev)
    _check(w, "w", _padded(dims), dev)
    done = _done_or_zero(done, dev)
    rc = lib().mg_subtract(
        v.data_ptr(), w.data_ptr(), done.data_ptr(), *dims, _stream(dev)
    )
    _check_rc(rc, "subtract")
    launches["subtract"] += 1


# ---------------------------------------------------------------------------
# The device-batched Newton outer loop (solver/newton.py, _newton_batch):
# the work the JAX package does as XLA glue around its whole-batch kernel
# (gpusolve_tpu/solver/newton.py:144-200: lax.cond on the outer flag, the
# inner threshold's float32 arithmetic, newton_v + v), here kernels that
# honour the device flags, so up to K outer steps are enqueued with no host
# read between them.  ``odone`` is the outer flag (a step after the outer
# stop writes nothing), ``idone`` the inner solve's (it starts each step
# equal to ``odone``).
#
# finalize_dev_thr — finalize (above) with the stop threshold read from a
# one-element float32 tensor on the device, which the previous step's
# newton_gate writes.  Same kernel body and sum order (a template
# parameter), so its Σ is finalize's bit for bit.  Bound: latency.
# ---------------------------------------------------------------------------


def finalize_dev_thr_plain(partials, out, thr, done) -> None:
    """Plain version of :func:`finalize_dev_thr`."""
    if _is_done(done):
        return
    ss = torch.sum(partials).to(out.dtype).reshape(1)
    out.copy_(ss)
    t = thr.reshape(1)
    done.copy_(((t >= 0) & (ss <= t)).to(torch.int32))


def finalize_dev_thr(
    partials: torch.Tensor,
    out: torch.Tensor,
    thr: torch.Tensor,
    done: torch.Tensor,
) -> None:
    """``out[0] = float32(Σ partials)``; set ``done`` when ``thr[0] >= 0``
    and the sum is ``<= thr[0]``, ``thr`` a one-element float32 tensor on
    the device."""
    if partials.device.type == "cpu":
        return finalize_dev_thr_plain(partials, out, thr, done)
    dev = _cuda_device(partials)
    _check(partials, "partials", None, dev, torch.float64)
    if partials.data_ptr() % 16:
        raise ValueError("partials must start on a 16-byte boundary (the "
                         "kernel copies them 16 bytes at a time)")
    _check(out, "out", (1,), dev)
    _check(thr, "thr", (1,), dev)
    _check(done, "done", (1,), dev, torch.int32)
    rc = lib().mg_finalize_dev_thr(
        partials.data_ptr(), partials.numel(), out.data_ptr(),
        thr.data_ptr(), done.data_ptr(), _stream(dev),
    )
    _check_rc(rc, "finalize_dev_thr")
    launches["finalize_dev_thr"] += 1


# ---------------------------------------------------------------------------
# newton_zero — level 0's v = 0 over the interior unless ``done`` is set:
# the zero start of a Newton step (the zeros_like of
# gpusolve_tpu/solver/newton.py:69 under the lax.cond of :196).  Bound:
# bytes (writes v: 4 B/point).  Design: subtract's flat pass storing
# zeros, 16-byte stores where v is aligned, the halo never written.
# ---------------------------------------------------------------------------


def newton_zero_plain(v, dims, done) -> None:
    """Plain version of :func:`newton_zero`."""
    if _is_done(done):
        return
    ref.interior(v, dims).zero_()


def newton_zero(v: torch.Tensor, dims: Dims, done: torch.Tensor) -> None:
    """The interior of ``v`` = 0 unless ``done`` is set."""
    if v.device.type == "cpu":
        return newton_zero_plain(v, dims, done)
    dev = _cuda_device(v)
    _check(v, "v", _padded(dims), dev)
    _check(done, "done", (1,), dev, torch.int32)
    rc = lib().mg_newton_zero(v.data_ptr(), done.data_ptr(), *dims,
                              _stream(dev))
    _check_rc(rc, "newton_zero")
    launches["newton_zero"] += 1


# ---------------------------------------------------------------------------
# newton_update — ũ += v over the interior unless ``done`` is set
# (gpusolve_tpu/solver/newton.py:89 under :196).  The per-op visit's
# smoother ping-pongs level 0's v with its spare buffer, so with odd
# sweeps which of the two holds v after a step's inner solve depends on
# how many cycles it ran (its norms that are not −1), which only the
# device knows: the kernel counts them and picks the buffer.  (On the
# fused legs level 0's v ends each cycle in the buffer it began in, and
# the record names one buffer.)  Bound: bytes (reads ũ and v, writes ũ:
# 12 B/point).  Design: subtract's flat pass, adding.
# ---------------------------------------------------------------------------


def _two_buffers(v_after):
    """The two tensors of ``v_after`` (the tensor that holds v after c
    cycles, c = 0, 1, ...; one tensor twice where the parity is even) and
    the mask whose bit c is set where v is in the second."""
    va = v_after[0]
    others = {id(t): t for t in v_after if t is not va}
    if len(others) > 1:
        raise ValueError("v_after names more than two buffers")
    vb = next(iter(others.values()), va)
    mask = sum(1 << c for c, t in enumerate(v_after) if t is not va)
    return va, vb, mask


def newton_update_plain(nv, v_after, norms, dims, done) -> None:
    """Plain version of :func:`newton_update`."""
    if _is_done(done):
        return
    c = int(torch.count_nonzero(norms != -1.0))
    ref.interior(nv, dims).add_(ref.interior(v_after[c], dims))


def newton_update(
    nv: torch.Tensor,
    v_after,
    norms: torch.Tensor,
    dims: Dims,
    done: torch.Tensor,
) -> None:
    """``nv += v`` over the interior unless ``done`` is set, where v is
    ``v_after[c]`` and c is the count of entries of ``norms`` (the step's
    inner norms, −1 where a cycle did not run) that are not −1.
    ``v_after[c]`` is the tensor that holds v after c cycles, c = 0 …
    len(norms): at most two distinct tensors, neither sharing memory with
    ``nv``."""
    if len(v_after) != norms.numel() + 1:
        raise ValueError(
            f"v_after has {len(v_after)} entries for {norms.numel()} norms"
        )
    va, vb, mask = _two_buffers(v_after)
    for t in (va, vb):
        _refuse_overlap(nv, t)
    if nv.device.type == "cpu":
        return newton_update_plain(nv, v_after, norms, dims, done)
    dev = _cuda_device(nv)
    shape = _padded(dims)
    _check(nv, "nv", shape, dev)
    _check(va, "v", shape, dev)
    _check(vb, "v", shape, dev)
    _check(norms, "norms", (norms.numel(),), dev)
    _check(done, "done", (1,), dev, torch.int32)
    rc = lib().mg_newton_update(
        nv.data_ptr(), va.data_ptr(), vb.data_ptr(), norms.data_ptr(),
        norms.numel(), mask, done.data_ptr(), *dims, _stream(dev),
    )
    _check_rc(rc, "newton_update")
    launches["newton_update"] += 1


# ---------------------------------------------------------------------------
# newton_gate — the outer gate (gpusolve_tpu/solver/newton.py:194-199),
# one thread.  With ``ss`` (the step's ΣF², from comp_f's finalize), unless
# ``odone`` is set: ``res = sqrt(ΣF²)`` into ``res_out``, ``odone =
# idone = (res >= 0 and res <= thr_outer)`` and the next step's inner
# threshold from res into ``thr_in``.  Without ``ss`` (the seed of a
# batch): both flags cleared and ``thr_in`` from the host's ``fn``.  The
# inner threshold is the JAX loop's float32 formula (:176-179), see
# inner_threshold.  Bound: latency (a few words).  Design: one thread; the
# products rounded one by one, IEEE sqrtf and nextafterf.
# ---------------------------------------------------------------------------


def inner_threshold(fn):
    """The inner solve's squared stop threshold from ‖F‖, in float32 as
    the JAX package's batched loop rounds it: ``(f32(fn)·f32(0.1))²``
    moved up 2 ulps (numpy float32)."""
    with np.errstate(over="ignore"):  # a huge norm squares to inf
        t = np.float32(fn) * np.float32(0.1)
        t = t * t
    inf = np.float32(np.inf)
    return np.nextafter(np.nextafter(t, inf, dtype=np.float32), inf,
                        dtype=np.float32)


def newton_gate_plain(ss, fn, thr_outer, res_out, odone, idone,
                      thr_in) -> None:
    """Plain version of :func:`newton_gate`, in numpy float32 on the host
    (numpy's float32 root is correctly rounded, as the kernel's sqrtf and
    the per-step loop's root are; torch's float32 sqrt on the CPU can miss
    by an ulp)."""
    if ss is None:
        res, d = np.float32(fn), 0
    else:
        if _is_done(odone):
            return
        res = np.sqrt(np.float32(ss.item()))
        res_out.fill_(float(res))
        d = int(res >= 0 and res <= np.float32(thr_outer))
    odone.fill_(d)
    idone.fill_(d)
    thr_in.fill_(float(inner_threshold(res)))


def newton_gate(
    ss: Optional[torch.Tensor],
    fn: float,
    thr_outer: float,
    res_out: Optional[torch.Tensor],
    odone: torch.Tensor,
    idone: torch.Tensor,
    thr_in: torch.Tensor,
) -> None:
    """The outer gate after a step (``ss`` given), or the seed of a batch
    (``ss`` None, from the host's ‖F‖ ``fn``); see the note above.
    ``thr_outer`` is a float32 value; every tensor has one element."""
    if odone.device.type == "cpu":
        return newton_gate_plain(ss, fn, thr_outer, res_out, odone, idone,
                                 thr_in)
    dev = _cuda_device(odone)
    for name, t, dt in (("odone", odone, torch.int32),
                        ("idone", idone, torch.int32),
                        ("thr_in", thr_in, torch.float32)):
        _check(t, name, (1,), dev, dt)
    if ss is not None:
        _check(ss, "ss", (1,), dev)
        _check(res_out, "res_out", (1,), dev)
    if odone.data_ptr() == idone.data_ptr():
        raise ValueError("odone and idone must be distinct")
    rc = lib().mg_newton_gate(
        ss.data_ptr() if ss is not None else None, fn, thr_outer,
        res_out.data_ptr() if ss is not None else None, odone.data_ptr(),
        idone.data_ptr(), thr_in.data_ptr(), _stream(dev),
    )
    _check_rc(rc, "newton_gate")
    launches["newton_gate"] += 1


# ---------------------------------------------------------------------------
# down_leg / up_leg — the structure of
# gpusolve_tpu/ops/pallas_vcycle2.py::_vcycle2_call (:280): one streamed
# pass a leg, its sweeps fused (stream_pass :517, restrict_yz :484,
# prolong_yz :499).  The down leg runs S sweeps, the residual, its
# restriction into the coarse f and the coarse start (v = 0; FAS: R(v) into
# the coarse v and rest_v), and writes the smoothed v out of place into
# ``v_out``; the up leg runs v += P(coarse v) and S sweeps into ``v_out``,
# and with ``with_norm`` returns the residual's Σr² as per-block partials
# for :func:`finalize`.  Bound: bytes (LINEAR down reads v and f, writes v
# and ¼ of a field of coarse f and v: 3.25 fields; up reads v, f and ⅛ of
# coarse v, writes v: 3.125; FAS and NEWTON a little more).  Design
# (``csrc/mg_legs.cu``): a block of 32 warps on a 32 × 64 (y, z) tile walks
# x one plane a step, every stage one plane behind the one before it, the
# ±x taps in registers, the ±y taps through one shared plane buffer a
# stage, one barrier a step.  S (1..5) and the mode are template
# parameters; face-tap stencils only (``legs_take``).  Each plain version
# is the plain ops it fuses, in the per-op cycle's order.
# ---------------------------------------------------------------------------

LEG_MAX_SWEEPS = 5  # csrc/mg_legs.cu kLegMaxS: the v2 sweep cap


def legs_take(stencil: Stencil, sweeps: int) -> bool:
    """Whether a leg of ``sweeps`` sweeps runs fused for ``stencil``: 1 to
    5 sweeps, and face taps only (each offset along at most one axis); the
    kernel refuses edge and corner taps."""
    return 1 <= sweeps <= LEG_MAX_SWEEPS and all(
        sum(abs(o) for o in off) <= 1 for off in stencil.offsets
    )


def _check_leg(params: GridParams, sweeps: int) -> None:
    if not legs_take(params.stencil, sweeps):
        raise ValueError(
            f"the fused legs take 1..{LEG_MAX_SWEEPS} sweeps and face taps "
            f"only; got {sweeps} sweeps, offsets {params.stencil.offsets}"
        )


def down_leg_plain(
    v_out, v, f, f_coarse, v_coarse, dims, coarse_dims, params, h, sweeps,
    done=None, newton_v=None, rest_v=None,
) -> None:
    """Plain version of :func:`down_leg`: the per-op plain ops in the
    cycle's order (sweeps, residual, restrictions)."""
    nv = _newton_v_for(params, newton_v)
    _check_leg(params, sweeps)
    if _is_done(done):
        return
    cur = v
    for _ in range(sweeps):
        nxt = torch.zeros_like(v)
        jacobi_sweep_plain(nxt, cur, f, dims, params, h, None, nv)
        cur = nxt
    r = torch.zeros_like(v)
    residual_plain(r, cur, f, dims, params, h, newton_v=nv)
    if params.mode == Mode.NONLINEAR:
        restrict_plain(f_coarse, r, dims, coarse_dims)
        restrict_plain(v_coarse, cur, dims, coarse_dims, out2=rest_v)
    else:
        restrict_zero_plain(f_coarse, v_coarse, r, dims, coarse_dims)
    ref.interior(v_out, dims).copy_(ref.interior(cur, dims))


def down_leg(
    v_out: torch.Tensor,
    v: torch.Tensor,
    f: torch.Tensor,
    f_coarse: torch.Tensor,
    v_coarse: torch.Tensor,
    dims: Dims,
    coarse_dims: Dims,
    params: GridParams,
    h: float,
    sweeps: int,
    done: Optional[torch.Tensor] = None,
    newton_v: Optional[torch.Tensor] = None,
    rest_v: Optional[torch.Tensor] = None,
) -> None:
    """The down leg of a level visit: ``sweeps`` sweeps of ``v`` into the
    interior of ``v_out``, the residual's full weighting into ``f_coarse``
    and the coarse start in ``v_coarse`` (zero; NONLINEAR: the full
    weighting of the smoothed v, also into ``rest_v``)."""
    if v.device.type == "cpu":
        return down_leg_plain(
            v_out, v, f, f_coarse, v_coarse, dims, coarse_dims, params, h,
            sweeps, done, newton_v, rest_v,
        )
    nv = _newton_v_for(params, newton_v)
    _check_leg(params, sweeps)
    fas = params.mode == Mode.NONLINEAR
    if fas and rest_v is None:
        raise ValueError("NONLINEAR mode needs rest_v")
    dev = _cuda_device(v)
    shape, cshape = _padded(dims), _padded(coarse_dims)
    _check_halving(dims, coarse_dims)
    for name, t in (("v_out", v_out), ("v", v), ("f", f)):
        _check(t, name, shape, dev)
    outs = [("f_coarse", f_coarse), ("v_coarse", v_coarse)]
    if fas:
        outs.append(("rest_v", rest_v))
    for name, t in outs:
        _check(t, name, cshape, dev)
    ins = [v, f] + ([nv] if nv is not None else [])
    if nv is not None:
        _check(nv, "newton_v", shape, dev)
    written = [v_out] + [t for _, t in outs]
    for i, a in enumerate(written):
        for b in ins + written[i + 1:]:
            _refuse_overlap(a, b)
    done = _done_or_zero(done, dev)
    t = _taps(params.stencil)
    rc = lib().mg_down_leg(
        v_out.data_ptr(), v.data_ptr(), f.data_ptr(),
        nv.data_ptr() if nv is not None else None, f_coarse.data_ptr(),
        v_coarse.data_ptr(), rest_v.data_ptr() if fas else None,
        done.data_ptr(), *dims, t.val, t.off, t.n, 1.0 / (h * h),
        (h * h) / params.stencil.diag, params.omega, params.gamma,
        params.stencil.diag / (h * h), int(params.mode), int(sweeps),
        _stream(dev),
    )
    name = variant("down_leg", params.mode)
    _check_rc(rc, name)
    launches[name] += 1


def up_leg_plain(
    v_out, v, v_coarse, f, dims, coarse_dims, params, h, sweeps, done=None,
    newton_v=None, with_norm=False,
) -> Optional[torch.Tensor]:
    """Plain version of :func:`up_leg`: prolong_add, the sweeps and the
    norm-only residual, plain; the partials are one float64 Σr²."""
    nv = _newton_v_for(params, newton_v)
    _check_leg(params, sweeps)
    if _is_done(done):
        return v.new_zeros(1, dtype=torch.float64) if with_norm else None
    cur = v.clone()
    prolong_add_plain(cur, v_coarse, dims, coarse_dims)
    for _ in range(sweeps):
        nxt = torch.zeros_like(v)
        jacobi_sweep_plain(nxt, cur, f, dims, params, h, None, nv)
        cur = nxt
    ref.interior(v_out, dims).copy_(ref.interior(cur, dims))
    if not with_norm:
        return None
    return residual_plain(None, cur, f, dims, params, h, write_r=False,
                          with_norm=True, newton_v=nv)


def up_leg(
    v_out: torch.Tensor,
    v: torch.Tensor,
    v_coarse: torch.Tensor,
    f: torch.Tensor,
    dims: Dims,
    coarse_dims: Dims,
    params: GridParams,
    h: float,
    sweeps: int,
    done: Optional[torch.Tensor] = None,
    newton_v: Optional[torch.Tensor] = None,
    with_norm: bool = False,
) -> Optional[torch.Tensor]:
    """The up leg of a level visit: ``v + P(v_coarse)`` and ``sweeps``
    sweeps into the interior of ``v_out``.  With ``with_norm`` returns the
    float64 partial sums of the residual's r² that :func:`finalize`
    reduces; else None."""
    if v.device.type == "cpu":
        return up_leg_plain(
            v_out, v, v_coarse, f, dims, coarse_dims, params, h, sweeps,
            done, newton_v, with_norm,
        )
    nv = _newton_v_for(params, newton_v)
    _check_leg(params, sweeps)
    dev = _cuda_device(v)
    shape = _padded(dims)
    _check_halving(dims, coarse_dims)
    for name, t in (("v_out", v_out), ("v", v), ("f", f)):
        _check(t, name, shape, dev)
    _check(v_coarse, "v_coarse", _padded(coarse_dims), dev)
    if nv is not None:
        _check(nv, "newton_v", shape, dev)
    for t in [v, f, v_coarse] + ([nv] if nv is not None else []):
        _refuse_overlap(v_out, t)
    done = _done_or_zero(done, dev)
    L = lib()
    partials = None
    if with_norm:
        partials = torch.empty(
            L.mg_up_leg_blocks(*dims, int(sweeps)), dtype=torch.float64,
            device=dev,
        )
    t = _taps(params.stencil)
    rc = L.mg_up_leg(
        v_out.data_ptr(), v.data_ptr(), v_coarse.data_ptr(), f.data_ptr(),
        nv.data_ptr() if nv is not None else None,
        partials.data_ptr() if with_norm else None, done.data_ptr(), *dims,
        t.val, t.off, t.n, 1.0 / (h * h), (h * h) / params.stencil.diag,
        params.omega, params.gamma, params.stencil.diag / (h * h),
        int(params.mode), int(sweeps), _stream(dev),
    )
    name = variant("up_leg", params.mode)
    _check_rc(rc, name)
    launches[name] += 1
    return partials
