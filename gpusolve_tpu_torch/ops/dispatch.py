"""Per-op choice between the CUDA kernels and their plain versions.

The counterpart of ``gpusolve_tpu/ops/dispatch.py``.  ``GridParams.backend``
and the tensors' device and dtype decide:
  * a CPU tensor runs the plain PyTorch version (as the kernel wrapper
    itself would); ``backend="cuda"`` on a CPU tensor raises;
  * a float32 CUDA tensor launches the CUDA kernel, or runs the plain
    version when ``backend="ref"`` was asked for;
  * a float64 CUDA tensor runs the plain version on the card under
    ``backend="auto"`` (the card has native float64; the kernels are
    float32), as the JAX package sends float64 to its XLA ops
    (gpusolve_tpu/solver/vcycle.py:184-187); ``backend="cuda"`` raises.
The choice reads the dtype; no failure of a kernel falls back to the plain
version.

The ops keep the kernels' buffer protocol (``ops/kernels.py``): outputs are
written in place into buffers the caller passes, interiors only, and every
op takes the batch's ``done`` flag.  ``smooth`` ping-pongs v with the
level's spare buffer and returns the pair in their new roles.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from gpusolve_tpu_torch.config import GridParams
from gpusolve_tpu_torch.ops import kernels

Dims = Tuple[int, int, int]


def plain_reason(params: GridParams, device, dtype) -> Optional[str]:
    """Why tensors of ``dtype`` (a ``torch.dtype`` or its name) on
    ``device`` run the plain ops, or None when they launch the CUDA
    kernels.  The one policy that both the per-op choice here and the
    solver's engine choice read.  ``backend="cuda"`` raises where it cannot
    launch the kernels."""
    device = torch.device(device)
    if params.backend == "cpu-native":
        raise ValueError(
            "backend='cpu-native' is the C++ host solver "
            "(cpu_native.solve_native), not a device backend"
        )
    if params.backend == "ref":
        return "--backend ref"
    if params.backend == "cuda" and device.type != "cuda":
        raise ValueError(
            f"backend='cuda' needs CUDA tensors, got a tensor on {device}"
        )
    if str(dtype).removeprefix("torch.") == "float64":
        if params.backend == "cuda":
            raise TypeError(
                "backend='cuda' runs the float32 CUDA kernels; float64 runs "
                "the plain ops (backend='auto' or 'ref')"
            )
        return "float64"
    if device.type != "cuda":
        return f"on {device.type}"
    return None


def _pick(params: GridParams, t: torch.Tensor, kernel, plain):
    """The kernel wrapper, or its plain version where ``plain_reason``
    gives a reason."""
    if plain_reason(params, t.device, t.dtype) is None:
        return kernel
    return plain


def smooth(
    v: torch.Tensor,
    f: torch.Tensor,
    spare: torch.Tensor,
    dims: Dims,
    params: GridParams,
    h: float,
    n_iter: int,
    done: Optional[torch.Tensor] = None,
    newton_v: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n_iter`` damped-Jacobi sweeps (NEWTON with the frozen
    ``newton_v``).  Returns ``(v_new, spare_new)``: each sweep writes into
    the spare buffer, and the two trade roles."""
    sweep = _pick(
        params, v, kernels.jacobi_sweep, kernels.jacobi_sweep_plain
    )
    a, b = v, spare
    for _ in range(n_iter):
        sweep(b, a, f, dims, params, h, done, newton_v)
        a, b = b, a
    return a, b


def residual_op(
    r: Optional[torch.Tensor],
    v: torch.Tensor,
    f: torch.Tensor,
    dims: Dims,
    params: GridParams,
    h: float,
    *,
    write_r: bool = True,
    norm_out: Optional[torch.Tensor] = None,
    thr=-1.0,
    done: Optional[torch.Tensor] = None,
    newton_v: Optional[torch.Tensor] = None,
) -> None:
    """The mode's residual into ``r`` (when ``write_r``); with ``norm_out``
    (a one-element tensor) also Σr² into it, setting ``done`` when
    ``thr >= 0`` and ``Σr² <= thr``.  ``thr`` is a float, or a one-element
    float32 tensor on the device (read there: ``finalize_dev_thr``)."""
    with_norm = norm_out is not None
    residual = _pick(params, v, kernels.residual, kernels.residual_plain)
    partials = residual(
        r, v, f, dims, params, h, write_r=write_r, with_norm=with_norm,
        done=done, newton_v=newton_v,
    )
    if with_norm:
        _finalize(params, v, partials, norm_out, thr, done)


def _finalize(params, v, partials, norm_out, thr, done) -> None:
    """Σ ``partials`` into ``norm_out``; ``done`` set when the threshold
    (a float, or a one-element float32 tensor on the device, read there
    by ``finalize_dev_thr``) is met."""
    if isinstance(thr, torch.Tensor):
        finalize = _pick(params, v, kernels.finalize_dev_thr,
                         kernels.finalize_dev_thr_plain)
    else:
        finalize = _pick(params, v, kernels.finalize, kernels.finalize_plain)
    finalize(partials, norm_out, thr, done)


def restrict_zero_op(
    f_coarse: torch.Tensor,
    v_coarse: torch.Tensor,
    r_fine: torch.Tensor,
    fine_dims: Dims,
    coarse_dims: Dims,
    params: GridParams,
    done: Optional[torch.Tensor] = None,
) -> None:
    """Full-weighting restriction of ``r_fine`` into ``f_coarse``, and the
    zero start of ``v_coarse`` (LINEAR and NEWTON)."""
    op = _pick(
        params, r_fine, kernels.restrict_zero, kernels.restrict_zero_plain
    )
    op(f_coarse, v_coarse, r_fine, fine_dims, coarse_dims, done)


def restrict_op(
    out: torch.Tensor,
    fine: torch.Tensor,
    fine_dims: Dims,
    coarse_dims: Dims,
    params: GridParams,
    done: Optional[torch.Tensor] = None,
    out2: Optional[torch.Tensor] = None,
) -> None:
    """Full-weighting restriction of ``fine`` into ``out`` (and ``out2``),
    with no zero fill: FAS's R(r) and R(v), Newton's R(ũ)."""
    op = _pick(params, fine, kernels.restrict, kernels.restrict_plain)
    op(out, fine, fine_dims, coarse_dims, done, out2)


def prolong_add_op(
    v_fine: torch.Tensor,
    v_coarse: torch.Tensor,
    coarse_dims: Dims,
    fine_dims: Dims,
    params: GridParams,
    done: Optional[torch.Tensor] = None,
) -> None:
    """``v_fine += P(v_coarse)`` in place."""
    op = _pick(
        params, v_fine, kernels.prolong_add, kernels.prolong_add_plain
    )
    op(v_fine, v_coarse, fine_dims, coarse_dims, done)


def apply_fas_op(
    out: torch.Tensor,
    v: torch.Tensor,
    dims: Dims,
    params: GridParams,
    h: float,
    done: Optional[torch.Tensor] = None,
) -> None:
    """``out += A(v)/h² + γ·v·eᵛ``, the FAS operator (the tau fold onto the
    coarse f)."""
    op = _pick(params, v, kernels.apply_fas, kernels.apply_fas_plain)
    op(out, v, dims, params, h, done)


def subtract_op(
    v: torch.Tensor,
    w: torch.Tensor,
    dims: Dims,
    params: GridParams,
    done: Optional[torch.Tensor] = None,
) -> None:
    """``v −= w`` in place (FAS: coarse v − rest_v)."""
    op = _pick(params, v, kernels.subtract, kernels.subtract_plain)
    op(v, w, dims, done)


def down_leg_op(
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
    """The fused down leg: ``sweeps`` sweeps into ``v_out``, the
    residual's restriction into ``f_coarse`` and the coarse start
    (``v_coarse`` = 0; FAS: R(v) into ``v_coarse`` and ``rest_v``)."""
    op = _pick(params, v, kernels.down_leg, kernels.down_leg_plain)
    op(v_out, v, f, f_coarse, v_coarse, dims, coarse_dims, params, h,
       sweeps, done, newton_v, rest_v)


def up_leg_op(
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
    norm_out: Optional[torch.Tensor] = None,
    thr=-1.0,
) -> None:
    """The fused up leg: ``v + P(v_coarse)`` and ``sweeps`` sweeps into
    ``v_out``; with ``norm_out`` also Σr² of the result into it, setting
    ``done`` as :func:`residual_op` does."""
    op = _pick(params, v, kernels.up_leg, kernels.up_leg_plain)
    partials = op(
        v_out, v, v_coarse, f, dims, coarse_dims, params, h, sweeps, done,
        newton_v, norm_out is not None,
    )
    if norm_out is not None:
        _finalize(params, v, partials, norm_out, thr, done)
