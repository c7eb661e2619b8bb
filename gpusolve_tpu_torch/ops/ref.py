"""Plain PyTorch versions of the multigrid ops, in all three modes.

The counterpart of ``gpusolve_tpu/ops/xla.py`` and the oracle every CUDA
kernel of the port is held against.  Every function is functional (it
returns new tensors and changes none of its inputs) and runs on any device.

Array model: a field with interior dims ``(nx, ny, nz)`` is a tensor of
shape ``(nx+2, ny+2, nz+2)`` with a zero halo; every op keeps that
invariant.  Interior dims are passed explicitly (``dims``).

Each function keeps the tap order and the factor order of its JAX
counterpart (``acc * inv_h2``, ``v + ω·(α·r)``, ``0.125·wx·wy·wz``), so
float32 results agree to rounding with the JAX package, and bit for bit
with the port's CUDA kernels, which round the same operations in the same
order (``ops/csrc/multigrid.cu``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from gpusolve_tpu_torch.config import GridParams, Mode, Stencil

Dims = Tuple[int, int, int]
Shape = Tuple[int, int, int]


def interior(a: torch.Tensor, dims: Dims) -> torch.Tensor:
    nx, ny, nz = dims
    return a[1 : 1 + nx, 1 : 1 + ny, 1 : 1 + nz]


def _padded(int_val: torch.Tensor, dims: Dims, shape: Shape) -> torch.Tensor:
    """Embed an interior-shaped result into a zeroed padded tensor."""
    out = torch.zeros(shape, dtype=int_val.dtype, device=int_val.device)
    interior(out, dims).copy_(int_val)
    return out


def stencil_apply(
    v: torch.Tensor, dims: Dims, stencil: Stencil, inv_h2: float
) -> torch.Tensor:
    """Σᵢ sᵢ·v[x+oxᵢ, y+oyᵢ, z+ozᵢ] / h² over the interior (unpadded)."""
    nx, ny, nz = dims
    acc = None
    for val, (ox, oy, oz) in zip(stencil.values, stencil.offsets):
        tap = v[
            1 + ox : 1 + ox + nx, 1 + oy : 1 + oy + ny, 1 + oz : 1 + oz + nz
        ]
        term = val * tap
        acc = term if acc is None else acc + term
    return acc * inv_h2


def _mode_residual_term(
    params: GridParams, v_int: torch.Tensor, newton_v_int
) -> Optional[torch.Tensor]:
    """The nonlinear term added to A·v/h²: NEWTON γ·(1+ṽ)·v·e^ṽ with
    frozen ṽ, NONLINEAR γ·v·e^v, LINEAR none."""
    if params.mode == Mode.NEWTON:
        ex = torch.exp(newton_v_int)
        return params.gamma * (1.0 + newton_v_int) * v_int * ex
    if params.mode == Mode.NONLINEAR:
        return params.gamma * v_int * torch.exp(v_int)
    return None


def residual_point(
    params: GridParams,
    av: torch.Tensor,
    v_int: torch.Tensor,
    f_int: torch.Tensor,
    newton_v_int: Optional[torch.Tensor],
) -> torch.Tensor:
    """``f − (A·v/h² + mode term)`` from ``av = A·v/h²`` and the points'
    v, f and (NEWTON) ũ."""
    if params.mode != Mode.LINEAR:
        av = av + _mode_residual_term(params, v_int, newton_v_int)
    return f_int - av


def residual(
    v: torch.Tensor,
    f: torch.Tensor,
    dims: Dims,
    params: GridParams,
    h: float,
    newton_v: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(r, Σr²)``: the residual ``f − (A·v/h² + mode term)``, zero outside
    the interior, and its squared L2 norm as a 0-d tensor."""
    inv_h2 = 1.0 / (h * h)
    av = stencil_apply(v, dims, params.stencil, inv_h2)
    r_int = residual_point(
        params, av, interior(v, dims), interior(f, dims),
        interior(newton_v, dims) if newton_v is not None else None,
    )
    return _padded(r_int, dims, v.shape), torch.sum(r_int * r_int)


def sweep_point(
    params: GridParams,
    h: float,
    av: torch.Tensor,
    v_int: torch.Tensor,
    f_int: torch.Tensor,
    newton_v_int: Optional[torch.Tensor],
) -> torch.Tensor:
    """One damped-Jacobi update of the points from ``av = A·v/h²``:
      linear:    v + ω · (h²/s₀) · r
      nonlinear: v + ω · r / (s₀/h² + γ(1+v)e^v)
      Newton:    v + ω · r / (s₀/h² + γ(1+ṽ)e^ṽ), ṽ frozen
    """
    if params.mode == Mode.LINEAR:
        alpha = (h * h) / params.stencil.diag
        return v_int + params.omega * (alpha * (f_int - av))
    pre_fac = params.stencil.diag / (h * h)
    if params.mode == Mode.NONLINEAR:
        ex = torch.exp(v_int)
        r_int = f_int - (av + params.gamma * v_int * ex)
        denom = pre_fac + params.gamma * (1.0 + v_int) * ex
        return v_int + params.omega * (r_int / denom)
    ex = torch.exp(newton_v_int)
    lin = params.gamma * (1.0 + newton_v_int) * ex
    r_int = f_int - (av + lin * v_int)
    return v_int + params.omega * (r_int / (pre_fac + lin))


def jacobi(
    v: torch.Tensor,
    f: torch.Tensor,
    dims: Dims,
    params: GridParams,
    h: float,
    n_iter: int,
    newton_v: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``n_iter`` damped-Jacobi sweeps (``sweep_point``); returns the
    updated v.  Each sweep computes the residual with the current v
    everywhere (simultaneous update)."""
    inv_h2 = 1.0 / (h * h)
    nv_int = interior(newton_v, dims) if newton_v is not None else None
    f_int = interior(f, dims)
    for _ in range(n_iter):
        av = stencil_apply(v, dims, params.stencil, inv_h2)
        new_v = sweep_point(params, h, av, interior(v, dims), f_int, nv_int)
        v = _padded(new_v, dims, v.shape)
    return v


def apply_stencil_fas(
    v: torch.Tensor, dims: Dims, params: GridParams, h: float
) -> torch.Tensor:
    """FAS coarse-operator application A(v)/h² + γ·v·e^v over the interior,
    zero outside."""
    inv_h2 = 1.0 / (h * h)
    v_int = interior(v, dims)
    av = stencil_apply(v, dims, params.stencil, inv_h2)
    result = av + params.gamma * v_int * torch.exp(v_int)
    return _padded(result, dims, v.shape)


_RESTRICT_W1D = (0.5, 1.0, 0.5)  # per-axis factors (2-|o|)/2, o in {-1,0,1}


def restrict_full_weighting(
    fine: torch.Tensor,
    fine_dims: Dims,
    coarse_dims: Dims,
    coarse_shape: Shape,
) -> torch.Tensor:
    """27-point full weighting: coarse[x] ← Σ w·fine[2x+o] with weights
    0.125·∏((2-|oᵢ|)/2), which sum to 1; zero outside the coarse interior."""
    del fine_dims  # bounds depend only on the coarse dims

    def taps(n_int: int, off: int) -> slice:
        # fine indices 2x+off for coarse interior x in [1, n_int]
        return slice(2 + off, 2 + off + 2 * n_int - 1, 2)

    cnx, cny, cnz = coarse_dims
    acc = None
    for ii, wx in zip((-1, 0, 1), _RESTRICT_W1D):
        for jj, wy in zip((-1, 0, 1), _RESTRICT_W1D):
            for kk, wz in zip((-1, 0, 1), _RESTRICT_W1D):
                w = 0.125 * wx * wy * wz
                tap = fine[taps(cnx, ii), taps(cny, jj), taps(cnz, kk)]
                term = w * tap
                acc = term if acc is None else acc + term
    return _padded(acc, coarse_dims, coarse_shape)


def interpolate(
    coarse: torch.Tensor,
    coarse_dims: Dims,
    fine_dims: Dims,
    fine_shape: Shape,
) -> torch.Tensor:
    """Trilinear prolongation of coarse v onto a fine correction field.

    The reference's 4 passes: inject coarse values at even fine sites, then
    midpoint-average along x, then y, then z.  Sites no pass writes stay
    zero (they derive from the zero halo)."""
    del coarse_dims
    fX, fY, fZ = (d + 2 for d in fine_dims)
    E = torch.zeros((fX, fY, fZ), dtype=coarse.dtype, device=coarse.device)
    # Inject: fine[2i,2j,2k] = coarse[i,j,k] for even sites < dim-1.
    nx, ny, nz = fX // 2, fY // 2, fZ // 2
    E[0 : fX - 1 : 2, 0 : fY - 1 : 2, 0 : fZ - 1 : 2] = coarse[:nx, :ny, :nz]
    # x-direction midpoints at (odd, even, even).
    E[1 : fX - 1 : 2, 0:fY:2, 0:fZ:2] = (
        0.5 * E[0 : fX - 2 : 2, 0:fY:2, 0:fZ:2]
        + 0.5 * E[2:fX:2, 0:fY:2, 0:fZ:2]
    )
    # y-direction midpoints at (any, odd, even).
    E[:, 1 : fY - 1 : 2, 0:fZ:2] = (
        0.5 * E[:, 0 : fY - 2 : 2, 0:fZ:2] + 0.5 * E[:, 2:fY:2, 0:fZ:2]
    )
    # z-direction midpoints at (any, any, odd).
    E[:, :, 1 : fZ - 1 : 2] = (
        0.5 * E[:, :, 0 : fZ - 2 : 2] + 0.5 * E[:, :, 2:fZ:2]
    )
    if tuple(fine_shape) != (fX, fY, fZ):
        raise ValueError(
            f"fine shape {tuple(fine_shape)} is not the padded extent "
            f"{(fX, fY, fZ)}"
        )
    return E


def prolong_add(
    v_fine: torch.Tensor,
    coarse: torch.Tensor,
    coarse_dims: Dims,
    fine_dims: Dims,
) -> torch.Tensor:
    """``v_fine + P(coarse)``: the coarse-grid correction, trilinear."""
    return v_fine + interpolate(coarse, coarse_dims, fine_dims, v_fine.shape)
