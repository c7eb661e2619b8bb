"""The distributed engine's shard-local CUDA kernels (``csrc/spmd_block.cu``):
wrappers, and the plain PyTorch version beside each.

They replace the per-op kernels of the JAX package's explicit-halo spmd
engine, ``gpusolve_tpu/ops/pallas_spmd.py``: ``_sweep_call`` (:284),
``_residual_call`` (:370), ``_res_restrict_call`` (:628) and
``_prolong_add_call`` (:850).  ``dist/spmd.py`` calls them on each shard's
block of a distributed level.

A block is a dense ``(bx, by, bz)`` tensor with no stored halo; the
neighbours' face planes come in ``faces = (gxlo, gxhi, gylo, gyhi)``, x
faces ``(by, bz)`` and y faces ``(bx, bz)``, zeros where a face has no
neighbour (the Dirichlet boundary).  z is never split: a z tap outside the
block reads 0.  ``box = (x0, x1, y0, y1, z0, z1)`` holds the inclusive
local bounds of the block's globally interior cells; every op writes
those cells only (the transfers: the coarse cells they feed), so a buffer
that starts zeroed stays zero outside them.  Only stencils whose taps lie
on the faces are taken (``dist/spmd.py`` refuses the others).

Each wrapper keeps the ``ops/kernels.py`` contract: outputs are passed in;
a CPU tensor runs the plain version; a CUDA tensor is checked (device,
dtype, shape, contiguity) and launched on the current stream, any launch
error raises, and ``kernels.launches[name]`` counts the launch (one name
per mode: ``sweep_block``, ``sweep_block_fas``, ``sweep_block_newton``,
and so for the residuals).  There is no device ``done`` flag: the
distributed solve runs whole batches, as the JAX package's ``lax.scan``
does.  Each plain version rounds every value as its kernel does.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from gpusolve_tpu_torch.config import GridParams, Mode
from gpusolve_tpu_torch.ops import kernels, ref

Box = Tuple[int, int, int, int, int, int]
Faces = Sequence[torch.Tensor]


def box_slices(box: Box) -> Tuple[slice, slice, slice]:
    x0, x1, y0, y1, z0, z1 = box
    return slice(x0, x1 + 1), slice(y0, y1 + 1), slice(z0, z1 + 1)


def box_dims(box: Box) -> Tuple[int, int, int]:
    x0, x1, y0, y1, z0, z1 = box
    return x1 - x0 + 1, y1 - y0 + 1, z1 - z0 + 1


def box_empty(box: Box) -> bool:
    return any(n <= 0 for n in box_dims(box))


def restrict_planes(box: Box, cbx: int) -> Tuple[int, int]:
    """The coarse x-planes ``m0..m1`` whose fine planes ``2m−1..2m+1``
    meet the box (empty when ``m0 > m1``)."""
    return max(0, box[0] // 2), min(cbx - 1, (box[1] + 1) // 2)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _extended(v: torch.Tensor, faces: Faces) -> torch.Tensor:
    """v with its ghost faces around it, ``(bx+2, by+2, bz+2)``: the x and
    y faces on their planes, zero z ends and edges."""
    gxlo, gxhi, gylo, gyhi = faces
    bx, by, bz = v.shape
    ve = v.new_zeros((bx + 2, by + 2, bz + 2))
    ve[1:-1, 1:-1, 1:-1] = v
    ve[0, 1:-1, 1:-1] = gxlo
    ve[-1, 1:-1, 1:-1] = gxhi
    ve[1:-1, 0, 1:-1] = gylo
    ve[1:-1, -1, 1:-1] = gyhi
    return ve


def block_stencil(
    v: torch.Tensor, faces: Faces, box: Box, params: GridParams, h: float
) -> torch.Tensor:
    """``A·v/h²`` on the box's cells, the taps that leave the block read
    from the faces (the engine's ``_stencil_overlap``)."""
    x0, x1, y0, y1, z0, z1 = box
    sub = _extended(v, faces)[x0 : x1 + 3, y0 : y1 + 3, z0 : z1 + 3]
    return ref.stencil_apply(
        sub, box_dims(box), params.stencil, 1.0 / (h * h)
    )


def _nv_box(params: GridParams, newton_v, sl):
    nv = kernels._newton_v_for(params, newton_v)
    return None if nv is None else nv[sl]


def sweep_block_plain(v_out, v, f, faces, box, params, h, newton_v=None):
    """Plain version of :func:`sweep_block`."""
    if box_empty(box):
        return
    sl = box_slices(box)
    av = block_stencil(v, faces, box, params, h)
    v_out[sl] = ref.sweep_point(
        params, h, av, v[sl], f[sl], _nv_box(params, newton_v, sl)
    )


def residual_block_plain(
    r_out, v, f, faces, box, params, h, *, write_r=True, with_norm=False,
    newton_v=None,
) -> Optional[torch.Tensor]:
    """Plain version of :func:`residual_block`: the partials are one
    float64 Σr²."""
    sl = box_slices(box)
    nv_box = _nv_box(params, newton_v, sl)
    if box_empty(box):
        return v.new_zeros(1, dtype=torch.float64) if with_norm else None
    av = block_stencil(v, faces, box, params, h)
    r = ref.residual_point(params, av, v[sl], f[sl], nv_box)
    if write_r:
        r_out[sl] = r
    if not with_norm:
        return None
    r64 = r.to(torch.float64)
    return torch.sum(r64 * r64).reshape(1)


def _weigh3(a, b, c):
    return 0.25 * a + 0.5 * b + 0.25 * c


def _restrict_xz(planes: torch.Tensor, m0: int, m1: int, cnz: int):
    """Full weighting along x then z: ``planes[q]`` is fine plane q−1;
    coarse plane m reads fine 2m−1..2m+1, coarse z k fine 2k−1..2k+1."""
    sx = _weigh3(
        planes[2 * m0 : 2 * m1 + 1 : 2],
        planes[2 * m0 + 1 : 2 * m1 + 2 : 2],
        planes[2 * m0 + 2 : 2 * m1 + 3 : 2],
    )
    return _restrict_z(sx, cnz)


def _restrict_z(a: torch.Tensor, cnz: int) -> torch.Tensor:
    return _weigh3(
        a[..., 1 : 2 * cnz : 2],
        a[..., 2 : 2 * cnz + 1 : 2],
        a[..., 3 : 2 * cnz + 2 : 2],
    )


def residual_restrict_block_plain(
    xzr, rlast, xzv, v, f, faces, box, params, h, cnz, newton_v=None
) -> None:
    """Plain version of :func:`residual_restrict_block`."""
    nv_box = _nv_box(params, newton_v, box_slices(box))
    m0, m1 = restrict_planes(box, xzr.shape[0])
    if box_empty(box) or m0 > m1:
        return
    bx = v.shape[0]
    sl = box_slices(box)
    ys = sl[1]
    # planes[q] = r of fine plane q−1; plane −1 is 0 (the caller's fix-up).
    planes = v.new_zeros((bx + 1,) + tuple(v.shape[1:]))
    av = block_stencil(v, faces, box, params, h)
    planes[1:][sl] = ref.residual_point(params, av, v[sl], f[sl], nv_box)
    xzr[m0 : m1 + 1, ys, 1 : cnz + 1] = _restrict_xz(planes, m0, m1, cnz)[
        :, ys
    ]
    if m1 == xzr.shape[0] - 1:
        rlast[ys, 1 : cnz + 1] = _restrict_z(planes[bx], cnz)[ys]
    if params.mode == Mode.NONLINEAR:
        vplanes = torch.cat([faces[0][None], v])  # plane −1: the x ghost
        xzv[m0 : m1 + 1, ys, 1 : cnz + 1] = _restrict_xz(
            vplanes, m0, m1, cnz
        )[:, ys]


def _mid(t: torch.Tensor, dim: int, lo: torch.Tensor, hi: torch.Tensor):
    return 0.5 * t.index_select(dim, lo) + 0.5 * t.index_select(dim, hi)


def prolong_add_block_plain(v, casm, box) -> None:
    """Plain version of :func:`prolong_add_block`."""
    if box_empty(box):
        return
    x0, x1, y0, y1, z0, z1 = box
    dev = v.device

    def idx(a, b, shift):
        p = torch.arange(a, b + 1, device=dev)
        return (p + shift) // 2, (p + shift + 1) // 2

    e = _mid(casm, 0, *idx(x0, x1, 2))
    e = _mid(e, 1, *idx(y0, y1, 2))
    e = _mid(e, 2, *idx(z0, z1, 0))
    v[box_slices(box)] += e


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check_faces(faces: Faces, shape, dev, dtype) -> None:
    bx, by, bz = shape
    if len(faces) != 4:
        raise ValueError(f"expected 4 ghost faces, got {len(faces)}")
    for name, t, s in zip(("gxlo", "gxhi", "gylo", "gyhi"), faces,
                          ((by, bz), (by, bz), (bx, bz), (bx, bz))):
        kernels._check(t, name, s, dev, dtype)


def _check_box(box: Box, shape) -> None:
    x0, x1, y0, y1, z0, z1 = box
    for lo, hi, n, ax in ((x0, x1, shape[0], "x"), (y0, y1, shape[1], "y"),
                          (z0, z1, shape[2], "z")):
        if lo < 0 or hi >= n:
            raise ValueError(
                f"box {box} leaves the block {tuple(shape)} along {ax}"
            )


def _check_block(v, f, faces, box, newton_v, params):
    """Device, dtype, shapes and contiguity of a block op's inputs;
    returns (device, ũ or None)."""
    dev = kernels._cuda_device(v)
    shape = tuple(v.shape)
    kernels._check(v, "v", shape, dev)
    kernels._check(f, "f", shape, dev)
    nv = kernels._newton_v_for(params, newton_v)
    if nv is not None:
        kernels._check(nv, "newton_v", shape, dev)
    _check_faces(faces, shape, dev, torch.float32)
    _check_box(box, shape)
    return dev, nv


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _geometry(v, box):
    return (*v.shape, *box)


# ---------------------------------------------------------------------------
# sweep_block — replaces gpusolve_tpu/ops/pallas_spmd.py::_sweep_call
# (:284), in all three modes.  Bound: bytes (reads v and f, NEWTON also ũ,
# writes v_out over the box: 12 or 16 B per point, plus the faces).
# Design: jacobi_sweep's tile over the interior box; taps that leave the
# block read the ghost faces, z ends read 0.  Out of place into the level's
# spare buffer (the engine's ping-pong).
# ---------------------------------------------------------------------------


def sweep_block(
    v_out: torch.Tensor,
    v: torch.Tensor,
    f: torch.Tensor,
    faces: Faces,
    box: Box,
    params: GridParams,
    h: float,
    newton_v: Optional[torch.Tensor] = None,
) -> None:
    """One damped-Jacobi sweep of a block over ``box`` into ``v_out``, in
    ``jacobi_sweep``'s arithmetic."""
    if v.device.type == "cpu":
        return sweep_block_plain(
            v_out, v, f, faces, box, params, h, newton_v
        )
    dev, nv = _check_block(v, f, faces, box, newton_v, params)
    kernels._check(v_out, "v_out", v.shape, dev)
    if v_out.data_ptr() in (v.data_ptr(), f.data_ptr(), _ptr(nv)):
        raise ValueError("v_out must not alias v, f or newton_v")
    if box_empty(box):
        return
    t = kernels._taps(params.stencil)
    rc = kernels.lib().mg_sweep_block(
        v_out.data_ptr(), v.data_ptr(), f.data_ptr(), _ptr(nv),
        *(g.data_ptr() for g in faces), *_geometry(v, box),
        t.val, t.off, t.n, 1.0 / (h * h), (h * h) / params.stencil.diag,
        params.omega, params.gamma, params.stencil.diag / (h * h),
        int(params.mode), kernels._stream(dev),
    )
    name = kernels.variant("sweep_block", params.mode)
    kernels._check_rc(rc, name)
    kernels.launches[name] += 1


# ---------------------------------------------------------------------------
# residual_block — replaces gpusolve_tpu/ops/pallas_spmd.py::_residual_call
# (:370), in all three modes, with its norm-only variant (write_r=False).
# Bound: bytes (reads v and f, NEWTON also ũ, writes r: 12 or 16 B per
# point, 8 or 12 norm-only).  Design: residual's tile over the box with
# the ghost-aware taps; Σr² per block in float64 (block_sum's fixed order)
# for finalize, in place of the TPU kernel's sequential Kahan chain.  It is
# also Newton's comp_f in FAS mode.
# ---------------------------------------------------------------------------


def residual_block(
    r_out: Optional[torch.Tensor],
    v: torch.Tensor,
    f: torch.Tensor,
    faces: Faces,
    box: Box,
    params: GridParams,
    h: float,
    *,
    write_r: bool = True,
    with_norm: bool = False,
    newton_v: Optional[torch.Tensor] = None,
) -> Optional[torch.Tensor]:
    """``r = f − (A·v/h² + mode term)`` of a block over ``box``, into
    ``r_out`` when ``write_r``; with ``with_norm`` returns the float64
    partial sums of r² that ``kernels.finalize`` reduces, else None."""
    if v.device.type == "cpu":
        return residual_block_plain(
            r_out, v, f, faces, box, params, h, write_r=write_r,
            with_norm=with_norm, newton_v=newton_v,
        )
    dev, nv = _check_block(v, f, faces, box, newton_v, params)
    if write_r:
        kernels._check(r_out, "r_out", v.shape, dev)
        if r_out.data_ptr() in (v.data_ptr(), f.data_ptr(), _ptr(nv)):
            raise ValueError("r_out must not alias v, f or newton_v")
    if box_empty(box):
        return v.new_zeros(1, dtype=torch.float64) if with_norm else None
    L = kernels.lib()
    partials = None
    if with_norm:
        partials = torch.empty(
            L.mg_box_blocks(*box_dims(box)), dtype=torch.float64, device=dev
        )
    t = kernels._taps(params.stencil)
    rc = L.mg_residual_block(
        r_out.data_ptr() if write_r else None, _ptr(partials),
        v.data_ptr(), f.data_ptr(), _ptr(nv),
        *(g.data_ptr() for g in faces), *_geometry(v, box),
        t.val, t.off, t.n, 1.0 / (h * h), params.gamma, int(params.mode),
        int(write_r), kernels._stream(dev),
    )
    name = kernels.variant("residual_block", params.mode)
    kernels._check_rc(rc, name)
    kernels.launches[name] += 1
    return partials


# ---------------------------------------------------------------------------
# residual_restrict_block — replaces
# gpusolve_tpu/ops/pallas_spmd.py::_res_restrict_call (:628), in all three
# modes.  Bound: bytes (reads v with its halo and f, NEWTON also ũ; writes
# the ¼-size x/z-restricted residual, FAS also of v: ~9 B per fine point,
# 13 with ũ, 10 in FAS).  Design: a block of 8 fine rows and 31 coarse z
# columns streams v, f (and ũ) plane by plane along x through a
# shared-memory ring (cp.async, two planes ahead), so v is read once from
# device memory; each lane takes two consecutive fine z, each fine
# residual is computed once, weighed along x in registers and along z in
# the lane and its neighbour; FAS restricts v from the same ring.  r never
# reaches device memory; the y restriction stays glue (dist/spmd.py), as
# in the TPU engine.  A block walks ``restrict_chunk`` coarse planes.
# ---------------------------------------------------------------------------

# A block's fine rows and coarse z columns (kRRRows, kRRCz in
# csrc/spmd_block.cu).
RR_ROWS = 8
RR_CZ = 31
# The longest x walk: its first odd plane, which the chunk before computed
# too, is then 1/64 of its residuals.
RR_MAX_CHUNK = 32
_resident = {}


def restrict_chunk(box: Box, m0: int, m1: int, cnz: int,
                   resident: int) -> int:
    """Coarse x-planes a block of residual_restrict_block walks: the
    longest (at most RR_MAX_CHUNK, at least 2) that still gives the grid
    four blocks for each of the ``resident`` the card holds at once."""
    tiles = -(-cnz // RR_CZ) * -(-box_dims(box)[1] // RR_ROWS)
    planes = m1 - m0 + 1
    return max(2, min(RR_MAX_CHUNK, planes * tiles // (4 * resident)))


def _resident_blocks(dev: torch.device, mode: Mode) -> int:
    """Blocks of the mode's residual_restrict_kernel the card holds at
    once (the occupancy calculator's blocks an SM times the SMs)."""
    key = (dev.index, int(mode))
    if key not in _resident:
        n = ctypes.c_int()
        rc = kernels.lib().mg_residual_restrict_resident(
            int(mode), ctypes.byref(n))
        kernels._check_rc(rc, "mg_residual_restrict_resident")
        _resident[key] = max(1, n.value)
    return _resident[key]


def residual_restrict_block(
    xzr: torch.Tensor,
    rlast: torch.Tensor,
    xzv: Optional[torch.Tensor],
    v: torch.Tensor,
    f: torch.Tensor,
    faces: Faces,
    box: Box,
    params: GridParams,
    h: float,
    cnz: int,
    newton_v: Optional[torch.Tensor] = None,
) -> None:
    """The residual of a block restricted along x and z into ``xzr``
    ``(bx/2, by, cbz)``: coarse plane m reads r planes 2m−1..2m+1 (plane −1
    taken as 0), coarse z k ∈ [1, cnz] reads 2k−1..2k+1, weights ¼ ½ ¼;
    ``rlast`` ``(by, cbz)`` gets the z restriction of r's last plane, for
    the caller's lower-x fix-up.  NONLINEAR also restricts v into ``xzv``,
    plane −1 being the lower x ghost face."""
    fas = params.mode == Mode.NONLINEAR
    if v.device.type == "cpu":
        return residual_restrict_block_plain(
            xzr, rlast, xzv, v, f, faces, box, params, h, cnz, newton_v
        )
    dev, nv = _check_block(v, f, faces, box, newton_v, params)
    bx, by, bz = v.shape
    if bx % 2:
        raise ValueError(f"block x extent {bx} is odd")
    cbz = xzr.shape[2]
    kernels._check(xzr, "xzr", (bx // 2, by, cbz), dev)
    kernels._check(rlast, "rlast", (by, cbz), dev)
    if fas:
        kernels._check(xzv, "xzv", (bx // 2, by, cbz), dev)
    if not 2 * cnz + 1 < bz or cnz >= cbz:
        raise ValueError(f"cnz {cnz} does not fit blocks {bz} / {cbz}")
    m0, m1 = restrict_planes(box, bx // 2)
    if box_empty(box) or m0 > m1:
        return
    t = kernels._taps(params.stencil)
    xc = restrict_chunk(box, m0, m1, cnz, _resident_blocks(dev, params.mode))
    rc = kernels.lib().mg_residual_restrict_block(
        xzr.data_ptr(), rlast.data_ptr(), _ptr(xzv) if fas else None,
        v.data_ptr(), f.data_ptr(), _ptr(nv),
        *(g.data_ptr() for g in faces), *_geometry(v, box), m0, m1, cnz,
        cbz, xc, t.val, t.off, t.n, 1.0 / (h * h), params.gamma,
        int(params.mode), kernels._stream(dev),
    )
    name = kernels.variant("residual_restrict_block", params.mode)
    kernels._check_rc(rc, name)
    kernels.launches[name] += 1


# ---------------------------------------------------------------------------
# prolong_add_block — replaces
# gpusolve_tpu/ops/pallas_spmd.py::_prolong_add_call (:850), mode-free.
# Bound: bytes (reads and writes v over the box, reads the ⅛-size coarse
# block: ~8.5 B per fine point).  Design: in place (each point reads only
# its own v); one thread per fine point gathers its 8 coarse values (L1
# hits from its neighbours), midpoints along x, y, then z.  No y padding
# to 8 rows (that is TPU DMA tiling).
# ---------------------------------------------------------------------------


def prolong_add_block(
    v: torch.Tensor, casm: torch.Tensor, box: Box
) -> None:
    """``v += P(casm)`` over ``box``, trilinear, in place.  ``casm`` is the
    coarse block with one ghost cell on each x and y face,
    ``(bx/2+2, by/2+2, czp)``, its z axis in padded global coordinates:
    fine p reads casm (p+2)//2 and (p+3)//2 along x and y, coarse k//2 and
    (k+1)//2 along z."""
    if v.device.type == "cpu":
        return prolong_add_block_plain(v, casm, box)
    dev = kernels._cuda_device(v)
    bx, by, bz = v.shape
    kernels._check(v, "v", v.shape, dev)
    czp = casm.shape[2]
    kernels._check(casm, "casm", (bx // 2 + 2, by // 2 + 2, czp), dev)
    _check_box(box, v.shape)
    if box_empty(box):
        return
    if (box[5] + 1) // 2 >= czp:
        raise ValueError(f"casm z extent {czp} is short of box {box}")
    rc = kernels.lib().mg_prolong_add_block(
        v.data_ptr(), casm.data_ptr(), *_geometry(v, box), by // 2 + 2, czp,
        kernels._stream(dev),
    )
    kernels._check_rc(rc, "prolong_add_block")
    kernels.launches["prolong_add_block"] += 1
