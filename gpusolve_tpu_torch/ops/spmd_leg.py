"""The distributed engine's trapezoid leg (``csrc/spmd_leg.cu``): all S
damped-Jacobi sweeps of one leg of a shard's block in one launch, with its
optional producers and consumers; the wrapper, and the plain PyTorch
version beside it.

It replaces the JAX package's communication-avoiding leg kernel,
``gpusolve_tpu/ops/pallas_spmd.py::_multi_sweep_call`` (:1847), whose body
is ``_make_leg`` (:1015) and whose caller is ``multi_sweep_block``
(:2047).  ``dist/spmd.py`` runs it wherever its leg gates allow.

The block layout is ``ops/spmd_kernels.py``'s: a dense ``(bx, by, bz)``
block with no stored halo, ``box`` the inclusive local bounds of its
globally interior cells.  In place of one-cell ghost faces the leg reads
ghost *slabs*, exchanged once per leg (``dist/spmd._Exchange.slabs``):

  * per field, ``(xlo, xhi, ylo, yhi)``: the lower and upper x neighbours'
    last and first ``G`` planes and, under a y split, the y neighbours'
    last and first ``G`` rows ``(bx, G, bz)``; the x slabs then carry the
    y-extended rows ``(G, by + 2G, bz)`` (the two-stage exchange forwards
    the diagonal neighbours' corners), else ``(G, by, bz)`` and ``ylo`` /
    ``yhi`` are None;
  * ``slabs=None`` is the one-rank mesh: every ghost is zero (the launch
    then reads no slab at all);
  * the coarse block of the corr-first up leg has slabs ``GC`` deep.

Generation k of the sweep chain is exact ``G − k`` planes (and, under a y
split, rows) into the ghost zone: the ghost cells are the neighbour's
real cells, so generations are masked by the GLOBAL interior ``glob =
(gx0, nx, gy0, ny)`` (the block's global x and y starts and the level's
extents; z is never split, the box's z bounds are its interior), and the
outputs by the local box.  So S sweeps with one exchange equal S
exchange-separated sweeps, bit for bit.

Producers: ``src_zero`` (a fresh down leg from v = 0: v is neither read
nor exchanged); ``coarse=(vc, cslabs)``, the corr-first up leg, which adds
the trilinear prolongation of the coarse block to v as generation 0.
Consumers: ``"norm"``, Σr² of the post-sweep residual over the box
(float64 partials for ``kernels.finalize``; the two x-edge planes read
generation S one plane into the ghost zone, so no separate edge pass, as
``_edge_norm_complete`` is in the JAX engine); ``"restrict"``, the
post-sweep residual restricted along x, y and z (¼ ½ ¼ per axis, in that
order) straight into the coarse f over the coarse box ``cbox`` — coarse
plane 0 reads the ghost-zone residual, so no fix-up — and in NONLINEAR
mode also R(v) into the coarse v and rest_v, and the tau fold
``f_c += A·Rv/h_c² + γ·Rv·e^{Rv}`` with the coarse h ``tau_h``.  A
consumer reads at most 3 planes past generation S (the tau fold's coarse
neighbours), so ``S + 3 <= G``.

The wrapper keeps the ``ops/kernels.py`` contract: outputs are passed in;
a CPU tensor runs the plain version; a CUDA float32 tensor is checked and
launched on the current stream, a launch error raises, and
``kernels.launches["leg_block[_fas|_newton]"]`` counts the launch.  There
is no device ``done`` flag, as with the other spmd kernels.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from gpusolve_tpu_torch.config import GridParams, Mode
from gpusolve_tpu_torch.ops import kernels, ref
from gpusolve_tpu_torch.ops.spmd_kernels import (
    Box, _check_box, box_dims, box_empty, box_slices,
)

G = 8   # ghost slab depth of a leg's fields
GC = 5  # of the coarse block of a corr-first leg: fine planes −G..bx+G−1
        # read coarse −G/2..(bx+G)/2
MAX_SWEEPS = 5       # a leg's sweeps; the corr-first leg takes 4
MAX_CORR_SWEEPS = 4
CONSUMERS = (None, "norm", "restrict")

Slabs = Sequence[Optional[torch.Tensor]]  # (xlo, xhi, ylo, yhi)
Glob = Tuple[int, int, int, int]          # (gx0, nx, gy0, ny)


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def _ysplit(slabs: Optional[Dict[str, Slabs]]) -> bool:
    return slabs is not None and slabs["f"][2] is not None


def _ext(u: torch.Tensor, s: Optional[Slabs], g: int, ysplit: bool):
    """u with its slabs around it: ``(bx+2g, by+2g·ysplit, bz)``; zeros
    for ``s=None``."""
    gy = g if ysplit else 0
    if s is None:
        return F.pad(u, (0, 0, gy, gy, g, g))
    xlo, xhi, ylo, yhi = s
    mid = torch.cat([ylo, u, yhi], dim=1) if ysplit else u
    return torch.cat([xlo, mid, xhi], dim=0)


def _stencil_all(e: torch.Tensor, params: GridParams, h: float):
    """A·e/h² at every cell of ``e``, taps outside it reading 0."""
    return ref.stencil_apply(F.pad(e, (1, 1, 1, 1, 1, 1)), tuple(e.shape),
                             params.stencil, 1.0 / (h * h))


def _keep(shape, offs, box: Box, glob: Glob, device):
    """The global-interior mask of an extended array whose index i along
    x and y is local ``i − offs``."""
    gx0, nx, gy0, ny = glob
    gx = gx0 + torch.arange(shape[0], device=device) - offs[0]
    gy = gy0 + torch.arange(shape[1], device=device) - offs[1]
    z = torch.arange(shape[2], device=device)
    return (
        ((gx >= 1) & (gx <= nx))[:, None, None]
        & ((gy >= 1) & (gy <= ny))[None, :, None]
        & ((z >= box[4]) & (z <= box[5]))[None, None, :]
    )


def _halves(n0: int, n: int, shift: int, device):
    """Indices of coarse p//2 and (p+1)//2 for fine p in [n0, n0+n),
    shifted by ``shift``."""
    p = torch.arange(n0, n0 + n, device=device)
    return (torch.div(p, 2, rounding_mode="floor") + shift,
            torch.div(p + 1, 2, rounding_mode="floor") + shift)


def _mid(t, dim, ab):
    return 0.5 * t.index_select(dim, ab[0]) + 0.5 * t.index_select(dim, ab[1])


def _prolong_ext(ce: torch.Tensor, shape, gy: int, gyc: int):
    """The trilinear prolongation of the extended coarse block ``ce`` (GC
    planes, ``gyc`` rows of ghosts) onto the extended fine block of
    ``shape`` (G planes, ``gy`` rows): fine local p reads coarse p//2 and
    (p+1)//2 per axis, midpoints along x, then y, then z."""
    dev = ce.device
    ce = F.pad(ce, (0, 1, 0, 1, 0, 1))  # coarse reads past the block: 0
    e = _mid(ce, 0, _halves(-G, shape[0], GC, dev))
    e = _mid(e, 1, _halves(-gy, shape[1], gyc, dev))
    return _mid(e, 2, _halves(0, shape[2], 0, dev))


def _restrict3(a: torch.Tensor, offs, starts, sizes):
    """Full weighting of an extended fine array (local index i at
    ``i + offs``) at coarse local m ∈ [start, start+size) per axis: fine
    2m−1, 2m, 2m+1, weights ¼ ½ ¼, along x, then y, then z; fine cells
    outside ``a`` read 0."""
    pad = 3
    out = F.pad(a, (pad,) * 6)
    for ax in range(3):
        s = offs[ax] + pad - 1 + 2 * starts[ax]
        n = sizes[ax]

        def tap(d, out=out, ax=ax, s=s, n=n):
            return out.narrow(ax, s + d, 2 * n - 1)[
                (slice(None),) * ax + (slice(0, None, 2),)
            ]

        out = 0.25 * tap(0) + 0.5 * tap(1) + 0.25 * tap(2)
    return out


def _coarse_keep(shape, starts, glob: Glob, cdims, device):
    gx0, _, gy0, _ = glob
    m = [torch.arange(s, s + n, device=device) for s, n in zip(starts, shape)]
    gx, gy, z = gx0 // 2 + m[0], gy0 // 2 + m[1], m[2]
    return (
        ((gx >= 1) & (gx <= cdims[0]))[:, None, None]
        & ((gy >= 1) & (gy <= cdims[1]))[None, :, None]
        & ((z >= 1) & (z <= cdims[2]))[None, None, :]
    )


def leg_block_plain(
    v_out, v, f, slabs, box, glob, params, h, S, *, newton_v=None,
    src_zero=False, coarse=None, consumer=None, cout=None, cbox=None,
    cdims=None, tau_h=0.0, sub_rv=None,
) -> Optional[torch.Tensor]:
    """Plain version of :func:`leg_block`: every generation over the whole
    extended block (cells near its outer edge are wrong, and no output
    reads them)."""
    nv = kernels._newton_v_for(params, newton_v)
    ys = _ysplit(slabs)
    gy = G if ys else 0
    sl = {} if slabs is None else slabs
    dev = f.device
    fe = _ext(f, sl.get("f"), G, ys)
    nve = None if nv is None else _ext(nv, sl.get("nv"), G, ys)
    keep = _keep(fe.shape, (G, gy), box, glob, dev)
    zero = torch.zeros((), dtype=f.dtype, device=dev)
    e = torch.zeros_like(fe) if src_zero else _ext(v, sl.get("v"), G, ys)
    if coarse is not None:
        vc, cs = coarse
        ce = _ext(vc, cs, GC, ys)
        e = e + _prolong_ext(ce, fe.shape, gy, GC if ys else 0)
    e = torch.where(keep, e, zero)
    for _ in range(S):
        av = _stencil_all(e, params, h)
        e = torch.where(keep, ref.sweep_point(params, h, av, e, fe, nve),
                        zero)
    x0, x1, y0, y1, z0, z1 = box
    loc = (slice(x0 + G, x1 + G + 1), slice(y0 + gy, y1 + gy + 1),
           slice(z0, z1 + 1))
    if not box_empty(box):
        out = e[loc]
        if sub_rv is not None:
            out = out - sub_rv[box_slices(box)]
        v_out[box_slices(box)] = out
    if consumer is None:
        return None
    r = ref.residual_point(params, _stencil_all(e, params, h), e, fe, nve)
    if consumer == "norm":
        if box_empty(box):
            return v.new_zeros(1, dtype=torch.float64)
        r64 = r[loc].to(torch.float64)
        return torch.sum(r64 * r64).reshape(1)
    # restrict
    fc, vc_out, rvc_out = cout
    if box_empty(cbox):
        return None
    r = torch.where(keep, r, zero)
    cx0, cx1, cy0, cy1, cz0, cz1 = cbox
    csl = box_slices(cbox)
    cdim = box_dims(cbox)
    rr = _restrict3(r, (G, gy, 0), (cx0, cy0, cz0), cdim)
    if params.mode != Mode.NONLINEAR:
        fc[csl] = rr
        return None
    # Rv over the coarse box and one coarse cell around it, zero outside
    # the coarse global interior; then the tau fold.
    st = (cx0 - 1, cy0 - 1, cz0 - 1)
    sz = tuple(n + 2 for n in cdim)
    rv = _restrict3(e, (G, gy, 0), st, sz)
    rv = torch.where(_coarse_keep(sz, st, glob, cdims, dev), rv, zero)
    rb = rv[1:-1, 1:-1, 1:-1]
    av = ref.stencil_apply(rv, cdim, params.stencil, 1.0 / (tau_h * tau_h))
    fc[csl] = rr + (av + params.gamma * rb * torch.exp(rb))
    vc_out[csl] = rb
    rvc_out[csl] = rb
    return None


# ---------------------------------------------------------------------------
# leg_block — replaces gpusolve_tpu/ops/pallas_spmd.py::_multi_sweep_call
# (:1847; body _make_leg :1015), in all three modes.  Bound: bytes (reads v,
# f, NEWTON also ũ, once per leg, writes v: 12 or 16 B per point; the
# restrict consumer adds the coarse f, FAS also the coarse v and rest_v,
# 0.5-1.5 B per fine point; the corr-first leg reads the ⅛-size coarse v).
# Design: 2.5-D temporal blocking.  A thread block owns a 16(y) x 32(z)
# tile of the box and a chunk of 64 x-planes; it marches along x through
# the chunk and a halo of R = S + e planes (e = 0 none, 1 norm, 2 restrict,
# 3 FAS restrict) over the tile and an R-cell ring around it, which it
# recomputes redundantly; generation k is computed one cell less deep
# each.  The ring's cells go to the threads in onion order (the tile, then
# each ring one cell shallower), so a generation's cells are a prefix of
# each thread's and whole warps skip the rings it does not reach.  The
# stencil's x taps read the thread's own cells, so one barrier a step
# suffices (csrc/spmd_leg.cu).  The generations never reach device memory;
# the residual and the restricted planes live in rings of their own.
# Templated on mode x consumer x slab-reading (one-rank launches read no
# slab); the producers are flags.
# ---------------------------------------------------------------------------


def _check_slabs(slabs, names, shape, g, ys, dev, what):
    bx, by, bz = shape
    rows = by + 2 * g if ys else by
    for name in names:
        s = slabs.get(name)
        if s is None or len(s) != 4:
            raise ValueError(f"{what}: missing slabs of {name}")
        xlo, xhi, ylo, yhi = s
        kernels._check(xlo, f"{name} xlo", (g, rows, bz), dev)
        kernels._check(xhi, f"{name} xhi", (g, rows, bz), dev)
        if ys:
            kernels._check(ylo, f"{name} ylo", (bx, g, bz), dev)
            kernels._check(yhi, f"{name} yhi", (bx, g, bz), dev)
        elif ylo is not None or yhi is not None:
            raise ValueError(f"{what}: {name} has y slabs but f has none")


def _shape_refusal(shape, cshape, ysplit: bool) -> Optional[str]:
    """Why a leg cannot run on blocks of these shapes, or None."""
    bx, by, bz = shape
    if bx % 2 or by % 2:
        return f"block {shape} has an odd x or y extent"
    if ysplit and by < G:
        return f"block y extent {by} is short of the {G}-row slab"
    if cshape is not None and ysplit and cshape[1] < GC:
        return f"coarse y extent {cshape[1]} is short of the {GC}-row slab"
    return None


def _ptrs(*ts):
    return [None if t is None else t.data_ptr() for t in ts]


def leg_block(
    v_out: torch.Tensor,
    v: Optional[torch.Tensor],
    f: torch.Tensor,
    slabs: Optional[Dict[str, Slabs]],
    box: Box,
    glob: Glob,
    params: GridParams,
    h: float,
    S: int,
    *,
    newton_v: Optional[torch.Tensor] = None,
    src_zero: bool = False,
    coarse=None,
    consumer: Optional[str] = None,
    cout=None,
    cbox: Optional[Box] = None,
    cdims=None,
    tau_h: float = 0.0,
    sub_rv: Optional[torch.Tensor] = None,
) -> Optional[torch.Tensor]:
    """S damped-Jacobi sweeps of a block over ``box`` into ``v_out``, from
    v (or 0 with ``src_zero``, or v + P(coarse) with ``coarse=(vc,
    cslabs)``), with the ghost ``slabs`` (None: all zero) of v, f and ũ
    (dict keys ``"v"``, ``"f"``, ``"nv"``; the coarse block's in
    ``cslabs``).  ``consumer="norm"`` returns the float64 partial sums of
    the post-sweep r² over the box (``kernels.finalize`` reduces them);
    ``consumer="restrict"`` writes the restricted post-sweep residual into
    ``cout[0]`` over ``cbox`` and, in NONLINEAR mode, R(v) into ``cout[1]``
    and ``cout[2]`` and the tau fold into ``cout[0]`` (``tau_h`` the
    coarse h, ``cdims`` the coarse level's dims).  With ``sub_rv`` (FAS
    rest_v) the leg writes generation S − sub_rv, one float32 subtraction
    a cell: the pod engine's up legs below a chain's head."""
    kw = dict(newton_v=newton_v, src_zero=src_zero, coarse=coarse,
              consumer=consumer, cout=cout, cbox=cbox, cdims=cdims,
              tau_h=tau_h, sub_rv=sub_rv)
    check_leg(params, S, **kw)
    if f.device.type == "cpu":
        return leg_block_plain(v_out, v, f, slabs, box, glob, params, h, S,
                               **kw)
    ptrs, ints, fl, partials = _launch_args(
        v_out, v, f, slabs, box, glob, params, h, S, **kw
    )
    if box_empty(box):
        return v_out.new_zeros(1, dtype=torch.float64) \
            if consumer == "norm" else None
    rc = kernels.lib().mg_leg_block(
        (ctypes.c_void_p * len(ptrs))(*ptrs),
        (ctypes.c_int * len(ints))(*ints),
        (ctypes.c_float * len(fl))(*fl), *_tap_args(params),
        kernels._stream(f.device),
    )
    name = kernels.variant("leg_block", params.mode)
    kernels._check_rc(rc, name)
    kernels.launches[name] += 1
    return partials


def check_leg(params: GridParams, S: int, *, newton_v=None, src_zero=False,
              coarse=None, consumer=None, cout=None, cbox=None, cdims=None,
              tau_h=0.0, sub_rv=None) -> None:
    """The leg arguments' consistency, on any device: the consumer, the
    sweep cap, which producer and epilogue go with which consumer and
    mode."""
    fas = params.mode == Mode.NONLINEAR
    if consumer not in CONSUMERS:
        raise ValueError(f"consumer must be one of {CONSUMERS}, got "
                         f"{consumer!r}")
    cap = MAX_CORR_SWEEPS if coarse is not None else MAX_SWEEPS
    if not 1 <= S <= cap:
        raise ValueError(f"a leg takes 1..{cap} sweeps, got {S}")
    if coarse is not None and consumer == "restrict":
        raise ValueError("the corr-first leg has no restrict consumer")
    if src_zero and (coarse is not None or fas):
        raise ValueError("src_zero starts a LINEAR or NEWTON down leg")
    if consumer == "restrict" and fas and not tau_h > 0.0:
        raise ValueError("a NONLINEAR restrict leg needs tau_h")
    if sub_rv is not None and (not fas or consumer is not None):
        raise ValueError("sub_rv is the FAS v - rest_v fold of a leg with "
                         "no consumer")


def _tap_args(params: GridParams):
    t = kernels._taps(params.stencil)
    return t.val, t.off, t.n


def _launch_args(
    v_out, v, f, slabs, box, glob, params, h, S, *, newton_v, src_zero,
    coarse, consumer, cout, cbox, cdims, tau_h, sub_rv,
):
    """Checks one leg's CUDA tensors and gives its C arguments: the
    pointer, int and float arrays of ``mg_leg_block`` and the norm
    partials it writes (None without the norm consumer)."""
    fas = params.mode == Mode.NONLINEAR
    dev = kernels._cuda_device(f)
    shape = tuple(f.shape)
    bx, by, bz = shape
    nv = kernels._newton_v_for(params, newton_v)
    ys = _ysplit(slabs)
    for name, t in (("v_out", v_out), ("f", f)):
        kernels._check(t, name, shape, dev)
    if not src_zero:
        kernels._check(v, "v", shape, dev)
    if nv is not None:
        kernels._check(nv, "newton_v", shape, dev)
    if sub_rv is not None:
        kernels._check(sub_rv, "sub_rv", shape, dev)
    if v_out.data_ptr() in _ptrs(v, f, nv, sub_rv):
        raise ValueError("v_out must not alias v, f, newton_v or sub_rv")
    _check_box(box, shape)
    names = (["f"] if src_zero else ["v", "f"]) + (["nv"] if nv is not None
                                                   else [])
    if slabs is not None:
        _check_slabs(slabs, names, shape, G, ys, dev, "leg_block")
    cshape = None
    vc, cs = (None, None) if coarse is None else coarse
    if coarse is not None:
        cshape = (bx // 2, vc.shape[1], vc.shape[2])
        kernels._check(vc, "coarse v", cshape, dev)
        if (slabs is None) != (cs is None):
            raise ValueError("the coarse slabs and the fine slabs must both "
                             "be given or both be None")
        if cs is not None:
            _check_slabs({"c": cs}, ["c"], cshape, GC, ys, dev, "leg_block")
    why = _shape_refusal(shape, cshape, ys)
    if why is not None:
        raise ValueError(why)
    fc = vco = rvo = None
    ci = [0] * 11
    if consumer == "restrict":
        fc, vco, rvo = cout
        cshape = (bx // 2,) + tuple(fc.shape[1:])
        kernels._check(fc, "coarse f", cshape, dev)
        if fas:
            kernels._check(vco, "coarse v", cshape, dev)
            kernels._check(rvo, "coarse rest_v", cshape, dev)
        _check_box(cbox, cshape)
        if 2 * cshape[1] > by + 2 or 2 * cshape[2] > bz + 2:
            raise ValueError(f"coarse block {cshape} does not halve {shape}")
        ci = [cshape[1], cshape[2], *cbox, *cdims]
    elif coarse is not None:
        ci = [cshape[1], cshape[2]] + [0] * 9
    ints = [
        int(params.mode), CONSUMERS.index(consumer), int(slabs is not None),
        int(ys), S, int(src_zero), int(coarse is not None), bx, by, bz,
        *box, *glob, *ci,
    ]
    partials = None
    if consumer == "norm" and not box_empty(box):
        grid = (ctypes.c_longlong * 4)()
        rc = kernels.lib().mg_leg_grid((ctypes.c_int * len(ints))(*ints),
                                       grid)
        kernels._check_rc(rc, "leg_block")
        partials = torch.empty(grid[0] * grid[1] * grid[2],
                               dtype=torch.float64, device=dev)
    sl = {} if slabs is None else slabs
    fields = []
    for name, t in (("v", v), ("f", f), ("nv", nv)):
        s = sl.get(name) or (None,) * 4
        fields += [t, *s]
    cfield = [vc, *(cs or (None,) * 4)]
    ptrs = _ptrs(v_out, *fields, *cfield, partials, fc, vco, rvo, sub_rv)
    pre_fac = params.stencil.diag / (h * h)
    fl = [1.0 / (h * h), (h * h) / params.stencil.diag, params.omega,
          params.gamma, pre_fac,
          1.0 / (tau_h * tau_h) if tau_h > 0.0 else 0.0]
    return ptrs, ints, fl, partials
