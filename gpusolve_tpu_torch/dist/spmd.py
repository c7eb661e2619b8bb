"""Explicit-halo distributed multigrid engine, per-leg form, on
``torch.distributed``.

The counterpart of ``gpusolve_tpu/dist/spmd.py`` with ``fuse="leg"``,
``halo="ppermute"``, no replicated tail, and the per-op shard-local path
(the JAX package's path wherever its trapezoid gate ``_trap_ok`` refuses a
leg).  Each process owns one block of every distributed level; its
neighbours' face planes arrive through ``dist.batch_isend_irecv``, norms
sum with ``all_reduce``, and the coarse levels below the distribution
cutoff are gathered into a replicated layout (``all_gather``) that every
rank smooths redundantly.  All three modes run: LINEAR, NONLINEAR (FAS
tau correction, the up-leg ``v − restV``) and NEWTON (the frozen ũ per
level; the outer loop ``newton_solve_spmd``).

Layout (``SpmdPlan``):
  * the z mesh axis folds into the y data decomposition, so the data mesh
    is ``(mx, my·mz, 1)``: z is never split;
  * distributed levels (``l < n_dist``) use the mesh-aware halving
    allocation ``alloc``, so a fine block is twice a coarse one and the
    transfers stay shard-local with a one-cell ghost; a block holds no
    halo, and its globally interior cells form the ``box`` every kernel
    writes (cells outside it stay zero);
  * replicated levels use the port's dense ``(n+2)³`` layout and run the
    single-device ops of ``ops/dispatch``: per-op kernels on the card, the
    plain ops elsewhere.

The distributed levels run the four shard-local kernels of
``ops/spmd_kernels.py`` (sweep, residual and its norm, the fused residual
and x/z restriction, the prolongation from a ghost-extended coarse block)
on float32 CUDA tensors, and their plain versions on CPU tensors, in
float64 or under ``backend="ref"`` (``ops/dispatch.plain_reason``).  The
glue between them is plain torch, as the JAX engine's is XLA: the
exchanges, the y restriction and the lower-x fix-up of the fused
restriction, the interior masks, the FAS tau, the gathers into the
replicated levels, and Newton's restriction of ũ.

On a ``(1, 1, 1)`` mesh no collective is called; a missing neighbour's
face is zeros, the Dirichlet boundary, as ``lax.ppermute`` leaves it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from gpusolve_tpu_torch.config import GridParams, Mode
from gpusolve_tpu_torch.dist.mesh import Mesh, coords_of
from gpusolve_tpu_torch.grid import GridLevel, GridState, rhs_values, \
    torch_dtype
from gpusolve_tpu_torch.ops import dispatch as ops
from gpusolve_tpu_torch.ops import kernels
from gpusolve_tpu_torch.ops import spmd_kernels as sk
from gpusolve_tpu_torch.ops.vcycle_batch import level_visits
from gpusolve_tpu_torch.utils.timer import Timer

_SUBCYCLES = {"V": ("V",), "W": ("W", "W"), "F": ("F", "V")}


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class SpmdPlan:
    """Static decomposition plan: which levels are distributed, and the
    mesh-aware allocation and block shapes per level
    (``gpusolve_tpu/dist/spmd.py:125-206``, without its tail mode).

    ``device_mesh`` is the process mesh; ``mesh_shape`` the data
    decomposition ``(mx, my·mz, 1)`` (the z mesh axis folds into y);
    ``names`` the mesh axes each data axis runs over."""

    def __init__(self, params: GridParams, mesh_shape, cutoff: int = 4):
        self.params = params
        self.device_mesh = tuple(mesh_shape)
        mesh_shape = (mesh_shape[0], mesh_shape[1] * mesh_shape[2], 1)
        self.names = (
            "x",
            ("y", "z") if self.device_mesh[2] > 1 else "y",
            "z",
        )
        self.mesh_shape = tuple(mesh_shape)
        dims = params.level_dims()
        nlev = len(dims)
        # Deepest level that still has >= cutoff interior points per shard
        # along every axis; the coarsest stays replicated.
        d = 0
        while d < nlev and all(
            dims[d][a] // self.mesh_shape[a] >= cutoff for a in range(3)
        ):
            d += 1
        self.n_dist = min(max(d, 1), nlev - 1) if all(
            dims[0][a] >= self.mesh_shape[a] for a in range(3)
        ) else 0
        if self.n_dist == 0:
            raise ValueError(
                f"grid {dims[0]} too small for mesh {self.mesh_shape}"
            )
        # Mesh-aware allocation: A0 covers every distributed level shifted
        # up, rounded so each level halves exactly down to an even block
        # at the last distributed level.
        gran = 1 << self.n_dist
        a0 = [
            _round_up(
                max((dims[l][ax] + 2) << l for l in range(self.n_dist)),
                self.mesh_shape[ax] * gran,
            )
            for ax in range(3)
        ]
        self.alloc: List[Tuple[int, int, int]] = [
            tuple(a >> l for a in a0) for l in range(self.n_dist)
        ]
        # Replicated levels: the port's dense padded layout.
        self.alloc += [tuple(n + 2 for n in dims[l])
                       for l in range(self.n_dist, nlev)]
        self.block = [
            tuple(self.alloc[l][a] // self.mesh_shape[a] for a in range(3))
            for l in range(self.n_dist)
        ]
        self.dims = dims
        self.nlev = nlev
        # The trapezoid legs are not ported: no level runs them.
        self.fused_down_levels: Tuple[int, ...] = ()
        self.fused_up_levels: Tuple[int, ...] = ()

    def data_coords(self, coords) -> Tuple[int, int]:
        """The (x, y) block coordinates of mesh coordinates ``coords``."""
        return coords[0], coords[1] * self.device_mesh[2] + coords[2]

    def box(self, l: int, coords) -> sk.Box:
        """Inclusive local bounds of the globally interior cells of the
        block at mesh ``coords`` on distributed level ``l``."""
        dc = self.data_coords(coords) + (0,)
        out = []
        for ax in range(3):
            b = self.block[l][ax]
            start = dc[ax] * b
            out += [max(0, 1 - start), min(b - 1, self.dims[l][ax] - start)]
        return tuple(out)


def spmd_eligible(params: GridParams, mesh_shape) -> Optional[str]:
    """None when the spmd engine can run this configuration, else the
    reason (the CLI's engine choice)."""
    dims = params.level_dims()
    if len(dims) < 2:
        return "single-level grid"
    folded = (mesh_shape[0], mesh_shape[1] * mesh_shape[2], 1)
    if any(dims[0][a] < folded[a] for a in range(3)):
        return f"grid {dims[0]} too small for mesh {tuple(mesh_shape)}"
    return None


def _face_taps_only(stencil) -> bool:
    return all(sum(1 for o in off if o) <= 1 for off in stencil.offsets)


# ---------------------------------------------------------------------------
# The exchange layer
# ---------------------------------------------------------------------------


class _Exchange:
    """Face swaps, halos, sums and gathers of one rank on the data mesh."""

    def __init__(self, mesh: Mesh, plan: SpmdPlan):
        self.mesh = mesh
        self.plan = plan
        self.dc = plan.data_coords(mesh.coords)
        self._zeros = {}

    def _peer(self, ax: int, step: int) -> Optional[int]:
        c = list(self.dc)
        c[ax] += step
        if not 0 <= c[ax] < self.plan.mesh_shape[ax]:
            return None
        mz = self.plan.device_mesh[2]
        return self.mesh.global_rank(
            self.mesh.rank_of((c[0], c[1] // mz, c[1] % mz))
        )

    def zeros(self, shape, like: torch.Tensor) -> torch.Tensor:
        """A zero tensor, cached per shape (read only)."""
        key = (tuple(shape), like.dtype, like.device)
        z = self._zeros.get(key)
        if z is None:
            z = self._zeros[key] = like.new_zeros(shape)
        return z

    def swap(self, ax: int, up: Optional[torch.Tensor],
             down: Optional[torch.Tensor]):
        """Send ``up`` to the upper neighbour along data axis ``ax`` and
        ``down`` to the lower; returns ``(from_lower, from_upper)``: what
        the lower neighbour sent up and the upper one sent down, zeros
        where there is no neighbour (None for a direction not sent)."""
        got = [None, None]
        sends = ((up, 1, 0), (down, -1, 1))
        if self.plan.mesh_shape[ax] > 1:
            p2p = []
            for t, step, slot in sends:
                if t is None:
                    continue
                t = t.contiguous()
                to, frm = self._peer(ax, step), self._peer(ax, -step)
                if to is not None:
                    p2p.append(dist.P2POp(dist.isend, t, to,
                                          self.mesh.group))
                if frm is not None:
                    got[slot] = torch.empty_like(t)
                    p2p.append(dist.P2POp(dist.irecv, got[slot], frm,
                                          self.mesh.group))
            if p2p:
                for work in dist.batch_isend_irecv(p2p):
                    work.wait()
        for t, _, slot in sends:
            if t is not None and got[slot] is None:
                got[slot] = self.zeros(t.shape, t)
        return got[0], got[1]

    def faces(self, u: torch.Tensor):
        """The x and y ghost faces of a block: ``(gxlo, gxhi, gylo,
        gyhi)``, each a contiguous plane."""
        if self.mesh.size == 1:
            bx, by, bz = u.shape
            gx, gy = self.zeros((by, bz), u), self.zeros((bx, bz), u)
            return gx, gx, gy, gy
        gxlo, gxhi = self.swap(0, u[-1], u[0])
        gylo, gyhi = self.swap(1, u[:, -1], u[:, 0])
        return gxlo, gxhi, gylo, gyhi

    def halo(self, u: torch.Tensor, axes=(0, 1, 2)) -> torch.Tensor:
        """The block extended by one ghost cell on each face of ``axes``;
        sequential per axis, so later axes forward the earlier axes'
        ghosts and the edge and corner cells are filled."""
        for ax in axes:
            n = u.shape[ax]
            lo, hi = self.swap(
                ax, u.narrow(ax, n - 1, 1), u.narrow(ax, 0, 1)
            ) if ax < 2 else (None, None)
            if lo is None:
                lo = hi = self.zeros(u.narrow(ax, 0, 1).shape, u)
            u = torch.cat([lo, u, hi], dim=ax)
        return u

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        if self.mesh.size > 1:
            dist.all_reduce(t, group=self.mesh.group)
        return t

    def assemble(self, block: torch.Tensor) -> torch.Tensor:
        """The blocks of every rank placed by their data coordinates:
        ``(mx·bx, MY·by, bz)``."""
        if self.mesh.size == 1:
            return block
        block = block.contiguous()
        parts = [torch.empty_like(block) for _ in range(self.mesh.size)]
        dist.all_gather(parts, block, group=self.mesh.group)
        bx, by, bz = block.shape
        mx, my = self.plan.mesh_shape[:2]
        out = block.new_zeros((mx * bx, my * by, bz))
        for rank, part in enumerate(parts):
            dx, dy = self.plan.data_coords(
                coords_of(rank, self.plan.device_mesh)
            )
            out[dx * bx:(dx + 1) * bx, dy * by:(dy + 1) * by] = part
        return out


# ---------------------------------------------------------------------------
# Plain local ops (the JAX engine's MXU contractions, as weighted sums)
# ---------------------------------------------------------------------------


def _weigh3(a, b, c):
    return 0.25 * a + 0.5 * b + 0.25 * c


def _restrict_axis(a: torch.Tensor, ax: int, n: int) -> torch.Tensor:
    """Full weighting along ``ax``: out j reads ``a`` 2j, 2j+1, 2j+2."""
    def tap(d):
        idx = [slice(None)] * a.dim()
        idx[ax] = slice(d, d + 2 * n - 1, 2)
        return a[tuple(idx)]

    return _weigh3(tap(0), tap(1), tap(2))


def _restrict_local(asm: torch.Tensor, cblock) -> torch.Tensor:
    """27-point full weighting of a ghost-extended fine block: coarse local
    j reads assembled fine 2j+d+1, d ∈ {−1, 0, 1}, weights ¼ ½ ¼ per axis
    (``gpusolve_tpu/dist/spmd.py:378``)."""
    out = asm
    for ax in range(3):
        out = _restrict_axis(out, ax, cblock[ax])
    return out


def _window(src: torch.Tensor, starts, sizes) -> torch.Tensor:
    """``src[starts : starts + sizes]`` per axis, zero where the window
    leaves ``src``."""
    out = src.new_zeros(tuple(sizes))
    dst_sl, src_sl = [], []
    for s, n, ext in zip(starts, sizes, src.shape):
        a, b = max(0, s), min(ext, s + n)
        if a >= b:
            return out
        src_sl.append(slice(a, b))
        dst_sl.append(slice(a - s, b - s))
    out[tuple(dst_sl)] = src[tuple(src_sl)]
    return out


def _local_rhs(plan: SpmdPlan, l: int, coords, params: GridParams,
               dtype, device) -> torch.Tensor:
    """The analytic RHS on this rank's block of level ``l``, from global
    coordinates in ``grid.rhs_values``' formula and order, zero outside the
    interior (``gpusolve_tpu/dist/spmd.py:455``)."""
    dc = plan.data_coords(coords) + (0,)
    off = -1.0 if params.mode == Mode.LINEAR else 0.0
    h = params.h
    axes = []
    for ax in range(3):
        b = plan.block[l][ax]
        g = dc[ax] * b + torch.arange(b, dtype=dtype, device=device)
        axes.append((g + off) * h)
    x = axes[0][:, None, None]
    y = axes[1][None, :, None]
    z = axes[2][None, None, :]
    val = rhs_values(params, x, y, z)
    out = torch.zeros(plan.block[l], dtype=dtype, device=device)
    sl = sk.box_slices(plan.box(l, coords))
    out[sl] = val[sl]
    return out


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def _cycle_key(params: GridParams) -> GridParams:
    """The parameters a cycle reads: maxiter, tol and progress normalised
    out, so an inner Newton solve reuses its outer solve's engine."""
    return dataclasses.replace(
        params, maxiter=0, tol=0.0, print_progress=False
    )


class SpmdEngine:
    """One rank's part of the per-leg engine: its geometry, its exchange
    and the cycle over a ``GridState`` whose distributed levels hold this
    rank's blocks and whose replicated levels hold the whole coarse grids
    (``gpusolve_tpu/dist/spmd.py:577-1650``, ``local_vcycle``)."""

    def __init__(self, params: GridParams, mesh: Mesh, cutoff: int = 4):
        if not _face_taps_only(params.stencil):
            raise ValueError(
                "the spmd engine takes stencils whose taps lie on the faces; "
                "corner and edge taps are not ported (the face exchange "
                "carries face neighbours only)"
            )
        self.key = _cycle_key(params)
        self.params = params
        self.mesh = mesh
        self.cutoff = cutoff
        self.plan = SpmdPlan(params, mesh.shape, cutoff)
        self.dtype = torch_dtype(params.dtype)
        self.device = mesh.device
        self.ex = _Exchange(mesh, self.plan)
        # Why the distributed levels run the plain versions, or None
        # (the kernels).
        self.plain_reason = ops.plain_reason(
            params, self.device, self.dtype
        )
        p = self.plan
        self.nd, self.nlev = p.n_dist, p.nlev
        self.hs = [params.level_h(l) for l in range(self.nlev)]
        self.boxes = [p.box(l, mesh.coords) for l in range(self.nd)]
        self.fas = params.mode == Mode.NONLINEAR
        self.newton = params.mode == Mode.NEWTON
        # The fused restriction's outputs: zeroed once, each launch writes
        # the same cells.
        self._xz = []
        for l in range(self.nd - 1):
            bx, by, _ = p.block[l]
            cbz = p.block[l + 1][2]
            z = lambda *s: torch.zeros(s, dtype=self.dtype,
                                       device=self.device)
            self._xz.append((
                z(bx // 2, by, cbz), z(by, cbz),
                z(bx // 2, by, cbz) if self.fas else None,
            ))

    # -- op choice ---------------------------------------------------------

    def _op(self, kernel, plain):
        return plain if self.plain_reason is not None else kernel

    def _finalize(self, partials, out):
        self._op(kernels.finalize, kernels.finalize_plain)(partials, out)

    # -- state ---------------------------------------------------------------

    def init_state(self) -> GridState:
        """Zero fields, the analytic RHS on level 0 (``local_init``)."""
        p = self.plan
        levels = []
        for l in range(self.nlev):
            shape = p.block[l] if l < self.nd else p.alloc[l]

            def z():
                return torch.zeros(shape, dtype=self.dtype,
                                   device=self.device)

            f = _local_rhs(p, 0, self.mesh.coords, self.params, self.dtype,
                           self.device) if l == 0 else z()
            levels.append(GridLevel(
                v=z(), f=f, r=z(),
                rest_v=z() if self.fas else None,
                newton_v=z() if self.newton else None,
            ))
        newton_f = levels[0].f.clone() if self.newton else None
        return GridState(levels=tuple(levels), newton_f=newton_f)

    # -- distributed-level ops ----------------------------------------------

    def _mask(self, l: int, x: torch.Tensor) -> torch.Tensor:
        """x with the cells outside level ``l``'s box zeroed."""
        out = torch.zeros_like(x)
        sl = sk.box_slices(self.boxes[l])
        out[sl] = x[sl]
        return out

    def _smooth(self, l: int, lvl: GridLevel, n_iter: int) -> None:
        sweep = self._op(sk.sweep_block, sk.sweep_block_plain)
        for _ in range(n_iter):
            sweep(lvl.r, lvl.v, lvl.f, self.ex.faces(lvl.v), self.boxes[l],
                  self.params, self.hs[l], lvl.newton_v)
            lvl.v, lvl.r = lvl.r, lvl.v

    def _fas_tau(self, l: int, f: torch.Tensor, rv: torch.Tensor) -> None:
        """``f += A·rv/h² + γ·rv·e^{rv}`` over level ``l``'s box: the FAS
        tau correction f_c = R(r) + A_c(R v) (``_finish_restrict``)."""
        box = self.boxes[l]
        sl = sk.box_slices(box)
        av = sk.block_stencil(rv, self.ex.faces(rv), box, self.params,
                              self.hs[l])
        rb = rv[sl]
        f[sl] += av + self.params.gamma * rb * torch.exp(rb)

    def _y_restrict(self, x2: torch.Tensor, lc: int) -> torch.Tensor:
        """y full weighting of an x/z-restricted block into coarse level
        ``lc``'s layout: coarse row k reads rows 2k−1..2k+1, row −1 the
        lower y neighbour's last row (``_y_restrict_embed``)."""
        glo, _ = self.ex.swap(1, x2[:, -1], None)
        x2e = torch.cat([glo[:, None], x2], dim=1)
        return _restrict_axis(x2e, 1, self.plan.block[lc][1])

    def _fix_x0(self, x2: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
        """Add ¼ of the lower x neighbour's z-restricted last residual
        plane onto coarse plane 0 (the fused kernel cannot see it)."""
        if self.plan.mesh_shape[0] == 1:
            return x2
        prev, _ = self.ex.swap(0, last, None)
        x2 = x2.clone()
        x2[0] += 0.25 * prev
        return x2

    def _to_repl(self, part: torch.Tensor) -> torch.Tensor:
        """Gather a distributed coarse field into the replicated level's
        layout, zero outside its interior (``_gather_to_replicated``)."""
        nd = self.nd
        g = self.ex.assemble(part)
        n = self.plan.dims[nd]
        out = g.new_zeros(self.plan.alloc[nd])
        sl = tuple(slice(1, d + 1) for d in n)
        out[sl] = g[sl]
        return out

    def _coarse_window(self, vc: torch.Tensor, lf: int) -> torch.Tensor:
        """This rank's window of the replicated coarse v for prolongation
        into distributed level ``lf``: one ghost cell on each x and y face,
        z whole (``_slice_coarse_for_shard``)."""
        cbx, cby = self.plan.block[lf][0] // 2, self.plan.block[lf][1] // 2
        dx, dy = self.ex.dc
        return _window(vc, (dx * cbx - 1, dy * cby - 1, 0),
                       (cbx + 2, cby + 2, vc.shape[2]))

    # -- legs -----------------------------------------------------------------

    def _down_dist(self, l: int, levels) -> None:
        prm = self.params
        lvl, nxt = levels[l], levels[l + 1]
        self._smooth(l, lvl, prm.pre_smoothing)
        faces = self.ex.faces(lvl.v)
        if l + 1 < self.nd:
            xzr, rlast, xzv = self._xz[l]
            self._op(sk.residual_restrict_block,
                     sk.residual_restrict_block_plain)(
                xzr, rlast, xzv, lvl.v, lvl.f, faces, self.boxes[l], prm,
                self.hs[l], self.plan.dims[l + 1][2], lvl.newton_v,
            )
            f_next = self._mask(
                l + 1, self._y_restrict(self._fix_x0(xzr, rlast), l + 1)
            )
            if self.fas:
                rv = self._mask(l + 1, self._y_restrict(xzv, l + 1))
                self._fas_tau(l + 1, f_next, rv)
                nxt.v, nxt.rest_v = rv, rv.clone()
            else:
                nxt.v.zero_()
            nxt.f = f_next
            return
        # The junction: distributed -> replicated.
        self._op(sk.residual_block, sk.residual_block_plain)(
            lvl.r, lvl.v, lvl.f, faces, self.boxes[l], prm, self.hs[l],
            newton_v=lvl.newton_v,
        )
        cb = tuple(b // 2 for b in self.plan.block[l])
        nxt.f = self._to_repl(_restrict_local(self.ex.halo(lvl.r), cb))
        if self.fas:
            rv = self._to_repl(_restrict_local(self.ex.halo(lvl.v), cb))
            nxt.v, nxt.rest_v = rv, rv.clone()
            ops.apply_fas_op(nxt.f, nxt.v, self.plan.dims[l + 1], prm,
                             self.hs[l + 1])
        else:
            nxt.v.zero_()

    def _up_dist(self, lc: int, levels) -> None:
        lf = lc - 1
        lvl, c = levels[lf], levels[lc]
        if lc == self.nd:
            if self.fas:
                ops.subtract_op(c.v, c.rest_v, self.plan.dims[lc],
                                self.params)
            casm = self._coarse_window(c.v, lf)
        else:
            vc = c.v - c.rest_v if self.fas else c.v
            casm = self.ex.halo(vc, axes=(0, 1))
        self._op(sk.prolong_add_block, sk.prolong_add_block_plain)(
            lvl.v, casm, self.boxes[lf]
        )
        self._smooth(lf, lvl, self.params.post_smoothing)

    def _smooth_repl(self, l: int, lvl: GridLevel, n_iter: int) -> None:
        lvl.v, lvl.r = ops.smooth(
            lvl.v, lvl.f, lvl.r, self.plan.dims[l], self.params, self.hs[l],
            n_iter, newton_v=lvl.newton_v,
        )

    def _down_repl(self, l: int, levels) -> None:
        prm, dims = self.params, self.plan.dims
        lvl, nxt = levels[l], levels[l + 1]
        self._smooth_repl(l, lvl, prm.pre_smoothing)
        ops.residual_op(lvl.r, lvl.v, lvl.f, dims[l], prm, self.hs[l],
                        newton_v=lvl.newton_v)
        if self.fas:
            ops.restrict_op(nxt.f, lvl.r, dims[l], dims[l + 1], prm)
            ops.restrict_op(nxt.v, lvl.v, dims[l], dims[l + 1], prm,
                            out2=nxt.rest_v)
            ops.apply_fas_op(nxt.f, nxt.v, dims[l + 1], prm, self.hs[l + 1])
        else:
            ops.restrict_zero_op(nxt.f, nxt.v, lvl.r, dims[l], dims[l + 1],
                                 prm)

    def _up_repl(self, lc: int, levels) -> None:
        prm, dims = self.params, self.plan.dims
        lvl, c = levels[lc - 1], levels[lc]
        if self.fas:
            ops.subtract_op(c.v, c.rest_v, dims[lc], prm)
        ops.prolong_add_op(lvl.v, c.v, dims[lc], dims[lc - 1], prm)
        self._smooth_repl(lc - 1, lvl, prm.post_smoothing)

    def _cycle_at(self, i: int, kind: str, levels) -> None:
        if i == self.nlev - 1:
            prm = self.params
            self._smooth_repl(i, levels[i],
                              prm.pre_smoothing + prm.post_smoothing)
            return
        if i < self.nd:
            self._down_dist(i, levels)
        else:
            self._down_repl(i, levels)
        for sub in _SUBCYCLES[kind]:
            self._cycle_at(i + 1, sub, levels)
        if i + 1 > self.nd:
            self._up_repl(i + 1, levels)
        else:
            self._up_dist(i + 1, levels)

    # -- cycles and norms ----------------------------------------------------

    def norm_sumsq(self, state: GridState, out: torch.Tensor) -> None:
        """This rank's Σr² of the finest level into ``out`` (one element;
        the caller sums over the ranks)."""
        lvl = state.levels[0]
        partials = self._op(sk.residual_block, sk.residual_block_plain)(
            None, lvl.v, lvl.f, self.ex.faces(lvl.v), self.boxes[0],
            self.params, self.hs[0], write_r=False, with_norm=True,
            newton_v=lvl.newton_v,
        )
        self._finalize(partials, out)

    def cycle(self, state: GridState, out: torch.Tensor) -> None:
        """One cycle of ``params.cycle_type`` on ``state`` in place, and
        this rank's finest-level Σr² after it into ``out``."""
        levels = list(state.levels)
        self._cycle_at(0, self.params.cycle_type, levels)
        self.norm_sumsq(state, out)

    def run_cycles(self, state: GridState, n: int, timer=None) -> np.ndarray:
        """``n`` cycles, then one sum over the ranks and one host read of
        their Σr² (timed as ``sumBuffer``)."""
        sums = torch.empty(n, dtype=self.dtype, device=self.device)
        for i in range(n):
            self.cycle(state, sums[i:i + 1])
        self.ex.all_reduce(sums)
        if timer is not None:
            with timer.section("sumBuffer"):
                return sums.cpu().numpy()
        return sums.cpu().numpy()

    def residual_norm(self, state: GridState) -> float:
        """The finest level's residual norm over the whole mesh
        (``_build_residual_norm``)."""
        ss = torch.empty(1, dtype=self.dtype, device=self.device)
        self.norm_sumsq(state, ss)
        return _sqrt(self.ex.all_reduce(ss).cpu().numpy()[0])

    # -- Newton ----------------------------------------------------------------

    def comp_f(self, state: GridState, timer=None) -> float:
        """F = newton_f − (A·ũ/h² + γ ũ e^ũ) into level 0's f and ‖F‖ over
        the mesh: the residual kernel in NONLINEAR mode at v = ũ."""
        lvl = state.levels[0]
        p_fas = self.params.replace(mode=Mode.NONLINEAR)
        ss = torch.empty(1, dtype=self.dtype, device=self.device)
        partials = self._op(sk.residual_block, sk.residual_block_plain)(
            lvl.f, lvl.newton_v, state.newton_f,
            self.ex.faces(lvl.newton_v), self.boxes[0], p_fas, self.hs[0],
            with_norm=True,
        )
        self._finalize(partials, ss)
        self.ex.all_reduce(ss)
        if timer is not None:
            with timer.section("sumBuffer"):
                return _sqrt(ss.cpu().numpy()[0])
        return _sqrt(ss.cpu().numpy()[0])

    def restrict_newton_v(self, state: GridState) -> None:
        """ũ restricted to levels 1..L−2, never the coarsest (reference
        src/cpu/NewtonSolver.cpp:88-92)."""
        levels, nd, nlev = state.levels, self.nd, self.nlev
        for l in range(min(nd, nlev - 2)):
            asm = self.ex.halo(levels[l].newton_v)
            if l + 1 < nd:
                levels[l + 1].newton_v = self._mask(
                    l + 1, _restrict_local(asm, self.plan.block[l + 1])
                )
            else:
                cb = tuple(b // 2 for b in self.plan.block[l])
                levels[l + 1].newton_v = self._to_repl(
                    _restrict_local(asm, cb)
                )
        dims = self.plan.dims
        for l in range(nd, nlev - 2):
            ops.restrict_op(levels[l + 1].newton_v, levels[l].newton_v,
                            dims[l], dims[l + 1], self.params)


def _sqrt(x) -> float:
    return float(np.sqrt(x))


def launches_per_cycle(plan: SpmdPlan) -> dict:
    """Kernel launches one cycle makes on the card, by kernel: per visit
    of a distributed level its sweeps, one fused residual-restriction (the
    junction level: one residual) and one prolongation; per visit of a
    replicated level the single-device engine's ops; the FAS junction adds
    ``apply_fas`` and ``subtract`` on the replicated level; the final
    norm-only residual and its finalize."""
    params = plan.params
    mode = params.mode
    nd, nlev = plan.n_dist, plan.nlev
    visits = level_visits(nlev, params.cycle_type)
    sweeps = params.pre_smoothing + params.post_smoothing
    v = kernels.variant
    fas = mode == Mode.NONLINEAR
    counts = {
        v("sweep_block", mode): sweeps * sum(visits[:nd]),
        v("residual_restrict_block", mode): sum(visits[:nd - 1]),
        v("residual_block", mode): visits[nd - 1] + 1,
        "prolong_add_block": sum(visits[:nd]),
        "finalize": 1,
        v("jacobi_sweep", mode): sweeps * sum(visits[nd:]),
        v("residual", mode): sum(visits[nd:nlev - 1]),
        "prolong_add": sum(visits[nd:nlev - 1]),
    }
    repl = sum(visits[nd:nlev - 1])
    if fas:
        counts.update(restrict=2 * repl, apply_fas=repl + visits[nd - 1],
                      subtract=repl + visits[nd - 1])
    else:
        counts["restrict_zero"] = repl
    return {k: n for k, n in counts.items() if n}


def build_spmd_solver(params: GridParams, mesh: Mesh,
                      cutoff: int = 4) -> SpmdEngine:
    """The per-leg engine of this rank (``build_spmd_solver``,
    ``gpusolve_tpu/dist/spmd.py:577`` with ``fuse="leg"`` and
    ``halo="ppermute"``, the forms ported)."""
    return SpmdEngine(params, mesh, cutoff)


def _engine(params, mesh, cutoff, plan) -> SpmdEngine:
    """The engine cached on ``plan`` when it was built for the same
    cycle, mesh and cutoff, else a new one, cached there."""
    eng = getattr(plan, "_engine", None)
    if (
        eng is not None and eng.key == _cycle_key(params)
        and eng.mesh == mesh and eng.cutoff == cutoff
    ):
        return eng
    eng = build_spmd_solver(params, mesh, cutoff)
    eng.plan._engine = eng
    return eng


def solve_spmd(
    params: GridParams, mesh: Mesh, cutoff: int = 4,
    state: Optional[GridState] = None, plan: Optional[SpmdPlan] = None,
    initial_residual: Optional[float] = None,
    check_every: int = 1,
    timer: Optional[Timer] = None,
) -> Tuple[GridState, List[float], SpmdPlan]:
    """The distributed solve, any mode (``gpusolve_tpu/dist/spmd.py:1746``).
    Returns ``(state, history, plan)``; the history is comparable with the
    single-device solver's.

    ``check_every=k`` runs k cycles per host sync and applies the stop test
    ``res <= initial / (1.0 / tol)`` between batches: the history records
    every cycle, and a solve may run up to k−1 cycles past the threshold,
    as in the JAX package."""
    eng = _engine(params, mesh, cutoff, plan)
    plan = eng.plan
    if state is None:
        state = eng.init_state()
    if timer is None and params.print_progress:
        timer = Timer()
    if initial_residual is None:
        initial = eng.residual_norm(state)
        history = [initial]
        if params.print_progress:
            print(f"Inital residual: {initial:.6g}")
    else:
        initial = float(initial_residual)
        history = []
    k = max(1, int(check_every))

    def _progress(i, res, ms):
        if params.print_progress:
            line = f"iter: {i} residual: {res:.6g} Took {ms}ms"
            if timer is not None:
                line += timer.suffix()
            print(line)

    done = 0
    while done < params.maxiter:
        t0 = time.perf_counter()
        n = k if k > 1 and done + k <= params.maxiter else 1
        sums = eng.run_cycles(state, n, timer)
        ms = (time.perf_counter() - t0) * 1000
        norms = [_sqrt(x) for x in sums]
        for res in norms:
            history.append(res)
            _progress(done, res, int(ms / n))
            done += 1
        if any(r <= initial / (1.0 / params.tol) for r in norms):
            break
    return state, history, plan


def gather_solution(state: GridState, plan: SpmdPlan, mesh: Mesh,
                    which: int = 0) -> np.ndarray:
    """The finest level's field ``which`` (0 v, 1 f, 2 the mode's third
    field: FAS rest_v, Newton ũ) of the whole mesh, as the padded
    ``(nx+2, ny+2, nz+2)`` numpy array, zero outside the interior; every
    rank gets it."""
    lvl = state.levels[0]
    third = lvl.newton_v if lvl.newton_v is not None else lvl.rest_v
    field = {0: lvl.v, 1: lvl.f, 2: third if third is not None else lvl.v}
    g = _Exchange(mesh, plan).assemble(field[which])
    nx, ny, nz = plan.dims[0]
    out = np.zeros((nx + 2, ny + 2, nz + 2),
                   dtype=str(g.dtype).removeprefix("torch."))
    out[1:nx + 1, 1:ny + 1, 1:nz + 1] = (
        g[1:nx + 1, 1:ny + 1, 1:nz + 1].cpu().numpy()
    )
    return out


def newton_solve_spmd(
    params: GridParams, mesh: Mesh, cutoff: int = 4,
    state: Optional[GridState] = None,
    newton_f: Optional[torch.Tensor] = None,
    initial_residual: Optional[float] = None,
    timer: Optional[Timer] = None,
    check_every: int = 1,
) -> Tuple[GridState, List[float], SpmdPlan]:
    """The distributed outer Newton iteration
    (``gpusolve_tpu/dist/spmd.py:2015``; reference
    src/cpu/NewtonSolver.cpp:10-44): per step, v zeroed on every level, ũ
    restricted to levels 1..L−2, an inner 10-cycle, tol-0.1 NEWTON solve,
    ũ += v, and F's norm.  The solution is level 0's ``newton_v``.

    ``newton_f``, the original RHS, is a tensor of its own (level 0's f
    holds F after each ``comp_f``), kept as ``plan.newton_f`` and
    ``state.newton_f``.  ``check_every`` batches the inner solve's cycles
    (``solve_spmd``)."""
    if params.mode != Mode.NEWTON:
        raise ValueError(
            f"newton_solve_spmd runs NEWTON mode, got {params.mode.name}"
        )
    eng = _engine(params, mesh, cutoff, None)
    plan = eng.plan
    if timer is None and params.print_progress:
        timer = Timer()
    if state is None:
        state = eng.init_state()
    if newton_f is not None:
        state = dataclasses.replace(state, newton_f=newton_f)
    elif state.newton_f is None:
        state = dataclasses.replace(state,
                                    newton_f=state.levels[0].f.clone())
    plan.newton_f = state.newton_f

    if initial_residual is None:
        initial = eng.comp_f(state, timer)
        history = [initial]
        if params.print_progress:
            print(f"Inital newton residual: {initial:.6g}")
        fn = initial
    else:
        initial = float(initial_residual)
        history = []
        fn = eng.comp_f(state, timer)  # resuming: level 0's f is stale

    inner = params.replace(maxiter=10, tol=0.1, print_progress=False)
    for i in range(params.maxiter):
        t0 = time.perf_counter()
        for lvl in state.levels:
            lvl.v.zero_()
        eng.restrict_newton_v(state)
        solve_spmd(inner, mesh, cutoff, state=state, plan=plan,
                   initial_residual=fn, check_every=check_every)
        lvl0 = state.levels[0]
        lvl0.newton_v.add_(lvl0.v)
        res = eng.comp_f(state, timer)
        fn = res
        history.append(res)
        if params.print_progress:
            ms = int((time.perf_counter() - t0) * 1000)
            line = f"newton iter: {i} residual: {res:.6g} Took {ms}ms"
            if timer is not None:
                line += timer.suffix()
            print(line)
        if res <= initial / (1.0 / params.tol):
            break
    return state, history, plan
