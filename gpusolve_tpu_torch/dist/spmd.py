"""Explicit-halo distributed multigrid engine, per-leg form, on
``torch.distributed``.

The counterpart of ``gpusolve_tpu/dist/spmd.py`` with ``fuse="leg"``, in
both of its plans: the classic plan, which distributes every level down to
the cutoff, and the replicated tail (``tail="auto"`` / ``"pv2"``, below).
Each process owns one block of every distributed
level; its neighbours' ghost faces and slabs arrive through
``dist.batch_isend_irecv`` (``halo="ppermute"``) or, for a leg's x slabs
with ``halo="rdma"``, through peer writes into this rank's receive
buffers (``ops/rdma.py``), norms sum with ``all_reduce``, and the
coarse levels below the distribution cutoff are gathered into a replicated
layout (``all_gather``) that every rank smooths redundantly.  All three
modes run: LINEAR, NONLINEAR (FAS tau correction, the up-leg ``v −
restV``) and NEWTON (the frozen ũ per level; the outer loop
``newton_solve_spmd``).

Layout (``SpmdPlan``):
  * the z mesh axis folds into the y data decomposition, so the data mesh
    is ``(mx, my·mz, 1)``: z is never split;
  * distributed levels (``l < n_dist``) use the mesh-aware halving
    allocation ``alloc``, so a fine block is twice a coarse one and the
    transfers stay shard-local; a block holds no halo, and its globally
    interior cells form the ``box`` every kernel writes (cells outside it
    stay zero);
  * replicated levels use the port's dense ``(n+2)³`` layout and run the
    single-device ops of ``ops/dispatch``: per-op kernels on the card, the
    plain ops elsewhere.

A distributed leg runs the trapezoid leg (``ops/spmd_leg.py``: all its
sweeps in one launch over ghost slabs exchanged once per leg) wherever the
plan's leg gates allow, as the JAX engine runs ``_trap_smooth``: the down
leg with the residual, its x/y/z restriction, the coarse mask and the FAS
tau in the kernel (``plan.fused_down_levels``), the up leg with the
prolongation first (``plan.fused_up_levels``), the finest up leg with the
cycle's norm.  Where a gate refuses, the leg runs per op.  On float32
CUDA tensors those ops are the four shard-local kernels of
``ops/spmd_kernels.py`` (sweep, residual and its norm, the residual with
its x/z restriction, the prolongation), with the glue between them plain
torch, as the JAX engine's is XLA: the y restriction and the lower-x
fix-up, the interior masks, the FAS tau.  Everywhere else (CPU tensors,
float64, ``backend="ref"``, ``local_backend="xla"``: the
``ops/dispatch.plain_reason`` policy) they are the plain ops over the
assembled block, its halo exchanged axis by axis so the edge and corner
ghosts arrive, as the JAX engine's ``_stencil_assembled`` path; on one
rank they round as the kernels do.  A stencil with edge or corner taps
always runs them, and neither kernels nor legs.  The gathers into the
replicated levels and Newton's restriction of ũ are glue everywhere.

The replicated tail (``_choose_tail_nd``, ``SpmdPlan(force_nd=...)``): a
shallow distributed prefix of ``nd`` levels whose junction legs feed one
batch-engine cycle (``ops/vcycle_batch.run_tail``) on the replicated
levels ``nd..``, rooted at the tail root, a dense ``(n+2)³`` level.  The
junction's down leg restricts straight into the root (FAS: R(v) into its
v and rest_v, with the tau folded in the leg), its up leg prolongs from
it (FAS: v − rest_v first, the ``subtract`` kernel in place).  On one rank
the junction's halved block is the root itself (``tail_in_place``); on a
larger mesh each rank's halved block is gathered into the root, and each
rank's window of it is cut back out.  A fresh LINEAR or NEWTON tail visit
starts from v = 0; a W or F cycle's second visit continues from the
first's state.  ``tail="auto"`` engages it where the engine runs the CUDA
kernels (float32 on a CUDA device, ``local_backend`` not "xla"), as the
JAX package engages it wherever Pallas runs natively; ``tail="pv2"``
forces it, on the plain ops too; ``tail="off"`` keeps the classic plan.

On a ``(1, 1, 1)`` mesh no collective is called; a missing neighbour's
ghosts are zeros, the Dirichlet boundary, as ``lax.ppermute`` leaves them.
With ``halo="rdma"`` the legs' slabs are the exchange kernel's zero fill
there, as the reference's kernel gives them on a 1×1×1 mesh.

``fuse="pod"`` runs the pod engine of ``dist/pod.py`` instead (its
``PodEngine`` keeps this engine's contract), through the same entry
points.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from gpusolve_tpu_torch.config import GridParams, Mode
from gpusolve_tpu_torch.dist.mesh import Mesh
from gpusolve_tpu_torch.grid import GridLevel, GridState, rhs_values, \
    torch_dtype
from gpusolve_tpu_torch.ops import dispatch as ops
from gpusolve_tpu_torch.ops import kernels, rdma, ref
from gpusolve_tpu_torch.ops import spmd_kernels as sk
from gpusolve_tpu_torch.ops import spmd_leg as sl
from gpusolve_tpu_torch.ops import vcycle_batch
from gpusolve_tpu_torch.solver.vcycle import v2_unsupported_reason
from gpusolve_tpu_torch.utils.timer import Timer

_SUBCYCLES = {"V": ("V",), "W": ("W", "W"), "F": ("F", "V")}


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class SpmdPlan:
    """Static decomposition plan: which levels are distributed, and the
    mesh-aware allocation and block shapes per level
    (``gpusolve_tpu/dist/spmd.py:125-206``).

    ``device_mesh`` is the process mesh; ``mesh_shape`` the data
    decomposition ``(mx, my·mz, 1)`` (the z mesh axis folds into y);
    ``names`` the mesh axes each data axis runs over.

    ``force_nd`` is the replicated tail's depth (``_choose_tail_nd``):
    ``n_dist = min(force_nd, n_dist)``, the halving allocation at that
    depth, and ``tail_pv2`` the tail root's layout, the dense ``(n+2)³`` of
    level ``n_dist`` (None in the classic plan).  The boundary block
    ``shape(n_dist)`` is the junction's halved block; ``tail_in_place``
    whether it is the root itself (one rank, the same layout)."""

    def __init__(self, params: GridParams, mesh_shape, cutoff: int = 4,
                 local_backend: str = "auto",
                 force_nd: Optional[int] = None):
        self.params = params
        self.local_backend = local_backend
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
        # Whether the legs' x slabs go through the rdma exchange: the
        # engine sets it (halo="rdma" without a y split).
        self.rdma_active = False
        self.n_dist = min(max(d, 1), nlev - 1) if all(
            dims[0][a] >= self.mesh_shape[a] for a in range(3)
        ) else 0
        if self.n_dist == 0:
            raise ValueError(
                f"grid {dims[0]} too small for mesh {self.mesh_shape}"
            )
        if force_nd is not None:
            self.n_dist = min(force_nd, self.n_dist)
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
        # Replicated levels (the tail root included): the port's dense
        # padded layout.
        self.alloc += [tuple(n + 2 for n in dims[l])
                       for l in range(self.n_dist, nlev)]
        self.block = [
            tuple(self.alloc[l][a] // self.mesh_shape[a] for a in range(3))
            for l in range(self.n_dist)
        ]
        self.dims = dims
        self.nlev = nlev
        self.tail_pv2 = None if force_nd is None else self.alloc[self.n_dist]
        self.tail_in_place = self.tail_pv2 is not None and boundary_in_place(
            self.mesh_shape, self.shape(self.n_dist), dims[self.n_dist]
        )
        # Which levels run the single-pass legs (``_trap_rr_ok`` /
        # ``_trap_corr_ok`` / ``_tail_up_ok``,
        # gpusolve_tpu/dist/spmd.py:942-991).
        self.fused_down_levels: Tuple[int, ...] = tuple(
            l for l in range(self.n_dist)
            if self.down_refusal(l, params.pre_smoothing) is None
        )
        self.fused_up_levels: Tuple[int, ...] = tuple(
            lc for lc in range(1, self.n_dist + 1)
            if self.up_refusal(lc, params.post_smoothing) is None
        )

    def shape(self, l: int) -> Tuple[int, int, int]:
        """The per-rank block of level ``l <= n_dist``; at ``n_dist`` the
        boundary block, the junction's halved block."""
        if l < self.n_dist:
            return self.block[l]
        return tuple(b // 2 for b in self.block[self.n_dist - 1])

    # The leg gates (``_trap_ok`` and its consumers' gates,
    # gpusolve_tpu/dist/spmd.py:816-991) in the port's layout: the
    # algorithm's conditions, without the TPU's tiling ones.  Each gives
    # the reason a leg cannot run, or None.

    def leg_refusal(self, l: int, S: int) -> Optional[str]:
        """Why distributed level ``l`` cannot run its ``S`` sweeps as one
        leg (``_trap_ok``)."""
        if self.local_backend == "xla":
            return 'local_backend="xla" runs the per-op path'
        if not _face_taps_only(self.params.stencil):
            return "the stencil has edge or corner taps"
        if l >= self.n_dist:
            return "a replicated level"
        if not 1 <= S <= sl.MAX_SWEEPS:
            return f"{S} sweeps (a leg takes 1..{sl.MAX_SWEEPS})"
        for ax, name in ((0, "x"), (1, "y")):
            if self.mesh_shape[ax] > 1 and self.block[l][ax] < sl.G:
                return (f"block {self.block[l]} is shorter than the "
                        f"{sl.G}-deep slab along {name}")
        return None

    def down_refusal(self, l: int, S: int) -> Optional[str]:
        """Why level ``l``'s down leg cannot run as one leg with the
        restriction (``_trap_rr_ok``); the junction's leg restricts into
        the tail root, so the classic plan runs its junction per op."""
        if l + 1 >= self.n_dist and self.tail_pv2 is None:
            return "the junction: the classic plan (tail='off') gathers it " \
                   "per op"
        return self.leg_refusal(l, S)

    def up_refusal(self, lc: int, S: int) -> Optional[str]:
        """Why the up leg into level ``lc − 1`` cannot run as one leg with
        the prolongation first (``_trap_corr_ok``; at the junction
        ``_tail_up_ok``, the boundary block as the coarse one)."""
        if lc >= self.n_dist and self.tail_pv2 is None:
            return "the junction: the classic plan (tail='off') prolongs " \
                   "it per op"
        why = self.leg_refusal(lc - 1, S)
        if why is not None:
            return why
        if S > sl.MAX_CORR_SWEEPS:
            return f"{S} sweeps (the corr-first leg takes 1..4)"
        for ax, name in ((0, "x"), (1, "y")):
            if self.mesh_shape[ax] > 1 and self.shape(lc)[ax] < sl.GC:
                return (f"coarse block {self.shape(lc)} is shorter than "
                        f"the {sl.GC}-deep slab along {name}")
        return None

    # The cycle's schedule, which the engine runs and launches_per_cycle
    # counts.

    def visits(self, kind: str, i: int = 0, fresh: bool = False):
        """The ``kind`` cycle from level ``i``, visit by visit, as ``(step,
        l, fresh, kind)``: ``("down", l, ...)``, ``("coarsest", l, ...)``,
        ``("up", lc, False, ...)`` and, with the replicated tail, ``("tail",
        n_dist, fresh, kind)``: one ``kind`` cycle of the batch engine on
        the levels from ``n_dist``.  ``fresh`` marks a first visit after the
        parent's restriction (v is the zero it wrote)."""
        if i == self.n_dist and self.tail_pv2 is not None:
            yield "tail", i, fresh, kind
            return
        if i == self.nlev - 1:
            yield "coarsest", i, fresh, kind
            return
        yield "down", i, fresh, kind
        for j, sub in enumerate(_SUBCYCLES[kind]):
            yield from self.visits(sub, i + 1, j == 0)
        yield "up", i + 1, False, kind

    def down_form(self, l: int) -> str:
        """How level ``l``'s down leg runs: "leg" (one leg with the
        restriction; at the junction into the tail root), "ops" (its
        smoothing, then the residual with the restriction), "junction"
        (the same into the replicated level) or "replicated"."""
        if l >= self.n_dist:
            return "replicated"
        if l in self.fused_down_levels:
            return "leg"
        return "junction" if l + 1 == self.n_dist else "ops"

    def up_form(self, lc: int) -> str:
        """How the up leg into level ``lc − 1`` runs: "leg" (one leg with
        the prolongation first), "ops" (the prolongation, then its
        smoothing) or "replicated"."""
        if lc > self.n_dist:
            return "replicated"
        return "leg" if lc in self.fused_up_levels else "ops"

    def smooth_leg(self, l: int, S: int) -> bool:
        """Whether level ``l`` runs ``S`` sweeps as one leg, else one op a
        sweep."""
        return self.leg_refusal(l, S) is None

    def norm_in_leg(self) -> bool:
        """Whether the finest up leg gives the cycle's Σr² (else a norm
        pass follows the cycle)."""
        return self.smooth_leg(0, self.params.post_smoothing)

    def data_coords(self, coords) -> Tuple[int, int]:
        """The (x, y) block coordinates of mesh coordinates ``coords``."""
        return coords[0], coords[1] * self.device_mesh[2] + coords[2]

    def box(self, l: int, coords) -> sk.Box:
        """Inclusive local bounds of the globally interior cells of the
        block at mesh ``coords`` on level ``l <= n_dist`` (``shape(l)``)."""
        dc = self.data_coords(coords) + (0,)
        out = []
        for ax in range(3):
            b = self.shape(l)[ax]
            start = dc[ax] * b
            out += [max(0, 1 - start), min(b - 1, self.dims[l][ax] - start)]
        return tuple(out)


def boundary_in_place(mesh_shape, boundary, root_dims) -> bool:
    """Whether the tail runs in place on the boundary block (the per-leg
    engine's junction halved block, the pod engine's level-``npod``
    block): one rank, and the block has the root's ``(n+2)³`` layout.
    Otherwise each rank's boundary block is a buffer of its own, gathered
    into the root after the down legs and cut back out before the up
    legs."""
    return mesh_shape[0] * mesh_shape[1] == 1 and \
        tuple(boundary) == tuple(n + 2 for n in root_dims)


def _junction_kinds(cycle_type: str, depth: int):
    """Cycle kinds that can reach level ``depth`` from a root schedule
    (``gpusolve_tpu/dist/spmd.py:503``)."""
    kinds = {cycle_type}
    for _ in range(depth):
        kinds = {k2 for k in kinds for k2 in _SUBCYCLES[k]}
    return kinds


def _choose_tail_nd(params: GridParams, dev_mesh_shape, cutoff: int,
                    default_nd: int) -> Optional[int]:
    """The replicated tail's depth for the per-leg engine
    (``gpusolve_tpu/dist/spmd.py:513-574``): a shallow distributed prefix
    feeding one batch-engine cycle on the replicated rest, the leg-engine
    analogue of the pod engine's tail.

    The depth of least streamed volume a rank, costed on the port's dense
    volumes: twice each distributed block (a down and an up leg) and twice
    each tail level's ``(n+2)³`` (the tail runs on every rank).  Depths
    ``1..min(default_nd, nlev − 2)`` are tried; a depth is skipped where
    the batch engine refuses a cycle kind that reaches the tail
    (``solver/vcycle.v2_unsupported_reason``: V(6,6) keeps the classic
    plan) or where the plan cannot distribute that deep.  None when no
    depth is left.  The reference's lane-starvation bound (z < 127 is a
    TPU lane rule) and its TPU tiling granularity are not ported.

    At 511³, V(3,3), cutoff 4 (millions of cells by depth):

      mesh      depth 1  depth 2  depth 3  chosen  classic plan
      (1,1,1)    310.47   314.05   321.39     1        7
      (2,1,1)    175.20   160.69   163.48     2        6
      (4,1,1)    107.57    84.00    84.52     2        5
      (2,2,1)    107.30    83.41    83.31     3        6

    On one rank depth 1's 514³ block against depth 2's 516³ + 258³ decides;
    on a split mesh the tail's 2·19.4 M cells, paid whole on every rank,
    outweigh the deeper blocks' rounding; (2,2,1) is a near tie.  The JAX
    package picks 1, 2, 2 and 2 (its costs count 128-lane z extents).
    """
    dims = params.level_dims()
    nlev = len(dims)
    best = None
    for nd in range(1, min(default_nd, nlev - 2) + 1):
        tail_p = params.replace(grid_dim=dims[nd])
        if any(
            v2_unsupported_reason(tail_p.replace(cycle_type=k)) is not None
            for k in _junction_kinds(params.cycle_type, nd)
        ):
            continue
        try:
            trial = SpmdPlan(params, dev_mesh_shape, cutoff, force_nd=nd)
        except ValueError:
            continue
        if trial.n_dist != nd:
            continue
        cost = 2 * sum(math.prod(b) for b in trial.block) + 2 * sum(
            math.prod(n + 2 for n in dims[l]) for l in range(nd, nlev)
        )
        if best is None or cost < best[1]:
            best = (nd, cost)
    return best[0] if best else None


def tail_depth(params: GridParams, mesh_shape, cutoff: int,
               local_backend: str, tail: str, device) -> Optional[int]:
    """The replicated tail's depth for this engine, or None for the
    classic plan (``_build_spmd_solver``, gpusolve_tpu/dist/spmd.py:633-
    660): float32 and ``local_backend`` not "xla"; ``tail="auto"`` also
    needs the CUDA kernels (``ops.plain_reason`` None: a CUDA device, not
    ``backend="ref"``), ``"pv2"`` forces it on the plain ops too; then
    ``_choose_tail_nd``'s depth, if any."""
    if tail == "off" or params.dtype != "float32" or local_backend == "xla":
        return None
    if tail == "auto" and \
            ops.plain_reason(params, device, params.dtype) is not None:
        return None
    classic = SpmdPlan(params, mesh_shape, cutoff, local_backend)
    return _choose_tail_nd(params, mesh_shape, cutoff, classic.n_dist)


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


LOCAL_BACKENDS = ("auto", "pallas", "xla")


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
        # The peer-memory registries (ops/rdma.py, ops/pod.py), released
        # by close().
        self.rdma = {}
        # Gloo carries no CUDA tensor point to point or in a gather: ranks
        # that share one card over a gloo group send host copies.
        self.staged = (mesh.size > 1 and mesh.device.type == "cuda"
                       and dist.get_backend(mesh.group) == "gloo")

    def neighbour(self, ax: int, step: int) -> Optional[int]:
        """The mesh rank ``step`` along data axis ``ax`` (0 x, 1 the
        folded y), or None past the mesh's edge."""
        c = list(self.dc)
        c[ax] += step
        if not 0 <= c[ax] < self.plan.mesh_shape[ax]:
            return None
        mz = self.plan.device_mesh[2]
        return self.mesh.rank_of((c[0], c[1] // mz, c[1] % mz))

    def _peer(self, ax: int, step: int) -> Optional[int]:
        nb = self.neighbour(ax, step)
        return None if nb is None else self.mesh.global_rank(nb)

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
                t = t.cpu().contiguous() if self.staged else t.contiguous()
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
            if self.staged:
                got = [None if g is None else g.to(self.mesh.device)
                       for g in got]
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

    def slabs(self, u: torch.Tensor, g: int):
        """A leg's ghost slabs of block ``u``, ``g`` deep: ``(xlo, xhi,
        ylo, yhi)`` (``_slabs_multi``, gpusolve_tpu/dist/spmd.py:870-908);
        None on a one-rank mesh, whose ghosts are all zero.  Under a y
        split the exchange is two-stage: the y slabs first, then the x
        slabs of the y-extended block, so the diagonal neighbours' corner
        rows arrive; else ``ylo`` and ``yhi`` are None."""
        if self.mesh.size == 1:
            return None
        if self.plan.mesh_shape[1] == 1:
            xlo, xhi = self.swap(0, u[-g:], u[:g])
            return xlo, xhi, None, None
        ylo, yhi = self.swap(1, u[:, -g:], u[:, :g])
        xlo, xhi = self.swap(
            0, torch.cat([ylo[-g:], u[-g:], yhi[-g:]], dim=1),
            torch.cat([ylo[:g], u[:g], yhi[:g]], dim=1),
        )
        return xlo, xhi, ylo, yhi

    def close(self) -> None:
        """Releases the rdma exchange's buffers (collective on a
        multi-rank mesh)."""
        rdma.close(self)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        if self.staged:
            host = t.cpu()
            dist.all_reduce(host, group=self.mesh.group)
            t.copy_(host)
        elif self.mesh.size > 1:
            dist.all_reduce(t, group=self.mesh.group)
        return t

    def assemble(self, block: torch.Tensor) -> torch.Tensor:
        """The blocks of every rank placed by their data coordinates:
        ``(mx·bx, MY·by, bz)``."""
        if self.mesh.size == 1:
            return block
        sent = block.cpu().contiguous() if self.staged else \
            block.contiguous()
        parts = [torch.empty_like(sent) for _ in range(self.mesh.size)]
        dist.all_gather(parts, sent, group=self.mesh.group)
        if self.staged:
            parts = [t.to(self.mesh.device) for t in parts]
        bx, by, bz = block.shape
        mx, my = self.plan.mesh_shape[:2]
        out = block.new_zeros((mx * bx, my * by, bz))
        for rank, part in enumerate(parts):
            dx, dy = self.plan.data_coords(self.mesh.coords_of(rank))
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
    (``gpusolve_tpu/dist/spmd.py:378``); along x, z, then y, the order of
    the fused residual-restriction kernel and its y glue, so on one rank
    the two round alike."""
    out = asm
    for ax in (0, 2, 1):
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

    def __init__(self, params: GridParams, mesh: Mesh, cutoff: int = 4,
                 local_backend: str = "auto",
                 plan: Optional[SpmdPlan] = None, halo: str = "ppermute",
                 tail: str = "auto"):
        self.key = _cycle_key(params)
        self.local_backend = local_backend
        self.halo = halo
        self.tail = tail
        self.mesh = mesh
        self.cutoff = cutoff
        if plan is None:
            plan = SpmdPlan(
                params, mesh.shape, cutoff, local_backend,
                force_nd=tail_depth(params, mesh.shape, cutoff,
                                    local_backend, tail, mesh.device),
            )
        self.plan = plan
        # The x-slab exchange in one kernel (the JAX engine's use_rdma,
        # gpusolve_tpu/dist/spmd.py:854-855): x slabs only, so not under a
        # y split, where the two-stage exchange runs.
        self.plan.rdma_active = halo == "rdma" and self.plan.mesh_shape[1] == 1
        self.dtype = torch_dtype(params.dtype)
        self.device = mesh.device
        self.ex = _Exchange(mesh, self.plan)
        self.face_taps = _face_taps_only(params.stencil)
        # Why the distributed levels run the plain versions, or None (the
        # kernels).  "xla" runs every op plain, the replicated levels too.
        self.plain_reason = ops.plain_reason(params, self.device, self.dtype)
        if local_backend == "xla":
            params = params.replace(backend="ref")
            self.plain_reason = 'local_backend="xla"'
        elif not self.face_taps and self.plain_reason is None:
            self.plain_reason = (
                "the stencil has edge or corner taps: plain ops over the "
                "assembled block"
            )
        self.params = params
        p = self.plan
        self.nd, self.nlev = p.n_dist, p.nlev
        self.hs = [params.level_h(l) for l in range(self.nlev)]
        # Levels 0..nd: the distributed blocks and the boundary block.
        self.boxes = [p.box(l, mesh.coords) for l in range(self.nd + 1)]
        dx, dy = self.ex.dc
        self.globs = [
            (dx * p.shape(l)[0], p.dims[l][0], dy * p.shape(l)[1],
             p.dims[l][1])
            for l in range(self.nd + 1)
        ]
        self.fas = params.mode == Mode.NONLINEAR
        self.newton = params.mode == Mode.NEWTON
        self._xz = {}
        self._bnd = None  # the boundary block's buffers, where not in place
        # The replicated tail's batch-engine parameters per cycle kind.
        self.tail_params = {
            k: params.replace(grid_dim=p.dims[self.nd], cycle_type=k)
            for k in _junction_kinds(params.cycle_type, self.nd)
        } if p.tail_pv2 is not None else {}

    def _xz_buffers(self, l: int):
        """The per-op fused restriction's outputs on level ``l``, made on
        first use (a level whose down leg runs fused never needs them):
        zeroed once, each launch writes the same cells."""
        if l not in self._xz:
            bx, by, _ = self.plan.block[l]
            cbz = self.plan.block[l + 1][2]

            def z(*shape):
                return torch.zeros(shape, dtype=self.dtype,
                                   device=self.device)

            self._xz[l] = (z(bx // 2, by, cbz), z(by, cbz),
                           z(bx // 2, by, cbz) if self.fas else None)
        return self._xz[l]

    # -- the boundary block (the tail's root) ------------------------------

    def _boundary(self):
        """The boundary block's own buffers (f, v, rest_v), made on first
        use: zero, so the cells no leg writes stay zero."""
        if self._bnd is None:
            shape = self.plan.shape(self.nd)
            self._bnd = [
                torch.zeros(shape, dtype=self.dtype, device=self.device)
                for _ in range(3 if self.fas else 1)
            ]
        return self._bnd

    def _root_outputs(self, root: GridLevel) -> tuple:
        """Where the junction's down leg writes (f; FAS also v, rest_v):
        the tail root itself where the tail runs in place, else the
        boundary buffers."""
        if self.plan.tail_in_place:
            return (root.f, root.v, root.rest_v) if self.fas else \
                (root.f, None, None)
        bnd = self._boundary()
        return tuple(bnd) if self.fas else (bnd[0], None, None)

    def _gather_root(self, root: GridLevel) -> None:
        """Every rank's boundary outputs gathered into the tail root,
        zero outside its interior; nothing where the tail is in place."""
        if self.plan.tail_in_place:
            return
        bnd = [self._to_repl(t) for t in self._boundary()]
        root.f = bnd[0]
        if self.fas:
            root.v, root.rest_v = bnd[1], bnd[2]

    def _root_coarse(self, root: GridLevel) -> torch.Tensor:
        """The junction's up leg's coarse block: the tail root's v (FAS:
        v − rest_v already) where the tail is in place, else this rank's
        window of it, in the boundary f buffer."""
        if self.plan.tail_in_place:
            return root.v
        coarse = self._boundary()[0]
        dx, dy = self.ex.dc
        b = self.plan.shape(self.nd)
        coarse.copy_(_window(root.v, (dx * b[0], dy * b[1], 0), b))
        return coarse

    # -- op choice ---------------------------------------------------------

    def _op(self, kernel, plain):
        return plain if self.plain_reason is not None else kernel

    def _finalize(self, partials, out):
        self._op(kernels.finalize, kernels.finalize_plain)(partials, out)

    def close(self) -> None:
        """Releases the buffers the engine holds outside the state (the
        rdma exchange's; collective on a multi-rank mesh)."""
        self.ex.close()

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
        sl_ = sk.box_slices(self.boxes[l])
        out[sl_] = x[sl_]
        return out

    def _av_assembled(self, l: int, v: torch.Tensor, h: float):
        """``A·v/h²`` over level ``l``'s box from the assembled block (its
        halo exchanged axis by axis, so edge and corner ghosts arrive):
        the JAX engine's ``_stencil_assembled`` (:346).  None for an empty
        box, after the exchange, which every rank joins."""
        asm = self.ex.halo(v)
        box = self.boxes[l]
        if sk.box_empty(box):
            return None
        x0, x1, y0, y1, z0, z1 = box
        return ref.stencil_apply(asm[x0:x1 + 3, y0:y1 + 3, z0:z1 + 3],
                                 sk.box_dims(box), self.params.stencil,
                                 1.0 / (h * h))

    def _nv_box(self, l: int, newton_v):
        if newton_v is None or not self.newton:
            return None
        return newton_v[sk.box_slices(self.boxes[l])]

    def _sweeps(self, l: int, lvl: GridLevel, n_iter: int) -> None:
        """``n_iter`` sweeps, one op each: the kernel on the ghost faces,
        or the plain op over the assembled block."""
        box, h = self.boxes[l], self.hs[l]
        for _ in range(n_iter):
            if self.plain_reason is None:
                sk.sweep_block(lvl.r, lvl.v, lvl.f, self.ex.faces(lvl.v), box,
                               self.params, h, lvl.newton_v)
            else:
                av = self._av_assembled(l, lvl.v, h)
                if av is not None:
                    s = sk.box_slices(box)
                    lvl.r[s] = ref.sweep_point(
                        self.params, h, av, lvl.v[s], lvl.f[s],
                        self._nv_box(l, lvl.newton_v),
                    )
            lvl.v, lvl.r = lvl.r, lvl.v

    def _residual(self, l: int, r_out, v, f, newton_v=None, *,
                  params: Optional[GridParams] = None, write_r=True,
                  with_norm=False):
        """The residual of level ``l``'s block (``params`` default the
        engine's; Newton's comp_f passes FAS ones), its norm partials when
        ``with_norm``: the kernel on the ghost faces, or the plain op over
        the assembled block (one float64 Σr²)."""
        prm = params or self.params
        box, h = self.boxes[l], self.hs[l]
        if self.plain_reason is None:
            return sk.residual_block(
                r_out, v, f, self.ex.faces(v), box, prm, h, write_r=write_r,
                with_norm=with_norm, newton_v=newton_v,
            )
        av = self._av_assembled(l, v, h)
        if av is None:
            return v.new_zeros(1, dtype=torch.float64) if with_norm else None
        s = sk.box_slices(box)
        nv = newton_v[s] if prm.mode == Mode.NEWTON else None
        r = ref.residual_point(prm, av, v[s], f[s], nv)
        if write_r:
            r_out[s] = r
        if not with_norm:
            return None
        r64 = r.to(torch.float64)
        return torch.sum(r64 * r64).reshape(1)

    def _fas_tau(self, l: int, f: torch.Tensor, rv: torch.Tensor) -> None:
        """``f += A·rv/h² + γ·rv·e^{rv}`` over level ``l``'s box: the FAS
        tau correction f_c = R(r) + A_c(R v) (``_finish_restrict``)."""
        av = self._av_assembled(l, rv, self.hs[l])
        if av is not None:
            s = sk.box_slices(self.boxes[l])
            rb = rv[s]
            f[s] += av + self.params.gamma * rb * torch.exp(rb)

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
        s = tuple(slice(1, d + 1) for d in n)
        out[s] = g[s]
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

    def _leg(self, l: int, lvl: GridLevel, S: int, *, src_zero=False,
             coarse=None, **kw):
        """One trapezoid leg of ``S`` sweeps on level ``l``'s block into
        its spare buffer, the ghost slabs exchanged once (with
        ``plan.rdma_active`` one exchange call for the leg's fields and one
        for the coarse block, on one rank too, as the reference); returns
        the consumer's norm partials or None."""
        slabs = None
        fields = {"f": lvl.f}
        if not src_zero:
            fields["v"] = lvl.v
        if self.newton:
            fields["nv"] = lvl.newton_v
        if self.plan.rdma_active:
            exchange = self._op(rdma.rdma_exchange, rdma.rdma_exchange_plain)
            slabs = dict(zip(fields, exchange(list(fields.values()),
                                              self.ex, sl.G)))
            if coarse is not None:
                coarse = (coarse, exchange([coarse], self.ex, sl.GC)[0])
        else:
            if self.mesh.size > 1:
                slabs = {name: self.ex.slabs(u, sl.G)
                         for name, u in fields.items()}
            if coarse is not None:
                coarse = (coarse, self.ex.slabs(coarse, sl.GC))
        out = self._op(sl.leg_block, sl.leg_block_plain)(
            lvl.r, lvl.v, lvl.f, slabs, self.boxes[l], self.globs[l],
            self.params, self.hs[l], S, newton_v=lvl.newton_v,
            src_zero=src_zero, coarse=coarse, **kw,
        )
        lvl.v, lvl.r = lvl.r, lvl.v
        return out

    def _smooth(self, l: int, lvl: GridLevel, n_iter: int, norm=None):
        """Damped Jacobi on a distributed level: one leg where the gate
        allows (the JAX engine's ``_smooth``; ``norm`` its consumer), else
        one op a sweep.  Returns the leg's norm partials or None."""
        if self.plan.smooth_leg(l, n_iter):
            return self._leg(l, lvl, n_iter, consumer=norm)
        self._sweeps(l, lvl, n_iter)
        return None

    def _down(self, l: int, levels, fresh: bool) -> None:
        """Level ``l``'s down leg in the plan's ``down_form``."""
        form = self.plan.down_form(l)
        if form == "replicated":
            self._down_repl(l, levels)
            return
        prm = self.params
        lvl, nxt = levels[l], levels[l + 1]
        junction = l + 1 == self.nd
        if form == "leg":
            # Sweeps, residual, x/y/z restriction, coarse mask and FAS tau
            # in one leg; a fresh LINEAR/NEWTON visit starts from v = 0.
            # The junction's leg writes the tail root (or the boundary
            # buffers, then gathered into it).
            if junction:
                cout = self._root_outputs(nxt)
            else:
                cout = (nxt.f, nxt.v, nxt.rest_v) if self.fas else \
                    (nxt.f, None, None)
            self._leg(
                l, lvl, prm.pre_smoothing,
                src_zero=l > 0 and fresh and not self.fas,
                consumer="restrict", cout=cout,
                cbox=self.boxes[l + 1], cdims=self.plan.dims[l + 1],
                tau_h=self.hs[l + 1] if self.fas else 0.0,
            )
            if junction:
                # LINEAR/NEWTON leave the root's v to the tail's zero
                # start.
                self._gather_root(nxt)
            elif not self.fas and self.plan.down_form(l + 1) != "leg":
                nxt.v.zero_()  # a child leg from v = 0 reads no v
            return
        self._smooth(l, lvl, prm.pre_smoothing)
        if form == "ops" and self.plain_reason is None:
            # The fused x/z restriction kernel, then the y restriction and
            # the lower-x fix-up as glue.
            xzr, rlast, xzv = self._xz_buffers(l)
            sk.residual_restrict_block(
                xzr, rlast, xzv, lvl.v, lvl.f, self.ex.faces(lvl.v),
                self.boxes[l], prm, self.hs[l], self.plan.dims[l + 1][2],
                lvl.newton_v,
            )
            f_next = self._mask(
                l + 1, self._y_restrict(self._fix_x0(xzr, rlast), l + 1)
            )
            rv = self._mask(l + 1, self._y_restrict(xzv, l + 1)) \
                if self.fas else None
        else:
            # The residual, then the plain restriction of the assembled
            # residual (and v); at the junction into the replicated level.
            self._residual(l, lvl.r, lvl.v, lvl.f, lvl.newton_v)
            if form == "junction":
                cb = tuple(b // 2 for b in self.plan.block[l])
                place = self._to_repl
            else:
                cb = self.plan.block[l + 1]
                place = functools.partial(self._mask, l + 1)
            f_next = place(_restrict_local(self.ex.halo(lvl.r), cb))
            rv = place(_restrict_local(self.ex.halo(lvl.v), cb)) \
                if self.fas else None
        nxt.f = f_next
        if not self.fas:
            nxt.v.zero_()
            return
        nxt.v, nxt.rest_v = rv, rv.clone()
        if form == "junction":
            ops.apply_fas_op(nxt.f, nxt.v, self.plan.dims[l + 1], prm,
                             self.hs[l + 1])
        else:
            self._fas_tau(l + 1, nxt.f, rv)

    def _up(self, lc: int, levels) -> Optional[torch.Tensor]:
        """The up leg into level ``lc − 1`` in the plan's ``up_form``;
        returns the finest level's norm partials when its leg produced
        them."""
        form = self.plan.up_form(lc)
        if form == "replicated":
            self._up_repl(lc, levels)
            return None
        lf = lc - 1
        lvl, c = levels[lf], levels[lc]
        post = self.params.post_smoothing
        norm = "norm" if lf == 0 else None
        if form == "leg" and lc == self.nd:
            # The junction's up leg from the tail root; FAS first forms
            # v − rest_v there, in place.
            if self.fas:
                ops.subtract_op(c.v, c.rest_v, self.plan.dims[lc],
                                self.params)
            return self._leg(lf, lvl, post, coarse=self._root_coarse(c),
                             consumer=norm)
        if form == "leg":
            vc = c.v - c.rest_v if self.fas else c.v
            return self._leg(lf, lvl, post, coarse=vc, consumer=norm)
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
        return self._smooth(lf, lvl, post, norm)

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

    # -- cycles and norms ----------------------------------------------------

    def norm_sumsq(self, state: GridState, out: torch.Tensor) -> None:
        """This rank's Σr² of the finest level into ``out`` (one element;
        the caller sums over the ranks)."""
        lvl = state.levels[0]
        partials = self._residual(0, None, lvl.v, lvl.f, lvl.newton_v,
                                  write_r=False, with_norm=True)
        self._finalize(partials, out)

    def cycle(self, state: GridState, out: torch.Tensor) -> None:
        """One cycle of ``params.cycle_type`` on ``state`` in place, and
        this rank's finest-level Σr² after it into ``out``: from the
        finest up leg where it ran one, else a norm pass."""
        levels, prm = list(state.levels), self.params
        partials = None
        for step, l, fresh, kind in self.plan.visits(prm.cycle_type):
            if step == "down":
                self._down(l, levels, fresh)
            elif step == "up":
                partials = self._up(l, levels)
            elif step == "tail":
                # One batch-engine cycle on the replicated levels; a fresh
                # LINEAR/NEWTON visit starts from v = 0, a W/F second
                # visit continues from the first's state.
                vcycle_batch.run_tail(
                    levels[l:], self.tail_params[kind], 1,
                    zero_start=fresh and not self.fas,
                )
            else:
                self._smooth_repl(l, levels[l],
                                  prm.pre_smoothing + prm.post_smoothing)
        if partials is None:
            self.norm_sumsq(state, out)
        else:
            self._finalize(partials, out)

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
        partials = self._residual(0, lvl.f, lvl.newton_v, state.newton_f,
                                  params=p_fas, with_norm=True)
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
    """Kernel launches one cycle makes on the card, by kernel: the plan's
    visits in the forms the engine runs them.  A leg is one ``leg_block``
    launch (the junction's up leg in FAS after a ``subtract``); a per-op
    smoothing its sweeps; a per-op down leg adds one fused
    residual-restriction, the junction one residual (FAS: and
    ``apply_fas``); a per-op up leg one prolongation (at the FAS junction
    after a ``subtract``); a replicated level runs the single-device
    engine's ops; a tail visit one cycle of the batch engine without its
    norm (``vcycle_batch.launches_per_cycle``); the cycle ends with a
    norm-only residual unless the finest up leg gave the norm, and a
    finalize.  With ``plan.rdma_active`` each leg adds one
    ``rdma_exchange`` (the corr-first leg two: its fields and its coarse
    block).  Counts the face-tap kernel path (plain runs launch none)."""
    params = plan.params
    mode = params.mode
    pre, post = params.pre_smoothing, params.post_smoothing
    fas = mode == Mode.NONLINEAR
    v = kernels.variant
    counts = {}

    def add(name, n=1):
        counts[name] = counts.get(name, 0) + n

    def leg(corr=False):
        add(v("leg_block", mode))
        if plan.rdma_active:
            add("rdma_exchange", 2 if corr else 1)

    def smooth(l, S):
        if plan.smooth_leg(l, S):
            leg()
        else:
            add(v("sweep_block", mode), S)

    for step, l, _, kind in plan.visits(params.cycle_type):
        if step == "coarsest":
            add(v("jacobi_sweep", mode), pre + post)
            continue
        if step == "tail":
            tail = params.replace(grid_dim=plan.dims[l], cycle_type=kind)
            for name, n in vcycle_batch.launches_per_cycle(
                tail, norm=False
            ).items():
                add(name, n)
            continue
        form = plan.down_form(l) if step == "down" else plan.up_form(l)
        if form == "leg":
            if step == "up" and l == plan.n_dist and fas:
                add("subtract")
            leg(corr=step == "up")
        elif step == "down" and form == "replicated":
            add(v("jacobi_sweep", mode), pre)
            add(v("residual", mode))
            if fas:
                add("restrict", 2)
                add("apply_fas")
            else:
                add("restrict_zero")
        elif step == "down":
            smooth(l, pre)
            if form == "ops":
                add(v("residual_restrict_block", mode))
            else:
                add(v("residual_block", mode))
                if fas:
                    add("apply_fas")
        elif form == "replicated":
            if fas:
                add("subtract")
            add("prolong_add")
            add(v("jacobi_sweep", mode), post)
        else:
            if l == plan.n_dist and fas:
                add("subtract")
            add("prolong_add_block")
            smooth(l - 1, post)
    if not plan.norm_in_leg():
        add(v("residual_block", mode))
    add("finalize")
    return {k: n for k, n in counts.items() if n}


def _check_options(local_backend: str, halo: str, fuse: str,
                   tail: str) -> None:
    """The reference's ``ValueError`` for an unknown value
    (gpusolve_tpu/dist/spmd.py:598-606)."""
    if fuse not in ("leg", "pod"):
        raise ValueError(f"fuse must be 'leg' or 'pod', got {fuse!r}")
    if halo not in ("ppermute", "rdma"):
        raise ValueError(f"halo must be 'ppermute' or 'rdma', got {halo!r}")
    if tail not in ("auto", "pv2", "off"):
        raise ValueError(f"tail must be 'auto', 'pv2' or 'off', got {tail!r}")
    if local_backend not in LOCAL_BACKENDS:
        raise ValueError(
            f"local_backend must be one of {', '.join(LOCAL_BACKENDS)}, got "
            f"{local_backend!r}"
        )


def build_spmd_solver(params: GridParams, mesh: Mesh, cutoff: int = 4,
                      local_backend: str = "auto", halo: str = "ppermute",
                      fuse: str = "leg", tail: str = "auto") -> SpmdEngine:
    """The engine of this rank (``build_spmd_solver``,
    ``gpusolve_tpu/dist/spmd.py:577``): the per-leg engine, or with
    ``fuse="pod"`` the pod engine (``dist/pod.py``, which takes neither
    ``local_backend``, ``halo`` nor ``tail``, as the reference's).
    ``local_backend``: "auto" and "pallas" run the kernels and the legs
    where the gates allow, "xla" the per-op path on plain ops.
    ``halo``: "ppermute" (point-to-point messages) or "rdma" (the legs' x
    slabs through ``ops/rdma.py``'s peer writes; under a y split the
    two-stage exchange runs and ``plan.rdma_active`` is False).
    ``tail``: "auto" (the replicated tail where the CUDA kernels run),
    "pv2" (the replicated tail, on the plain ops too) or "off" (the
    classic plan); see ``tail_depth``."""
    _check_options(local_backend, halo, fuse, tail)
    return _engine(params, mesh, cutoff, None, local_backend, fuse, halo,
                   tail)


def _engine(params, mesh, cutoff, plan, local_backend,
            fuse="leg", halo="ppermute", tail="auto") -> SpmdEngine:
    """The engine cached on ``plan`` when it was built for the same
    cycle, mesh, cutoff, local backend, engine, halo and tail, else a new
    one, cached there.  A pod plan passed in gives the pod engine its
    depth; the pod engine takes no halo and no tail."""
    from gpusolve_tpu_torch.dist.pod import PodEngine, PodPlan

    eng = getattr(plan, "_engine", None)
    if (
        eng is not None and eng.key == _cycle_key(params)
        and eng.mesh == mesh and eng.cutoff == cutoff
        and eng.local_backend == local_backend
        and isinstance(eng, PodEngine) == (fuse == "pod")
        and (fuse == "pod" or (eng.halo, eng.tail) == (halo, tail))
    ):
        return eng
    if fuse == "pod":
        npod = plan.npod if isinstance(plan, PodPlan) else None
        eng = PodEngine(params, mesh, cutoff, local_backend, npod)
    else:
        eng = SpmdEngine(params, mesh, cutoff, local_backend, halo=halo,
                         tail=tail)
    eng.plan._engine = eng
    return eng


def solve_spmd(
    params: GridParams, mesh: Mesh, cutoff: int = 4,
    state: Optional[GridState] = None, plan: Optional[SpmdPlan] = None,
    initial_residual: Optional[float] = None,
    local_backend: str = "auto",
    check_every: int = 1,
    halo: str = "ppermute",
    fuse: str = "leg",
    timer: Optional[Timer] = None,
    tail: str = "auto",
) -> Tuple[GridState, List[float], SpmdPlan]:
    """The distributed solve, any mode (``gpusolve_tpu/dist/spmd.py:1746``),
    on the per-leg engine or with ``fuse="pod"`` the pod engine (a pod
    ``plan`` gives its depth).  Returns ``(state, history, plan)``; the
    history is comparable with the single-device solver's.

    ``check_every=k`` runs k cycles per host sync and applies the stop test
    ``res <= initial / (1.0 / tol)`` between batches: the history records
    every cycle, and a solve may run up to k−1 cycles past the threshold,
    as in the JAX package.  ``tail`` selects the plan
    (``build_spmd_solver``)."""
    _check_options(local_backend, halo, fuse, tail)
    eng = _engine(params, mesh, cutoff, plan, local_backend, fuse, halo,
                  tail)
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


def gather_field(state: GridState, plan: SpmdPlan, mesh: Mesh,
                 which: int = 0) -> torch.Tensor:
    """The finest level's field ``which`` (0 v, 1 f, 2 the mode's third
    field: FAS rest_v, Newton ũ) of the whole mesh, as the padded
    ``(nx+2, ny+2, nz+2)`` tensor on the mesh's device, zero outside the
    interior; every rank gets it (collective)."""
    lvl = state.levels[0]
    third = lvl.newton_v if lvl.newton_v is not None else lvl.rest_v
    field = {0: lvl.v, 1: lvl.f, 2: third if third is not None else lvl.v}
    g = _Exchange(mesh, plan).assemble(field[which])
    nx, ny, nz = plan.dims[0]
    out = g.new_zeros((nx + 2, ny + 2, nz + 2))
    s = (slice(1, nx + 1), slice(1, ny + 1), slice(1, nz + 1))
    out[s] = g[s]
    return out


def gather_solution(state: GridState, plan: SpmdPlan, mesh: Mesh,
                    which: int = 0) -> np.ndarray:
    """``gather_field`` as a numpy array (the dump and validate
    surface)."""
    return gather_field(state, plan, mesh, which).cpu().numpy()


def newton_solve_spmd(
    params: GridParams, mesh: Mesh, cutoff: int = 4,
    local_backend: str = "auto",
    halo: str = "ppermute",
    fuse: str = "leg",
    state: Optional[GridState] = None,
    newton_f: Optional[torch.Tensor] = None,
    initial_residual: Optional[float] = None,
    timer: Optional[Timer] = None,
    check_every: int = 1,
    tail: str = "auto",
    plan: Optional[SpmdPlan] = None,
) -> Tuple[GridState, List[float], SpmdPlan]:
    """The distributed outer Newton iteration
    (``gpusolve_tpu/dist/spmd.py:2015``; reference
    src/cpu/NewtonSolver.cpp:10-44): per step, v zeroed on every level, ũ
    restricted to levels 1..L−2, an inner 10-cycle, tol-0.1 NEWTON solve,
    ũ += v, and F's norm.  The solution is level 0's ``newton_v``.

    ``newton_f``, the original RHS, is a tensor of its own (level 0's f
    holds F after each ``comp_f``), kept as ``plan.newton_f`` and
    ``state.newton_f``.  ``check_every`` batches the inner solve's cycles
    (``solve_spmd``).  ``plan``: a plan whose engine to reuse (a pod
    plan: its depth), as ``solve_spmd`` takes one; ``tail`` selects the
    plan (``build_spmd_solver``): ũ is restricted down the distributed
    levels, into the tail root and down the tail, never to the
    coarsest."""
    if params.mode != Mode.NEWTON:
        raise ValueError(
            f"newton_solve_spmd runs NEWTON mode, got {params.mode.name}"
        )
    _check_options(local_backend, halo, fuse, tail)
    eng = _engine(params, mesh, cutoff, plan, local_backend, fuse, halo,
                  tail)
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
                   initial_residual=fn, local_backend=local_backend,
                   check_every=check_every, halo=halo, fuse=fuse, tail=tail)
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
