"""Per-level placement of the GSPMD engine and the state's distribution:
the counterpart of ``gpusolve_tpu/dist/sharding.py`` (``level_shardings``
:28, ``shard_state`` :62).

A level is blocked over the mesh's ``('x', 'y', 'z')`` axes when every
mesh axis keeps at least ``coarse_cutoff`` interior points a shard
(``n // m``), else replicated: every rank holds it whole and computes on
it redundantly, as the JAX package's ``P()`` levels are.  The JAX
package's decision, verbatim.

A blocked axis of ``n`` points over ``m`` ranks splits as XLA's SPMD
partitioner splits it: blocks of ``ceil(n / m)`` points, the last one
short (or empty).  A rank holds its block of each blocked level with a
ghost frame one point deep: a tensor of ``(bx+2, by+2, bz+2)``, the
layout every op of ``ops/dispatch.py`` takes.  Where the frame lies on
the domain's boundary it holds the Dirichlet zero, placed here and never
written (every op writes interiors only); elsewhere it holds ghosts,
which ``dist/gspmd.py`` fetches before each op that reads them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from gpusolve_tpu_torch.config import GridParams
from gpusolve_tpu_torch.dist.mesh import Mesh
from gpusolve_tpu_torch.grid import GridLevel, GridState, _device_rhs

# Minimum interior points a shard along each mesh axis for a level to stay
# blocked (the JAX package's default).
DEFAULT_COARSE_CUTOFF = 4

Box = Tuple[Tuple[int, int], Tuple[int, int], Tuple[int, int]]


def split(n: int, m: int, k: int) -> Tuple[int, int]:
    """Shard ``k`` of ``m`` of an axis of ``n`` interior points, as a
    half-open range of 0-based interior indices: blocks of ``ceil(n/m)``,
    the last one short (or empty)."""
    b = -(-n // m)
    return min(k * b, n), min((k + 1) * b, n)


@dataclasses.dataclass(frozen=True)
class LevelSharding:
    """One level's placement on a mesh (hashable).

    ``spec`` is ``('x', 'y', 'z')`` for a blocked level and ``()`` for a
    replicated one, as the JAX package's ``PartitionSpec``; ``box`` is
    this rank's block of a blocked level, a half-open range of 0-based
    global interior indices per axis (None when replicated)."""

    mesh: Mesh
    dims: Tuple[int, int, int]
    spec: Tuple[str, ...]
    box: Optional[Box]

    @property
    def blocked(self) -> bool:
        return bool(self.spec)

    def box_of(self, coords) -> Box:
        """The block of the rank at mesh ``coords`` (the whole level when
        replicated)."""
        if not self.blocked:
            return tuple((0, n) for n in self.dims)
        return tuple(split(n, m, c) for n, m, c in
                     zip(self.dims, self.mesh.shape, coords))

    @property
    def local_dims(self) -> Tuple[int, int, int]:
        """The interior dims of this rank's tensor of the level."""
        if not self.blocked:
            return self.dims
        return tuple(hi - lo for lo, hi in self.box)

    def padded_boxes(self):
        """Every rank's block in padded global indices (half-open), by
        rank."""
        return [
            tuple((lo + 1, hi + 1) for lo, hi in
                  self.box_of(self.mesh.coords_of(r)))
            for r in range(self.mesh.size)
        ]


def level_shardings(
    params: GridParams,
    mesh: Mesh,
    coarse_cutoff: int = DEFAULT_COARSE_CUTOFF,
) -> Tuple[LevelSharding, ...]:
    """One placement a level: blocked on fine levels, replicated on
    coarse ones (``gpusolve_tpu/dist/sharding.py:28-49``)."""
    out = []
    msx, msy, msz = mesh.shape
    for dims in params.level_dims():
        nx, ny, nz = dims
        blocked = (
            nx // msx >= coarse_cutoff
            and ny // msy >= coarse_cutoff
            and nz // msz >= coarse_cutoff
        )
        sh = LevelSharding(mesh, tuple(dims), ("x", "y", "z") if blocked
                           else (), None)
        if blocked:
            sh = dataclasses.replace(sh, box=sh.box_of(mesh.coords))
        out.append(sh)
    return tuple(out)


def place(t: torch.Tensor, sh: LevelSharding) -> torch.Tensor:
    """This rank's tensor of a whole padded level ``t``: its block with
    the ghost frame (``t`` itself where that is the whole level), or
    ``t`` when the level is replicated."""
    if not sh.blocked:
        return t
    (x0, x1), (y0, y1), (z0, z1) = sh.box
    block = t[x0 : x1 + 2, y0 : y1 + 2, z0 : z1 + 2]
    if block.shape == t.shape:
        return t
    return block.clone()


def shard_state(
    state: GridState, shardings: Tuple[LevelSharding, ...]
) -> GridState:
    """Place a whole state (``build_grid``'s, or a loaded one) by
    ``shardings``: each blocked level's tensors cut to this rank's block
    and ghost frame, replicated levels kept whole, ``newton_f`` on level
    0's placement.  On a one-rank mesh every tensor is kept as it is."""
    if state.shardings is not None:
        raise ValueError("the state is placed already")
    if len(shardings) != len(state.levels):
        raise ValueError(
            f"{len(shardings)} shardings for {len(state.levels)} levels")
    levels = []
    for lvl, sh in zip(state.levels, shardings):
        levels.append(GridLevel(**{
            f.name: None if getattr(lvl, f.name) is None
            else place(getattr(lvl, f.name), sh)
            for f in dataclasses.fields(GridLevel)
        }))
    newton_f = state.newton_f
    if newton_f is not None:
        newton_f = place(newton_f, shardings[0])
    return GridState(levels=tuple(levels), newton_f=newton_f,
                     shardings=tuple(shardings))


def gather_field(t: torch.Tensor, sh: LevelSharding) -> Optional[torch.Tensor]:
    """The whole padded level of ``t`` (this rank's tensor of it), on rank
    0; None on the other ranks.  Collective on a multi-rank mesh."""
    mesh = sh.mesh
    if not sh.blocked or mesh.size == 1:
        return t if mesh.rank == 0 else None
    (x0, x1), (y0, y1), (z0, z1) = sh.box
    mine = t[1 : 1 + x1 - x0, 1 : 1 + y1 - y0, 1 : 1 + z1 - z0]
    if mesh.rank != 0:
        if mine.numel():
            dist.send(mine.contiguous(), mesh.global_rank(0),
                      group=mesh.group)
        return None
    out = t.new_zeros(tuple(n + 2 for n in sh.dims))
    for r, box in enumerate(sh.padded_boxes()):
        shape = tuple(hi - lo for lo, hi in box)
        if not math.prod(shape):
            continue
        if r == 0:
            part = mine
        else:
            part = t.new_empty(shape)
            dist.recv(part, mesh.global_rank(r), group=mesh.group)
        out[tuple(slice(lo, hi) for lo, hi in box)] = part
    return out


def gather_state(state: GridState) -> Optional[GridState]:
    """The whole state of a placed one, on rank 0 (None on the other
    ranks): the inverse of :func:`shard_state`.  Collective."""
    shs = state.shardings
    if shs is None:
        raise ValueError("the state is not placed")
    levels = []
    for lvl, sh in zip(state.levels, shs):
        levels.append({
            f.name: None if getattr(lvl, f.name) is None
            else gather_field(getattr(lvl, f.name), sh)
            for f in dataclasses.fields(GridLevel)
        })
    newton_f = None
    if state.newton_f is not None:
        newton_f = gather_field(state.newton_f, shs[0])
    if shs[0].mesh.rank != 0:
        return None
    return GridState(levels=tuple(GridLevel(**kw) for kw in levels),
                     newton_f=newton_f)


def place_rhs(params: GridParams, sh: LevelSharding, dtype,
              device) -> torch.Tensor:
    """This rank's tensor of the finest RHS (level 0's placement ``sh``),
    computed on its block alone, each point as the whole grid's fill
    computes it; the frame holds zeros."""
    start = tuple(lo + 1 for lo, _ in sh.box_of(sh.mesh.coords))
    return _device_rhs(params, dtype, device, start, sh.local_dims)
