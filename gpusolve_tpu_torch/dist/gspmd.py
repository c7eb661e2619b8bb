"""The GSPMD engine's sharded ops: ``ops/dispatch.py``'s ops over a state
placed by ``dist/sharding.py``, on ``torch.distributed``.

The JAX package runs its per-op cycle on global arrays under
``with_sharding_constraint`` and lets XLA's partitioner insert the
collectives (``gpusolve_tpu/solver/vcycle.py:56-175``).  Here one
primitive stands for what the partitioner does: :func:`fetch`, *the box
B of a level's field onto this rank*, assembled from the owners' blocks
by point-to-point messages on the mesh's process group, zero outside the
domain (the Dirichlet halo).  Every op is a fetch followed by the local
op of ``ops/dispatch.py`` on this rank's block (on the card the per-op
CUDA kernels; on the CPU or in float64 their plain versions, as dispatch
decides per tensor):

  * a stencil op (sweep, residual, the FAS operator) fetches its block
    grown by one on every side, into the field's own ghost frame;
  * a restriction fetches the fine box under its coarse block, a
    prolongation the coarse box over its fine block, both from global
    indices (adjacent levels' blocks do not line up), widened where the
    kernels' shape contract (fine = 2·coarse + 1 interior points) asks;
  * a transfer between a blocked level and a replicated one fetches the
    whole fine level (it is small: under ``2·cutoff·m + 1`` points an
    axis), or slices the replicated coarse level locally.

On a one-rank mesh every fetch is a view, so every op runs on the
state's own tensors, as the single-device per-op schedule does.  Norms: Σr² over each rank's own interior, one
``all_reduce`` (SUM), then the caller's square root.  Replicated levels
run the single-device op on every rank.

:class:`ShardedOps` has dispatch's signatures, with each level named by
its global interior dims (they differ level to level), so the single
cycle of ``ops/vcycle_batch.py`` drives it: V, W and F in every mode come
from one code path.  The fused legs are single-device kernels and are not
taken here.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

from gpusolve_tpu_torch.dist.sharding import LevelSharding
from gpusolve_tpu_torch.ops import dispatch

# A box of padded global indices, half-open per axis.
Box = Tuple[Tuple[int, int], Tuple[int, int], Tuple[int, int]]


def _meet(a: Box, b: Box) -> Optional[Box]:
    out = tuple((max(lo, c), min(hi, d)) for (lo, hi), (c, d) in zip(a, b))
    return out if all(lo < hi for lo, hi in out) else None


def _slices(part: Box, origin) -> tuple:
    """``part`` as slices of a tensor whose index 0 is global ``origin``."""
    return tuple(slice(lo - o, hi - o) for (lo, hi), o in zip(part, origin))


def window(t: torch.Tensor, box: Box) -> torch.Tensor:
    """The box of a whole padded level ``t``, zero outside it: a view when
    the box lies within ``t``."""
    if all(0 <= lo and hi <= n for (lo, hi), n in zip(box, t.shape)):
        return t[_slices(box, (0, 0, 0))]
    out = t.new_zeros(tuple(hi - lo for lo, hi in box))
    inside = _meet(box, tuple((0, n) for n in t.shape))
    if inside is not None:
        out[_slices(inside, [lo for lo, _ in box])] = \
            t[_slices(inside, (0, 0, 0))]
    return out


def storage(sh: LevelSharding, coords=None) -> Box:
    """The padded global box a rank's tensor of a blocked level covers:
    its block and ghost frame."""
    box = sh.box_of(sh.mesh.coords if coords is None else coords)
    return tuple((lo, hi + 2) for lo, hi in box)


def fetch(t: torch.Tensor, sh: LevelSharding,
          box_of: Callable[[tuple], Box]) -> torch.Tensor:
    """Box ``box_of(coords)`` (padded global indices) of a level's field
    onto this rank, ``t`` its tensor of the level.  Collective on a
    multi-rank mesh: every rank calls it with the same ``box_of``.

    A replicated level, and any level on a one-rank mesh (whose block and
    frame are the whole padded level), is sliced locally
    (:func:`window`: a view where the box lies within the level, the
    whole tensor for a stencil op's box).  Of a blocked level on a larger
    mesh, where the box is ``t``'s own block and frame, the neighbours'
    points are written into ``t``'s frame and ``t`` is returned; else a
    new tensor, zero outside the domain.  The frame's points outside the
    domain are zero already (placed so, and no op writes a frame)."""
    mesh = sh.mesh
    mine = box_of(mesh.coords)
    if not sh.blocked or mesh.size == 1:
        return window(t, mine).contiguous()
    own = storage(sh)
    blocks = sh.padded_boxes()
    out = t if mine == own else t.new_zeros(
        tuple(hi - lo for lo, hi in mine))
    origin = [lo for lo, _ in mine]
    if out is not t:
        part = _meet(mine, blocks[mesh.rank])
        if part is not None:
            out[_slices(part, origin)] = t[_slices(part, [lo for lo, _ in own])]
    ops, recvs = [], []
    for r in range(mesh.size):
        if r == mesh.rank:
            continue
        peer = mesh.global_rank(r)
        send = _meet(blocks[mesh.rank], box_of(mesh.coords_of(r)))
        if send is not None:
            ops.append(dist.P2POp(dist.isend, t[_slices(
                send, [lo for lo, _ in own])].contiguous(), peer, mesh.group))
        recv = _meet(blocks[r], mine)
        if recv is not None:
            buf = t.new_empty(tuple(hi - lo for lo, hi in recv))
            recvs.append((recv, buf))
            ops.append(dist.P2POp(dist.irecv, buf, peer, mesh.group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for part, buf in recvs:
        out[_slices(part, origin)] = buf
    return out


def halo(t: torch.Tensor, sh: LevelSharding) -> torch.Tensor:
    """A stencil op's fetch: the neighbours' points of the block grown by
    one, into ``t``'s ghost frame (nothing to fetch on one rank or a
    replicated level)."""
    return fetch(t, sh, lambda c: storage(sh, c))


def all_sum(t: torch.Tensor, sh: LevelSharding) -> torch.Tensor:
    """Σ over the ranks of a blocked level's per-rank partial ``t``, in
    place (a replicated level's, computed whole on every rank, stands)."""
    if sh.blocked and sh.mesh.size > 1:
        dist.all_reduce(t, group=sh.mesh.group)
    return t


def _coarse_range(sh: LevelSharding, coords) -> Box:
    """Padded global interior range (half-open) of a coarse level's part
    a rank computes: its block, or the whole level when replicated."""
    return tuple((lo + 1, hi + 1) for lo, hi in sh.box_of(coords))


def restrict_box(shc: LevelSharding, coords) -> Box:
    """The fine box a restriction into a rank's coarse part reads: coarse
    c takes fine 2c−1 … 2c+1, and the kernel's contract (fine = 2·coarse
    + 1 interior points) lays the fine box out from 2c₀−2 to 2c₁+2."""
    return tuple((2 * lo - 2, 2 * hi + 1)
                 for lo, hi in _coarse_range(shc, coords))


def prolong_boxes(shf: LevelSharding, coords) -> Tuple[Box, Box]:
    """``(fine_box, coarse_box)`` of a prolongation onto a rank's fine
    block.  Fine p reads coarse ⌊p/2⌋ and ⌈p/2⌉, so the fine box starts
    at an even index 2c₀ (one point before the block at most).  Its
    interior ends with the block, one point later where that leaves an
    odd count inside the domain: the kernel reads the coarse point past
    an odd count as the zero halo, which holds only at the domain's end."""
    fine, coarse = [], []
    for (lo, hi), n in zip(shf.box_of(coords), shf.dims):
        f0, f1 = lo + 1, hi  # the block's padded interior, inclusive
        c0 = (f0 - 1) // 2
        fd = f1 - 2 * c0
        if fd % 2 and f1 < n:
            fd += 1
        cd = fd // 2
        fine.append((2 * c0, 2 * c0 + fd + 2))
        coarse.append((c0, c0 + cd + 2))
    return tuple(fine), tuple(coarse)


def _dims(box: Box) -> Tuple[int, int, int]:
    """The interior dims of a padded box."""
    return tuple(hi - lo - 2 for lo, hi in box)


def _empty(sh: LevelSharding) -> bool:
    return sh.blocked and not math.prod(sh.local_dims)


def _no_device_stop(thr) -> None:
    if isinstance(thr, torch.Tensor) or thr >= 0:
        raise ValueError(
            "a sharded state's norm takes no stop threshold on the device: "
            "its loop tests each norm on the host")


class ShardedOps:
    """The ops of ``ops/dispatch.py`` (the per-op ones) over a placed
    state; a level is named by its global interior dims."""

    def __init__(self, shardings: Tuple[LevelSharding, ...]):
        self._by_dims = {sh.dims: sh for sh in shardings}

    def level(self, dims) -> LevelSharding:
        return self._by_dims[tuple(dims)]

    def smooth(self, v, f, spare, dims, params, h, n_iter, done=None,
               newton_v=None):
        sh = self.level(dims)
        if not sh.blocked:
            return dispatch.smooth(v, f, spare, dims, params, h, n_iter,
                                   done, newton_v)
        a, b = v, spare
        for _ in range(n_iter):
            halo(a, sh)
            if not _empty(sh):
                dispatch.smooth(a, f, b, sh.local_dims, params, h, 1, done,
                                newton_v)
            a, b = b, a
        return a, b

    def residual_op(self, r, v, f, dims, params, h, *, write_r=True,
                    norm_out=None, thr=-1.0, done=None, newton_v=None):
        sh = self.level(dims)
        if not sh.blocked:
            dispatch.residual_op(r, v, f, dims, params, h, write_r=write_r,
                                 norm_out=norm_out, thr=thr, done=done,
                                 newton_v=newton_v)
            return
        if sh.mesh.size > 1:
            _no_device_stop(thr)
        halo(v, sh)
        if not _empty(sh):
            dispatch.residual_op(r, v, f, sh.local_dims, params, h,
                                 write_r=write_r, norm_out=norm_out, thr=thr,
                                 done=done, newton_v=newton_v)
        elif norm_out is not None:
            norm_out.zero_()
        if norm_out is not None:
            all_sum(norm_out, sh)

    def _restrict(self, fine, fine_dims, coarse_dims):
        """The fine box of a restriction and its interior dims, with the
        coarse part's; None where both levels are replicated."""
        shf, shc = self.level(fine_dims), self.level(coarse_dims)
        if not shf.blocked:
            return None
        box = fetch(fine, shf, lambda c: restrict_box(shc, c))
        cd = tuple(hi - lo for lo, hi in _coarse_range(shc, shc.mesh.coords))
        return box, tuple(2 * n + 1 for n in cd), cd

    def restrict_zero_op(self, f_coarse, v_coarse, r_fine, fine_dims,
                         coarse_dims, params, done=None):
        got = self._restrict(r_fine, fine_dims, coarse_dims)
        if got is None:
            return dispatch.restrict_zero_op(
                f_coarse, v_coarse, r_fine, fine_dims, coarse_dims, params,
                done)
        box, fd, cd = got
        if math.prod(cd):
            dispatch.restrict_zero_op(f_coarse, v_coarse, box, fd, cd,
                                      params, done)

    def restrict_op(self, out, fine, fine_dims, coarse_dims, params,
                    done=None, out2=None):
        got = self._restrict(fine, fine_dims, coarse_dims)
        if got is None:
            return dispatch.restrict_op(out, fine, fine_dims, coarse_dims,
                                        params, done, out2)
        box, fd, cd = got
        if math.prod(cd):
            dispatch.restrict_op(out, box, fd, cd, params, done, out2)

    def prolong_add_op(self, v_fine, v_coarse, coarse_dims, fine_dims,
                       params, done=None):
        shf, shc = self.level(fine_dims), self.level(coarse_dims)
        if not shf.blocked:
            return dispatch.prolong_add_op(v_fine, v_coarse, coarse_dims,
                                           fine_dims, params, done)
        fbox, cbox = prolong_boxes(shf, shf.mesh.coords)
        coarse = fetch(v_coarse, shc,
                       lambda c: prolong_boxes(shf, c)[1])
        if _empty(shf):
            return
        own = storage(shf)
        if fbox == own:
            dispatch.prolong_add_op(v_fine, coarse, _dims(cbox),
                                    _dims(fbox), params, done)
            return
        # The box reaches one point past the frame: run on a copy, keep
        # the block's points.
        tmp = window(v_fine, tuple((lo - o, hi - o) for (lo, hi), (o, _)
                                   in zip(fbox, own))).clone()
        dispatch.prolong_add_op(tmp, coarse, _dims(cbox), _dims(fbox),
                                params, done)
        blk = tuple((lo + 1, hi - 1) for lo, hi in own)
        v_fine[_slices(blk, [lo for lo, _ in own])] = \
            tmp[_slices(blk, [lo for lo, _ in fbox])]

    def apply_fas_op(self, out, v, dims, params, h, done=None):
        sh = self.level(dims)
        if not sh.blocked:
            return dispatch.apply_fas_op(out, v, dims, params, h, done)
        halo(v, sh)
        if not _empty(sh):
            dispatch.apply_fas_op(out, v, sh.local_dims, params, h, done)

    def subtract_op(self, v, w, dims, params, done=None):
        sh = self.level(dims)
        if not _empty(sh):
            dispatch.subtract_op(v, w, sh.local_dims, params, done)


def ops_for(state):
    """The ops a state's cycle runs: ``ops/dispatch`` on one device,
    :class:`ShardedOps` for a placed state."""
    if state.shardings is None:
        return dispatch
    return ShardedOps(state.shardings)
