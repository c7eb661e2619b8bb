"""The pod engine's chained legs (``csrc/pod.cu``): every distributed down
leg of a cycle in one launch, and every up leg in another; their
geometry, the wrappers, and the plain PyTorch versions beside them.

The counterpart of ``gpusolve_tpu/ops/pallas_pod.py``: ``pod_down``
replaces ``_pod_down_call`` (:494, ``pod_down`` :707) and ``pod_up``
replaces ``_pod_up_call`` (:741, ``pod_up`` :968).  A chain is a list of
:class:`Leg`, each one leg's arguments as ``ops/spmd_leg.leg_block`` takes
them, in launch order:

  * the down chain, levels ``a..npod−1``: each leg with the restriction
    consumer, its coarse outputs (the next level's f; FAS also its v and
    rest_v, with the tau fold) being the next leg's inputs; a LINEAR or
    NEWTON leg below the head starts from v = 0 (``src_zero``);
  * the up chain, levels ``npod−1..a``: each leg corr-first, its coarse
    block the previous leg's output (the first leg's: the boundary block
    of the replicated tail); FAS legs below the head write v − rest_v
    (``sub_rv``), the head writes the true v; the level-0 leg carries the
    norm consumer, whose float64 partials the wrapper returns.

On CUDA tensors one launch runs the chain, each leg the per-leg kernel's
body, so the chain equals its legs launched one by one through
``leg_block``, bit for bit: a cooperative launch whose grid barrier
separates the legs, or for a chain of one leg (the one-rank plan's depth
1) one block a tile.  It runs on the one-rank mesh only: between legs on
a larger mesh the TPU kernels exchange slabs by writing into the
neighbours' memory inside the chain, whose in-kernel waits wait for a
machine with two cards (ROADMAP Queue 2, rows 12-14 across cards), so a
chain with an ``exchange`` raises on CUDA.  On CPU tensors
the plain version chains ``leg_block_plain``, exchanging each leg's slabs
on the host through ``exchange(t, depth)`` (``dist/spmd._Exchange.slabs``)
on a multi-rank mesh.

The wrappers keep the ``ops/kernels.py`` contract: outputs are passed in
(every leg's ``v_out`` is the level's spare buffer: no leg writes what it
reads); a CPU tensor runs the plain version; a CUDA float32 tensor is
checked and launched on the current stream, a launch error raises, and
``kernels.launches["pod_down[_fas|_newton]"]`` and ``["pod_up…"]`` count
the launches.

Pod geometry (``pod_levels``): the levels' blocks in the port's layout.
x halves exactly down the chain (a fine block is twice its coarse one,
so the restriction and the prolongation stay shard-local), and so does y
under a y split; otherwise y and z are free per level.  The level-``npod``
block, the tail's root, takes the replicated levels' ``(n+2)``-padded
layout wherever the halving allows, so on one rank the tail runs on it in
place (for ``2^k − 1`` grids always).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from gpusolve_tpu_torch.config import GridParams, Mode
from gpusolve_tpu_torch.ops import kernels
from gpusolve_tpu_torch.ops import spmd_leg as sl
from gpusolve_tpu_torch.ops.spmd_kernels import Box, box_empty

MAX_LEGS = 8           # a chain's legs (csrc/pod.cu kMaxPod)
SMEM_MAX = 232448      # dynamic shared memory a block may use (H100)
_TY, _TZ = 16, 32      # the leg's tile (csrc/leg_device.cuh)

Level = Tuple[int, int, int, int, int, int]  # (bx, by, bz, nx, ny, nz)
Exchange = Callable[[torch.Tensor, int], Optional[Sequence]]


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def pod_levels(params: GridParams, mesh_xy, npod: int
               ) -> Optional[Tuple[Level, ...]]:
    """Per-rank blocks ``(bx, by, bz, nx, ny, nz)`` of levels 0..npod
    (entry npod: the boundary block, the tail's root) on the ``(mx, my)``
    data mesh, or None when ``npod`` is out of range.

    x: ``a0x`` covers every level's padded extent shifted up to level 0,
    rounded to ``mx·2^npod``, and level l's block is ``a0x/(mx·2^l)``; y
    the same under a y split.  Unsplit y: an even ``n+2`` on the legs'
    levels (the leg takes even blocks), ``n+2`` on the boundary; z ``n+2``.
    For a ``2^k − 1`` grid ``a0x = 2^npod·(n_npod + 2)``, so on one rank
    the boundary block is ``(n+2)³``: the tail's own layout."""
    mx, my = mesh_xy
    dims = params.level_dims()
    if npod < 1 or npod >= len(dims):
        return None

    def a0(ax, m):
        return _round_up(max((dims[l][ax] + 2) << l for l in range(npod + 1)),
                         m << npod)

    a0x = a0(0, mx)
    a0y = a0(1, my) if my > 1 else None
    levels = []
    for l in range(npod + 1):
        nx, ny, nz = dims[l]
        if a0y is not None:
            by = a0y // my >> l
        else:
            by = ny + 2 if l == npod else _round_up(ny + 2, 2)
        levels.append((a0x // mx >> l, by, nz + 2, nx, ny, nz))
    return tuple(levels)


def leg_smem_bytes(mode: Mode, consumer: Optional[str], S: int) -> int:
    """The dynamic shared memory of one leg launch (csrc/leg_device.cuh
    ``leg_smem_floats``): a three-plane ring per generation 0..S−1 and for
    generation S (none with no consumer), S + 2 planes of f (and ũ; S + 1
    with no consumer), for the restriction the residual's two planes and
    the x-restricted plane (FAS two), and in FAS the restricted-v ring and
    the R(r) staging."""
    fas_restrict = mode == Mode.NONLINEAR and consumer == "restrict"
    reach = {None: 0, "norm": 1}.get(consumer, 3 if fas_restrict else 2)
    R = S + reach
    ps = (_TY + 2 * R) * (_TZ + 2 * R)
    gen_s = 0 if consumer is None else 3
    nf = S + (1 if consumer is None else 2)
    n = (3 * S + gen_s) * ps + nf * ps
    if mode == Mode.NEWTON:
        n += nf * ps
    if consumer == "restrict":
        n += (4 if fas_restrict else 3) * ps
        if fas_restrict:
            n += 3 * (_TY // 2 + 2) * (_TZ // 2 + 2) \
                + 2 * (_TY // 2) * (_TZ // 2)
    return 4 * n


def chain_smem_bytes(mode: Mode, pre: int, post: int) -> Tuple[int, int]:
    """(down, up) dynamic shared memory of the two chained launches: the
    largest leg of each (the pod kernels' counterpart of
    ``pallas_pod.pod_scratch_bytes``, :172-214)."""
    return (leg_smem_bytes(mode, "restrict", pre),
            max(leg_smem_bytes(mode, "norm", post),
                leg_smem_bytes(mode, None, post)))


@dataclasses.dataclass
class Leg:
    """One leg of a chain: ``leg_block``'s arguments but the slabs (the
    chain's ``exchange`` makes them) and the sweep count (the chain's)."""

    v_out: torch.Tensor
    v: Optional[torch.Tensor]
    f: torch.Tensor
    box: Box
    glob: Tuple[int, int, int, int]
    h: float
    newton_v: Optional[torch.Tensor] = None
    src_zero: bool = False
    coarse: Optional[torch.Tensor] = None
    consumer: Optional[str] = None
    cout: Optional[tuple] = None
    cbox: Optional[Box] = None
    cdims: Optional[Tuple[int, int, int]] = None
    tau_h: float = 0.0
    sub_rv: Optional[torch.Tensor] = None

    def kwargs(self, cslabs=None) -> dict:
        return dict(
            newton_v=self.newton_v, src_zero=self.src_zero,
            coarse=None if self.coarse is None else (self.coarse, cslabs),
            consumer=self.consumer, cout=self.cout, cbox=self.cbox,
            cdims=self.cdims, tau_h=self.tau_h, sub_rv=self.sub_rv,
        )


def _check_chain(legs: Sequence[Leg], params: GridParams, S: int,
                 up: bool) -> None:
    if not legs:
        raise ValueError("a chain has at least one leg")
    for i, leg in enumerate(legs):
        sl.check_leg(params, S, **leg.kwargs())
        if up:
            if leg.coarse is None:
                raise ValueError("every up leg is corr-first")
            if leg.consumer == "norm" and i != len(legs) - 1:
                raise ValueError("only the chain's last up leg has the norm")
        elif leg.consumer != "restrict" or leg.coarse is not None:
            raise ValueError("every down leg restricts")


def _chain_plain(legs: Sequence[Leg], params: GridParams, S: int,
                 exchange: Optional[Exchange]) -> Optional[torch.Tensor]:
    """The legs one by one through ``leg_block_plain``, each with its
    slabs from ``exchange`` (None: the one-rank mesh, zero ghosts)."""
    newton = params.mode == Mode.NEWTON
    partials = None
    for leg in legs:
        slabs = cslabs = None
        if exchange is not None:
            slabs = {"f": exchange(leg.f, sl.G)}
            if not leg.src_zero:
                slabs["v"] = exchange(leg.v, sl.G)
            if newton:
                slabs["nv"] = exchange(leg.newton_v, sl.G)
            if leg.coarse is not None:
                cslabs = exchange(leg.coarse, sl.GC)
        out = sl.leg_block_plain(
            leg.v_out, leg.v, leg.f, slabs, leg.box, leg.glob, params,
            leg.h, S, **leg.kwargs(cslabs),
        )
        if out is not None:
            partials = out
    return partials


def pod_down_plain(legs: Sequence[Leg], params: GridParams, S: int,
                   exchange: Optional[Exchange] = None) -> None:
    """Plain version of :func:`pod_down`."""
    _check_chain(legs, params, S, up=False)
    _chain_plain(legs, params, S, exchange)


def pod_up_plain(legs: Sequence[Leg], params: GridParams, T: int,
                 exchange: Optional[Exchange] = None
                 ) -> Optional[torch.Tensor]:
    """Plain version of :func:`pod_up`."""
    _check_chain(legs, params, T, up=True)
    return _chain_plain(legs, params, T, exchange)


# Each chain launch's grid: (blocks, resident blocks an SM, dynamic shared
# memory bytes), by counter name, from the last launch.
last_grid = {}


def _chain_launch(legs: Sequence[Leg], params: GridParams, S: int, up: bool,
                  exchange: Optional[Exchange]) -> Optional[torch.Tensor]:
    name = kernels.variant("pod_up" if up else "pod_down", params.mode)
    _check_chain(legs, params, S, up)
    if legs[0].f.device.type == "cpu":
        return _chain_plain(legs, params, S, exchange)
    if exchange is not None:
        raise ValueError(
            f"{name} runs on the one-rank mesh: the exchange between the "
            "legs of a chain on a larger mesh needs in-kernel peer "
            "writes and waits (ROADMAP Queue 2, rows 12-14 across cards)"
        )
    if len(legs) > MAX_LEGS:
        raise ValueError(f"{name}: {len(legs)} legs, one launch takes "
                         f"{MAX_LEGS}")
    ptrs: List = []
    ints: List[int] = []
    fls: List[float] = []
    partials = None
    for leg in legs:
        if box_empty(leg.box):
            raise ValueError(f"{name}: a leg with an empty box")
        p, i, f, part = sl._launch_args(
            leg.v_out, leg.v, leg.f, None, leg.box, leg.glob, params,
            leg.h, S, **leg.kwargs(),
        )
        ptrs += p
        ints += i
        fls += f
        if part is not None:
            partials = part
    info = (ctypes.c_longlong * 3)()
    rc = kernels.lib().mg_pod_chain(
        int(up), len(legs), (ctypes.c_void_p * len(ptrs))(*ptrs),
        (ctypes.c_int * len(ints))(*ints),
        (ctypes.c_float * len(fls))(*fls), *sl._tap_args(params), info,
        kernels._stream(legs[0].f.device),
    )
    kernels._check_rc(rc, name)
    kernels.launches[name] += 1
    last_grid[name] = tuple(info)
    return partials


# ---------------------------------------------------------------------------
# pod_down — replaces gpusolve_tpu/ops/pallas_pod.py::_pod_down_call (:494)
# and pod_up — replaces ::_pod_up_call (:741), in all three modes.  Bound:
# bytes by the table (each leg's, summed: PERF.md), instruction issue as
# measured.  Design: one cooperative launch a chain; every block walks
# each leg's tiles in a grid-stride loop and a grid barrier separates the
# legs; a chain of one leg launches one block a tile (csrc/pod.cu).
# ---------------------------------------------------------------------------


def pod_down(legs: Sequence[Leg], params: GridParams, S: int,
             exchange: Optional[Exchange] = None) -> None:
    """The down chain: S pre-sweeps, the residual and its restriction (FAS:
    R(v) and the tau fold) per leg, in one launch."""
    _chain_launch(legs, params, S, False, exchange)


def pod_up(legs: Sequence[Leg], params: GridParams, T: int,
           exchange: Optional[Exchange] = None) -> Optional[torch.Tensor]:
    """The up chain: the prolongation first, then T post-sweeps per leg,
    in one launch; returns the norm partials of the last leg when it has
    the norm consumer."""
    return _chain_launch(legs, params, T, True, exchange)
