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
separates the legs, or for a chain of one leg on the one-rank mesh (its
plan's depth 1) one block a tile.  On a multi-rank CUDA mesh the chain
exchanges the legs' ghost slabs between ranks inside the launch, as the
TPU kernels do (``_emit_barrier`` / ``_emit_exchange``): each rank writes
its face planes into its neighbours' receive buffers through the peer
registry (``ChainPeers``, one per engine, chain and mode), with flag
words for a neighbour barrier at the start and for each exchange step,
and the legs read their slabs from this rank's buffers; the launch equals
the legs one by one through ``leg_block`` with the host exchange, bit for
bit.  On CPU tensors the plain version chains ``leg_block_plain``,
exchanging each leg's slabs on the host through ``exchange(t, depth)``
(``dist/spmd._Exchange.slabs``) on a multi-rank mesh.

The wrappers keep the ``ops/kernels.py`` contract: outputs are passed in
(every leg's ``v_out`` is the level's spare buffer: no leg writes what it
reads); a CPU tensor runs the plain version; a CUDA float32 tensor is
checked and launched on the current stream, a launch error raises, and
``kernels.launches["pod_down[_fas|_newton]"]`` and ``["pod_up…"]`` count
the launches (on a multi-rank mesh ``["pod_down_ranks…"]`` and
``["pod_up_ranks…"]``).

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
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from gpusolve_tpu_torch.config import GridParams, Mode
from gpusolve_tpu_torch.ops import kernels, rdma
from gpusolve_tpu_torch.ops import spmd_leg as sl
from gpusolve_tpu_torch.ops.spmd_kernels import Box, box_empty

MAX_LEGS = 8           # a chain's legs (csrc/pod.cu kMaxPod)
MAX_STEPS = 16         # exchange steps of a chain (csrc/pod.cu kMaxSteps)
MAX_JOBS = 320         # row copies of a chain (csrc/pod.cu kMaxXJobs)
WAIT_LIMIT_S = 30.0    # an in-kernel wait for a neighbour traps past this
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


def _leg_fields(leg: Leg, mode: Mode):
    """The fields whose ghost slabs a leg reads, in exchange order:
    ``(name, tensor, depth)`` for f, v (not from a zero start), ũ
    (NEWTON) and the coarse block (corr-first)."""
    out = [("f", leg.f, sl.G)]
    if not leg.src_zero:
        out.append(("v", leg.v, sl.G))
    if mode == Mode.NEWTON:
        out.append(("nv", leg.newton_v, sl.G))
    if leg.coarse is not None:
        out.append(("c", leg.coarse, sl.GC))
    return out


def _chain_plain(legs: Sequence[Leg], params: GridParams, S: int,
                 exchange: Optional[Exchange]) -> Optional[torch.Tensor]:
    """The legs one by one through ``leg_block_plain``, each with its
    slabs from ``exchange`` (None: the one-rank mesh, zero ghosts)."""
    partials = None
    for leg in legs:
        slabs = cslabs = None
        if exchange is not None:
            slabs = {name: exchange(t, g)
                     for name, t, g in _leg_fields(leg, params.mode)}
            cslabs = slabs.pop("c", None)
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


# ---------------------------------------------------------------------------
# The exchange between ranks inside a chain
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class XSet:
    """One exchange set of a chain: the ghost slabs of field ``name``
    (``_leg_fields``) of leg ``leg``, a block of ``shape``, ``g`` deep,
    exchanged in ``phase``: 0, before the first leg, for a chain input;
    ``leg`` for what an earlier leg of the chain writes (the down chain's
    coarse f, FAS also v; the up chain's coarse v)."""

    phase: int
    leg: int
    name: str
    shape: Tuple[int, int, int]
    g: int


def exchange_sets(legs: Sequence[Leg], params: GridParams) -> List[XSet]:
    """The chain's exchange sets by phase, in leg and ``_leg_fields``
    order within a phase (the TPU kernels' sets,
    gpusolve_tpu/ops/pallas_pod.py:626-681 and :887-942): the down
    chain's phase 0 holds the head's v and f and every leg's ũ, phase i
    leg i's f (FAS: and v); the up chain's phase 0 every leg's v, f and ũ
    and the head's coarse block, phase i leg i's coarse block (the
    previous leg's output)."""
    written = set()
    out = []
    for i, leg in enumerate(legs):
        for name, t, g in _leg_fields(leg, params.mode):
            out.append(XSet(i if id(t) in written else 0, i, name,
                            tuple(t.shape), g))
        written.update(id(t) for t in (leg.v_out, *(leg.cout or ()))
                       if t is not None)
    return sorted(out, key=lambda x: x.phase)


def exchange_steps(sets: Sequence[XSet], mesh_xy) -> List[Tuple[int, int]]:
    """``(phase, axis)`` of each step: per phase a y step (under a y
    split) and then an x step (with more than one rank along x)."""
    axes = [ax for ax in (1, 0) if mesh_xy[ax] > 1]
    return [(ph, ax) for ph in sorted({x.phase for x in sets}) for ax in axes]


def _parts(x: XSet, ys: bool) -> Dict[str, Tuple[int, ...]]:
    """The receive buffers of a set: its x slabs (y-extended under a y
    split) and, under a y split, its y slabs."""
    bx, by, bz = x.shape
    xs = (x.g, by + 2 * x.g if ys else by, bz)
    out = {"xlo": xs, "xhi": xs}
    if ys:
        out.update(ylo=(bx, x.g, bz), yhi=(bx, x.g, bz))
    return out


def _align(n: int) -> int:
    return -(-n // 256) * 256


class ChainLayout:
    """The exchange of one chain on a ``(mx, my)`` data mesh: its sets and
    steps, and one rank's allocation: the flag words first (four start
    words, four a step: one per neighbour, -x, +x, -y, +y), then every
    set's receive buffers, ``offsets[(leg, name)][part] = (byte offset,
    shape)``.  Every rank's is the same (the blocks are equal), so a
    neighbour's buffer sits at the same offset in its allocation."""

    def __init__(self, legs: Sequence[Leg], params: GridParams, mesh_xy):
        self.mode = params.mode
        self.ys = mesh_xy[1] > 1
        self.sets = exchange_sets(legs, params)
        self.steps = exchange_steps(self.sets, mesh_xy)
        if len(self.steps) > MAX_STEPS:
            raise ValueError(f"{len(self.steps)} exchange steps, a chain "
                             f"takes {MAX_STEPS}")
        off = _align(8 * 4 * (1 + len(self.steps)))
        self.offsets = {}
        for x in self.sets:
            parts = {}
            for part, shape in _parts(x, self.ys).items():
                parts[part] = (off, shape)
                off += _align(4 * shape[0] * shape[1] * shape[2])
            self.offsets[(x.leg, x.name)] = parts
        self.nbytes = off

    def views(self, mem: torch.Tensor):
        """Each set's receive buffers as views of ``mem``, a rank's whole
        allocation as a flat float32 tensor."""
        return {key: {part: mem[o // 4:o // 4 + shape[0] * shape[1]
                                * shape[2]].view(shape)
                      for part, (o, shape) in parts.items()}
                for key, parts in self.offsets.items()}

    def _jobs(self, x: XSet, src: int, ax: int, base: int, peers):
        """The row copies of set ``x`` (its tensor's data at ``src``) in a
        step along ``ax`` from the rank whose allocation is at ``base`` to
        its neighbours' (``peers[(ax, ±1)]``): ``(dst, src, rows, rpp,
        sps, dps, bz)``, strides in floats."""
        bx, by, bz = x.shape
        g = x.g
        own = self.offsets[(x.leg, x.name)]
        out = []
        for step in (-1, 1):
            peer = peers.get((ax, step))
            if peer is None:
                continue
            if ax == 1:
                # The first (last) g rows of every plane into the lower
                # (upper) neighbour's yhi (ylo).
                row = 0 if step < 0 else by - g
                dst = peer + own["yhi" if step < 0 else "ylo"][0]
                out.append((dst, src + 4 * row * bz, bx * g, g, by * bz,
                            g * bz, bz))
                continue
            # The first (last) g planes into the lower (upper) neighbour's
            # xhi (xlo); under a y split with this rank's y slabs of those
            # planes around them (the corners its y neighbours sent).
            p0 = 0 if step < 0 else bx - g
            dst = peer + own["xhi" if step < 0 else "xlo"][0]
            if not self.ys:
                out.append((dst, src + 4 * p0 * by * bz, g * by, g * by, 0,
                            0, bz))
                continue
            rows = by + 2 * g
            for part, y0, n, stride in ((own["ylo"][0] + base, 0, g, g * bz),
                                        (src, g, by, by * bz),
                                        (own["yhi"][0] + base, g + by, g,
                                         g * bz)):
                out.append((dst + 4 * y0 * bz, part + 4 * p0 * stride,
                            g * n, n, stride, rows * bz, bz))
        return out

    def copies(self, legs: Sequence[Leg], base: int, peers):
        """A launch's steps ``(leg, axis, first job, jobs, rows)`` and row
        copies ``(dst, src, rows, rpp, sps, dps, bz, row0)`` for the legs'
        current tensors."""
        fields = {(i, name): t for i, leg in enumerate(legs)
                  for name, t, _ in _leg_fields(leg, self.mode)}
        steps, jobs = [], []
        for phase, ax in self.steps:
            job0, rows = len(jobs), 0
            for x in self.sets:
                if x.phase != phase:
                    continue
                t = fields[(x.leg, x.name)]
                if tuple(t.shape) != x.shape or not t.is_contiguous():
                    raise ValueError(f"leg {x.leg} {x.name}: "
                                     f"{tuple(t.shape)}, the layout holds "
                                     f"{x.shape} (contiguous)")
                for j in self._jobs(x, t.data_ptr(), ax, base, peers):
                    jobs.append((*j, rows))
                    rows += j[2]
            steps.append((phase, ax, job0, len(jobs) - job0, rows))
        if len(jobs) > MAX_JOBS:
            raise ValueError(f"{len(jobs)} exchange copies, a chain takes "
                             f"{MAX_JOBS}")
        return steps, jobs


def _free_host(lib, host: List[int]) -> None:
    while host:
        lib.mg_host_free(host.pop())


class ChainPeers(rdma.PeerSlabs):
    """The peer registry of one chain on a multi-rank CUDA mesh: this
    rank's allocation of the chain's ``ChainLayout``, opened by its ±x
    (and, under a y split, ±y) neighbours (``rdma.PeerSlabs``); the launch
    epoch, a device record of each wait's ns and a host-mapped status
    word.  Built for the legs' shapes; each launch takes the legs' current
    tensors.  ``ex`` is the rank's ``dist/spmd._Exchange``; released by
    ``rdma.close(ex)``."""

    def __init__(self, ex, legs: Sequence[Leg], params: GridParams,
                 up: bool):
        self.up, self.mode = up, params.mode
        self.rank = ex.mesh.rank
        self.layout = lay = ChainLayout(legs, params, ex.plan.mesh_shape[:2])
        dev = legs[0].f.device
        super().__init__(ex, lay.nbytes, dev,
                         axes=(0, 1) if lay.ys else (0,),
                         sig=(up, tuple(lay.sets), tuple(lay.steps)))
        self.views = lay.views(rdma._as_tensor(
            self.base, (self.nbytes // 4,), torch.float32))
        self.waits = torch.zeros(1 + len(lay.steps), dtype=torch.int64,
                                 device=dev)
        host, devp = ctypes.c_void_p(), ctypes.c_void_p()
        rdma._rc(self.lib.mg_host_alloc(4, ctypes.byref(host),
                                        ctypes.byref(devp)),
                 "cudaHostAlloc of the chain's status word")
        self._host = [host.value]
        self._status = (host.value, devp.value)
        weakref.finalize(self, _free_host, self.lib, self._host)
        self.epoch = 0

    def free(self) -> None:
        super().free()
        _free_host(self.lib, self._host)

    def slabs(self, i: int):
        """Leg ``i``'s slabs as ``leg_block`` takes them: ``(slabs,
        cslabs)``, views of this rank's receive buffers."""
        slabs = {}
        for (leg, name), v in self.views.items():
            if leg == i:
                slabs[name] = (v["xlo"], v["xhi"], v.get("ylo"),
                               v.get("yhi"))
        return slabs, slabs.pop("c", None)

    def table(self, legs: Sequence[Leg]) -> List[int]:
        """The launch's exchange table (csrc/pod.cu ``exch_args``) for the
        legs' current tensors, with the next epoch."""
        steps, jobs = self.layout.copies(legs, self.base, self.peers)
        self.epoch += 1
        peers = [self.peers.get(k) or 0
                 for k in ((0, -1), (0, 1), (1, -1), (1, 1))]
        out = [self.epoch, int(WAIT_LIMIT_S * 1e9), self.base, *peers,
               self.waits.data_ptr(), self._status[1], len(steps),
               len(jobs)]
        for st in steps:
            out += st
        for j in jobs:
            out += j
        return out

    def timed_out(self) -> int:
        """The wait that passed its limit in the last launch (1: the start
        barrier, 1 + k: step k), or 0."""
        return ctypes.c_int.from_address(self._status[0]).value

    def last_waits_ms(self) -> List[float]:
        """The last launch's waits in ms: the start barrier, then each
        step (synchronises)."""
        return [w / 1e6 for w in self.waits.tolist()]


# Each chain launch's grid: (blocks, resident blocks an SM, dynamic shared
# memory bytes), by counter name, from the last launch.
last_grid = {}


def _chain_launch(legs: Sequence[Leg], params: GridParams, S: int, up: bool,
                  exchange: Optional[Exchange],
                  peers: Optional[ChainPeers]) -> Optional[torch.Tensor]:
    base = "pod_up" if up else "pod_down"
    _check_chain(legs, params, S, up)
    if legs[0].f.device.type == "cpu":
        return _chain_plain(legs, params, S, exchange)
    name = kernels.variant(base + ("_ranks" if peers is not None else ""),
                           params.mode)
    if exchange is not None and peers is None:
        raise ValueError(f"{name} on a multi-rank mesh takes the chain's "
                         "peer registry (ChainPeers)")
    if peers is not None and (peers.up != up or peers.mode != params.mode):
        raise ValueError(f"{name}: the registry is of another chain")
    if len(legs) > MAX_LEGS:
        raise ValueError(f"{name}: {len(legs)} legs, one launch takes "
                         f"{MAX_LEGS}")
    ptrs: List = []
    ints: List[int] = []
    fls: List[float] = []
    partials = None
    for i, leg in enumerate(legs):
        if box_empty(leg.box):
            raise ValueError(f"{name}: a leg with an empty box")
        slabs, cslabs = (None, None) if peers is None else peers.slabs(i)
        p, iv, f, part = sl._launch_args(
            leg.v_out, leg.v, leg.f, slabs, leg.box, leg.glob, params,
            leg.h, S, **leg.kwargs(cslabs),
        )
        ptrs += p
        ints += iv
        fls += f
        if part is not None:
            partials = part
    xv = None if peers is None else peers.table(legs)
    info = (ctypes.c_longlong * 3)()
    dev = legs[0].f.device
    rc = kernels.lib().mg_pod_chain(
        int(up), len(legs), (ctypes.c_void_p * len(ptrs))(*ptrs),
        (ctypes.c_int * len(ints))(*ints),
        (ctypes.c_float * len(fls))(*fls), *sl._tap_args(params), info,
        None if xv is None else (ctypes.c_longlong * len(xv))(*xv),
        0 if xv is None else len(xv), kernels._stream(dev),
    )
    kernels._check_rc(rc, name)
    kernels.launches[name] += 1
    last_grid[name] = tuple(info)
    if peers is not None:
        # A wait past its limit traps: the launch fails, and so does this
        # rank's next synchronisation; name the chain, the rank and the
        # wait here.
        try:
            torch.cuda.current_stream(dev).synchronize()
        except RuntimeError as e:
            k = peers.timed_out()
            what = ("no wait passed its limit" if k == 0 else
                    "the start barrier's wait passed its limit" if k == 1
                    else f"exchange step {k - 2}'s wait passed its limit")
            raise RuntimeError(
                f"{name} on rank {peers.rank} failed ({what}, "
                f"{WAIT_LIMIT_S:g} s): {e}") from e
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
             exchange: Optional[Exchange] = None,
             peers: Optional[ChainPeers] = None) -> None:
    """The down chain: S pre-sweeps, the residual and its restriction (FAS:
    R(v) and the tau fold) per leg, in one launch.  On a multi-rank mesh
    ``exchange`` serves CPU tensors and ``peers`` (the chain's
    ``ChainPeers``) CUDA tensors."""
    _chain_launch(legs, params, S, False, exchange, peers)


def pod_up(legs: Sequence[Leg], params: GridParams, T: int,
           exchange: Optional[Exchange] = None,
           peers: Optional[ChainPeers] = None) -> Optional[torch.Tensor]:
    """The up chain: the prolongation first, then T post-sweeps per leg,
    in one launch; returns the norm partials of the last leg when it has
    the norm consumer.  ``exchange`` and ``peers`` as ``pod_down``'s."""
    return _chain_launch(legs, params, T, True, exchange, peers)
