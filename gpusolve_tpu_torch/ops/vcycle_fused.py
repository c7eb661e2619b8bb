"""One whole V-cycle of any mode in one cooperative launch: the counterpart
of ``gpusolve_tpu/ops/pallas_vcycle.py`` (the TPU's v1 whole-cycle kernel,
``_vcycle_call`` :112, ``supported`` :679, ``vcycle_fused`` :687).

``solve`` runs it for the V-cycles the batch engine (``vcycle_batch``, the
counterpart of the TPU's v2 kernel) does not take: pre or post > 5
sweeps (``solver/vcycle.py``).  The CUDA kernel is ``csrc/vcycle_fused.cu``;
the host builds the cycle's static schedule here, the TPU kernel's:

  * down leg, each non-coarsest level l: the pre-sweeps (a coarse level
    starts from v = 0, except in FAS, so its first sweep reads no v), the
    residual into the level's spare buffer, then its restriction: into the
    coarse f (LINEAR, NEWTON), or R(v) into the coarse v and rest_v and
    the tau fold f_c = R(r) + A_c(rest_v) (FAS);
  * the coarsest level: pre + post sweeps;
  * up leg: v + P(coarse v) (FAS: coarse v − rest_v, computed on the fly,
    leaving the coarse v as it is), written into the spare buffer, then the
    post-sweeps;
  * the final level-0 residual's Σr² (norm only: r is not written).

Each sweep and each prolongation writes the buffer that does not hold v,
so v and r ping-pong as in the TPU kernel; ``final_locs[l]`` says which of
the level's two buffers (0: the one that held v when the cycle started, 1:
its spare) holds v afterwards, and the wrapper hands ``lvl.v``/``lvl.r``
their new tensors.  One departure, for a level that starts from zero with
no sweep at all (pre = 0, or pre + post = 0 at the coarsest): the TPU
kernel then reads the previous cycle's v; here a ZERO op clears it, as the
XLA cycle does (ROADMAP Queue 3).

The coarse tail (``tail_level``, ``tail_range``): from the first level
on which every pass is one tile (7³ for 2^k − 1 grids), one block runs
the cycle's ops, from the restriction into that level down to the
coarsest and back to its last post-sweep, with a block barrier between
them; the other blocks wait at one grid barrier.  The kernel takes the
tail as a range of the op table; the split is a function of the level
dims alone, and the plain version, which runs every op alike, needs
neither.

Within one op no buffer it writes is one it reads (the ping-pong above;
a restriction writes the coarse level, a prolongation the fine spare),
and no field of one level is another level's (``launch`` checks that no
two overlap): the kernel reads level 0's f and NEWTON's ũ, which no op
of the cycle writes, through the read-only cache.  The transfers take
their tiles from a counter per op as blocks come free; ``launch`` hands
the kernel a zeroed counter for each op of the table.

``vcycle_fused_plain`` runs the same schedule over the plain ops
(``ops/kernels.py``'s plain versions, built on ``ops/ref.py``) on the same
buffers; the tests and ``chip_smoke.py`` hold the kernel against it.  The
fields equal the batch engine's one-cycle fields bit for bit, but for the
FAS coarse v (here v, there v − rest_v) and every level's spare buffer.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import torch

from gpusolve_tpu_torch.config import GridParams, Mode
from gpusolve_tpu_torch.grid import GridLevel
from gpusolve_tpu_torch.ops import kernels, ref

NAME = "vcycle_fused"

# Op kinds, numbered as csrc/vcycle_fused.cu numbers them.
ZERO, SMOOTH0, SMOOTH, RESIDUAL, RESTRICT, RESTRICT_V, FAS_F, PROLONG, \
    NORM, FINALIZE = range(10)

Op = Tuple[int, int, int, int]  # (kind, level, a, b)

# A tile: the 32 (z) x 8 (y) x 8 (x) box one block covers in one pass
# (csrc/mg_device.cuh, grid_for).
_TZ, _TY, _TX = 32, 8, 8


def supported(params: GridParams) -> bool:
    """The V schedule only, in the three modes (W and F cycles run the
    batch engine)."""
    if params.cycle_type != "V":
        return False
    return params.mode in (Mode.LINEAR, Mode.NEWTON, Mode.NONLINEAR)


@functools.lru_cache(maxsize=None)
def schedule(
    nlev: int, mode: Mode, pre: int, post: int
) -> Tuple[Tuple[Op, ...], Tuple[int, ...]]:
    """The cycle's ops and ``final_locs``, as ``_vcycle_call`` builds them
    (gpusolve_tpu/ops/pallas_vcycle.py:143-186)."""
    fas = mode == Mode.NONLINEAR
    locs = [0] * nlev
    ops: List[Op] = []

    def emit_smooth(lvl: int, n_iter: int, from_zero: bool) -> None:
        if from_zero and n_iter == 0:
            ops.append((ZERO, lvl, locs[lvl], 0))
        for s in range(n_iter):
            if from_zero and s == 0:
                ops.append((SMOOTH0, lvl, 0, 0))
                locs[lvl] = 0
            else:
                src = locs[lvl]
                ops.append((SMOOTH, lvl, src, 1 - src))
                locs[lvl] = 1 - src

    for lvl in range(nlev - 1):
        emit_smooth(lvl, pre, from_zero=lvl > 0 and not fas)
        ops.append((RESIDUAL, lvl, locs[lvl], 1 - locs[lvl]))
        if fas:
            ops.append((RESTRICT_V, lvl, locs[lvl], 0))
            locs[lvl + 1] = 0
            ops.append((FAS_F, lvl, 1 - locs[lvl], 0))
        else:
            ops.append((RESTRICT, lvl, 1 - locs[lvl], 0))
    emit_smooth(nlev - 1, pre + post, from_zero=not fas)
    for lvl in range(nlev - 1, 0, -1):
        ops.append((PROLONG, lvl, locs[lvl], locs[lvl - 1]))
        locs[lvl - 1] = 1 - locs[lvl - 1]
        emit_smooth(lvl - 1, post, from_zero=False)
    ops.append((NORM, 0, locs[0], 0))
    ops.append((FINALIZE, 0, 0, 0))
    return tuple(ops), tuple(locs)


def tiles(dims: Sequence[int]) -> int:
    """Tiles of a stencil pass over a level of interior ``dims``."""
    nx, ny, nz = dims
    return -(-nz // _TZ) * -(-ny // _TY) * -(-nx // _TX)


def tail_level(dims: Sequence[Sequence[int]]) -> Optional[int]:
    """The first level from which every level is one tile: one block runs
    the cycle's passes over them (the coarse tail), from the restriction
    into this level down and back up to its last post-sweep, with a block
    barrier between them.  A prolongation onto such a level is one tile
    too (it walks nz / 2 + 1 <= 32 coarse z columns).  None when the
    coarsest level is more than a tile."""
    split = None
    for lvl in range(len(dims) - 1, -1, -1):
        if tiles(dims[lvl]) > 1:
            break
        split = lvl
    return split


def _pass_level(op: Op) -> int:
    """The level whose tiles an op's pass walks."""
    kind, lvl = op[0], op[1]
    if kind in (RESTRICT, RESTRICT_V, FAS_F):
        return lvl + 1
    if kind == PROLONG:
        return lvl - 1
    if kind == FINALIZE:
        return 0
    return lvl


def tail_range(ops: Sequence[Op], split: Optional[int]) -> Tuple[int, int]:
    """The coarse tail's ops ``[begin, end)`` in ``ops``: the run whose
    passes walk level ``split`` or a coarser one (a V-cycle visits them in
    one run); empty when ``split`` is None."""
    if split is None:
        return 0, 0
    run = [q for q, op in enumerate(ops) if _pass_level(op) >= split]
    first, n = run[0], len(run)
    assert run == list(range(first, first + n)), "the tail is one run"
    return first, first + n


@functools.lru_cache(maxsize=None)
def _schedule_for(params: GridParams):
    """The cycle's ops, ``final_locs`` and coarse tail."""
    ops, final_locs = schedule(
        params.num_levels, Mode(params.mode), params.pre_smoothing,
        params.post_smoothing,
    )
    return ops, final_locs, tail_range(ops, tail_level(params.level_dims()))


def _aux(lvl: GridLevel, params: GridParams):
    if params.mode == Mode.NEWTON:
        return lvl.newton_v
    if params.mode == Mode.NONLINEAR:
        return lvl.rest_v
    return None


def _hand_over(levels: Sequence[GridLevel], bufs, final_locs) -> None:
    for lvl, (b0, b1), loc in zip(levels, bufs, final_locs):
        lvl.v, lvl.r = (b0, b1) if loc == 0 else (b1, b0)


def vcycle_fused_plain(
    levels: Sequence[GridLevel], params: GridParams
) -> torch.Tensor:
    """Plain version of :func:`vcycle_fused`: the schedule over the plain
    ops, on the same buffers, with the same hand-over."""
    ops, final_locs, _ = _schedule_for(params)
    dims = params.level_dims()
    hs = [params.level_h(i) for i in range(len(levels))]
    bufs = [(lvl.v, lvl.r) for lvl in levels]
    fas = params.mode == Mode.NONLINEAR
    sumsq = levels[0].v.new_empty(1)
    partials = None
    for kind, i, a, b in ops:
        lvl = levels[i]
        nv = lvl.newton_v
        if kind == ZERO:
            ref.interior(bufs[i][a], dims[i]).zero_()
        elif kind == SMOOTH0:
            zero = torch.zeros_like(lvl.f)
            kernels.jacobi_sweep_plain(
                bufs[i][a], zero, lvl.f, dims[i], params, hs[i],
                newton_v=nv,
            )
        elif kind == SMOOTH:
            kernels.jacobi_sweep_plain(
                bufs[i][b], bufs[i][a], lvl.f, dims[i], params, hs[i],
                newton_v=nv,
            )
        elif kind == RESIDUAL:
            kernels.residual_plain(
                bufs[i][b], bufs[i][a], lvl.f, dims[i], params, hs[i],
                newton_v=nv,
            )
        elif kind == RESTRICT:
            kernels.restrict_plain(
                levels[i + 1].f, bufs[i][a], dims[i], dims[i + 1]
            )
        elif kind == RESTRICT_V:
            kernels.restrict_plain(
                bufs[i + 1][0], bufs[i][a], dims[i], dims[i + 1],
                out2=levels[i + 1].rest_v,
            )
        elif kind == FAS_F:
            nxt = levels[i + 1]
            kernels.restrict_plain(nxt.f, bufs[i][a], dims[i], dims[i + 1])
            kernels.apply_fas_plain(
                nxt.f, nxt.rest_v, dims[i + 1], params, hs[i + 1]
            )
        elif kind == PROLONG:
            coarse = bufs[i][a] - lvl.rest_v if fas else bufs[i][a]
            fine = ref.prolong_add(
                bufs[i - 1][b], coarse, dims[i], dims[i - 1]
            )
            ref.interior(bufs[i - 1][1 - b], dims[i - 1]).copy_(
                ref.interior(fine, dims[i - 1])
            )
        elif kind == NORM:
            partials = kernels.residual_plain(
                None, bufs[0][a], lvl.f, dims[0], params, hs[0],
                write_r=False, with_norm=True, newton_v=nv,
            )
        elif kind == FINALIZE:
            kernels.finalize_plain(partials, sumsq)
    _hand_over(levels, bufs, final_locs)
    return sumsq


class _LevelTable:
    """The C interface's per-level host arrays of one configuration: dims
    and scalars."""

    def __init__(self, params: GridParams) -> None:
        dims = params.level_dims()
        n = len(dims)
        self.nlev = n
        self.dims = (ctypes.c_int * (3 * n))(*[d for ds in dims for d in ds])
        scal = []
        for i in range(n):
            h = params.level_h(i)
            # As the per-op wrappers pass them (ops/kernels.py).
            scal += [1.0 / (h * h), (h * h) / params.stencil.diag,
                     params.stencil.diag / (h * h)]
        self.scal = (ctypes.c_float * (3 * n))(*scal)


@functools.lru_cache(maxsize=None)
def _table(params: GridParams) -> _LevelTable:
    return _LevelTable(params)


@functools.lru_cache(maxsize=None)
def _ops_tensor(ops: Tuple[Op, ...], device: str) -> torch.Tensor:
    return torch.tensor(ops, dtype=torch.int32, device=device)


def grid_blocks(mode: Mode) -> int:
    """The blocks a launch in ``mode`` runs: SMs x the resident blocks per
    SM at 256 threads (a cooperative grid must be resident)."""
    blocks = ctypes.c_int(0)
    rc = kernels.lib().mg_vcycle_fused_grid(int(mode), ctypes.byref(blocks))
    kernels._check_rc(rc, NAME)
    return blocks.value


def launch(
    levels: Sequence[GridLevel], params: GridParams, ops: torch.Tensor,
    tail: Tuple[int, int] = (0, 0),
) -> torch.Tensor:
    """One launch of the cooperative kernel over the op table ``ops`` (a
    CUDA int32 ``(n, 4)`` tensor of :func:`schedule`'s ops), whose ops
    ``tail`` (``[begin, end)``) run on one block: the cycle's own table
    and tail, or a table of chosen ops (``chip_smoke.py`` times one op
    kind at a time with it).  Returns the one-element float32 Σr² the
    table's FINALIZE writes; hands no buffer over."""
    dev = kernels._cuda_device(levels[0].v)
    dims = params.level_dims()
    if len(levels) != len(dims):
        raise ValueError(
            f"{len(levels)} levels given, the configuration has {len(dims)}"
        )
    kernels._check(ops, "ops", (ops.shape[0], 4), dev, torch.int32)
    if not 0 <= tail[0] <= tail[1] <= ops.shape[0]:
        raise ValueError(f"tail {tail} outside the table of {ops.shape[0]}")
    tab = _table(params.replace(maxiter=0, tol=0.0, print_progress=False))
    ptrs = (ctypes.c_longlong * (4 * tab.nlev))()
    spans = []
    for i, (lvl, d) in enumerate(zip(levels, dims)):
        shape = kernels._padded(d)
        aux = _aux(lvl, params)
        named = [("v", lvl.v), ("r", lvl.r), ("f", lvl.f)]
        if params.mode != Mode.LINEAR:
            if aux is None:
                what = "newton_v" if params.mode == Mode.NEWTON else "rest_v"
                raise ValueError(f"level {i} has no {what}")
            named.append(("aux", aux))
        for what, t in named:
            kernels._check(t, f"level {i} {what}", shape, dev)
        addr = [t.data_ptr() for _, t in named]
        spans += [(a, a + 4 * t.numel(), f"level {i} {what}")
                  for a, (what, t) in zip(addr, named)]
        ptrs[4 * i: 4 * i + 4] = addr + [0] * (4 - len(addr))
    # The kernel reads level 0's f and NEWTON's ũ through the read-only
    # cache, and each op's outputs are apart from its inputs: no two
    # fields may overlap.
    spans.sort()
    for (_, end, what), (start, _, other) in zip(spans, spans[1:]):
        if start < end:
            raise ValueError(f"{what} and {other} overlap")
    L = kernels.lib()
    partials = torch.empty(
        L.mg_residual_blocks(*dims[0]), dtype=torch.float64, device=dev
    )
    sumsq = torch.empty(1, dtype=torch.float32, device=dev)
    # The transfers' tile counters, one per op (csrc/vcycle_fused.cu:
    # for_tiles_dyn).
    tile_ctr = torch.zeros(ops.shape[0], dtype=torch.int32, device=dev)
    t = kernels._taps(params.stencil)
    rc = L.mg_vcycle_fused(
        ops.data_ptr(), ops.shape[0], tail[0], tail[1],
        int(params.mode), tab.nlev, ptrs,
        tab.dims, tab.scal, t.val, t.off, t.n, params.omega, params.gamma,
        partials.data_ptr(), tile_ctr.data_ptr(), sumsq.data_ptr(),
        kernels._stream(dev),
    )
    kernels._check_rc(rc, NAME)
    kernels.launches[NAME] += 1
    return sumsq


def vcycle_fused(
    levels: Sequence[GridLevel], params: GridParams
) -> torch.Tensor:
    """One V-cycle on ``levels`` in place, in one cooperative launch on a
    CUDA device (the plain version for CPU tensors).  Returns the final
    level-0 Σr² as a one-element float32 tensor on the device; the host
    reads it.  Each level's ``v``/``r`` take their new tensors."""
    if levels[0].v.device.type == "cpu":
        return vcycle_fused_plain(levels, params)
    if not supported(params):
        raise ValueError(
            f"the whole-cycle kernel runs V-cycles in the three modes, got "
            f"a {params.cycle_type}-cycle"
        )
    ops, final_locs, tail = _schedule_for(params)
    bufs = [(lvl.v, lvl.r) for lvl in levels]
    sumsq = launch(levels, params, _ops_tensor(ops, str(levels[0].v.device)),
                   tail)
    _hand_over(levels, bufs, final_locs)
    return sumsq
