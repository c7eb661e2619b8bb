"""The pod engine: two chained launches of distributed legs and one batch
of the replicated tail per V-cycle, on ``torch.distributed``.

The counterpart of ``gpusolve_tpu/dist/pod.py``.  One V-cycle is

    pod_down (the down legs of the pod levels 0..npod-1, one launch)
      -> the replicated tail: the batch engine's cycle on levels
         npod..nlev-1, rooted at the pod's boundary block
      -> pod_up (the up legs npod-1..0 with the finest level's norm,
         one launch)

with the legs of ``ops/pod.py`` (the per-leg engine's trapezoid leg,
``csrc/leg_device.cuh``, chained in one launch a direction,
``csrc/pod.cu``) and the tail of ``ops/vcycle_batch.run_tail``.  W and F
cycles break into suffix chains (``_linearize``): every descent runs down
to the tail, every ascent starts there.  The distribution depth is the
pod depth: levels ``>= npod`` are replicated on every rank.

Layout (``PodPlan``, ``ops/pod.pod_levels``): x halves exactly down the
chain, and so does y under a y split; the boundary block, the tail's root,
takes the replicated layout ``(n+2)³`` where the halving allows it, and
on one rank the tail then runs on it in place: the down chain's last leg
writes the tail root's f (FAS: its v and rest_v) and the up chain's first
leg reads the tail root's v (FAS: v − rest_v, the ``subtract`` kernel in
place).  Otherwise, and on a larger mesh, the boundary block is a buffer
of its own, gathered into the tail's layout after the down chain and
sliced back out of it before the up chain.

The state is the per-leg engine's (``dist/spmd.SpmdEngine``, whose norm,
Newton and gather helpers run here unchanged): per level ``v, f, r``
(FAS ``rest_v``, NEWTON ``newton_v``), the pod levels in their blocks,
then the tail levels in ``(n+2)³``.  Each leg writes its level's spare
buffer ``r`` and the two trade roles, as the per-leg engine's legs do.

Where it runs: on the card the chains run on their CUDA kernels
(float32) or their plain versions (float64, ``backend="ref"``).  On a
multi-rank CUDA mesh each chain exchanges its legs' slabs between ranks
inside its launch, as the TPU kernels do: the engine builds one peer
registry a chain (``ops/pod.ChainPeers``, kept with the rdma exchange's
in ``self.ex.rdma`` and released with them by ``close()``, collectively);
nothing falls back to the host exchange.  Ranks that share one card over
a gloo group run it too (the group then carries the rest, the gathers
and sums, through host copies: ``_Exchange.staged``).  The plain chains
(CPU ranks over gloo, or ``backend="ref"``) exchange each leg's slabs on
the host (``_Exchange.slabs``), x- and y-split.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from gpusolve_tpu_torch.config import GridParams, Mode
from gpusolve_tpu_torch.dist.mesh import Mesh
from gpusolve_tpu_torch.dist.spmd import (
    SpmdEngine,
    SpmdPlan,
    _restrict_local,
    boundary_in_place,
)
from gpusolve_tpu_torch.ops import dispatch as ops
from gpusolve_tpu_torch.ops import kernels
from gpusolve_tpu_torch.ops import pod
from gpusolve_tpu_torch.ops import spmd_leg as sl
from gpusolve_tpu_torch.ops import vcycle_batch


def _linearize(cycle_type: str, npod: int):
    """The (possibly W/F) schedule over the pod levels as maximal launch
    groups: ``("down", a)``, the down legs a..npod-1 (every descent runs
    to the tail, so a down run is a suffix chain); ``("tail", kind,
    count)``, count consecutive tail cycles of one kind (one batch);
    ``("up", a)``, the up legs npod-1..a (every ascent starts at the tail
    and stops where a level still owes sub-cycles).  V gives exactly
    down, tail, up.  A copy of ``gpusolve_tpu/dist/pod.py:153-201``
    (subcycles: W -> (W, W), F -> (F, V))."""
    subcycles = {"V": ("V",), "W": ("W", "W"), "F": ("F", "V")}
    events = []

    def cyc(l, kind):
        if l == npod:
            events.append(("tail", kind))
            return
        events.append(("down", l))
        for sub in subcycles[kind]:
            cyc(l + 1, sub)
        events.append(("up", l))

    cyc(0, cycle_type)
    groups = []
    i = 0
    while i < len(events):
        e = events[i]
        if e[0] == "down":
            a = e[1]
            while events[i][0] == "down":
                i += 1
            groups.append(("down", a))
        elif e[0] == "tail":
            kind = e[1]
            cnt = 0
            while (
                i < len(events) and events[i][0] == "tail"
                and events[i][1] == kind
            ):
                cnt += 1
                i += 1
            groups.append(("tail", kind, cnt))
        else:
            while i < len(events) and events[i][0] == "up":
                a = events[i][1]
                i += 1
            groups.append(("up", a))
    return tuple(groups)


class PodPlan(SpmdPlan):
    """The pod engine's decomposition (``gpusolve_tpu/dist/pod.py:85``),
    with the ``SpmdPlan`` contract: ``mesh_shape`` the data mesh ``(mx,
    my·mz, 1)``, ``block`` the pod levels' per-rank blocks, ``alloc`` the
    global allocation per level (blocks times the mesh, then the tail's
    ``(n+2)³``), ``dims``, ``n_dist = npod``, ``fused_down_levels`` /
    ``fused_up_levels``.  ``levels`` holds ``ops/pod.pod_levels``' entries
    0..npod (npod: the boundary block); ``tail_in_place`` whether the tail
    runs on the boundary block itself (one rank, the same layout)."""

    def __init__(self, params: GridParams, mesh_shape, npod: int):
        self.params = params
        self.local_backend = "auto"  # the gates are the geometry's
        self.device_mesh = tuple(mesh_shape)
        self.mesh_shape = (mesh_shape[0], mesh_shape[1] * mesh_shape[2], 1)
        self.names = (
            "x",
            ("y", "z") if self.device_mesh[2] > 1 else "y",
            "z",
        )
        self.dims = params.level_dims()
        self.nlev = len(self.dims)
        levels = pod.pod_levels(params, self.mesh_shape[:2], npod)
        if levels is None:
            raise ValueError(
                f"pod depth {npod} outside 1..{self.nlev - 1} for grid "
                f"{self.dims[0]}"
            )
        self.npod = self.n_dist = npod
        self.levels = levels
        self.block = [lv[:3] for lv in levels[:npod]]
        mx, my = self.mesh_shape[:2]
        self.alloc = [(mx * bx, my * by, bz) for (bx, by, bz) in self.block]
        self.alloc += [tuple(n + 2 for n in self.dims[l])
                       for l in range(npod, self.nlev)]
        self.tail_pv2 = None  # the per-leg engine's tail mode
        self.tail_in_place = boundary_in_place(
            self.mesh_shape, levels[npod][:3], self.dims[npod]
        )
        self.fused_down_levels = tuple(range(npod))
        self.fused_up_levels = tuple(range(1, npod + 1))

    def shape(self, l: int) -> Tuple[int, int, int]:
        """The per-rank block of level ``l <= npod``."""
        return tuple(self.levels[l][:3])

    def down_refusal(self, l: int, S: int) -> Optional[str]:
        """Why level ``l``'s down leg cannot run in the down chain: the
        leg gate; the junction's leg writes the boundary block."""
        return self.leg_refusal(l, S)

    def up_refusal(self, lc: int, S: int) -> Optional[str]:
        """Why the up leg into level ``lc − 1`` cannot run in the up
        chain (``_trap_corr_ok``, the boundary block as the coarse one at
        ``lc = npod``)."""
        if lc > self.npod:
            return "a replicated level"
        why = self.leg_refusal(lc - 1, S)
        if why is not None:
            return why
        if S > sl.MAX_CORR_SWEEPS:
            return f"{S} sweeps (the corr-first leg takes 1..4)"
        for ax, name in ((0, "x"), (1, "y")):
            if self.mesh_shape[ax] > 1 and self.levels[lc][ax] < sl.GC:
                return (f"coarse block {self.shape(lc)} is shorter than the "
                        f"{sl.GC}-deep slab along {name}")
        return None

    def refusal(self) -> Optional[str]:
        """Why the pod engine cannot run this plan, or None: the leg gates
        on every pod level both ways (``pallas_pod.pod_supported``), the
        legs a chain takes, and the chains' shared memory (a block of a
        launch holds its leg's rings at once)."""
        pre, post = self.params.pre_smoothing, self.params.post_smoothing
        for l in range(self.npod):
            for what, why in (("down", self.down_refusal(l, pre)),
                              ("up", self.up_refusal(l + 1, post))):
                if why is not None:
                    return f"level {l} {what} leg: {why}"
        if self.npod > pod.MAX_LEGS:
            return f"{self.npod} pod levels (a chain takes {pod.MAX_LEGS})"
        smem = max(pod.chain_smem_bytes(self.params.mode, pre, post))
        if smem > pod.SMEM_MAX:
            return (f"{smem} bytes of shared memory a block, over "
                    f"{pod.SMEM_MAX}")
        return None

    def cost(self) -> int:
        """The cells a rank streams a cycle, as ``choose_npod`` weighs
        them: its pod blocks, and every tail level whole (the tail runs
        on every rank)."""
        pods = sum(bx * by * bz for (bx, by, bz) in self.block)
        return pods + sum(
            (nx + 2) * (ny + 2) * (nz + 2)
            for (nx, ny, nz) in self.dims[self.npod:]
        )


def pod_supported(params: GridParams, mesh_xy, npod: int) -> bool:
    """Whether the pod engine runs depth ``npod`` on the ``(mx, my)`` data
    mesh (``gpusolve_tpu/ops/pallas_pod.py:194``): the depth in range and
    ``PodPlan.refusal`` None."""
    if not 1 <= npod < len(params.level_dims()):
        return False
    return PodPlan(params, (mesh_xy[0], mesh_xy[1], 1), npod).refusal() \
        is None


def choose_npod(params: GridParams, mesh_xy, cutoff: int = 4
                ) -> Optional[int]:
    """The pod depth of least streamed volume per rank
    (``gpusolve_tpu/dist/pod.py:55``), costed on the port's dense volumes:
    a pod level costs its block, a tail level its whole ``(n+2)³`` on
    every rank, so deeper pods pay x-alignment padding and shallower ones
    redundant tail work.  Depths whose gates refuse, or whose deepest pod
    level's block is under ``max(16, cutoff)`` along x (the reference's
    minimum), are skipped; None when none is left.  ``mesh_xy``: the
    ``(mx, my)`` data mesh (an int: ``(mx, 1)``)."""
    if isinstance(mesh_xy, int):
        mesh_xy = (mesh_xy, 1)
    best = None
    for npod in range(1, len(params.level_dims())):
        plan = PodPlan(params, (mesh_xy[0], mesh_xy[1], 1), npod)
        if plan.refusal() is not None or \
                plan.levels[npod - 1][0] < max(16, cutoff):
            continue
        cost = plan.cost()
        if best is None or cost < best[1]:
            best = (npod, cost)
    return best[0] if best else None


def _restrict_into(asm: torch.Tensor, cshape) -> torch.Tensor:
    """Full weighting of a ghost-extended fine block into a coarse block
    of ``cshape`` (``dist/spmd._restrict_local``), zero fine cells past
    the assembled block where the pod's free y and z extents read them."""
    need = [max(0, 2 * c + 1 - n) for c, n in zip(cshape, asm.shape)]
    if any(need):
        asm = torch.nn.functional.pad(
            asm, (0, need[2], 0, need[1], 0, need[0])
        )
    return _restrict_local(asm, cshape)


class PodEngine(SpmdEngine):
    """One rank's part of the pod engine, with the ``SpmdEngine``
    contract (``init_state``, ``cycle``, ``run_cycles``,
    ``residual_norm``, ``norm_sumsq``, ``comp_f``,
    ``restrict_newton_v``), so ``solve_spmd``, ``newton_solve_spmd`` and
    ``gather_solution`` run on it unchanged.  ``npod`` None takes
    ``choose_npod``'s depth."""

    def __init__(self, params: GridParams, mesh: Mesh, cutoff: int = 4,
                 local_backend: str = "auto", npod: Optional[int] = None):
        mesh_xy = (mesh.shape[0], mesh.shape[1] * mesh.shape[2])
        if npod is None:
            npod = choose_npod(params, mesh_xy, cutoff)
            if npod is None:
                raise ValueError(
                    "the pod engine cannot run this geometry or mode (no pod "
                    "depth passes its gates); use fuse='leg'"
                )
        plan = PodPlan(params, mesh.shape, npod)
        why = plan.refusal()
        if why is not None:
            raise ValueError(f"the pod engine cannot run depth {npod}: {why}")
        # local_backend is the per-leg engine's knob; the pod engine's
        # chains always run (as the reference's, which ignores it).
        super().__init__(params, mesh, cutoff, "auto", plan=plan)
        self.local_backend = local_backend
        p = self.plan
        self.npod = npod
        self.groups = _linearize(self.params.cycle_type, npod)
        self.tail_params = {
            g[1]: self.params.replace(grid_dim=p.dims[npod], cycle_type=g[1])
            for g in self.groups if g[0] == "tail"
        }
        self.exchange = self.ex.slabs if mesh.size > 1 else None
        self._done = torch.zeros(1, dtype=torch.int32, device=self.device)

    def _run_chain(self, up: bool, a: int, legs: List[pod.Leg]):
        """One chain: its kernel (on a multi-rank mesh with the chain's
        peer registry, built on first use, collectively) or its plain
        version, per the engine's ``plain_reason``."""
        prm = self.params
        S = prm.post_smoothing if up else prm.pre_smoothing
        if self.plain_reason is not None:
            plain = pod.pod_up_plain if up else pod.pod_down_plain
            return plain(legs, prm, S, self.exchange)
        peers = None
        if self.mesh.size > 1 and self.device.type == "cuda":
            key = ("pod", up, a)
            peers = self.ex.rdma.get(key)
            if peers is None:
                peers = self.ex.rdma[key] = pod.ChainPeers(self.ex, legs,
                                                           prm, up)
        return (pod.pod_up if up else pod.pod_down)(legs, prm, S,
                                                    self.exchange, peers)

    # -- the three stages ----------------------------------------------------

    def down_legs(self, a: int, levels) -> List[pod.Leg]:
        """The down chain a..npod-1 over ``levels``: each leg from the
        level's v into its spare buffer, restricting into the next level
        (the last leg into the tail's root, or the boundary buffers where
        the tail is not in place)."""
        npod, fas = self.npod, self.fas
        legs = []
        for l in range(a, npod):
            lvl, nxt = levels[l], levels[l + 1]
            if l + 1 == npod:
                cout = self._root_outputs(nxt)
            else:
                cout = (nxt.f, nxt.v, nxt.rest_v) if fas else \
                    (nxt.f, None, None)
            legs.append(pod.Leg(
                v_out=lvl.r, v=lvl.v, f=lvl.f, box=self.boxes[l],
                glob=self.globs[l], h=self.hs[l], newton_v=lvl.newton_v,
                src_zero=l > a and not fas, consumer="restrict", cout=cout,
                cbox=self.boxes[l + 1], cdims=self.plan.dims[l + 1],
                tau_h=self.hs[l + 1] if fas else 0.0,
            ))
        return legs

    def up_legs(self, a: int, levels, coarse: torch.Tensor
                ) -> List[pod.Leg]:
        """The up chain npod-1..a over ``levels``, its first leg prolonging
        ``coarse`` (the boundary block; FAS: v − rest_v already), each next
        one the previous leg's output; FAS legs below the head write
        v − rest_v, the level-0 leg has the norm."""
        legs = []
        for l in range(self.npod - 1, a - 1, -1):
            lvl = levels[l]
            legs.append(pod.Leg(
                v_out=lvl.r, v=lvl.v, f=lvl.f, box=self.boxes[l],
                glob=self.globs[l], h=self.hs[l], newton_v=lvl.newton_v,
                coarse=coarse, consumer="norm" if l == 0 else None,
                sub_rv=lvl.rest_v if self.fas and l > a else None,
            ))
            coarse = lvl.r
        return legs

    def _pod_down(self, a: int, levels) -> None:
        """The down chain a..npod-1 in one launch; where the tail is not in
        place, its boundary outputs then gathered into the tail's root."""
        npod = self.npod
        self._run_chain(False, a, self.down_legs(a, levels))
        for l in range(a, npod):
            levels[l].v, levels[l].r = levels[l].r, levels[l].v
        self._gather_root(levels[npod])

    def _tail(self, kind: str, cnt: int, levels, fresh: bool) -> None:
        """``cnt`` cycles of the replicated tail; a fresh LINEAR or NEWTON
        tail (the first after a descent) starts from v = 0, a FAS one at
        the R(v) the down chain left."""
        vcycle_batch.run_tail(
            levels[self.npod:], self.tail_params[kind], cnt,
            zero_start=fresh and not self.fas, done=self._done,
        )

    def _pod_up(self, a: int, levels) -> Optional[torch.Tensor]:
        """The up chain npod-1..a in one launch from the tail root's v
        (FAS: v − rest_v, in place); returns the level-0 leg's norm
        partials when ``a == 0``."""
        prm, npod = self.params, self.npod
        root = levels[npod]
        if self.fas:
            ops.subtract_op(root.v, root.rest_v, self.plan.dims[npod], prm,
                            self._done)
        partials = self._run_chain(
            True, a, self.up_legs(a, levels, self._root_coarse(root)))
        for l in range(a, npod):
            levels[l].v, levels[l].r = levels[l].r, levels[l].v
        return partials

    # -- the SpmdEngine contract -----------------------------------------------

    def cycle(self, state, out: torch.Tensor) -> None:
        """One cycle of ``params.cycle_type`` on ``state`` in place, group
        by group of ``_linearize``, and this rank's finest-level Σr² after
        it into ``out`` (the level-0 up leg's norm).  Only the first tail
        group after a descent starts fresh; the next one of another kind
        (F's (F, V)) continues from the tail the previous one left."""
        levels = list(state.levels)
        partials, fresh = None, False
        for grp in self.groups:
            if grp[0] == "down":
                self._pod_down(grp[1], levels)
                fresh = True
            elif grp[0] == "tail":
                self._tail(grp[1], grp[2], levels, fresh)
                fresh = False
            else:
                partials = self._pod_up(grp[1], levels)
        self._finalize(partials, out)

    def restrict_newton_v(self, state) -> None:
        """ũ restricted down the pod levels and into the tail root, then
        down the tail, to levels 1..L−2: never the coarsest (reference
        src/cpu/NewtonSolver.cpp:88-92)."""
        levels, npod, nlev = state.levels, self.npod, self.nlev
        for l in range(min(npod, nlev - 2)):
            part = self._mask(l + 1, _restrict_into(
                self.ex.halo(levels[l].newton_v), self.plan.shape(l + 1)
            ))
            levels[l + 1].newton_v = part if l + 1 < npod else \
                self._to_repl(part)
        dims = self.plan.dims
        for l in range(npod, nlev - 2):
            ops.restrict_op(levels[l + 1].newton_v, levels[l].newton_v,
                            dims[l], dims[l + 1], self.params)


def launches_per_cycle(plan: PodPlan) -> dict:
    """Kernel launches one pod cycle makes on the card, by kernel
    (``dist/spmd.launches_per_cycle``'s counterpart): one ``pod_down`` a
    down group, the batch engine's kernels a tail group (its fused legs
    and the coarsest sweeps, without a norm), one ``pod_up`` a up group,
    FAS one ``subtract`` (the boundary's v − rest_v) before it; the
    cycle's norm is the level-0 leg's, so one ``finalize``.  On a
    multi-rank mesh the chains count as ``pod_down_ranks`` /
    ``pod_up_ranks``."""
    params = plan.params
    mode = params.mode
    ranks = "_ranks" if plan.mesh_shape[0] * plan.mesh_shape[1] > 1 else ""
    counts = {}

    def add(name, n=1):
        counts[name] = counts.get(name, 0) + n

    for grp in _linearize(params.cycle_type, plan.npod):
        if grp[0] == "down":
            add(kernels.variant("pod_down" + ranks, mode))
        elif grp[0] == "tail":
            tail = params.replace(grid_dim=plan.dims[plan.npod],
                                  cycle_type=grp[1])
            for name, n in vcycle_batch.launches_per_cycle(
                tail, norm=False
            ).items():
                add(name, n * grp[2])
        else:
            if mode == Mode.NONLINEAR:
                add("subtract")
            add(kernels.variant("pod_up" + ranks, mode))
    add("finalize")
    return counts


def build_pod_solver(params: GridParams, mesh: Mesh, cutoff: int = 4,
                     npod: Optional[int] = None,
                     local_backend: str = "auto") -> PodEngine:
    """This rank's pod engine (``gpusolve_tpu/dist/pod.py:204``): at
    ``choose_npod``'s depth, or ``npod``.  Raises ``ValueError`` where the
    gates refuse every depth."""
    return PodEngine(params, mesh, cutoff, local_backend, npod)
