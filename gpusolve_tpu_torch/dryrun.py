"""Entry points: one cycle on the device, and a dry run of every
distributed engine on gloo CPU ranks.

The counterpart of the JAX package's ``__graft_entry__.py``.

``entry(device=None)`` returns ``(fn, (state,))``: ``fn(state)`` runs one
LINEAR V(3,3) cycle at 63³ float32 (``solver.vcycle.vcycle``) and returns
``(state, residual norm)``; on the card unless ``device`` asks for the CPU.
``fn.keywords["params"]`` holds its configuration.

``dryrun_multichip(n)`` spawns ``n`` processes joined in one gloo group on
the CPU and runs one step of every section of the JAX dry run
(``__graft_entry__.py:110-270``), with its shapes, meshes and cutoffs, in
its order (``SECTIONS``).  A section on a smaller mesh than ``n`` runs on
the first ranks; one that needs more ranks than ``n`` is announced as not
run.  Rank 0 prints ``[dryrun] <section> ok`` and the section's
engagement line (the plan: distributed levels, the fused down and up
levels, whether the rdma exchange runs, the replicated tail; the GSPMD
sections: blocked and replicated levels).  A section that fails raises,
and the run with it.  Returns, for each section that ran, rank 0's
history and engagement line.

    python -m gpusolve_tpu_torch.dryrun [n] [--platform cpu]

runs ``entry()``'s cycle (on the card, or the CPU) and
``dryrun_multichip(n)`` (default 8, every section).
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import json
import math
import os
import sys
import tempfile
from typing import Dict, List, Optional, Tuple

from gpusolve_tpu_torch.config import GridParams, Mode, Stencil

Shape = Tuple[int, int, int]


def entry(device=None):
    """(fn, example_args): one LINEAR V(3,3) cycle at 63³ float32."""
    from gpusolve_tpu_torch.grid import build_grid
    from gpusolve_tpu_torch.solver.vcycle import vcycle

    params = GridParams(
        maxiter=10, tol=1e-5, grid_dim=(63, 63, 63), mode=Mode.LINEAR,
        pre_smoothing=3, post_smoothing=3, omega=0.8, gamma=1.0,
        stencil=Stencil.poisson_7pt(), print_progress=False,
    )
    state = build_grid(params, device=device)
    return functools.partial(vcycle, params=params), (state,)


# The dry run's problem (``__graft_entry__.py:129-140``): FAS exercises
# every transfer op.
BASE = GridParams(
    maxiter=1, tol=1e-5, grid_dim=(15, 15, 15), mode=Mode.NONLINEAR,
    pre_smoothing=2, post_smoothing=2, omega=0.8, gamma=1.0,
    stencil=Stencil.poisson_7pt(), print_progress=False,
)


@dataclasses.dataclass(frozen=True)
class Section:
    """One step of the dry run: ``engine`` "gspmd" (``solve`` with
    ``shardings=``), "spmd" (``solve_spmd`` / ``newton_solve_spmd`` with
    ``kw``) or "refine" (``solve_refine`` with the first section's
    shardings); ``mesh`` None is the ``factor_devices(n)`` mesh."""

    name: str
    engine: str
    params: GridParams
    mesh: Optional[Shape] = None
    cutoff: int = 2
    kw: Tuple[Tuple[str, str], ...] = ()

    def ranks(self, n: int) -> int:
        return n if self.mesh is None else math.prod(self.mesh)


_LIN = BASE.replace(mode=Mode.LINEAR)
SECTIONS = (
    Section("gspmd FAS", "gspmd", BASE),
    Section("spmd LINEAR", "spmd", _LIN),
    Section("spmd FAS", "spmd", BASE),
    Section("spmd NEWTON", "spmd", BASE.replace(mode=Mode.NEWTON)),
    # x-split: the legs' x slabs through the rdma exchange, and the pod
    # engine (V and W).
    Section("rdma x-split", "spmd", _LIN.replace(grid_dim=(63, 31, 127)),
            (2, 1, 1), kw=(("local_backend", "pallas"), ("halo", "rdma"))),
    Section("pod x-split", "spmd", _LIN.replace(grid_dim=(63, 31, 63)),
            (2, 1, 1), kw=(("fuse", "pod"),)),
    Section("pod W-cycle x-split", "spmd",
            _LIN.replace(grid_dim=(63, 31, 63), cycle_type="W"), (2, 1, 1),
            kw=(("fuse", "pod"),)),
    # y-split legs, and the z mesh axis folded into y (data mesh (2,4,1)).
    Section("ysplit", "spmd", _LIN.replace(grid_dim=(31, 31, 127)),
            (1, 2, 1), kw=(("local_backend", "pallas"),)),
    Section("zfold", "spmd", _LIN.replace(grid_dim=(31, 31, 127)),
            (2, 2, 2), cutoff=1, kw=(("local_backend", "pallas"),)),
    Section("pod y-split", "spmd", _LIN.replace(grid_dim=(31, 31, 127)),
            (2, 2, 2), kw=(("fuse", "pod"),)),
    # float64 outer defect, float32 inner solves on the GSPMD engine.
    Section("refine", "refine", _LIN.replace(maxiter=2, tol=1e-10)),
)


def _engagement(tag: str, plan) -> str:
    return (
        f"[dryrun] {tag}: nd={plan.n_dist} "
        f"fused_down={list(plan.fused_down_levels)} "
        f"fused_up={list(plan.fused_up_levels)} "
        f"rdma={bool(plan.rdma_active)} tail={plan.tail_pv2}"
    )


def _sharding_line(tag: str, shardings) -> str:
    blocked = sum(sh.blocked for sh in shardings)
    return (f"[dryrun] {tag}: gspmd blocked levels {blocked}, replicated "
            f"{len(shardings) - blocked}")


def run_section(sec: Section, mesh, shardings) -> Tuple[List[float], str]:
    """One section on this rank's ``mesh``: its history and its
    engagement line.  Raises on a non-finite history."""
    from gpusolve_tpu_torch.dist.spmd import newton_solve_spmd, solve_spmd
    from gpusolve_tpu_torch.grid import build_grid
    from gpusolve_tpu_torch.solver.refine import solve_refine
    from gpusolve_tpu_torch.solver.vcycle import solve

    p = sec.params
    if sec.engine == "gspmd":
        _, hist = solve(build_grid(p, device="cpu"), p, shardings=shardings)
        line = _sharding_line(sec.name, shardings)
    elif sec.engine == "refine":
        _, hist = solve_refine(p, shardings=shardings)
        if not hist[-1] < hist[0]:
            raise RuntimeError(f"refine did not contract: {hist}")
        line = _sharding_line(sec.name, shardings)
    else:
        fn = newton_solve_spmd if p.mode == Mode.NEWTON else solve_spmd
        _, hist, plan = fn(p, mesh, cutoff=sec.cutoff, **dict(sec.kw))
        line = _engagement(sec.name, plan)
    hist = [float(h) for h in hist]
    if not all(math.isfinite(h) and h >= 0.0 for h in hist):
        raise RuntimeError(f"{sec.name}: non-finite history {hist}")
    return hist, line


def _rank_main(rank: int, n: int, store_path: str, out_path: str) -> None:
    import torch
    import torch.distributed as dist

    from gpusolve_tpu_torch.dist import (
        factor_devices,
        level_shardings,
        make_mesh,
    )

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, n), rank=rank,
        world_size=n, timeout=datetime.timedelta(seconds=300),
    )
    try:
        # Every group is made by every rank, in one order.
        groups = {k: dist.new_group(list(range(k)))
                  for k in sorted({s.ranks(n) for s in SECTIONS})
                  if k < n}
        world = make_mesh(factor_devices(n), device="cpu")
        shardings = level_shardings(BASE, world, coarse_cutoff=2)
        results: Dict[str, dict] = {}
        for sec in SECTIONS:
            k = sec.ranks(n)
            if k > n:
                if rank == 0:
                    print(f"[dryrun] {sec.name} not run: needs {k} ranks, "
                          f"{n} given", flush=True)
                continue
            if rank < k:
                mesh = world if sec.mesh is None else make_mesh(
                    sec.mesh, group=groups.get(k), device="cpu")
                hist, line = run_section(sec, mesh, shardings)
                if rank == 0:
                    results[sec.name] = {"history": hist,
                                         "engagement": line}
                    print(line, flush=True)
                    print(f"[dryrun] {sec.name} ok", flush=True)
            dist.barrier()
        if rank == 0:
            with open(out_path, "w") as fh:
                json.dump(results, fh)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int) -> Dict[str, dict]:
    """Every section on ``n_devices`` gloo ranks on the CPU; returns, for
    each section that ran, ``{"history": [...], "engagement": line}``
    from rank 0."""
    import torch.multiprocessing as mp

    if n_devices < 1:
        raise ValueError(f"dryrun_multichip needs n >= 1, got {n_devices}")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "results.json")
        mp.start_processes(
            _rank_main, args=(n_devices, os.path.join(tmp, "store"), out),
            nprocs=n_devices, join=True, start_method="spawn",
        )
        with open(out) as fh:
            return json.load(fh)


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    device = None
    if "--platform" in args:
        i = args.index("--platform")
        device = args[i + 1]
        del args[i:i + 2]
    n = int(args[0]) if args else 8
    fn, (state,) = entry(device)
    _, res = fn(state)
    print(f"entry ok, residual: {res}")
    dryrun_multichip(n)
    print("dryrun_multichip ok")
    return 0


if __name__ == "__main__":
    from gpusolve_tpu_torch import dryrun

    sys.exit(dryrun.main())
