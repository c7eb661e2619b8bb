"""Command-line entry point: ``python -m gpusolve_tpu_torch.cli <config>``.

The single-device counterpart of ``gpusolve_tpu/cli.py``, with the same
progress lines (``Using config file …``, ``Solving linear problem`` /
``Solving nonlinear problem`` / ``Solving newton problem``,
``Inital residual: …`` or ``Inital newton residual: …``, then
``iter: N residual: R Took Xms`` or ``newton iter: N …``) that the
reference's experiment harness parses.  Modes 0 and 1 run ``solve``;
mode 2 runs ``newton_solve``, whose solution is level 0's ``newton_v``.

Flags:
  --dtype {float32,float64}  float32 runs the CUDA kernels; float64 runs
                             the plain ops (on the card, or the CPU)
  --backend {auto,ref,cuda,cpu-native}
                             CUDA kernels, plain PyTorch ops, kernels only
                             (see config.py), or the C++/OpenMP host
                             solver in float64 (cpu_native.py; no card
                             needed, V cycles only, no --refine or
                             --profile; --mesh is checked but the host
                             solver runs the whole grid)
  --check-every K            cycles per batch (one host sync per batch) on
                             the batch engine; in mode 2 outer Newton steps
                             per batch where it runs on the kernels
  --cycle {V,W,F}            cycling schedule
  --quiet                    no progress lines
  --platform P               ``cpu`` runs on the host; default CUDA
  --devices                  print the CUDA device before solving
  --dump PATH                write the final solution in the reference's
                             Vector3::dump text format
  --validate                 print the max-abs error against the analytic
                             solution (modes 1 and 2)
  --explain-backend          print (stderr) which engine runs: the batch
                             of kernels (a level visit as two fused legs,
                             or per op), the v1 whole-cycle kernel, or
                             the plain ops
  --profile DIR              trace the solve with torch.profiler and write
                             a Chrome trace into DIR
  --save-state PATH          write a resumable checkpoint (.npz) after the
                             solve (utils/checkpoint.py)
  --load-state PATH          resume from a checkpoint, of this package or
                             of the JAX package
  --refine                   mixed-precision iterative refinement: float64
                             outer defect, float32 inner solves on the
                             kernels (solver/refine.py)
  --refine-inner-tol T       the inner solves' relative tolerance

Distributed (the spmd engine: dist/spmd.py per leg, dist/pod.py pod; the
gspmd engine: dist/sharding.py, dist/gspmd.py):
  --mesh X,Y,Z               the process mesh; 1,1,1 runs in one process
                             (on the card, or --platform cpu), larger
                             meshes one process per shard under
                             ``torchrun --nproc-per-node N -m
                             gpusolve_tpu_torch.cli ... --mesh ...`` (gloo
                             with --platform cpu, else NCCL, one card per
                             rank); only rank 0 prints
  --dist-engine {auto,spmd,gspmd}, --fuse {auto,leg,pod},
  --halo {ppermute,rdma}     the JAX CLI's engine flags.  auto takes spmd
                             wherever it can run the configuration, else
                             gspmd with a note (a single-level grid, a
                             grid smaller than the mesh); gspmd is the
                             debugging/fallback engine: the single-device
                             cycle per op on each rank's blocks, each op
                             fetching the boxes it reads (--fuse and
                             --halo do not apply to it).  --halo rdma
                             exchanges the legs' x slabs in one CUDA
                             launch of peer writes (ops/rdma.py); under a
                             y split the two-stage exchange runs
                             instead, with a note.  --fuse
                             auto takes the pod engine where the
                             reference's CLI does (a depth passes its
                             gates), else leg, and says why: --halo rdma
                             takes leg.  On the
                             card --fuse leg runs the replicated tail
                             (dist/spmd.py, tail="auto")
With --mesh on the spmd engine, --save-state and --load-state write and
read its checkpoint (utils/checkpoint.save_state_spmd, keyed on the mesh,
the engine and the plan), and --refine runs the inner float32 solves on
it (solver/refine.solve_refine_spmd); on the gspmd engine the checkpoint
is the single-device one (written by rank 0) and --refine runs
solve_refine with the shardings.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
from typing import Optional

from gpusolve_tpu_torch.config import BACKENDS

# The reference announces the mode (gpusolve_tpu/cli.py:411-417).
_MODE_LINES = {
    0: "Solving linear problem",
    1: "Solving nonlinear problem",
    2: "Solving newton problem",
}


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="gpusolve_tpu_torch",
        description="3D geometric-multigrid solver on one CUDA device",
    )
    ap.add_argument("config", help="path to config file (14-line format)")
    ap.add_argument(
        "--dtype", choices=["float32", "float64"], default="float32"
    )
    ap.add_argument(
        "--backend", choices=BACKENDS, default="auto",
        help="auto: CUDA kernels on the card, plain ops on the CPU; ref: "
        "plain PyTorch ops on any device; cuda: kernels only; cpu-native: "
        "the C++/OpenMP host solver in float64 "
        "(ops/csrc/gpusolve_cpu.cpp)",
    )
    ap.add_argument(
        "--check-every", type=int, default=1, metavar="K",
        help="batch K cycles per host sync (the early stop runs on the "
        "device, so the history and final state do not depend on K); "
        "NEWTON mode batches K outer steps per host sync where the batch "
        "engine runs on the kernels",
    )
    ap.add_argument("--cycle", choices=["V", "W", "F"], default="V")
    ap.add_argument(
        "--quiet", action="store_true", help="suppress progress lines"
    )
    ap.add_argument(
        "--platform", default=None, metavar="P",
        help="'cpu' runs on the host; default (or 'cuda'/'gpu'): the "
        "CUDA device",
    )
    ap.add_argument(
        "--devices", action="store_true",
        help="print the CUDA device before solving",
    )
    ap.add_argument(
        "--dump", default=None, metavar="PATH",
        help="write the final solution in Vector3::dump text format",
    )
    ap.add_argument(
        "--validate", action="store_true",
        help="print the max-abs error vs the analytic solution (modes 1, 2)",
    )
    ap.add_argument(
        "--explain-backend", action="store_true",
        help="print (stderr) which engine and kernel path this "
        "configuration runs",
    )
    ap.add_argument(
        "--profile", default=None, metavar="DIR",
        help="trace the solve with torch.profiler into DIR (a Chrome "
        "trace, trace.json)",
    )
    ap.add_argument(
        "--save-state", default=None, metavar="PATH",
        help="write a resumable checkpoint (.npz) after solving",
    )
    ap.add_argument(
        "--load-state", default=None, metavar="PATH",
        help="resume from a checkpoint written by --save-state (this "
        "package's or the JAX package's)",
    )
    ap.add_argument(
        "--refine", action="store_true",
        help="mixed-precision iterative refinement: float64-accurate "
        "solves at float32 multigrid speed (float64 outer defect + float32 "
        "cycle corrections; see solver/refine.py). tol is the float64 "
        "relative-residual target, maxiter the outer-step limit",
    )
    ap.add_argument(
        "--refine-inner-tol", type=float, default=1e-3, metavar="T",
        help="relative tolerance of each inner float32 multigrid solve "
        "under --refine",
    )
    ap.add_argument(
        "--mesh", default=None,
        help="comma-separated 3-D process mesh, e.g. 2,2,1 (default: one "
        "device); more than one process runs under torchrun",
    )
    ap.add_argument(
        "--dist-engine", choices=["auto", "spmd", "gspmd"], default="auto",
        help="with --mesh: spmd (explicit halo exchange on "
        "torch.distributed, shard-local CUDA kernels); gspmd (the "
        "debugging/fallback engine: the per-op cycle on each rank's "
        "blocks); auto: spmd wherever it can run, else gspmd",
    )
    ap.add_argument(
        "--fuse", choices=["auto", "leg", "pod"], default="auto",
        help="with --mesh: one kernel per leg (leg), or every down leg of "
        "a cycle in one launch and every up leg in another around a "
        "replicated tail (pod); auto takes pod wherever its gates allow",
    )
    ap.add_argument(
        "--halo", choices=["ppermute", "rdma"], default="ppermute",
        help="with --mesh: face exchange by point-to-point messages "
        "(ppermute), or the legs' x slabs by peer writes in one CUDA "
        "launch (rdma; x-split meshes, the per-leg engine)",
    )
    return ap


def _device(platform):
    if platform in (None, "cuda", "gpu"):
        return None  # resolve_device's default: CUDA, raising without one
    if platform == "cpu":
        return "cpu"
    raise ValueError(f"unknown --platform {platform!r} (use cpu or cuda)")


_ENGINE_LINES = {
    "batch": "single device: batch of CUDA kernels, early stop on "
             "the device (ops/vcycle_batch; the v2 whole-batch kernel's "
             "counterpart, of whose gates only the sweep cap applies: "
             "its TPU layout gates are not ported)",
    "v1": "single device: v1 whole-cycle kernel, one cooperative launch "
          "per V-cycle (ops/vcycle_fused)",
    "plain": "single device: plain PyTorch ops",
}


def _single_device_notes(params, device, _explain) -> None:
    """The engine the solve runs (under --explain-backend) and, on stderr,
    why it runs without the fused fast path (the JAX package's
    ``_single_device_notes``, gpusolve_tpu/cli.py:221-261)."""
    from gpusolve_tpu_torch.ops.dispatch import plain_reason
    from gpusolve_tpu_torch.solver import vcycle as vc

    reason = vc.engine_note(params, device)
    if reason is not None:
        print(
            f"note: running without the fused mega-kernel: {reason}",
            file=sys.stderr,
        )
    kind = vc.engine(params, device)
    line = _ENGINE_LINES[kind]
    if kind == "plain":
        why = plain_reason(params, device, params.dtype)
        line += f" ({why}; ops/ref.py)"
    lines = [line]
    if kind != "v1":
        lines.append(vc.legs_note(params))
    _explain(lines)


@contextlib.contextmanager
def _profiled(out_dir: str, device):
    """torch.profiler around the solve; the Chrome trace goes into
    ``out_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))


def _spmd_notes(params, eng, args, _explain) -> None:
    """The distributed engine's plan and kernel path (under
    --explain-backend) and, on stderr, why it runs without the kernels
    (the JAX package's ``_spmd_notes``, gpusolve_tpu/cli.py:154-200)."""
    plan = eng.plan
    if args.halo == "rdma" and args.fuse == "leg" and not plan.rdma_active:
        print(
            "note: --halo rdma carries x-face slabs only; the y-split "
            "two-stage ppermute exchange runs instead on this mesh",
            file=sys.stderr,
        )
    if eng.plain_reason == "float64":
        print(
            "note: shard-local compute runs the plain ops: dtype float64 "
            "(the CUDA kernels are float32)", file=sys.stderr,
        )
    if not eng.face_taps:
        print("note: the stencil has edge or corner taps: the distributed "
              "levels run the plain ops over the assembled block, as the "
              "JAX engine's assembled-halo path", file=sys.stderr)
    nd = plan.n_dist
    fold = (
        f" (z mesh axis folded into y: data mesh {plan.mesh_shape})"
        if plan.device_mesh != plan.mesh_shape else ""
    )
    kind = (
        "CUDA shard-local kernels (ops/spmd_leg, ops/spmd_kernels)"
        if eng.plain_reason is None
        else f"plain shard-local ops ({eng.plain_reason})"
    )
    lines = [
        f"dist-engine=spmd fuse={args.fuse} halo={args.halo} "
        f"({nd} distributed levels, {plan.nlev - nd} replicated){fold}",
    ]
    in_place = ("in place on the boundary block" if plan.tail_in_place
                else "gathered from the boundary blocks")
    if args.fuse == "pod":
        lines.append(
            f"pod depth {nd}: levels 0..{nd - 1} in one down launch and one "
            f"up launch (ops/pod, csrc/pod.cu), the tail from level {nd} "
            + in_place
        )
    elif plan.tail_pv2 is not None:
        # The reference's line (gpusolve_tpu/cli.py:187-191), for the
        # batch engine.
        lines.append(
            f"replicated tail: ONE batch-engine cycle a visit from level {nd} "
            f"(ops/vcycle_batch.run_tail; direct layout "
            f"{tuple(plan.tail_pv2)}, {in_place})"
        )
    pre, post = params.pre_smoothing, params.post_smoothing
    for l in range(nd):
        # The per-level tags of the JAX CLI (gpusolve_tpu/cli.py:193-205),
        # and the gate that refused a leg.
        tags, refused = [], []
        for tag, why in (
            ("fused-down", plan.down_refusal(l, pre)),
            ("fused-up", plan.up_refusal(l + 1, post)),
        ):
            if why is None:
                tags.append(tag)
            else:
                refused.append(f"{tag} refused: {why}")
        lines.append(
            f"level {l}: {kind}" + (f" ({', '.join(tags)})" if tags else "")
            + (f"; {'; '.join(refused)}" if refused else "")
        )
    tail = args.fuse == "pod" or plan.tail_pv2 is not None
    lines.append(
        f"levels {nd}..{plan.nlev - 1}: replicated on every rank, the "
        "single-device per-op ops (ops/dispatch"
        + (", one batch a tail visit: ops/vcycle_batch.run_tail)"
           if tail else ")")
    )
    _explain(lines)


def _pod_refusal(params, mesh_shape, halo) -> Optional[str]:
    """Why ``--fuse auto`` takes the per-leg engine, or None for pod
    (the JAX CLI's choice, gpusolve_tpu/cli.py:378-409; ``--backend ref``
    stands for its ``--backend xla``)."""
    from gpusolve_tpu_torch.dist.pod import choose_npod

    if halo != "ppermute":
        return f"--halo {halo} is a per-leg engine feature"
    if params.backend == "ref":
        return "--backend ref requests the plain ops"
    if choose_npod(params, (mesh_shape[0], mesh_shape[1] * mesh_shape[2])) \
            is None:
        return "geometry/mode outside the pod gates"
    return None


def _resolve_engine(args, params, mesh_shape, _explain) -> Optional[str]:
    """Settles ``--dist-engine auto`` and ``--fuse auto`` on ``args`` (the
    JAX CLI's choice, gpusolve_tpu/cli.py:338-409): spmd wherever it can
    run the configuration, else the gspmd engine, with a note; the pod
    engine wherever its gates allow.  Returns why an explicit
    ``--dist-engine spmd`` cannot run, or None."""
    from gpusolve_tpu_torch.dist.spmd import spmd_eligible

    why = spmd_eligible(params, mesh_shape)
    if args.dist_engine == "auto":
        args.dist_engine = "gspmd" if why else "spmd"
        if why:
            print(f"note: using the gspmd engine ({why})", file=sys.stderr)
    if args.dist_engine == "spmd" and why is not None:
        return (f"the spmd engine cannot run this configuration ({why}); "
                "--dist-engine gspmd runs it")
    if args.dist_engine == "spmd" and args.fuse == "auto":
        why = _pod_refusal(params, mesh_shape, args.halo)
        args.fuse = "leg" if why else "pod"
        _explain([f"fuse=auto -> {args.fuse}" + (f" ({why})" if why else "")])
    return None


def _run_native(args, params, mesh_shape, _explain) -> int:
    """``--backend cpu-native``: the whole solve on the C++/OpenMP host
    solver in float64, with the JAX CLI's lines and each iteration's wall
    ms as the native loop measured it (gpusolve_tpu/cli.py:428-447).  A
    ``--mesh`` is settled as on the card, with its notes, and then not
    used: the host solver runs the whole grid, as in the JAX CLI."""
    import torch

    from gpusolve_tpu_torch import cpu_native
    from gpusolve_tpu_torch.config import Mode

    if mesh_shape is not None:
        _resolve_engine(args, params, mesh_shape, _explain)
    solution, history, cycle_ms = cpu_native.solve_native(
        params, with_times=True
    )
    _explain([
        f"cpu-native: the C++/OpenMP host solver in float64 "
        f"(ops/csrc/gpusolve_cpu.cpp, {cpu_native.num_threads()} threads)"
        + ("; the mesh is not used" if mesh_shape is not None else "")
    ])
    if params.print_progress:
        newton = params.mode == Mode.NEWTON
        first = "Inital newton residual" if newton else "Inital residual"
        print(f"{first}: {history[0]:.6g}")
        word = "newton iter" if newton else "iter"
        for i, res in enumerate(history[1:]):
            print(f"{word}: {i} residual: {res:.6g} "
                  f"Took {int(cycle_ms[i])}ms")
    _report(solution, params, args)
    return 0


def _run_gspmd(args, params, mesh_shape, device, profile_cm, _explain,
               started) -> int:
    """--mesh on the GSPMD engine (dist/gspmd.py): the single-device cycle
    per op on this process's blocks, a fetch of the boxes each op reads
    (the JAX CLI's gspmd path, gpusolve_tpu/cli.py:486-510, :626-716)."""
    import torch.distributed as dist

    from gpusolve_tpu_torch.config import Mode
    from gpusolve_tpu_torch.dist import level_shardings, make_mesh
    from gpusolve_tpu_torch.dist.sharding import gather_field
    from gpusolve_tpu_torch.grid import build_grid
    from gpusolve_tpu_torch.ops.dispatch import plain_reason
    from gpusolve_tpu_torch.solver.newton import newton_solve
    from gpusolve_tpu_torch.solver.vcycle import solve

    try:
        multi = dist.is_initialized()
        mesh = make_mesh(
            mesh_shape,
            device=None if multi and device.type == "cuda" else device,
        )
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 1
    # --refine's inner solves are float32.
    run = params.replace(dtype="float32") if args.refine else params
    shardings = level_shardings(run, mesh)
    if args.refine:
        print("note: --refine on the gspmd engine runs the per-op cycle "
              "with a box fetch an op (the debugging path); use "
              "--dist-engine spmd (the default wherever eligible) for the "
              "fused inner engine", file=sys.stderr)
    else:
        print("note: the gspmd engine is the debugging/fallback path: every "
              "op fetches the boxes it reads from their owners and runs the "
              "per-op ops on its block; use --dist-engine spmd (the default "
              "wherever eligible) for performance", file=sys.stderr)
    why = plain_reason(run, mesh.device, run.dtype)
    local = ("the per-op CUDA kernels on each block (ops/dispatch)"
             if why is None else f"plain ops ({why}; ops/ref.py)")
    blocked = sum(sh.blocked for sh in shardings)
    _explain([
        f"dist-engine=gspmd (box fetches over torch.distributed; local "
        f"compute: {local})",
        f"{blocked} blocked levels, {len(shardings) - blocked} replicated",
    ])
    if args.refine:
        from gpusolve_tpu_torch.solver.refine import solve_refine

        with profile_cm:
            u, _ = solve_refine(params, inner_tol=args.refine_inner_tol,
                                shardings=shardings)
        if args.profile:
            print(f"Wrote profiler trace to {args.profile}")
        u = gather_field(u, shardings[0])
        if u is not None:
            _report(u.cpu().numpy(), params, args)
        return _end(started)
    history0, initial_residual = [], None
    if args.load_state:
        from gpusolve_tpu_torch.utils.checkpoint import load_state

        if not os.path.isfile(args.load_state):
            print(f"{args.load_state} does not exist or is not a file",
                  file=sys.stderr)
            return 1
        try:
            state, it0, history0 = load_state(args.load_state, params,
                                              shardings=shardings)
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 1
        print(f"Resumed from {args.load_state} (iteration {it0})")
        # The stop threshold keeps the original run's initial residual.
        if history0:
            initial_residual = history0[0]
    else:
        state = build_grid(params, device=mesh.device)
    newton = params.mode == Mode.NEWTON
    with profile_cm:
        state, history = (newton_solve if newton else solve)(
            state, params, shardings=shardings,
            initial_residual=initial_residual, check_every=args.check_every,
        )
    if args.profile:
        print(f"Wrote profiler trace to {args.profile}")
    if args.save_state:
        from gpusolve_tpu_torch.utils.checkpoint import save_state

        combined = history0 + history
        save_state(args.save_state, state, params,
                   iteration=len(combined) - 1, history=combined)
        print(f"Saved state to {args.save_state}")
    if args.dump or args.validate:
        lvl0 = state.levels[0]
        solution = gather_field(lvl0.newton_v if newton else lvl0.v,
                                shardings[0])
        if solution is not None:
            _report(solution.cpu().numpy(), params, args)
    return _end(started)


def _run_mesh(args, params, mesh_shape, device, profile_cm, _explain) -> int:
    """--mesh: the spmd engine (per leg, or pod) on this process's
    shard, or the gspmd engine (``_run_gspmd``) where spmd cannot run the
    configuration or ``--dist-engine gspmd`` asks for it."""
    import torch.distributed as dist

    from gpusolve_tpu_torch.config import Mode
    from gpusolve_tpu_torch.dist import make_mesh
    from gpusolve_tpu_torch.dist.spmd import (
        build_spmd_solver,
        gather_solution,
        newton_solve_spmd,
        solve_spmd,
    )

    refused = _resolve_engine(args, params, mesh_shape, _explain)
    if refused:
        print(refused, file=sys.stderr)
        return 1
    started = False
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and not dist.is_initialized():
        dist.init_process_group("gloo" if device.type == "cpu" else "nccl")
        started = True
    try:
        if args.dist_engine == "gspmd":
            return _run_gspmd(args, params, mesh_shape, device, profile_cm,
                              _explain, started)
        try:
            multi = dist.is_initialized()
            mesh = make_mesh(
                mesh_shape,
                device=None if multi and device.type == "cuda" else device,
            )
            # --refine's inner solves are float32 LINEAR or NEWTON.
            inner = params.replace(mode=Mode.LINEAR) \
                if params.mode == Mode.LINEAR else params.replace(
                    mode=Mode.NEWTON)
            eng = build_spmd_solver(inner if args.refine else params, mesh,
                                    fuse=args.fuse, halo=args.halo)
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 1
        if args.refine:
            _explain(["refine: float64 outer defect on the plain ops; inner "
                      "float32 solves on the distributed engine:"])
        _spmd_notes(params, eng, args, _explain)
        if args.refine:
            from gpusolve_tpu_torch.solver.refine import solve_refine_spmd

            with profile_cm:
                u, _ = solve_refine_spmd(
                    params, mesh, inner_tol=args.refine_inner_tol,
                    halo=args.halo, fuse=args.fuse,
                )
            if args.profile:
                print(f"Wrote profiler trace to {args.profile}")
            _report(u.cpu().numpy(), params, args)
            eng.close()
            return _end(started)
        engine_tag = f"spmd/{args.fuse}"
        state, history0, initial_residual, newton_f0 = None, [], None, None
        if args.load_state:
            from gpusolve_tpu_torch.utils.checkpoint import load_state_spmd

            if not os.path.isfile(args.load_state):
                print(f"{args.load_state} does not exist or is not a file",
                      file=sys.stderr)
                return 1
            try:
                state, it0, history0, newton_f0 = load_state_spmd(
                    args.load_state, params, eng.plan, engine_tag, mesh=mesh
                )
            except ValueError as e:
                print(str(e), file=sys.stderr)
                return 1
            print(f"Resumed from {args.load_state} (iteration {it0})")
            # The stop threshold keeps the original run's initial residual.
            if history0:
                initial_residual = history0[0]
        with profile_cm:
            if params.mode == Mode.NEWTON:
                state, history, plan = newton_solve_spmd(
                    params, mesh, check_every=args.check_every,
                    halo=args.halo, fuse=args.fuse, plan=eng.plan,
                    state=state, newton_f=newton_f0,
                    initial_residual=initial_residual,
                )
                newton_f0 = plan.newton_f
                which = 2
            else:
                state, history, plan = solve_spmd(
                    params, mesh, plan=eng.plan, state=state,
                    initial_residual=initial_residual,
                    check_every=args.check_every, halo=args.halo,
                    fuse=args.fuse,
                )
                which = 0
        if args.profile:
            print(f"Wrote profiler trace to {args.profile}")
        if args.save_state:
            from gpusolve_tpu_torch.utils.checkpoint import save_state_spmd

            combined = history0 + history
            save_state_spmd(
                args.save_state, state, plan, params, engine_tag,
                iteration=len(combined) - 1, history=combined,
                newton_f=newton_f0, mesh=mesh,
            )
            print(f"Saved state to {args.save_state}")
        if args.dump or args.validate:
            solution = gather_solution(state, plan, mesh, which=which)
            if args.dump:
                from gpusolve_tpu_torch.utils.dump import dump_field

                dump_field(solution, args.dump)
                print(f"Dumped solution to {args.dump}")
            if args.validate:
                from gpusolve_tpu_torch.utils.dump import compare_analytic

                err = compare_analytic(solution, params.h)
                print(f"max-abs error vs analytic solution: {err:.6g}")
        eng.close()
        return _end(started)
    finally:
        if started:
            dist.destroy_process_group()


def _end(started: bool) -> int:
    """A mesh run's end: no rank tears its connections down while a peer
    still reads."""
    if started:
        import torch.distributed as dist

        dist.barrier()
    return 0


def _report(solution, params, args) -> None:
    """--dump and --validate on the final solution (a padded numpy
    array)."""
    from gpusolve_tpu_torch.config import Mode
    from gpusolve_tpu_torch.utils.dump import compare_analytic, dump_field

    if args.dump:
        dump_field(solution, args.dump)
        print(f"Dumped solution to {args.dump}")
    if args.validate:
        if params.mode == Mode.LINEAR:
            print("--validate only applies to nonlinear/newton modes")
        else:
            err = compare_analytic(solution, params.h)
            print(f"max-abs error vs analytic solution: {err:.6g}")


def _mesh_shape(args):
    """The --mesh shape, or a message: why the mesh run cannot start."""
    try:
        shape = tuple(int(t) for t in args.mesh.split(","))
    except ValueError:
        shape = ()
    if len(shape) != 3 or any(m < 1 for m in shape):
        return None, f"invalid --mesh {args.mesh!r}"
    return shape, None


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.mesh and int(os.environ.get("RANK", "0")) != 0:
        # Only rank 0 of a multi-process mesh prints.
        with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
            return _main(args)
    return _main(args)


def _main(args) -> int:
    if not os.path.isfile(args.config):
        print(
            f"{args.config} does not exist or is not a file", file=sys.stderr
        )
        return 1
    mesh_shape = None
    if args.mesh:
        mesh_shape, why = _mesh_shape(args)
        if why:
            print(why, file=sys.stderr)
            return 1
    native = args.backend == "cpu-native"
    if args.refine:
        incompat = [
            ("--dtype float64", args.dtype == "float64"),
            ("--backend cpu-native", native),
            ("--save-state/--load-state",
             bool(args.save_state or args.load_state)),
        ]
        bad = [name for name, hit in incompat if hit]
        if bad:
            print(
                f"--refine is incompatible with {', '.join(bad)} "
                "(f32 inner solves with an f64 outer defect)",
                file=sys.stderr,
            )
            return 1

    import torch

    from gpusolve_tpu_torch.config import Mode, parse_config
    from gpusolve_tpu_torch.grid import build_grid, resolve_device
    from gpusolve_tpu_torch.solver.newton import newton_solve
    from gpusolve_tpu_torch.solver.vcycle import solve

    device = None
    if not native:  # the host solver needs no card
        try:
            device = resolve_device(_device(args.platform))
        except (ValueError, RuntimeError) as e:
            print(str(e), file=sys.stderr)
            return 1

    print(f"Using config file {args.config}")
    try:
        params = parse_config(
            args.config,
            dtype="float64" if native else args.dtype,
            backend=args.backend,
            print_progress=not args.quiet,
            cycle_type=args.cycle,
        )
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 1
    if native and args.profile:
        print(
            "--profile needs a JAX device backend (jax.profiler); the "
            "cpu-native backend has no trace hooks",
            file=sys.stderr,
        )
        return 1
    if native and args.cycle != "V":
        print(
            "--cycle W/F is not available on the cpu-native backend",
            file=sys.stderr,
        )
        return 1
    print(_MODE_LINES[params.mode])
    if not params.properly_nested:
        print(
            "warning: grid dims are not 2^k-1-nested; coarse grids are "
            "geometrically misaligned and multigrid convergence is not "
            "guaranteed (this matches the reference's behavior)",
            file=sys.stderr,
        )

    def _explain(lines):
        if args.explain_backend:
            for ln in lines:
                print(f"backend: {ln}", file=sys.stderr)

    if native:
        return _run_native(args, params, mesh_shape, _explain)
    if args.devices:
        if device.type == "cuda":
            name = torch.cuda.get_device_name(device)
            print(f"Device [0]: {name} (cuda)")
        else:
            print("Device [0]: cpu")
        print("Using device [0]")

    profile_cm = contextlib.nullcontext()
    if args.profile:
        profile_cm = _profiled(args.profile, device)

    if mesh_shape is not None:
        return _run_mesh(args, params, mesh_shape, device, profile_cm,
                         _explain)

    if args.refine:
        from gpusolve_tpu_torch.solver.refine import solve_refine

        _explain([
            "refine: float64 outer defect on the plain ops; inner float32 "
            "solves:"
        ])
        _single_device_notes(
            params.replace(mode=Mode.LINEAR if params.mode == Mode.LINEAR
                           else Mode.NEWTON),
            device, _explain,
        )
        with profile_cm:
            u, _ = solve_refine(
                params, inner_tol=args.refine_inner_tol, device=device
            )
        if args.profile:
            print(f"Wrote profiler trace to {args.profile}")
        _report(u.cpu().numpy(), params, args)
        return 0

    _single_device_notes(params, device, _explain)
    state = build_grid(params, device=device)
    history0 = []
    initial_residual = None
    if args.load_state:
        from gpusolve_tpu_torch.utils.checkpoint import load_state

        if not os.path.isfile(args.load_state):
            print(
                f"{args.load_state} does not exist or is not a file",
                file=sys.stderr,
            )
            return 1
        try:
            state, it0, history0 = load_state(
                args.load_state, params, device=device
            )
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 1
        print(f"Resumed from {args.load_state} (iteration {it0})")
        # The stop threshold keeps the original run's initial residual.
        if history0:
            initial_residual = history0[0]
    with profile_cm:
        if params.mode == Mode.NEWTON:
            state, history = newton_solve(
                state, params, initial_residual=initial_residual,
                check_every=args.check_every,
            )
            solution = state.levels[0].newton_v
        else:
            state, history = solve(
                state, params, initial_residual=initial_residual,
                check_every=args.check_every,
            )
            solution = state.levels[0].v
    if args.profile:
        print(f"Wrote profiler trace to {args.profile}")
    if args.save_state:
        from gpusolve_tpu_torch.utils.checkpoint import save_state

        combined = history0 + history
        save_state(
            args.save_state, state, params, iteration=len(combined) - 1,
            history=combined,
        )
        print(f"Saved state to {args.save_state}")
    if args.dump or args.validate:
        _report(solution.cpu().numpy(), params, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
