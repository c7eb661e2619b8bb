"""Command-line entry point: ``python -m gpusolve_tpu_torch.cli <config>``.

The single-device counterpart of ``gpusolve_tpu/cli.py``, with the same
progress lines (``Using config file …``, ``Solving linear problem`` /
``Solving nonlinear problem`` / ``Solving newton problem``,
``Inital residual: …`` or ``Inital newton residual: …``, then
``iter: N residual: R Took Xms`` or ``newton iter: N …``) that the
reference's experiment harness parses.  Modes 0 and 1 run ``solve``;
mode 2 runs ``newton_solve``, whose solution is level 0's ``newton_v``.

Flags:
  --dtype {float32,float64}  float32 on the card; float64 runs the plain
                             ops on the CPU only (``--platform cpu``)
  --backend {auto,ref,cuda}  CUDA kernels, plain PyTorch ops, or kernels
                             only (see config.py)
  --check-every K            cycles per batch (one host sync per batch)
  --cycle {V,W,F}            cycling schedule
  --quiet                    no progress lines
  --platform P               ``cpu`` runs on the host; default CUDA
  --devices                  print the CUDA device before solving
  --dump PATH                write the final solution in the reference's
                             Vector3::dump text format
  --validate                 print the max-abs error against the analytic
                             solution (modes 1 and 2)

The flags of later slices (``--mesh``, ``--refine``, ``--save-state``,
``--load-state``, ``--profile``) exit 1 with a message saying they are not
ported yet.
"""

from __future__ import annotations

import argparse
import os
import sys

_NOT_PORTED = {
    "mesh": "ROADMAP Queue 1 item 13",
    "refine": "ROADMAP Queue 1 item 9",
    "save_state": "ROADMAP Queue 1 item 8",
    "load_state": "ROADMAP Queue 1 item 8",
    "profile": "ROADMAP Queue 1 item 5",
}


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
        "--backend", choices=["auto", "ref", "cuda"], default="auto",
        help="auto: CUDA kernels on the card, plain ops on the CPU; ref: "
        "plain PyTorch ops on any device; cuda: kernels only",
    )
    ap.add_argument(
        "--check-every", type=int, default=1, metavar="K",
        help="batch K cycles per host sync (the early stop runs on the "
        "device, so the history and final state do not depend on K)",
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
    for flag in ("--mesh", "--save-state", "--load-state", "--profile"):
        ap.add_argument(flag, default=None, help="not ported yet")
    ap.add_argument("--refine", action="store_true", help="not ported yet")
    return ap


def _device(platform):
    if platform in (None, "cuda", "gpu"):
        return None  # build_grid's default: CUDA, raising without one
    if platform == "cpu":
        return "cpu"
    raise ValueError(f"unknown --platform {platform!r} (use cpu or cuda)")


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    if not os.path.isfile(args.config):
        print(
            f"{args.config} does not exist or is not a file", file=sys.stderr
        )
        return 1
    for name, item in _NOT_PORTED.items():
        if getattr(args, name):
            flag = "--" + name.replace("_", "-")
            print(
                f"{flag} is not ported to gpusolve_tpu_torch yet ({item})",
                file=sys.stderr,
            )
            return 1
    try:
        device = _device(args.platform)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 1
    if args.dtype == "float64" and device != "cpu":
        print(
            "--dtype float64 runs the plain ops on the CPU only (add "
            "--platform cpu); the CUDA kernels are float32",
            file=sys.stderr,
        )
        return 1

    import torch

    from gpusolve_tpu_torch.config import Mode, parse_config
    from gpusolve_tpu_torch.grid import build_grid
    from gpusolve_tpu_torch.solver.newton import newton_solve
    from gpusolve_tpu_torch.solver.vcycle import solve
    from gpusolve_tpu_torch.utils.dump import compare_analytic, dump_field

    print(f"Using config file {args.config}")
    try:
        params = parse_config(
            args.config,
            dtype=args.dtype,
            backend=args.backend,
            print_progress=not args.quiet,
            cycle_type=args.cycle,
        )
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 1
    print(_MODE_LINES[params.mode])
    if not params.properly_nested:
        print(
            "warning: grid dims are not 2^k-1-nested; coarse grids are "
            "geometrically misaligned and multigrid convergence is not "
            "guaranteed (this matches the reference's behavior)",
            file=sys.stderr,
        )
    try:
        state = build_grid(params, device=device)
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        return 1
    if args.devices:
        if state.device.type == "cuda":
            name = torch.cuda.get_device_name(state.device)
            print(f"Device [0]: {name} (cuda)")
        else:
            print("Device [0]: cpu")
        print("Using device [0]")
    if params.mode == Mode.NEWTON:
        state, _ = newton_solve(state, params, check_every=args.check_every)
        solution = state.levels[0].newton_v
    else:
        state, _ = solve(state, params, check_every=args.check_every)
        solution = state.levels[0].v
    if args.dump or args.validate:
        solution = solution.cpu().numpy()
    if args.dump:
        dump_field(solution, args.dump)
        print(f"Dumped solution to {args.dump}")
    if args.validate:
        if params.mode == Mode.LINEAR:
            print("--validate only applies to nonlinear/newton modes")
        else:
            err = compare_analytic(solution, params.h)
            print(f"max-abs error vs analytic solution: {err:.6g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
