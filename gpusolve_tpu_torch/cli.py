"""Command-line entry point: ``python -m gpusolve_tpu_torch.cli <config>``.

The single-device counterpart of ``gpusolve_tpu/cli.py``, with the same
progress lines (``Using config file …``, ``Solving linear problem``,
``Inital residual: …``, ``iter: N residual: R Took Xms``) that the
reference's experiment harness parses.

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

Modes 1 and 2 and the flags of later slices (``--mesh``, ``--refine``,
``--save-state``, ``--load-state``, ``--dump``, ``--profile``) exit 1 with
a message saying they are not ported yet.
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
    "dump": "ROADMAP Queue 1 item 5",
    "profile": "ROADMAP Queue 1 item 5",
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
    for flag in ("--mesh", "--save-state", "--load-state", "--dump",
                 "--profile"):
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
    from gpusolve_tpu_torch.solver.vcycle import solve

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
    if params.mode != Mode.LINEAR:
        print(
            f"mode {int(params.mode)} ({params.mode.name}) is not ported to "
            "gpusolve_tpu_torch yet (ROADMAP Queue 2 items 2(c)/2(d), "
            "Queue 1 item 7)",
            file=sys.stderr,
        )
        return 1

    print("Solving linear problem")
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
    solve(state, params, check_every=args.check_every)
    return 0


if __name__ == "__main__":
    sys.exit(main())
