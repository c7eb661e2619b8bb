"""Experiment sweep: backend × mode × size, one table and a JSON file.

The counterpart of the JAX package's ``scripts/experiments.py`` (itself
the reference's runExperiments.py): it drives the port's library API
(``build_grid`` + ``solve`` / ``newton_solve``) on the card, or with
``--platform cpu`` on the host, and the C++ host solver for
``cpu-native``; for each configuration it records the first and a warm
run's wall ms, ms per iteration and the residual history.  A user's
sweep tool, not a benchmark: wall times on the host's clock.

    python -m gpusolve_tpu_torch.scripts.experiments [--sizes 63,127,255]
        [--modes 0,1,2] [--backends auto,ref,cpu-native] [--maxiter 10]
        [--platform cpu] [--json out.json]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

MODE_NAMES = {0: "LINEAR", 1: "NONLINEAR", 2: "NEWTON"}


def run_one(backend: str, mode: int, size: int, maxiter: int, device):
    """One configuration: (history, first run ms, warm run ms)."""
    from gpusolve_tpu_torch.config import GridParams, Mode, Stencil

    params = GridParams(
        maxiter=maxiter,
        tol=1e-5,
        grid_dim=(size, size, size),
        mode=Mode(mode),
        pre_smoothing=3,
        post_smoothing=3,
        omega=0.8,
        gamma=1.0,
        stencil=Stencil.poisson_7pt(),
        print_progress=False,
        dtype="float32",
        backend=backend,
    )
    if backend == "cpu-native":
        from gpusolve_tpu_torch import cpu_native

        t0 = time.perf_counter()
        _, history = cpu_native.solve_native(params.replace(dtype="float64"))
        total_ms = (time.perf_counter() - t0) * 1e3
        return history, total_ms, total_ms  # nothing is compiled a run

    import torch

    from gpusolve_tpu_torch.grid import build_grid
    from gpusolve_tpu_torch.solver.newton import newton_solve
    from gpusolve_tpu_torch.solver.vcycle import solve

    run = newton_solve if params.mode == Mode.NEWTON else solve
    times = []
    for _ in range(2):  # the first run builds the kernels; the second is warm
        state = build_grid(params, device=device)
        if state.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, history = run(state, params)
        if state.device.type == "cuda":
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return history, times[0], times[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="63,127,255")
    ap.add_argument("--modes", default="0,1,2")
    ap.add_argument("--backends", default="auto",
                    help="comma-separated: auto, ref, cpu-native")
    ap.add_argument("--maxiter", type=int, default=10)
    ap.add_argument("--platform", choices=("cuda", "cpu"), default=None,
                    help="cpu: the device backends run on the host")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    sizes = [int(s) for s in args.sizes.split(",")]
    modes = [int(m) for m in args.modes.split(",")]
    backends = args.backends.split(",")
    bad = [b for b in backends if b not in ("auto", "ref", "cpu-native")]
    if bad:
        ap.error(f"unknown backends {bad}")

    results = []
    hdr = (
        f"{'backend':<12} {'mode':<10} {'size':>5} {'warm ms':>9} "
        f"{'ms/iter':>9} {'iters':>5}  residuals (first→last)"
    )
    print(hdr)
    print("-" * len(hdr))
    for backend in backends:
        for mode in modes:
            for size in sizes:
                history, total_ms, warm_ms = run_one(
                    backend, mode, size, args.maxiter, args.platform
                )
                iters = len(history) - 1
                per_iter = warm_ms / max(1, iters)
                print(
                    f"{backend:<12} {MODE_NAMES[mode]:<10} {size:>5} "
                    f"{warm_ms:>9.1f} {per_iter:>9.1f} {iters:>5}  "
                    f"{history[0]:.3g} → {history[-1]:.3g}",
                    flush=True,
                )
                results.append({
                    "backend": backend,
                    "mode": MODE_NAMES[mode],
                    "size": size,
                    "first_total_ms": round(total_ms, 1),
                    "warm_total_ms": round(warm_ms, 1),
                    "ms_per_iter": round(per_iter, 2),
                    "iters": iters,
                    "residuals": [float(f"{h:.6g}") for h in history],
                })
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
        print(f"\nwrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
