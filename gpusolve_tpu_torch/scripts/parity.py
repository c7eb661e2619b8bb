"""Parity of every engine on the card against the float64 host solver.

The counterpart of the JAX package's ``scripts/tpu_parity.py``: each
engine's residual history on the card, for each size and mode, checked
against the golden history of ``cpu_native`` (the C++/OpenMP solver in
float64, an implementation independent of the port's ops).  The engines:

  * ``ref``: the plain float32 ops on the card (``backend="ref"``), the
    JAX script's "xla" row, which gives the drift term;
  * ``batch``: the batch engine on the fused legs (the main path);
  * ``batch-perop``: the batch engine with every level visit per op;
  * ``v1``: the whole-cycle kernel, one launch a cycle;
  * ``spmd-leg`` (``tail="auto"``: the replicated tail where the kernels
    run), ``spmd-classic`` (``tail="off"``), ``spmd-rdma``
    (``halo="rdma"``), ``pod`` and ``gspmd``, on the (1,1,1) mesh;
  * ``pod-y``, the pod engine on a (1,2,1) mesh: it needs 2 ranks, so a
    one-card run records it as skipped.

The margin model is the JAX script's: with ``drift_i = |h_ref,i − g_i|``
and ``spread_i`` the ran engines' max − min of entry i,
``atol_i = SAFETY·max(spread_i, drift_i, 1.2e-7·|g_0|)`` and ``margin =
max_i |h_i − g_i| / (RTOL·|g_i| + atol_i)``; a row is ok iff margin < 1
and its history is finite and as long as the golden one.  Each run is
V(3,3) with tol 1e-30, so it runs its maxiter: 8 cycles, or 3 Newton
steps.

The spread includes the engine judged, and ``max(spread, drift) >= |h −
g| / 2`` whenever the ``ref`` row ran, so that margin stays at or below
0.5 for any finite history of the right length.  Each row therefore also
records ``margin_drift_only``, the same quotient with ``atol_i =
SAFETY·max(drift_i, 1.2e-7·|g_0|)``: an engine that strays from the ref
row's drift by more than SAFETY times shows there.  It decides nothing.

    python -m gpusolve_tpu_torch.scripts.parity [--sizes 63,127]
        [--big 255] [--engines ...] [--device cuda|cpu] [--out PATH]

writes ``{"device", "power_limit", "platform", "rtol", "safety",
"all_ok", "results"}`` to ``--out`` (default
``chiprun_out/h100_parity.json``, a git-ignored directory: the record is
not committed) and exits 1 unless every row is ok.
``--device cpu`` runs the same on the plain ops of the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# Relative term: float32 storage tracking a float64 golden over <= 8
# cycles drifts ~1e-6..1e-5 on the early entries; 3e-4 catches a wrong
# stencil term or halo, which moves a history by orders of magnitude.
RTOL = 3e-4
# Absolute term: SAFETY x the measured noise floor (module note).
SAFETY = 4.0

# engine -> mesh (None: the single-device solvers).
ENGINES = {
    "ref": None,
    "batch": None,
    "batch-perop": None,
    "v1": None,
    "spmd-leg": (1, 1, 1),
    "spmd-classic": (1, 1, 1),
    "spmd-rdma": (1, 1, 1),
    "pod": (1, 1, 1),
    "gspmd": (1, 1, 1),
    "pod-y": (1, 2, 1),
}
BIG_ENGINES = ("ref", "batch", "pod")
_SPMD_KW = {
    "spmd-leg": dict(tail="auto"),
    "spmd-classic": dict(tail="off"),
    "spmd-rdma": dict(halo="rdma"),
    "pod": dict(fuse="pod"),
    "pod-y": dict(fuse="pod"),
}


def make_params(size: int, mode_num: int, engine: str):
    from gpusolve_tpu_torch.config import GridParams, Mode, Stencil

    mode = Mode(mode_num)
    return GridParams(
        maxiter=3 if mode == Mode.NEWTON else 8,
        tol=1e-30,
        grid_dim=(size, size, size),
        mode=mode,
        pre_smoothing=3,
        post_smoothing=3,
        omega=0.8,
        gamma=1.0,
        stencil=Stencil.poisson_7pt(),
        print_progress=False,
        dtype="float32",
        backend="ref" if engine == "ref" else "auto",
    )


def golden(size: int, mode_num: int):
    """The float64 host solver's history of the configuration."""
    from gpusolve_tpu_torch import cpu_native

    p = make_params(size, mode_num, "ref").replace(dtype="float64")
    return cpu_native.solve_native(p)[1]


@contextlib.contextmanager
def schedule(engine: str):
    """The single-device schedule an engine names: ``batch-perop`` refuses
    both fused legs (every level visit per op); ``v1`` takes the
    whole-cycle kernel, one launch a cycle, where ``solve`` would take the
    batch engine (the call ``chip_smoke.check_vcycle_fused`` makes)."""
    from gpusolve_tpu_torch.ops import vcycle_batch
    from gpusolve_tpu_torch.solver import vcycle as vc

    legs, choose = vcycle_batch.legs, vc.engine
    if engine == "batch-perop":
        vcycle_batch.legs = lambda params: (False, False)
    elif engine == "v1":
        vc.engine = lambda params, device: "v1"
    try:
        yield
    finally:
        vcycle_batch.legs, vc.engine = legs, choose


def _sync(device: str) -> None:
    if device != "cpu":
        import torch

        torch.cuda.synchronize()


def run_engine(size: int, mode_num: int, engine: str, device: str):
    """One engine's solve; returns (history, wall seconds)."""
    from gpusolve_tpu_torch.config import Mode
    from gpusolve_tpu_torch.dist import level_shardings, make_mesh
    from gpusolve_tpu_torch.dist.spmd import (
        build_spmd_solver,
        newton_solve_spmd,
        solve_spmd,
    )
    from gpusolve_tpu_torch.grid import build_grid
    from gpusolve_tpu_torch.solver.newton import newton_solve
    from gpusolve_tpu_torch.solver.vcycle import solve

    params = make_params(size, mode_num, engine)
    newton = params.mode == Mode.NEWTON
    _sync(device)
    t0 = time.perf_counter()
    if ENGINES[engine] is None:
        with schedule(engine):
            state = build_grid(params, device=device)
            _, history = (newton_solve if newton else solve)(state, params)
    elif engine == "gspmd":
        mesh = make_mesh(ENGINES[engine], device=device)
        state = build_grid(params, device=device)
        _, history = (newton_solve if newton else solve)(
            state, params, shardings=level_shardings(params, mesh))
    else:
        mesh = make_mesh(ENGINES[engine], device=device)
        kw = _SPMD_KW[engine]
        eng = build_spmd_solver(params, mesh, **kw)
        try:
            _, history, _ = (newton_solve_spmd if newton else solve_spmd)(
                params, mesh, plan=eng.plan, **kw)
        finally:
            eng.close()
    _sync(device)
    return [float(h) for h in history], time.perf_counter() - t0


def _ranks() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def judge_group(size, mode_num, engines, gold, device):
    """Every engine of one (size, mode), then the measured atol envelope
    and each ran engine's margin against ``gold`` (module note)."""
    from gpusolve_tpu_torch.config import Mode

    rows = []
    for engine in engines:
        mesh = ENGINES[engine]
        need = 1 if mesh is None else math.prod(mesh)
        row = {"size": size, "mode": Mode(mode_num).name, "engine": engine}
        if need > _ranks():
            row.update(skipped=f"needs {need} ranks ({_ranks()} available)",
                       ok=True)
            print(f"{size}^3 mode={mode_num} {engine}: SKIPPED (needs "
                  f"{need} ranks)", flush=True)
        else:
            history, wall = run_engine(size, mode_num, engine, device)
            row.update(history=history, wall_ms_total=wall * 1e3)
        rows.append(row)

    ran = [r for r in rows if "history" in r]
    # A history with a NaN or an infinity fails its row and stays out of
    # the envelope (Python's max passes over a NaN that comes last).
    finite = [r for r in ran if all(map(math.isfinite, r["history"]))]
    n = min([len(gold)] + [len(r["history"]) for r in ran])
    ref = next((r["history"] for r in finite if r["engine"] == "ref"), None)
    atol, atol_drift = [], []
    for i in range(n):
        vals = [r["history"][i] for r in finite] or [gold[i]]
        spread = max(vals) - min(vals)
        drift = abs(ref[i] - gold[i]) if ref is not None else 0.0
        # One float32 ulp of the initial residual: below it the check
        # would ask for agreement float32 cannot express.
        floor = abs(gold[0]) * 1.2e-7
        atol.append(SAFETY * max(spread, drift, floor))
        atol_drift.append(SAFETY * max(drift, floor))

    def quotient(h, tol):
        return max(abs(h[i] - gold[i]) / (RTOL * abs(gold[i]) + tol[i])
                   for i in range(n))

    for r in ran:
        h = r["history"]
        margin = quotient(h, atol)
        r.update(oracle=[float(g) for g in gold[:n]], rtol=RTOL, atol=atol,
                 margin=margin, margin_drift_only=quotient(h, atol_drift),
                 ok=bool(r in finite and margin < 1.0
                         and len(h) == len(gold)))
        print(f"{size}^3 mode={mode_num} {r['engine']}: "
              f"{'ok' if r['ok'] else 'FAIL'} margin={margin:.4f} "
              f"(drift only {r['margin_drift_only']:.4f}; "
              f"{r['wall_ms_total']:.0f} ms)", flush=True)
    return rows


def card() -> tuple:
    """(name, power limit) as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name, limit = (t.strip() for t in out.split(","))
    return name, limit


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="63,127")
    ap.add_argument("--engines", default=",".join(ENGINES))
    ap.add_argument(
        "--big", type=int, default=255,
        help="an extra LINEAR row at this size on the ref, batch and pod "
        "engines (0: none)",
    )
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument(
        "--out", default=os.path.join(REPO, "chiprun_out",
                                      "h100_parity.json"),
    )
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("parity: no CUDA device (--device cpu runs the plain ops "
                  "on the host)", file=sys.stderr)
            return 1
        name, limit = card()
    else:
        name, limit = "cpu", None

    engines = args.engines.split(",")
    unknown = [e for e in engines if e not in ENGINES]
    if unknown:
        ap.error(f"unknown engines {unknown}; known: {', '.join(ENGINES)}")
    results = []
    for size in (int(s) for s in args.sizes.split(",")):
        for mode_num in (0, 1, 2):
            results += judge_group(size, mode_num, engines,
                                   golden(size, mode_num), args.device)
    if args.big:
        results += judge_group(args.big, 0, BIG_ENGINES, golden(args.big, 0),
                               args.device)
    out = {
        "device": name,
        "power_limit": limit,
        "platform": "gpu" if args.device == "cuda" else "cpu",
        "rtol": RTOL,
        "safety": SAFETY,
        "all_ok": all(r["ok"] for r in results),
        "results": results,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    print(f"wrote {args.out}; all_ok={out['all_ok']}")
    return 0 if out["all_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
