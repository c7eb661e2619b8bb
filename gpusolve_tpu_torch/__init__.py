"""gpusolve_tpu_torch — the PyTorch / CUDA port of gpusolve_tpu for one
NVIDIA H100.

A 3-D geometric-multigrid solver for the Poisson equation on a structured
grid with a config-driven 7-point stencil.  The JAX package ``gpusolve_tpu``
beside it is the reference this package is held against; this package
imports neither it nor jax.

It runs the single-device solve in all three modes (LINEAR multigrid,
NONLINEAR FAS multigrid, and the NEWTON outer loop with its inner
multigrid solve; V, W and F cycles) on hand-written CUDA kernels
(``ops/csrc/``: per-op kernels batched with an early stop on the device,
and a whole V-cycle in one cooperative launch for more than 5 sweeps),
with a plain PyTorch version of every op (``ops/ref.py``) that runs on the
CPU, runs float64 on the card, and serves as the kernels' oracle; and
mixed-precision refinement (``solver/refine.py``) and checkpoints
(``utils/checkpoint.py``).  The distributed engine (``dist/``: the
per-leg explicit-halo engine on ``torch.distributed``, four shard-local
CUDA kernels) runs the same three modes on a process mesh; on one card
as the ``(1, 1, 1)`` mesh, ``solve_spmd(params, make_mesh((1, 1, 1)))``,
or on the pod engine (every down leg in one launch, every up leg in
another) with ``fuse="pod"``.  The GSPMD engine, the fallback where the
spmd engine refuses a mesh, runs ``solve`` / ``newton_solve`` /
``solve_refine`` with ``shardings=level_shardings(params, mesh)``.
Entry points run on CUDA unless the caller asks for the CPU
(``device="cpu"``, or ``--platform cpu`` on the CLI).

    import gpusolve_tpu_torch as gt
    params = gt.parse_config("examples/linear_127.conf")   # or nonlinear_
    state = gt.build_grid(params)            # on CUDA
    state, history = gt.solve(state, params, check_every=10)

    params = gt.parse_config("examples/newton_127.conf")
    state, history = gt.newton_solve(gt.build_grid(params), params)
    solution = state.levels[0].newton_v
"""

from gpusolve_tpu_torch.config import (
    GridParams,
    Mode,
    Stencil,
    parse_config,
    parse_config_text,
)
from gpusolve_tpu_torch.dist import (
    PodPlan,
    SpmdPlan,
    build_pod_solver,
    choose_npod,
    level_shardings,
    make_mesh,
    multihost,
    newton_solve_spmd,
    shard_state,
    solve_spmd,
)
from gpusolve_tpu_torch.grid import GridLevel, GridState, build_grid
from gpusolve_tpu_torch.solver.newton import newton_solve
from gpusolve_tpu_torch.solver.refine import solve_refine
from gpusolve_tpu_torch.solver.vcycle import solve, vcycle

__all__ = [
    "GridLevel",
    "GridParams",
    "GridState",
    "Mode",
    "PodPlan",
    "SpmdPlan",
    "Stencil",
    "build_grid",
    "build_pod_solver",
    "choose_npod",
    "level_shardings",
    "make_mesh",
    "multihost",
    "newton_solve",
    "newton_solve_spmd",
    "parse_config",
    "parse_config_text",
    "shard_state",
    "solve",
    "solve_refine",
    "solve_spmd",
    "vcycle",
]
