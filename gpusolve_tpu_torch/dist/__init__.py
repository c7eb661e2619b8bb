"""Distributed multigrid on ``torch.distributed``: the counterpart of
``gpusolve_tpu/dist``.

Each process owns one block of every distributed level of a 3-D process
mesh (``mesh.make_mesh``); ``spmd`` is the explicit-halo engine in its
per-leg form, on the four shard-local CUDA kernels of
``ops/spmd_kernels.py`` and the trapezoid leg; ``pod`` chains every down
leg of a cycle into one launch and every up leg into another, around a
replicated tail (``fuse="pod"``).  ``sharding`` and ``gspmd`` are the
GSPMD engine, the demoted fallback: a per-level placement
(``level_shardings``, ``shard_state``) under which ``solve``,
``newton_solve`` and ``solve_refine`` run the single-device cycle per op,
each op fetching the boxes it reads from their owners.  ``multihost``
joins the process group from torchrun's environment and lays each host's
ranks out as a block of the mesh.  A ``(1, 1, 1)`` mesh runs in one
process with no collective; larger meshes start one process per shard
under ``torchrun`` (gloo on the CPU; NCCL, one card per rank).
"""

from gpusolve_tpu_torch.dist import multihost
from gpusolve_tpu_torch.dist.mesh import Mesh, factor_devices, make_mesh
from gpusolve_tpu_torch.dist.pod import PodPlan, build_pod_solver, choose_npod
from gpusolve_tpu_torch.dist.sharding import (
    LevelSharding,
    gather_field,
    gather_state,
    level_shardings,
    shard_state,
)
from gpusolve_tpu_torch.dist.spmd import (
    SpmdPlan,
    build_spmd_solver,
    gather_solution,
    newton_solve_spmd,
    solve_spmd,
    spmd_eligible,
)

__all__ = [
    "LevelSharding",
    "Mesh",
    "PodPlan",
    "SpmdPlan",
    "build_pod_solver",
    "build_spmd_solver",
    "choose_npod",
    "factor_devices",
    "gather_field",
    "gather_solution",
    "gather_state",
    "level_shardings",
    "make_mesh",
    "multihost",
    "newton_solve_spmd",
    "shard_state",
    "solve_spmd",
    "spmd_eligible",
]
