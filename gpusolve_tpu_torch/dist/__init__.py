"""Distributed multigrid on ``torch.distributed``: the counterpart of
``gpusolve_tpu/dist``.

Each process owns one block of every distributed level of a 3-D process
mesh (``mesh.make_mesh``); ``spmd`` is the explicit-halo engine in its
per-leg form, on the four shard-local CUDA kernels of
``ops/spmd_kernels.py`` and the trapezoid leg; ``pod`` chains every down
leg of a cycle into one launch and every up leg into another, around a
replicated tail (``fuse="pod"``).  A ``(1, 1, 1)`` mesh runs in one
process with no collective; larger meshes start one process per shard
under ``torchrun`` (gloo on the CPU; NCCL, one card per rank).
"""

from gpusolve_tpu_torch.dist.mesh import Mesh, factor_devices, make_mesh
from gpusolve_tpu_torch.dist.pod import PodPlan, build_pod_solver, choose_npod
from gpusolve_tpu_torch.dist.spmd import (
    SpmdPlan,
    build_spmd_solver,
    gather_solution,
    newton_solve_spmd,
    solve_spmd,
    spmd_eligible,
)

__all__ = [
    "Mesh",
    "PodPlan",
    "SpmdPlan",
    "build_pod_solver",
    "build_spmd_solver",
    "choose_npod",
    "factor_devices",
    "gather_solution",
    "make_mesh",
    "newton_solve_spmd",
    "solve_spmd",
    "spmd_eligible",
]
