"""Distributed multigrid on ``torch.distributed``: the counterpart of
``gpusolve_tpu/dist``.

Each process owns one block of every distributed level of a 3-D process
mesh (``mesh.make_mesh``); ``spmd`` is the explicit-halo engine in its
per-leg form, on the four shard-local CUDA kernels of
``ops/spmd_kernels.py``.  A ``(1, 1, 1)`` mesh runs in one process with no
collective; larger meshes start one process per shard under ``torchrun``
(gloo on the CPU; NCCL, one card per rank).
"""

from gpusolve_tpu_torch.dist.mesh import Mesh, factor_devices, make_mesh
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
    "SpmdPlan",
    "build_spmd_solver",
    "factor_devices",
    "gather_solution",
    "make_mesh",
    "newton_solve_spmd",
    "solve_spmd",
    "spmd_eligible",
]
