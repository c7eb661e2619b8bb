"""Multi-process initialisation and host-aware meshes, on
``torch.distributed``: the counterpart of ``gpusolve_tpu/dist/multihost.py``
(``initialize`` :39, ``is_multiprocess`` :79, ``make_topology_mesh`` :83).

Usage (one call near the top of every process started by ``torchrun``)::

    from gpusolve_tpu_torch.dist import multihost
    multihost.initialize()                 # RANK, WORLD_SIZE, MASTER_*
    mesh = multihost.make_topology_mesh()  # each host a contiguous block

On a single process both degrade: ``initialize`` is a no-op returning
False and the mesh is ``mesh.make_mesh``'s.  CUDA ranks join over NCCL,
each on ``cuda:{LOCAL_RANK}``; CPU ranks (``device="cpu"``) over gloo,
which is how the tests run several processes on one host.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from gpusolve_tpu_torch.dist.mesh import Mesh, factor_devices, make_mesh


def initialize(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    local_rank: Optional[int] = None,
    device=None,
) -> bool:
    """Join the process group (the JAX package's
    ``jax.distributed.initialize``; its coordinator address, process count,
    process id and local device ids stand as ``init_method``,
    ``world_size``, ``rank`` and ``local_rank``).

    The arguments default to torchrun's environment: ``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``, and ``MASTER_ADDR`` / ``MASTER_PORT``
    through ``init_method="env://"``.  ``device``: ``"cpu"`` joins over
    gloo; default CUDA, over NCCL, with this process on
    ``cuda:{local_rank}``.  Returns True when a multi-process group was
    (or already had been) joined, False for the single-process no-op."""
    if dist.is_available() and dist.is_initialized():
        return True
    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if world_size is None or world_size <= 1:
        return False
    if rank is None:
        rank = int(env["RANK"])
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", 0))
    if device is not None and torch.device(device).type == "cpu":
        backend = "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to join "
                "over gloo on the host"
            )
        torch.cuda.set_device(local_rank)
        backend = "nccl"
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        world_size=world_size, rank=rank,
    )
    return True


def is_multiprocess() -> bool:
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def _gcd(a: int, b: int) -> int:
    while b:
        a, b = b, a % b
    return a


def topology_order(shape, world: int,
                   per_host: int) -> Optional[Tuple[int, ...]]:
    """The rank at each mesh position (row-major) when every host's
    ``per_host`` ranks (consecutive, host by host) form a contiguous
    sub-block, hosts stacked along x first, then y, then z (the JAX
    package's gcd rule, ``gpusolve_tpu/dist/multihost.py:113-124``); None
    when the hosts do not tile ``shape``."""
    nhost = world // per_host
    if per_host < 1 or nhost * per_host != world or \
            math.prod(shape) != world:
        return None
    dcn, rem = [1, 1, 1], nhost
    for ax in range(3):
        g = _gcd(shape[ax], rem)
        dcn[ax] = g
        rem //= g
        if rem == 1:
            break
    if rem != 1:
        return None
    ici = [s // d for s, d in zip(shape, dcn)]
    order = []
    for x in range(shape[0]):
        for y in range(shape[1]):
            for z in range(shape[2]):
                hx, hy, hz = x // ici[0], y // ici[1], z // ici[2]
                lx, ly, lz = x % ici[0], y % ici[1], z % ici[2]
                host = (hx * dcn[1] + hy) * dcn[2] + hz
                local = (lx * ici[1] + ly) * ici[2] + lz
                order.append(host * per_host + local)
    return tuple(order)


def make_topology_mesh(
    shape: Optional[Tuple[int, int, int]] = None, device=None
) -> Mesh:
    """A 3-D mesh over every process in which each host's ranks
    (``LOCAL_WORLD_SIZE`` of them, from torchrun) form a contiguous
    sub-block, hosts stacked along x first: the mesh's exchanges cross
    hosts on the fewest faces (the mesh's ``order``).  Falls back to
    ``make_mesh``'s row-major order where the hosts do not tile ``shape``
    (default: ``factor_devices`` of the world size)."""
    world = dist.get_world_size() if is_multiprocess() else 1
    if shape is None:
        shape = factor_devices(world)
    shape = tuple(int(s) for s in shape)
    if world == 1:
        return make_mesh(shape, device=device)
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    order = topology_order(shape, world, per_host)
    if order == tuple(range(world)):
        order = None
    return make_mesh(shape, device=device, order=order)
