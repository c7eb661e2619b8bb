"""The 3-D process mesh of the distributed engine, on ``torch.distributed``.

The counterpart of ``gpusolve_tpu/dist/mesh.py``.  Where the JAX package
lays a ``jax.sharding.Mesh`` over its devices, here each process is one
shard: ``make_mesh`` gives this process's coordinates in the mesh, the
process group its exchanges run on, and the device its tensors live on.

Ranks map to coordinates row-major, as ``np.asarray(devices).reshape(shape)``
maps devices in the JAX package: rank ``r`` sits at
``(r // (my·mz), (r // mz) % my, r % mz)``, unless the mesh carries an
``order`` (``multihost.make_topology_mesh``: each host's ranks a
contiguous block), the rank at each row-major position.

A ``(1, 1, 1)`` mesh needs no process group and makes no collective call.
Any other shape needs an initialised ``torch.distributed`` group whose
size is the product of the shape (start the processes with ``torchrun``).
CPU tensors exchange over gloo, CUDA tensors over NCCL, each rank on
``cuda:{LOCAL_RANK}``.  NCCL takes one rank per card, so ``make_mesh``
puts one rank on each card.  Processes that share one card can still
form a mesh: a gloo group built by hand and a ``Mesh`` over it with
their CUDA device, whose engines send host copies through the group
(``dist/spmd._Exchange.staged``) while tensors and kernels stay on the
card.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from gpusolve_tpu_torch.grid import resolve_device


def factor_devices(n: int) -> Tuple[int, int, int]:
    """Factor ``n`` devices into a balanced 3-D mesh shape.

    Greedy: distribute prime factors (largest first) onto the axis with the
    smallest current extent, so 8 → (2,2,2), 4 → (2,2,1), 6 → (3,2,1).
    """
    factors = []
    m = n
    p = 2
    while m > 1:
        while m % p == 0:
            factors.append(p)
            m //= p
        p += 1 if p == 2 else 2
        if p * p > m and m > 1:
            factors.append(m)
            break
    shape = [1, 1, 1]
    for fct in sorted(factors, reverse=True):
        shape[shape.index(min(shape))] *= fct
    return tuple(sorted(shape, reverse=True))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One process's place in the mesh: the mesh ``shape``, this rank's
    ``coords`` and ``rank``, the process ``group`` (None on a one-rank
    mesh), the ``device`` its tensors live on, and the ``order`` of the
    ranks over the mesh's row-major positions (None: rank = position)."""

    shape: Tuple[int, int, int]
    coords: Tuple[int, int, int]
    rank: int
    group: Optional[object]
    device: torch.device
    order: Optional[Tuple[int, ...]] = None

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def rank_of(self, coords) -> int:
        """The rank at mesh coordinates ``coords``."""
        _, my, mz = self.shape
        pos = (coords[0] * my + coords[1]) * mz + coords[2]
        return pos if self.order is None else self.order[pos]

    def coords_of(self, rank: int) -> Tuple[int, int, int]:
        """The mesh coordinates of ``rank``."""
        pos = rank if self.order is None else self.order.index(rank)
        return coords_of(pos, self.shape)

    def global_rank(self, rank: int) -> int:
        """The rank in the default group of this mesh's ``rank``."""
        if self.group is None:
            return rank
        return dist.get_global_rank(self.group, rank)


def coords_of(rank: int, shape) -> Tuple[int, int, int]:
    _, my, mz = shape
    return (rank // (my * mz), (rank // mz) % my, rank % mz)


def _device_for(backend: str, device) -> torch.device:
    """The device of a multi-rank mesh: the one asked for, else
    ``cuda:{LOCAL_RANK}``, which must suit the group's backend."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' (with a "
                "gloo process group) to run the plain path on the host"
            )
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    device = torch.device(device)
    want = "gloo" if device.type == "cpu" else "nccl"
    if backend != want:
        raise ValueError(
            f"{device.type} tensors exchange over {want}, but the process "
            f"group's backend is {backend}"
        )
    return device


def make_mesh(
    shape: Optional[Tuple[int, int, int]] = None,
    group=None,
    device=None,
    order: Optional[Tuple[int, ...]] = None,
) -> Mesh:
    """This process's mesh of ``shape`` (default: the world size
    factored by ``factor_devices``) over ``group`` (default: the world),
    its ranks row-major or in ``order`` (the rank at each row-major
    position).

    ``device`` defaults to CUDA (``cuda:{LOCAL_RANK}`` on a multi-rank
    mesh) and raises when there is none; pass ``"cpu"`` for the host."""
    initialised = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size(group) if initialised else 1
    if shape is None:
        shape = factor_devices(world)
    shape = tuple(int(s) for s in shape)
    if len(shape) != 3 or any(s < 1 for s in shape):
        raise ValueError(f"mesh shape {shape} is not three positive ints")
    n = math.prod(shape)
    if n == 1:
        return Mesh(shape, (0, 0, 0), 0, None, resolve_device(device))
    if not initialised:
        raise ValueError(
            f"mesh {shape} needs {n} processes in an initialised "
            "torch.distributed group; start one per shard with "
            f"'torchrun --nproc-per-node {n} ...'"
        )
    if world != n:
        raise ValueError(
            f"mesh {shape} needs {n} processes, the process group has "
            f"{world} (torchrun --nproc-per-node {n})"
        )
    if group is None:
        group = dist.group.WORLD
    rank = dist.get_rank(group)
    dev = _device_for(dist.get_backend(group), device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if order is not None:
        order = tuple(order)
        if sorted(order) != list(range(n)):
            raise ValueError(f"order {order} is not a permutation of the "
                             f"{n} ranks")
    pos = rank if order is None else order.index(rank)
    return Mesh(shape, coords_of(pos, shape), rank, group, dev, order)
