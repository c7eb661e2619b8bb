"""The per-leg spmd engine's in-kernel halo exchange (``halo="rdma"``,
``csrc/rdma_exchange.cu``): the wrapper, the peer registry and the plain
version.

It replaces the JAX package's
``gpusolve_tpu/ops/pallas_spmd.py::_rdma_exchange_call`` (:1919, wrapped by
``rdma_exchange`` at :2030): the x-face slabs of ``n`` same-shape fields
of a shard's block, ``g`` planes deep, written by each shard straight into
its x neighbours' receive buffers, zeros at the global x edges.  Per field
the result is ``(xlo, xhi, None, None)`` in ``dist/spmd._Exchange.slabs``'
form: ``xlo`` the lower neighbour's last ``g`` planes, ``xhi`` the upper
neighbour's first ``g``, bit for bit what the point-to-point pair gives.
It carries x slabs only: under a y split the engine runs the two-stage
exchange instead (``plan.rdma_active`` False), and this wrapper refuses.

On the card (``rdma_exchange`` on CUDA tensors):
  * **the registry** (``RdmaSlabs``, a ``PeerSlabs``), built once per
    exchange object, block shape, dtype, depth and field count: this
    rank's receive buffers (lo and hi per field) as one device allocation
    of its own, so its CUDA IPC handle needs no offset; the handles and
    host names swapped with ``all_gather_object`` over the mesh's group;
    each x neighbour's handle opened (``cudaIpcOpenMemHandle``, lazy peer
    access).  Neighbours on different hosts raise ``ValueError``; a
    failure to allocate, open or launch raises ``RuntimeError``.  Nothing
    falls back to the point-to-point exchange.  ``PeerSlabs`` opens y
    neighbours too, for the pod chains' registry (``ops/pod.py``);
  * **the barrier** is host-ordered, unlike the TPU kernel's in-kernel
    semaphores: before the launch a stream sync and a group barrier (no
    neighbour's leg still reads the buffers this launch writes), after it
    the same (every write has landed before this rank's leg reads).  A
    one-rank mesh has no peer and no barrier: the launch is the edge zero
    fill alone, as the reference's kernel on a 1×1×1 mesh;
  * ``kernels.launches["rdma_exchange"]`` counts the launch.

On CPU tensors the wrapper runs ``rdma_exchange_plain``: the same slabs
through the group's point-to-point messages (``_Exchange.swap`` per
field; gloo on the CPU), zeros at the edges and on one rank.

``close(ex)`` releases an exchange object's registries (collective on a
multi-rank mesh: every rank closes its neighbours' mappings, a barrier,
then every rank frees its own buffers).  A registry dropped without it
frees its buffers when it is collected.
"""

from __future__ import annotations

import ctypes
import socket
import weakref
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

from gpusolve_tpu_torch.ops import kernels

MAX_FIELDS = 8  # the kernel takes 16 jobs, two a field

SlabSet = Tuple[torch.Tensor, torch.Tensor, None, None]


def _check_args(fields: Sequence[torch.Tensor], ex, g: int) -> None:
    if not fields:
        raise ValueError("rdma_exchange needs at least one field")
    if len(fields) > MAX_FIELDS:
        raise ValueError(f"rdma_exchange takes at most {MAX_FIELDS} fields, "
                         f"got {len(fields)}")
    u0 = fields[0]
    if u0.dim() != 3:
        raise ValueError(f"a field is a (bx, by, bz) block, got shape "
                         f"{tuple(u0.shape)}")
    for i, u in enumerate(fields):
        if u.shape != u0.shape or u.dtype != u0.dtype \
                or u.device != u0.device:
            raise ValueError(
                f"field {i} is {tuple(u.shape)} {u.dtype} on {u.device}, "
                f"field 0 {tuple(u0.shape)} {u0.dtype} on {u0.device}")
    if g < 1:
        raise ValueError(f"slab depth {g} is not positive")
    if ex.plan.mesh_shape[0] > 1 and g > u0.shape[0]:
        # One rank's slabs are zeros of any depth (a one-rank leg may run
        # on a block shorter than its slab); a neighbour's are its planes.
        raise ValueError(f"slab depth {g} exceeds the block's x extent "
                         f"{u0.shape[0]}")
    if ex.plan.mesh_shape[1] > 1:
        raise ValueError(
            "rdma_exchange carries x slabs only; under a y split the "
            "two-stage exchange runs (_Exchange.slabs)")


def rdma_exchange_plain(fields: Sequence[torch.Tensor], ex,
                        g: int) -> List[SlabSet]:
    """Plain version of :func:`rdma_exchange`: each field's slabs through
    the group's point-to-point messages."""
    _check_args(fields, ex, g)
    if ex.plan.mesh_shape[0] == 1:
        z = ex.zeros((g,) + tuple(fields[0].shape[1:]), fields[0])
        return [(z, z, None, None) for _ in fields]
    out = []
    for u in fields:
        xlo, xhi = ex.swap(0, u[-g:], u[:g])
        out.append((xlo, xhi, None, None))
    return out


def _rc(rc: int, what: str) -> None:
    if rc != 0:
        msg = kernels.lib().mg_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: {msg}")


class _DeviceArray:
    """A device allocation seen by ``torch.as_tensor`` (the CUDA array
    interface); the tensor keeps this object alive, not the memory."""

    def __init__(self, ptr: int, shape, dtype: torch.dtype):
        typestr = {torch.float32: "<f4", torch.float64: "<f8"}[dtype]
        self.__cuda_array_interface__ = {
            "shape": tuple(shape), "typestr": typestr,
            "data": (ptr, False), "version": 2, "strides": None,
        }


def _as_tensor(ptr: int, shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.as_tensor(_DeviceArray(ptr, shape, dtype))


def _release(lib, device: int, own: List[int], peers: List[int]) -> None:
    """Closes the opened peer buffers and frees this rank's own; errors
    are ignored (a process may be past its CUDA teardown)."""
    while peers:
        lib.mg_ipc_close(device, peers.pop())
    while own:
        lib.mg_ipc_free(device, own.pop())


class PeerSlabs:
    """One registry of peer memory: one device allocation of its own on
    this rank (``base``, ``nbytes``, zeroed before any neighbour can open
    it), and the device pointers of the same allocation of this rank's
    neighbours along the data axes ``axes`` (0: x, 1: y), opened over CUDA
    IPC: ``peers[(ax, step)]``, step -1 the lower and +1 the upper
    neighbour, absent at a global edge.  ``sig`` is the layout every rank
    of the group must agree on (a mismatch raises).  The rdma exchange's
    receive buffers are one (``RdmaSlabs``), the pod chains' exchange
    another (``ops/pod.ChainPeers``)."""

    def __init__(self, ex, nbytes: int, device: torch.device, axes=(0,),
                 sig=None):
        self.lib = lib = kernels.lib()
        self.device = device
        self.index = device.index if device.index is not None \
            else torch.cuda.current_device()
        self.nbytes = nbytes = -(-nbytes // 256) * 256
        ptr = ctypes.c_void_p()
        _rc(lib.mg_ipc_alloc(self.index, nbytes, ctypes.byref(ptr)),
            "cudaMalloc of the peer buffers")
        self._own, self._peers = [ptr.value], []
        self._finalizer = weakref.finalize(self, _release, lib, self.index,
                                           self._own, self._peers)
        self.base = ptr.value
        _as_tensor(self.base, (nbytes // 4,), torch.float32).zero_()
        torch.cuda.synchronize(device)
        self.peers = {}
        if ex.mesh.size > 1:
            self._open_peers(ex, axes, sig)

    @property
    def peer_lo(self):
        return self.peers.get((0, -1))

    @property
    def peer_hi(self):
        return self.peers.get((0, 1))

    def _open_peers(self, ex, axes, sig) -> None:
        """Swaps IPC handles with every rank of the group and opens the
        neighbours' along ``axes``."""
        mesh, lib = ex.mesh, self.lib
        handle = (ctypes.c_char * lib.mg_ipc_handle_size())()
        _rc(lib.mg_ipc_handle(self.index, self.base, handle),
            "cudaIpcGetMemHandle of the peer buffers")
        everyone = [None] * mesh.size
        dist.all_gather_object(everyone, (socket.gethostname(),
                                          bytes(handle), sig),
                               group=mesh.group)
        if any(e[2] != sig for e in everyone):
            raise ValueError("the ranks' peer buffers differ in layout: "
                             f"{sorted({str(e[2]) for e in everyone})}")
        me = everyone[mesh.rank][0]
        for ax in axes:
            for step in (-1, 1):
                nb = ex.neighbour(ax, step)
                if nb is None:
                    continue
                host, peer, _ = everyone[nb]
                name = "xy"[ax]
                if host != me:
                    raise ValueError(
                        f"{name} neighbour rank {nb} runs on host {host!r}, "
                        f"this rank on {me!r}; CUDA IPC maps memory between "
                        "processes of one host only")
                ptr = ctypes.c_void_p()
                _rc(lib.mg_ipc_open(self.index, peer, ctypes.byref(ptr)),
                    f"cudaIpcOpenMemHandle of {name} neighbour rank {nb}'s "
                    "peer buffers")
                self._peers.append(ptr.value)
                self.peers[(ax, step)] = ptr.value

    def close_peers(self) -> None:
        while self._peers:
            self.lib.mg_ipc_close(self.index, self._peers.pop())
        self.peers = {}

    def free(self) -> None:
        self._finalizer()


class RdmaSlabs(PeerSlabs):
    """The rdma exchange's registry: the receive buffers of ``n`` fields'
    x slabs of one block ``shape``, ``dtype`` and depth ``g`` on this rank
    (``recv``, ``(2n, g, by, bz)``: lo and hi of each field) and its x
    neighbours' (``peer_lo`` / ``peer_hi``, None at a global edge)."""

    def __init__(self, ex, shape, dtype: torch.dtype, g: int, n: int,
                 device: torch.device):
        self.shape, self.g, self.n = tuple(shape), g, n
        _, by, bz = self.shape
        self.elem = torch.empty((), dtype=dtype).element_size()
        self.slab_bytes = g * by * bz * self.elem
        super().__init__(ex, 2 * n * self.slab_bytes, device,
                         sig=(self.shape, str(dtype), g, n))
        self.recv = _as_tensor(self.base, (2 * n, g, by, bz), dtype)

    def slabs(self) -> List[SlabSet]:
        """Per field ``(xlo, xhi, None, None)``: views of ``recv``."""
        return [(self.recv[2 * i], self.recv[2 * i + 1], None, None)
                for i in range(self.n)]

    def jobs(self, fields: Sequence[torch.Tensor]):
        """The kernel's copies: per field its first ``g`` planes into the
        lower neighbour's hi buffer (or zeros into its own lo), its last
        ``g`` into the upper neighbour's lo buffer (or zeros into its own
        hi).  ``(dst, src, bytes)`` triples, src None for a zero fill."""
        sb = self.slab_bytes
        tail = (self.shape[0] - self.g) * self.shape[1] * self.shape[2] \
            * self.elem
        lo_peer, hi_peer = self.peer_lo, self.peer_hi
        out = []
        for i, u in enumerate(fields):
            lo, hi = self.base + 2 * i * sb, self.base + (2 * i + 1) * sb
            out.append((lo_peer + (2 * i + 1) * sb, u.data_ptr(), sb)
                       if lo_peer is not None else (lo, None, sb))
            out.append((hi_peer + 2 * i * sb, u.data_ptr() + tail, sb)
                       if hi_peer is not None else (hi, None, sb))
        return out

    def launch(self, fields: Sequence[torch.Tensor]) -> None:
        """One launch of the kernel on the current stream, no barrier."""
        jobs = self.jobs(fields)
        k = len(jobs)
        rc = self.lib.mg_rdma_exchange(
            (ctypes.c_void_p * k)(*[j[0] for j in jobs]),
            (ctypes.c_void_p * k)(*[j[1] for j in jobs]),
            (ctypes.c_longlong * k)(*[j[2] for j in jobs]), k,
            kernels._stream(self.device),
        )
        kernels._check_rc(rc, "rdma_exchange")


def peer_slabs(ex, fields: Sequence[torch.Tensor], g: int) -> RdmaSlabs:
    """The registry of ``ex`` for these fields' shape, dtype, depth and
    count, built on first use (collective on a multi-rank mesh: every
    rank reaches the same exchanges in the same order)."""
    u = fields[0]
    key = (tuple(u.shape), u.dtype, g, len(fields))
    reg = ex.rdma.get(key)
    if reg is None:
        reg = ex.rdma[key] = RdmaSlabs(ex, u.shape, u.dtype, g, len(fields),
                                       u.device)
    return reg


def _fence(ex, device: torch.device) -> None:
    """The host-ordered barrier: this rank's stream drained, then every
    rank of the group at the same point."""
    if ex.mesh.size > 1:
        torch.cuda.current_stream(device).synchronize()
        dist.barrier(group=ex.mesh.group)


def rdma_exchange(fields: Sequence[torch.Tensor], ex,
                  g: int) -> List[SlabSet]:
    """The ``g``-plane x-face slabs of same-shape contiguous ``fields``
    (float32 or float64) through peer writes: per field ``(xlo, xhi, None,
    None)``, zeros where there is no neighbour.  ``ex`` is the rank's
    ``dist/spmd._Exchange``.  The slabs are views of the registry's
    receive buffers, valid until the next exchange of the same shape,
    depth and field count."""
    _check_args(fields, ex, g)
    if fields[0].device.type == "cpu":
        return rdma_exchange_plain(fields, ex, g)
    dev = kernels._cuda_device(fields[0])
    if fields[0].dtype not in (torch.float32, torch.float64):
        raise TypeError(f"rdma_exchange copies float32 or float64 fields, "
                        f"got {fields[0].dtype}")
    for i, u in enumerate(fields):
        if not u.is_contiguous():
            raise ValueError(f"field {i} is not contiguous")
    reg = peer_slabs(ex, fields, g)
    _fence(ex, dev)
    reg.launch(fields)
    kernels.launches["rdma_exchange"] += 1
    _fence(ex, dev)
    return reg.slabs()


def close(ex) -> None:
    """Releases every registry of ``ex``: the neighbours' mappings closed,
    a barrier on a multi-rank mesh, then this rank's buffers freed."""
    regs: List[PeerSlabs] = list(ex.rdma.values())
    ex.rdma.clear()
    if not regs:
        return
    torch.cuda.synchronize(regs[0].device)
    for reg in regs:
        reg.close_peers()
    if ex.mesh.size > 1:
        dist.barrier(group=ex.mesh.group)
    for reg in regs:
        reg.free()

