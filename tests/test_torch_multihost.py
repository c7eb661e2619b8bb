"""The port's multi-process helpers (gpusolve_tpu_torch/dist/multihost.py)
on the CPU, the counterparts of tests/test_multihost.py: the
single-process no-op, the topology mesh's rank blocks (pure Python, the
JAX package's gcd rule), and two processes joined from torchrun's
environment over gloo on localhost, each solving the same problem on the
GSPMD engine over the topology mesh and agreeing on the history.
"""

import os
import socket
import time

import numpy as np
import pytest
import torch

import gpusolve_tpu_torch as gt
from gpusolve_tpu_torch import config as tcfg
from gpusolve_tpu_torch.config import Mode
from gpusolve_tpu_torch.dist import multihost


def test_initialize_single_process_is_noop(monkeypatch):
    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert multihost.initialize(device="cpu") is False
    assert not torch.distributed.is_initialized()
    assert multihost.is_multiprocess() is False
    mesh = multihost.make_topology_mesh(device="cpu")
    assert mesh.shape == (1, 1, 1) and mesh.size == 1 and mesh.order is None


@pytest.mark.parametrize("shape,world,per_host,blocks", [
    # Two hosts of four ranks: stacked along x, each a (1,2,2) block.
    ((2, 2, 2), 8, 4, [(0, 0, 0), (1, 0, 0)]),
    # Four hosts of two on (2,4,1): x takes 2, y the other 2.
    ((2, 4, 1), 8, 2, [(0, 0, 0), (0, 2, 0), (1, 0, 0), (1, 2, 0)]),
    # Eight hosts of one: the plain row-major order.
    ((2, 2, 2), 8, 1, None),
])
def test_topology_order_blocks(shape, world, per_host, blocks):
    """Each host's ranks form a contiguous block of the mesh, hosts
    stacked along x first (``gpusolve_tpu/dist/multihost.py:113-124``);
    within a host its ranks lie row-major."""
    order = multihost.topology_order(shape, world, per_host)
    assert sorted(order) == list(range(world))
    where = np.empty(world, dtype=object)
    for pos, rank in enumerate(order):
        where[rank] = np.unravel_index(pos, shape)
    if blocks is None:
        assert order == tuple(range(world))
        return
    for host, corner in enumerate(blocks):
        ranks = range(host * per_host, (host + 1) * per_host)
        pts = np.array([where[r] for r in ranks])
        lo, hi = pts.min(axis=0), pts.max(axis=0)
        assert tuple(lo) == corner
        assert int(np.prod(hi - lo + 1)) == per_host
        # Row-major within the host's block.
        assert [tuple(p) for p in pts] == sorted(tuple(p) for p in pts)


def test_topology_order_untileable():
    """Hosts that do not tile the shape leave make_mesh's order."""
    assert multihost.topology_order((3, 1, 1), 6, 2) is None  # 3 of 6 ranks
    assert multihost.topology_order((2, 2, 2), 8, 3) is None  # 8 % 3 != 0


def _worker(rank, port, out):
    torch.set_num_threads(1)
    os.environ.update(
        RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1",
        MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
    )
    assert multihost.initialize(device="cpu")
    try:
        assert multihost.is_multiprocess()
        assert torch.distributed.get_world_size() == 2
        mesh = multihost.make_topology_mesh(device="cpu")
        params = tcfg.GridParams(
            maxiter=2, tol=1e-30, grid_dim=(15, 15, 15), mode=Mode.LINEAR,
            pre_smoothing=2, post_smoothing=2, omega=0.8, gamma=1.0,
            stencil=tcfg.Stencil.poisson_7pt(), print_progress=False,
            dtype="float64",
        )
        shs = gt.level_shardings(params, mesh, 2)
        _, history = gt.solve(gt.build_grid(params, device="cpu"), params,
                              shardings=shs)
        np.save(os.path.join(out, f"r{rank}.npy"),
                np.asarray([*mesh.shape, *history]))
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_cpu_smoke(tmp_path):
    """Two processes join from the environment (RANK, WORLD_SIZE,
    MASTER_ADDR/MASTER_PORT on localhost), build the topology mesh over
    both hosts (one rank each: (2,1,1)) and see the same history, which
    is the single-device one to rounding."""
    ctx = torch.multiprocessing.start_processes(
        _worker, args=(_free_port(), str(tmp_path)), nprocs=2, join=False,
        start_method="spawn",
    )
    deadline = time.monotonic() + 240
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.terminate()
            pytest.fail("the two processes did not finish")
    got = [np.load(tmp_path / f"r{r}.npy") for r in range(2)]
    assert list(got[0][:3]) == [2, 1, 1]
    assert np.array_equal(got[0], got[1])
    assert len(got[0]) == 3 + 3  # the shape, then initial + 2 cycles
    params = tcfg.GridParams(
        maxiter=2, tol=1e-30, grid_dim=(15, 15, 15), mode=Mode.LINEAR,
        pre_smoothing=2, post_smoothing=2, omega=0.8, gamma=1.0,
        stencil=tcfg.Stencil.poisson_7pt(), print_progress=False,
        dtype="float64",
    )
    _, want = gt.solve(gt.build_grid(params, device="cpu"), params)
    np.testing.assert_allclose(got[0][3:], want, rtol=1e-12)
