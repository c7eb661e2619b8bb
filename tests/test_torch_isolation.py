"""The port stands alone: it imports neither jax nor the JAX package, runs on
CUDA unless the CPU is asked for, and never launches a kernel for a CPU
tensor."""

import os
import re
import subprocess
import sys

import pytest
import torch

import gpusolve_tpu_torch as gt
from gpusolve_tpu_torch import grid as tgrid
from gpusolve_tpu_torch.ops import dispatch, kernels

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "gpusolve_tpu_torch")
CONF = os.path.join(ROOT, "examples", "linear_127.conf")


def port_sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PKG):
        files += [
            os.path.join(dirpath, n) for n in names
            if n.endswith((".py", ".cu", ".cuh", ".cpp"))
        ]
    return files


def test_import_leaves_jax_out():
    code = (
        "import sys, gpusolve_tpu_torch, gpusolve_tpu_torch.cli, "
        "gpusolve_tpu_torch.interop, gpusolve_tpu_torch.ops.vcycle_batch, "
        "gpusolve_tpu_torch.dist.spmd, gpusolve_tpu_torch.ops.spmd_kernels, "
        "gpusolve_tpu_torch.dist.pod, gpusolve_tpu_torch.ops.pod, "
        "gpusolve_tpu_torch.ops.spmd_leg, gpusolve_tpu_torch.ops.rdma, "
        "gpusolve_tpu_torch.cpu_native, gpusolve_tpu_torch.utils.tuning, "
        "gpusolve_tpu_torch.dryrun, gpusolve_tpu_torch.scripts.parity, "
        "gpusolve_tpu_torch.scripts.experiments, "
        "gpusolve_tpu_torch.scripts.plotter; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'gpusolve_tpu' or m.startswith('gpusolve_tpu.')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_import_no_jax():
    pat = re.compile(
        r"^\s*(import\s+jax\b|from\s+jax\b|import\s+gpusolve_tpu\b(?!_torch)"
        r"|from\s+gpusolve_tpu\b(?!_torch))",
        re.M,
    )
    files = port_sources()
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            text = f.read()
        assert not pat.search(text), path
        assert "import jax" not in text, path


def test_sources_cover_the_host_solver_and_scripts():
    names = {os.path.relpath(p, PKG) for p in port_sources()}
    assert {"cpu_native.py", "ops/csrc/gpusolve_cpu.cpp", "utils/tuning.py",
            "dryrun.py", "scripts/parity.py", "scripts/experiments.py",
            "scripts/plotter.py"} <= names


def test_build_grid_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = gt.parse_config(CONF, grid_dim=(15, 15, 15))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gt.build_grid(params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgrid.resolve_device(None)
    assert tgrid.resolve_device("cpu").type == "cpu"


def test_cpu_solve_leaves_counters_at_zero():
    kernels.reset_launches()
    params = gt.parse_config(
        CONF, grid_dim=(15, 15, 15), maxiter=3, print_progress=False
    )
    for cycle in "VWF":
        p = params.replace(cycle_type=cycle)
        gt.solve(gt.build_grid(p, device="cpu"), p, check_every=2)
    assert set(kernels.launches) == set(kernels.KERNELS)
    assert all(n == 0 for n in kernels.launches.values())


def test_backend_cuda_on_cpu_raises():
    params = gt.parse_config(
        CONF, grid_dim=(15, 15, 15), print_progress=False, backend="cuda"
    )
    state = gt.build_grid(params, device="cpu")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        gt.solve(state, params)
    lvl = state.levels[0]
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        dispatch.smooth(
            lvl.v, lvl.f, lvl.r, params.grid_dim, params, params.h, 1
        )


def test_cpu_spmd_solve_leaves_counters_at_zero():
    """The distributed engine on CPU tensors runs the plain versions of its
    kernels and of the replicated levels' ops: no counter moves."""
    kernels.reset_launches()
    mesh = gt.make_mesh((1, 1, 1), device="cpu")
    for mode in range(3):
        params = gt.parse_config(
            CONF, grid_dim=(15, 15, 15), maxiter=2, print_progress=False,
            mode=mode,
        )
        if mode == 2:
            gt.newton_solve_spmd(params, mesh, cutoff=3)
        else:
            gt.solve_spmd(params, mesh, cutoff=3, check_every=2)
    assert all(n == 0 for n in kernels.launches.values())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        import unittest.mock as um

        with um.patch.object(torch.cuda, "is_available", lambda: False):
            gt.make_mesh((1, 1, 1))


def test_cpu_pod_solve_leaves_counters_at_zero():
    """The pod engine on CPU tensors runs the plain chains and the tail's
    plain ops: no counter moves, in any mode; its module sources are
    scanned above (ops/pod.py, dist/pod.py, csrc/pod.cu, leg_device.cuh)."""
    names = {os.path.relpath(p, PKG) for p in port_sources()}
    assert {"ops/pod.py", "dist/pod.py", "ops/csrc/pod.cu",
            "ops/csrc/leg_device.cuh"} <= names
    kernels.reset_launches()
    mesh = gt.make_mesh((1, 1, 1), device="cpu")
    for mode in range(3):
        params = gt.parse_config(
            CONF, grid_dim=(15, 15, 15), maxiter=2, print_progress=False,
            mode=mode,
        )
        if mode == 2:
            gt.newton_solve_spmd(params, mesh, fuse="pod")
        else:
            gt.solve_spmd(params, mesh, fuse="pod", check_every=2)
    assert all(n == 0 for n in kernels.launches.values())


def test_cpu_rdma_solve_leaves_counters_at_zero():
    """halo="rdma" on CPU tensors runs the plain exchange: no counter
    moves, in any mode; its module sources are scanned above (ops/rdma.py,
    csrc/rdma_exchange.cu)."""
    names = {os.path.relpath(p, PKG) for p in port_sources()}
    assert {"ops/rdma.py", "ops/csrc/rdma_exchange.cu"} <= names
    kernels.reset_launches()
    mesh = gt.make_mesh((1, 1, 1), device="cpu")
    for mode in range(3):
        params = gt.parse_config(
            CONF, grid_dim=(15, 15, 15), maxiter=2, print_progress=False,
            mode=mode,
        )
        if mode == 2:
            gt.newton_solve_spmd(params, mesh, cutoff=3, halo="rdma")
        else:
            gt.solve_spmd(params, mesh, cutoff=3, halo="rdma", check_every=2)
    assert all(n == 0 for n in kernels.launches.values())
    assert kernels.launches["rdma_exchange"] == 0
