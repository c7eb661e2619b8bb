"""The per-leg engine's rdma exchange (``halo="rdma"``,
gpusolve_tpu_torch/ops/rdma.py) in one process, on CPU tensors:

  * the one-rank (1, 1, 1) engine with ``halo="rdma"`` in all three modes
    gives the ``halo="ppermute"`` history bit for bit (the legs read zero
    slabs in place of none), and launches no kernel;
  * the plain exchange on one rank: zero slabs of the asked depth, also
    deeper than the block (a one-rank leg may run on a block shorter than
    its slab);
  * the wrapper's argument errors, ``plan.rdma_active`` under a y split,
    and the rdma exchanges ``launches_per_cycle`` counts.

The multi-rank cases run in ``tests/test_torch_spmd.py``'s gloo spawns.
"""

import numpy as np
import pytest
import torch

import gpusolve_tpu_torch as gt
from gpusolve_tpu_torch.dist import mesh as tmesh
from gpusolve_tpu_torch.dist import spmd as tsp
from gpusolve_tpu_torch.ops import kernels, rdma


def _params(mode, dims=(15, 15, 15), dtype="float32", maxiter=3):
    return gt.GridParams(
        stencil=gt.Stencil.poisson_7pt(), maxiter=maxiter, tol=1e-30,
        grid_dim=dims, mode=mode, pre_smoothing=2, post_smoothing=2,
        omega=0.8, gamma=1.0, print_progress=False, dtype=dtype,
    )


def _fake_mesh(shape):
    """Rank 0 of a mesh of ``shape`` with no process group: enough to
    build a plan, an engine and an exchange object, not to exchange."""
    return tmesh.Mesh(shape, (0, 0, 0), 0, None, torch.device("cpu"))


def _exchange(shape, dims=(31, 31, 31)):
    return tsp._Exchange(_fake_mesh(shape),
                         gt.SpmdPlan(_params(0, dims), shape, 3))


@pytest.mark.parametrize("mode", [0, 1, 2], ids=["linear", "fas", "newton"])
def test_one_rank_rdma_matches_ppermute(mode):
    mesh = gt.make_mesh((1, 1, 1), device="cpu")
    p = _params(mode)
    run = gt.newton_solve_spmd if mode == 2 else gt.solve_spmd
    _, want, plan_pp = run(p, mesh, cutoff=3)
    kernels.reset_launches()
    state, got, plan = run(p, mesh, cutoff=3, halo="rdma")
    assert plan.rdma_active and not plan_pp.rdma_active
    assert plan.fused_down_levels and plan.fused_up_levels
    assert got == want
    assert all(n == 0 for n in kernels.launches.values())
    tsp._engine(p, mesh, 3, plan, "auto", halo="rdma").close()


def test_plain_exchange_one_rank_is_zero():
    ex = _exchange((1, 1, 1))
    u = torch.randn(6, 8, 10, dtype=torch.float64)
    for g in (1, 6, 8):
        out = rdma.rdma_exchange([u, u + 1.0], ex, g)  # CPU: the plain one
        assert len(out) == 2
        for xlo, xhi, ylo, yhi in out:
            assert xlo.shape == xhi.shape == (g, 8, 10)
            assert xlo.dtype == torch.float64
            assert not xlo.any() and not xhi.any()
            assert ylo is None and yhi is None
    assert ex.rdma == {}  # no registry on the CPU


ERRORS = {
    "shapes": "field 1 is",
    "dtypes": "field 1 is",
    "deep": "exceeds the block's x extent",
    "zero_depth": "not positive",
    "y_split": "x slabs only",
    "none": "at least one field",
    "many": "at most 8 fields",
    "2d": r"a field is a \(bx, by, bz\) block",
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_rdma_exchange_argument_errors(case):
    u = torch.zeros(16, 8, 4)
    mesh_shape, fields, g = (2, 1, 1), [u, u], 8
    if case == "shapes":
        fields = [u, torch.zeros(16, 8, 5)]
    elif case == "dtypes":
        fields = [u, u.double()]
    elif case == "deep":
        g = 17
    elif case == "zero_depth":
        g = 0
    elif case == "y_split":
        mesh_shape = (2, 2, 1)
    elif case == "none":
        fields = []
    elif case == "many":
        fields = [u] * 9
    elif case == "2d":
        fields = [u[0]]
    ex = _exchange(mesh_shape)
    for fn in (rdma.rdma_exchange, rdma.rdma_exchange_plain):
        with pytest.raises(ValueError, match=ERRORS[case]):
            fn(fields, ex, g)


def test_rdma_active_and_launch_counts():
    """``plan.rdma_active`` is the JAX engine's ``use_rdma``: halo="rdma"
    without a y split.  ``launches_per_cycle`` then counts one exchange a
    leg and two a corr-first up leg (its coarse block), and none
    otherwise."""
    p = _params(0, (63, 63, 63))
    for shape, halo, active in (((2, 1, 1), "rdma", True),
                                ((1, 1, 1), "rdma", True),
                                ((2, 2, 1), "rdma", False),
                                ((1, 2, 2), "rdma", False),
                                ((2, 1, 1), "ppermute", False)):
        eng = tsp.SpmdEngine(p, _fake_mesh(shape), 3, halo=halo)
        assert eng.plan.rdma_active == active, (shape, halo)
    big = _params(1, (511, 511, 511))
    plan = gt.SpmdPlan(big, (1, 1, 1))
    assert "rdma_exchange" not in tsp.launches_per_cycle(plan)
    plan.rdma_active = True
    counts = tsp.launches_per_cycle(plan)
    legs = counts["leg_block_fas"]
    assert legs == 14  # 6 down legs, 6 up legs, the junction's 2 smooths
    assert counts["rdma_exchange"] == legs + len(plan.fused_up_levels)


def test_rdma_engine_float64_runs_plain():
    """float64 runs the plain ops and the plain exchange (no kernel), as
    every other op of the engine: the history equals ppermute's to the
    bit."""
    mesh = gt.make_mesh((1, 1, 1), device="cpu")
    p = _params(1, dtype="float64", maxiter=2)
    _, want, _ = gt.solve_spmd(p, mesh, cutoff=3)
    _, got, plan = gt.solve_spmd(p, mesh, cutoff=3, halo="rdma")
    assert plan.rdma_active
    np.testing.assert_array_equal(got, want)
