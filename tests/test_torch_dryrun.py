"""The port's entry points (gpusolve_tpu_torch/dryrun.py) on the CPU:

  * ``entry()``'s cycle on the CPU against the JAX package's ``entry()``
    cycle (``__graft_entry__.py``): level 0's v to rtol 1e-5, the residual
    norm to rtol 1e-5 against the float64 oracle (tests/oracle.py) and to
    2e-5 against the JAX package's.  Both norms are float32 sums of 63³
    squares: the JAX package's on the CPU (XLA's reduction order) lies
    1.4e-5 from the oracle, the port's (torch.sum) 1.5e-6, while the two
    fields agree to 1.1e-8 of a 0.048 maximum;
  * one spawn of 8 gloo ranks running every section of
    ``dryrun_multichip`` (the JAX dry run's sections at n = 8), each
    section's history held against the port's single-device solve of the
    same parameters (rel 2e-4 where the residual is >= 1e-4 of the
    initial, a factor 1.5 below), and its engagement line.
"""

import concurrent.futures
import os
import sys

import numpy as np
import pytest

import gpusolve_tpu_torch as gt
from gpusolve_tpu_torch import dryrun
from gpusolve_tpu_torch.config import Mode

N = 8


def _jax_entry():
    """The JAX package's entry() cycle: level 0's v and the norm."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import __graft_entry__ as ge

    jfn, jargs = ge.entry()
    jstate, jres = jfn(*jargs)
    return np.asarray(jstate.levels[0].v)[:65, :65, :65], float(jres)


@pytest.fixture(scope="module")
def runs():
    """The 8 gloo ranks' sections, and the JAX entry() cycle computed in
    a thread meanwhile."""
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        jax_entry = ex.submit(_jax_entry)
        sections = dryrun.dryrun_multichip(N)
        return sections, jax_entry.result()


def test_entry_matches_jax_entry(runs):
    import oracle as orc
    from gpusolve_tpu.config import GridParams, Stencil
    from gpusolve_tpu.config import Mode as JMode

    fn, (state,) = dryrun.entry(device="cpu")
    params = fn.keywords["params"]
    assert params.grid_dim == (63, 63, 63) and params.dtype == "float32"
    _, res = fn(state)
    want, jres = runs[1]
    got = state.levels[0].v.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    golden = orc.solve(orc.OracleGrid(GridParams(
        maxiter=1, tol=params.tol, grid_dim=params.grid_dim,
        mode=JMode(int(params.mode)), pre_smoothing=3, post_smoothing=3,
        omega=params.omega, gamma=params.gamma,
        stencil=Stencil.poisson_7pt(), dtype="float64",
        print_progress=False,
    )))
    np.testing.assert_allclose(res, golden[1], rtol=1e-5)
    np.testing.assert_allclose(res, jres, rtol=2e-5)


def _single(sec):
    """The same parameters on one device (CPU, plain ops)."""
    p = sec.params
    if sec.engine == "refine":
        return gt.solve_refine(p, device="cpu")[1]
    solve = gt.newton_solve if p.mode == Mode.NEWTON else gt.solve
    return solve(gt.build_grid(p, device="cpu"), p)[1]


@pytest.mark.parametrize("sec", dryrun.SECTIONS, ids=lambda s: s.name)
def test_section_matches_single_device(runs, sec):
    got = runs[0][sec.name]
    want = _single(sec)
    hist = got["history"]
    assert len(hist) == len(want)
    for g, w in zip(hist, want):
        if w >= 1e-4 * want[0]:
            assert abs(g - w) <= 2e-4 * w, (hist, want)
        else:
            assert w / 1.5 <= g <= w * 1.5, (hist, want)
    line = got["engagement"]
    assert line.startswith(f"[dryrun] {sec.name}: ")
    if sec.engine == "spmd":
        assert " nd=" in line and "fused_down=" in line
        assert ("rdma=True" in line) == (("halo", "rdma") in sec.kw)
    else:
        assert "gspmd blocked levels 2" in line


def test_every_jax_section_runs(runs):
    """The JAX dry run's sections at n = 8, in its order."""
    assert list(runs[0]) == [
        "gspmd FAS", "spmd LINEAR", "spmd FAS", "spmd NEWTON",
        "rdma x-split", "pod x-split", "pod W-cycle x-split", "ysplit",
        "zfold", "pod y-split", "refine",
    ]
