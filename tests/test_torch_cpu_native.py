"""The port's host solver (gpusolve_tpu_torch/cpu_native.py) and
``--backend cpu-native`` on its CLI, on the CPU:

  * the port's copy of the C++ source is byte for byte the JAX package's
    ``csrc/gpusolve_cpu.cpp``;
  * ``solve_native`` against the JAX package's at 15³ in the three modes:
    histories and fields to rtol 1e-12 (the library's
    ``reduction(+:sumsq)`` may combine its partial sums in any order), in
    a process that imported torch first (torch's OpenMP runtime and the
    library's in one process);
  * against the float64 oracle (tests/oracle.py) at rtol 1e-9, as
    tests/test_cpu_native.py holds the JAX package's;
  * the strip budget seeded from the tuning table unless set;
  * the CLI's standard output line for line the JAX CLI's, apart from the
    ``Took Nms`` figures, with --dump and --validate; the three refusals
    (--refine, --profile, --cycle W) with the JAX CLI's text and rc 1.
"""

import contextlib
import filecmp
import io
import os
import re

import numpy as np
import pytest
import torch  # noqa: F401  (torch's OpenMP runtime loads before the library)

import gpusolve_tpu_torch as gt
from gpusolve_tpu_torch import cli, cpu_native
from gpusolve_tpu_torch import config as tcfg
from gpusolve_tpu_torch.config import Mode
from gpusolve_tpu_torch.utils import tuning

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = {mode: os.path.join(ROOT, "examples", f"{name}_127.conf")
            for mode, name in enumerate(("linear", "nonlinear", "newton"))}
RTOL = 1e-12
MODES = [Mode.LINEAR, Mode.NONLINEAR, Mode.NEWTON]
IDS = ["linear", "nonlinear", "newton"]


def _kw(mode, dims=(15, 15, 15), maxiter=4):
    return dict(
        maxiter=maxiter, tol=1e-5, grid_dim=dims, mode=mode,
        pre_smoothing=3, post_smoothing=3, omega=0.8, gamma=1.0,
        dtype="float64", print_progress=False,
    )


def _tparams(mode, **kw):
    return tcfg.GridParams(stencil=tcfg.Stencil.poisson_7pt(),
                           **_kw(mode, **kw))


def _jparams(mode, **kw):
    from gpusolve_tpu.config import GridParams, Stencil

    return GridParams(stencil=Stencil.poisson_7pt(), **_kw(mode, **kw))


def test_source_is_the_jax_packages_byte_for_byte():
    assert filecmp.cmp(cpu_native.SOURCE,
                       os.path.join(ROOT, "csrc", "gpusolve_cpu.cpp"),
                       shallow=False)
    assert cpu_native.library_path().parent == cpu_native.BUILD_DIR


@pytest.mark.parametrize("mode", MODES, ids=IDS)
def test_matches_jax_package(mode):
    from gpusolve_tpu import cpu_native as jax_native

    sol, hist = cpu_native.solve_native(_tparams(mode))
    want_sol, want_hist = jax_native.solve_native(_jparams(mode))
    assert len(hist) == len(want_hist)
    np.testing.assert_allclose(hist, want_hist, rtol=RTOL)
    np.testing.assert_allclose(sol, want_sol, rtol=RTOL,
                               atol=RTOL * np.abs(want_sol).max())
    assert sol.shape == (17, 17, 17) and sol.dtype == np.float64


@pytest.mark.parametrize("mode", MODES, ids=IDS)
def test_matches_oracle(mode):
    import oracle as orc

    g = orc.OracleGrid(_jparams(mode))
    want = orc.newton_solve(g) if mode == Mode.NEWTON else orc.solve(g)
    sol, hist = cpu_native.solve_native(_tparams(mode))
    assert len(hist) == len(want)
    np.testing.assert_allclose(hist, want, rtol=1e-9)
    field = g.levels[0].newton_v if mode == Mode.NEWTON else g.levels[0].v
    np.testing.assert_allclose(sol[1:-1, 1:-1, 1:-1],
                               field[1:-1, 1:-1, 1:-1], rtol=1e-8,
                               atol=1e-12)
    _, timed, ms = cpu_native.solve_native(_tparams(mode), with_times=True)
    np.testing.assert_allclose(timed, hist, rtol=RTOL)
    assert len(ms) == len(hist) - 1
    assert cpu_native.num_threads() >= 1


def test_strip_budget_seeded_from_the_table(monkeypatch):
    monkeypatch.delenv(cpu_native.STRIP_ENV, raising=False)
    cpu_native.seed_strip_kb()
    assert os.environ[cpu_native.STRIP_ENV] == \
        str(tuning.current().cpu_strip_kb) == "32"
    monkeypatch.delenv(cpu_native.STRIP_ENV)
    monkeypatch.setattr(tuning, "current",
                        lambda: tuning.DeviceTuning(cpu_strip_kb=48))
    cpu_native.seed_strip_kb()
    assert os.environ[cpu_native.STRIP_ENV] == "48"
    monkeypatch.setenv(cpu_native.STRIP_ENV, "64")
    cpu_native.seed_strip_kb()
    assert os.environ[cpu_native.STRIP_ENV] == "64"


def test_device_solvers_refuse_cpu_native():
    p = _tparams(Mode.LINEAR).replace(backend="cpu-native")
    with pytest.raises(ValueError, match="host solver"):
        gt.solve(gt.build_grid(p, device="cpu"), p)


def _run(main, args):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(args)
    return rc, out.getvalue(), err.getvalue()


def _conf(tmp_path, mode, dims=(31, 31, 31)):
    toks = open(EXAMPLES[mode]).read().split()
    toks[2:5] = [str(d) for d in dims]
    path = tmp_path / f"m{mode}.conf"
    path.write_text(" ".join(toks))
    return str(path)


TOOK = re.compile(r" Took \d+ms$")


@pytest.mark.parametrize("mode", [0, 1, 2], ids=IDS)
def test_cli_lines_match_jax_cli(tmp_path, monkeypatch, mode):
    from gpusolve_tpu import cli as jcli

    monkeypatch.chdir(tmp_path)
    conf = _conf(tmp_path, mode)
    extra = ["--dump", "u.txt"] + (["--validate"] if mode else [])
    rc, out, err = _run(cli.main, [conf, "--backend", "cpu-native",
                                   "--explain-backend", *extra])
    assert rc == 0, err
    mine = (tmp_path / "u.txt").read_text()
    rc, want, _ = _run(jcli.main, [conf, "--backend", "cpu-native", *extra])
    assert rc == 0
    assert (tmp_path / "u.txt").read_text() == mine
    got, want = out.splitlines(), want.splitlines()
    assert [TOOK.sub("", ln) for ln in got] == \
        [TOOK.sub("", ln) for ln in want]
    assert sum(bool(TOOK.search(ln)) for ln in got) >= 3
    assert "Dumped solution to u.txt" in got
    assert "backend: cpu-native: the C++/OpenMP host solver" in err


@pytest.mark.parametrize("args", [
    ["--refine"], ["--profile", "prof"], ["--cycle", "W"],
    ["--refine", "--dtype", "float64"],
])
def test_cli_refusals_match_jax_cli(tmp_path, monkeypatch, args):
    from gpusolve_tpu import cli as jcli

    monkeypatch.chdir(tmp_path)
    conf = _conf(tmp_path, 0, dims=(15, 15, 15))
    argv = [conf, "--backend", "cpu-native", *args]
    got = _run(cli.main, argv)
    want = _run(jcli.main, argv)
    assert got[0] == want[0] == 1
    assert got[1:] == want[1:]
    assert not (tmp_path / "prof").exists()
