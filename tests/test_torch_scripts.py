"""The port's scripts (gpusolve_tpu_torch/scripts/) on the CPU:

  * ``parity --device cpu`` at 15³ (every engine, three modes, against
    the float64 host solver): all_ok, every single-device and (1,1,1)
    engine ran and pod-y is recorded as skipped, the record shaped like
    the JAX script's ``TPU_PARITY_r05.json``; a non-finite or short
    history fails its row;
  * ``experiments --platform cpu`` at 15³ for 2 cycles: the JAX script's
    JSON keys, and the host solver's histories those of ``cpu_native``;
  * ``plotter`` on a 15³ dump (where matplotlib is installed).
"""

import json
import os

import numpy as np
import pytest

import gpusolve_tpu_torch as gt
from gpusolve_tpu_torch import cpu_native
from gpusolve_tpu_torch.scripts import experiments, parity, plotter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def parity_record(tmp_path_factory):
    out = tmp_path_factory.mktemp("parity") / "parity.json"
    rc = parity.main(["--device", "cpu", "--sizes", "15", "--big", "0",
                      "--out", str(out)])
    return rc, json.loads(out.read_text())


def test_parity_cpu_all_ok(parity_record):
    rc, rec = parity_record
    assert rc == 0 and rec["all_ok"]
    with open(os.path.join(ROOT, "TPU_PARITY_r05.json")) as fh:
        jax_rec = json.load(fh)
    assert set(jax_rec) - {"round"} <= set(rec)
    assert rec["device"] == "cpu" and rec["platform"] == "cpu"
    rows = rec["results"]
    assert len(rows) == 3 * len(parity.ENGINES)
    jax_keys = set(jax_rec["results"][0])
    for row in rows:
        if row["engine"] == "pod-y":
            assert row["skipped"].startswith("needs 2 ranks")
            continue
        assert jax_keys <= set(row)
        assert row["ok"] and row["margin"] < 1.0
        assert len(row["history"]) == len(row["oracle"]) == (
            4 if row["mode"] == "NEWTON" else 9)


@pytest.mark.parametrize("bad", ["nan", "short"])
def test_parity_fails_a_broken_row(monkeypatch, bad):
    run = parity.run_engine

    def broken(size, mode_num, engine, device):
        hist, wall = run(size, mode_num, engine, device)
        if engine == "batch":
            hist = hist[:-1] if bad == "short" else hist[:-1] + [np.nan]
        return hist, wall

    monkeypatch.setattr(parity, "run_engine", broken)
    rows = parity.judge_group(15, 0, ["ref", "batch", "gspmd"],
                              parity.golden(15, 0), "cpu")
    assert [r["ok"] for r in rows] == [True, False, True]


def test_experiments_cpu_keys(tmp_path, capsys):
    out = tmp_path / "e.json"
    assert experiments.main([
        "--sizes", "15", "--maxiter", "2", "--platform", "cpu",
        "--backends", "auto,ref,cpu-native", "--json", str(out),
    ]) == 0
    rows = json.loads(out.read_text())
    assert len(rows) == 9
    for row in rows:
        assert set(row) == {"backend", "mode", "size", "first_total_ms",
                            "warm_total_ms", "ms_per_iter", "iters",
                            "residuals"}
        assert row["iters"] == 2 and len(row["residuals"]) == 3
    native = [r for r in rows if r["backend"] == "cpu-native"]
    for row in native:
        p = gt.parse_config(os.path.join(ROOT, "examples",
                                         "linear_127.conf"),
                            grid_dim=(15, 15, 15), maxiter=2,
                            mode=["LINEAR", "NONLINEAR", "NEWTON"].index(
                                row["mode"]), dtype="float64")
        want = [float(f"{h:.6g}") for h in cpu_native.solve_native(p)[1]]
        assert row["residuals"] == want
    table = capsys.readouterr().out
    assert table.splitlines()[0].startswith("backend")


def test_plotter_on_a_dump(tmp_path, capsys):
    pytest.importorskip("matplotlib")
    from gpusolve_tpu_torch.utils.dump import dump_field

    p = gt.parse_config(os.path.join(ROOT, "examples", "nonlinear_127.conf"),
                        grid_dim=(15, 15, 15), maxiter=3,
                        print_progress=False)
    state, _ = gt.solve(gt.build_grid(p, device="cpu"), p)
    dump = tmp_path / "u.txt"
    dump_field(state.levels[0].v.numpy(), str(dump))
    assert plotter.main([str(dump), "-o", str(tmp_path / "u.png")]) == 0
    assert (tmp_path / "u.png").stat().st_size > 0
    assert "max-abs mid-plane error" in capsys.readouterr().out


def test_plotter_without_matplotlib(tmp_path, monkeypatch, capsys):
    import builtins

    real = builtins.__import__

    def no_mpl(name, *args, **kwargs):
        if name.startswith("matplotlib"):
            raise ImportError(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_mpl)
    assert plotter.main([str(tmp_path / "missing.txt")]) == 1
    assert "matplotlib" in capsys.readouterr().err
