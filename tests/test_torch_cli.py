"""The port's CLI on the CPU: the reference's output lines in every mode,
and a clear exit for every flag not ported yet."""

import os
import re

import pytest
import torch

from gpusolve_tpu_torch import cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(ROOT, "examples", "linear_127.conf")

LINE = re.compile(r"^iter: (\d+) residual: (\S+) Took (\d+)ms")


@pytest.fixture
def small_conf(tmp_path):
    def make(mode=0, dims=(15, 15, 15), maxiter=4):
        toks = open(CONF).read().split()
        toks[0] = str(maxiter)
        toks[2:5] = [str(d) for d in dims]
        toks[5] = str(mode)
        path = tmp_path / f"m{mode}.conf"
        path.write_text(" ".join(toks))
        return str(path)

    return make


@pytest.mark.parametrize("extra", [[], ["--cycle", "W", "--check-every", "3"]])
def test_cli_cpu_lines(small_conf, capsys, extra):
    path = small_conf()
    assert cli.main([path, "--platform", "cpu", *extra]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"Using config file {path}"
    assert out[1] == "Solving linear problem"
    m = re.match(r"^Inital residual: (\S+)$", out[2])
    assert m and float(m.group(1)) > 0
    iters = [LINE.match(line) for line in out[3:]]
    assert iters and all(iters)
    assert [int(x.group(1)) for x in iters] == list(range(len(iters)))
    res = [float(x.group(2)) for x in iters]
    assert all(b < a for a, b in zip(res, res[1:]))


def test_cli_float64_and_devices(small_conf, capsys):
    path = small_conf(maxiter=2)
    assert cli.main(
        [path, "--platform", "cpu", "--dtype", "float64", "--devices"]
    ) == 0
    out = capsys.readouterr().out
    assert "Device [0]: cpu" in out and "iter: 1 residual:" in out


@pytest.mark.parametrize(
    "args",
    [
        ["--mesh", "1,1,1"], ["--refine"], ["--save-state", "x.npz"],
        ["--load-state", "x.npz"], ["--dump", "v.txt"], ["--profile", "d"],
    ],
)
def test_cli_not_ported_flags_exit_1(
    small_conf, capsys, tmp_path, monkeypatch, args
):
    """The flags of later slices exit 1 with "not ported"; --dump, ported
    since, writes the solution and exits 0."""
    monkeypatch.chdir(tmp_path)
    rc = cli.main([small_conf(), "--platform", "cpu", *args])
    if args[0] == "--dump":
        assert rc == 0 and (tmp_path / args[1]).is_file()
        assert f"Dumped solution to {args[1]}" in capsys.readouterr().out
        return
    assert rc == 1
    assert "not ported" in capsys.readouterr().err


@pytest.mark.parametrize("mode", [1, 2])
def test_cli_other_modes_exit_1(small_conf, capsys, mode):
    """Modes 1 and 2 exited 1 before they were ported; they run now, with
    the reference's mode line and progress lines."""
    assert cli.main([small_conf(mode=mode), "--platform", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[1] == ("Solving nonlinear problem" if mode == 1
                      else "Solving newton problem")
    word = "iter" if mode == 1 else "newton iter"
    first = "Inital residual: " if mode == 1 else "Inital newton residual: "
    assert out[2].startswith(first)
    assert len(out) > 3
    assert all(re.match(rf"^{word}: {i} residual: \S+ Took \d+ms", ln)
               for i, ln in enumerate(out[3:]))


def test_cli_errors(small_conf, capsys, monkeypatch):
    path = small_conf()
    assert cli.main([path, "--dtype", "float64"]) == 1
    assert "float64" in capsys.readouterr().err
    assert cli.main([path + ".missing"]) == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main([path]) == 1
    assert "no CUDA device" in capsys.readouterr().err
