"""The port's CLI on the CPU: the reference's output lines in every mode,
the flags of the JAX CLI's single-device surface, --explain-backend's
engine lines, and --mesh: the spmd engine (per leg, or pod; --halo
rdma) and the gspmd engine (asked for, or the fallback where spmd cannot
run) on the one-rank mesh with the JAX CLI's lines, and a clear exit 1
for flags that do not go together and for a mesh larger than the
world."""

import os
import re

import numpy as np
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
    """The flags ported since they exited 1 run: --mesh 1,1,1 (the
    distributed engine on one rank), the refinement, a checkpoint written
    and resumed, the dump, a profiler trace."""
    monkeypatch.chdir(tmp_path)
    path = small_conf()
    if args[0] == "--load-state":
        assert cli.main([path, "--platform", "cpu", "--quiet",
                         "--save-state", args[1]]) == 0
        capsys.readouterr()
    rc = cli.main([path, "--platform", "cpu", *args])
    out, err = capsys.readouterr()
    assert rc == 0
    lines = out.splitlines()
    if args[0] == "--mesh":
        assert [ln for ln in lines if LINE.match(ln)]
        # --fuse auto takes the pod engine, silently, as the JAX CLI does.
        assert "per-leg" not in err
    elif args[0] == "--refine":
        res = [float(LINE.match(ln).group(2)) for ln in lines
               if LINE.match(ln)]
        initial = float(lines[2].split(": ")[1])
        assert res and res[-1] <= initial * 1e-5  # the config's tol
    elif args[0] == "--save-state":
        assert (tmp_path / args[1]).is_file()
        assert f"Saved state to {args[1]}" in lines
    elif args[0] == "--load-state":
        assert f"Resumed from {args[1]} (iteration 4)" in lines
        assert not any(ln.startswith("Inital") for ln in lines)
    elif args[0] == "--dump":
        assert (tmp_path / args[1]).is_file()
        assert f"Dumped solution to {args[1]}" in lines
    else:
        assert f"Wrote profiler trace to {args[1]}" in lines
        assert (tmp_path / args[1] / "trace.json").is_file()


def test_cli_explain_backend(small_conf, capsys, monkeypatch):
    """The engine line for the plain ops on the CPU, and, with the device
    gate opened for CPU tensors, the batch engine at V(3,3) and the v1
    kernel at V(6,6), with the JAX package's note for leaving the fast
    path."""
    path = small_conf()
    assert cli.main([path, "--platform", "cpu", "--quiet",
                     "--explain-backend"]) == 0
    err = capsys.readouterr().err
    assert "backend: single device: plain PyTorch ops" in err
    from gpusolve_tpu_torch.solver import vcycle as tvc

    monkeypatch.setattr(
        tvc, "_fused_capable",
        lambda p, device: p.backend != "ref" and p.dtype == "float32",
    )
    assert cli.main([path, "--platform", "cpu", "--quiet",
                     "--explain-backend"]) == 0
    err = capsys.readouterr().err
    assert "backend: single device: batch of CUDA kernels" in err
    assert "level visit: fused down and up legs" in err
    assert "note:" not in err
    toks = open(path).read().split()
    toks[6:8] = ["6", "6"]
    v66 = path + ".v66"
    with open(v66, "w") as f:
        f.write(" ".join(toks))
    assert cli.main([v66, "--platform", "cpu", "--explain-backend"]) == 0
    out, err = capsys.readouterr()
    assert "backend: single device: v1 whole-cycle kernel" in err
    assert ("note: running without the fused mega-kernel: pre/post "
            "smoothing 6/6 exceeds the per-leg sweep cap (5)") in err
    assert LINE.match(out.splitlines()[3])


def test_cli_refine_incompatible_flags(small_conf, capsys):
    path = small_conf()
    for extra in (["--dtype", "float64"], ["--save-state", "x.npz"]):
        assert cli.main([path, "--platform", "cpu", "--refine", *extra]) == 1
        assert "--refine is incompatible with" in capsys.readouterr().err


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
    """float64 is no longer refused (it runs the plain ops, and says so);
    a missing config and a missing CUDA device exit 1."""
    path = small_conf()
    assert cli.main([path, "--dtype", "float64", "--platform", "cpu",
                     "--explain-backend", "--quiet"]) == 0
    err = capsys.readouterr().err
    assert "backend: single device: plain PyTorch ops (float64;" in err
    assert cli.main([path + ".missing"]) == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main([path]) == 1
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("mode", [1])
def test_cli_mesh_lines_match_jax(small_conf, capsys, mode):
    """--mesh 1,1,1 --platform cpu prints the lines the JAX CLI prints
    with --mesh 1,1,1 --fuse leg, the same numbers to the printed digits
    in float64 (--validate's error too), and the per-level engine
    lines."""
    from gpusolve_tpu import cli as jax_cli

    path = small_conf(mode=mode, dims=(15, 15, 15))
    extra = ["--validate"] if mode else []
    assert cli.main([path, "--mesh", "1,1,1", "--platform", "cpu",
                     "--explain-backend", "--check-every", "2",
                     "--dtype", "float64", "--fuse", "leg", *extra]) == 0
    out, err = capsys.readouterr()
    assert "backend: dist-engine=spmd fuse=leg halo=ppermute" in err
    assert "backend: level 0: plain shard-local ops (float64)" in err
    # The JAX CLI in this process (the tests run JAX on the CPU
    # with float64 enabled).
    assert jax_cli.main([path, "--mesh", "1,1,1", "--fuse", "leg",
                         "--check-every", "2", "--dtype", "float64",
                         *extra]) == 0
    ref_out = capsys.readouterr().out
    num = re.compile(r"[-+]?\d+\.?\d*(?:e[-+]?\d+)?")

    def shape(text):
        lines = [re.sub(r"Took \d+ms.*", "", ln) for ln in text.splitlines()]
        return ([num.sub("#", ln) for ln in lines],
                [float(x) for ln in lines for x in num.findall(ln)])

    got, want = shape(out), shape(ref_out)
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("args,message", [
    (["--mesh", "1,1,1", "--dist-engine", "gspmd", "--load-state", "x.npz"],
     "does not exist"),
    (["--mesh", "1,1,1", "--refine", "--dtype", "float64"], "incompatible"),
    (["--mesh", "1,1,1", "--refine", "--save-state", "x.npz"],
     "incompatible"),
    (["--mesh", "1,1,1", "--load-state", "x.npz"], "does not exist"),
    (["--mesh", "2,2,1"], "torchrun"),
    (["--mesh", "2,2"], "invalid --mesh"),
])
def test_cli_mesh_exits_1(small_conf, capsys, args, message):
    assert cli.main([small_conf(), "--platform", "cpu", *args]) == 1
    assert message in capsys.readouterr().err


@pytest.mark.parametrize("args,rc,message", [
    (["--dist-engine", "gspmd"], 0,
     "note: the gspmd engine is the debugging/fallback path"),
    (["--mesh", "32,1,1"], 1, "torchrun --nproc-per-node 32"),
])
def test_cli_mesh_refusal_names_roadmap_item(small_conf, capsys, args, rc,
                                             message):
    """The two --mesh refusals that named the ROADMAP item of the gspmd
    engine now run it: asked for, it solves with the reference's note; as
    the reference's fallback where the spmd engine cannot run the mesh
    (a grid smaller than it), it says so and, on one process, asks for
    the processes the mesh needs."""
    assert cli.main([small_conf(), "--platform", "cpu", "--mesh", "1,1,1",
                     *args]) == rc
    err = capsys.readouterr().err
    assert message in err
    if rc:
        assert "note: using the gspmd engine (grid (15, 15, 15) too small " \
               "for mesh (32, 1, 1))" in err


def test_cli_gspmd_lines_match_jax(small_conf, capsys):
    """--mesh 1,1,1 --dist-engine gspmd prints the JAX CLI's lines with
    the same flags, the same numbers to the printed digits in float64,
    and says what its local compute is under --explain-backend."""
    from gpusolve_tpu import cli as jax_cli

    path = small_conf(mode=1, dims=(15, 15, 15), maxiter=3)
    flags = ["--mesh", "1,1,1", "--dist-engine", "gspmd", "--dtype",
             "float64", "--validate"]
    assert cli.main([path, "--platform", "cpu", "--explain-backend",
                     *flags]) == 0
    out, err = capsys.readouterr()
    assert "backend: dist-engine=gspmd (box fetches over " \
           "torch.distributed; local compute: plain ops (float64" in err
    assert "debugging/fallback path" in err
    assert jax_cli.main([path, *flags]) == 0
    ref_out = capsys.readouterr().out
    num = re.compile(r"[-+]?\d+\.?\d*(?:e[-+]?\d+)?")

    def shape(text):
        lines = [re.sub(r"Took \d+ms.*", "", ln) for ln in text.splitlines()]
        return ([num.sub("#", ln) for ln in lines],
                [float(x) for ln in lines for x in num.findall(ln)])

    got, want = shape(out), shape(ref_out)
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-9)


def test_cli_single_level_falls_back_to_gspmd(small_conf, capsys):
    """A single-level grid, which the spmd engine cannot run, takes the
    gspmd engine under --dist-engine auto with the reference's note, and
    runs: the progress lines, numbered, with a falling residual."""
    path = small_conf(mode=1, dims=(15, 15, 1), maxiter=3)
    assert cli.main([path, "--platform", "cpu", "--mesh", "1,1,1"]) == 0
    out, err = capsys.readouterr()
    assert "note: using the gspmd engine (single-level grid)" in err
    iters = [LINE.match(ln) for ln in out.splitlines() if LINE.match(ln)]
    assert [int(m.group(1)) for m in iters] == [0, 1, 2]
    res = [float(m.group(2)) for m in iters]
    assert all(b < a for a, b in zip(res, res[1:]))


def test_cli_mesh_fuse_pod(small_conf, capsys):
    """--fuse pod with --mesh runs the pod engine (it exited 1 as not
    ported): the progress lines, the pod depth and each pod level's
    (fused-down, fused-up) tags under --explain-backend."""
    path = small_conf(dims=(31, 31, 31), maxiter=2)
    assert cli.main([path, "--mesh", "1,1,1", "--platform", "cpu",
                     "--explain-backend", "--fuse", "pod"]) == 0
    out, err = capsys.readouterr()
    assert len([ln for ln in out.splitlines() if LINE.match(ln)]) == 2
    assert "backend: dist-engine=spmd fuse=pod halo=ppermute" in err
    assert "backend: pod depth 1" in err
    assert re.search(r"backend: level 0: .*\(fused-down, fused-up\)", err)


def test_cli_mesh_halo_rdma(small_conf, capsys):
    """--halo rdma with --mesh runs (it exited 1 as not ported): --fuse
    auto takes the per-leg engine with the reference's reason, and the
    progress lines are --fuse leg's, residual for residual."""
    path = small_conf(mode=1, dims=(31, 31, 31), maxiter=2)
    base = [path, "--mesh", "1,1,1", "--platform", "cpu",
            "--explain-backend"]
    assert cli.main([*base, "--halo", "rdma"]) == 0
    out, err = capsys.readouterr()
    assert ("backend: fuse=auto -> leg (--halo rdma is a per-leg engine "
            "feature)") in err
    assert "backend: dist-engine=spmd fuse=leg halo=rdma" in err
    assert "note: --halo rdma" not in err
    assert cli.main([*base, "--fuse", "leg"]) == 0
    want = capsys.readouterr().out

    def residuals(text):
        return [ln.split(" Took")[0] for ln in text.splitlines()
                if "residual" in ln]

    assert len(residuals(out)) == 3
    assert residuals(out) == residuals(want)


def test_cli_rdma_y_split_note(capsys):
    """Under a y split --halo rdma prints the reference's note: the
    two-stage exchange runs instead (plan.rdma_active False)."""
    import gpusolve_tpu_torch as gt
    from gpusolve_tpu_torch.dist import mesh as tmesh
    from gpusolve_tpu_torch.dist import spmd as tsp

    args = cli.build_argparser().parse_args(
        [CONF, "--halo", "rdma", "--fuse", "leg"])
    params = gt.parse_config(CONF, grid_dim=(31, 31, 31))
    for shape, noted in (((2, 2, 1), True), ((2, 1, 1), False)):
        mesh = tmesh.Mesh(shape, (0, 0, 0), 0, None, torch.device("cpu"))
        eng = tsp.SpmdEngine(params, mesh, halo="rdma")
        cli._spmd_notes(params, eng, args, lambda lines: None)
        err = capsys.readouterr().err
        assert ("note: --halo rdma carries x-face slabs only; the y-split "
                "two-stage ppermute exchange runs instead" in err) == noted


def test_cli_mesh_fused_tags(small_conf, capsys):
    """--explain-backend with --mesh --fuse leg prints each distributed
    level's (fused-down, fused-up) tags, as the JAX CLI does, and the gate
    that refused a leg: at 31³ on the one-rank mesh, levels 0 and 1 run
    both legs and the junction level 2 neither."""
    path = small_conf(dims=(31, 31, 31), maxiter=2)
    assert cli.main([path, "--mesh", "1,1,1", "--platform", "cpu",
                     "--explain-backend", "--fuse", "leg"]) == 0
    err = capsys.readouterr().err
    for l in (0, 1):
        assert re.search(rf"backend: level {l}: .*\(fused-down, fused-up\)",
                         err), err
    assert re.search(r"backend: level 2: .*; fused-down refused: the "
                     r"junction", err), err


def test_cli_mesh_edge_tap_stencil(tmp_path, capsys):
    """A stencil with a (1,1,0) tap runs on --mesh 1,1,1 (it exited 1):
    the plain ops over the assembled block, with a note."""
    toks = open(CONF).read().split()
    toks[0], toks[2:5] = "2", ["15", "15", "15"]
    # The offsets rows: x, y, z per tap; the second tap becomes (1,1,0).
    stencil = "\n".join([
        "6 -1 -1 -1 -1 -1 -1", "0 1 -1 0 0 0 0", "0 1 0 1 -1 0 0",
        "0 0 0 0 0 1 -1",
    ])
    path = tmp_path / "edge.conf"
    path.write_text(" ".join(toks[:10]) + "\n" + stencil + "\n")
    assert cli.main([str(path), "--mesh", "1,1,1", "--platform", "cpu",
                     "--explain-backend"]) == 0
    out, err = capsys.readouterr()
    assert "edge or corner taps" in err
    assert [ln for ln in out.splitlines() if LINE.match(ln)]
