"""The port's checkpoints (utils/checkpoint.py) on the CPU: a split run
resumes to the uninterrupted run's history, bit for bit on the plain ops,
in every mode; the file keeps the JAX package's keys and fingerprint; a
file the JAX package wrote resumes in the port; a file of another
configuration is refused.

Inputs are made with numpy from a seed; every comparison here is exact
(both sides run the port's plain ops, or copy the same numbers)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpusolve_tpu as gs
from gpusolve_tpu.utils import checkpoint as jckpt
from gpusolve_tpu_torch import config as tcfg
from gpusolve_tpu_torch import grid as tgrid
from gpusolve_tpu_torch import interop
from gpusolve_tpu_torch.config import Mode
from gpusolve_tpu_torch.solver import newton as tnewton
from gpusolve_tpu_torch.solver import vcycle as tvc
from gpusolve_tpu_torch.utils import checkpoint as tckpt


def params_pair(mode=0, dims=(15, 15, 15), **kw):
    base = dict(
        maxiter=6, tol=1e-12, grid_dim=dims, mode=mode, pre_smoothing=3,
        post_smoothing=3, omega=0.8, gamma=1.0, dtype="float32",
        print_progress=False,
    )
    base.update(kw)
    pj = gs.GridParams(
        stencil=gs.Stencil.poisson_7pt(), backend="xla", **base
    )
    pt = tcfg.GridParams(stencil=tcfg.Stencil.poisson_7pt(), **base)
    return pj, pt


def run(state, pt, **kw):
    fn = tnewton.newton_solve if pt.mode == Mode.NEWTON else tvc.solve
    return fn(state, pt, **kw)


def solution(state, pt):
    lvl = state.levels[0]
    return lvl.newton_v if pt.mode == Mode.NEWTON else lvl.v


@pytest.mark.parametrize("mode", list(Mode), ids=lambda m: m.name)
def test_split_run_resumes_bit_for_bit(tmp_path, mode):
    _, pt = params_pair(mode)
    full_state, full = run(tgrid.build_grid(pt, device="cpu"), pt)

    head_state, head = run(
        tgrid.build_grid(pt, device="cpu"), pt.replace(maxiter=2)
    )
    path = str(tmp_path / "ck.npz")
    tckpt.save_state(path, head_state, pt, iteration=len(head) - 1,
                     history=head)
    state, it0, hist0 = tckpt.load_state(path, pt, device="cpu")
    assert it0 == 2 and hist0 == head
    state, tail = run(state, pt.replace(maxiter=4), initial_residual=head[0])
    assert head + tail == full
    assert torch.equal(solution(state, pt), solution(full_state, pt))


def test_keys_shapes_and_fingerprint(tmp_path):
    pj, pt = params_pair(Mode.NEWTON)
    assert tckpt._fingerprint(pt) == jckpt._fingerprint(pj)
    state = tgrid.build_grid(pt, device="cpu")
    path = str(tmp_path / "ck.npz")
    tckpt.save_state(path, state, pt, iteration=0, history=[1.0])
    nlev = pt.num_levels
    with np.load(path) as z:
        want = {"__fingerprint__", "__iteration__", "__history__", "f_0",
                "newton_f"}
        want |= {f"v_{i}" for i in range(nlev)}
        want |= {f"newton_v_{i}" for i in range(nlev)}
        assert set(z.files) == want
        for i, d in enumerate(pt.level_dims()):
            assert z[f"v_{i}"].shape == tuple(n + 2 for n in d)


@pytest.mark.parametrize("mode", [Mode.LINEAR, Mode.NEWTON],
                         ids=lambda m: m.name)
def test_jax_checkpoint_resumes_in_port(tmp_path, mode):
    """A file the JAX package wrote, at its (8, 8, 128) allocation: the
    port loads the same fields and resumes exactly as from the same JAX
    fields carried across by interop."""
    pj, pt = params_pair(mode)
    jstate = gs.build_grid(pj)
    rng = np.random.default_rng(11)
    d = pj.grid_dim
    inner = (slice(1, d[0] + 1), slice(1, d[1] + 1), slice(1, d[2] + 1))
    fields = [{"v": np.array(lvl.v), "f": np.array(lvl.f)}
              for lvl in jstate.levels]
    fields[0]["v"][inner] = rng.standard_normal(d, np.float32) * 0.01
    if mode == Mode.NEWTON:
        for f, lvl in zip(fields, jstate.levels):
            f["newton_v"] = np.array(lvl.newton_v)
        fields[0]["newton_v"][inner] = (
            rng.standard_normal(d, np.float32) * 0.01
        )
    jstate = dataclasses.replace(jstate, levels=tuple(
        dataclasses.replace(lvl, **{k: jnp.asarray(a) for k, a in f.items()})
        for lvl, f in zip(jstate.levels, fields)
    ))
    path = str(tmp_path / "jax.npz")
    jckpt.save_state(path, jstate, pj, iteration=3, history=[9.0, 2.0, 1.0])

    state, it0, hist0 = tckpt.load_state(path, pt, device="cpu")
    assert it0 == 3 and hist0 == [9.0, 2.0, 1.0]
    for lvl, f, dims in zip(state.levels, fields, pt.level_dims()):
        np.testing.assert_array_equal(
            lvl.v.numpy(), interop.crop(f["v"], dims)
        )
    np.testing.assert_array_equal(
        state.levels[0].f.numpy(), interop.crop(fields[0]["f"], d)
    )
    nf = None if jstate.newton_f is None else np.asarray(jstate.newton_f)
    twin = interop.state_from_numpy(pt, fields, device="cpu", newton_f=nf)
    kw = dict(initial_residual=9.0)
    state, got = run(state, pt.replace(maxiter=3), **kw)
    twin, want = run(twin, pt.replace(maxiter=3), **kw)
    assert got == want and len(got) == 3
    assert torch.equal(solution(state, pt), solution(twin, pt))


def test_fingerprint_mismatch_raises(tmp_path):
    _, pt = params_pair()
    path = str(tmp_path / "ck.npz")
    tckpt.save_state(path, tgrid.build_grid(pt, device="cpu"), pt)
    with pytest.raises(ValueError, match="different problem"):
        tckpt.load_state(path, pt.replace(omega=0.7), device="cpu")
