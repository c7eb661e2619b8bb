"""The port's level hierarchy and RHS against the JAX package's
``build_grid``, and the carry-over of level fields between the two."""

import os

import numpy as np
import pytest
import torch

import gpusolve_tpu as gs
import gpusolve_tpu_torch as gt
from gpusolve_tpu_torch import interop
from gpusolve_tpu_torch.grid import linear_rhs

CONF = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "examples", "linear_127.conf",
)


def params_pair(mode, dims, dtype="float32"):
    kw = dict(grid_dim=dims, mode=mode, dtype=dtype, print_progress=False)
    return (
        gs.parse_config(CONF, backend="xla", **kw),
        gt.parse_config(CONF, **kw),
    )


def halo_zero(t):
    a = t.numpy()
    return (
        not a[0].any() and not a[-1].any() and not a[:, 0].any()
        and not a[:, -1].any() and not a[:, :, 0].any()
        and not a[:, :, -1].any()
    )


@pytest.mark.parametrize("mode", [gt.Mode.LINEAR, gt.Mode.NONLINEAR])
@pytest.mark.parametrize("dims", [(15, 15, 15), (31, 15, 63)])
def test_rhs_matches_jax(mode, dims):
    pj, pt = params_pair(mode, dims)
    want = np.asarray(gs.build_grid(pj).levels[0].f)
    state = gt.build_grid(pt, device="cpu")
    got = state.levels[0].f.numpy()
    assert got.shape == tuple(d + 2 for d in dims)
    want = interop.crop(want, dims)
    np.testing.assert_allclose(
        got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max()
    )


@pytest.mark.parametrize("mode", list(gt.Mode))
def test_levels_shapes_and_halos(mode):
    _, pt = params_pair(mode, (16, 16, 16))
    state = gt.build_grid(pt, device="cpu")
    assert len(state.levels) == pt.num_levels
    for d, lvl in zip(pt.level_dims(), state.levels):
        shape = tuple(n + 2 for n in d)
        for t in (lvl.v, lvl.f, lvl.r):
            assert tuple(t.shape) == shape and t.dtype == torch.float32
            assert t.is_contiguous() and halo_zero(t)
        assert (lvl.rest_v is not None) == (mode == gt.Mode.NONLINEAR)
        assert (lvl.newton_v is not None) == (mode == gt.Mode.NEWTON)
    assert (state.newton_f is not None) == (mode == gt.Mode.NEWTON)


def test_float64_rhs_is_host_formula():
    _, pt = params_pair(gt.Mode.LINEAR, (15, 15, 15), dtype="float64")
    f = gt.build_grid(pt, device="cpu").levels[0].f
    assert f.dtype == torch.float64
    np.testing.assert_array_equal(f.numpy(), linear_rhs((15, 15, 15), pt.h))


def test_interop_round_trip():
    pj, pt = params_pair(gt.Mode.LINEAR, (31, 15, 63))
    jstate = gs.build_grid(pj)
    rng = np.random.default_rng(0)
    fields = []
    for d, lvl in zip(pj.level_dims(), jstate.levels):
        v = np.zeros(lvl.v.shape, np.float32)
        v[1 : d[0] + 1, 1 : d[1] + 1, 1 : d[2] + 1] = rng.standard_normal(d)
        fields.append({"v": v, "f": np.asarray(lvl.f)})
    state = interop.state_from_numpy(pt, fields, device="cpu")
    for d, lvl in zip(pt.level_dims(), state.levels):
        assert tuple(lvl.v.shape) == tuple(n + 2 for n in d)
        assert halo_zero(lvl.v) and not lvl.r.any()
    back = interop.state_to_numpy(state, pt)
    for src, dst, lvl in zip(fields, back, jstate.levels):
        assert dst["v"].shape == lvl.v.shape
        np.testing.assert_array_equal(dst["v"], src["v"])
        np.testing.assert_array_equal(dst["f"], src["f"])


def test_interop_rejects_nonzero_padding():
    dims = (15, 15, 15)
    a = np.zeros(interop.jax_alloc_shape(dims), np.float32)
    a[dims[0] + 2, 0, 0] = 1.0
    with pytest.raises(ValueError, match="outside the padded region"):
        interop.crop(a, dims)
