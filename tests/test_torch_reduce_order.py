"""The finalize kernel's summation order (``kernels.finalize_slots_plain``),
the refusal of overlapping ``subtract`` operands, and the cached zero
``done`` flag, on the CPU.

``finalize_slots_plain`` reproduces the order the CUDA finalize kernel
sums the residual's float64 partials in (1024 slots, each in order, then a
halving tree); ``chip_smoke.py`` holds the kernel to it bit for bit on the
card.  Here it is held against ``math.fsum`` (rel 1e-14: positive terms,
at most 64 in a slot and 10 tree levels, so at most ~74 roundings of
1.1e-16 each) and, over the partials of a 15³ residual, against the square
of the JAX package's ``residual_norm`` in float64 (rel 1e-12: the two sum
in different orders)."""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gpusolve_tpu as gs
from gpusolve_tpu.grid import alloc_shape
from gpusolve_tpu.solver import vcycle as jvc
from gpusolve_tpu_torch import config as tcfg
from gpusolve_tpu_torch.ops import kernels, ref

# The residual kernel's tile (mg_device.cuh kBZ, kBY, kXCH): one float64
# partial a tile, tile (x, y, z) at index z + gz·(y + gy·x).
TILE = (8, 8, 32)


def residual_blocks(dims):
    return math.prod(-(-d // t) for d, t in zip(dims, TILE))


N_VALUES = [1, 1023, 1024, 1025, residual_blocks((127,) * 3),
            residual_blocks((511,) * 3)]
N_IDS = ["1", "1023", "1024", "1025", "127cubed", "511cubed"]


@pytest.mark.parametrize("n", N_VALUES, ids=N_IDS)
def test_finalize_slots_plain_matches_fsum(n):
    rng = np.random.default_rng(n)
    parts = rng.random(n) * 1e3
    got = kernels.finalize_slots_plain(torch.from_numpy(parts))
    assert got.dtype == torch.float64
    assert float(got) == pytest.approx(math.fsum(parts), rel=1e-14)
    again = kernels.finalize_slots_plain(torch.from_numpy(parts.copy()))
    assert torch.equal(got, again)


def tile_partials(r2, dims):
    """Σ r² of each residual tile, in the kernel's partials order."""
    grid = [-(-d // t) for d, t in zip(dims, TILE)]
    padded = torch.zeros([g * t for g, t in zip(grid, TILE)],
                         dtype=torch.float64)
    padded[:dims[0], :dims[1], :dims[2]] = r2
    tiles = padded.reshape(grid[0], TILE[0], grid[1], TILE[1], grid[2],
                           TILE[2])
    return tiles.sum(dim=(1, 3, 5)).reshape(-1)


def test_slot_order_of_residual_partials_matches_jax_norm():
    dims = (15, 15, 15)
    kw = dict(maxiter=1, tol=1e-5, grid_dim=dims, mode=0, pre_smoothing=3,
              post_smoothing=3, omega=0.8, gamma=1.0, dtype="float64",
              print_progress=False)
    pj = gs.GridParams(stencil=gs.Stencil.poisson_7pt(), backend="xla",
                       **kw)
    pt = tcfg.GridParams(stencil=tcfg.Stencil.poisson_7pt(), **kw)
    rng = np.random.default_rng(9)
    fields = []
    for scale in (0.5, 100.0):
        a = np.zeros(tuple(d + 2 for d in dims))
        a[1:-1, 1:-1, 1:-1] = rng.standard_normal(dims) * scale
        fields.append(a)
    v, f = fields

    def to_jax(a):
        full = np.zeros(alloc_shape(dims))
        full[:a.shape[0], :a.shape[1], :a.shape[2]] = a
        return jnp.asarray(full)

    state = gs.build_grid(pj)
    lvl = dataclasses.replace(state.levels[0], v=to_jax(v), f=to_jax(f))
    state = dataclasses.replace(state, levels=(lvl,) + state.levels[1:])
    _, norm = jvc.residual_norm(state, pj)

    r, _ = ref.residual(torch.from_numpy(v), torch.from_numpy(f), dims, pt,
                        pt.level_h(0))
    r_int = ref.interior(r, dims)
    parts = tile_partials(r_int * r_int, dims)
    assert parts.numel() == residual_blocks(dims)
    got = float(kernels.finalize_slots_plain(parts))
    assert got == pytest.approx(float(norm) ** 2, rel=1e-12)


@pytest.mark.parametrize("fn", [kernels.subtract, kernels.subtract_plain],
                         ids=["subtract", "subtract_plain"])
def test_subtract_refuses_overlapping_operands(fn):
    dims = (4, 4, 4)
    size = 6 ** 3
    buf = torch.from_numpy(
        np.random.default_rng(3).standard_normal(2 * size + 5)
        .astype(np.float32))
    v = buf[:size].view(6, 6, 6)
    for w in (buf[5:size + 5].view(6, 6, 6), v, buf[:size].view(6, 6, 6)):
        with pytest.raises(ValueError, match="share memory"):
            fn(v, w, dims)
    # Disjoint parts of one storage are two operands.
    w = buf[size:2 * size].view(6, 6, 6)
    want = v.clone()
    want[1:-1, 1:-1, 1:-1] -= w[1:-1, 1:-1, 1:-1]
    fn(v, w, dims)
    assert torch.equal(v, want)


def test_zero_done_flag_is_one_cached_zero():
    dev = torch.device("cpu")
    a = kernels._done_or_zero(None, dev)
    assert a is kernels._done_or_zero(None, dev)
    assert a.dtype == torch.int32 and a.shape == (1,) and int(a[0]) == 0
    own = torch.ones(1, dtype=torch.int32)
    assert kernels._done_or_zero(own, dev) is own
