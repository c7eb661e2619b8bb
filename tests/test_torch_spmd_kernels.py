"""The plain versions of the distributed engine's four shard-local kernels
(gpusolve_tpu_torch/ops/spmd_kernels.py) against the JAX package's Pallas
kernels (gpusolve_tpu/ops/pallas_spmd.py) in interpret mode, called
directly on one block with explicit ghost faces and interior bounds, as
tests/test_spmd_pallas.py runs them.

The block is (16, 8, 128) of a (31, 15, 126) grid on a (2, 2, 1) data
mesh, the smallest geometry ``level_supported`` accepts: shard (0, 0)
sits on the lower x and y edges, shard (1, 1) reads ghosts on both lower
faces.  Inputs are seeded numpy values, zero outside each array's
interior cells (the engine's invariant); the Newton ũ is at scale 0.3.
float32, rtol 1e-5 with atol 1e-5·max|JAX| (the JAX transfers run
3-pass bf16 dots, the port plain sums: both round to float32).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gpusolve_tpu.config import GridParams as JParams
from gpusolve_tpu.config import Stencil as JStencil
from gpusolve_tpu.ops import pallas_spmd as ps

from gpusolve_tpu_torch.config import GridParams, Stencil
from gpusolve_tpu_torch.ops import spmd_kernels as sk

GRID = (31, 15, 126)
BLOCK = (16, 8, 128)
CBLOCK = (8, 4, 64)
RTOL = 1e-5
MODES = {"linear": (0, 0.0), "fas": (1, 1.0), "newton": (2, 1.0)}
SHARDS = {"edge": (0, 0), "inner": (1, 1)}


# Stencils whose taps are not the canonical 7-point order, as (values,
# offsets): the restriction kernel's generic-tap body on the card.
OTHER_TAPS = {
    "reordered": ((6.2, -1.1, -0.9, -1.05, -0.97, -1.0, -1.13),
                  ((0, 0, 0), (0, 0, -1), (0, 1, 0), (-1, 0, 0), (0, 0, 1),
                   (1, 0, 0), (0, -1, 0))),
    "five": ((4.0, -1.0, -1.0, -1.0, -1.0),
             ((0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0))),
}


def _params(mode, gamma, taps=None):
    kw = dict(maxiter=1, tol=1e-5, grid_dim=GRID, mode=mode,
              pre_smoothing=1, post_smoothing=1, omega=0.8, gamma=gamma,
              dtype="float32", print_progress=False)
    if taps is None:
        return (JParams(stencil=JStencil.poisson_7pt(), **kw),
                GridParams(stencil=Stencil.poisson_7pt(), **kw))
    return (JParams(stencil=JStencil(*OTHER_TAPS[taps]), **kw),
            GridParams(stencil=Stencil(*OTHER_TAPS[taps]), **kw))


def _box(shard, dims=GRID, block=BLOCK):
    out = []
    for ax, c in enumerate((*shard, 0)):
        start = c * block[ax]
        out += [max(0, 1 - start), min(block[ax] - 1, dims[ax] - start)]
    return tuple(out)


class Inputs:
    """Seeded block fields, zero outside the box; faces zero outside the
    box's rows and columns."""

    def __init__(self, shard, seed):
        rng = np.random.default_rng(seed)
        self.box = _box(shard)
        x0, x1, y0, y1, z0, z1 = self.box
        keep = np.zeros(BLOCK, dtype=bool)
        keep[x0:x1 + 1, y0:y1 + 1, z0:z1 + 1] = True

        def field(scale):
            a = rng.standard_normal(BLOCK, dtype=np.float32)
            return np.where(keep, a * np.float32(scale), np.float32(0))

        self.v, self.f, self.nv = field(0.05), field(100.0), field(0.3)
        xf = np.where(keep[0], 1.0, 0.0).astype(np.float32)
        yf = np.where(keep[:, 0], 1.0, 0.0).astype(np.float32)
        self.faces = [
            rng.standard_normal(m.shape, dtype=np.float32) * 0.05 * m
            for m in (xf, xf, yf, yf)
        ]
        self.bounds = np.array([list(self.box) + [0] * 6], dtype=np.int32)

    def jax(self):
        return (jnp.asarray(self.v), jnp.asarray(self.f),
                tuple(jnp.asarray(g) for g in self.faces),
                jnp.asarray(self.bounds), jnp.asarray(self.nv))

    def torch(self):
        t = torch.from_numpy
        return (t(self.v), t(self.f), [t(g) for g in self.faces],
                t(self.nv))


def close(got, want, what):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    atol = RTOL * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol, err_msg=what)


H = 1.0 / 16
ZZ = 128


def _seed(mode, shard):
    return 10 * list(MODES).index(mode) + list(SHARDS).index(shard)


@pytest.mark.parametrize("shard", SHARDS, ids=list(SHARDS))
@pytest.mark.parametrize("mode", MODES, ids=list(MODES))
def test_sweep_and_residual_block(mode, shard):
    jp, tp = _params(*MODES[mode])
    x = Inputs(SHARDS[shard], seed=_seed(mode, shard))
    jv, jf, jfaces, jb, jnv = x.jax()
    tv, tf, tfaces, tnv = x.torch()
    nvj = jnv if mode == "newton" else None
    nvt = tnv if mode == "newton" else None

    want = ps.sweep_block(jv, jf, jfaces, jb, jp, H, ZZ, newton_v=nvj,
                          interpret=True)
    got = torch.zeros(BLOCK)
    sk.sweep_block(got, tv, tf, tfaces, x.box, tp, H, newton_v=nvt)
    close(got, want, f"sweep_block {mode} {shard}")

    r_want, ss_want = ps.residual_block(
        jv, jf, jfaces, jb, jp, H, ZZ, newton_v=nvj, with_norm=True,
        interpret=True,
    )
    r_got = torch.zeros(BLOCK)
    parts = sk.residual_block(r_got, tv, tf, tfaces, x.box, tp, H,
                              with_norm=True, newton_v=nvt)
    close(r_got, r_want, f"residual_block {mode} {shard}")
    assert float(parts.sum()) == pytest.approx(float(ss_want), rel=RTOL)
    # The norm-only form writes no r and gives the same partials.
    parts2 = sk.residual_block(None, tv, tf, tfaces, x.box, tp, H,
                               write_r=False, with_norm=True, newton_v=nvt)
    assert torch.equal(parts, parts2)


def _check_residual_restrict(mode, shard, taps=None):
    jp, tp = _params(*MODES[mode], taps)
    x = Inputs(SHARDS[shard], seed=7 + _seed(mode, shard))
    jv, jf, jfaces, jb, jnv = x.jax()
    tv, tf, tfaces, tnv = x.torch()
    cnz = GRID[2] // 2
    xzr, rlast, xzv = ps.residual_restrict_block(
        jv, jf, jfaces, jb, jp, H, ZZ, ZZ, cnz,
        newton_v=jnv if mode == "newton" else None, interpret=True,
    )
    cshape = (BLOCK[0] // 2, BLOCK[1], ZZ)
    g_xzr, g_rlast = torch.zeros(cshape), torch.zeros(cshape[1:])
    g_xzv = torch.zeros(cshape) if mode == "fas" else None
    sk.residual_restrict_block(
        g_xzr, g_rlast, g_xzv, tv, tf, tfaces, x.box, tp, H, cnz,
        newton_v=tnv if mode == "newton" else None,
    )
    close(g_xzr, xzr, f"xzr {mode} {shard} {taps}")
    close(g_rlast, rlast, f"r_last_z {mode} {shard} {taps}")
    if mode == "fas":
        close(g_xzv, xzv, f"xzv {shard} {taps}")
    else:
        assert xzv is None


@pytest.mark.parametrize("shard", SHARDS, ids=list(SHARDS))
@pytest.mark.parametrize("mode", MODES, ids=list(MODES))
def test_residual_restrict_block(mode, shard):
    _check_residual_restrict(mode, shard)


# Other tap orders, on the shard that reads both lower ghost faces: the
# reordered stencil in FAS (the v restriction too), five taps in NEWTON.
@pytest.mark.parametrize("taps,mode", [("reordered", "fas"),
                                       ("five", "newton")])
def test_residual_restrict_block_taps(taps, mode):
    _check_residual_restrict(mode, "inner", taps)


@pytest.mark.parametrize("box,m0,m1,cnz,resident,want", [
    # The 511³ level-0 box of the one-rank plan: the longest walk.
    ((0, 510, 0, 510, 1, 511), 0, 255, 255, 792, 32),
    # Its level 1 (255³): six planes a block, 3520 blocks.
    ((0, 254, 0, 254, 1, 255), 0, 127, 127, 792, 6),
    # Level 2 and below: two planes, the shortest walk.
    ((0, 126, 0, 126, 1, 127), 0, 63, 63, 792, 2),
    ((0, 6, 0, 6, 1, 7), 0, 3, 3, 1, 2),
])
def test_restrict_chunk(box, m0, m1, cnz, resident, want):
    xc = sk.restrict_chunk(box, m0, m1, cnz, resident)
    assert xc == want
    tiles = -(-cnz // sk.RR_CZ) * -(-(box[3] - box[2] + 1) // sk.RR_ROWS)
    blocks = tiles * -(-(m1 - m0 + 1) // xc)
    # Four blocks a resident slot wherever the walk could be shortened.
    assert xc == 2 or blocks >= 4 * resident


@pytest.mark.parametrize("shard", SHARDS, ids=list(SHARDS))
def test_prolong_add_block(shard):
    x = Inputs(SHARDS[shard], seed=11)
    rng = np.random.default_rng(12)
    casm = rng.standard_normal(
        (CBLOCK[0] + 2, CBLOCK[1] + 2, ZZ), dtype=np.float32
    )
    # The JAX kernel takes the coarse block y-padded to 8 rows.
    casm_j = np.zeros((CBLOCK[0] + 2, 8, ZZ), dtype=np.float32)
    casm_j[:, :CBLOCK[1] + 2] = casm
    jv, _, _, jb, _ = x.jax()
    want = ps.prolong_add_block(jv, jnp.asarray(casm_j), jb, ZZ, ZZ,
                                GRID[2], interpret=True)
    got = torch.from_numpy(x.v.copy())
    sk.prolong_add_block(got, torch.from_numpy(casm), x.box)
    close(got, want, f"prolong_add_block {shard}")
