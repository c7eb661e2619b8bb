"""The trapezoid leg's plain version (gpusolve_tpu_torch/ops/spmd_leg.py):

  * against the JAX package's leg kernel
    (gpusolve_tpu/ops/pallas_spmd.py::multi_sweep_block) in interpret mode,
    float32, on the middle block of a 3-block x split (and of a 3x3 x/y
    split for the y-split form) at block (16, 8, 128), the smallest shape
    its gates take.  The ghost slabs are cut from one seeded global field,
    as the exchange delivers them.  Compared over the box (the coarse box
    for the restriction), to atol 2e-5·max|JAX|; measured: at most 2.5e-7
    of max|JAX| (the JAX transfers run 3-pass bf16 dots, the port plain
    weighted sums).  The norm consumer is held against the port's own
    residual of the JAX leg's output (the JAX kernel leaves the two x-edge
    planes to a separate exchange);
  * against the per-op plain path (S × sweep_block_plain, then
    residual_restrict_block_plain with the engine's y restriction, lower-x
    fix-up, coarse mask and FAS tau), in float64 to 1e-12, at odd one-rank
    blocks and on a (2, 2, 1)-carved field whose slabs come from the
    neighbours' blocks, which must also equal the uncarved leg bit for
    bit.
"""

import functools
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gpusolve_tpu.config import GridParams as JParams
from gpusolve_tpu.config import Stencil as JStencil
from gpusolve_tpu.ops import pallas_spmd as ps

from gpusolve_tpu_torch.config import GridParams, Stencil
from gpusolve_tpu_torch.dist import make_mesh
from gpusolve_tpu_torch.dist import spmd as tsp
from gpusolve_tpu_torch.ops import spmd_kernels as sk
from gpusolve_tpu_torch.ops import spmd_leg as sl

ATOL = 2e-5
BX, BY = 16, 8
G = 8
NZ = 126


def _params(mode, dims, dtype="float32"):
    kw = dict(maxiter=1, tol=1e-5, grid_dim=dims, mode=mode,
              pre_smoothing=3, post_smoothing=3, omega=0.8,
              gamma=1.0 if mode else 0.0, dtype=dtype,
              print_progress=False)
    return (JParams(stencil=JStencil.poisson_7pt(), **kw),
            GridParams(stencil=Stencil.poisson_7pt(), **kw))


class Field:
    """A seeded global field over a 3 x my block mesh (my = 1: y unsplit),
    zero outside the grid's interior, and its blocks and slabs."""

    def __init__(self, dims, my, bz, seed, scale, coarse=False):
        rng = np.random.default_rng(seed)
        bx, by = (BX // 2, BY // 2) if coarse else (BX, BY)
        self.b = (bx, by, bz)
        self.my = my
        self.a = np.zeros((3 * bx, my * by, bz), np.float32)
        nx, ny, nz = dims
        self.a[1:nx + 1, 1:ny + 1, 1:nz + 1] = (
            rng.standard_normal((nx, ny, nz)).astype(np.float32) * scale
        )

    def _win(self, x0, y0, sx, sy):
        out = np.zeros((sx, sy, self.b[2]), np.float32)
        gx0, gy0 = max(x0, 0), max(y0, 0)
        gx1 = min(x0 + sx, self.a.shape[0])
        gy1 = min(y0 + sy, self.a.shape[1])
        if gx0 < gx1 and gy0 < gy1:
            out[gx0 - x0:gx1 - x0, gy0 - y0:gy1 - y0] = \
                self.a[gx0:gx1, gy0:gy1]
        return out

    def block(self, dx, dy):
        bx, by, _ = self.b
        return self._win(dx * bx, dy * by, bx, by)

    def slabs(self, dx, dy, g):
        """(xlo, xhi, ylo, yhi); y slabs None when y is unsplit."""
        bx, by, _ = self.b
        gy = g if self.my > 1 else 0
        x0, y0 = dx * bx, dy * by
        out = [self._win(x0 - g, y0 - gy, g, by + 2 * gy),
               self._win(x0 + bx, y0 - gy, g, by + 2 * gy)]
        if self.my > 1:
            out += [self._win(x0, y0 - g, bx, g),
                    self._win(x0, y0 + by, bx, g)]
        else:
            out += [None, None]
        return out


def _box(dims, dx, dy, b):
    out = []
    for ax, c in enumerate((dx, dy, 0)):
        start = c * b[ax]
        out += [max(0, 1 - start), min(b[ax] - 1, dims[ax] - start)]
    return tuple(out)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


# name -> (mode, y split, consumer, src_zero, corr)
CASES = {
    "linear_none": (0, False, None, False, False),
    "linear_norm": (0, False, "norm", False, False),
    "linear_restrict": (0, False, "restrict", False, False),
    "fas_restrict_tau": (1, False, "restrict", False, False),
    "newton_restrict": (2, False, "restrict", False, False),
    "linear_corr_norm": (0, False, "norm", False, True),
    "ysplit_restrict": (0, True, "restrict", False, False),
    "linear_src_zero_restrict": (0, False, "restrict", True, False),
}


def _jax_leg(jp, fields, dx, dy, bounds, S, zz, kw):
    """The JAX leg on block (dx, dy), its slabs in _slabs_multi's order."""
    v, f, nv, c = fields
    names = ([] if kw["src_zero"] else [v]) + [f] + \
        ([nv] if jp.mode == 2 else [])
    slabs = []
    for fl in names:
        s = fl.slabs(dx, dy, G)
        slabs += [jnp.asarray(a) for a in s if a is not None]
    extra = {}
    if kw["coarse"]:
        cs = [jnp.asarray(a) for a in c.slabs(dx, dy, G) if a is not None]
        extra = dict(coarse=(jnp.asarray(c.block(dx, dy)), *cs),
                     czp=kw["czp"], c_ny=kw["dims"][1], c_nz=kw["dims"][2])
    if kw["consumer"] == "restrict":
        cd = kw["cdims"]
        extra.update(czz=128, cnz=cd[2], r_cby=BY // 2, r_cny=cd[1])
        if jp.mode == 1:
            extra["tau_h"] = kw["hc"]
    return ps.multi_sweep_block(
        jnp.asarray(v.block(dx, dy)), jnp.asarray(f.block(dx, dy)),
        tuple(slabs), jnp.asarray(bounds), jp, kw["h"], zz, S,
        newton_v=jnp.asarray(nv.block(dx, dy)) if jp.mode == 2 else None,
        src_zero=kw["src_zero"], consumer=kw["consumer"], interpret=True,
        ghy=G if kw["ysplit"] else 0, **extra,
    )


@functools.lru_cache(maxsize=None)
def _case(name):
    """(JAX outputs, port outputs, geometry) of one case."""
    mode, ysplit, consumer, src_zero, corr = CASES[name]
    my = 3 if ysplit else 1
    ny = 23 if ysplit else BY - 3
    dims = (3 * BX - 1, ny, NZ)
    cdims = tuple(d // 2 for d in dims)
    bz = 256 if corr else 128
    jp, tp = _params(mode, dims)
    seed = 10 * list(CASES).index(name)
    fields = (Field(dims, my, bz, seed, 0.05),
              Field(dims, my, bz, seed + 1, 100.0),
              Field(dims, my, bz, seed + 2, 0.3),
              Field(cdims, my, bz // 2, seed + 3, 0.05, coarse=True))
    dy = 1 if ysplit else 0
    h, hc = tp.level_h(0), tp.level_h(1)
    S = 3
    kw = dict(src_zero=src_zero, coarse=corr, consumer=consumer, dims=dims,
              cdims=cdims, czp=128, h=h, hc=hc, ysplit=ysplit)

    def bounds(dx):
        b = _box(dims, dx, dy, (BX, BY, bz))
        return np.array([list(b) + [dx * BX, dims[0], dy * BY, dims[1],
                                    0, 0]], np.int32), b

    jb, box = bounds(1)
    jout = _jax_leg(jp, fields, 1, dy, jb, S, 128, kw)
    v, f, nv, c = fields
    slabs = {k: [_t(a) for a in fl.slabs(1, dy, sl.G)]
             for k, fl in zip(("v", "f", "nv"), (v, f, nv))}
    cbox = _box(cdims, 1, dy, (BX // 2, BY // 2, bz // 2))
    outs = [torch.zeros((BX, BY, bz))]
    cout = None
    if consumer == "restrict":
        cout = tuple(torch.zeros((BX // 2, BY // 2, bz // 2))
                     for _ in range(3 if mode == 1 else 1))
        outs += list(cout)
        cout = cout if mode == 1 else (cout[0], None, None)
    coarse = None
    if corr:
        coarse = (_t(c.block(1, dy)),
                  [_t(a) for a in c.slabs(1, dy, sl.GC)])
    part = sl.leg_block_plain(
        outs[0], _t(v.block(1, dy)), _t(f.block(1, dy)), slabs, box,
        (BX, dims[0], dy * BY, dims[1]), tp, h, S,
        newton_v=_t(nv.block(1, dy)), src_zero=src_zero, coarse=coarse,
        consumer=consumer, cout=cout, cbox=cbox, cdims=cdims, tau_h=hc,
    )
    ref_ss = None
    if consumer == "norm":
        # The port's residual of the JAX leg's output over the box, the
        # neighbours' post-sweep faces from their own JAX legs.
        vj = [np.asarray(_jax_leg(jp, fields, dx, dy, bounds(dx)[0], S, 128,
                                  kw)[0]) for dx in range(3)]
        faces = [_t(vj[0][-1]), _t(vj[2][0]), _t(np.zeros((BX, bz),
                                                           np.float32)),
                 _t(np.zeros((BX, bz), np.float32))]
        ref_ss = float(sk.residual_block_plain(
            None, _t(vj[1]), _t(f.block(1, dy)), faces, box, tp, h,
            write_r=False, with_norm=True, newton_v=_t(nv.block(1, dy)),
        ))
    return jout, outs, part, ref_ss, box, cbox


def _close(got, want, sl_, what):
    got = got.numpy()[sl_].astype(np.float64)
    want = np.asarray(want)[sl_].astype(np.float64)
    atol = ATOL * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
def test_leg_plain_matches_jax(name):
    mode, _, consumer, _, _ = CASES[name]
    jout, outs, part, ref_ss, box, cbox = _case(name)
    _close(outs[0], jout[0], sk.box_slices(box), f"{name} v")
    if consumer == "norm":
        assert float(part.sum()) == pytest.approx(ref_ss, rel=1e-5)
    if consumer == "restrict":
        x0, x1, y0, y1, z0, z1 = cbox
        csl = sk.box_slices(cbox)
        _close(outs[1], jout[1], csl, f"{name} coarse f")
        if mode == 1:
            _close(outs[2], jout[2], csl, f"{name} coarse v")
            assert torch.equal(outs[2], outs[3])


# ---------------------------------------------------------------------------
# Against the per-op plain path, float64
# ---------------------------------------------------------------------------


def _per_op(eng, l, lvl, S, consumer, fas):
    """The engine's per-op path of one leg on level l (per-op ops only):
    returns (v, coarse f, coarse v) or (v, norm)."""
    eng._sweeps(l, lvl, S)
    if consumer == "norm":
        p = eng._residual(0, None, lvl.v, lvl.f, lvl.newton_v,
                          write_r=False, with_norm=True)
        return lvl.v, float(p.sum())
    if consumer != "restrict":
        return lvl.v, None
    xzr, rlast, xzv = eng._xz_buffers(l)
    sk.residual_restrict_block_plain(
        xzr, rlast, xzv, lvl.v, lvl.f, eng.ex.faces(lvl.v), eng.boxes[l],
        eng.params, eng.hs[l], eng.plan.dims[l + 1][2], lvl.newton_v,
    )
    fc = eng._mask(l + 1, eng._y_restrict(eng._fix_x0(xzr, rlast), l + 1))
    rv = None
    if fas:
        rv = eng._mask(l + 1, eng._y_restrict(xzv, l + 1))
        eng._fas_tau(l + 1, fc, rv)
    return lvl.v, fc, rv


VARIANTS = {
    "none": {}, "norm": {"consumer": "norm"},
    "restrict": {"consumer": "restrict"},
    "zero_restrict": {"consumer": "restrict", "src_zero": True},
}


@pytest.mark.parametrize("dims", [(15, 15, 15), (33, 17, 9)],
                         ids=["15", "33x17x9"])
@pytest.mark.parametrize("mode", [0, 1, 2], ids=["linear", "fas", "newton"])
def test_leg_plain_matches_per_op(mode, dims):
    _, p = _params(mode, dims, "float64")
    mesh = make_mesh((1, 1, 1), device="cpu")
    eng = tsp.SpmdEngine(p, mesh, cutoff=2)
    rng = np.random.default_rng(40 + mode)
    fas = mode == 1
    for label, kw in VARIANTS.items():
        if fas and kw.get("src_zero"):
            continue
        st = eng.init_state()
        lvl, nxt = st.levels[0], st.levels[1]
        box = eng.boxes[0]
        s = sk.box_slices(box)
        for t, scale in ((lvl.v, 0.05), (lvl.f, 100.0), (lvl.newton_v, 0.3)):
            if t is not None:
                t[s] = torch.from_numpy(
                    rng.standard_normal(sk.box_dims(box)) * scale)
        if kw.get("src_zero"):
            lvl.v.zero_()
        v0 = lvl.v.clone()
        out = torch.zeros_like(v0)
        consumer = kw.get("consumer")
        cout = (torch.zeros_like(nxt.f),) + (
            (torch.zeros_like(nxt.f), torch.zeros_like(nxt.f)) if fas
            else (None, None))
        part = sl.leg_block_plain(
            out, v0, lvl.f, None, box, eng.globs[0], p, eng.hs[0], 3,
            newton_v=lvl.newton_v, consumer=consumer, cout=cout,
            cbox=eng.boxes[1], cdims=eng.plan.dims[1], tau_h=eng.hs[1],
            src_zero=kw.get("src_zero", False),
        )
        want = _per_op(eng, 0, lvl, 3, consumer, fas)
        tol = dict(rtol=0, atol=1e-12)
        scale = float(want[0].abs().max())
        torch.testing.assert_close(out, want[0], rtol=0, atol=1e-12 * scale)
        if consumer == "norm":
            assert float(part.sum()) == pytest.approx(want[1], rel=1e-12)
        if consumer == "restrict":
            sc = float(want[1].abs().max())
            torch.testing.assert_close(cout[0], want[1], rtol=0,
                                       atol=1e-12 * sc)
            if fas:
                torch.testing.assert_close(cout[1], want[2], **tol)


def _carve_field(alloc, dims, rng, scale):
    a = torch.zeros(alloc, dtype=torch.float64)
    a[1:dims[0] + 1, 1:dims[1] + 1, 1:dims[2] + 1] = torch.from_numpy(
        rng.standard_normal(dims) * scale)
    return a


@pytest.mark.parametrize("mode", [0, 1, 2], ids=["linear", "fas", "newton"])
def test_leg_carved_equals_whole(mode):
    """A 31³ field on the four blocks of a (2, 2, 1) plan: each block's
    leg with slabs cut from the field equals the same leg on the whole
    field, bit for bit, in every variant; the corr-first leg too."""
    dims = (31, 31, 31)
    _, p = _params(mode, dims, "float64")
    plan = tsp.SpmdPlan(p, (2, 2, 1), cutoff=2)
    rng = np.random.default_rng(50 + mode)
    (bx, by, bz), (cbx, cby, cbz) = plan.block[0], plan.block[1]
    gv, gf, gn = (_carve_field(plan.alloc[0], dims, rng, s)
                  for s in (0.05, 100.0, 0.3))
    gc = _carve_field(plan.alloc[1], plan.dims[1], rng, 0.05)
    wbox = (1, dims[0], 1, dims[1], 1, dims[2])
    cd = plan.dims[1]
    wcbox = (1, cd[0], 1, cd[1], 1, cd[2])
    fas = mode == 1
    variants = dict(VARIANTS, corr={"corr": True},
                    corr_norm={"corr": True, "consumer": "norm"})

    def run(v, f, nv, c, slabs, cslabs, box, glob, cbox, kw):
        kw = dict(kw)
        corr = kw.pop("corr", False)
        out = torch.zeros_like(v)
        couts = (torch.zeros_like(c),) + (
            (torch.zeros_like(c), torch.zeros_like(c)) if fas
            else (None, None))
        part = sl.leg_block_plain(
            out, v, f, slabs, box, glob, p, p.level_h(0), 3, newton_v=nv,
            coarse=(c, cslabs) if corr else None, cout=couts, cbox=cbox,
            cdims=cd, tau_h=p.level_h(1), **kw,
        )
        return [out] + [t for t in couts if t is not None], part

    def win(g, x0, y0, sx, sy):
        return tsp._window(g, (x0, y0, 0), (sx, sy, g.shape[2]))

    def slabs_of(g, dx, dy, b, d):
        x0, y0 = dx * b[0], dy * b[1]
        return (win(g, x0 - d, y0 - d, d, b[1] + 2 * d),
                win(g, x0 + b[0], y0 - d, d, b[1] + 2 * d),
                win(g, x0, y0 - d, b[0], d), win(g, x0, y0 + b[1], b[0], d))

    for label, kw in variants.items():
        if fas and kw.get("src_zero"):
            continue
        want, pw = run(gv, gf, gn, gc, None, None, wbox,
                       (0, dims[0], 0, dims[1]), wcbox, kw)
        got = [torch.zeros_like(t) for t in want]
        ss = 0.0
        for dx, dy in itertools.product(range(2), range(2)):
            blk = [win(g, dx * b[0], dy * b[1], b[0], b[1]) for g, b in
                   ((gv, (bx, by)), (gf, (bx, by)), (gn, (bx, by)),
                    (gc, (cbx, cby)))]
            slabs = {k: slabs_of(g, dx, dy, (bx, by), sl.G)
                     for k, g in (("v", gv), ("f", gf), ("nv", gn))}
            outs, part = run(
                *blk, slabs, slabs_of(gc, dx, dy, (cbx, cby), sl.GC),
                plan.box(0, (dx, dy, 0)), (dx * bx, dims[0], dy * by,
                                           dims[1]),
                plan.box(1, (dx, dy, 0)), kw)
            for i, o in enumerate(outs):
                b = (bx, by) if i == 0 else (cbx, cby)
                got[i][dx * b[0]:(dx + 1) * b[0],
                       dy * b[1]:(dy + 1) * b[1]] = o
            if part is not None:
                ss += float(part.sum())
        for g, w in zip(got, want):
            assert torch.equal(g, w), f"{label}: carved != whole"
        if pw is not None:
            assert ss == pytest.approx(float(pw.sum()), rel=1e-12)
