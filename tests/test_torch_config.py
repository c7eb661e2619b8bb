"""The port's config module against the JAX package's: same fields from the
same files, same level hierarchy, same errors."""

import glob
import os

import pytest

from gpusolve_tpu import config as jcfg
from gpusolve_tpu_torch import config as tcfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(glob.glob(os.path.join(ROOT, "examples", "*.conf")))

FIELDS = ("maxiter", "tol", "grid_dim", "mode", "pre_smoothing",
          "post_smoothing", "omega", "gamma", "print_progress", "dtype",
          "backend", "cycle_type")


def test_examples_found():
    assert len(EXAMPLES) == 3


@pytest.mark.parametrize("path", EXAMPLES, ids=os.path.basename)
def test_examples_parse_equal(path):
    pj = jcfg.parse_config(path)
    pt = tcfg.parse_config(path)
    for name in FIELDS:
        assert getattr(pt, name) == getattr(pj, name), name
    assert int(pt.mode) == int(pj.mode)
    assert pt.stencil.values == pj.stencil.values
    assert pt.stencil.offsets == pj.stencil.offsets
    assert pt.h == pj.h and pt.num_levels == pj.num_levels


@pytest.mark.parametrize(
    "dims",
    [(15, 15, 15), (16, 16, 16), (31, 15, 63), (48, 48, 48), (511, 511, 511),
     (1, 5, 9)],
)
def test_level_hierarchy_equal(dims):
    pj = jcfg.parse_config(EXAMPLES[0], grid_dim=dims)
    pt = tcfg.parse_config(EXAMPLES[0], grid_dim=dims)
    assert pt.level_dims() == pj.level_dims()
    assert [pt.level_h(i) for i in range(pt.num_levels)] == [
        pj.level_h(i) for i in range(pj.num_levels)
    ]
    assert pt.properly_nested == pj.properly_nested


def _text(path):
    with open(path) as f:
        return f.read()


@pytest.mark.parametrize(
    "mutate",
    [
        lambda toks: toks[:20],  # truncated
        lambda toks: toks[:5] + ["9"] + toks[6:],  # mode 9
        lambda toks: toks[:17] + ["2"] + toks[18:],  # radius-2 x offset
    ],
    ids=["truncated", "mode9", "radius2"],
)
def test_errors_match(mutate):
    text = " ".join(mutate(_text(EXAMPLES[0]).split()))
    with pytest.raises(ValueError) as ej:
        jcfg.parse_config_text(text)
    with pytest.raises(ValueError) as et:
        tcfg.parse_config_text(text)
    assert str(et.value) == str(ej.value)


def test_backend_and_cycle_validated():
    p = tcfg.parse_config(EXAMPLES[0])
    for backend in tcfg.BACKENDS:
        assert p.replace(backend=backend).backend == backend
    with pytest.raises(ValueError, match="backend"):
        p.replace(backend="xla")
    with pytest.raises(ValueError, match="cycle_type"):
        p.replace(cycle_type="X")
