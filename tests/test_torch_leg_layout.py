"""The trapezoid leg's shared-memory layout, as the port's Python side
mirrors it (gpusolve_tpu_torch/ops/pod.py) from the CUDA body
(gpusolve_tpu_torch/ops/csrc/leg_device.cuh), on the CPU:

  * the mirrored constants (tile, slab depths, chain length, the block's
    shared-memory limit) equal the ones the CUDA sources define, read from
    the sources;
  * ``leg_smem_bytes`` gives the dynamic shared memory that
    ``mg_leg_grid`` reported on an H100 for the 511³ level-0 legs at
    S = 3, every mode and consumer;
  * every leg that runs (every mode, S in 1..5) fits one block, and the
    pod engine takes the 511³ one-rank plan at V(3,3), V(4,4) and
    V(5,4) (V(5,5) only for the corr-first leg's cap of 4 sweeps).

The kernels themselves run only on the card (chip_smoke.py).
"""

import os
import re

import pytest

import gpusolve_tpu_torch as gt
from gpusolve_tpu_torch.config import Mode
from gpusolve_tpu_torch.dist import pod as tpod
from gpusolve_tpu_torch.ops import pod, spmd_leg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "gpusolve_tpu_torch", "ops", "csrc")
CONF = os.path.join(ROOT, "examples", "linear_127.conf")


def _constants(name):
    with open(os.path.join(CSRC, name)) as fh:
        src = fh.read()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (k\w+) = (\d+);", src)}


def test_mirrored_constants_match_the_cuda_sources():
    leg = _constants("leg_device.cuh")
    assert (pod._TY, pod._TZ) == (leg["kTY"], leg["kTZ"])
    assert (spmd_leg.G, spmd_leg.GC) == (leg["kG"], leg["kGC"])
    assert spmd_leg.MAX_SWEEPS == leg["kMaxS"]
    assert pod.SMEM_MAX == leg["kSmemMax"]
    assert pod.MAX_LEGS == _constants("pod.cu")["kMaxPod"]


# mg_leg_grid's shared-memory bytes of the 511³ (1,1,1) plan's level-0
# legs at S = 3 (chip_smoke.py's "leg smem" lines, NVIDIA H100 80GB HBM3).
CARD_SMEM_S3 = {
    (Mode.LINEAR, None): 43472,
    (Mode.LINEAR, "norm"): 65280,
    (Mode.LINEAR, "restrict"): 87360,
    (Mode.NONLINEAR, None): 43472,
    (Mode.NONLINEAR, "norm"): 65280,
    (Mode.NONLINEAR, "restrict"): 106672,
    (Mode.NEWTON, None): 56848,
    (Mode.NEWTON, "norm"): 84480,
    (Mode.NEWTON, "restrict"): 109200,
}


@pytest.mark.parametrize("mode,consumer", sorted(
    CARD_SMEM_S3, key=lambda k: (int(k[0]), str(k[1]))))
def test_leg_smem_bytes_match_the_kernel(mode, consumer):
    assert pod.leg_smem_bytes(mode, consumer, 3) == \
        CARD_SMEM_S3[mode, consumer]


@pytest.mark.parametrize("mode", list(Mode))
def test_every_leg_fits_a_block(mode):
    for S in range(1, spmd_leg.MAX_SWEEPS + 1):
        down, up = pod.chain_smem_bytes(mode, S, S)
        assert max(down, up) <= pod.SMEM_MAX, (mode, S, down, up)


@pytest.mark.parametrize("sweeps", [(3, 3), (4, 4), (5, 4), (5, 5)])
@pytest.mark.parametrize("mode", list(Mode))
def test_pod_takes_the_511_plan(mode, sweeps):
    pre, post = sweeps
    params = gt.parse_config(CONF, grid_dim=(511, 511, 511),
                             pre_smoothing=pre, post_smoothing=post)
    plan = tpod.PodPlan(params.replace(mode=mode), (1, 1, 1), 1)
    if post > spmd_leg.MAX_CORR_SWEEPS:
        # The corr-first up leg takes 1..4 sweeps: V(5,5) is refused for
        # that alone, never for its shared memory.
        assert "corr-first leg takes" in plan.refusal()
    else:
        assert plan.refusal() is None
