#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (gpusolve_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):
  1. the card (nvidia-smi name and power limit), versions, kernel build
     (one nvcc per source, started together), and ptxas's registers and
     spills for every kernel instantiation;
  2. every CUDA kernel, in each mode it has (LINEAR, FAS, NEWTON with ũ
     random at scale 0.3), against its plain PyTorch version on CUDA
     tensors at 15³, 16³, (31,15,63), 127³ and the 511³ level-0 shape:
     fields to rtol 1e-5 with atol 1e-5·max|plain|, Σr² to rel 1e-5,
     each printed with whether it is bit-identical; a set ``done`` flag
     must leave every output untouched; subtract bit for bit against
     subtract_plain at those shapes, 255³ and two coarsest-level shapes,
     on aligned and on offset fields, with NaN halos whose bits v must
     keep; finalize bit for bit against finalize_slots_plain (its slot
     order) at n = 1, 1023, 1024, 1025, the 127³ and the 511³ partial
     counts, and its stop flag; the batched Newton loop's kernels
     (newton_zero, newton_update at NEWTON_SHAPES, aligned and offset,
     NaN halos, after 0/1/3/10 inner cycles in one or two buffers;
     newton_gate's seed and step, its inner threshold against numpy's
     float32 formula; finalize_dev_thr against finalize), bit for bit,
     with the outer flag clear and set.  Then the v1 whole-cycle kernel
     (``vcycle_fused``) against ``vcycle_fused_plain`` at 15³, 16³, 31³,
     (31,15,63), 47³ (its coarse tail from 5³), 127³ and 511³, V(3,3) and
     V(6,6), in the three modes (every field of every level and Σr², same
     tolerances), at 15³ and (33,17,9) also with the taps reordered and
     with five taps (the body that indexes the level table, the norm
     included), and one v1 cycle against one batch-engine cycle at 511³
     V(6,6);
  3. the main paths, each with the launch counters zeroed just before it
     and read just after; the counts must equal what the engine's
     schedule implies, and the same run on the plain ops (backend="ref")
     on the card must give the same history (V(3,3): rel 2e-4 while the
     residual is >= 1e-4·initial, a factor 1.5 nearer the float32 floor,
     a stop at most one cycle apart; V(6,6): identical):
       * examples/linear_127.conf at grid_dim 511³ (9 levels) through
         build_grid + solve(check_every=10), then W and F at 127³;
       * examples/nonlinear_127.conf (FAS) likewise at 511³, W and F at
         127³;
       * examples/newton_127.conf at 511³ through newton_solve
         (check_every=10: the batched outer loop, 2 host reads a solve;
         the plain run, the per-step loop, takes 3 outer steps and is
         compared on those); then the per-step loop on the kernels from
         the same state (the history and every level's v, f and newton_v
         bit for bit), the batched solve's synchronising calls under
         PyTorch's sync debug mode (its host reads, no more), and at 127³
         with tol 1e-3 the outer stop inside a batch (K = 10, V(3,3) and
         V(2,1)) and at a batch's end (K = the steps), each bit for bit
         against the per-step loop;
       * the three at 511³ V(6,6), where solve (and newton_solve's inner
         solve) runs the v1 kernel: one vcycle_fused launch per cycle and
         no per-op cycle launch;
  4. the CLI: the three example configs as they are (--validate on the
     nonlinear and Newton ones: the mode line, the progress lines, and a
     max-abs error against the analytic solution under 5e-4) with
     --explain-backend; a V(6,6) config (the v1 engine and its note);
     --save-state/--load-state resuming to the uninterrupted history;
     --refine at 127³ to tol 1e-10 (LINEAR and Newton); --dtype float64
     at 127³ on the card (the plain ops, no kernel launch); --profile;
  4b. dryrun.entry()'s cycle (63³ LINEAR V(3,3), its counts zeroed just
     before it) against the same cycle on the plain ops (histories_agree);
     the parity check (gpusolve_tpu_torch/scripts/parity.py) at 63³ and
     127³ in the three modes: the ref, batch, batch-perop, v1, spmd-leg,
     spmd-classic, spmd-rdma, pod and gspmd engines against the float64
     host solver (cpu_native, built with g++), one line a row with its
     margin, each under 1, pod-y recorded as skipped (it needs 2 ranks);
     --backend cpu-native on examples/linear_127.conf at 63³ (no kernel
     launch) against the batch engine's history;
  5. times at 511³ with CUDA events: device ms per LINEAR and FAS cycle
     over a 10-cycle batch and per Newton step of newton_solve (the
     per-step and the batched loop in turns, with host reads a solve,
     busy time and idle share, and the events over busy), a
     profiler breakdown by kernel for each, each kernel's time beside its
     bound (the bytes of kernel_bytes over the card's memory rate, or
     operations over its float32 rate), its plain
     version's time and a PyTorch library call computing the same
     function where there is one, each kernel and library call also by
     its device time (torch.profiler over the same calls: no host part,
     no launch gaps); finalize with a flag of its own, beside its launch
     floor (the flag set) and torch.sum; subtract beside its 80 % target
     and torch.sub; the batched Newton loop's kernels at 511³
     (newton_update beside add_, newton_zero beside zero_,
     finalize_dev_thr beside torch.sum, newton_gate); the card's row of
     utils/tuning.py and its measured stream ceiling
     (probe_ceiling_gbps(refresh=True): a copy of a padded 511³ field),
     on one line; the v1
     kernel's ms per cycle at V(3,3) and V(6,6) in the
     three modes beside the batch engine's at the same configuration,
     their bytes and bounds, each level-0 op inside it beside the per-op
     kernel of the same mode and function, its coarse tail on one block
     beside the same ops on the whole grid, the wall per cycle of a
     V(6,6) solve with its idle share, and the cost of one op and its
     grid barrier.

The batch engine's fused legs (ops/csrc/mg_legs.cu, down_leg / up_leg):
  2. each leg against its plain version in every mode at S = 1..5, at
     15³, (33,17,9), 63³ and 511³ (the two other stencils at the small
     shapes), done set and clear: fields bit for bit, the up leg's norm
     within 1 float32 ulp; FAS and NEWTON on subnormal operands and on
     quotients that are ties of the float32 grid (the exact walk, which
     the counter mg_leg_exact_walks must show) and on operands scaled by
     2^-70 (inside the fast division's range);
  3. each 511³ main path on the legs against the same solve on the
     per-op schedule (histories and every level's fields bit for bit);
  5. each level-0 leg beside its bound and the per-op kernels for the
     same work; every level's legs against its per-op visit, with the
     blocks on the exact walk; the V(3,3) cycle on the legs and on the
     per-op schedule in turns; the Newton step on both.
  ``python3 chip_smoke.py --legs`` runs only these (the solves in place
  of the main paths) and prints no contract line.

The distributed engine (dist/spmd.py) on the one-rank (1,1,1) mesh:
  1. the dynamic shared memory of each leg launch at 511³ (S = 3) and
     the blocks an SM holds of it, by shared memory and by the occupancy
     calculator; no leg_kernel instantiation (mode x consumer x slabs x
     tap order) and no rdma_kernel may spill;
  2. its four shard-local kernels (ops/spmd_kernels.py), in each mode,
     against their plain versions at the 511³ level-0 block (640³, the
     box 511³) and at small odd blocks whose boxes touch every face (same
     tolerances), residual_restrict_block also with the taps reordered
     and with five taps; then a 127³ field cut into the 4 blocks of a
     (2,2,1) plan, each run with faces carved from its neighbours
     (residual_restrict_block against its plain version on each block)
     and put back together, against the single-device kernels on the
     whole field.  The
     trapezoid leg (ops/spmd_leg.py) against leg_block_plain, bit for bit,
     in every mode and variant (no consumer, norm, restriction with the
     FAS tau, from v = 0, corr-first) at the 511³ block and at the
     one-rank blocks of 15³ and (33,17,9) grids (the last also with the
     stencil's taps reordered: the kernel's generic tap path), and
     against 3 launches of sweep_block; then a 127³ field carved into the blocks of (2,1,1) and
     (2,2,1) plans, each leg with slabs cut from the field, against the
     same leg on the whole field;
  3. solve_spmd (LINEAR and FAS V(3,3), check_every=10) and
     newton_solve_spmd at 511³, on the legs: every level below the
     junction fused both ways, no per-op down-leg glue, launch counts
     equal to the engine's schedule (dist/spmd.launches_per_cycle), the
     same history on the plain ops on the card, the per-op path
     (local_backend="xla") and the single-device batch engine within rel
     2e-4 above 1e-2·initial; at V(6,6), past the legs' sweep cap, the
     per-op kernels with their counts, against the same run on the plain
     ops within rel 2e-4 above 1e-4·initial and against the v1 engine
     above 1e-2·initial (FAS 1e-1·initial);
  4. the CLI with --mesh 1,1,1 on the three example configs, with --fuse
     leg and as they are (--fuse auto resolves to the pod engine), and a
     mesh larger than the world (exit 1);
  5. each shard-local kernel's time, bound, plain and library time at the
     511³ level-0 block, and each leg variant's (event and device ms,
     the launch alone), the level-0 down leg's slab-reading
     instantiation beside the slab-free one; device ms per 511³ spmd
     cycle beside the batch engine's, a profiler split into the
     shard-local kernels, the replicated levels' kernels and the torch
     glue (launches a cycle), the idle share and peak memory, at V(3,3)
     (the legs) and, LINEAR and FAS, at V(6,6) (the per-op kernels, the
     down step residual_restrict_block).

The pod engine (dist/pod.py, fuse="pod") on the (1,1,1) mesh:
  2. pod_down and pod_up (ops/pod.py, csrc/pod.cu: every leg of a
     direction in one cooperative launch) against their plain versions
     and against the same legs launched one by one through leg_block, bit
     for bit, every field of the pod levels and the norm, in every mode, at
     511³ (the one-rank plan, npod = 1, and a three-level chain) and at 15³
     and (33,17,9) (depths 1 and 2), with each chain's cooperative grid;
  3. solve_spmd(fuse="pod") (LINEAR and FAS V(3,3), check_every=10) and
     newton_solve_spmd(fuse="pod") at 511³: depth 1, the tail in place,
     launch counts equal to dist/pod.launches_per_cycle's schedule (one
     pod_down and one pod_up a V-cycle), the same history on the plain ops
     on the card, the per-leg and batch engines within rel 2e-4 above
     1e-2·initial; W and F at 127³ against the plain ops;
  5. each chain's ms, bytes, bound, plain ms and the same legs' ms as
     separate launches, at npod = 1 and 3; device ms per pod cycle (npod 1
     and 3) beside the per-leg and batch engines', with the profiler split
     (pod chains, tail kernels, torch glue and its launches a cycle), the
     idle share and peak memory.

The per-leg engine's replicated tail (dist/spmd.py, tail="auto", its
default on the card; the per-leg lines above run the classic plan,
tail="off"):
  2. the junction legs through the engine's own code (the down leg into
     the tail root, FAS with R(v) and the tau fold, and the up leg from
     it, FAS after the subtract kernel in place, with the norm) against
     an engine on the plain versions, bit for bit, every mode, at 15³,
     (33,17,9) and 511³ (the 514³ block into the 257³ root, in place);
  3. solve_spmd / newton_solve_spmd at 511³ V(3,3): the depth (1), the
     blocks, the fused levels, launch counts equal to launches_per_cycle's
     schedule (the junction legs, one batch-engine cycle of the tail a
     visit, the finalize), no per-op down-leg glue, the same history on
     the plain ops on the card, the classic plan's, the batch engine's and
     the pod engine's within rel 2e-4 above 1e-2·initial;
  4. a checkpoint round trip through the tail plan at 63³ in every mode
     (save_state_spmd, load_state_spmd: the resumed history bit for bit),
     --mesh 1,1,1 --fuse leg --save-state / --load-state on the CLI, and
     --mesh 1,1,1 --refine;
  5. device ms per 511³ LINEAR and FAS cycle beside the classic plan and
     the pod engine in the same call, the profiler split into the
     junction legs, the tail's kernels and the torch glue, the idle share
     and peak memory.

The rdma exchange (ops/rdma.py, csrc/rdma_exchange.cu; halo="rdma" on
the per-leg engine):
  2. (a) rdma_exchange on the one-rank mesh against its plain version, bit
     for bit (the zero fill, the receive buffers NaN before), at the 511³
     plan's 640³ level-0 block (3 fields, G = 8) and 320³ level-1 block
     (1 field, GC = 5), with its ms, bytes, bound, plain ms and the
     library's (one zero_() a slab), both blocks by device time; (b) 2 and 4 processes spawned on the
     one card (a gloo group over a FileStore carries the CUDA IPC handles
     and the barriers), each rank one shard of the (m,1,1) plan's 511³
     level-0 blocks and of odd (9,5,7) blocks: 50 exchanges with new
     contents each, every slab bit-identical to the plain version over the
     same group on CPU copies of the planes it reads; then each rank's
     kernel and library (copy_ into the IPC-opened peer buffers, zero_ at
     an edge) times, CUDA events taken while the card time-slices the
     ranks' contexts, and the wrapper's wall time with its host barriers;
  3. (c) solve_spmd / newton_solve_spmd with halo="rdma" at 511³ V(3,3)
     on the (1,1,1) mesh, all three modes: plan.rdma_active, counts equal
     to launches_per_cycle (one rdma_exchange a leg, two a corr-first
     leg), histories bit-identical to halo="ppermute" in the same call;
  4. (d) --mesh 1,1,1 --halo rdma on the three examples: --fuse auto ->
     leg with the reference's reason, the --fuse leg run's residuals;
  5. device ms per 511³ cycle with halo="rdma" beside halo="ppermute".

The GSPMD engine (dist/sharding.py, dist/gspmd.py; ``shardings=`` on
solve and newton_solve) on the (1,1,1) mesh:
  2. a 127³ level and its 63³ coarse level cut into the (2,2,1) boxes of
     the engine's split and box functions, each box windowed from the
     whole fields with its neighbours' points as ghosts and run through
     the per-op kernels (the sweep and the residual in every mode, FAS's
     operator, restrict_zero, restrict, prolong_add), put back together:
     bit for bit the kernels on the whole fields;
  3. solve (LINEAR and FAS V(3,3)) and newton_solve (3 steps) at 511³
     with shardings=level_shardings(...): launch counts equal to the
     per-op schedule's for the executed cycles (one cycle a host read),
     no kernel's plain version on a CUDA tensor, and the history and
     every level's fields bit for bit the single-device per-op
     schedule's;
  4. --mesh 1,1,1 --dist-engine gspmd on the three examples (--validate),
     with --refine, and a single-level grid (127,127,1) under
     --dist-engine auto (the reference's note, then the run);
  5. ms a 511³ cycle (LINEAR, FAS) and a Newton step on it beside the
     per-op schedule and the legs, in turns: CUDA events, busy, idle
     share, launches a cycle, peak memory.
  ``python3 chip_smoke.py --gspmd`` runs only these and prints no
  contract line.

The pod chains' in-kernel exchange between ranks (ops/pod.py
ChainPeers, the multi-rank instantiations of csrc/pod.cu), on 2 and 4
processes spawned on the card (a gloo group over a FileStore; the
engines' other traffic through host copies):
  1. no multi-rank chain instantiation may spill;
  2. on (2,1,1), (4,1,1) and (2,2,1): pod_down / pod_up in every mode at
     511³ (choose_npod's depth and depth 1), 15³ and (33,17,9), 20
     launches each with new contents, every field and the boundary block
     bit for bit their plain versions over the same group on the card
     (the first launch also the legs one by one through leg_block with
     the host exchange, and its norm; at 15³ and (33,17,9) also the
     plain chains on CPU copies over the group, LINEAR bit for bit, FAS
     and NEWTON within RTOL); the waits per exchange step and the launch
     times, labelled time-sliced;
  3. on (2,1,1) and (2,2,1): solve_spmd (LINEAR, FAS V(3,3), 5 cycles)
     and newton_solve_spmd (2 steps) with fuse="pod" at 511³: launch
     counts equal to the schedule (one pod_down_ranks and one
     pod_up_ranks a V-cycle), no host slab exchange and no rdma_exchange,
     the history equal to the plain ops' on the card and within rel 2e-4
     of the per-leg engine on the same ranks and of the single-device
     batch engine; ms a cycle per rank, time-sliced;
  4. a wait past its limit (1 s, rank 0 launching alone) fails the
     launch with the wrapper's RuntimeError naming the chain and rank.
  ``python3 chip_smoke.py --pod-ranks`` runs only these and prints no
  contract line; ``--pod-cycle`` times the one-rank 511³ pod cycle
  (copied into another tree, it times that tree's).

At the end the zero done flag the wrappers lend launches given none
must still read 0.  The line before the last is the JSON object
{"kernels": [...]}, each kernel with its event ms and its device_ms (and
library_ms, library_device_ms); the last line is {"ok": true, "device":
{...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CONFS = {
    mode: os.path.join(HERE, "examples", f"{mode}_127.conf")
    for mode in ("linear", "nonlinear", "newton")
}
SRC = "gpusolve_tpu_torch/ops/csrc/multigrid.cu"
V1_SRC = "gpusolve_tpu_torch/ops/csrc/vcycle_fused.cu"
SPMD_SRC = "gpusolve_tpu_torch/ops/csrc/spmd_block.cu"
LEG_SRC = "gpusolve_tpu_torch/ops/csrc/spmd_leg.cu"
LEGS_SRC = "gpusolve_tpu_torch/ops/csrc/mg_legs.cu"
POD_SRC = "gpusolve_tpu_torch/ops/csrc/pod.cu"
RDMA_SRC = "gpusolve_tpu_torch/ops/csrc/rdma_exchange.cu"
SHAPES = [(15, 15, 15), (16, 16, 16), (31, 15, 63), (127, 127, 127),
          (511, 511, 511)]
V1_SHAPES = [(15, 15, 15), (16, 16, 16), (31, 31, 31), (31, 15, 63),
             (47, 47, 47), (127, 127, 127), (511, 511, 511)]
V1_SWEEPS = [(3, 3), (6, 6)]
# Stencils whose taps are not the canonical 7-point order, as (values,
# offsets): the v1 kernel and the leg run them through their generic-tap
# code.
OTHER_TAPS = {
    "reordered": ((6.2, -1.1, -0.9, -1.05, -0.97, -1.0, -1.13),
                  ((0, 0, 0), (0, 0, -1), (0, 1, 0), (-1, 0, 0), (0, 0, 1),
                   (1, 0, 0), (0, -1, 0))),
    "five": ((4.0, -1.0, -1.0, -1.0, -1.0),
             ((0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0))),
}
BIG = (511, 511, 511)
RTOL = 1e-5
DEVICE = "cuda"
NEWTON_PLAIN_STEPS = 3

# The TPU kernel each CUDA kernel replaces (builder line of the Pallas
# kernel, or of the part of _vcycle2_call it stands for).
REPLACES = {
    "residual": "gpusolve_tpu/ops/pallas_kernels.py:292",
    "residual_fas": "gpusolve_tpu/ops/pallas_kernels.py:292",
    "residual_newton": "gpusolve_tpu/ops/pallas_kernels.py:292",
    "finalize": "gpusolve_tpu/ops/pallas_vcycle2.py:1370",
    "jacobi_sweep": "gpusolve_tpu/ops/pallas_vcycle2.py:421",
    "jacobi_sweep_fas": "gpusolve_tpu/ops/pallas_kernels.py:172",
    "jacobi_sweep_newton": "gpusolve_tpu/ops/pallas_vcycle2.py:432",
    "restrict_zero": "gpusolve_tpu/ops/pallas_vcycle2.py:484",
    "restrict": "gpusolve_tpu/ops/pallas_kernels.py:526",
    "prolong_add": "gpusolve_tpu/ops/pallas_vcycle2.py:499",
    "apply_fas": "gpusolve_tpu/ops/pallas_vcycle2.py:1338",
    "subtract": "gpusolve_tpu/ops/pallas_vcycle2.py:527",
    # The batched Newton loop: the whole-batch kernel's norm with the
    # threshold operand batch_call takes on the device, and the XLA glue
    # around that kernel in _newton_batch (gpusolve_tpu/solver/newton.py:
    # 69, 89, 176-179, 194-199), counted with row 6.
    "finalize_dev_thr": "gpusolve_tpu/ops/pallas_vcycle2.py:1370",
    "newton_zero": "gpusolve_tpu/ops/pallas_vcycle2.py:280",
    "newton_update": "gpusolve_tpu/ops/pallas_vcycle2.py:280",
    "newton_gate": "gpusolve_tpu/ops/pallas_vcycle2.py:280",
    "vcycle_fused": "gpusolve_tpu/ops/pallas_vcycle.py:112",
    "sweep_block": "gpusolve_tpu/ops/pallas_spmd.py:284",
    "sweep_block_fas": "gpusolve_tpu/ops/pallas_spmd.py:284",
    "sweep_block_newton": "gpusolve_tpu/ops/pallas_spmd.py:284",
    "residual_block": "gpusolve_tpu/ops/pallas_spmd.py:370",
    "residual_block_fas": "gpusolve_tpu/ops/pallas_spmd.py:370",
    "residual_block_newton": "gpusolve_tpu/ops/pallas_spmd.py:370",
    "residual_restrict_block": "gpusolve_tpu/ops/pallas_spmd.py:628",
    "residual_restrict_block_fas": "gpusolve_tpu/ops/pallas_spmd.py:628",
    "residual_restrict_block_newton": "gpusolve_tpu/ops/pallas_spmd.py:628",
    "prolong_add_block": "gpusolve_tpu/ops/pallas_spmd.py:850",
    "leg_block": "gpusolve_tpu/ops/pallas_spmd.py:1847",
    "leg_block_fas": "gpusolve_tpu/ops/pallas_spmd.py:1847",
    "leg_block_newton": "gpusolve_tpu/ops/pallas_spmd.py:1847",
    "pod_down": "gpusolve_tpu/ops/pallas_pod.py:494",
    "pod_down_fas": "gpusolve_tpu/ops/pallas_pod.py:494",
    "pod_down_newton": "gpusolve_tpu/ops/pallas_pod.py:494",
    "pod_up": "gpusolve_tpu/ops/pallas_pod.py:741",
    "pod_up_fas": "gpusolve_tpu/ops/pallas_pod.py:741",
    "pod_up_newton": "gpusolve_tpu/ops/pallas_pod.py:741",
    # The multi-rank chains: the same TPU kernels, their in-kernel
    # exchange (_emit_barrier / _emit_exchange) in the launch.
    "pod_down_ranks": "gpusolve_tpu/ops/pallas_pod.py:494",
    "pod_down_ranks_fas": "gpusolve_tpu/ops/pallas_pod.py:494",
    "pod_down_ranks_newton": "gpusolve_tpu/ops/pallas_pod.py:494",
    "pod_up_ranks": "gpusolve_tpu/ops/pallas_pod.py:741",
    "pod_up_ranks_fas": "gpusolve_tpu/ops/pallas_pod.py:741",
    "pod_up_ranks_newton": "gpusolve_tpu/ops/pallas_pod.py:741",
    "rdma_exchange": "gpusolve_tpu/ops/pallas_spmd.py:1919",
    # The batch engine's fused legs: _vcycle2_call's streamed pass a leg
    # (stream_pass; the up leg's prolongation is prolong_yz, :499).
    "down_leg": "gpusolve_tpu/ops/pallas_vcycle2.py:517",
    "down_leg_fas": "gpusolve_tpu/ops/pallas_vcycle2.py:517",
    "down_leg_newton": "gpusolve_tpu/ops/pallas_vcycle2.py:517",
    "up_leg": "gpusolve_tpu/ops/pallas_vcycle2.py:517",
    "up_leg_fas": "gpusolve_tpu/ops/pallas_vcycle2.py:517",
    "up_leg_newton": "gpusolve_tpu/ops/pallas_vcycle2.py:517",
}
F32_PEAK = 67e12  # H100 SXM float32 outside the tensor cores, FLOP/s
# Operations counted for one e^x (a range reduction, a polynomial and a
# scale); the bound of every kernel here is bytes all the same.
EXP_OPS = 8


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def mem_rate(name: str) -> float:
    """Published device-memory rate of the card, bytes/s: its row of the
    port's table (utils/tuning.py), which must have one."""
    from gpusolve_tpu_torch.utils import tuning

    check(tuning.known_kind(name), f"no memory rate on record for {name!r}")
    return tuning.for_kind(name).peak_hbm_gbps * 1e9


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device ms of ``fn`` over ``reps`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


# Tiny kernels (torch.cuda._sleep's spin_kernel) launched at each end of
# a profiler window.  On the card the profiler withheld the last device
# events of a window, more in each later window of a process; the fillers
# take their place, and device_events leaves them out.
FILLER_LAUNCHES = 256


class Traced:
    """torch.profiler over the host and the card, its window opened and
    closed by FILLER_LAUNCHES filler kernels; ``as`` gives the profile."""

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._fill()
        return self.prof

    def __exit__(self, *exc):
        self._fill()
        return self.prof.__exit__(*exc)

    @staticmethod
    def _fill():
        import torch

        torch.cuda.synchronize()
        for _ in range(FILLER_LAUNCHES):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()


def device_ms(fn, reps: int = 20):
    """Mean device ms of one call of ``fn``: the device time of every
    kernel and copy that ``reps`` back-to-back calls launched, from
    torch.profiler (device_events), over ``reps``.  Unlike cuda_ms it
    leaves out the host's part of the call and the gaps between launches.
    A window whose event count is not a multiple of ``reps`` lost some
    (its events are printed) and is taken again, up to 5 times; then None
    (not measured), as when the profiler records no device event."""
    import torch

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with Traced() as prof:
            for _ in range(reps):
                fn()
        events = list(device_events(prof))
        total = sum(us for _, us in events)
        count = sum(ev.count for ev, _ in events)
        if total > 0 and count % reps == 0:
            return total / 1e3 / reps
        print(f"profiler: {count} device events for {reps} calls "
              f"({', '.join(f'{ev.count} {ev.key[:50]}' for ev, _ in events)}"
              f"); taking the window again")
    return None


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def fmt_us(us):
    return "not measured" if us is None else f"{us:.1f} us"


def padded(dims):
    return (dims[0] + 2) * (dims[1] + 2) * (dims[2] + 2)


def inner(dims):
    return dims[0] * dims[1] * dims[2]


def kernel_bytes(name, dims, cdims=None, outputs=2):
    """Bytes one launch must move at level ``dims`` (coarse ``cdims``):
    each input read once, each output written once.  A field counts at its
    padded size only where the kernel reads its halo (the stencil's v;
    prolong_add's coarse v); reads of the interior only, and every write,
    count the interior.  The restriction reads fine points 2c−1..2c+1 of
    each coarse c (on 2^k−1 grids the fine interior) and writes
    ``outputs`` coarse fields (restrict_zero: f and the zeroed v).
    apply_fas and subtract run on their own level, ``dims``."""
    n, pad = inner(dims), padded(dims)
    if name.startswith(("residual", "jacobi_sweep")):
        fields = 3 if name.endswith("_newton") else 2  # f, r or v out; ũ
        return 4 * (pad + fields * n)
    if name.startswith("restrict"):
        box = math.prod(2 * c + 1 for c in cdims)
        return 4 * (box + outputs * inner(cdims))
    if name == "prolong_add":
        return 4 * (padded(cdims) + 2 * n)
    if name == "apply_fas":
        return 4 * (pad + 2 * n)  # v with halo; out read and written
    if name == "subtract":
        return 4 * 3 * n
    raise ValueError(name)


# ---------------------------------------------------------------------------
# Phase 1: ptxas
# ---------------------------------------------------------------------------


def print_ptxas(log, checked=True):
    """One line per kernel instantiation: registers and spills.  The
    LINEAR per-op instantiations, the leg, the rdma kernel, every
    instantiation of the v1 kernel and of residual_restrict_kernel and the
    multi-rank pod chains must not spill (``checked``: a tree's own
    kernels; another tree's are only printed)."""
    def short(mangled):
        k = re.search(r"\d+([A-Za-z_]+_kernel|tile_call|exchange_step|"
                      r"neighbour_wait)(I(?:L[ib]\d+E)+E)?", mangled)
        args = re.findall(r"L[ib](\d+)E", k.group(2) or "") if k else []
        return (k.group(1) + (f"<{','.join(args)}>" if args else "")
                if k else mangled)

    name = prop = None
    spills = {}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = short(m.group(1))
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            prop = short(m.group(1))
            continue
        if prop and "spill" in line:
            spills[prop] = line.strip()
            if prop != name:  # a device function the kernels call
                print(f"ptxas: function {prop}: {spills[prop]}")
            prop = None
            continue
        if name and "registers" in line:
            print(f"ptxas: {name}: {line.split(':', 1)[-1].strip()}; "
                  f"{spills.get(name, '')}")
    if not checked:
        return
    # The multi-rank pod chains (pod_kernel<M, up, 0, canon, 1>) must not
    # spill.
    ranks = sorted(k for k in spills
                   if re.fullmatch(r"pod_kernel<\d,\d,0,\d,1>", k))
    check(len(ranks) == 12, f"ptxas reported {len(ranks)} of 12 multi-rank "
          f"chain kernels: {ranks}")
    for k in ranks:
        check(not re.search(r"[1-9]\d* bytes spill", spills[k]),
              f"{k} spills: {spills[k]}")
    legs = sorted(k for k in spills if k.startswith("leg_kernel<"))
    check(len(legs) == 36 and "rdma_kernel" in spills,
          f"ptxas reported {len(legs)} of 36 leg_kernel instantiations "
          f"and rdma_kernel {'rdma_kernel' in spills}")
    # residual_restrict_kernel<mode, faces, ...>: every mode with and
    # without the ghost faces.
    rr = sorted(k for k in spills if k.startswith("residual_restrict_kernel<"))
    rr_pairs = {tuple(re.findall(r"\d+", k)[:2]) for k in rr}
    check(rr_pairs == {(str(m), str(f)) for m in range(3) for f in range(2)},
          f"ptxas reported residual_restrict_kernel instantiations {rr}")
    for lin in ("residual_kernel<0>", "jacobi_kernel<0>",
                "finalize_kernel<0>", "finalize_kernel<1>",
                "subtract_kernel<0>", "subtract_kernel<1>",
                "newton_zero_kernel<0>", "newton_zero_kernel<1>",
                "newton_update_kernel<0>", "newton_update_kernel<1>",
                "newton_gate_kernel", "rdma_kernel",
                "vcycle_kernel<0>", "vcycle_kernel<1>", "vcycle_kernel<2>",
                *legs, *rr):
        line = spills.get(lin, "")
        check(not re.search(r"[1-9]\d* bytes spill", line),
              f"{lin} spills: {line}")
    new = [k for k in ("finalize_kernel<1>", "newton_zero_kernel<1>",
                       "newton_update_kernel<1>", "newton_gate_kernel")
           if k not in spills]
    check(not new, f"ptxas reported no {new} (of {sorted(spills)})")
    # The fused legs: every mode x S = 1..5 x tap order, down and up; the
    # LINEAR main path's instantiations (S = 3, canonical taps) must not
    # spill (FAS's and NEWTON's hold the 64-register cap of 1024 threads
    # with a few spilled words: PERF.md row 6).
    legs2 = sorted(k for k in spills
                   if k.startswith(("down_leg_kernel<", "up_leg_kernel<")))
    check(len(legs2) == 60, f"ptxas reported {len(legs2)} of 60 fused-leg "
          "instantiations")
    for k in (f"{d}_leg_kernel<0,3,1>" for d in ("down", "up")):
        line = spills.get(k, "")
        check(not re.search(r"[1-9]\d* bytes spill", line),
              f"{k} spills: {line}")


def print_leg_smem(base):
    """The dynamic shared memory of each leg launch of the 511³ main path
    (S = 3; ptxas reports only the static part), how many blocks of it an
    SM holds (228 KB, 1 KB reserved per block), and the blocks an SM holds
    by the occupancy calculator (registers too), with and without slabs."""
    import ctypes

    from gpusolve_tpu_torch.config import Mode
    from gpusolve_tpu_torch.dist.spmd import SpmdPlan
    from gpusolve_tpu_torch.ops import kernels as K

    plan = SpmdPlan(base.replace(grid_dim=BIG), (1, 1, 1))
    box = plan.box(0, (0, 0, 0))
    for mode in Mode:
        for c, cname in enumerate(("none", "norm", "restrict")):
            ints = [int(mode), c, 0, 0, 3, 0, 0, *plan.block[0], *box,
                    0, BIG[0], 0, BIG[1]] + [0] * 11
            out = (ctypes.c_longlong * 4)()
            K.lib().mg_leg_grid((ctypes.c_int * len(ints))(*ints), out)
            occ = []
            for slabs in (0, 1):
                ints[2] = slabs
                n = (ctypes.c_int * 1)()
                rc = K.lib().mg_leg_occupancy(
                    (ctypes.c_int * len(ints))(*ints), n)
                K._check_rc(rc, "mg_leg_occupancy")
                occ.append(n[0])
            print(f"leg smem: leg_kernel<{int(mode)},{c}> {cname} S=3: "
                  f"{out[3]} bytes, {233472 // (out[3] + 1024)} blocks/SM by "
                  f"shared memory, {occ[0]} by occupancy ({occ[1]} with "
                  f"slabs); grid {out[0]}x{out[1]}x{out[2]}")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


class Fields:
    """Seeded numpy inputs of one shape, on the card."""

    def __init__(self, dims, seed):
        import numpy as np
        import torch

        rng = np.random.default_rng(seed)
        self.dims = dims
        self.cdims = tuple(d // 2 for d in dims)

        def field(d, scale):
            a = torch.zeros(tuple(n + 2 for n in d), device=DEVICE)
            a[1:-1, 1:-1, 1:-1] = torch.from_numpy(
                rng.standard_normal(d, dtype=np.float32) * np.float32(scale)
            ).to(DEVICE)
            return a

        self.v = field(dims, 0.05)
        self.f = field(dims, 100.0)
        self.nv = field(dims, 0.3)  # Newton's ũ, as tests/test_pallas.py
        self.vc = field(self.cdims, 0.05)
        self.wc = field(self.cdims, 0.05)


class Record:
    """Worst field error and bit-identity of each kernel over the shapes."""

    def __init__(self):
        self.errs = {}
        self.same = {}

    def close(self, got, want, what, key):
        """Fields agree to rtol 1e-5 and atol 1e-5·max|want|."""
        import torch

        diff = (got - want).abs()
        err = float(diff.max())
        atol = RTOL * float(want.abs().max())
        ok = bool((diff <= atol + RTOL * want.abs()).all())
        same = bool(torch.equal(got, want))
        self.errs[key] = max(self.errs.get(key, 0.0), err)
        self.same[key] = self.same.get(key, True) and same
        check(ok, f"{what}: max_abs_err {err:.3e} over atol {atol:.3e}")
        return (f"{what}: max_abs_err={err:.3e} (atol {atol:.3e}) "
                f"bit-identical={same}")

    def fields(self, got, want, what, key):
        """Every pair of fields agrees as in close(); one line for all."""
        import torch

        err, ok, same = 0.0, True, True
        for g, w in zip(got, want):
            diff = (g - w).abs()
            atol = RTOL * float(w.abs().max())
            err = max(err, float(diff.max()))
            ok = ok and bool((diff <= atol + RTOL * w.abs()).all())
            same = same and bool(torch.equal(g, w))
        self.errs[key] = max(self.errs.get(key, 0.0), err)
        self.same[key] = self.same.get(key, True) and same
        check(ok, f"{what}: max_abs_err {err:.3e}")
        return f"{what}: max_abs_err={err:.3e} bit-identical={same}"

    def scalar(self, got, want, what, key):
        err = abs(got - want)
        check(err <= RTOL * abs(want), f"{what}: {got} vs {want}")
        self.errs[key] = max(self.errs.get(key, 0.0), err)
        self.same[key] = self.same.get(key, True) and got == want
        return f"{what}: rel_err={err / abs(want):.3e}"


def check_mode_kernels(p, x, rec, lines):
    """The mode-templated kernels (residual, jacobi_sweep; FAS apply_fas)
    in ``p.mode``, and finalize in LINEAR."""
    import torch

    from gpusolve_tpu_torch.config import Mode
    from gpusolve_tpu_torch.ops import kernels as K

    dims, h = x.dims, p.level_h(0)
    tag = f"{'x'.join(map(str, dims))} {p.mode.name}"
    nv = x.nv if p.mode == Mode.NEWTON else None
    res = K.variant("residual", p.mode)
    r_k, r_p = torch.zeros_like(x.v), torch.zeros_like(x.v)
    parts = K.residual(r_k, x.v, x.f, dims, p, h, with_norm=True,
                       newton_v=nv)
    parts_p = K.residual_plain(r_p, x.v, x.f, dims, p, h, with_norm=True,
                               newton_v=nv)
    ss_k, ss_p = x.v.new_empty(1), x.v.new_empty(1)
    K.finalize(parts, ss_k)
    K.finalize_plain(parts_p, ss_p)
    lines.append(rec.close(r_k, r_p, f"{res} {tag}", res))
    lines.append(rec.scalar(float(ss_k), float(ss_p),
                            f"{res} sum r^2 {tag}", res))
    if p.mode == Mode.LINEAR:
        # finalize alone: the kernel's partials through both versions, and
        # bit for bit through the plain reproduction of its slot order.
        fin_p = x.v.new_empty(1)
        K.finalize_plain(parts, fin_p)
        lines.append(rec.scalar(float(ss_k), float(fin_p),
                                f"finalize {tag}", "finalize"))
        slots = torch.tensor([float(K.finalize_slots_plain(parts))],
                             dtype=torch.float32)
        check(torch.equal(ss_k.cpu(), slots),
              f"finalize {tag}: {float(ss_k)} != slot order "
              f"{float(slots)}")

    jac = K.variant("jacobi_sweep", p.mode)
    out_k, out_p = torch.zeros_like(x.v), torch.zeros_like(x.v)
    K.jacobi_sweep(out_k, x.v, x.f, dims, p, h, newton_v=nv)
    K.jacobi_sweep_plain(out_p, x.v, x.f, dims, p, h, newton_v=nv)
    lines.append(rec.close(out_k, out_p, f"{jac} {tag}", jac))

    outs = [r_k, out_k]
    if p.mode == Mode.NONLINEAR:
        a_k, a_p = x.f.clone(), x.f.clone()
        K.apply_fas(a_k, x.v, dims, p, h)
        K.apply_fas_plain(a_p, x.v, dims, p, h)
        lines.append(rec.close(a_k, a_p, f"apply_fas {tag}", "apply_fas"))
        outs.append(a_k)

    # A set done flag: every kernel returns without writing.
    done = torch.ones(1, dtype=torch.int32, device=DEVICE)
    snap = [t.clone() for t in (*outs, ss_k)]
    K.residual(r_k, x.f, x.v, dims, p, h, done=done, newton_v=nv)
    K.finalize(parts, ss_k, 1e30, done)
    K.jacobi_sweep(out_k, x.f, x.v, dims, p, h, done, newton_v=nv)
    if p.mode == Mode.NONLINEAR:
        K.apply_fas(outs[-1], x.f, dims, p, h, done)
    torch.cuda.synchronize()
    for a, b in zip(snap, (*outs, ss_k)):
        check(torch.equal(a, b), f"done flag ignored at {tag}")
    lines.append(f"done-flag skip {tag}: ok")


def check_transfer_kernels(x, rec, lines):
    """The mode-free kernels: restrict_zero, restrict (one and two
    outputs), prolong_add, subtract."""
    import torch

    from gpusolve_tpu_torch.ops import kernels as K

    dims, cdims = x.dims, x.cdims
    tag = "x".join(map(str, dims))
    fc_k = 7.0 * x.vc  # stale values, zero halo
    vc_k = x.vc.clone()
    fc_p, vc_p = fc_k.clone(), vc_k.clone()
    K.restrict_zero(fc_k, vc_k, x.f, dims, cdims)
    K.restrict_zero_plain(fc_p, vc_p, x.f, dims, cdims)
    lines.append(rec.close(fc_k, fc_p, f"restrict_zero {tag}",
                           "restrict_zero"))
    check(torch.equal(vc_k, vc_p), f"restrict_zero {tag}: coarse v")

    o_k, o2_k = 7.0 * x.vc, 3.0 * x.wc
    o_p, o2_p = o_k.clone(), o2_k.clone()
    K.restrict(o_k, x.v, dims, cdims, out2=o2_k)
    K.restrict_plain(o_p, x.v, dims, cdims, out2=o2_p)
    lines.append(rec.close(o_k, o_p, f"restrict {tag}", "restrict"))
    check(torch.equal(o_k, o2_k), f"restrict {tag}: out2 differs from out")
    one_k = x.wc.clone()
    K.restrict(one_k, x.nv, dims, cdims)
    one_p = x.wc.clone()
    K.restrict_plain(one_p, x.nv, dims, cdims)
    lines.append(rec.close(one_k, one_p, f"restrict one-output {tag}",
                           "restrict"))

    v_k, v_p = x.v.clone(), x.v.clone()
    K.prolong_add(v_k, x.vc, dims, cdims)
    K.prolong_add_plain(v_p, x.vc, dims, cdims)
    lines.append(rec.close(v_k, v_p, f"prolong_add {tag}", "prolong_add"))

    s_k, s_p = x.vc.clone(), x.vc.clone()
    K.subtract(s_k, x.wc, cdims)
    K.subtract_plain(s_p, x.wc, cdims)
    lines.append(rec.close(s_k, s_p, f"subtract {tag}", "subtract"))

    done = torch.ones(1, dtype=torch.int32, device=DEVICE)
    outs = (fc_k, vc_k, o_k, o2_k, v_k, s_k)
    snap = [t.clone() for t in outs]
    K.restrict_zero(fc_k, vc_k, x.v, dims, cdims, done)
    K.restrict(o_k, x.f, dims, cdims, done, out2=o2_k)
    K.prolong_add(v_k, x.vc, dims, cdims, done)
    K.subtract(s_k, x.vc, cdims, done)
    torch.cuda.synchronize()
    for a, b in zip(snap, outs):
        check(torch.equal(a, b), f"done flag ignored at {tag}")
    lines.append(f"done-flag skip {tag} transfers: ok")


# Halo bits of check_subtract: two quiet NaNs with payloads of their own.
NAN_V, NAN_W = 0x7FC0_1234, 0x7FC0_5678
NEWTON_SHAPES = [(15, 15, 15), (31, 15, 63), (127, 127, 127), BIG]
SUBTRACT_SHAPES = [(1, 1, 1), (2, 3, 1), (15, 15, 15), (16, 16, 16),
                   (31, 15, 63), (127, 127, 127), (255, 255, 255)]


def nan_field(dims, nan, offset, rng):
    """A seeded (dims + 2) field on the card whose halo holds the NaN bits
    ``nan``, starting ``offset`` floats into its buffer."""
    import numpy as np
    import torch

    shape = tuple(d + 2 for d in dims)
    buf = torch.full((math.prod(shape) + offset,), nan, dtype=torch.int32,
                     device=DEVICE)
    a = buf[offset:].view(torch.float32).view(shape)
    a[1:-1, 1:-1, 1:-1] = torch.from_numpy(
        rng.standard_normal(dims, dtype=np.float32)).to(DEVICE)
    return a


def halo_kept(a, nan):
    """Every halo point of ``a`` still holds the NaN bits ``nan``."""
    import torch

    bits = a.view(torch.int32).clone()
    bits[1:-1, 1:-1, 1:-1] = nan
    return bool((bits == nan).all())


def check_subtract(rec):
    """subtract against subtract_plain, bit for bit, at the phase-2 shapes,
    the 255³ level the 511³ main paths give it and two of the coarsest
    levels' shapes (rows of 3 floats: a group of 4 spans rows), with NaN
    in the halo of v and of w: v's halo must keep its NaN bits (the
    kernel writes the interior only).  Each shape twice: on 16-byte
    aligned fields (the vector path) and on fields that start 1 and 3
    floats into their buffers (the scalar path)."""
    import numpy as np
    import torch

    from gpusolve_tpu_torch.ops import kernels as K

    field = nan_field
    for n, dims in enumerate(SUBTRACT_SHAPES):
        for offsets in ((0, 0), (1, 3)):
            rng = np.random.default_rng(600 + n)
            v = field(dims, NAN_V, offsets[0], rng)
            w = field(dims, NAN_W, offsets[1], rng)
            v_p = v.clone()
            K.subtract(v, w, dims)
            K.subtract_plain(v_p, w, dims)
            torch.cuda.synchronize()
            bits, bits_p = v.view(torch.int32), v_p.view(torch.int32)
            same = torch.equal(bits, bits_p)
            halo = bits.clone()
            halo[1:-1, 1:-1, 1:-1] = NAN_V
            halo_kept = bool((halo == NAN_V).all())
            err = float((v[1:-1, 1:-1, 1:-1] - v_p[1:-1, 1:-1, 1:-1])
                        .abs().max())
            rec.errs["subtract"] = max(rec.errs.get("subtract", 0.0), err)
            rec.same["subtract"] = rec.same.get("subtract", True) and same
            tag = f"{'x'.join(map(str, dims))} offsets {offsets}"
            print(f"check subtract {tag} (NaN halos): max_abs_err={err:.3e} "
                  f"bit-identical={same}; v's halo NaN bits kept="
                  f"{halo_kept}")
            check(same, f"subtract {tag}: not bit-identical to "
                  "subtract_plain")
            check(halo_kept, f"subtract {tag}: the halo of v was written")
            del v, w, v_p, bits, bits_p, halo
    torch.cuda.empty_cache()


def check_finalize(rec):
    """finalize against finalize_slots_plain (its slot order in float64 on
    the CPU, rounded once to float32), bit for bit, on seeded positive
    partials at n = 1, 1023, 1024, 1025, the 127³ residual's count and the
    511³ count (65 536); and the stop flag: set when the sum is <= thr,
    left when it is above."""
    import numpy as np
    import torch

    from gpusolve_tpu_torch.ops import kernels as K

    L = K.lib()
    ns = (1, 1023, 1024, 1025, L.mg_residual_blocks(127, 127, 127),
          L.mg_residual_blocks(*BIG))
    check(ns[-1] == 65536, f"511^3 residual blocks {ns[-1]}")
    for n in ns:
        rng = np.random.default_rng(700 + n)
        parts = torch.from_numpy(rng.random(n) * 1e3).to(DEVICE)
        out = torch.empty(1, device=DEVICE)
        flag = torch.zeros(1, dtype=torch.int32, device=DEVICE)
        K.finalize(parts, out, done=flag)
        want = float(K.finalize_slots_plain(parts))
        want32 = torch.tensor([want], dtype=torch.float32)
        got = out.cpu()
        same = torch.equal(got, want32)
        err = abs(float(got) - float(want32))
        rec.errs["finalize"] = max(rec.errs.get("finalize", 0.0), err)
        rec.same["finalize"] = rec.same.get("finalize", True) and same
        above, below = out.clone(), out.clone()
        K.finalize(parts, above, float(want32) * 0.5, flag)
        left = int(flag.item())
        K.finalize(parts, below, float(want32) * 2.0, flag)
        set_ = int(flag.item())
        print(f"check finalize n={n}: {float(got)!r} vs slot order "
              f"{float(want32)!r} bit-identical={same}; flag left {left} "
              f"above thr, set {set_} below")
        check(same, f"finalize n={n}: not bit-identical to the slot order")
        check(left == 0 and set_ == 1 and torch.equal(above, out),
              f"finalize n={n}: stop flag {left}/{set_}")


def bits_equal(a, b):
    """Bit for bit, or NaN in both (CUDA's and torch's NaN bits differ)."""
    import torch

    if a.dtype == torch.float32 and bool(a.isnan().all() & b.isnan().all()):
        return True
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def check_newton_kernels(rec):
    """The batched Newton loop's kernels against their plain versions on
    the card, bit for bit, with the outer flag clear and set (a set flag
    must leave every output as it was): newton_zero and newton_update at
    NEWTON_SHAPES (the 511³ level 0 among them) on aligned fields and on
    fields 1 and 3 floats into their buffers (the scalar path), with NaN
    halos whose bits must stay; newton_update after c = 0, 1, 3 and 10
    inner cycles, with v in the second buffer after odd c (odd pre + post)
    and in one buffer throughout; newton_gate's seed over seeded ‖F‖
    values and its step over ΣF² at thr_outer², one ulp above, 0, 26.888361
    (whose float32 root a 1-ulp-off sqrt misses), inf and NaN, every word
    against the plain version and the inner threshold against numpy's
    float32 formula (kernels.inner_threshold); finalize_dev_thr against
    finalize (the same body) and finalize_slots_plain at the finalize
    check's counts, its flag against a device threshold at the sum, one
    ulp below it and −1."""
    import numpy as np
    import torch

    from gpusolve_tpu_torch.ops import kernels as K

    f32, i32 = np.float32, torch.int32

    def flag(x):
        return torch.full((1,), x, dtype=i32, device=DEVICE)

    def note(key, same, err=0.0):
        rec.errs[key] = max(rec.errs.get(key, 0.0), err)
        rec.same[key] = rec.same.get(key, True) and same

    for n, dims in enumerate(NEWTON_SHAPES):
        for offsets in ((0, 0, 0), (1, 3, 1)):
            rng = np.random.default_rng(900 + n)
            tag = f"{'x'.join(map(str, dims))} offsets {offsets}"
            ok_z = ok_u = kept = True
            err_u = 0.0
            for d in (1, 0):
                a = nan_field(dims, NAN_V, offsets[0], rng)
                before = a.clone()
                b = a.clone()
                K.newton_zero(a, dims, flag(d))
                K.newton_zero_plain(b, dims, flag(d))
                ok_z = ok_z and bits_equal(a, b) and (
                    d == 0 or bits_equal(a, before))
                kept = kept and halo_kept(a, NAN_V)
            va = nan_field(dims, NAN_W, offsets[1], rng)
            vb = nan_field(dims, NAN_W, offsets[2], rng)
            nv = nan_field(dims, NAN_V, offsets[0], rng)
            for c in (0, 1, 3, 10):
                norms = torch.full((10,), -1.0, device=DEVICE)
                norms[:c] = torch.from_numpy(
                    rng.random(c).astype(f32)).to(DEVICE)
                for odd in (True, False):
                    v_after = [vb if odd and q % 2 else va
                               for q in range(11)]
                    for d in (1, 0):
                        a, b = nv.clone(), nv.clone()
                        K.newton_update(a, v_after, norms, dims, flag(d))
                        K.newton_update_plain(b, v_after, norms, dims,
                                              flag(d))
                        ok_u = ok_u and bits_equal(a, b) and (
                            d == 0 or bits_equal(a, nv))
                        kept = kept and halo_kept(a, NAN_V)
                        err_u = max(err_u, float(
                            (a - b)[1:-1, 1:-1, 1:-1].abs().max()))
            torch.cuda.synchronize()
            note("newton_zero", ok_z)
            note("newton_update", ok_u, err_u)
            print(f"check newton_zero / newton_update {tag} (NaN halos, "
                  f"flag set and clear, c in 0/1/3/10, odd and even "
                  f"parity): bit-identical={ok_z} / {ok_u}, "
                  f"max_abs_err={err_u:.3e}; halo NaN bits kept={kept}")
            check(ok_z and ok_u and kept,
                  f"newton_zero / newton_update {tag}: {ok_z} {ok_u} {kept}")
            del a, b, before, va, vb, nv
            torch.cuda.empty_cache()

    def words(d, thr_in=-5.0, res=-1.0):
        return [flag(d), flag(d), torch.full((1,), thr_in, device=DEVICE),
                torch.full((1,), res, device=DEVICE)]

    rng = np.random.default_rng(950)
    fns = np.concatenate([
        rng.random(64) * 10.0 ** rng.integers(-20, 20, 64),
        [0.0, 7.33, 2253.0, 3.4e38, np.inf]]).astype(f32)
    ok_seed = True
    for fn in fns:
        ka, pa = words(1), words(1)
        K.newton_gate(None, float(fn), 0.5, None, *ka[:3])
        K.newton_gate_plain(None, float(fn), 0.5, None, *pa[:3])
        want = K.inner_threshold(fn)
        ok_seed = ok_seed and all(bits_equal(x, y) for x, y in zip(ka, pa))
        ok_seed = ok_seed and ka[2].cpu().numpy()[0].tobytes() == \
            want.tobytes() and int(ka[0].item()) == 0
    thr_outer = f32(0.25)
    up = np.nextafter(thr_outer, f32(1), dtype=f32)
    ok_step = True
    for ss in (thr_outer * thr_outer, up * up, f32(0.0), f32(26.888361),
               f32(np.inf), f32(np.nan)):
        for d in (0, 1):
            ka, pa = words(d), words(d)
            sst = torch.full((1,), float(ss), device=DEVICE)
            K.newton_gate(sst, 0.0, float(thr_outer), ka[3], *ka[:3])
            K.newton_gate_plain(sst, 0.0, float(thr_outer), pa[3], *pa[:3])
            same = all(bits_equal(x, y) for x, y in zip(ka, pa))
            r = np.sqrt(ss)
            stop = int(d or (r >= 0 and r <= thr_outer))
            same = same and int(ka[0].item()) == stop == int(ka[1].item())
            if d == 0 and not np.isnan(r):
                same = same and ka[3].cpu().numpy()[0] == r and \
                    ka[2].cpu().numpy()[0] == K.inner_threshold(r)
            ok_step = ok_step and same
    note("newton_gate", ok_seed and ok_step)
    print(f"check newton_gate: the seed over {len(fns)} norms "
          f"bit-identical={ok_seed} (the inner threshold equal to numpy's "
          f"float32 formula); the step at res = thr_outer, one ulp above, "
          f"0, 26.888361's root, inf and NaN, flag clear and set: "
          f"bit-identical={ok_step}")
    check(ok_seed and ok_step, "newton_gate differs from its plain version")

    L = K.lib()
    for n in (1, 1023, 1025, L.mg_residual_blocks(127, 127, 127),
              L.mg_residual_blocks(*BIG)):
        rng = np.random.default_rng(700 + n)
        parts = torch.from_numpy(rng.random(n) * 1e3).to(DEVICE)
        ref = torch.empty(1, device=DEVICE)
        K.finalize(parts, ref, done=flag(0))
        slots = torch.tensor([float(K.finalize_slots_plain(parts))],
                             dtype=torch.float32)
        total = float(ref.item())
        below = float(np.nextafter(f32(total), f32(0), dtype=f32))
        ok = bits_equal(ref.cpu(), slots)
        for thr in (total, below, -1.0):
            for d in (0, 1):
                out, fl = torch.full((1,), -1.0, device=DEVICE), flag(d)
                K.finalize_dev_thr(parts, out, torch.full(
                    (1,), thr, device=DEVICE), fl)
                if d:
                    ok = ok and float(out.item()) == -1.0 and \
                        int(fl.item()) == 1
                else:
                    ok = ok and bits_equal(out, ref) and \
                        int(fl.item()) == int(thr == total)
        err = abs(total - float(slots))
        note("finalize_dev_thr", ok, err)
        print(f"check finalize_dev_thr n={n}: {total!r} bit-identical to "
              f"finalize and the slot order={ok}; flag set at thr = sum, "
              f"left one ulp below and at -1, untouched when set")
        check(ok, f"finalize_dev_thr n={n} differs")


def check_kernels(base, rec):
    import torch

    from gpusolve_tpu_torch.config import Mode

    for n, dims in enumerate(SHAPES):
        x = Fields(dims, seed=100 + n)
        lines = []
        for mode in Mode:
            p = base.replace(grid_dim=dims, mode=mode, print_progress=False)
            check_mode_kernels(p, x, rec, lines)
        check_transfer_kernels(x, rec, lines)
        for line in lines:
            print(f"check {line}")
        del x
        torch.cuda.empty_cache()
    check_subtract(rec)
    check_finalize(rec)
    check_newton_kernels(rec)
    print(f"check bit-identical over all shapes: {rec.same}")


# The fused legs' shapes (csrc/mg_legs.cu): two small grids, one not
# 2^k - 1 along every axis, 63³ (a few tiles a plane) and the 511³ level 0.
LEG_SHAPES = [(15, 15, 15), (33, 17, 9), (63, 63, 63), BIG]


def f32_ulps(a, b):
    """How many float32 ulps (of b) a lies from b."""
    import numpy as np

    a, b = np.float32(a), np.float32(b)
    return float(abs(a - b) / np.spacing(b)) if a != b else 0.0


def check_fused_legs(base, rec):
    """down_leg and up_leg against down_leg_plain / up_leg_plain in each
    mode at S = 1..5 and at LEG_SHAPES (canonical taps; OTHER_TAPS at the
    three small shapes): every output field bit for bit (the smoothed v,
    the coarse f, the coarse v, FAS's rest_v; the halos the sentinel they
    were filled with), and the up leg's norm, finalized, within one
    float32 ulp of the plain norm (its partials are one a block, not one a
    32 x 8 x 8 box, so the float64 sum groups otherwise).  A set done flag
    leaves every output as it was."""
    import torch

    from gpusolve_tpu_torch.config import Mode, Stencil
    from gpusolve_tpu_torch.ops import kernels as K

    worst_ulps = 0.0
    for n, dims in enumerate(LEG_SHAPES):
        x = Fields(dims, seed=300 + n)
        stencils = [("canonical", None)]
        if dims != BIG:
            stencils += list(OTHER_TAPS.items())
        for mode in Mode:
            nv = x.nv if mode == Mode.NEWTON else None
            fas = mode == Mode.NONLINEAR
            dn, up = K.variant("down_leg", mode), K.variant("up_leg", mode)
            for tname, taps in stencils:
                p = base.replace(grid_dim=dims, mode=mode,
                                 print_progress=False)
                if taps is not None:
                    p = p.replace(stencil=Stencil(values=taps[0],
                                                  offsets=taps[1]))
                h = p.level_h(0)
                same, ulps = True, []
                for S in range(1, 6):
                    outs = [torch.full_like(x.v, 7.0)] + [
                        torch.full_like(x.vc, 3.0) for _ in range(3)]
                    want = [t.clone() for t in outs]
                    K.down_leg(outs[0], x.v, x.f, outs[1], outs[2], dims,
                               x.cdims, p, h, S, None, nv,
                               outs[3] if fas else None)
                    K.down_leg_plain(want[0], x.v, x.f, want[1], want[2],
                                     dims, x.cdims, p, h, S, None, nv,
                                     want[3] if fas else None)
                    rec.fields(outs, want, f"down_leg {dims} S={S}", dn)
                    same = same and all(
                        torch.equal(a, b) for a, b in zip(outs, want))
                    got = torch.full_like(x.v, 5.0)
                    ref = got.clone()
                    parts = K.up_leg(got, x.v, x.vc, x.f, dims, x.cdims, p,
                                     h, S, None, nv, with_norm=True)
                    pparts = K.up_leg_plain(ref, x.v, x.vc, x.f, dims,
                                            x.cdims, p, h, S, None, nv,
                                            with_norm=True)
                    rec.fields([got], [ref], f"up_leg {dims} S={S}", up)
                    same = same and torch.equal(got, ref)
                    norm = torch.empty(1, device=DEVICE)
                    pnorm = torch.empty(1, device=DEVICE)
                    K.finalize(parts, norm)
                    K.finalize_plain(pparts, pnorm)
                    ulps.append(f32_ulps(norm.item(), pnorm.item()))
                check(same, f"legs {dims} {mode.name} {tname}: a field "
                      "differs from the plain version")
                check(max(ulps) <= 1.0, f"legs {dims} {mode.name} {tname}:"
                      f" norms {ulps} ulps from the plain norm")
                worst_ulps = max(worst_ulps, max(ulps))
                print(f"check down_leg / up_leg {dims} {mode.name} {tname} "
                      f"S=1..5 vs plain: fields bit-identical={same}, up "
                      f"leg norm ulps from plain {ulps}")
            # A set done flag: nothing written.
            done = torch.ones(1, dtype=torch.int32, device=DEVICE)
            outs = [torch.full_like(x.v, 7.0)] + [
                torch.full_like(x.vc, 3.0) for _ in range(3)]
            K.down_leg(outs[0], x.v, x.f, outs[1], outs[2], dims, x.cdims,
                       base.replace(grid_dim=dims, mode=mode), 1.0, 3, done,
                       nv, outs[3] if fas else None)
            got = torch.full_like(x.v, 5.0)
            K.up_leg(got, x.v, x.vc, x.f, dims, x.cdims,
                     base.replace(grid_dim=dims, mode=mode), 1.0, 3, done,
                     nv, with_norm=True)
            kept = (all(bool((t == 7.0).all()) for t in outs[:1])
                    and all(bool((t == 3.0).all()) for t in outs[1:])
                    and bool((got == 5.0).all()))
            check(kept, f"legs {dims} {mode.name}: a set done flag let a "
                  "leg write")
            print(f"check down_leg / up_leg {dims} {mode.name} done set: "
                  f"outputs untouched={kept}")
        del x
        torch.cuda.empty_cache()
    print(f"check legs: worst up-leg norm {worst_ulps:g} float32 ulps from "
          "the plain norm")


def exact_walks(reset=True):
    """Blocks of either fused leg that took the exact walk (mg_legs.cu's
    div_exact, where a division left the fast path's range) since the last
    reset."""
    import ctypes

    import torch

    from gpusolve_tpu_torch.ops import kernels as K

    torch.cuda.synchronize()
    n = ctypes.c_ulonglong()
    K._check_rc(K.lib().mg_leg_exact_walks(ctypes.byref(n), int(reset)),
                "mg_leg_exact_walks")
    return n.value


def check_legs_exact(base, rec):
    """The legs where their division leaves the fast path, against the
    plain versions bit for bit: FAS and NEWTON at (33,17,9), S = 1..3, on
    fields scaled by 2^-130 (subnormal operands), and on quotients that lie
    on midpoints of the float32 grid (v = ũ = 0, coarse v = 0, gamma 2, f =
    m (pre_fac + gamma) 2^-150 with m odd: the first sweep's quotients m
    2^-150 are ties, which round to even), both of which must take the
    exact walk; and on fields scaled by 2^-70, tiny operands inside the
    fast path's range."""
    import numpy as np
    import torch

    from gpusolve_tpu_torch.config import Mode
    from gpusolve_tpu_torch.ops import kernels as K

    dims = (33, 17, 9)
    x = Fields(dims, seed=390)
    rng = np.random.default_rng(391)
    m = rng.choice(np.arange(-7, 8, 2), size=dims).astype(np.float64)
    for mode in (Mode.NONLINEAR, Mode.NEWTON):
        p = base.replace(grid_dim=dims, mode=mode, gamma=2.0,
                         print_progress=False)
        h = p.level_h(0)
        den = float(np.float32(np.float32(p.stencil.diag / (h * h))
                               + np.float32(p.gamma)))
        check(den % 2 == 0 and den < 2 ** 24,
              f"legs exact: pre_fac + gamma {den} is not an even integer "
              "below 2^24, so f = m den 2^-150 is no float32")
        tie_f = torch.zeros_like(x.f)
        tie_f[1:-1, 1:-1, 1:-1] = torch.from_numpy(
            (m * den * 2.0 ** -150).astype(np.float32)).to(DEVICE)

        def scaled(k):
            return (x.v * 2.0 ** k, x.f * 2.0 ** k, x.nv, x.vc * 2.0 ** k)

        cases = (
            ("2^-130", scaled(-130), True),
            ("ties", (torch.zeros_like(x.v), tie_f, torch.zeros_like(x.nv),
                      torch.zeros_like(x.vc)), True),
            ("2^-70", scaled(-70), False),
        )
        nv_mode = mode == Mode.NEWTON
        fas = mode == Mode.NONLINEAR
        dn, up = K.variant("down_leg", mode), K.variant("up_leg", mode)
        for what, (v, f, nv, vc), forced in cases:
            nv = nv if nv_mode else None
            same, walks = True, []
            for S in range(1, 4):
                outs = [torch.full_like(v, 7.0)] + [
                    torch.full_like(vc, 3.0) for _ in range(3)]
                want = [t.clone() for t in outs]
                exact_walks()
                K.down_leg(outs[0], v, f, outs[1], outs[2], dims, x.cdims,
                           p, h, S, None, nv, outs[3] if fas else None)
                got = torch.full_like(v, 5.0)
                parts = K.up_leg(got, v, vc, f, dims, x.cdims, p, h, S,
                                 None, nv, with_norm=True)
                walks.append(exact_walks())
                K.down_leg_plain(want[0], v, f, want[1], want[2], dims,
                                 x.cdims, p, h, S, None, nv,
                                 want[3] if fas else None)
                ref = torch.full_like(v, 5.0)
                pparts = K.up_leg_plain(ref, v, vc, f, dims, x.cdims, p, h,
                                        S, None, nv, with_norm=True)
                rec.fields(outs, want, f"down_leg {what} S={S}", dn)
                rec.fields([got], [ref], f"up_leg {what} S={S}", up)
                norm = torch.empty(1, device=DEVICE)
                pnorm = torch.empty(1, device=DEVICE)
                K.finalize(parts, norm)
                K.finalize_plain(pparts, pnorm)
                same = (same and torch.equal(got, ref)
                        and all(torch.equal(a, b) for a, b in zip(outs, want))
                        and f32_ulps(norm.item(), pnorm.item()) <= 1.0)
            check(same, f"legs {mode.name} {what}: a field or the norm "
                  "differs from the plain version")
            if forced:
                check(all(walks), f"legs {mode.name} {what}: no block took "
                      f"the exact walk ({walks})")
            print(f"check down_leg / up_leg {dims} {mode.name} {what} "
                  f"S=1..3 vs plain: fields bit-identical and norms within "
                  f"1 ulp={same}, blocks on the exact walk {walks}")


def seeded_state(params, seed):
    """A state with seeded level-0 v (scale 0.05) and, in NEWTON, ũ
    (scale 0.3)."""
    import numpy as np
    import torch

    import gpusolve_tpu_torch as gt

    state = gt.build_grid(params)
    rng = np.random.default_rng(seed)
    d = params.grid_dim

    def fill(t, scale):
        t[1:-1, 1:-1, 1:-1] = torch.from_numpy(
            rng.standard_normal(d, dtype=np.float32) * np.float32(scale)
        ).to(DEVICE)

    fill(state.levels[0].v, 0.05)
    if params.mode == gt.Mode.NEWTON:
        fill(state.levels[0].newton_v, 0.3)
    return state


def clone_state(state):
    import dataclasses

    import gpusolve_tpu_torch as gt

    def cl(t):
        return None if t is None else t.clone()

    levels = tuple(
        dataclasses.replace(lvl, v=cl(lvl.v), f=cl(lvl.f), r=cl(lvl.r),
                            rest_v=cl(lvl.rest_v),
                            newton_v=cl(lvl.newton_v))
        for lvl in state.levels
    )
    return gt.GridState(levels=levels, newton_f=cl(state.newton_f))


def host_state(state):
    """A copy of ``state`` on the CPU."""
    import dataclasses

    import gpusolve_tpu_torch as gt

    def cp(t):
        return None if t is None else t.cpu()

    levels = tuple(
        dataclasses.replace(lvl, v=cp(lvl.v), f=cp(lvl.f), r=cp(lvl.r),
                            rest_v=cp(lvl.rest_v),
                            newton_v=cp(lvl.newton_v))
        for lvl in state.levels
    )
    return gt.GridState(levels=levels, newton_f=cp(state.newton_f))


def level_fields(state):
    out = []
    for lvl in state.levels:
        out += [t for t in (lvl.v, lvl.r, lvl.f, lvl.rest_v, lvl.newton_v)
                if t is not None]
    return out


def check_vcycle_fused(base, rec):
    """The v1 kernel against its plain version: two cycles (one at 511³)
    from the same seeded state, every field of every level (the plain
    version runs the same schedule on the same buffers) and Σr²; then one
    v1 cycle against one batch-engine cycle at 511³ V(6,6), compared as
    tests/test_torch_vcycle_fused.py compares them (FAS coarse v as
    v − rest_v)."""
    import torch

    from gpusolve_tpu_torch.config import Mode, Stencil
    from gpusolve_tpu_torch.ops import vcycle_batch
    from gpusolve_tpu_torch.ops import vcycle_fused as vf

    # The examples' stencil at every shape; at two small ones also its
    # taps in another order with other values, and five taps, which run
    # the body that indexes the level table on every level (the fixed
    # bodies take the canonical order only).
    cases = [(dims, None, pre, post, 200 + n)
             for n, dims in enumerate(V1_SHAPES) for pre, post in V1_SWEEPS]
    cases += [(dims, st, 6, 6, 250 + n)
              for n, dims in enumerate(((15, 15, 15), (33, 17, 9)))
              for st in OTHER_TAPS]
    for dims, st, pre, post, seed in cases:
        stencil = base.stencil if st is None else Stencil(*OTHER_TAPS[st])
        for mode in Mode:
            p = base.replace(grid_dim=dims, mode=mode, pre_smoothing=pre,
                             post_smoothing=post, stencil=stencil,
                             print_progress=False)
            a = seeded_state(p, seed)
            b = clone_state(a)
            for _ in range(1 if dims == BIG else 2):
                ss_k = vf.vcycle_fused(a.levels, p)
                ss_p = vf.vcycle_fused_plain(b.levels, p)
            torch.cuda.synchronize()
            tag = (f"vcycle_fused {'x'.join(map(str, dims))} "
                   f"V({pre},{post}) {mode.name}"
                   + ("" if st is None else f", taps {st}"))
            fields = rec.fields(level_fields(a), level_fields(b), tag,
                                "vcycle_fused")
            norm = rec.scalar(float(ss_k), float(ss_p), "sum r^2",
                              "vcycle_fused")
            print(f"check {fields}; {norm}")
            del a, b
            torch.cuda.empty_cache()
    for mode in Mode:
        p = base.replace(grid_dim=BIG, mode=mode, pre_smoothing=6,
                         post_smoothing=6, print_progress=False)
        a = seeded_state(p, 300)
        b = clone_state(a)
        ss_k = float(vf.vcycle_fused(a.levels, p)[0])
        ss_b = float(vcycle_batch.run(b, p, maxk=1)[0])
        got, want = [], []
        for i, (la, lb) in enumerate(zip(a.levels, b.levels)):
            got.append(la.f)
            want.append(lb.f)
            if mode == Mode.NONLINEAR:
                got += [la.rest_v, la.v - la.rest_v if i else la.v]
                want += [lb.rest_v, lb.v]
            else:
                got.append(la.v)
                want.append(lb.v)
        check(ss_k == ss_b,
              f"v1 vs batch 511^3 {mode.name}: sum r^2 {ss_k} != {ss_b}")
        line = rec.fields(got, want,
                          f"v1 vs batch cycle 511^3 V(6,6) {mode.name}",
                          "v1_vs_batch")
        print(f"check {line}; sum r^2 {ss_k} == {ss_b}")
        del a, b, got, want
        torch.cuda.empty_cache()
    grids = {mode.name: vf.grid_blocks(mode) for mode in Mode}
    print(f"check v1 bit-identical: to its plain version "
          f"{rec.same['vcycle_fused']}, to the batch engine's cycle "
          f"{rec.same['v1_vs_batch']}; cooperative grid {grids} blocks")


# ---------------------------------------------------------------------------
# Phase 3: the main paths
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def counting_inner():
    """Records the inner cycles of each Newton step in the list it yields:
    the per-step loop's from the lengths of find_error's histories, the
    batched loop's from each executed step's inner norms (those not −1) in
    the batch's one read."""
    import numpy as np

    from gpusolve_tpu_torch.solver import newton

    inner_cycles = []
    find_error, read_batch = newton.find_error, newton._read_batch

    def counted(*args, **kwargs):
        hist = find_error(*args, **kwargs)
        inner_cycles.append(len(hist))
        return hist

    def counted_batch(*args, **kwargs):
        norms, outer = read_batch(*args, **kwargs)
        inner_cycles.extend(int(np.count_nonzero(row != -1.0))
                            for row, res in zip(norms, outer) if res != -1.0)
        return norms, outer

    newton.find_error = counted
    newton._read_batch = counted_batch
    try:
        yield inner_cycles
    finally:
        newton.find_error = find_error
        newton._read_batch = read_batch


def histories_agree(got, want, what, floor=1e-4):
    """rel 2e-4 where the residual is >= floor·initial; a factor 1.5 below
    (the float32 floor, where summation orders legitimately differ); the
    stop at most one cycle apart."""
    check(abs(len(got) - len(want)) <= 1,
          f"{what}: {len(got)} vs {len(want)} entries")
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if w >= floor * want[0]:
            rel = abs(g - w) / w
            worst = max(worst, rel)
            check(rel <= 2e-4, f"{what}: entry {i} {g} vs {w}")
        else:
            check(w / 1.5 <= g <= w * 1.5, f"{what}: entry {i} {g} vs {w}")
    return worst


def run_solve(params, check_every):
    import torch

    import gpusolve_tpu_torch as gt

    state = gt.build_grid(params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if params.mode == gt.Mode.NEWTON:
        state, hist = gt.newton_solve(state, params, check_every=check_every)
    else:
        state, hist = gt.solve(state, params, check_every=check_every)
    torch.cuda.synchronize()
    return state, hist, time.perf_counter() - t0


def nonzero(counts):
    return {k: n for k, n in counts.items() if n}


def newton_batched(params, k):
    """newton_solve(check_every=k) runs the batched outer loop."""
    from gpusolve_tpu_torch.config import Mode
    from gpusolve_tpu_torch.solver import vcycle as tvc

    return (params.mode == Mode.NEWTON and k > 1
            and tvc.use_fused2(params, DEVICE))


def enqueued(params, executed, k):
    """Cycles or steps a batched loop enqueues: whole batches of ``k``
    (after an early stop the rest of the batch is enqueued and skips on
    the device), the last cut by maxiter."""
    return min(params.maxiter, k * math.ceil(executed / k))


def expected_counts(params, hist, k, inner_cycles=()):
    """Launches of a solve.  The batch engine: whole batches of ``k``
    cycles (the cycles after an early stop are enqueued and skip on the
    device); the v1 engine: one vcycle_fused launch per executed cycle.
    Plus the initial residual norm.  A Newton solve: the initial F, then
    the per-step loop: per outer step R(ũ) into levels 1..L−2, the inner
    solve (batch: one batch of 10 cycles; v1: the cycles each step ran)
    and F again; the batched loop (``check_every`` > 1 on the batch
    engine): a seed newton_gate a batch and per enqueued step newton_zero,
    R(ũ), 10 inner cycles (their norms through finalize_dev_thr),
    newton_update, F with its finalize and newton_gate."""
    from gpusolve_tpu_torch.config import Mode
    from gpusolve_tpu_torch.ops import kernels as K
    from gpusolve_tpu_torch.ops.vcycle_batch import launches_per_cycle
    from gpusolve_tpu_torch.solver import vcycle as tvc

    v1 = tvc.engine(params, DEVICE) == "v1"
    per = {"vcycle_fused": 1} if v1 else launches_per_cycle(params)
    executed = len(hist) - 1
    want = {name: 0 for name in K.KERNELS}
    if newton_batched(params, k):
        steps = enqueued(params, executed, k)
        for name, n in per.items():
            name = "finalize_dev_thr" if name == "finalize" else name
            want[name] += n * 10 * steps
        for name in ("newton_zero", "newton_update", "residual_fas",
                     "finalize", "newton_gate"):
            want[name] += steps
        want["restrict"] += steps * max(0, params.num_levels - 2)
        want["newton_gate"] += math.ceil(executed / k)
        want["residual_fas"] += 1
        want["finalize"] += 1
        return nonzero(want)
    if params.mode == Mode.NEWTON:
        cycles = sum(inner_cycles) if v1 else 10 * executed
        norms = executed + 1
        first = "residual_fas"
    else:
        cycles = executed if v1 else enqueued(params, executed, k)
        norms = 1
        first = K.variant("residual", params.mode)
    for name, n in per.items():
        want[name] += n * cycles
    want[first] += norms
    want["finalize"] += norms
    if params.mode == Mode.NEWTON:
        want["restrict"] += executed * max(0, params.num_levels - 2)
    return nonzero(want)


def host_reads(params, hist, k, inner_cycles=()):
    """Host reads of a solve by the schedule: the initial norm, then one a
    batch (the batch engine, the batched Newton loop) or a cycle (v1); the
    per-step Newton loop reads F a step beside its inner solve's reads."""
    from gpusolve_tpu_torch.solver import vcycle as tvc

    executed = len(hist) - 1
    v1 = tvc.engine(params, DEVICE) == "v1"
    if newton_batched(params, k):
        return 1 + math.ceil(executed / k)
    if params.mode.name == "NEWTON":
        return 1 + executed + (sum(inner_cycles) if v1 else executed)
    return 1 + (executed if v1 else math.ceil(executed / k))


def main_path(params, label, k=10, plain_maxiter=None, identical=False,
              floor=None):
    """One main path: launch counts, the stop, the fall of the residual
    down to ``floor``·initial, and the plain ops on the card
    (``identical``: the same history, else histories_agree).  Returns the
    state and the counts."""
    import torch

    from gpusolve_tpu_torch.config import Mode
    from gpusolve_tpu_torch.ops import kernels as K
    from gpusolve_tpu_torch.ops import vcycle_batch
    from gpusolve_tpu_torch.solver import vcycle as tvc

    K.reset_launches()
    reads0 = vcycle_batch.host_reads
    with counting_inner() as inner_cycles:
        state, hist, secs = run_solve(params, k)
    counts = nonzero(K.launches)
    reads = vcycle_batch.host_reads - reads0
    steps = len(hist) - 1
    print(f"main path {label}: engine {tvc.engine(params, DEVICE)}"
          f"{', batched Newton loop' if newton_batched(params, k) else ''}, "
          f"{steps} steps in {secs:.3f} s wall "
          f"({1e3 * secs / steps:.2f} ms per step, initial residual "
          f"included), {reads} host reads, history {hist}")
    if inner_cycles:
        print(f"main path {label}: inner cycles per step {inner_cycles}")
    print(f"main path {label} launches: {counts}")
    want = expected_counts(params, hist, k, inner_cycles)
    check(counts == want, f"{label}: launch counts {counts} != schedule "
          f"{want}")
    want_reads = host_reads(params, hist, k, inner_cycles)
    check(reads == want_reads, f"{label}: {reads} host reads, the "
          f"schedule's {want_reads}")
    initial = hist[0]
    stop = [i for i, r in enumerate(hist[1:])
            if r <= initial / (1.0 / params.tol)]
    check(stop == [] and steps == params.maxiter or stop == [steps - 1],
          f"{label}: the loop did not end by the stop test or maxiter")
    # At V(3,3) LINEAR falls every step down to 1e-4·initial; FAS and
    # Newton reach their float32 floor sooner, so they are held to falling
    # above 1e-2, as is every V(6,6) path (LINEAR's floor at 511³ lies at
    # ~8.6e-4·initial).
    if floor is None:
        floor = 1e-4 if params.mode == Mode.LINEAR else 1e-2
    above = [r for r in hist if r >= floor * initial]
    check(all(b < a for a, b in zip(above, above[1:])),
          f"{label}: the residual did not fall every step")

    K.reset_launches()
    plain = params.replace(backend="ref",
                           maxiter=plain_maxiter or params.maxiter)
    ref_state, ref_hist, ref_secs = run_solve(plain, k)
    check(all(n == 0 for n in K.launches.values()),
          "the plain path launched a kernel")
    print(f"plain path {label}: {ref_secs:.3f} s wall "
          f"({1e3 * ref_secs / (len(ref_hist) - 1):.2f} ms per step), "
          f"history {ref_hist}")
    mine = hist[:len(ref_hist)] if plain_maxiter else hist
    if identical:
        check(mine == ref_hist,
              f"{label}: kernel and plain histories differ")
        worst = 0.0
    else:
        worst = histories_agree(mine, ref_hist, f"{label} kernels vs plain")
    line = (f"kernels vs plain {label}: worst history rel diff {worst:.3e}"
            f" (identical: {mine == ref_hist})")
    if plain_maxiter is None:
        field = "newton_v" if params.mode == Mode.NEWTON else "v"
        v = getattr(state.levels[0], field)
        vr = getattr(ref_state.levels[0], field)
        vdiff = float((v - vr).abs().max())
        scale = float(vr.abs().max())
        check(vdiff <= 2e-5 * scale + 2e-4 * scale,
              f"{label}: final v differs by {vdiff:.3e}")
        if identical:
            check(torch.equal(v, vr), f"{label}: final {field} differs")
        line += (f", final {field} max_abs_diff {vdiff:.3e} "
                 f"(bit-identical: {torch.equal(v, vr)})")
    print(line)
    del ref_state
    torch.cuda.empty_cache()
    return state, counts, hist


def state_fields(state):
    """Every level's v, f and newton_v (r is scratch: the two Newton
    loops may leave different spares in it)."""
    return [(f"level {i} {n}", getattr(lvl, n))
            for i, lvl in enumerate(state.levels)
            for n in ("v", "f", "newton_v")]


def same_state(a, b):
    """The fields of state_fields that differ between two states."""
    import torch

    return [n for (n, x), (_, y) in zip(state_fields(a), state_fields(b))
            if not torch.equal(x, y)]


def newton_loops_agree(params, label, k, batch=None):
    """The batched Newton loop (check_every=k) against the per-step loop
    on the kernels from the same state: the same history and every level's
    v, f and newton_v bit for bit; the batched run's launch counts and
    host reads equal its schedule.  ``batch``: the batched run's (state,
    history) when the caller has it.  Returns the per-step history."""
    import torch

    from gpusolve_tpu_torch.ops import kernels as K
    from gpusolve_tpu_torch.ops import vcycle_batch

    check(newton_batched(params, k), f"{label}: not the batched loop")
    if batch is None:
        K.reset_launches()
        reads0 = vcycle_batch.host_reads
        with counting_inner() as inner_cycles:
            state, hist, _ = run_solve(params, k)
        counts = nonzero(K.launches)
        reads = vcycle_batch.host_reads - reads0
        want = expected_counts(params, hist, k)
        check(counts == want, f"{label}: launch counts {counts} != "
              f"schedule {want}")
        check(reads == host_reads(params, hist, k),
              f"{label}: {reads} host reads")
        print(f"newton batched {label} K={k}: history {hist}, inner cycles "
              f"per step {inner_cycles}, {reads} host reads, launches "
              f"{counts} (the schedule's)")
    else:
        state, hist = batch
    ref_state, ref_hist, _ = run_solve(params, 1)
    differ = same_state(state, ref_state)
    print(f"newton batched vs per-step {label} K={k}: histories identical "
          f"{hist == ref_hist} ({len(hist) - 1} steps), every level's v, f "
          f"and newton_v bit-identical {not differ}"
          + (f" (differ: {differ})" if differ else ""))
    check(hist == ref_hist and not differ,
          f"{label}: the batched loop left another history or state")
    del state, ref_state
    torch.cuda.empty_cache()
    return ref_hist


def newton_sync_count(params, k):
    """The batched loop's synchronising calls, counted by PyTorch's sync
    debug mode (a warning each), against its host-read counter: no read
    slips in beside the one a batch."""
    import warnings

    import torch

    import gpusolve_tpu_torch as gt
    from gpusolve_tpu_torch.ops import vcycle_batch

    state = gt.build_grid(params)
    torch.cuda.synchronize()
    reads0 = vcycle_batch.host_reads
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _, hist = gt.newton_solve(state, params, check_every=k)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    reads = vcycle_batch.host_reads - reads0
    print(f"newton batched 511^3 K={k} under the sync debug mode: "
          f"{len(syncs)} synchronising calls, {reads} host reads counted, "
          f"{len(hist) - 1} steps"
          + (f"; {sorted({str(w.message)[:80] for w in syncs})}"
             if len(syncs) != reads else ""))
    check(len(syncs) == reads == host_reads(params, hist, k),
          f"newton batched: {len(syncs)} syncs, {reads} reads")


def newton_stops_127():
    """The outer stop inside a batch and at a batch's end, at 127³: tol
    1e-3 stops the per-step loop before maxiter; the batched loop with
    K = 10 (the stop mid-batch, the rest of the batch enqueued and
    skipped on the device) and with K = the steps taken (the stop at the
    batch's end) at V(3,3), and K = 10 at V(2,1) (odd pre + post: level
    0's v lies in a data-dependent buffer) must leave the per-step loop's
    history and state."""
    import gpusolve_tpu_torch as gt

    base = gt.parse_config(CONFS["newton"], tol=1e-3, print_progress=False)
    for pre, post in ((3, 3), (2, 1)):
        p = base.replace(pre_smoothing=pre, post_smoothing=post)
        label = f"127^3 V({pre},{post}) tol 1e-3"
        hist = newton_loops_agree(p, label, 10)
        steps = len(hist) - 1
        check(steps < p.maxiter and steps % 10,
              f"{label}: stops after {steps} steps, not inside a batch")
        if (pre, post) == (3, 3) and steps > 1:
            newton_loops_agree(p, label, steps)


def other_cycles(params127, label):
    """W and F cycles at 127³ (3 cycles, or 3 Newton steps), against the
    plain ops; their launches equal the schedule's.  Returns the launches
    summed over both."""
    from gpusolve_tpu_torch.ops import kernels as K

    total = {}
    for cyc in "WF":
        p = params127.replace(cycle_type=cyc, maxiter=3, tol=1e-12,
                              print_progress=False)
        K.reset_launches()
        _, hist, secs = run_solve(p, 3)
        counts = nonzero(K.launches)
        _, ref_hist, _ = run_solve(p.replace(backend="ref"), 3)
        worst = histories_agree(hist, ref_hist, f"127^3 {label} {cyc}")
        want = expected_counts(p, hist, 3)
        check(counts == want, f"{label} {cyc}: launch counts {counts} != "
              f"schedule {want}")
        print(f"127^3 {label} {cyc}-cycle: history {hist} ({secs:.3f} s), "
              f"worst rel diff vs plain {worst:.3e}, launches {counts}")
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n
    return total


@contextlib.contextmanager
def per_op_schedule():
    """The batch engine with every level visit on the per-op kernels (the
    schedule W and F cycles past the sweep cap run): both legs refused."""
    from gpusolve_tpu_torch.ops import vcycle_batch

    legs = vcycle_batch.legs
    vcycle_batch.legs = lambda params: (False, False)
    try:
        yield
    finally:
        vcycle_batch.legs = legs


def legs_vs_per_op(params, label, state, hist, k=10):
    """The main path on the legs against the same solve on the per-op
    schedule, from the same state: every level's fields bit for bit, each
    history entry within one float32 ulp (the up leg's norm partials group
    the float64 sum otherwise), the per-op run's launches its schedule's."""
    import torch

    from gpusolve_tpu_torch.ops import kernels as K

    with per_op_schedule():
        K.reset_launches()
        with counting_inner() as inner_cycles:
            ref, ref_hist, secs = run_solve(params, k)
        counts = nonzero(K.launches)
        want = expected_counts(params, ref_hist, k, inner_cycles)
    check(counts == want, f"{label} per-op schedule: launch counts {counts}"
          f" != schedule {want}")
    check(len(hist) == len(ref_hist),
          f"{label}: legs {len(hist)} entries, per-op {len(ref_hist)}")
    ulps = [f32_ulps(a, b) for a, b in zip(hist, ref_hist)]
    check(max(ulps) <= 1.0, f"{label}: legs vs per-op norms {ulps} ulps")

    def fields(st):
        return [(f"level {i} {n}", getattr(lvl, n))
                for i, lvl in enumerate(st.levels)
                for n in ("v", "f", "rest_v", "newton_v")
                if getattr(lvl, n) is not None]

    differ = [n for (n, a), (_, b) in zip(fields(state), fields(ref))
              if not torch.equal(a, b)]
    check(not differ, f"{label}: legs vs per-op fields differ: {differ}")
    print(f"legs vs per-op schedule {label}: histories identical "
          f"{hist == ref_hist} (worst {max(ulps):g} float32 ulps), every "
          f"level's fields bit-identical ({len(fields(state))} fields); "
          f"per-op run {secs:.3f} s wall, launches {counts}")
    del ref
    torch.cuda.empty_cache()


def run_cli(args):
    """cli.main on ``args``; returns (rc, stdout, stderr), echoing both."""
    from gpusolve_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(args)
    sys.stdout.write(out.getvalue())
    for ln in err.getvalue().splitlines():
        print(f"[stderr] {ln}")
    return rc, out.getvalue(), err.getvalue()


def progress(lines, newton=False):
    """The initial residual and the per-iteration residuals of a run's
    progress lines, checked for form and numbering."""
    word = "newton iter" if newton else "iter"
    first = "Inital newton residual: " if newton else "Inital residual: "
    init = [float(ln[len(first):]) for ln in lines if ln.startswith(first)]
    iters = [re.match(rf"^{word}: (\d+) residual: (\S+) Took (\d+)ms", ln)
             for ln in lines if ln.startswith(f"{word}: ")]
    check(len(init) == 1 and iters and all(iters), "cli: progress lines")
    check([int(m.group(1)) for m in iters] == list(range(len(iters))),
          "cli: iteration numbers")
    return init[0], [float(m.group(2)) for m in iters]


def cli_path(conf, mode_line, newton=False, extra=(), engine="batch of"):
    """One CLI run with --devices and --explain-backend: the reference's
    lines, --validate's error in modes 1 and 2, the engine line."""
    from gpusolve_tpu_torch.ops import kernels as K

    K.reset_launches()
    validate = mode_line != "Solving linear problem"
    args = [conf, "--devices", "--explain-backend", *extra]
    args += ["--validate"] if validate else []
    rc, out, err = run_cli(args)
    check(rc == 0, f"cli exited {rc}")
    lines = out.splitlines()
    check(lines[0] == f"Using config file {conf}", "cli: config line")
    check(mode_line in lines, f"cli: mode line {mode_line!r}")
    progress(lines, newton)
    check(f"backend: single device: {engine}" in err,
          f"cli: engine line {engine!r} missing")
    if validate:
        m = [re.match(r"^max-abs error vs analytic solution: (\S+)$", ln)
             for ln in lines if ln.startswith("max-abs error")]
        check(len(m) == 1 and m[0], "cli: the --validate line")
        err = float(m[0].group(1))
        check(math.isfinite(err) and err < 5e-4,
              f"cli: max-abs error {err} vs the analytic solution")
    check(K.launches["finalize"] > 0, f"cli: no kernel ran {K.launches}")
    print(f"cli launches: {nonzero(K.launches)}")
    return lines


def conf_with(tmp, src, name, **changes):
    """A copy of a config file with tokens changed: maxiter, tol, pre,
    post, dims (the grid's three)."""
    toks = open(src).read().split()
    where = {"maxiter": 0, "tol": 1, "pre": 6, "post": 7}
    for key, val in changes.items():
        if key == "dims":
            toks[2:5] = [str(d) for d in val]
        else:
            toks[where[key]] = str(val)
    path = os.path.join(tmp, name)
    with open(path, "w") as f:
        f.write(" ".join(toks))
    return path


def cli_flags(tmp):
    """The flags this port gained with the v1 engine, each on the card."""
    import numpy as np

    from gpusolve_tpu_torch.ops import kernels as K

    # A V(6,6) config runs the v1 kernel, one launch per cycle, and says
    # why it left the batch engine.
    v66 = conf_with(tmp, CONFS["linear"], "v66.conf", pre=6, post=6)
    K.reset_launches()
    lines = cli_path(v66, "Solving linear problem",
                     engine="v1 whole-cycle kernel")
    _, res = progress(lines)
    check(nonzero(K.launches) == {"residual": 1, "finalize": 1,
                                  "vcycle_fused": len(res)},
          f"cli V(6,6): launches {K.launches}")

    # --save-state / --load-state: 4 cycles, then 6 resumed, against 10
    # straight, on the v1 engine (tol far below the float32 floor, so
    # maxiter ends each run).
    ck = {n: os.path.join(tmp, f"{n}.npz") for n in ("head", "tail", "all")}
    confs = {n: conf_with(tmp, v66, f"v66_{n}.conf", maxiter=n, tol=1e-12)
             for n in (4, 6, 10)}
    rc_a, _, _ = run_cli([confs[4], "--quiet", "--save-state", ck["head"]])
    rc_b, out_b, _ = run_cli([confs[6], "--quiet", "--load-state",
                              ck["head"], "--save-state", ck["tail"]])
    rc_c, _, _ = run_cli([confs[10], "--quiet", "--save-state", ck["all"]])
    check(rc_a == rc_b == rc_c == 0, "cli checkpoint runs")
    check(f"Resumed from {ck['head']} (iteration 4)" in out_b.splitlines(),
          "cli: the Resumed line")
    with np.load(ck["tail"]) as t, np.load(ck["all"]) as a:
        check(int(t["__iteration__"]) == int(a["__iteration__"]) == 10,
              "cli checkpoint iterations")
        check(np.array_equal(t["__history__"], a["__history__"]),
              f"cli: resumed history {t['__history__']} != "
              f"{a['__history__']}")
        hist = [float(x) for x in a["__history__"]]
    print(f"cli checkpoint: 4 + 6 resumed cycles give the 10-cycle "
          f"history exactly: {hist}")

    # --refine to tol 1e-10: float64 outer defect, float32 inner solves on
    # the kernels.
    for label in ("linear", "newton"):
        conf = conf_with(tmp, CONFS[label], f"refine_{label}.conf",
                         tol=1e-10)
        K.reset_launches()
        rc, out, _ = run_cli([conf, "--refine", "--explain-backend"])
        check(rc == 0, f"cli --refine {label} exited {rc}")
        initial, res = progress(out.splitlines(), newton=label == "newton")
        check(res[-1] <= initial * 1e-10,
              f"cli --refine {label}: {res[-1]} vs initial {initial}")
        check(K.launches[K.variant("jacobi_sweep", 0 if label == "linear"
                                   else 2)] > 0,
              f"cli --refine {label}: the inner solves ran no kernel")
        print(f"cli --refine {label}: {initial:.6g} -> {res[-1]:.6g} in "
              f"{len(res)} outer steps ({res[-1] / initial:.3e} of the "
              f"initial); launches {nonzero(K.launches)}")

    # --dtype float64: the plain ops on the card, no kernel launch.
    K.reset_launches()
    rc, out, err = run_cli([CONFS["linear"], "--dtype", "float64",
                            "--explain-backend"])
    check(rc == 0, f"cli --dtype float64 exited {rc}")
    check("backend: single device: plain PyTorch ops (float64;" in err,
          "cli --dtype float64: engine line")
    check(all(n == 0 for n in K.launches.values()),
          f"cli --dtype float64 launched {K.launches}")
    initial, res = progress(out.splitlines())
    check(all(b < a for a, b in zip(res, res[1:])),
          "cli --dtype float64: the residual did not fall every cycle")
    print(f"cli --dtype float64: {initial:.10g} -> {res[-1]:.10g}, no "
          "kernel launched")

    # --profile DIR: a Chrome trace of the solve.
    prof = os.path.join(tmp, "prof")
    rc, out, _ = run_cli([CONFS["linear"], "--quiet", "--profile", prof])
    trace = os.path.join(prof, "trace.json")
    check(rc == 0 and f"Wrote profiler trace to {prof}" in out
          and os.path.getsize(trace) > 0, "cli --profile")
    print(f"cli --profile: {os.path.getsize(trace)} bytes of trace")


# ---------------------------------------------------------------------------
# Phase 4b: the entry cycle, parity against the host solver, cpu-native
# ---------------------------------------------------------------------------

PARITY_SIZES = (63, 127)


def entry_path():
    """dryrun.entry()'s cycle on the card (its counts zeroed just before
    and read just after) against the same cycle on the plain ops on the
    card, by histories_agree's rule.  Returns the counts."""
    import torch

    from gpusolve_tpu_torch import dryrun
    from gpusolve_tpu_torch.ops import kernels as K
    from gpusolve_tpu_torch.solver.vcycle import vcycle

    fn, (state,) = dryrun.entry()
    params = fn.keywords["params"]
    K.reset_launches()
    _, res = fn(state)
    torch.cuda.synchronize()
    counts = nonzero(K.launches)
    _, (pstate,) = dryrun.entry()
    K.reset_launches()
    _, want = vcycle(pstate, params.replace(backend="ref"))
    check(not nonzero(K.launches), "entry: the plain cycle launched a kernel")
    worst = histories_agree([res], [want], "entry cycle vs plain")
    check(counts.get("down_leg", 0) > 0 and counts.get("up_leg", 0) > 0,
          f"entry: the cycle ran no fused leg {counts}")
    print(f"entry path 63^3 LINEAR V(3,3): residual {res} vs plain {want} "
          f"(rel {worst:.3e}); launches {counts}")
    return counts


def parity_phase():
    """The parity check (gpusolve_tpu_torch/scripts/parity.py) at 63³
    and 127³, every mode, every engine, against the float64 host solver:
    each ran row's margin under 1 (an engine that fails to run raises),
    pod-y recorded as skipped on the one card."""
    from gpusolve_tpu_torch.scripts import parity

    t0 = time.perf_counter()
    for size in PARITY_SIZES:
        for mode in (0, 1, 2):
            rows = parity.judge_group(size, mode, list(parity.ENGINES),
                                      parity.golden(size, mode), "cuda")
            ran = [r["engine"] for r in rows if "history" in r]
            check(ran == [e for e in parity.ENGINES if e != "pod-y"],
                  f"parity {size}^3 mode {mode}: ran {ran}")
            skipped = [r for r in rows if "skipped" in r]
            check([r["engine"] for r in skipped] == ["pod-y"],
                  f"parity {size}^3 mode {mode}: skipped {skipped}")
            print(f"parity {size}^3 mode={mode} pod-y: skipped: "
                  f"{skipped[0]['skipped']}")
            bad = [(r["engine"], r["margin"]) for r in rows
                   if not r["ok"]]
            check(not bad, f"parity {size}^3 mode {mode}: {bad}")
    print(f"parity: {len(PARITY_SIZES) * 3 * (len(parity.ENGINES) - 1)} "
          f"rows, every margin < 1, in {time.perf_counter() - t0:.1f} s")


def native_cli(tmp):
    """--backend cpu-native on examples/linear_127.conf at 63³: the JAX
    CLI's lines, no kernel launch, and its float64 history against the
    batch engine's on the card: rel 2e-4 while the residual is >= 1e-3 of
    the initial, within 1e-4 of the initial below (float32's floor lies
    near 1.5e-5 of it at 63³)."""
    import gpusolve_tpu_torch as gt
    from gpusolve_tpu_torch.ops import kernels as K

    conf = conf_with(tmp, CONFS["linear"], "native63.conf", dims=(63,) * 3)
    K.reset_launches()
    rc, out, err = run_cli([conf, "--backend", "cpu-native",
                            "--explain-backend"])
    check(rc == 0, f"cli --backend cpu-native exited {rc}")
    lines = out.splitlines()
    check(lines[:2] == [f"Using config file {conf}",
                        "Solving linear problem"], "cli cpu-native: lines")
    check("backend: cpu-native: the C++/OpenMP host solver" in err,
          "cli cpu-native: engine line")
    check(not nonzero(K.launches), f"cli cpu-native launched {K.launches}")
    initial, res = progress(lines)
    native = [initial] + res
    params = gt.parse_config(conf, print_progress=False)
    _, batch, _ = run_solve(params, 10)
    check(native[-1] <= initial * params.tol,
          f"cli cpu-native did not reach tol: {native}")
    for i, (g, w) in enumerate(zip(batch, native)):
        lim = 2e-4 * w if w >= 1e-3 * initial else 1e-4 * initial
        check(abs(g - w) <= lim, f"cli cpu-native vs batch: entry {i} "
              f"{g} vs {w}")
    print(f"cli --backend cpu-native 63^3: {native} against the batch "
          f"engine's {batch}")


# ---------------------------------------------------------------------------
# Phase 5: times
# ---------------------------------------------------------------------------


def stencil_filter(params, inv_h2):
    import torch

    w = torch.zeros((1, 1, 3, 3, 3), device=DEVICE)
    for val, (ox, oy, oz) in zip(params.stencil.values,
                                 params.stencil.offsets):
        w[0, 0, 1 + ox, 1 + oy, 1 + oz] += val * inv_h2
    return w


def trilinear_filter(scale):
    import torch

    w1 = torch.tensor([0.5, 1.0, 0.5], device=DEVICE)
    w = w1[:, None, None] * w1[None, :, None] * w1[None, None, :]
    return (w * scale).reshape(1, 1, 3, 3, 3)


def time_cases(cases, rate, rows):
    """Each case's time (CUDA events over 20 back-to-back calls, the host's
    part of each call included), its device time (device_ms: the
    profiler's over 20 calls; a reading below the bound or above the
    events is taken again, up to twice), bound, plain time, and the
    library call's event and device times."""
    for name, (kern, plain, libcall, nbytes, flops, shape) in cases.items():
        t_bytes = nbytes / rate * 1e3
        t_ops = flops / F32_PEAK * 1e3
        bound_ms = max(t_bytes, t_ops)
        ms = cuda_ms(kern, reps=20)
        dev_ms = device_ms(kern, reps=20)
        # The kernels of back-to-back calls on one stream take at least
        # the bound and at most the events' span: a reading outside that
        # lost or misdated events.  Taken again, twice; then not measured.
        for retake in range(3):
            if dev_ms is None or bound_ms <= dev_ms <= 1.01 * ms:
                break
            print(f"profiler: {name} device {dev_ms:.4f} ms outside "
                  f"[bound {bound_ms:.4f}, events {ms:.4f}]"
                  + ("; taking it again" if retake < 2 else
                     "; not measured"))
            dev_ms = device_ms(kern, reps=20) if retake < 2 else None
        plain_ms = cuda_ms(plain, reps=3)
        library_ms = cuda_ms(libcall, reps=5) if libcall else None
        library_dev_ms = device_ms(libcall, reps=5) if libcall else None
        rows[name] = dict(
            ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
            library_ms=library_ms, library_device_ms=library_dev_ms,
            bound_ms=bound_ms,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
        )
        lib = (f"{library_ms:.4f} ms (device {fmt_ms(library_dev_ms)})"
               if library_ms is not None else "—")
        share = (f" = {100 * bound_ms / dev_ms:.1f}% of bound by device "
                 "time" if dev_ms else "")
        print(f"time {name} {shape}: {ms:.4f} ms, device "
              f"{fmt_ms(dev_ms)}, bound {bound_ms:.4f} ms "
              f"({rows[name]['bound_by']}, {nbytes / 1e9:.3f} GB), "
              f"{nbytes / ms / 1e6:.1f} GB/s = "
              f"{100 * bound_ms / ms:.1f}% of bound{share}; plain "
              f"{plain_ms:.3f} ms; library {lib}")


def time_kernels(params, state, rate, rows):
    """The LINEAR kernels' device time at the 511³ level-0 shape, their
    bound, their plain version's time and a PyTorch call computing the
    same function."""
    import torch
    import torch.nn.functional as F

    from gpusolve_tpu_torch.ops import kernels as K

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dims = BIG
    cdims = params.level_dims()[1]
    h = params.level_h(0)
    lvl0, lvl1 = state.levels[0], state.levels[1]
    v, f = lvl0.v, lvl0.f
    r = torch.zeros_like(v)
    out = torch.zeros_like(v)
    fc, vc = torch.zeros_like(lvl1.f), lvl1.v.clone()
    n, cn = inner(dims), inner(cdims)
    ntaps = len(params.stencil.values)
    parts = K.residual(None, v, f, dims, params, h, write_r=False,
                       with_norm=True)
    ss = v.new_empty(1)
    # The flags finalize is timed with: no allocation or fill in the call.
    live = torch.zeros(1, dtype=torch.int32, device=DEVICE)
    stopped = torch.ones(1, dtype=torch.int32, device=DEVICE)
    taps_w = stencil_filter(params, 1.0 / (h * h))
    restrict_w = trilinear_filter(0.125)
    prolong_w = trilinear_filter(1.0)
    v5 = v[None, None]
    vc5 = vc[None, None]
    r5 = r[None, None]
    s = "511^3"
    cases = {
        # name: (kernel, plain, library, bytes, flops, shape)
        "residual": (
            lambda: K.residual(r, v, f, dims, params, h),
            lambda: K.residual_plain(r, v, f, dims, params, h),
            lambda: F.conv3d(v5, taps_w),
            kernel_bytes("residual", dims), (2 * ntaps + 1) * n, s,
        ),
        "finalize": (
            lambda: K.finalize(parts, ss, done=live),
            lambda: K.finalize_plain(parts, ss),
            lambda: torch.sum(parts),
            8 * parts.numel() + 4, parts.numel(), s,
        ),
        "jacobi_sweep": (
            lambda: K.jacobi_sweep(out, v, f, dims, params, h),
            lambda: K.jacobi_sweep_plain(out, v, f, dims, params, h),
            lambda: F.conv3d(v5, taps_w),
            kernel_bytes("jacobi_sweep", dims), (2 * ntaps + 4) * n, s,
        ),
        "restrict_zero": (
            lambda: K.restrict_zero(fc, vc, r, dims, cdims),
            lambda: K.restrict_zero_plain(fc, vc, r, dims, cdims),
            lambda: F.conv3d(r5, restrict_w, stride=2),
            kernel_bytes("restrict_zero", dims, cdims), 53 * cn, s,
        ),
        "prolong_add": (
            lambda: K.prolong_add(out, vc, dims, cdims),
            lambda: K.prolong_add_plain(out, vc, dims, cdims),
            lambda: F.conv_transpose3d(vc5, prolong_w, stride=2),
            kernel_bytes("prolong_add", dims, cdims), 11.5 * n, s,
        ),
    }
    time_cases(cases, rate, rows)
    floor = lambda: K.finalize(parts, ss, done=stopped)
    fin = rows["finalize"]
    print(f"time finalize 511^3 (n={parts.numel()}): device "
          f"{fmt_ms(fin['device_ms'])} (target 0.0030 ms), launch floor "
          f"(done set, the kernel returns at once) device "
          f"{fmt_ms(device_ms(floor))}, events {cuda_ms(floor, 20):.4f} "
          f"ms; torch.sum device {fmt_ms(fin['library_device_ms'])}")
    norm_only = cuda_ms(
        lambda: K.residual(None, v, f, dims, params, h, write_r=False,
                           with_norm=True), reps=20)
    norm_bytes = kernel_bytes("residual", dims) - 4 * n  # r not written
    print(f"time residual norm-only 511^3: {norm_only:.4f} ms, bound "
          f"{norm_bytes / rate * 1e3:.4f} ms")
    from gpusolve_tpu_torch.utils import tuning

    name = torch.cuda.get_device_name(0)
    ceiling = tuning.probe_ceiling_gbps(refresh=True)
    check(ceiling is not None and ceiling > 0, "no measured ceiling")
    print(f"tuning: {name}: row {tuning.for_kind(name)} (a row of its own: "
          f"{tuning.known_kind(name)}); probe_ceiling_gbps(refresh=True) "
          f"{ceiling:.1f} GB/s (stream ceiling: CUDA events over "
          f"{tuning.PROBE_REPS} copies of one padded 511^3 float32 field), "
          f"{100 * ceiling / tuning.for_kind(name).peak_hbm_gbps:.1f} % of "
          f"the row's peak")


def time_mode_kernels(fas_params, fas_state, newton_params, newton_state,
                      rate, rows):
    """The FAS and Newton kernels at the largest shapes the main paths
    give them: the mode-templated ones and restrict at the 511³ level 0,
    apply_fas and subtract at the 255³ level 1.  No single PyTorch call
    computes the nonlinear residual, sweep or operator (library —)."""
    import torch
    import torch.nn.functional as F

    from gpusolve_tpu_torch.ops import kernels as K

    dims = BIG
    cdims = fas_params.level_dims()[1]
    h, hc = fas_params.level_h(0), fas_params.level_h(1)
    l0, l1 = fas_state.levels[0], fas_state.levels[1]
    v, f = l0.v, l0.f
    nv = newton_state.levels[0].newton_v
    vn, fn = newton_state.levels[0].v, newton_state.levels[0].f
    r = torch.zeros_like(v)
    out = torch.zeros_like(v)
    fc, vc, rv = l1.f.clone(), l1.v.clone(), l1.rest_v.clone()
    n, cn = inner(dims), inner(cdims)
    taps = 2 * len(fas_params.stencil.values)
    restrict_w = trilinear_filter(0.125)
    v5 = v[None, None]
    diff = torch.empty_like(vc)
    s, sc = "511^3", "255^3"
    fp, np_ = fas_params, newton_params
    cases = {
        "residual_fas": (
            lambda: K.residual(r, v, f, dims, fp, h),
            lambda: K.residual_plain(r, v, f, dims, fp, h),
            None, kernel_bytes("residual_fas", dims),
            (taps + 4 + EXP_OPS) * n, s,
        ),
        "residual_newton": (
            lambda: K.residual(r, vn, fn, dims, np_, h, newton_v=nv),
            lambda: K.residual_plain(r, vn, fn, dims, np_, h, newton_v=nv),
            None, kernel_bytes("residual_newton", dims),
            (taps + 5 + EXP_OPS) * n, s,
        ),
        "jacobi_sweep_fas": (
            lambda: K.jacobi_sweep(out, v, f, dims, fp, h),
            lambda: K.jacobi_sweep_plain(out, v, f, dims, fp, h),
            None, kernel_bytes("jacobi_sweep_fas", dims),
            (taps + 10 + EXP_OPS) * n, s,
        ),
        "jacobi_sweep_newton": (
            lambda: K.jacobi_sweep(out, vn, fn, dims, np_, h, newton_v=nv),
            lambda: K.jacobi_sweep_plain(out, vn, fn, dims, np_, h,
                                         newton_v=nv),
            None, kernel_bytes("jacobi_sweep_newton", dims),
            (taps + 9 + EXP_OPS) * n, s,
        ),
        "restrict": (
            lambda: K.restrict(vc, v, dims, cdims, out2=rv),
            lambda: K.restrict_plain(vc, v, dims, cdims, out2=rv),
            lambda: F.conv3d(v5, restrict_w, stride=2),
            kernel_bytes("restrict", dims, cdims), 53 * cn, s,
        ),
        "apply_fas": (
            lambda: K.apply_fas(fc, vc, cdims, fp, hc),
            lambda: K.apply_fas_plain(fc, vc, cdims, fp, hc),
            None, kernel_bytes("apply_fas", cdims),
            (taps + 4 + EXP_OPS) * cn, sc,
        ),
        "subtract": (
            lambda: K.subtract(vc, rv, cdims),
            lambda: K.subtract_plain(vc, rv, cdims),
            lambda: torch.sub(vc, rv, out=diff),
            kernel_bytes("subtract", cdims), cn, sc,
        ),
    }
    time_cases(cases, rate, rows)
    sub = rows["subtract"]
    dev = sub["device_ms"]
    share = f"{100 * sub['bound_ms'] / dev:.1f}%" if dev else "not measured"
    print(f"time subtract 255^3: device {fmt_ms(dev)} = {share} of the "
          f"{sub['bound_ms']:.4f} ms bound (target >= 80%, <= "
          f"{sub['bound_ms'] / 0.8:.4f} ms); torch.sub(out=) device "
          f"{fmt_ms(sub['library_device_ms'])}")


def time_newton_kernels(params, state, rate, rows):
    """The batched Newton loop's kernels at the shapes its 511³ main path
    gives them: finalize_dev_thr on the 511³ residual's partials,
    newton_zero and newton_update on the 511³ level 0 (v after 3 inner
    cycles, in the second of two buffers), newton_gate's step; each with
    its flag clear, so it does its work every call."""
    import torch

    from gpusolve_tpu_torch.ops import kernels as K

    dims = BIG
    h = params.level_h(0)
    lvl0 = state.levels[0]
    n = inner(dims)
    parts = K.residual(None, lvl0.newton_v, lvl0.f, dims, params, h,
                       write_r=False, with_norm=True,
                       newton_v=lvl0.newton_v)
    ss = torch.empty(1, device=DEVICE)
    thr = torch.full((1,), -1.0, device=DEVICE)
    live = torch.zeros(1, dtype=torch.int32, device=DEVICE)
    idone = torch.zeros(1, dtype=torch.int32, device=DEVICE)
    v, nv = lvl0.v.clone(), lvl0.newton_v.clone()
    vb = torch.zeros_like(v)
    v_after = [vb if c % 2 else v for c in range(11)]
    norms = torch.full((10,), -1.0, device=DEVICE)
    norms[:3] = 1.0
    nv_int, v_int = nv[1:-1, 1:-1, 1:-1], vb[1:-1, 1:-1, 1:-1]
    gss = torch.full((1,), 4.0, device=DEVICE)
    res, thr_in = torch.empty(1, device=DEVICE), torch.empty(1, device=DEVICE)
    s = "511^3"
    cases = {
        # name: (kernel, plain, library, bytes, flops, shape)
        "finalize_dev_thr": (
            lambda: K.finalize_dev_thr(parts, ss, thr, live),
            lambda: K.finalize_dev_thr_plain(parts, ss, thr, live),
            lambda: torch.sum(parts),
            8 * parts.numel() + 8, parts.numel(), s,
        ),
        "newton_zero": (
            lambda: K.newton_zero(v, dims, live),
            lambda: K.newton_zero_plain(v, dims, live),
            lambda: v[1:-1, 1:-1, 1:-1].zero_(),
            4 * n, 0, s,
        ),
        "newton_update": (
            lambda: K.newton_update(nv, v_after, norms, dims, live),
            lambda: K.newton_update_plain(nv, v_after, norms, dims, live),
            lambda: nv_int.add_(v_int),
            12 * n + 40, n, s,
        ),
        # thr_outer −1: the flags stay clear, so every call does its work.
        "newton_gate": (
            lambda: K.newton_gate(gss, 0.0, -1.0, res, live, idone, thr_in),
            lambda: K.newton_gate_plain(gss, 0.0, -1.0, res, live, idone,
                                        thr_in),
            None, 24, 6, "one word",
        ),
    }
    time_cases(cases, rate, rows)
    check(int(live.item()) == 0, "a timed Newton kernel set its flag")


def device_events(prof):
    """(event, device µs) of each kernel or copy on the card, by name; the
    host ops that launched them (aten::…) carry the same device time and
    are left out, so nothing is counted twice, and so are Traced's
    fillers."""
    from torch.autograd import DeviceType

    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if (dev_us > 0 and getattr(ev, "device_type", None) != DeviceType.CPU
                and "spin_kernel" not in ev.key):
            yield ev, dev_us


def profile_rows(prof, per, what):
    rows = []
    for ev, dev_us in device_events(prof):
        rows.append((dev_us, ev.count, ev.key[:70]))
    rows.sort(reverse=True)
    for dev_us, count, key in rows:
        print(f"profile {what} {key}: {dev_us / 1e3 / per:.3f} ms/{what} "
              f"({count / per:g} launches/{what})")
    return sum(r[0] for r in rows) / 1e3, bool(rows)


def cycle_bytes(params):
    """Bytes one cycle of the per-op structure moves: kernel_bytes of
    every launch launches_per_cycle counts, level by level, and the final
    norm-only residual."""
    from gpusolve_tpu_torch.config import Mode
    from gpusolve_tpu_torch.ops import kernels as K
    from gpusolve_tpu_torch.ops.vcycle_batch import level_visits

    dims = params.level_dims()
    visits = level_visits(len(dims), params.cycle_type)
    sweeps = params.pre_smoothing + params.post_smoothing
    res = K.variant("residual", params.mode)
    jac = K.variant("jacobi_sweep", params.mode)
    total = 0
    for i, d in enumerate(dims):
        per = sweeps * kernel_bytes(jac, d)
        if i + 1 < len(dims):
            c = dims[i + 1]
            per += (kernel_bytes(res, d)
                    + kernel_bytes("prolong_add", d, c))
            if params.mode == Mode.NONLINEAR:
                per += (kernel_bytes("restrict", d, c, outputs=1)
                        + kernel_bytes("restrict", d, c)
                        + kernel_bytes("apply_fas", c)
                        + kernel_bytes("subtract", c))
            else:
                per += kernel_bytes("restrict_zero", d, c)
        total += visits[i] * per
    return total + kernel_bytes(res, dims[0]) - 4 * inner(dims[0])


def fused_cycle_bytes(params):
    """The least bytes a LINEAR cycle with each leg fused into one pass
    moves (the TPU kernel's wavefront, ROADMAP's first perf item), counted
    as kernel_bytes counts: per visit of a non-coarsest level a down pass
    reads v (with halo) and f and writes v and the coarse f, an up pass
    reads v (with halo), f and the coarse v (with halo) and writes v (the
    finest norm folded in); the coarsest reads v and f and writes v."""
    from gpusolve_tpu_torch.ops.vcycle_batch import level_visits

    dims = params.level_dims()
    visits = level_visits(len(dims), params.cycle_type)
    total = 0
    for i, d in enumerate(dims):
        leg = padded(d) + 2 * inner(d)
        if i + 1 < len(dims):
            c = dims[i + 1]
            total += visits[i] * (2 * leg + inner(c) + padded(c))
        else:
            total += visits[i] * leg
    return 4 * total


def time_cycles(params, state, rate, label):
    import torch

    from gpusolve_tpu_torch.ops import vcycle_batch

    k = 10
    vcycle_batch.run(state, params, maxk=2)  # warm
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    exact_walks()
    t0 = time.perf_counter()
    a.record()
    vcycle_batch.run(state, params, maxk=k)
    b.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / k
    dev = a.elapsed_time(b) / k
    walks = exact_walks() / k
    nbytes = cycle_bytes(params)
    print(f"cycle {label}: {dev:.3f} ms/cycle device (CUDA events over "
          f"a {k}-cycle batch), {wall:.3f} ms/cycle wall; "
          f"{nbytes / 1e9:.3f} GB/cycle -> {nbytes / dev / 1e6:.1f} GB/s, "
          f"bound {nbytes / rate * 1e3:.3f} ms/cycle; {walks:g} leg blocks "
          "a cycle on the exact walk")
    if label.startswith("511^3 LINEAR"):
        fused = fused_cycle_bytes(params)
        print(f"cycle 511^3 fused-leg bound: {fused / 1e9:.3f} GB/cycle -> "
              f"{fused / rate * 1e3:.3f} ms/cycle")

    with Traced() as prof:
        t0 = time.perf_counter()
        vcycle_batch.run(state, params, maxk=k)
        torch.cuda.synchronize()
        wall_p = (time.perf_counter() - t0) * 1e3
    busy, any_rows = profile_rows(prof, k, "cycle")
    if any_rows:
        print(f"profile {label} busy {busy / k:.3f} ms/cycle of "
              f"{wall_p / k:.3f} wall -> idle share {1 - busy / wall_p:.3f}")
    else:
        print("profile: no device time recorded (not measured)")
    return dev, (busy / k if any_rows else None)


def fused_leg_bytes(name, dims, cdims):
    """Bytes a leg must move (kernel_bytes' rule): the down leg reads v
    with its halo, f (and ũ), writes v and the coarse f and v (FAS also
    rest_v); the up leg reads v with its halo, f (and ũ) and the coarse v
    with its halo, writes v (the norm's partials are a few KB)."""
    n, pad, cn = inner(dims), padded(dims), inner(cdims)
    extra = n if name.endswith("_newton") else 0
    if name.startswith("down_leg"):
        return 4 * (pad + 2 * n + extra
                    + (3 if name.endswith("_fas") else 2) * cn)
    return 4 * (pad + 2 * n + extra + padded(cdims))


def leg_plan(down, dims, S):
    """mg_leg_plan: hy, ty, hz, tz, L, gx, gy, gz and the shared bytes of
    a leg over ``dims`` at S sweeps."""
    import ctypes

    from gpusolve_tpu_torch.ops import kernels as K

    plan = (ctypes.c_int * 9)()
    K._check_rc(K.lib().mg_leg_plan(int(down), *dims, S, plan),
                "mg_leg_plan")
    return list(plan)


def per_op_visit(p, S, dims, cdims, h, v, f, nv, fc, vc, rest, cv, norm):
    """The per-op kernels of one level visit as two functions: the down
    half (S sweeps, the residual, its restriction(s) into fc, vc, rest)
    and the up half (prolong_add of cv, S sweeps, with ``norm`` the
    norm-only residual).  Each works on its own copy of v, made here: the
    sweeps ping-pong it with a scratch field and the prolongation adds
    into it in place, as the cycle does, so v stays as it was and a
    repeated call walks on from what the last one left."""
    import torch

    from gpusolve_tpu_torch.config import Mode
    from gpusolve_tpu_torch.ops import kernels as K

    fas = p.mode == Mode.NONLINEAR
    work, out = v.clone(), torch.empty_like(v)
    spare, out2 = v.clone(), torch.empty_like(v)

    def down():
        a, b = work, out
        for _ in range(S):
            K.jacobi_sweep(b, a, f, dims, p, h, None, nv)
            a, b = b, a
        K.residual(b, a, f, dims, p, h, newton_v=nv)
        if fas:
            K.restrict(fc, b, dims, cdims)
            K.restrict(vc, a, dims, cdims, out2=rest)
        else:
            K.restrict_zero(fc, vc, b, dims, cdims)

    def up():
        K.prolong_add(spare, cv, dims, cdims)
        a, b = spare, out2
        for _ in range(S):
            K.jacobi_sweep(b, a, f, dims, p, h, None, nv)
            a, b = b, a
        if norm:
            K.residual(None, a, f, dims, p, h, write_r=False,
                       with_norm=True, newton_v=nv)

    return down, up


def time_legs(params_by_mode, states, rate, rows):
    """Each leg at the 511³ level 0 (S = 3, the main paths' V(3,3)): its
    event and device ms beside its bound and its plain version's ms
    (time_cases), and the per-op kernels for the same work, by events and
    by device time (per_op_visit: the down leg's 3 sweeps, residual and
    restriction(s), the up leg's prolongation, 3 sweeps and norm-only
    residual)."""
    import torch

    from gpusolve_tpu_torch.config import Mode
    from gpusolve_tpu_torch.ops import kernels as K

    dims = BIG
    for down, name in ((1, "down"), (0, "up")):
        hy, ty, hz, tz, L, gx, gy, gz, smem = leg_plan(down, dims, 3)
        print(f"leg plan 511^3 S=3 {name}: a block's tile {ty} (y) x {tz} "
              f"(z) of its extended tile (halo {hy} / {hz} below), x "
              f"chunks of {L} planes, grid {gx} x {gy} x {gz} = "
              f"{gx * gy * gz} blocks, {smem} bytes of shared memory")
    for mode, p in params_by_mode.items():
        state = states[mode]
        cdims = p.level_dims()[1]
        h = p.level_h(0)
        lvl0, lvl1 = state.levels[0], state.levels[1]
        v, f = lvl0.v, lvl0.f
        nv = lvl0.newton_v if mode == Mode.NEWTON else None
        out = torch.empty_like(v)
        fc, vc, rest = lvl1.f.clone(), lvl1.v.clone(), lvl1.v.clone()
        fas = mode == Mode.NONLINEAR
        S = p.pre_smoothing
        dn, up = K.variant("down_leg", mode), K.variant("up_leg", mode)
        ntaps = len(p.stencil.values)
        n = inner(dims)
        point = 2 * ntaps + 4 + (EXP_OPS + 8 if mode != Mode.LINEAR else 0)
        cases = {
            dn: (
                lambda: K.down_leg(out, v, f, fc, vc, dims, cdims, p, h, S,
                                   None, nv, rest if fas else None),
                lambda: K.down_leg_plain(out, v, f, fc, vc, dims, cdims, p,
                                         h, S, None, nv,
                                         rest if fas else None),
                None, fused_leg_bytes(dn, dims, cdims),
                ((S + 1) * point + 7) * n, "511^3 S=3",
            ),
            up: (
                lambda: K.up_leg(out, v, lvl1.v, f, dims, cdims, p, h, S,
                                 None, nv, with_norm=True),
                lambda: K.up_leg_plain(out, v, lvl1.v, f, dims, cdims, p, h,
                                       S, None, nv, with_norm=True),
                None, fused_leg_bytes(up, dims, cdims),
                ((S + 1) * point + 12) * n, "511^3 S=3",
            ),
        }
        time_cases(cases, rate, rows)

        per_op = per_op_visit(p, S, dims, cdims, h, v, f, nv, fc, vc,
                              rest if fas else None, lvl1.v, True)
        for name, fn in zip((dn, up), per_op):
            ev, dev = cuda_ms(fn, reps=5), device_ms(fn, reps=5)
            row = rows[name]
            share = (f", {100 * row['bound_ms'] / row['device_ms']:.1f}% "
                     "of its bound" if row["device_ms"] else "")
            print(f"time {name} 511^3 S=3 vs the per-op kernels for the "
                  f"same work: leg {fmt_ms(row['device_ms'])} "
                  f"device{share} (target >= 35%), per-op {ev:.4f} ms "
                  f"events, {fmt_ms(dev)} device "
                  f"-> {dev / row['device_ms'] if dev and row['device_ms'] else float('nan'):.2f}x")
        del out, fc, vc, rest, per_op
        torch.cuda.empty_cache()


def time_leg_levels(params, state, label):
    """Each non-coarsest level's visit on the legs (down_leg, up_leg)
    against its per-op visit (per_op_visit), device ms, on the state's
    fields as a cycle meets them (a LINEAR or NEWTON coarse level's v
    zero; apply_fas and subtract, the same in both, left out), with the
    blocks of each leg that took the exact walk; and the sums over the
    levels below 0."""
    import torch

    from gpusolve_tpu_torch.config import Mode
    from gpusolve_tpu_torch.ops import kernels as K

    fas = params.mode == Mode.NONLINEAR
    S = params.pre_smoothing
    all_dims = params.level_dims()
    below = [0.0, 0.0]
    for i in range(params.num_levels - 1):
        lvl, nxt = state.levels[i], state.levels[i + 1]
        dims, cdims = all_dims[i], all_dims[i + 1]
        h = params.level_h(i)
        nv = lvl.newton_v if params.mode == Mode.NEWTON else None
        v = lvl.v if i == 0 or fas else torch.zeros_like(lvl.v)
        f, cv = lvl.f, nxt.v
        out = torch.empty_like(v)
        fc, vc = nxt.f.clone(), nxt.v.clone()
        rest = nxt.v.clone() if fas else None
        norm = i == 0

        def down_leg():
            K.down_leg(out, v, f, fc, vc, dims, cdims, params, h, S, None,
                       nv, rest)

        def up_leg():
            K.up_leg(out, v, cv, f, dims, cdims, params, h, S, None, nv,
                     with_norm=norm)

        def legs():
            down_leg()
            up_leg()

        per_op = per_op_visit(params, S, dims, cdims, h, v, f, nv, fc, vc,
                              rest, cv, norm)

        def per_op_both():
            per_op[0]()
            per_op[1]()

        exact_walks()
        down_leg()
        walks_down = exact_walks()
        up_leg()
        walks_up = exact_walks()
        blocks = [(lambda q: q[5] * q[6] * q[7])(leg_plan(d, dims, S))
                  for d in (1, 0)]
        leg_ms = device_ms(legs, reps=10)
        op_ms = device_ms(per_op_both, reps=10)
        ratio = op_ms / leg_ms if leg_ms and op_ms else float("nan")
        print(f"level {i} {dims} {label}: legs {fmt_ms(leg_ms)} device, "
              f"per-op visit {fmt_ms(op_ms)} -> {ratio:.2f}x; blocks on "
              f"the exact walk: down {walks_down} of {blocks[0]}, up "
              f"{walks_up} of {blocks[1]}")
        if i > 0 and leg_ms and op_ms:
            below[0] += leg_ms
            below[1] += op_ms
        del out, fc, vc, rest, per_op
    print(f"levels 1..{params.num_levels - 2} {label}: legs {below[0]:.4f} "
          f"ms device, per-op visits {below[1]:.4f} ms")
    torch.cuda.empty_cache()


def time_cycle_schedules(params, state, rate, label):
    """The V(3,3) cycle on the legs and on the per-op schedule, in turns
    (legs, per-op, per-op, legs): events and busy ms a cycle, launches a
    cycle, idle share (time_cycles)."""
    from gpusolve_tpu_torch.ops import vcycle_batch

    out = {"legs": [], "per-op": []}
    for sched in ("legs", "per-op", "per-op", "legs"):
        ctx = per_op_schedule() if sched == "per-op" else \
            contextlib.nullcontext()
        with ctx:
            launches = sum(vcycle_batch.launches_per_cycle(params).values())
            dev, busy = time_cycles(params, state, rate,
                                    f"{label} ({sched}, run "
                                    f"{len(out[sched]) + 1})")
        out[sched].append((dev, busy))
        print(f"cycle {label} {sched}: {launches} launches a cycle")
    for i in range(2):
        (dl, bl), (dp, bp) = out["legs"][i], out["per-op"][i]
        print(f"cycle {label} legs vs per-op (pair {i + 1}): events "
              f"{dl:.3f} vs {dp:.3f} ms, busy {fmt_ms(bl)} vs {fmt_ms(bp)}"
              f" -> {dp / dl:.2f}x by events")
        if bl is not None and bp is not None:
            print(f"cycle {label}: legs less busy than the per-op schedule "
                  f"(pair {i + 1}): {bl < bp} ({bl:.3f} vs {bp:.3f} ms)")
    return out


def time_newton_steps(params, steps=3):
    """Both outer Newton loops in one call, in turns (per-step, batched,
    batched, per-step): ms a step by CUDA events around gt.newton_solve
    from a fresh 511³ state with maxiter ``steps`` (the initial F
    included), wall ms and host reads a solve, in two runs of each; then a
    profiled run of each, whose kernels' device time is the busy time and
    whose idle share is 1 − busy / wall.  The batched loop runs
    check_every=10 (one batch of ``steps`` steps).  Returns the event ms a
    step of each run and the busy ms a step, by loop."""
    import torch

    import gpusolve_tpu_torch as gt
    from gpusolve_tpu_torch.ops import vcycle_batch

    p = params.replace(maxiter=steps, print_progress=False)
    loops = {"per-step": 1, "batched": 10}

    def run(k, window=contextlib.nullcontext()):
        state = gt.build_grid(p)
        torch.cuda.synchronize()
        inner.clear()
        reads0 = vcycle_batch.host_reads
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        with window:
            t0 = time.perf_counter()
            a.record()
            _, hist = gt.newton_solve(state, p, check_every=k)
            b.record()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        check(len(hist) == steps + 1, f"newton timing ran {hist}")
        return (a.elapsed_time(b), wall, hist, list(inner),
                vcycle_batch.host_reads - reads0)

    events = {name: [] for name in loops}
    busy = {}
    with counting_inner() as inner:
        for k in loops.values():
            run(k)  # warm
        for n, name in enumerate(("per-step", "batched", "batched",
                                  "per-step")):
            dev, wall, hist, steps_inner, reads = run(loops[name])
            events[name].append(dev / steps)
            print(f"newton step 511^3 {name} loop (run "
                  f"{len(events[name])}): {dev / steps:.3f} ms/step "
                  f"(CUDA events around newton_solve, {steps} steps, the "
                  f"initial F included), {wall / steps:.3f} ms/step wall; "
                  f"{reads} host reads a solve; inner cycles per step "
                  f"{steps_inner}; history {hist}")
        for name, k in loops.items():
            window = Traced()
            _, wall_p, _, _, _ = run(k, window)
            b_ms, any_rows = profile_rows(window.prof, steps,
                                          f"step ({name})")
            if not any_rows:
                print(f"profile newton {name}: no device time recorded "
                      "(not measured)")
                continue
            busy[name] = b_ms / steps
            print(f"profile newton {name} loop busy {b_ms / steps:.3f} "
                  f"ms/step of {wall_p / steps:.3f} wall -> idle share "
                  f"{1 - b_ms / wall_p:.3f}")
    for name in loops:
        if name in busy:
            over = [e / busy[name] - 1 for e in events[name]]
            print(f"newton step 511^3 {name} loop: events over busy "
                  f"{', '.join(f'{100 * o:+.1f}%' for o in over)} (the "
                  f"exit criterion: within 10% in two runs in a row: "
                  f"{all(abs(o) <= 0.10 for o in over)})")
    return events, busy


def v1_cycle_bytes(params):
    """Bytes one v1 cycle must move, op by op of its schedule, counted as
    kernel_bytes counts: a zero-start sweep reads f (and ũ) and writes v;
    RESTRICT_V writes two coarse fields; FAS_F reads the fine box and
    rest_v with its halo and writes f; the FAS prolongation reads rest_v
    with its halo as well; ZERO writes one field; the final residual
    writes no r.  The 8-byte partial of each level-0 tile is left out, as
    cycle_bytes leaves it out."""
    from gpusolve_tpu_torch.config import Mode
    from gpusolve_tpu_torch.ops import kernels as K
    from gpusolve_tpu_torch.ops import vcycle_fused as vf

    dims = params.level_dims()
    res = K.variant("residual", params.mode)
    jac = K.variant("jacobi_sweep", params.mode)
    fields = 3 if params.mode == Mode.NEWTON else 2
    ops, _ = vf.schedule(len(dims), params.mode, params.pre_smoothing,
                         params.post_smoothing)
    total = 0
    for kind, lvl, _, _ in ops:
        d = dims[lvl]
        n = inner(d)
        if kind == vf.ZERO:
            total += 4 * n
        elif kind == vf.SMOOTH0:
            total += 4 * fields * n
        elif kind == vf.SMOOTH:
            total += kernel_bytes(jac, d)
        elif kind == vf.RESIDUAL:
            total += kernel_bytes(res, d)
        elif kind in (vf.RESTRICT, vf.RESTRICT_V, vf.FAS_F):
            c = dims[lvl + 1]
            total += kernel_bytes("restrict", d, c,
                                  outputs=2 if kind == vf.RESTRICT_V else 1)
            if kind == vf.FAS_F:
                total += 4 * padded(c)
        elif kind == vf.PROLONG:
            total += kernel_bytes("prolong_add", dims[lvl - 1], d)
            if params.mode == Mode.NONLINEAR:
                total += 4 * padded(d)
        elif kind == vf.NORM:
            total += kernel_bytes(res, d) - 4 * n
    return total


def v1_op_times(p, state, rows):
    """Inside the cooperative kernel at 511³, in p's mode: ms per op of
    each kind on level 0 (ten of one kind in one launch, a grid barrier
    after each) beside the per-op kernel of the same mode computing the
    same function (the restriction: ``restrict`` with one output, as v1
    writes only f; ``restrict_zero``, the batch engine's, beside it; the
    FAS prolongation also subtracts rest_v, which ``subtract`` does apart
    in the batch engine), and the ratio; the coarse tail (the cycle's ops
    from the restriction into the tail level down and back, on block 0
    with a block barrier between them) beside the same ops on the whole
    grid with a grid barrier after each, by device time; a bare op and
    barrier (a hundred ZERO ops on the 1³ coarsest level, one tile
    each)."""
    import torch

    from gpusolve_tpu_torch.config import Mode
    from gpusolve_tpu_torch.ops import kernels as K
    from gpusolve_tpu_torch.ops import vcycle_fused as vf

    def per(ops_list):
        ops = torch.tensor(ops_list, dtype=torch.int32, device=DEVICE)
        return cuda_ms(lambda: vf.launch(state.levels, p, ops),
                       reps=3) / len(ops_list)

    def tail_us(ops_list, on_block):
        # Device time: a launch of the tail's few-tile ops takes less on
        # the card than the wrapper takes on the host, so events would
        # time the host.
        ops = torch.tensor(ops_list, dtype=torch.int32, device=DEVICE)
        rng = (0, len(ops_list)) if on_block else (0, 0)
        ms = device_ms(lambda: vf.launch(state.levels, p, ops, rng))
        return None if ms is None else ms * 1e3

    mode = Mode(p.mode)
    dims, cdims = BIG, p.level_dims()[1]
    lvl0, lvl1 = state.levels[0], state.levels[1]
    h = p.level_h(0)
    nv = {"newton_v": lvl0.newton_v} if mode == Mode.NEWTON else {}
    fc = torch.zeros_like(lvl1.f)
    norm_alone = cuda_ms(
        lambda: K.residual(None, lvl0.v, lvl0.f, dims, p, h, write_r=False,
                           with_norm=True, **nv), reps=20)
    restrict_alone = cuda_ms(
        lambda: K.restrict(fc, lvl0.r, dims, cdims), reps=20)
    kinds = {
        "sweep": ([(vf.SMOOTH, 0, k % 2, 1 - k % 2) for k in range(10)],
                  rows[K.variant("jacobi_sweep", mode)]["ms"]),
        "residual": ([(vf.RESIDUAL, 0, 0, 1)] * 10,
                     rows[K.variant("residual", mode)]["ms"]),
        "norm-only residual": ([(vf.NORM, 0, 0, 0)] * 10, norm_alone),
        "restriction": ([(vf.RESTRICT, 0, 1, 0)] * 10, restrict_alone),
        "prolongation": ([(vf.PROLONG, 1, 0, k % 2) for k in range(10)],
                         rows["prolong_add"]["ms"]),
    }
    parts = []
    for label, (ops_list, alone) in kinds.items():
        ms = per(ops_list)
        parts.append(f"{label} {ms:.4f} (per-op kernel {alone:.4f}, "
                     f"{ms / alone:.3f}x)")
    split = vf.tail_level(p.level_dims())
    ops, _, (begin, end) = vf._schedule_for(p)
    tail_ops = list(ops[begin:end])
    on_block, on_grid = tail_us(tail_ops, True), tail_us(tail_ops, False)
    barrier = per([(vf.ZERO, p.num_levels - 1, 0, 0)] * 100)
    print(f"v1 ops at 511^3 {mode.name}, ms per level-0 op with its "
          f"barrier: {'; '.join(parts)}; restrict_zero "
          f"{rows['restrict_zero']['ms']:.4f}; the coarse tail from level "
          f"{split} ({'x'.join(map(str, p.level_dims()[split]))}, "
          f"{len(tail_ops)} ops, device time with the launch's counter "
          f"fill) {fmt_us(on_block)} on block 0, {fmt_us(on_grid)} on the "
          f"grid; a bare op and grid barrier {barrier * 1e3:.2f} us")


def time_v1(base, rate, rows):
    """The v1 kernel's device ms per cycle at 511³, V(3,3) and V(6,6) in
    the three modes (10 back-to-back launches between CUDA events), beside
    the batch engine's at the same configuration (a 10-cycle batch); the
    bytes and bounds of both; a V(6,6) LINEAR solve's wall per cycle (one
    host sync a cycle) with its profiler idle share; one op with its grid
    barrier (a 15³ V(6,6) cycle over its ops); the plain version's time.
    Fills rows["vcycle_fused"] from the V(6,6) LINEAR numbers, the main
    path's configuration.  Returns the batch engine's V(6,6) ms a cycle by
    mode."""
    import torch

    import gpusolve_tpu_torch as gt
    from gpusolve_tpu_torch.config import Mode
    from gpusolve_tpu_torch.ops import vcycle_batch
    from gpusolve_tpu_torch.ops import vcycle_fused as vf
    from gpusolve_tpu_torch.ops.vcycle_batch import launches_per_cycle

    k = 10
    batch66 = {}
    for pre in (3, 6):
        for mode in Mode:
            p = base.replace(grid_dim=BIG, mode=mode, pre_smoothing=pre,
                             post_smoothing=pre, print_progress=False)
            state = seeded_state(p, 400)
            v1_ms = cuda_ms(lambda: vf.vcycle_fused(state.levels, p),
                            reps=k)
            batch_ms = cuda_ms(
                lambda: vcycle_batch.run(state, p, maxk=k), reps=1) / k
            if pre == 6:
                batch66[mode] = batch_ms
            b1, bb = v1_cycle_bytes(p), cycle_bytes(p)
            nops = len(vf.schedule(p.num_levels, mode, pre, pre)[0])
            launches = sum(launches_per_cycle(p).values())
            print(f"cycle v1 511^3 V({pre},{pre}) {mode.name}: "
                  f"{v1_ms:.3f} ms/cycle device, 1 launch, {nops} ops, "
                  f"{b1 / 1e9:.3f} GB -> per-op schedule bound "
                  f"{b1 / rate * 1e3:.3f} ms "
                  f"({100 * b1 / rate * 1e3 / v1_ms:.1f}%); batch engine "
                  f"{batch_ms:.3f} ms/cycle, {launches} launches, "
                  f"{bb / 1e9:.3f} GB -> bound {bb / rate * 1e3:.3f} ms; "
                  f"v1/batch {v1_ms / batch_ms:.3f}")
            if pre == 6:
                v1_op_times(p, state, rows)
            if pre == 6 and mode == Mode.LINEAR:
                plain_ms = cuda_ms(
                    lambda: vf.vcycle_fused_plain(state.levels, p), reps=1)
                # The function is one whole V-cycle: its bound is the
                # least bytes such a cycle moves (each leg one pass), not
                # the sum over the per-op schedule v1 runs.
                bf = fused_cycle_bytes(p)
                v1_dev = device_ms(lambda: vf.vcycle_fused(state.levels, p),
                                   reps=3)
                rows["vcycle_fused"] = dict(
                    ms=v1_ms, device_ms=v1_dev, plain_ms=plain_ms,
                    library_ms=None, library_device_ms=None,
                    bound_ms=bf / rate * 1e3, bound_by="bytes",
                )
                print(f"time vcycle_fused 511^3 V(6,6) LINEAR: {v1_ms:.4f} "
                      f"ms, device {fmt_ms(v1_dev)}, bound "
                      f"{bf / rate * 1e3:.4f} ms (bytes, "
                      f"{bf / 1e9:.3f} GB, a fused-leg cycle; "
                      f"{100 * bf / rate * 1e3 / v1_ms:.1f}%), per-op "
                      f"schedule bound {b1 / rate * 1e3:.4f} ms "
                      f"({b1 / 1e9:.3f} GB); plain {plain_ms:.3f} ms; "
                      f"library —")
            del state
            torch.cuda.empty_cache()

    p = base.replace(grid_dim=BIG, pre_smoothing=6, post_smoothing=6,
                     maxiter=k, tol=1e-12, print_progress=False)
    state = gt.build_grid(p)
    gt.solve(state, p.replace(maxiter=1))  # warm
    with Traced() as prof:
        t0 = time.perf_counter()
        _, hist = gt.solve(state, p)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    check(len(hist) == k + 1, f"v1 solve ran {hist}")
    busy, any_rows = profile_rows(prof, k, "cycle")
    idle = f"idle share {1 - busy / wall:.3f}" if any_rows else \
        "idle share not measured"
    print(f"solve v1 511^3 V(6,6) LINEAR: {wall / k:.3f} ms/cycle wall "
          f"under the profiler (the initial residual included), busy "
          f"{busy / k:.3f} ms/cycle -> {idle}")
    del state
    torch.cuda.empty_cache()

    p = base.replace(grid_dim=(15, 15, 15), pre_smoothing=6,
                     post_smoothing=6, print_progress=False)
    state = gt.build_grid(p)
    nops = len(vf.schedule(p.num_levels, Mode.LINEAR, 6, 6)[0])
    ms = cuda_ms(lambda: vf.vcycle_fused(state.levels, p), reps=50)
    print(f"barrier: a 15^3 V(6,6) v1 cycle takes {ms * 1e3:.1f} us for "
          f"{nops} ops -> {ms * 1e3 / (nops - 1):.2f} us per op and grid "
          f"barrier (grid {vf.grid_blocks(p.mode)} blocks)")
    return batch66

# ---------------------------------------------------------------------------
# The distributed engine's shard-local kernels (ops/spmd_kernels.py)
# ---------------------------------------------------------------------------

def block_inputs(block, box, seed):
    """Seeded block fields on the card, zero outside the box (v at 0.05,
    f at 100, ũ at 0.3), and four random non-zero ghost faces."""
    import numpy as np
    import torch

    from gpusolve_tpu_torch.ops import spmd_kernels as SK

    rng = np.random.default_rng(seed)
    sl = SK.box_slices(box)

    def field(scale):
        a = torch.zeros(block, device=DEVICE)
        n = SK.box_dims(box)
        a[sl] = torch.from_numpy(
            rng.standard_normal(n, dtype=np.float32) * np.float32(scale)
        ).to(DEVICE)
        return a

    bx, by, bz = block
    faces = [
        torch.from_numpy(
            rng.standard_normal(s, dtype=np.float32) * np.float32(0.05)
        ).to(DEVICE)
        for s in ((by, bz), (by, bz), (bx, bz), (bx, bz))
    ]
    return field(0.05), field(100.0), field(0.3), faces


def check_block_kernels(base, rec):
    """Each shard-local kernel in each mode against its plain version on
    CUDA tensors: at the (1,1,1)-mesh 511³ level-0 block (640³, the box
    511³), the largest shape the main path gives them, and at small odd
    blocks whose boxes touch every x and y face, so the ghost faces are
    read; residual_restrict_block also with the taps reordered and with
    five taps.  Fields to rtol 1e-5 / atol 1e-5·max|plain|, Σr² to rel
    1e-5."""
    import numpy as np
    import torch

    from gpusolve_tpu_torch.config import Mode, Stencil
    from gpusolve_tpu_torch.dist.spmd import SpmdPlan
    from gpusolve_tpu_torch.ops import kernels as K
    from gpusolve_tpu_torch.ops import spmd_kernels as SK

    plan = SpmdPlan(base.replace(grid_dim=BIG), (1, 1, 1))
    cases = [
        ("511^3 level-0 block", plan.block[0], plan.box(0, (0, 0, 0)),
         plan.block[1][2], plan.dims[1][2]),
        ("odd block", (17, 13, 21), (0, 16, 0, 12, 1, 19), None, None),
        ("even-x block", (18, 13, 21), (0, 17, 0, 12, 1, 19), 11, 9),
    ]
    h = base.level_h(0)
    for n, (what, block, box, cbz, cnz) in enumerate(cases):
        v, f, nv, faces = block_inputs(block, box, 500 + n)
        tag = f"{'x'.join(map(str, block))} ({what})"
        lines = []
        for mode in Mode:
            p = base.replace(mode=mode, print_progress=False)
            nvm = nv if mode == Mode.NEWTON else None
            name = K.variant("sweep_block", mode)
            o_k, o_p = torch.zeros_like(v), torch.zeros_like(v)
            SK.sweep_block(o_k, v, f, faces, box, p, h, nvm)
            SK.sweep_block_plain(o_p, v, f, faces, box, p, h, nvm)
            lines.append(rec.close(o_k, o_p, f"{name} {tag}", name))
            name = K.variant("residual_block", mode)
            r_k, r_p = torch.zeros_like(v), torch.zeros_like(v)
            pk = SK.residual_block(r_k, v, f, faces, box, p, h,
                                   with_norm=True, newton_v=nvm)
            pp = SK.residual_block_plain(r_p, v, f, faces, box, p, h,
                                         with_norm=True, newton_v=nvm)
            ss_k, ss_p = v.new_empty(1), v.new_empty(1)
            K.finalize(pk, ss_k)
            K.finalize_plain(pp, ss_p)
            lines.append(rec.close(r_k, r_p, f"{name} {tag}", name))
            lines.append(rec.scalar(float(ss_k), float(ss_p),
                                    f"{name} sum r^2 {tag}", name))
            pn = SK.residual_block(None, v, f, faces, box, p, h,
                                   write_r=False, with_norm=True,
                                   newton_v=nvm)
            check(torch.equal(pn, pk), f"{name} norm-only partials {tag}")
            if cbz is None:
                continue
            # The restriction with the canonical taps, then with the taps
            # reordered and with five taps (the kernel's generic-tap body).
            name = K.variant("residual_restrict_block", mode)
            cs = (block[0] // 2, block[1], cbz)
            for st in (None, *OTHER_TAPS):
                pt = p if st is None else p.replace(
                    stencil=Stencil(*OTHER_TAPS[st]))
                outs_k = [torch.zeros(cs, device=DEVICE),
                          torch.zeros(cs[1:], device=DEVICE),
                          torch.zeros(cs, device=DEVICE)
                          if mode == Mode.NONLINEAR else None]
                outs_p = [None if t is None else t.clone() for t in outs_k]
                SK.residual_restrict_block(*outs_k, v, f, faces, box, pt, h,
                                           cnz, nvm)
                SK.residual_restrict_block_plain(*outs_p, v, f, faces, box,
                                                 pt, h, cnz, nvm)
                taps = "" if st is None else f" taps {st}"
                lines.append(rec.fields(
                    [t for t in outs_k if t is not None],
                    [t for t in outs_p if t is not None],
                    f"{name} {tag}{taps} (xzr, r_last_z"
                    f"{', xzv' if outs_k[2] is not None else ''})",
                    name,
                ))
        rng = np.random.default_rng(600 + n)
        czp = cbz if cbz else block[2] // 2 + 1
        casm = torch.from_numpy(rng.standard_normal(
            (block[0] // 2 + 2, block[1] // 2 + 2, czp), dtype=np.float32
        ) * np.float32(0.05)).to(DEVICE)
        v_k, v_p = v.clone(), v.clone()
        SK.prolong_add_block(v_k, casm, box)
        SK.prolong_add_block_plain(v_p, casm, box)
        lines.append(rec.close(v_k, v_p, f"prolong_add_block {tag}",
                               "prolong_add_block"))
        for line in lines:
            print(f"check {line}")
        del v, f, nv, faces, o_k, o_p, r_k, r_p, v_k, v_p
        torch.cuda.empty_cache()


def check_ghosts(base, rec):
    """The kernels with live neighbours: a 127³ field cut into the four
    blocks of a (2, 2, 1) plan, each run with faces carved from its
    neighbours, and the blocks put together again, against the
    single-device kernels on the whole field: sweep_block and
    residual_block against jacobi_sweep and residual, residual_restrict_block
    on each block against its plain version with the same faces, and with
    the engine's glue (lower-x fix-up, y restriction with the lower
    y neighbour's row, the coarse mask) against residual + restrict,
    prolong_add_block against prolong_add."""
    import itertools

    import numpy as np
    import torch

    from gpusolve_tpu_torch.config import Mode
    from gpusolve_tpu_torch.dist import spmd as tsp
    from gpusolve_tpu_torch.ops import kernels as K
    from gpusolve_tpu_torch.ops import spmd_kernels as SK

    dims = (127, 127, 127)
    p0 = base.replace(grid_dim=dims, print_progress=False)
    plan = tsp.SpmdPlan(p0, (2, 2, 1))
    cdims = plan.dims[1]
    (bx, by, bz), (cbx, cby, cbz) = plan.block[0], plan.block[1]
    h = p0.level_h(0)
    rng = np.random.default_rng(700)

    def glob(d, alloc, scale):
        g = torch.zeros(alloc, device=DEVICE)
        g[1:d[0] + 1, 1:d[1] + 1, 1:d[2] + 1] = torch.from_numpy(
            rng.standard_normal(d, dtype=np.float32) * np.float32(scale)
        ).to(DEVICE)
        return g

    def full(g, d):
        return g[:d[0] + 2, :d[1] + 2, :d[2] + 2].contiguous()

    gv, gf, gnv = (glob(dims, plan.alloc[0], s) for s in (0.05, 100, 0.3))
    gvc = glob(cdims, plan.alloc[1], 0.05)
    shards = list(itertools.product(range(2), range(2)))

    def blk(g, dx, dy, b=(bx, by)):
        return g[dx * b[0]:(dx + 1) * b[0],
                 dy * b[1]:(dy + 1) * b[1]].contiguous()

    def faces_of(g, dx, dy):
        z = torch.zeros
        xs = slice(dx * bx, (dx + 1) * bx)
        ys = slice(dy * by, (dy + 1) * by)
        return [
            g[dx * bx - 1, ys].contiguous() if dx else z((by, bz),
                                                          device=DEVICE),
            g[(dx + 1) * bx, ys].contiguous() if dx == 0 else
            z((by, bz), device=DEVICE),
            g[xs, dy * by - 1].contiguous() if dy else z((bx, bz),
                                                          device=DEVICE),
            g[xs, (dy + 1) * by].contiguous() if dy == 0 else
            z((bx, bz), device=DEVICE),
        ]

    def put(parts, alloc, b):
        g = torch.zeros(alloc, device=DEVICE)
        for (dx, dy), t in parts.items():
            g[dx * b[0]:(dx + 1) * b[0], dy * b[1]:(dy + 1) * b[1]] = t
        return g

    for mode in Mode:
        p = p0.replace(mode=mode)
        tag = f"127^3 on 4 carved (2,2,1) blocks {mode.name}"
        nvf = full(gnv, dims) if mode == Mode.NEWTON else None
        vf_, ff_ = full(gv, dims), full(gf, dims)
        sw, rs, ss, xz, xv, last = {}, {}, [], {}, {}, {}
        for dx, dy in shards:
            box = plan.box(0, (dx, dy, 0))
            v, f = blk(gv, dx, dy), blk(gf, dx, dy)
            nv = blk(gnv, dx, dy) if mode == Mode.NEWTON else None
            fc = faces_of(gv, dx, dy)
            sw[dx, dy] = torch.zeros_like(v)
            SK.sweep_block(sw[dx, dy], v, f, fc, box, p, h, nv)
            rs[dx, dy] = torch.zeros_like(v)
            part = SK.residual_block(rs[dx, dy], v, f, fc, box, p, h,
                                     with_norm=True, newton_v=nv)
            ss.append(v.new_empty(1))
            K.finalize(part, ss[-1])
            xz[dx, dy] = torch.zeros((cbx, by, cbz), device=DEVICE)
            last[dx, dy] = torch.zeros((by, cbz), device=DEVICE)
            xv[dx, dy] = torch.zeros_like(xz[dx, dy]) \
                if mode == Mode.NONLINEAR else None
            SK.residual_restrict_block(
                xz[dx, dy], last[dx, dy], xv[dx, dy], v, f, fc, box, p, h,
                cdims[2], nv,
            )
            # The same block on the plain version: the face-reading
            # instantiation bit for bit.
            outs = [torch.zeros_like(xz[dx, dy]),
                    torch.zeros_like(last[dx, dy]),
                    None if xv[dx, dy] is None else
                    torch.zeros_like(xv[dx, dy])]
            SK.residual_restrict_block_plain(*outs, v, f, fc, box, p, h,
                                             cdims[2], nv)
            name = K.variant("residual_restrict_block", mode)
            got_k = [t for t in (xz[dx, dy], last[dx, dy], xv[dx, dy])
                     if t is not None]
            print("check ghosts " + rec.fields(
                got_k, [t for t in outs if t is not None],
                f"{name} vs plain, carved block ({dx}, {dy}) {tag}", name))
        want = torch.zeros_like(vf_)
        K.jacobi_sweep(want, vf_, ff_, dims, p, h, newton_v=nvf)
        got = full(put(sw, plan.alloc[0], (bx, by)), dims)
        print(f"check ghosts {rec.close(got, want, f'sweep_block {tag}', 'ghosts')}")
        r_want = torch.zeros_like(vf_)
        parts = K.residual(r_want, vf_, ff_, dims, p, h, with_norm=True,
                           newton_v=nvf)
        ss_want = vf_.new_empty(1)
        K.finalize(parts, ss_want)
        got = full(put(rs, plan.alloc[0], (bx, by)), dims)
        print(f"check ghosts {rec.close(got, r_want, f'residual_block {tag}', 'ghosts')}; "
              + rec.scalar(float(sum(float(t) for t in ss)),
                           float(ss_want), "sum r^2 over the 4 blocks",
                           "ghosts_sum"))

        def coarse(xzs, fix):
            out = {}
            for dx, dy in shards:
                x2 = xzs[dx, dy]
                if fix and dx:
                    x2 = x2.clone()
                    x2[0] += 0.25 * last[0, dy]
                out[dx, dy] = x2
            res = {}
            for dx, dy in shards:
                g = out[dx, 0][:, -1] if dy else torch.zeros_like(
                    out[dx, dy][:, 0])
                y = tsp._restrict_axis(
                    torch.cat([g[:, None], out[dx, dy]], dim=1), 1, cby
                )
                box = plan.box(1, (dx, dy, 0))
                res[dx, dy] = torch.zeros_like(y)
                sl = SK.box_slices(box)
                res[dx, dy][sl] = y[sl]
            return full(put(res, plan.alloc[1], (cbx, cby)), cdims)

        c_want = torch.zeros((cdims[0] + 2,) * 3, device=DEVICE)
        K.restrict(c_want, r_want, dims, cdims)
        print(f"check ghosts {rec.close(coarse(xz, True), c_want, f'residual_restrict_block + glue vs residual + restrict {tag}', 'ghosts_restrict')}")
        if mode == Mode.NONLINEAR:
            v_want = torch.zeros_like(c_want)
            K.restrict(v_want, vf_, dims, cdims)
            print(f"check ghosts {rec.close(coarse(xv, False), v_want, f'residual_restrict_block R(v) + glue vs restrict {tag}', 'ghosts_restrict')}")
    pv = {}
    for dx, dy in shards:
        v = blk(gv, dx, dy)
        casm = tsp._window(gvc, (dx * cbx - 1, dy * cby - 1, 0),
                           (cbx + 2, cby + 2, cbz))
        SK.prolong_add_block(v, casm, plan.box(0, (dx, dy, 0)))
        pv[dx, dy] = v
    want = full(gv, dims).clone()
    K.prolong_add(want, full(gvc, cdims), dims, cdims)
    got = full(put(pv, plan.alloc[0], (bx, by)), dims)
    print(f"check ghosts {rec.close(got, want, 'prolong_add_block 127^3 on 4 carved blocks', 'ghosts')}")
    print(f"check ghosts bit-identical: sweep/residual/prolong "
          f"{rec.same['ghosts']}, restriction {rec.same['ghosts_restrict']}")


# ---------------------------------------------------------------------------
# The trapezoid leg (ops/spmd_leg.py)
# ---------------------------------------------------------------------------


def leg_variants(mode):
    """(label, kwargs) of every leg variant a mode has: no consumer, the
    norm and the restriction (FAS: with the tau fold), each from v; from
    v = 0 (LINEAR and NEWTON) with no consumer and with the restriction;
    corr-first with no consumer and with the norm."""
    from gpusolve_tpu_torch.config import Mode

    out = [("none", {}), ("norm", {"consumer": "norm"}),
           ("restrict", {"consumer": "restrict"})]
    if mode != Mode.NONLINEAR:
        out += [("zero", {"src_zero": True}),
                ("zero+restrict", {"src_zero": True,
                                   "consumer": "restrict"})]
    out += [("corr", {"corr": True}),
            ("corr+norm", {"corr": True, "consumer": "norm"})]
    return out


def leg_call(fn, p, plan, l, x, kw, slabs=None, cslabs=None, box=None,
             glob=None, cbox=None, S=3, outs=None):
    """One leg of ``fn`` (leg_block or its plain version) on the inputs
    ``x`` (v, f, ũ, coarse v) of level ``l``; returns the output fields
    and the norm partials.  ``outs``: the output fields of an earlier call
    to write again (a timed call allocates nothing)."""
    import torch

    from gpusolve_tpu_torch.config import Mode
    from gpusolve_tpu_torch.ops import spmd_leg as SL

    v, f, nv, vc = x
    fas = p.mode == Mode.NONLINEAR
    out = torch.zeros_like(v) if outs is None else outs[0]
    kw = dict(kw)
    corr = kw.pop("corr", False)
    extra = {}
    couts = []
    if kw.get("consumer") == "restrict":
        couts = [torch.zeros_like(vc) for _ in range(3 if fas else 1)] \
            if outs is None else list(outs[1:])
        extra = dict(
            cout=tuple(couts) if fas else (couts[0], None, None),
            cbox=cbox, cdims=plan.dims[l + 1],
            tau_h=p.level_h(l + 1) if fas else 0.0,
        )
    if corr:
        extra["coarse"] = (vc, cslabs)
        S = min(S, SL.MAX_CORR_SWEEPS)
    part = fn(out, v, f, slabs, box, glob, p, p.level_h(l), S,
              newton_v=nv if p.mode == Mode.NEWTON else None, **kw, **extra)
    return [out] + couts, part


def leg_inputs(block, cblock, box, cbox, seed):
    """Seeded block fields on the card, zero outside the box (v 0.05,
    f 100, ũ 0.3), and a coarse v zero outside the coarse box."""
    import numpy as np
    import torch

    from gpusolve_tpu_torch.ops import spmd_kernels as SK

    rng = np.random.default_rng(seed)

    def field(shape, b, scale):
        a = torch.zeros(shape, device=DEVICE)
        a[SK.box_slices(b)] = torch.from_numpy(
            rng.standard_normal(SK.box_dims(b), dtype=np.float32)
            * np.float32(scale)
        ).to(DEVICE)
        return a

    return (field(block, box, 0.05), field(block, box, 100.0),
            field(block, box, 0.3), field(cblock, cbox, 0.05))


def check_leg_kernels(base, rec):
    """leg_block against leg_block_plain on CUDA tensors, every mode and
    variant, at the (1,1,1)-mesh 511³ level-0 block (640³, the box 511³)
    and at the one-rank blocks of 15³ and (33, 17, 9) grids, the last also
    with the stencil's taps reordered (with and without zero slabs); and
    the leg with no consumer against S launches of sweep_block.  Bit for
    bit."""
    import itertools

    import torch

    from gpusolve_tpu_torch.config import Mode, Stencil
    from gpusolve_tpu_torch.dist.spmd import SpmdPlan
    from gpusolve_tpu_torch.ops import kernels as K
    from gpusolve_tpu_torch.ops import spmd_kernels as SK
    from gpusolve_tpu_torch.ops import spmd_leg as SL

    # The examples' stencil (taps in the order the kernel reads from
    # registers and immediate offsets), and the same taps in another order
    # with other values, which the kernel reads by offsets (33x17x9 only).
    perm = Stencil(*OTHER_TAPS["reordered"])
    cases = [(BIG, base.stencil), ((15, 15, 15), base.stencil),
             ((33, 17, 9), base.stencil), ((33, 17, 9), perm)]
    for n, (dims, stencil) in enumerate(cases):
        plan = SpmdPlan(base.replace(grid_dim=dims), (1, 1, 1))
        box, cbox = plan.box(0, (0, 0, 0)), plan.box(1, (0, 0, 0))
        glob = (0, dims[0], 0, dims[1])
        x = leg_inputs(plan.block[0], plan.block[1], box, cbox, 800 + n)
        tag = f"{'x'.join(map(str, plan.block[0]))} block, box {SK.box_dims(box)}"
        if stencil is perm:
            tag += ", taps reordered"
        lines = []
        for mode in Mode:
            p = base.replace(mode=mode, grid_dim=dims, print_progress=False,
                             stencil=stencil)
            name = K.variant("leg_block", mode)
            # The reordered taps also with zero slabs: the generic-tap
            # slab-reading instantiations.
            slab_runs = [(None, None, "")]
            if stencil is perm:
                zx = torch.zeros((SL.G,) + tuple(plan.block[0][1:]),
                                 device=DEVICE)
                zc = torch.zeros((SL.GC,) + tuple(plan.block[1][1:]),
                                 device=DEVICE)
                slab_runs.append(({k: (zx, zx, None, None)
                                   for k in ("v", "f", "nv")},
                                  (zc, zc, None, None), ", zero slabs"))
            for (slabs, cslabs, stag), (label, kw) in itertools.product(
                    slab_runs, leg_variants(mode)):
                args = (p, plan, 0, x, kw)
                opts = dict(slabs=slabs, cslabs=cslabs, box=box, glob=glob,
                            cbox=cbox)
                got, pk = leg_call(SL.leg_block, *args, **opts)
                want, pp = leg_call(SL.leg_block_plain, *args, **opts)
                label += stag
                lines.append(rec.fields(got, want,
                                        f"{name} {label} {tag}", name))
                check(rec.same[name], f"{name} {label} {tag} not bit-identical")
                if pk is not None:
                    ss_k, ss_p = x[0].new_empty(1), x[0].new_empty(1)
                    K.finalize(pk, ss_k)
                    K.finalize_plain(pp, ss_p)
                    lines.append(rec.scalar(float(ss_k), float(ss_p),
                                            f"{name} {label} sum r^2 {tag}",
                                            name + "_norm"))
            # The leg with no consumer equals 3 launches of sweep_block.
            v, f, nv, _ = x
            nvm = nv if mode == Mode.NEWTON else None
            a, b = v.clone(), torch.zeros_like(v)
            zero = [torch.zeros((plan.block[0][1], plan.block[0][2]),
                                device=DEVICE)] * 2 + \
                [torch.zeros((plan.block[0][0], plan.block[0][2]),
                             device=DEVICE)] * 2
            for _ in range(3):
                SK.sweep_block(b, a, f, zero, box, p, p.level_h(0), nvm)
                a, b = b, a
            got, _ = leg_call(SL.leg_block, p, plan, 0, x, {}, box=box,
                              glob=glob)
            same = bool(torch.equal(got[0], a))
            check(same, f"{name} vs 3 sweep_block launches {tag}")
            lines.append(f"{name} vs 3 sweep_block launches {tag}: "
                         f"bit-identical={same}")
        for line in lines:
            print(f"check {line}")
        del x
        torch.cuda.empty_cache()


def check_leg_ghosts(base, rec):
    """The leg with live neighbours: a 127³ field carved into the blocks
    of a (2,1,1) plan (x slabs) and of a (2,2,1) plan (y slabs and
    y-extended x slabs), each block's slabs cut from the field as the
    exchange would deliver them, and the blocks' outputs put together,
    against the same leg on the whole field as one block with no slab.
    Every mode and variant; bit for bit (the norm: the float64 sums of
    the blocks against the whole, to rel 1e-5 after float32 rounding)."""
    import itertools

    import torch

    from gpusolve_tpu_torch.config import Mode
    from gpusolve_tpu_torch.dist import spmd as tsp
    from gpusolve_tpu_torch.ops import kernels as K
    from gpusolve_tpu_torch.ops import spmd_kernels as SK
    from gpusolve_tpu_torch.ops import spmd_leg as SL

    dims = (127, 127, 127)
    for n, mesh in enumerate(((2, 1, 1), (2, 2, 1))):
        p0 = base.replace(grid_dim=dims, print_progress=False)
        plan = tsp.SpmdPlan(p0, mesh)
        ys = mesh[1] > 1
        whole = tsp.SpmdPlan(p0, (1, 1, 1))
        (bx, by, bz), (cbx, cby, cbz) = plan.block[0], plan.block[1]
        # The whole field as one block of the carved plan's allocation.
        wbox = (1, dims[0], 1, dims[1], 1, dims[2])
        cd = plan.dims[1]
        wcbox = (1, cd[0], 1, cd[1], 1, cd[2])
        gx = leg_inputs(plan.alloc[0], plan.alloc[1], wbox, wcbox, 900 + n)
        shards = list(itertools.product(range(mesh[0]), range(mesh[1])))

        def slabs_of(g, dx, dy, b, dep):
            gy = dep if ys else 0
            x0, y0 = dx * b[0], dy * b[1]
            xs = (dep, b[1] + 2 * gy, b[2])
            out = (tsp._window(g, (x0 - dep, y0 - gy, 0), xs),
                   tsp._window(g, (x0 + b[0], y0 - gy, 0), xs))
            if not ys:
                return out + (None, None)
            yss = (b[0], dep, b[2])
            return out + (tsp._window(g, (x0, y0 - dep, 0), yss),
                          tsp._window(g, (x0, y0 + b[1], 0), yss))

        def blk(g, dx, dy, b):
            return g[dx * b[0]:(dx + 1) * b[0],
                     dy * b[1]:(dy + 1) * b[1]].contiguous()

        def put(parts, alloc, b):
            g = torch.zeros(alloc, device=DEVICE)
            for (dx, dy), t in parts.items():
                g[dx * b[0]:(dx + 1) * b[0], dy * b[1]:(dy + 1) * b[1]] = t
            return g

        lines = []
        for mode in Mode:
            p = p0.replace(mode=mode)
            name = K.variant("leg_block", mode)
            for label, kw in leg_variants(mode):
                want, pw = leg_call(SL.leg_block, p, whole, 0, gx, kw,
                                    box=wbox, glob=(0, dims[0], 0, dims[1]),
                                    cbox=wcbox)
                outs, ss = {}, 0.0
                for dx, dy in shards:
                    x = tuple(blk(g, dx, dy, b) for g, b in
                              zip(gx, ((bx, by),) * 3 + ((cbx, cby),)))
                    slabs = {k: slabs_of(g, dx, dy, (bx, by, bz), SL.G)
                             for k, g in zip(("v", "f", "nv"), gx)}
                    cslabs = slabs_of(gx[3], dx, dy, (cbx, cby, cbz), SL.GC)
                    got, part = leg_call(
                        SL.leg_block, p, plan, 0, x, kw, slabs=slabs,
                        cslabs=cslabs, box=plan.box(0, (dx, dy, 0)),
                        glob=(dx * bx, dims[0], dy * by, dims[1]),
                        cbox=plan.box(1, (dx, dy, 0)),
                    )
                    outs[dx, dy] = got
                    if part is not None:
                        ss += float(part.sum())
                got = [put({k: o[i] for k, o in outs.items()},
                           plan.alloc[0] if i == 0 else plan.alloc[1],
                           (bx, by) if i == 0 else (cbx, cby))
                       for i in range(len(want))]
                tag = f"127^3 carved {mesh} {label}"
                lines.append(rec.fields(got, want, f"{name} {tag}",
                                        "leg_ghosts"))
                check(all(torch.equal(a, b) for a, b in zip(got, want)),
                      f"{name} {tag}: carved != uncarved")
                if pw is not None:
                    lines.append(rec.scalar(ss, float(pw.sum()),
                                            f"{name} {tag} sum r^2",
                                            "leg_ghosts_norm"))
        for line in lines:
            print(f"check ghosts {line}")
        del gx
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The pod engine's chains (ops/pod.py)
# ---------------------------------------------------------------------------

# (grid, pod depths): the 511³ one-rank plan (choose_npod's depth 1) and a
# three-level chain, and small grids, one of them not 2^k − 1.
POD_CASES = ((BIG, (1, 3)), ((15, 15, 15), (1, 2)), ((33, 17, 9), (1, 2)))


def seeded_pod_state(eng, seed):
    """A pod (or per-leg) engine state on the card with seeded v (0.05), f
    (100), ũ (0.3) and rest_v (0.05) on levels 0..nd (the pod levels and
    the boundary block), zero outside each box (normal numbers drawn on
    the card from a generator seeded with ``seed``)."""
    import torch

    from gpusolve_tpu_torch.ops import spmd_kernels as SK

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    state = eng.init_state()
    for l in range(eng.nd + 1):
        lvl, box = state.levels[l], eng.boxes[l]
        for name, scale in (("v", 0.05), ("f", 100.0), ("newton_v", 0.3),
                            ("rest_v", 0.05)):
            t = getattr(lvl, name)
            if t is not None:
                t[SK.box_slices(box)] = scale * torch.randn(
                    SK.box_dims(box), generator=gen, device=DEVICE)
    return state


def run_chain(eng, state, how, up):
    """The whole down (or up) chain of ``eng`` over ``state`` in one
    launch ("kernel"), its plain version ("plain") or one ``leg_block``
    launch a leg ("legs"); the up chain prolongs the tail root's v.
    Returns the norm partials (up) or None."""
    from gpusolve_tpu_torch.ops import pod as PD
    from gpusolve_tpu_torch.ops import spmd_leg as SL

    p, levels = eng.params, list(state.levels)
    S = p.post_smoothing if up else p.pre_smoothing
    legs = eng.up_legs(0, levels, levels[eng.npod].v) if up \
        else eng.down_legs(0, levels)
    if how == "kernel":
        return (PD.pod_up if up else PD.pod_down)(legs, p, S)
    if how == "plain":
        return (PD.pod_up_plain if up else PD.pod_down_plain)(legs, p, S)
    part = None
    for leg in legs:
        out = SL.leg_block(leg.v_out, leg.v, leg.f, None, leg.box, leg.glob,
                           p, leg.h, S, **leg.kwargs())
        if out is not None:
            part = out
    return part


def pod_fields(state, npod):
    return [t for lvl in state.levels[:npod + 1]
            for t in (lvl.v, lvl.r, lvl.f, lvl.rest_v) if t is not None]


def check_pod_kernels(base, rec):
    """pod_down and pod_up against their plain versions and against the
    same legs launched one by one through leg_block, every field of
    levels 0..npod and the norm, bit for bit, in every mode: the 511³
    one-rank plan (npod = 1) and a three-level chain, and 15³ and
    (33, 17, 9) at depths 1 and 2 (FAS sub_rv below the chain's head)."""
    import torch

    import gpusolve_tpu_torch as gt
    from gpusolve_tpu_torch.config import Mode
    from gpusolve_tpu_torch.dist.pod import build_pod_solver
    from gpusolve_tpu_torch.ops import kernels as K
    from gpusolve_tpu_torch.ops import pod as PD

    mesh = gt.make_mesh((1, 1, 1))
    for dims, npods in POD_CASES:
        for npod in npods:
            lines = []
            for mode in Mode:
                p = base.replace(mode=mode, grid_dim=dims,
                                 print_progress=False)
                eng = build_pod_solver(p, mesh, npod=npod)
                tag = (f"{'x'.join(map(str, dims))} npod={npod} blocks "
                       f"{[eng.plan.shape(l) for l in range(npod + 1)]}")
                seeded = seeded_pod_state(eng, 700 + npod)
                for up in (False, True):
                    name = K.variant("pod_up" if up else "pod_down", mode)
                    res = {}
                    for how in ("kernel", "plain", "legs"):
                        st = clone_state(seeded)
                        part = run_chain(eng, st, how, up)
                        ss = None
                        if part is not None:
                            ss = st.levels[0].v.new_empty(1)
                            (K.finalize_plain if how == "plain"
                             else K.finalize)(part, ss)
                            ss = float(ss)
                        res[how] = (pod_fields(st, npod), ss)
                        del st
                    got, ss_k = res["kernel"]
                    lines.append(rec.fields(got, res["plain"][0],
                                            f"{name} {tag}", name))
                    check(rec.same[name], f"{name} {tag}: not bit-identical "
                          "to its plain version")
                    legs = all(torch.equal(a, b)
                               for a, b in zip(got, res["legs"][0]))
                    check(legs and ss_k == res["legs"][1],
                          f"{name} {tag}: != its legs one by one")
                    lines.append(f"{name} vs {npod} leg_block launches "
                                 f"{tag}: bit-identical={legs}")
                    if ss_k is not None:
                        lines.append(rec.scalar(ss_k, res["plain"][1],
                                                f"{name} sum r^2 {tag}",
                                                name + "_norm"))
                    blocks, per_sm, smem = PD.last_grid[name]
                    form = "one block a tile" if npod == 1 else \
                        "cooperative"
                    lines.append(f"{name} grid {tag}: {blocks} blocks, "
                                 f"{form}, {per_sm} resident an SM, {smem} "
                                 "bytes of shared memory a block")
                del eng, seeded
                torch.cuda.empty_cache()
            for line in lines:
                print(f"check {line}")


@contextlib.contextmanager
def counting_spmd_inner():
    """Records the inner cycles of each distributed Newton step."""
    from gpusolve_tpu_torch.dist import spmd as tsp

    inner_cycles = []
    solve = tsp.solve_spmd

    def counted(*args, **kwargs):
        out = solve(*args, **kwargs)
        inner_cycles.append(len(out[1]))
        return out

    tsp.solve_spmd = counted
    try:
        yield inner_cycles
    finally:
        tsp.solve_spmd = solve


def run_spmd(params, check_every, local_backend="auto", fuse="leg",
             halo="ppermute", tail="off"):
    """One distributed solve on make_mesh((1,1,1)); the per-leg engine in
    the classic plan unless ``tail`` says otherwise."""
    import torch

    import gpusolve_tpu_torch as gt

    mesh = gt.make_mesh((1, 1, 1))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if params.mode == gt.Mode.NEWTON:
        state, hist, plan = gt.newton_solve_spmd(
            params, mesh, local_backend=local_backend, fuse=fuse, halo=halo,
            tail=tail)
    else:
        state, hist, plan = gt.solve_spmd(params, mesh,
                                          local_backend=local_backend,
                                          check_every=check_every, fuse=fuse,
                                          halo=halo, tail=tail)
    torch.cuda.synchronize()
    return state, hist, plan, time.perf_counter() - t0


@contextlib.contextmanager
def counting_glue():
    """Counts the calls of the per-op path's torch glue of a down leg (the
    y restriction, the lower-x fix-up, the FAS tau), which a leg folds."""
    from gpusolve_tpu_torch.dist import spmd as tsp

    calls = {"n": 0}
    saved = {}
    for name in ("_y_restrict", "_fix_x0", "_fas_tau"):
        fn = getattr(tsp.SpmdEngine, name)
        saved[name] = fn

        def counted(*args, fn=fn, **kwargs):
            calls["n"] += 1
            return fn(*args, **kwargs)

        setattr(tsp.SpmdEngine, name, counted)
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(tsp.SpmdEngine, name, fn)


def spmd_expected(plan, hist, inner_cycles):
    """Launches of a distributed solve (the per-leg or the pod engine's
    schedule): every executed cycle's (the history records each), the
    initial norm; a Newton solve the initial F, and per step the
    replicated R(ũ), the inner cycles and F."""
    from gpusolve_tpu_torch.config import Mode
    from gpusolve_tpu_torch.dist import pod as tpod
    from gpusolve_tpu_torch.dist import spmd as tsp
    from gpusolve_tpu_torch.ops import kernels as K

    params = plan.params
    per = (tpod if isinstance(plan, tpod.PodPlan) else tsp
           ).launches_per_cycle(plan)
    steps = len(hist) - 1
    newton = params.mode == Mode.NEWTON
    cycles = sum(inner_cycles) if newton else steps
    want = {name: 0 for name in K.KERNELS}
    for name, n in per.items():
        want[name] += n * cycles
    norms = steps + 1 if newton else 1
    first = "residual_block_fas" if newton else \
        K.variant("residual_block", params.mode)
    want[first] += norms
    want["finalize"] += norms
    if newton:
        want["restrict"] += steps * max(0, plan.nlev - 2 - plan.n_dist)
    return nonzero(want)


def spmd_main_path(params, label, batch_hist, k=10, legs=True):
    """solve_spmd (Newton: newton_solve_spmd) on make_mesh((1,1,1)): the
    launch counts, and the single-device batch engine's history at the
    same configuration.  With ``legs`` (V(3,3)): every level below the
    junction runs both legs and no down leg's per-op glue; the same run on
    the plain ops on the card gives the same history, and the per-op path
    (local_backend="xla") agrees with it.  Without (V(6,6), past the legs'
    sweep cap): the per-op kernels and no leg, held against the same run
    on the plain ops at rel 2e-4 above 1e-4·initial."""
    import torch

    from gpusolve_tpu_torch.config import Mode
    from gpusolve_tpu_torch.ops import kernels as K

    K.reset_launches()
    with counting_spmd_inner() as inner_cycles, counting_glue() as glue:
        state, hist, plan, secs = run_spmd(params, k)
    counts = nonzero(K.launches)
    steps = len(hist) - 1
    nd = plan.n_dist
    print(f"spmd path {label}: mesh (1,1,1), {nd} distributed "
          f"levels (level-0 block {plan.block[0]}), fused-down "
          f"{plan.fused_down_levels}, fused-up {plan.fused_up_levels}, "
          f"{steps} steps in {secs:.3f} s wall, history {hist}")
    if inner_cycles:
        print(f"spmd path {label}: inner cycles per step {inner_cycles}")
    print(f"spmd path {label} launches: {counts}")
    want = spmd_expected(plan, hist, inner_cycles)
    check(counts == want,
          f"spmd {label}: launch counts {counts} != schedule {want}")
    legs_run = sum(n for kname, n in counts.items()
                   if kname.startswith("leg_block"))
    if legs:
        check(plan.fused_down_levels == tuple(range(nd - 1))
              and plan.fused_up_levels == tuple(range(1, nd)),
              f"spmd {label}: fused levels {plan.fused_down_levels} / "
              f"{plan.fused_up_levels}")
        check(glue["n"] == 0,
              f"spmd {label}: the per-op down-leg glue ran {glue['n']} times")
        print(f"spmd path {label}: per-op down-leg glue (y restriction, "
              f"fix-up, FAS tau) calls: {glue['n']}")
    else:
        check(legs_run == 0 and not plan.fused_down_levels,
              f"spmd {label}: a leg ran past the sweep cap")
    # The engines restrict in other orders, so the histories part by
    # rounding, more the nearer the float32 floor: held above 1e-2·initial;
    # V(6,6) FAS against the v1 engine above 1e-1·initial, since it comes
    # within 10x of its floor by cycle 2, where the two part by 2.5e-4
    # (entry 2: 30.804 against 30.812).
    newton = params.mode == Mode.NEWTON
    fas_v66 = params.mode == Mode.NONLINEAR and not legs
    worst_b = histories_agree(hist[:len(batch_hist)], batch_hist,
                              f"spmd {label} vs the batch engine",
                              floor=1e-1 if fas_v66 else 1e-2)
    print(f"spmd {label} vs the single-device engine: worst rel diff "
          f"{worst_b:.3e} (identical: {hist == batch_hist})")
    K.reset_launches()
    plain = params.replace(backend="ref",
                           maxiter=NEWTON_PLAIN_STEPS if newton
                           else params.maxiter)
    _, ref_hist, _, ref_secs = run_spmd(plain, k)
    check(all(n == 0 for n in K.launches.values()),
          "the plain spmd path launched a kernel")
    mine = hist[:len(ref_hist)]
    if not legs:
        # The per-op kernels against the plain ops over the assembled
        # block, which restrict in the kernels' order.
        worst_p = histories_agree(mine, ref_hist,
                                  f"spmd {label} per-op kernels vs plain")
        print(f"spmd per-op kernels vs plain {label}: worst rel diff "
              f"{worst_p:.3e} (identical: {mine == ref_hist}; plain run "
              f"{ref_secs:.3f} s, {len(ref_hist) - 1} steps)")
    else:
        check(mine == ref_hist,
              f"spmd {label}: kernels {mine} != plain ops {ref_hist}")
        K.reset_launches()
        _, xla_hist, xplan, xla_secs = run_spmd(
            plain.replace(backend="auto"), k, local_backend="xla")
        check(all(n == 0 for n in K.launches.values())
              and not xplan.fused_down_levels,
              'local_backend="xla" launched a kernel or a leg')
        # The per-op path restricts in another order (x, z, then y), so
        # the histories part by rounding: held as the batch engine's.
        worst_x = histories_agree(mine, xla_hist,
                                  f"spmd {label} legs vs the per-op path",
                                  floor=1e-2)
        print(f"spmd kernels vs plain {label}: identical (plain run "
              f"{ref_secs:.3f} s, {len(ref_hist) - 1} steps); vs the "
              f"per-op path on plain ops (local_backend=\"xla\", "
              f"{xla_secs:.3f} s) worst rel diff {worst_x:.3e}")
    del state
    torch.cuda.empty_cache()
    return counts, hist


def pod_main_path(params, label, batch_hist, leg_hist, k=10):
    """solve_spmd (Newton: newton_solve_spmd) with fuse="pod" on
    make_mesh((1,1,1)): the engine's own depth (1) with the tail in place
    on the boundary block, launch counts equal to its schedule
    (dist/pod.launches_per_cycle: one pod_down and one pod_up a V-cycle,
    the tail's per-op kernels), no leg or shard-local kernel; the same
    history on the plain ops on the card; the per-leg and the batch
    engines' histories within rel 2e-4 above 1e-2·initial."""
    import torch

    from gpusolve_tpu_torch.config import Mode
    from gpusolve_tpu_torch.ops import kernels as K

    K.reset_launches()
    with counting_spmd_inner() as inner_cycles:
        state, hist, plan, secs = run_spmd(params, k, fuse="pod")
    counts = nonzero(K.launches)
    print(f"pod path {label}: mesh (1,1,1), pod depth {plan.npod} (blocks "
          f"{[plan.shape(l) for l in range(plan.npod + 1)]}, tail in place "
          f"{plan.tail_in_place}), {len(hist) - 1} steps in {secs:.3f} s "
          f"wall, history {hist}")
    if inner_cycles:
        print(f"pod path {label}: inner cycles per step {inner_cycles}")
    print(f"pod path {label} launches: {counts}")
    check(plan.npod == 1 and plan.tail_in_place,
          f"pod {label}: depth {plan.npod}, tail in place "
          f"{plan.tail_in_place}")
    want = spmd_expected(plan, hist, inner_cycles)
    check(counts == want,
          f"pod {label}: launch counts {counts} != schedule {want}")
    for what, other in (("the batch engine", batch_hist),
                        ("the per-leg engine", leg_hist)):
        worst = histories_agree(hist[:len(other)], other,
                                f"pod {label} vs {what}", floor=1e-2)
        print(f"pod {label} vs {what}: worst rel diff {worst:.3e} "
              f"(identical: {hist == other})")
    newton = params.mode == Mode.NEWTON
    K.reset_launches()
    plain = params.replace(backend="ref",
                           maxiter=NEWTON_PLAIN_STEPS if newton
                           else params.maxiter)
    _, ref_hist, _, ref_secs = run_spmd(plain, k, fuse="pod")
    check(all(n == 0 for n in K.launches.values()),
          "the plain pod path launched a kernel")
    mine = hist[:len(ref_hist)]
    check(mine == ref_hist,
          f"pod {label}: kernels {mine} != plain ops {ref_hist}")
    print(f"pod kernels vs plain {label}: identical (plain run "
          f"{ref_secs:.3f} s, {len(ref_hist) - 1} steps)")
    del state
    torch.cuda.empty_cache()
    return counts, hist


def pod_other_cycles(params127, label):
    """W and F at 127³ on the pod engine: the kernels' history equals the
    plain ops' on the card, and the counts follow the schedule."""
    from gpusolve_tpu_torch.ops import kernels as K

    for cycle in ("W", "F"):
        p = params127.replace(cycle_type=cycle, print_progress=False)
        K.reset_launches()
        _, hist, plan, _ = run_spmd(p, 1, fuse="pod")
        counts = nonzero(K.launches)
        want = spmd_expected(plan, hist, [])
        check(counts == want, f"pod {cycle} {label}: counts {counts} != "
              f"{want}")
        _, ref, _, _ = run_spmd(p.replace(backend="ref"), 1, fuse="pod")
        check(hist == ref, f"pod {cycle} {label}: kernels {hist} != plain "
              f"{ref}")
        print(f"pod path 127^3 {cycle} {label}: depth {plan.npod}, "
              f"identical to the plain ops, launches {counts}")


# ---------------------------------------------------------------------------
# The per-leg engine's replicated tail (dist/spmd.py, tail="auto")
# ---------------------------------------------------------------------------

JUNCTION_SHAPES = ((15, 15, 15), (33, 17, 9), BIG)


def check_junction_legs(base, rec):
    """The replicated tail's junction legs on the one-rank mesh against
    their plain versions, bit for bit, in every mode, through the engine's
    own junction code (``_down`` / ``_up`` of a tail="pv2" engine on the
    CUDA kernels beside one on the plain versions, over the same plan and
    the same seeded state): the down leg restricting straight into the
    tail root (its f; FAS also its v and rest_v, with the tau fold) and the
    up leg prolonging from it (FAS after the subtract kernel in place),
    with the cycle's norm; at 15³, (33, 17, 9) and 511³ (the 514³ block
    into the 257³ root, in place)."""
    import torch

    import gpusolve_tpu_torch as gt
    from gpusolve_tpu_torch.config import Mode
    from gpusolve_tpu_torch.dist import spmd as tsp
    from gpusolve_tpu_torch.ops import kernels as K

    mesh = gt.make_mesh((1, 1, 1))
    for n, dims in enumerate(JUNCTION_SHAPES):
        lines = []
        for mode in Mode:
            p = base.replace(mode=mode, grid_dim=dims, print_progress=False)
            eng = tsp.build_spmd_solver(p, mesh, tail="pv2")
            plan = eng.plan
            nd = plan.n_dist
            check(plan.tail_pv2 is not None
                  and nd - 1 in plan.fused_down_levels
                  and nd in plan.fused_up_levels,
                  f"junction {dims}: the tail plan's junction legs are "
                  f"refused ({plan.fused_down_levels}, "
                  f"{plan.fused_up_levels})")
            plain = tsp.SpmdEngine(p, mesh, plan=plan, tail="pv2")
            plain.plain_reason = "the plain check"
            name = K.variant("leg_block", mode)
            tag = (f"{'x'.join(map(str, dims))} depth {nd}: block "
                   f"{plan.shape(nd - 1)} -> root {plan.tail_pv2} (in place "
                   f"{plan.tail_in_place})")
            seeded = seeded_pod_state(eng, 900 + n)
            states = {}
            for how, e in (("kernel", eng), ("plain", plain)):
                st = clone_state(seeded)
                levels = list(st.levels)
                e._down(nd - 1, levels, fresh=False)
                root = levels[nd]
                down = [levels[nd - 1].v, root.f] + (
                    [root.v, root.rest_v] if mode == Mode.NONLINEAR else [])
                down = [t.clone() for t in down]
                # The up leg from a seeded root (FAS: v − rest_v first).
                gen = torch.Generator(device=DEVICE).manual_seed(950 + n)
                root.v.copy_(0.05 * torch.randn(root.v.shape, generator=gen,
                                                device=DEVICE))
                part = e._up(nd, levels)
                ss = root.v.new_empty(1)
                (K.finalize if how == "kernel" else K.finalize_plain)(
                    part, ss)
                states[how] = (down, [levels[nd - 1].v, root.v], float(ss))
            (dk, uk, sk_), (dp, up_, sp) = states["kernel"], states["plain"]
            lines.append(rec.fields(dk, dp, f"{name} junction down {tag}",
                                    name))
            lines.append(rec.fields(uk, up_, f"{name} junction up {tag}",
                                    name))
            check(rec.same[name], f"{name} junction legs {tag}: not "
                  "bit-identical to their plain versions")
            lines.append(rec.scalar(sk_, sp, f"{name} junction up sum r^2 "
                                    f"{tag}", name + "_norm"))
            del eng, plain, seeded, states
            torch.cuda.empty_cache()
        for line in lines:
            print(f"check {line}")


def tail_main_path(params, label, batch_hist, leg_hist, pod_hist, k=10):
    """solve_spmd (Newton: newton_solve_spmd) with tail="auto" (the per-leg
    engine's default on the card) on make_mesh((1,1,1)): the replicated
    tail at _choose_tail_nd's depth (1 at 511³: the 514³ level-0 block
    whose junction legs write and read the 257³ root in place), launch
    counts equal to launches_per_cycle's schedule, no per-op down-leg
    glue; the same history on the plain ops on the card (tail="pv2"); the
    classic plan's, the batch engine's and the pod engine's histories
    within rel 2e-4 above 1e-2·initial."""
    import torch

    from gpusolve_tpu_torch.config import Mode
    from gpusolve_tpu_torch.dist import spmd as tsp
    from gpusolve_tpu_torch.ops import kernels as K

    K.reset_launches()
    with counting_spmd_inner() as inner_cycles, counting_glue() as glue:
        state, hist, plan, secs = run_spmd(params, k, tail="auto")
    counts = nonzero(K.launches)
    nd = plan.n_dist
    classic = tsp.SpmdPlan(params, (1, 1, 1))
    print(f"tail path {label}: mesh (1,1,1), tail depth {nd} (the classic "
          f"plan distributes {classic.n_dist}), blocks "
          f"{[plan.shape(l) for l in range(nd + 1)]}, root {plan.tail_pv2} "
          f"in place {plan.tail_in_place}, fused-down "
          f"{plan.fused_down_levels}, fused-up {plan.fused_up_levels}, "
          f"{len(hist) - 1} steps in {secs:.3f} s wall, history {hist}")
    if inner_cycles:
        print(f"tail path {label}: inner cycles per step {inner_cycles}")
    per = tsp.launches_per_cycle(plan)
    print(f"tail path {label}: launches_per_cycle {per}")
    print(f"tail path {label} launches: {counts}")
    check(plan.tail_pv2 is not None and nd == 1 and plan.tail_in_place,
          f"tail {label}: depth {nd}, root {plan.tail_pv2}, in place "
          f"{plan.tail_in_place}")
    check(plan.fused_down_levels == (0,) and plan.fused_up_levels == (1,),
          f"tail {label}: fused levels {plan.fused_down_levels} / "
          f"{plan.fused_up_levels}")
    check(glue["n"] == 0,
          f"tail {label}: the per-op down-leg glue ran {glue['n']} times")
    want = spmd_expected(plan, hist, inner_cycles)
    check(counts == want,
          f"tail {label}: launch counts {counts} != schedule {want}")
    print(f"tail path {label}: launches equal the schedule "
          f"(launches_per_cycle x cycles + the norms), per-op down-leg glue "
          f"calls {glue['n']}")
    for what, other in (("the classic plan", leg_hist),
                        ("the batch engine", batch_hist),
                        ("the pod engine", pod_hist)):
        worst = histories_agree(hist[:len(other)], other,
                                f"tail {label} vs {what}", floor=1e-2)
        print(f"tail {label} vs {what}: worst rel diff {worst:.3e} "
              f"(identical: {hist == other})")
    newton = params.mode == Mode.NEWTON
    K.reset_launches()
    plain = params.replace(backend="ref",
                           maxiter=NEWTON_PLAIN_STEPS if newton
                           else params.maxiter)
    _, ref_hist, ref_plan, ref_secs = run_spmd(plain, k, tail="pv2")
    check(all(n == 0 for n in K.launches.values())
          and ref_plan.n_dist == nd,
          "the plain tail path launched a kernel or took another depth")
    mine = hist[:len(ref_hist)]
    check(mine == ref_hist,
          f"tail {label}: kernels {mine} != plain ops {ref_hist}")
    print(f"tail kernels vs plain {label}: identical (plain run "
          f"{ref_secs:.3f} s, {len(ref_hist) - 1} steps)")
    del state
    torch.cuda.empty_cache()
    return counts


def tail_checkpoint(tmp):
    """A checkpoint round trip through the tail plan on the card at 63³
    (utils/checkpoint.save_state_spmd / load_state_spmd), each mode: k
    steps, saved, loaded into a new engine, the rest, against the
    uninterrupted run, bit for bit; the same through the CLI (--mesh 1,1,1
    --fuse leg --save-state, then --load-state); and --refine with --mesh
    1,1,1 to tol 1e-10 (the inner float32 solves on the tail plan)."""
    import numpy as np

    import gpusolve_tpu_torch as gt
    from gpusolve_tpu_torch.dist import spmd as tsp
    from gpusolve_tpu_torch.ops import kernels as K
    from gpusolve_tpu_torch.utils import checkpoint as ck

    mesh = gt.make_mesh((1, 1, 1))
    for label in ("linear", "nonlinear", "newton"):
        base = gt.parse_config(CONFS[label], grid_dim=(63, 63, 63),
                               print_progress=False, tol=1e-12)
        newton = base.mode == gt.Mode.NEWTON
        total, head = (3, 1) if newton else (6, 3)

        def run(p, **kw):
            if newton:
                return gt.newton_solve_spmd(p, mesh, **kw)
            return gt.solve_spmd(p, mesh, **kw)

        _, full, plan = run(base.replace(maxiter=total))
        check(plan.tail_pv2 is not None,
              f"checkpoint {label}: tail='auto' kept the classic plan")
        p = base.replace(maxiter=head)
        state, h1, plan = run(p)
        path = os.path.join(tmp, f"tail_{label}.npz")
        ck.save_state_spmd(path, state, plan, p, "spmd/leg", iteration=head,
                           history=h1,
                           newton_f=plan.newton_f if newton else None,
                           mesh=mesh)
        rest = base.replace(maxiter=total - head)
        eng = tsp.build_spmd_solver(rest, mesh)
        st, it, h0, nf = ck.load_state_spmd(path, rest, eng.plan, "spmd/leg",
                                            mesh=mesh)
        kw = {"newton_f": nf} if newton else {}
        _, h2, _ = run(rest, state=st, plan=eng.plan,
                       initial_residual=h0[0], **kw)
        check(h0 + h2 == full, f"checkpoint {label}: {h0 + h2} != {full}")
        print(f"tail checkpoint 63^3 {label}: depth {plan.n_dist}, {head} + "
              f"{total - head} resumed steps give the {total}-step history "
              f"exactly: {full}")

    # The CLI: 4 cycles, then 6 resumed, against 10 straight.
    paths = {n: os.path.join(tmp, f"cli_{n}.npz")
             for n in ("head", "tail", "all")}
    confs = {n: conf_with(tmp, CONFS["nonlinear"], f"tail_{n}.conf",
                          maxiter=n, tol=1e-12) for n in (4, 6, 10)}
    mesh_args = ["--mesh", "1,1,1", "--fuse", "leg", "--quiet"]
    K.reset_launches()
    rc_a, _, err_a = run_cli([confs[4], *mesh_args, "--explain-backend",
                              "--save-state", paths["head"]])
    rc_b, out_b, _ = run_cli([confs[6], *mesh_args, "--load-state",
                              paths["head"], "--save-state", paths["tail"]])
    rc_c, _, _ = run_cli([confs[10], *mesh_args, "--save-state",
                          paths["all"]])
    check(rc_a == rc_b == rc_c == 0, "cli --mesh checkpoint runs")
    check("backend: replicated tail: ONE batch-engine cycle a visit from "
          "level 1" in err_a, "cli --mesh: the replicated tail line")
    check(f"Resumed from {paths['head']} (iteration 4)"
          in out_b.splitlines(), "cli --mesh: the Resumed line")
    with np.load(paths["tail"]) as t, np.load(paths["all"]) as a:
        check(np.array_equal(t["__history__"], a["__history__"]),
              f"cli --mesh: resumed history {t['__history__']} != "
              f"{a['__history__']}")
        hist = [float(x) for x in a["__history__"]]
    print(f"cli --mesh 1,1,1 --fuse leg checkpoint (the tail plan): 4 + 6 "
          f"resumed cycles give the 10-cycle history exactly: {hist}; "
          f"launches {nonzero(K.launches)}")

    conf = conf_with(tmp, CONFS["linear"], "tail_refine.conf", tol=1e-10)
    K.reset_launches()
    rc, out, err = run_cli([conf, "--mesh", "1,1,1", "--fuse", "leg",
                            "--refine", "--explain-backend"])
    check(rc == 0, f"cli --mesh --refine exited {rc}")
    initial, res = progress(out.splitlines())
    check(res[-1] <= initial * 1e-10,
          f"cli --mesh --refine: {res[-1]} vs initial {initial}")
    check(K.launches["leg_block"] > 0 and "replicated tail" in err,
          "cli --mesh --refine: the inner solves ran no junction leg")
    print(f"cli --mesh 1,1,1 --refine: {initial:.6g} -> {res[-1]:.6g} in "
          f"{len(res)} outer steps ({res[-1] / initial:.3e} of the "
          f"initial); launches {nonzero(K.launches)}")


def spmd_cli():
    """--mesh 1,1,1 on the example configs, with --fuse leg (the per-leg
    engine, in its replicated tail: tail="auto" on the card), as they are (--fuse auto, the pod engine) and with --halo
    rdma (--fuse auto -> leg, the reference's reason; the --fuse leg
    run's progress lines, residual for residual), and a mesh larger than
    the world."""
    from gpusolve_tpu_torch.ops import kernels as K

    for label, line in (("linear", "Solving linear problem"),
                        ("nonlinear", "Solving nonlinear problem"),
                        ("newton", "Solving newton problem")):
        mode = {"linear": 0, "nonlinear": 1, "newton": 2}[label]
        K.reset_launches()
        args = [CONFS[label], "--mesh", "1,1,1", "--explain-backend",
                "--check-every", "10"]
        args += ["--validate"] if label != "linear" else []
        rc, out, err = run_cli(args)
        check(rc == 0, f"cli --mesh 1,1,1 (auto) {label} exited {rc}")
        lines = out.splitlines()
        check(line in lines, f"cli --mesh (auto): mode line {line!r}")
        progress(lines, newton=label == "newton")
        check("backend: fuse=auto -> pod" in err and
              "backend: pod depth 1" in err,
              f"cli --mesh {label}: --fuse auto did not take the pod engine")
        check(K.launches[K.variant("pod_down", mode)]
              and K.launches[K.variant("pod_up", mode)]
              and not K.launches[K.variant("leg_block", mode)],
              f"cli --mesh {label} (auto): launches {nonzero(K.launches)}")
        if label != "linear":
            m = [ln for ln in lines if ln.startswith("max-abs error")]
            err_v = float(m[0].split(": ")[1])
            check(math.isfinite(err_v) and err_v < 5e-4,
                  f"cli --mesh (auto): max-abs error {err_v}")
        print(f"cli --mesh 1,1,1 {label} (fuse=auto -> pod): launches "
              f"{nonzero(K.launches)}")
        K.reset_launches()
        args = [CONFS[label], "--mesh", "1,1,1", "--explain-backend",
                "--check-every", "10", "--fuse", "leg"]
        args += ["--validate"] if label != "linear" else []
        rc, out, err = run_cli(args)
        check(rc == 0, f"cli --mesh 1,1,1 {label} exited {rc}")
        lines = out.splitlines()
        check(line in lines, f"cli --mesh: mode line {line!r}")
        progress(lines, newton=label == "newton")
        check("backend: level 0: CUDA shard-local kernels" in err,
              "cli --mesh: the kernel line")
        if label != "linear":
            m = [ln for ln in lines if ln.startswith("max-abs error")]
            err_v = float(m[0].split(": ")[1])
            check(math.isfinite(err_v) and err_v < 5e-4,
                  f"cli --mesh: max-abs error {err_v}")
        check("backend: level 0: CUDA shard-local kernels (ops/spmd_leg, "
              "ops/spmd_kernels) (fused-down, fused-up)" in err,
              "cli --mesh: the fused tags of level 0")
        check(K.launches[K.variant("leg_block", mode)],
              "cli --mesh --fuse leg ran no leg")
        print(f"cli --mesh 1,1,1 --fuse leg {label}: launches "
              f"{nonzero(K.launches)}")
        leg_lines = progress(lines, newton=label == "newton")
        K.reset_launches()
        args = [CONFS[label], "--mesh", "1,1,1", "--explain-backend",
                "--check-every", "10", "--halo", "rdma"]
        args += ["--validate"] if label != "linear" else []
        rc, out, err = run_cli(args)
        check(rc == 0, f"cli --mesh 1,1,1 --halo rdma {label} exited {rc}")
        lines = out.splitlines()
        check(line in lines, f"cli --halo rdma: mode line {line!r}")
        check("backend: fuse=auto -> leg (--halo rdma is a per-leg engine "
              "feature)" in err and "fuse=leg halo=rdma" in err,
              f"cli --halo rdma {label}: --fuse auto did not take leg")
        got = progress(lines, newton=label == "newton")
        check(got == leg_lines, f"cli --halo rdma {label}: {got} != the "
              f"--fuse leg run's {leg_lines}")
        check(K.launches["rdma_exchange"]
              and K.launches[K.variant("leg_block", mode)],
              f"cli --halo rdma {label}: launches {nonzero(K.launches)}")
        print(f"cli --mesh 1,1,1 --halo rdma {label} (fuse=auto -> leg): "
              f"the --fuse leg run's residuals, launches "
              f"{nonzero(K.launches)}")
    rc, _, err = run_cli([CONFS["linear"], "--mesh", "2,2,1"])
    check(rc == 1 and "torchrun" in err, f"cli --mesh 2,2,1: rc {rc}")
    print("cli --mesh: a mesh larger than the world exits 1 (--dist-engine "
          "gspmd runs: gspmd_cli)")


def spmd_kernel_bytes(name, box, cnz=None):
    """Bytes one launch over ``box`` must move, as kernel_bytes counts
    them: v with the halo its taps read, f (and ũ) over the box, the
    outputs over what the kernel writes."""
    from gpusolve_tpu_torch.ops import spmd_kernels as SK

    d = SK.box_dims(box)
    n = inner(d)
    ins = 2 if name.endswith("_newton") else 1  # f; ũ
    if name.startswith("sweep_block") or name.startswith("residual_block"):
        return 4 * (padded(d) + (ins + 1) * n)
    if name.startswith("residual_restrict_block"):
        cx = (box[1] + 1) // 2 - box[0] // 2 + 1  # coarse planes written
        fields = 2 if name.endswith("_fas") else 1  # R(r); FAS R(v)
        return 4 * (padded(d) + ins * n + (fields * cx + 1) * d[1] * cnz)
    if name == "prolong_add_block":
        c = tuple((hi + 3) // 2 - (lo + 2) // 2 + 1
                  for lo, hi in zip(box[0::2], box[1::2]))
        return 4 * (2 * n + inner(c))
    raise ValueError(name)


def time_block_kernels(base, rate, rows):
    """Each shard-local kernel at the (1,1,1)-mesh 511³ level-0 block, its
    bound, plain version and a PyTorch library call computing the same
    function (the stencil as conv3d; the restriction as stride-2 conv3d;
    the prolongation as conv_transpose3d)."""
    import torch
    import torch.nn.functional as F

    from gpusolve_tpu_torch.config import Mode
    from gpusolve_tpu_torch.dist.spmd import SpmdPlan
    from gpusolve_tpu_torch.ops import kernels as K
    from gpusolve_tpu_torch.ops import spmd_kernels as SK

    torch.backends.cudnn.allow_tf32 = False
    plan = SpmdPlan(base.replace(grid_dim=BIG), (1, 1, 1))
    block, box = plan.block[0], plan.box(0, (0, 0, 0))
    cnz, cbz = plan.dims[1][2], plan.block[1][2]
    v, f, nv, faces = block_inputs(block, box, 800)
    h = base.level_h(0)
    n = inner(SK.box_dims(box))
    out = torch.zeros_like(v)
    cs = (block[0] // 2, block[1], cbz)
    xzr, rlast, xzv = (torch.zeros(cs, device=DEVICE),
                       torch.zeros(cs[1:], device=DEVICE),
                       torch.zeros(cs, device=DEVICE))
    casm = torch.zeros((block[0] // 2 + 2, block[1] // 2 + 2, cbz),
                       device=DEVICE)
    casm[1:-1, 1:-1] = v[::2, ::2, ::2]
    sub = v[0:box[1] + 2, 0:box[3] + 2, 0:box[5] + 2][None, None]
    taps = 2 * len(base.stencil.values)
    s = "511^3 box of a 640^3 block"
    lib_st = lambda: F.conv3d(sub, stencil_filter(base, 1.0 / (h * h)))
    cases = {}
    for mode in Mode:
        p = base.replace(mode=mode, print_progress=False)
        nvm = nv if mode == Mode.NEWTON else None
        extra = {Mode.LINEAR: 0, Mode.NONLINEAR: 4 + EXP_OPS,
                 Mode.NEWTON: 5 + EXP_OPS}[mode]
        lib = lib_st if mode == Mode.LINEAR else None
        sw = K.variant("sweep_block", mode)
        cases[sw] = (
            lambda p=p, nvm=nvm: SK.sweep_block(out, v, f, faces, box, p, h,
                                                nvm),
            lambda p=p, nvm=nvm: SK.sweep_block_plain(out, v, f, faces, box,
                                                      p, h, nvm),
            lib, spmd_kernel_bytes(sw, box), (taps + 4 + extra) * n, s,
        )
        rs = K.variant("residual_block", mode)
        cases[rs] = (
            lambda p=p, nvm=nvm: SK.residual_block(out, v, f, faces, box, p,
                                                   h, newton_v=nvm),
            lambda p=p, nvm=nvm: SK.residual_block_plain(
                out, v, f, faces, box, p, h, newton_v=nvm),
            lib, spmd_kernel_bytes(rs, box), (taps + 1 + extra) * n, s,
        )
        rr = K.variant("residual_restrict_block", mode)
        xv = xzv if mode == Mode.NONLINEAR else None
        cases[rr] = (
            lambda p=p, nvm=nvm, xv=xv: SK.residual_restrict_block(
                xzr, rlast, xv, v, f, faces, box, p, h, cnz, nvm),
            lambda p=p, nvm=nvm, xv=xv: SK.residual_restrict_block_plain(
                xzr, rlast, xv, v, f, faces, box, p, h, cnz, nvm),
            (lambda: F.conv3d(sub, trilinear_filter(0.125), stride=2))
            if mode == Mode.LINEAR else None,
            spmd_kernel_bytes(rr, box, cnz), (taps + 1 + extra + 12) * n, s,
        )
    cases["prolong_add_block"] = (
        lambda: SK.prolong_add_block(out, casm, box),
        lambda: SK.prolong_add_block_plain(out, casm, box),
        lambda: F.conv_transpose3d(casm[None, None], trilinear_filter(1.0),
                                   stride=2),
        spmd_kernel_bytes("prolong_add_block", box), 11.5 * n, s,
    )
    time_cases(cases, rate, rows)


def leg_bytes(mode, kw, box, cbox, S):
    """Bytes one leg must move over ``box``, each input read once and each
    output written once: v (unless it starts from 0), f and ũ over the
    box, v written; the coarse v over the coarse cells the box reads
    (corr-first); the coarse f (FAS also v and rest_v) over the coarse box
    (restrict).  And its operations: per sweep the stencil's taps, the
    update and the mode's term per point; the residual and the weighted
    sums of the restriction (restrict), the residual (norm), the
    prolongation's midpoints (corr-first)."""
    from gpusolve_tpu_torch.config import Mode
    from gpusolve_tpu_torch.ops import spmd_kernels as SK

    n = inner(SK.box_dims(box))
    cn = inner(SK.box_dims(cbox))
    fields = (0 if kw.get("src_zero") else 1) + 1 + (mode == Mode.NEWTON)
    b = 4 * (fields + 1) * n
    if kw.get("corr"):
        b += 4 * n // 8
    taps = 2 * 7
    extra = {Mode.LINEAR: 0, Mode.NONLINEAR: 4 + EXP_OPS,
             Mode.NEWTON: 5 + EXP_OPS}[mode]
    ops = S * (taps + 4 + extra) * n
    consumer = kw.get("consumer")
    if consumer == "restrict":
        b += 4 * (3 if mode == Mode.NONLINEAR else 1) * cn
        ops += (taps + 1 + extra) * n + 6 * n
        if mode == Mode.NONLINEAR:
            ops += 6 * n + (taps + 4 + EXP_OPS) * cn
    elif consumer == "norm":
        ops += (taps + 3 + extra) * n
    if kw.get("corr"):
        ops += 11.5 * n
    return b, ops


def time_leg_kernels(base, rate, rows):
    """Each leg variant at the (1,1,1)-mesh 511³ level-0 block (S = 3, as
    V(3,3) runs it; the corr-first leg too): its ms and device ms (the
    launch alone: the timed calls write the outputs of a first call
    again), bytes and bound, and its plain version's ms; and the level-0
    down leg's slab-reading instantiation (zero slabs, as the one-rank
    halo="rdma" path gives it) by device time beside the slab-free one.
    No single PyTorch call computes S sweeps and a restriction, so
    library_ms is null.  A mode's row in the kernels line is its level-0
    down leg (the restriction), the largest."""
    import torch

    from gpusolve_tpu_torch.config import Mode
    from gpusolve_tpu_torch.dist.spmd import SpmdPlan
    from gpusolve_tpu_torch.ops import kernels as K
    from gpusolve_tpu_torch.ops import spmd_leg as SL

    plan = SpmdPlan(base.replace(grid_dim=BIG), (1, 1, 1))
    box, cbox = plan.box(0, (0, 0, 0)), plan.box(1, (0, 0, 0))
    glob = (0, BIG[0], 0, BIG[1])
    x = leg_inputs(plan.block[0], plan.block[1], box, cbox, 1000)
    S = 3
    for mode in Mode:
        p = base.replace(mode=mode, print_progress=False)
        name = K.variant("leg_block", mode)
        for label, kw in leg_variants(mode):
            args = (p, plan, 0, x, kw)
            opts = dict(box=box, glob=glob, cbox=cbox, S=S)
            opts["outs"] = leg_call(SL.leg_block, *args, **opts)[0]
            ms = cuda_ms(lambda: leg_call(SL.leg_block, *args, **opts), 5)
            plain = cuda_ms(lambda: leg_call(SL.leg_block_plain, *args,
                                             **opts), 1)
            torch.cuda.synchronize()
            nbytes, ops = leg_bytes(mode, kw, box, cbox, S)
            by_bytes, by_ops = nbytes / rate * 1e3, ops / F32_PEAK * 1e3
            bound = max(by_bytes, by_ops)
            bound_by = "bytes" if by_bytes >= by_ops else "operations"
            dev = device_ms(lambda: leg_call(SL.leg_block, *args, **opts),
                            3)
            share = f", {100 * bound / dev:.1f}% of it by device" \
                if dev else ""
            print(f"time {name} {label} (511^3 box of a 640^3 block, S={S}"
                  f"): {ms:.3f} ms, device {fmt_ms(dev)}, {nbytes / 1e9:.3f}"
                  f" GB, bound {bound:.3f} ms by {bound_by} "
                  f"({100 * bound / ms:.1f}% of it{share}), plain "
                  f"{plain:.3f} ms, library —")
            if label != "restrict":
                continue
            rows[name] = {"ms": ms, "device_ms": dev, "plain_ms": plain,
                          "bound_ms": bound, "bound_by": bound_by,
                          "library_ms": None, "library_device_ms": None}
            zx = torch.zeros((SL.G,) + tuple(plan.block[0][1:]),
                             device=DEVICE)
            slabs = {k: (zx, zx, None, None) for k in
                     ("v", "f") + (("nv",) if mode == Mode.NEWTON else ())}
            sdev = device_ms(lambda: leg_call(SL.leg_block, *args,
                                              slabs=slabs, **opts), 3)
            ratio = f" ({sdev / dev:.3f}x the slab-free one)" \
                if sdev and dev else ""
            print(f"time {name} {label} with zero slabs (the slab-reading "
                  f"instantiation): device {fmt_ms(sdev)}{ratio}")
    del x
    torch.cuda.empty_cache()


def chain_bytes(eng, up):
    """Bytes and operations of one chain of ``eng``: its legs' (leg_bytes,
    each input read once and each output written once), with the FAS
    rest_v each up leg below the head reads (sub_rv)."""
    from gpusolve_tpu_torch.ops import spmd_kernels as SK

    p = eng.params
    nbytes = ops = 0
    for l in range(eng.npod):
        box = eng.boxes[l]
        kw = {"corr": True, "consumer": "norm" if l == 0 else None} if up \
            else {"consumer": "restrict", "src_zero": l > 0 and not eng.fas}
        b, o = leg_bytes(p.mode, kw, box, eng.boxes[l + 1],
                         p.post_smoothing if up else p.pre_smoothing)
        if up and eng.fas and l > 0:
            b += 4 * inner(SK.box_dims(box))
        nbytes += b
        ops += o
    return nbytes, ops


def time_pod_kernels(base, rate, rows):
    """pod_down and pod_up at 511³ on the one-rank plan (npod = 1, the
    main path's) and a three-level chain, every mode: ms, bytes and bound,
    the plain version's ms, and the same legs as one leg_block launch each
    (ms).  No single PyTorch call computes a chain of legs: library_ms is
    null.  The kernels line takes the npod = 1 chains."""
    import torch

    import gpusolve_tpu_torch as gt
    from gpusolve_tpu_torch.config import Mode
    from gpusolve_tpu_torch.dist.pod import build_pod_solver
    from gpusolve_tpu_torch.ops import kernels as K
    from gpusolve_tpu_torch.ops import pod as PD

    mesh = gt.make_mesh((1, 1, 1))
    for npod in (1, 3):
        for mode in Mode:
            p = base.replace(mode=mode, grid_dim=BIG, print_progress=False)
            eng = build_pod_solver(p, mesh, npod=npod)
            seeded = seeded_pod_state(eng, 1000 + npod)
            for up in (False, True):
                name = K.variant("pod_up" if up else "pod_down", mode)
                st = clone_state(seeded)
                ms = cuda_ms(lambda: run_chain(eng, st, "kernel", up), 5)
                legs = cuda_ms(lambda: run_chain(eng, st, "legs", up), 5)
                plain = cuda_ms(lambda: run_chain(eng, st, "plain", up), 1)
                nbytes, ops = chain_bytes(eng, up)
                by_bytes, by_ops = nbytes / rate * 1e3, ops / F32_PEAK * 1e3
                bound = max(by_bytes, by_ops)
                bound_by = "bytes" if by_bytes >= by_ops else "operations"
                blocks, per_sm, smem = PD.last_grid[name]
                print(f"time {name} (511^3, npod={npod}, S=3): {ms:.3f} ms, "
                      f"{nbytes / 1e9:.3f} GB, bound {bound:.3f} ms by "
                      f"{bound_by} ({100 * bound / ms:.1f}% of it), the same "
                      f"{npod} legs one launch each {legs:.3f} ms (chain/"
                      f"legs {ms / legs:.3f}), plain {plain:.3f} ms, library "
                      f"—; grid {blocks} blocks ({per_sm} resident an SM), "
                      f"{smem} bytes of shared memory a block")
                if npod == 1:
                    dev = device_ms(lambda: run_chain(eng, st, "kernel", up),
                                    3)
                    print(f"time {name} (511^3, npod=1): device "
                          f"{fmt_ms(dev)}")
                    rows[name] = {"ms": ms, "device_ms": dev,
                                  "plain_ms": plain, "bound_ms": bound,
                                  "bound_by": bound_by, "library_ms": None,
                                  "library_device_ms": None}
                del st
            del eng, seeded
            torch.cuda.empty_cache()


def glue_class(key):
    """The part of the distributed cycle a profiler row belongs to."""
    if re.search(r"pod_kernel", key):
        return "pod chains"
    if re.search(r"rdma_kernel", key):
        return "rdma exchange"
    if re.search(r"sweep_block_kernel|residual_block_kernel|"
                 r"residual_restrict_kernel|prolong_add_block_kernel|"
                 r"leg_kernel", key):
        return "shard-local kernels"
    if re.search(r"jacobi_kernel|residual_kernel|restrict_kernel|"
                 r"prolong_add_kernel|apply_fas_kernel|subtract_kernel|"
                 r"finalize_kernel", key):
        return "replicated-level and norm kernels"
    return "torch glue"


def time_spmd_cycles(params, label, batch_ms, rate, fuse="leg", npod=None,
                     others=(), halo="ppermute", tail="off"):
    """Device ms per distributed cycle at 511³ on the (1,1,1) mesh (CUDA
    events over 10 cycles) on the per-leg (``fuse="leg"``, ``halo``,
    ``tail``: the classic plan or the replicated tail) or the pod engine
    (at its own depth, or ``npod``), beside the batch engine's from the
    same call (and ``others``: (name, ms) of other engines in this call); a
    profiler breakdown into the distributed levels' kernels (the legs, the
    tail plan's junction legs, or the pod chains), the replicated levels'
    kernels (the tail's) and the torch glue, with the glue's launches a
    cycle; the idle share; peak memory.  Returns the device ms a
    cycle."""
    import torch

    import gpusolve_tpu_torch as gt
    from gpusolve_tpu_torch.dist.pod import PodEngine
    from gpusolve_tpu_torch.dist.spmd import build_spmd_solver

    k = 10
    torch.cuda.synchronize()
    base_gib = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    mesh = gt.make_mesh((1, 1, 1))
    eng = PodEngine(params, mesh, npod=npod) if npod else \
        build_spmd_solver(params, mesh, fuse=fuse, halo=halo, tail=tail)
    tail_plan = fuse == "leg" and eng.plan.tail_pv2 is not None
    what = f"pod npod={eng.npod}" if fuse == "pod" else \
        f"spmd tail depth {eng.nd}" if tail_plan else \
        "spmd" if halo == "ppermute" else f"spmd halo={halo}"
    state = eng.init_state()
    sums = torch.empty(k, device=DEVICE)
    eng.run_cycles(state, 2)  # warm
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    for i in range(k):
        eng.cycle(state, sums[i:i + 1])
    b.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / k
    dev = a.elapsed_time(b) / k
    peak = torch.cuda.max_memory_allocated() / 2**30 - base_gib
    beside = "".join(f"; {name} {ms:.3f} ms/cycle in this call "
                     f"({what}/{name} {dev / ms:.3f})" for name, ms in others)
    print(f"{what} cycle {label}: {dev:.3f} ms/cycle device (CUDA events "
          f"over {k} cycles), {wall:.3f} ms/cycle wall; the batch engine "
          f"{batch_ms:.3f} ms/cycle in this call ({what}/batch "
          f"{dev / batch_ms:.3f}){beside}; peak memory of the engine "
          f"{peak:.2f} GiB (state, buffers and temporaries)")
    with Traced() as prof:
        t0 = time.perf_counter()
        for i in range(k):
            eng.cycle(state, sums[i:i + 1])
        torch.cuda.synchronize()
        wall_p = (time.perf_counter() - t0) * 1e3
    busy, any_rows = profile_rows(prof, k, f"{what}-cycle")
    parts, glue_n = {}, 0
    tail_names = {"shard-local kernels": "junction legs",
                  "replicated-level and norm kernels": "tail and norm "
                  "kernels"} if tail_plan else {}
    for ev, us in device_events(prof):
        c = glue_class(ev.key)
        c = tail_names.get(c, c)
        parts[c] = parts.get(c, 0.0) + us / 1e3 / k
        if c == "torch glue":
            glue_n += ev.count
    print(f"profile {what} {label}: {glue_n / k:.1f} torch glue launches "
          "a cycle")
    if any_rows:
        split = "; ".join(f"{c} {ms:.3f} ms ({100 * ms * k / busy:.1f}%)"
                          for c, ms in sorted(parts.items()))
        print(f"profile {what} {label}: {split}; busy {busy / k:.3f} "
              f"ms/cycle -> idle share {1 - busy / (k * dev):.3f} of the "
              f"event time ({dev:.3f} ms), {1 - busy / wall_p:.3f} of the "
              f"profiled wall ({wall_p / k:.3f} ms)")
    else:
        print(f"profile {what}: no device time recorded (not measured)")
    eng.close()
    del state, eng
    torch.cuda.empty_cache()
    return dev



# ---------------------------------------------------------------------------
# The rdma exchange (ops/rdma.py, csrc/rdma_exchange.cu; halo="rdma")
# ---------------------------------------------------------------------------

RDMA_ITERS = 50   # exchanges a rank checks in phase (b)
RDMA_RANKS = (2, 4)
# (label, block, fields, depth) of phase (b)'s odd-shaped case: its slabs
# and its upper slab's offset are not 16-byte multiples (the 4-byte path).
RDMA_ODD = ("odd (9,5,7) blocks", (9, 5, 7), 2, 3)


def rdma_bytes(fields, g, neighbours):
    """Bytes one exchange must move on one rank: each slab sent read once
    and written once (into a neighbour), each edge slab written once."""
    _, by, bz = fields[0].shape
    sb = g * by * bz * fields[0].element_size()
    return len(fields) * sb * (2 + neighbours)


def seeded_blocks(shape, n, seed):
    """``n`` seeded float32 blocks on the card."""
    import torch

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=DEVICE)
            for _ in range(n)]


def check_rdma_kernel(base, rec, rate, rows):
    """Phase (a): rdma_exchange on the one-rank mesh against its plain
    version, bit for bit (the zero fill; the receive buffers are filled
    with NaN first), at the 511³ (1,1,1) plan's level-0 block (640³, 3
    fields, G = 8) and its level-1 block (320³, 1 field, GC = 5); the
    level-0 call's ms, bytes and bound, the plain version's ms (cached
    zeros on one rank) and the library's (one zero_() a slab)."""
    import torch

    import gpusolve_tpu_torch as gt
    from gpusolve_tpu_torch.dist.spmd import SpmdPlan, _Exchange
    from gpusolve_tpu_torch.ops import rdma as RD
    from gpusolve_tpu_torch.ops import spmd_leg as SL

    plan = SpmdPlan(base.replace(grid_dim=BIG), (1, 1, 1))
    ex = _Exchange(gt.make_mesh((1, 1, 1)), plan)
    for l, n, g in ((0, 3, SL.G), (1, 1, SL.GC)):
        fields = seeded_blocks(plan.block[l], n, 2000 + l)
        RD.peer_slabs(ex, fields, g).recv.fill_(float("nan"))
        got = RD.rdma_exchange(fields, ex, g)
        want = RD.rdma_exchange_plain(fields, ex, g)
        torch.cuda.synchronize()
        flat = [t for s in got for t in s[:2]]
        line = rec.fields(flat, [t for s in want for t in s[:2]],
                          f"rdma_exchange {plan.block[l]} x{n} g={g} "
                          "(1,1,1): the zero fill", "rdma_exchange")
        print(f"check {line}")
        check(rec.same["rdma_exchange"], "rdma_exchange: not bit-identical")
        if l:
            dev = device_ms(lambda: RD.rdma_exchange(fields, ex, g))
            lib_dev = device_ms(lambda: [t.zero_() for t in flat])
            bound = rdma_bytes(fields, g, 0) / rate * 1e3
            print(f"time rdma_exchange ({plan.block[l]} block, {n} field, "
                  f"g={g}, one rank: the zero fill): device: kernel "
                  f"{fmt_ms(dev)}, library {fmt_ms(lib_dev)} ({2 * n} "
                  f"zero_() calls), bound {bound:.4f} ms by bytes")
            continue
        ms = cuda_ms(lambda: RD.rdma_exchange(fields, ex, g), 20)
        plain = cuda_ms(lambda: RD.rdma_exchange_plain(fields, ex, g), 20)
        lib_ms = cuda_ms(lambda: [t.zero_() for t in flat], 20)
        dev = device_ms(lambda: RD.rdma_exchange(fields, ex, g))
        lib_dev = device_ms(lambda: [t.zero_() for t in flat])
        nbytes = rdma_bytes(fields, g, 0)
        bound = nbytes / rate * 1e3
        print(f"time rdma_exchange ({plan.block[l]} block, {n} fields, "
              f"g={g}, one rank: the zero fill): {ms:.4f} ms, "
              f"{nbytes / 1e9:.4f} GB, bound {bound:.4f} ms by bytes "
              f"({100 * bound / ms:.1f}% of it), plain {plain:.4f} ms "
              f"(cached zeros), library {lib_ms:.4f} ms ({2 * n} zero_() "
              f"calls); device: kernel {fmt_ms(dev)}, library "
              f"{fmt_ms(lib_dev)}")
        rows["rdma_exchange"] = {"ms": ms, "device_ms": dev,
                                 "plain_ms": plain, "bound_ms": bound,
                                 "bound_by": "bytes", "library_ms": lib_ms,
                                 "library_device_ms": lib_dev}
        del fields, got, want, flat
    ex.close()
    torch.cuda.empty_cache()


def spawn_ranks(fn, m, args, what, limit):
    """``fn(rank, m, store, out_dir, *args)`` on ``m`` spawned processes
    (a gloo group over a FileStore); their results, one dict a rank.  Any
    failing rank, or no end in ``limit`` s, fails the run."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            fn, args=(m, os.path.join(tmp, "store"), tmp, *args),
            nprocs=m, join=False, start_method="spawn")
        deadline = time.monotonic() + limit
        failed = None
        try:
            while not ctx.join(timeout=5):
                check(time.monotonic() < deadline,
                      f"{what} m={m}: no end in {limit} s")
        except (mp.ProcessRaisedException,
                mp.ProcessExitedException) as e:
            failed = e
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.terminate()
        results = []
        for rank in range(m):
            path = os.path.join(tmp, f"rank{rank}.json")
            if os.path.exists(path):
                with open(path) as f:
                    results.append(json.load(f))
        if failed is not None:  # what the ranks did before it, then why
            for res in results:
                for ln in res["lines"]:
                    print(ln)
            raise SmokeFailure(f"{what} m={m}: {failed}") from failed
        check(len(results) == m, f"{what} m={m}: {len(results)} results")
    bad = [f"rank {r['rank']}: {r.get('error')}" for r in results
           if not r["ok"]]
    check(not bad, f"{what} m={m}: {'; '.join(bad)}")
    return results


def _rdma_rank(rank, m, store_path, out_dir):
    """Phase (b) on one of ``m`` processes sharing the card: see
    rdma_ranks.  Writes its lines, numbers and verdict to
    ``out_dir/rank{rank}.json``."""
    sys.path.insert(0, HERE)
    import torch
    import torch.distributed as dist

    import gpusolve_tpu_torch as gt
    from gpusolve_tpu_torch.dist.mesh import Mesh
    from gpusolve_tpu_torch.dist.spmd import SpmdPlan, _Exchange
    from gpusolve_tpu_torch.ops import kernels as K
    from gpusolve_tpu_torch.ops import rdma as RD
    from gpusolve_tpu_torch.ops import spmd_leg as SL

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, m),
                            rank=rank, world_size=m)
    result = {"rank": rank, "ok": False, "lines": [], "times": {}}
    try:
        group = dist.group.WORLD
        coords = (rank, 0, 0)
        params = gt.parse_config(CONFS["linear"], grid_dim=BIG)
        plan = SpmdPlan(params, (m, 1, 1))
        ex = _Exchange(Mesh((m, 1, 1), coords, rank, group,
                            torch.device(DEVICE)), plan)
        host = _Exchange(Mesh((m, 1, 1), coords, rank, group,
                              torch.device("cpu")), plan)
        neighbours = (rank > 0) + (rank < m - 1)
        rate = mem_rate(torch.cuda.get_device_name(0))
        cases = ((f"511^3 ({m},1,1) level-0 blocks", plan.block[0], 3,
                  SL.G), RDMA_ODD)
        for ci, (label, shape, n, g) in enumerate(cases):
            fields = seeded_blocks(shape, n, 3000 + 100 * ci + 10 * rank)
            launched = K.launches["rdma_exchange"]
            for it in range(RDMA_ITERS):
                for u in fields:
                    u.add_(1.0)  # new contents every exchange
                got = RD.rdma_exchange(fields, ex, g)
                got = [t.cpu() for s in got for t in s[:2]]
                # The plain version on CPU copies of the planes it reads
                # (the first and last g of each block).
                faces = [torch.cat([u[:g], u[-g:]]).cpu() for u in fields]
                want = [t for s in RD.rdma_exchange_plain(faces, host, g)
                        for t in s[:2]]
                bad = [i for i, (a, b) in enumerate(zip(got, want))
                       if not torch.equal(a, b)]
                if bad:
                    raise RuntimeError(f"{label}: exchange {it}: slabs {bad} "
                                       "differ from the plain version")
            check(K.launches["rdma_exchange"] - launched == RDMA_ITERS,
                  f"{label}: {K.launches['rdma_exchange'] - launched} "
                  "launches")
            result["lines"].append(
                f"rank {rank}/{m} {label} x{n} g={g}: {RDMA_ITERS} "
                "exchanges bit-identical to the plain version")
            # Times: the kernel alone (no barrier), the wrapper with its
            # host barriers, and the library's copy_/zero_ a slab into the
            # IPC-opened peer buffers, all ranks at once.
            reg = RD.peer_slabs(ex, fields, g)
            by, bz = shape[1:]
            peer = {side: RD._as_tensor(ptr, (2 * n, g, by, bz),
                                        torch.float32)
                    for side, ptr in (("lo", reg.peer_lo),
                                      ("hi", reg.peer_hi)) if ptr}

            def library():
                for i, u in enumerate(fields):
                    if "lo" in peer:
                        peer["lo"][2 * i + 1].copy_(u[:g])
                    else:
                        reg.recv[2 * i].zero_()
                    if "hi" in peer:
                        peer["hi"][2 * i].copy_(u[-g:])
                    else:
                        reg.recv[2 * i + 1].zero_()

            times = {}
            for what, fn in (("kernel", lambda: reg.launch(fields)),
                             ("library", library)):
                torch.cuda.synchronize()
                dist.barrier(group)
                times[what] = cuda_ms(fn, 20)
            torch.cuda.synchronize()
            dist.barrier(group)
            t0 = time.perf_counter()
            for _ in range(10):
                RD.rdma_exchange(fields, ex, g)
            times["wrapper_wall"] = (time.perf_counter() - t0) * 1e2
            nbytes = rdma_bytes(fields, g, neighbours)
            times["bound"] = nbytes / rate * 1e3
            result["times"][label] = times
            result["lines"].append(
                f"time rdma_exchange rank {rank}/{m} {label} x{n} g={g} "
                f"({neighbours} neighbours): kernel {times['kernel']:.4f} ms "
                f"(CUDA events, {m} processes time-slicing the card), "
                f"{nbytes / 1e9:.4f} GB, bound {times['bound']:.4f} ms by "
                f"bytes, library {times['library']:.4f} ms ({2 * n} "
                f"copy_/zero_ calls), wrapper with its host barriers "
                f"{times['wrapper_wall']:.3f} ms wall")
            del fields, got, peer
        ex.close()
        result["ok"] = True
    except Exception as e:
        result["error"] = f"{type(e).__name__}: {e}"
        raise  # the parent stops the other ranks and fails
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(result, f)
        if result["ok"]:
            dist.destroy_process_group()


def rdma_ranks():
    """Phase (b): m = 2 and m = 4 processes on the one card (spawned; a
    gloo group over a FileStore carries the IPC handles and the
    barriers; the library built by this process before the spawn), each
    rank one shard of the (m,1,1) plan's 511³ level-0 blocks (3 fields,
    G = 8) and of an odd-shaped case: RDMA_ITERS exchanges with new
    contents each, every slab bit-identical to the plain version over the
    same group on CPU copies; then the kernel's, the library's and the
    wrapper's times.  Any failing rank fails the run."""
    for m in RDMA_RANKS:
        for res in spawn_ranks(_rdma_rank, m, (), "rdma ranks", 420):
            for ln in res["lines"]:
                print(f"check {ln}" if "bit-identical" in ln else ln)


def rdma_main_path(params, label, leg_hist, k=10):
    """Phase (c): solve_spmd (Newton: newton_solve_spmd) with
    halo="rdma" on make_mesh((1,1,1)): plan.rdma_active, launch counts
    equal to launches_per_cycle's schedule (one rdma_exchange a leg, two a
    corr-first leg), and the halo="ppermute" history of the same call bit
    for bit."""
    import torch

    from gpusolve_tpu_torch.ops import kernels as K

    K.reset_launches()
    with counting_spmd_inner() as inner_cycles:
        state, hist, plan, secs = run_spmd(params, k, halo="rdma")
    counts = nonzero(K.launches)
    print(f"rdma path {label}: mesh (1,1,1), rdma_active "
          f"{plan.rdma_active}, {len(hist) - 1} steps in {secs:.3f} s wall, "
          f"history {hist}")
    print(f"rdma path {label} launches: {counts}")
    check(plan.rdma_active, f"rdma {label}: plan.rdma_active is False")
    want = spmd_expected(plan, hist, inner_cycles)
    check(counts == want,
          f"rdma {label}: launch counts {counts} != schedule {want}")
    check(hist == leg_hist,
          f"rdma {label}: {hist} != halo='ppermute' {leg_hist}")
    print(f"rdma {label} vs halo='ppermute': identical")
    plan._engine.close()
    del state
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# The pod chains' in-kernel exchange on ranks that share the card
# ---------------------------------------------------------------------------

# Processes spawned on the card -> the meshes their chains run on; the
# engine runs on POD_ENGINE_MESHES.
POD_RANKS = {2: ((2, 1, 1),), 4: ((4, 1, 1), (2, 2, 1))}
POD_ENGINE_MESHES = ((2, 1, 1), (2, 2, 1))
POD_RANK_ITERS = 20   # launches a chain, new contents each
POD_RANK_SMALL = ((15, 15, 15), (33, 17, 9))


def fill_pod_state(eng, state, seed):
    """Seeded v (0.05), f (100), ũ (0.3) and rest_v (0.05) on levels
    0..nd of ``state`` in place, inside each box (normal numbers drawn on
    the card from a generator seeded with ``seed``)."""
    import torch

    from gpusolve_tpu_torch.ops import spmd_kernels as SK

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    for l in range(eng.nd + 1):
        lvl, box = state.levels[l], eng.boxes[l]
        for name, scale in (("v", 0.05), ("f", 100.0), ("newton_v", 0.3),
                            ("rest_v", 0.05)):
            t = getattr(lvl, name)
            if t is not None:
                t[SK.box_slices(box)] = scale * torch.randn(
                    SK.box_dims(box), generator=gen, device=DEVICE)


def run_rank_chain(eng, state, how, up):
    """The whole down (or up) chain of a multi-rank pod engine over
    ``state``: its kernel with the in-kernel exchange ("kernel"), its
    plain version with the host exchange ("plain"), or one leg_block
    launch a leg with the host exchange ("legs"); the up chain prolongs
    this rank's window of the tail root's v.  Returns the norm partials
    (up) or None."""
    from gpusolve_tpu_torch.ops import pod as PD
    from gpusolve_tpu_torch.ops import spmd_leg as SL

    p, levels = eng.params, list(state.levels)
    S = p.post_smoothing if up else p.pre_smoothing
    legs = eng.up_legs(0, levels, eng._root_coarse(levels[eng.npod])) \
        if up else eng.down_legs(0, levels)
    if how == "kernel":
        return eng._run_chain(up, 0, legs)
    if how == "plain":
        return (PD.pod_up_plain if up else PD.pod_down_plain)(
            legs, p, S, eng.exchange)
    part = None
    for leg in legs:
        slabs = {name: eng.exchange(t, g)
                 for name, t, g in PD._leg_fields(leg, p.mode)}
        cslabs = slabs.pop("c", None)
        out = SL.leg_block(leg.v_out, leg.v, leg.f, slabs, leg.box,
                           leg.glob, p, leg.h, S, **leg.kwargs(cslabs))
        if out is not None:
            part = out
    return part


def exchange_bytes(peers):
    """Bytes a rank's chain moves between ranks: each slab it sends read
    once and written once into the neighbour's buffer."""
    n = 0
    for x in peers.layout.sets:
        bx, by, bz = x.shape
        for ax in (0, 1):
            sends = sum((ax, s) in peers.peers for s in (-1, 1))
            rows = by + 2 * x.g if peers.layout.ys else by
            n += sends * (x.g * rows * bz if ax == 0 else bx * x.g * bz)
    return 8 * n


def pod_rank_cases(p, mesh_shape):
    """(dims, npod) of the chain checks on a mesh: the 511³ grid at
    choose_npod's depth and at depth 1, and POD_RANK_SMALL at the depths
    1 and 2 the gates allow."""
    from gpusolve_tpu_torch.dist.pod import PodPlan, choose_npod

    mxy = (mesh_shape[0], mesh_shape[1] * mesh_shape[2])
    d = choose_npod(p.replace(grid_dim=BIG), mxy)
    cases = [(BIG, d)] + ([(BIG, 1)] if d != 1 else [])
    for dims in POD_RANK_SMALL:
        q = p.replace(grid_dim=dims)
        cases += [(dims, n) for n in (1, 2) if len(q.level_dims()) > n
                  and PodPlan(q, mesh_shape, n).refusal() is None]
    return cases


@contextlib.contextmanager
def counting_slabs():
    """Counts the host slab exchanges (_Exchange.slabs)."""
    from gpusolve_tpu_torch.dist import spmd as tsp

    calls = {"n": 0}
    fn = tsp._Exchange.slabs

    def counted(self, *args, **kwargs):
        calls["n"] += 1
        return fn(self, *args, **kwargs)

    tsp._Exchange.slabs = counted
    try:
        yield calls
    finally:
        tsp._Exchange.slabs = fn


def _rank_chains(mesh, rate, result):
    """The chain checks of one mesh on this rank (see pod_ranks)."""
    import dataclasses

    import torch

    import gpusolve_tpu_torch as gt
    from gpusolve_tpu_torch.config import Mode
    from gpusolve_tpu_torch.dist.pod import build_pod_solver
    from gpusolve_tpu_torch.ops import kernels as K
    from gpusolve_tpu_torch.ops import pod as PD

    rank, m = mesh.rank, mesh.size
    base = gt.parse_config(CONFS["linear"], print_progress=False)
    for dims, npod in pod_rank_cases(base, mesh.shape):
        for mode in Mode:
            p = base.replace(mode=mode, grid_dim=dims)
            eng = build_pod_solver(p, mesh, npod=npod)
            tag = (f"{'x'.join(map(str, dims))} {mesh.shape} npod={npod} "
                   f"{mode.name} blocks "
                   f"{[eng.plan.shape(l) for l in range(npod + 1)]}")
            seeded = eng.init_state()
            # At the small shapes also the plain chains on CPU copies over
            # the same group (the 511³ ones would take minutes a launch).
            ceng = None if dims == BIG else build_pod_solver(
                p, dataclasses.replace(mesh, device=torch.device("cpu")),
                npod=npod)
            stats = {}
            for it in range(POD_RANK_ITERS):
                fill_pod_state(eng, seeded, 9000 + 97 * it + rank)
                for up in (False, True):
                    name = K.variant("pod_up_ranks" if up
                                     else "pod_down_ranks", mode)
                    res = {}
                    # The legs one by one on the first launch of a case.
                    hows = ("kernel", "plain", "legs")[:3 if it == 0 else 2]
                    for how in hows + (("cpu",) if ceng is not None
                                       else ()):
                        on = ceng if how == "cpu" else eng
                        st = host_state(seeded) if how == "cpu" else \
                            clone_state(seeded)
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        part = run_rank_chain(
                            on, st, "plain" if how == "cpu" else how, up)
                        torch.cuda.synchronize()
                        wall = (time.perf_counter() - t0) * 1e3
                        ss = None
                        if part is not None:
                            ss = st.levels[0].v.new_empty(1)
                            (K.finalize_plain if how in ("plain", "cpu")
                             else K.finalize)(part, ss)
                            ss = float(ss)
                        got = pod_fields(st, npod) + [
                            t.clone() for t in on._boundary()]
                        res[how] = (got, ss, wall)
                        del st
                    got, ss_k, wall = res["kernel"]
                    bad = [i for i, (a, b) in enumerate(zip(got,
                                                            res["plain"][0]))
                           if not torch.equal(a, b)]
                    check(not bad, f"{name} rank {rank} {tag} launch {it}: "
                          f"fields {bad} differ from the plain version")
                    if it == 0:
                        bad = [i for i, (a, b) in enumerate(
                            zip(got, res["legs"][0])) if not torch.equal(a, b)]
                        check(not bad and ss_k == res["legs"][1],
                              f"{name} rank {rank} {tag}: != its legs one "
                              f"by one (fields {bad}, norm {ss_k} vs "
                              f"{res['legs'][1]})")
                    if ss_k is not None:
                        ssp = res["plain"][1]
                        check(abs(ss_k - ssp) <= RTOL * abs(ssp),
                              f"{name} rank {rank} {tag}: norm {ss_k} vs "
                              f"plain {ssp}")
                    peers = eng.ex.rdma[("pod", up, 0)]
                    s = stats.setdefault(name, {"wall": [], "plain": [],
                                                "waits": [], "norm_same": True,
                                                "cpu_err": 0.0,
                                                "cpu_same": True})
                    if ceng is not None:
                        # LINEAR bit for bit; FAS and NEWTON within RTOL
                        # (the CPU's exp rounds apart from CUDA's).
                        for a, b in zip(got, res["cpu"][0]):
                            a = a.cpu()
                            diff = float((a - b).abs().max())
                            s["cpu_err"] = max(s["cpu_err"], diff)
                            s["cpu_same"] &= bool(torch.equal(a, b))
                            check(diff <= RTOL * float(b.abs().max())
                                  and (mode != Mode.LINEAR
                                       or torch.equal(a, b)),
                                  f"{name} rank {rank} {tag} launch {it}: "
                                  f"{diff:.3e} from the plain chain on CPU "
                                  "copies")
                    s["wall"].append(wall)
                    s["plain"].append(res["plain"][2])
                    s["waits"].append(peers.last_waits_ms())
                    if ss_k is not None:
                        s["norm_same"] &= ss_k == res["plain"][1]
                del res, got
            for up in (False, True):
                name = K.variant("pod_up_ranks" if up else "pod_down_ranks",
                                 mode)
                s = stats[name]
                peers = eng.ex.rdma[("pod", up, 0)]
                waits = [sum(w) / len(w) for w in zip(*s["waits"])]
                blocks, per_sm, smem = PD.last_grid[name]
                result["lines"].append(
                    f"check {name} rank {rank}/{m} {tag}: "
                    f"{POD_RANK_ITERS} launches, every field bit-identical "
                    f"to the plain version over the group, the first also "
                    f"to the legs one by one (and its norm); norm vs plain "
                    f"identical {s['norm_same']}; grid {blocks} blocks "
                    f"({per_sm} an SM), {smem} bytes of shared memory a "
                    "block" + ("" if ceng is None else
                               f"; the plain chain on CPU copies over the "
                               f"group: identical {s['cpu_same']}, max abs "
                               f"err {s['cpu_err']:.3e}"))
                steps = " ".join(f"{ph}{'xy'[ax]}:{w:.3f}" for (ph, ax), w
                                 in zip(peers.layout.steps, waits[1:]))
                wall = sorted(s["wall"])[len(s["wall"]) // 2]
                plain = sorted(s["plain"])[len(s["plain"]) // 2]
                result["lines"].append(
                    f"time {name} rank {rank}/{m} {tag} ({m} processes "
                    f"time-slicing the card): launch to sync {wall:.3f} ms "
                    f"(median), plain {plain:.3f} ms; mean waits ms: start "
                    f"{waits[0]:.3f}, by step (phase, axis) {steps}")
                if dims == BIG and npod != 1 and mesh.shape == (2, 1, 1):
                    nbytes, ops = chain_bytes(eng, up)
                    nbytes += exchange_bytes(peers)
                    bound = max(nbytes / rate, ops / F32_PEAK) * 1e3
                    result["rows"][name] = {
                        "ms": wall, "device_ms": None, "plain_ms": plain,
                        "bound_ms": bound,
                        "bound_by": "bytes" if nbytes / rate
                        >= ops / F32_PEAK else "operations",
                        "library_ms": None, "library_device_ms": None}
            eng.close()
            del eng, seeded, ceng
            torch.cuda.empty_cache()


def _rank_engine(mesh, batch_hist, result):
    """The engine checks of one mesh on this rank (see pod_ranks)."""
    import torch

    import gpusolve_tpu_torch as gt
    from gpusolve_tpu_torch.dist.pod import choose_npod
    from gpusolve_tpu_torch.ops import kernels as K

    rank, m = mesh.rank, mesh.size
    for label in ("linear", "nonlinear", "newton"):
        newton = label == "newton"
        params = gt.parse_config(CONFS[label], grid_dim=BIG,
                                 maxiter=2 if newton else 5,
                                 print_progress=False)

        def run(p, fuse):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if newton:
                state, hist, plan = gt.newton_solve_spmd(p, mesh, fuse=fuse)
            else:
                state, hist, plan = gt.solve_spmd(p, mesh, fuse=fuse)
            torch.cuda.synchronize()
            return state, hist, plan, time.perf_counter() - t0

        K.reset_launches()
        with counting_spmd_inner() as inner, counting_slabs() as slabs:
            state, hist, plan, secs = run(params, "pod")
        counts = nonzero(K.launches)
        want = spmd_expected(plan, hist, inner)
        tag = f"511^3 {label} {mesh.shape}"
        depth = choose_npod(params, (plan.mesh_shape[0],
                                     plan.mesh_shape[1]))
        check(plan.npod == depth, f"pod ranks {tag}: depth {plan.npod}, "
              f"choose_npod {depth}")
        check(counts == want, f"pod ranks {tag} rank {rank}: launches "
              f"{counts} != schedule {want}")
        check("rdma_exchange" not in counts and slabs["n"] == 0,
              f"pod ranks {tag}: {slabs['n']} host slab exchanges, "
              f"{counts.get('rdma_exchange', 0)} rdma_exchange launches")
        result["counts"].append(counts)
        result["lines"].append(
            f"pod ranks path {tag} rank {rank}/{m}: depth {plan.npod} "
            f"(blocks {[plan.shape(l) for l in range(plan.npod + 1)]}), "
            f"{len(hist) - 1} steps in {secs:.3f} s wall, history {hist}; "
            f"launches {counts} = the schedule; 0 host slab exchanges")
        # ms a cycle on this rank: 5 more cycles of the same engine.
        eng = plan._engine
        if not newton:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.run_cycles(state, 5)
            ms = (time.perf_counter() - t0) * 1e3 / 5
            waits = {f"{'up' if k[1] else 'down'}": [
                round(w, 3) for w in r.last_waits_ms()]
                for k, r in eng.ex.rdma.items() if k[0] == "pod"}
            result["lines"].append(
                f"time pod ranks cycle {tag} rank {rank}/{m}: {ms:.3f} ms a "
                f"V(3,3) cycle by the host clock ({m} processes "
                f"time-slicing the card), the last cycle's waits ms "
                f"(start, then each step) {waits}")
        eng.close()
        del state, eng
        K.reset_launches()
        _, ref_hist, _, ref_secs = run(params.replace(backend="ref"), "pod")
        check(all(n == 0 for n in K.launches.values()),
              f"pod ranks {tag}: the plain pod path launched a kernel")
        check(hist[:len(ref_hist)] == ref_hist,
              f"pod ranks {tag}: kernels {hist} != plain ops {ref_hist}")
        _, leg_hist, leg_plan, leg_secs = run(params, "leg")
        leg_plan._engine.close()
        worst = {}
        for what, other in (("per-leg engine", leg_hist),
                            ("batch engine", batch_hist[label])):
            n = min(len(hist), len(other))
            worst[what] = histories_agree(hist[:n], other[:n],
                                          f"pod ranks {tag} vs {what}",
                                          floor=1e-2)
        result["lines"].append(
            f"check pod ranks {tag} rank {rank}/{m}: identical to the plain "
            f"ops on the card ({ref_secs:.1f} s); worst rel diff vs the "
            f"per-leg engine on the same ranks {worst['per-leg engine']:.3e}"
            f" ({leg_secs:.1f} s), vs the single-device batch engine "
            f"{worst['batch engine']:.3e}")
        torch.cuda.empty_cache()


def _pod_rank(rank, m, store_path, out_dir, meshes, batch_hist):
    """One of ``m`` processes sharing the card: see pod_ranks.  Writes its
    lines, rows, counts and verdict to ``out_dir/rank{rank}.json``."""
    sys.path.insert(0, HERE)
    import torch
    import torch.distributed as dist

    from gpusolve_tpu_torch.dist.mesh import Mesh, coords_of

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, m),
                            rank=rank, world_size=m)
    result = {"rank": rank, "ok": False, "lines": [], "rows": {},
              "counts": []}
    try:
        rate = mem_rate(torch.cuda.get_device_name(0))
        for shape in meshes:
            mesh = Mesh(shape, coords_of(rank, shape), rank,
                        dist.group.WORLD, torch.device(DEVICE))
            _rank_chains(mesh, rate, result)
            if shape in POD_ENGINE_MESHES:
                _rank_engine(mesh, batch_hist, result)
        result["ok"] = True
    except Exception as e:
        result["error"] = f"{type(e).__name__}: {e}"
        raise  # the parent stops the other ranks and fails
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(result, f)
        if result["ok"]:
            dist.destroy_process_group()


def _timeout_rank(rank, m, store_path, out_dir):
    """A wait past its limit (see pod_ranks): on a (2,1,1) mesh both ranks
    build a down chain's peer registry; rank 0 launches the chain alone
    with a 1 s limit and must get the wrapper's RuntimeError naming the
    chain, the rank and the wait; rank 1 launches nothing."""
    sys.path.insert(0, HERE)
    import torch
    import torch.distributed as dist

    import gpusolve_tpu_torch as gt
    from gpusolve_tpu_torch.dist.mesh import Mesh, coords_of
    from gpusolve_tpu_torch.dist.pod import build_pod_solver
    from gpusolve_tpu_torch.ops import pod as PD

    torch.cuda.set_device(0)
    store = dist.FileStore(store_path, m)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=m)
    result = {"rank": rank, "ok": False, "lines": [], "rows": {},
              "counts": []}
    try:
        shape = (m, 1, 1)
        mesh = Mesh(shape, coords_of(rank, shape), rank, dist.group.WORLD,
                    torch.device(DEVICE))
        p = gt.parse_config(CONFS["linear"], grid_dim=(63, 63, 63),
                            print_progress=False)
        eng = build_pod_solver(p, mesh, npod=1)
        legs = eng.down_legs(0, list(eng.init_state().levels))
        peers = PD.ChainPeers(eng.ex, legs, p, False)
        PD.WAIT_LIMIT_S = 1.0
        if rank == 0:
            t0 = time.perf_counter()
            msg = "no error"
            try:
                PD.pod_down(legs, p, p.pre_smoothing, eng.exchange, peers)
            except RuntimeError as e:
                msg = str(e)
            secs = time.perf_counter() - t0
            result["lines"].append(
                f"check pod ranks timeout: rank 0 launched pod_down_ranks "
                f"alone (wait limit {PD.WAIT_LIMIT_S:g} s): after "
                f"{secs:.2f} s {msg.splitlines()[0]}")
            store.set("timeout_done", "1")
            check("pod_down_ranks on rank 0" in msg
                  and "start barrier" in msg, f"no timeout error: {msg}")
        else:
            store.wait(["timeout_done"])
        result["ok"] = True
    except Exception as e:
        result["error"] = f"{type(e).__name__}: {e}"
        raise
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(result, f)


def pod_cycle_times(reps=3):
    """ms a 511³ V(3,3) cycle (LINEAR, FAS) of the one-rank pod engine,
    CUDA events over 10 cycles, ``reps`` times: the one-rank chains'
    times, for a comparison of two trees in one call."""
    import torch

    import gpusolve_tpu_torch as gt
    from gpusolve_tpu_torch.dist.pod import build_pod_solver

    mesh = gt.make_mesh((1, 1, 1))
    for label in ("linear", "nonlinear"):
        p = gt.parse_config(CONFS[label], grid_dim=BIG, print_progress=False)
        eng = build_pod_solver(p, mesh)
        state = eng.init_state()
        sums = torch.empty(10, device=DEVICE)
        eng.run_cycles(state, 2)
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            for i in range(10):
                eng.cycle(state, sums[i:i + 1])
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b) / 10)
        print(f"pod one-rank cycle 511^3 {p.mode.name} V(3,3) npod="
              f"{eng.npod}: {' '.join(f'{t:.4f}' for t in times)} ms/cycle "
              f"(CUDA events over 10 cycles, {reps} runs) in {HERE}")
        eng.close()
        del eng, state
        torch.cuda.empty_cache()


def pod_ranks(rows, launched, rec=None):
    """The pod chains' in-kernel exchange on 2 and 4 processes sharing the
    card (spawned; a gloo group over a FileStore carries the IPC handles
    and the host exchange of the references; the library built by this
    process before the spawn).  On each mesh: pod_down / pod_up in every
    mode, at 511³ (choose_npod's depth and depth 1) and at POD_RANK_SMALL,
    POD_RANK_ITERS launches each with new contents, every field (and the
    boundary block) bit for bit their plain versions over the same group
    on the card, the first launch also the legs one by one through
    leg_block with the host exchange and their norm (the plain's within
    RTOL), and at POD_RANK_SMALL the plain chains on CPU copies (LINEAR
    bit for bit, FAS and NEWTON within RTOL); the waits per step and the
    times, labelled time-sliced.  On POD_ENGINE_MESHES:
    solve_spmd (LINEAR, FAS V(3,3), 5 cycles) and newton_solve_spmd (2
    steps) with fuse="pod" at 511³: launch counts equal to the schedule,
    no host slab exchange and no rdma_exchange; the history equal to the
    plain ops' on the card and within rel 2e-4 above 1e-2·initial of the
    per-leg engine on the same ranks and of the single-device batch
    engine.  Then a wait past its limit (_timeout_rank).  Merges the
    engine's launches (summed over the ranks) into ``launched`` and the
    kernels-line rows into ``rows``."""
    import torch

    import gpusolve_tpu_torch as gt

    batch_hist = {}
    for label in ("linear", "nonlinear", "newton"):
        newton = label == "newton"
        p = gt.parse_config(CONFS[label], grid_dim=BIG,
                            maxiter=2 if newton else 5, print_progress=False)
        state = gt.build_grid(p)
        _, batch_hist[label] = (gt.newton_solve if newton else gt.solve)(
            state, p)
        del state
        torch.cuda.empty_cache()
    for m, meshes in POD_RANKS.items():
        t0 = time.perf_counter()
        results = spawn_ranks(_pod_rank, m, (meshes, batch_hist),
                              "pod ranks", 900)
        print(f"pod ranks m={m} on {list(meshes)}: "
              f"{time.perf_counter() - t0:.1f} s")
        for res in results:
            for ln in res["lines"]:
                print(ln)
            for counts in res["counts"]:
                for kname, n in counts.items():
                    launched[kname] = launched.get(kname, 0) + n
            for kname, row in res["rows"].items():
                rows.setdefault(kname, row)
                if rec is not None:  # every check above is bit for bit
                    rec.errs[kname] = 0.0
    for res in spawn_ranks(_timeout_rank, 2, (), "pod ranks timeout", 180):
        for ln in res["lines"]:
            print(ln)


# ---------------------------------------------------------------------------
# The GSPMD engine (dist/sharding.py, dist/gspmd.py) on the (1,1,1) mesh
# ---------------------------------------------------------------------------

GSPMD_CARVE = (127, 127, 127)
GSPMD_SPLIT = (2, 2, 1)


@contextlib.contextmanager
def counting_plain():
    """Counts the calls of every kernel's plain version (``*_plain`` in
    ops/kernels.py) on a CUDA tensor, by name, in the dict it yields."""
    import torch

    from gpusolve_tpu_torch.ops import kernels as K

    calls = {}
    saved = {name: getattr(K, name) for name in dir(K)
             if name.endswith("_plain") and callable(getattr(K, name))}

    def wrap(name, fn):
        def counted(*args, **kwargs):
            if any(isinstance(a, torch.Tensor) and a.is_cuda
                   for a in list(args) + list(kwargs.values())):
                calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        return counted

    for name, fn in saved.items():
        setattr(K, name, wrap(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(K, name, fn)


def check_gspmd_carved(base, rec):
    """A 127³ level (and its 63³ coarse level) cut into the (2,2,1) boxes
    of the engine's own split and box functions (``dist/gspmd.py``:
    ``storage``, ``restrict_box``, ``prolong_boxes``), each box windowed
    from the whole fields with its neighbours' points as ghosts and run
    through the per-op CUDA kernels, the blocks put back together: bit for
    bit the kernels on the whole fields, every mode (the sweep, the
    residual, FAS's operator; the restrictions and the prolongation).
    On one card this is how the kernels read non-zero ghosts as the
    engine feeds them on a mesh."""
    import torch

    from gpusolve_tpu_torch.config import Mode
    from gpusolve_tpu_torch.dist import gspmd
    from gpusolve_tpu_torch.dist import sharding as tsh
    from gpusolve_tpu_torch.dist.mesh import Mesh, coords_of
    from gpusolve_tpu_torch.ops import dispatch
    from gpusolve_tpu_torch.ops import kernels as K
    from gpusolve_tpu_torch.ops import ref

    gen = torch.Generator(device=DEVICE).manual_seed(11)
    n = math.prod(GSPMD_SPLIT)

    def level(p, coords, lev):
        mesh = Mesh(GSPMD_SPLIT, coords, 0, None, torch.device(DEVICE))
        return tsh.level_shardings(p, mesh)[lev]

    def rand(dims):
        t = torch.zeros(tuple(d + 2 for d in dims), device=DEVICE)
        ref.interior(t, dims).copy_(0.3 * torch.randn(
            dims, generator=gen, device=DEVICE))
        return t

    def carve(whole, part, what):
        out = torch.zeros_like(whole)
        K.reset_launches()
        for r in range(n):
            block, values = part(coords_of(r, GSPMD_SPLIT))
            out[tuple(slice(lo, hi) for lo, hi in block)] = values
        launched = nonzero(K.launches)
        same = torch.equal(out, whole)
        check(same, f"gspmd carved {what}: the boxes differ from the "
              "whole field")
        print(f"check gspmd carved {GSPMD_CARVE[0]}^3 {GSPMD_SPLIT} {what}: "
              f"bit-identical={same}, launches {launched}")

    for mode in (Mode.LINEAR, Mode.NONLINEAR, Mode.NEWTON):
        p = base.replace(grid_dim=GSPMD_CARVE, mode=mode)
        h = p.level_h(0)
        dims, cdims = p.level_dims()[:2]
        v, f, nv, vc = rand(dims), rand(dims), rand(dims), rand(cdims)

        def sweep(d, v_, f_, nv_):
            out = torch.zeros_like(v_)
            dispatch.smooth(v_, f_, out, d, p, h, 1, None, nv_)
            return out

        def resid(d, v_, f_, nv_):
            out = torch.zeros_like(v_)
            dispatch.residual_op(out, v_, f_, d, p, h, newton_v=nv_)
            return out

        def fas_op(d, v_, f_, nv_):
            out = f_.clone()
            dispatch.apply_fas_op(out, v_, d, p, h)
            return out

        ops = [("sweep", sweep), ("residual", resid)]
        if mode == Mode.NONLINEAR:
            ops.append(("apply_fas", fas_op))
        for name, op in ops:
            def part(coords, op=op):
                sh = level(p, coords, 0)
                box = gspmd.storage(sh)
                res = op(sh.local_dims, *(gspmd.window(t, box).contiguous()
                                          for t in (v, f, nv)))
                return (tuple((lo + 1, hi - 1) for lo, hi in box),
                        ref.interior(res, sh.local_dims))

            carve(op(dims, v, f, nv), part, f"{name} {mode.name}")
        if mode != Mode.LINEAR:
            continue

        def restricted(coords, zero):
            shc = level(p, coords, 1)
            cd = shc.local_dims
            fine = gspmd.window(v, gspmd.restrict_box(shc, coords))
            fine = fine.contiguous()
            out = torch.zeros(tuple(d + 2 for d in cd), device=DEVICE)
            fd = tuple(2 * d + 1 for d in cd)
            if zero:
                dispatch.restrict_zero_op(out, torch.ones_like(out), fine, fd,
                                          cd, p)
            else:
                dispatch.restrict_op(out, fine, fd, cd, p)
            return (tuple((lo + 1, hi + 1) for lo, hi in shc.box_of(coords)),
                    ref.interior(out, cd))

        for zero, what in ((True, "restrict_zero"), (False, "restrict")):
            whole = torch.zeros_like(vc)
            if zero:
                dispatch.restrict_zero_op(whole, torch.ones_like(vc), v, dims,
                                          cdims, p)
            else:
                dispatch.restrict_op(whole, v, dims, cdims, p)
            carve(whole, lambda c, z=zero: restricted(c, z), what)

        def prolonged(coords):
            shf = level(p, coords, 0)
            fbox, cbox = gspmd.prolong_boxes(shf, coords)
            fine = gspmd.window(v, fbox).clone()
            dispatch.prolong_add_op(fine, gspmd.window(vc, cbox).contiguous(),
                                    gspmd._dims(cbox), gspmd._dims(fbox), p)
            block = tuple((lo + 1, hi + 1) for lo, hi in shf.box_of(coords))
            return block, fine[tuple(slice(lo - o, hi - o) for (lo, hi), (o, _)
                                     in zip(block, fbox))]

        whole = v.clone()
        dispatch.prolong_add_op(whole, vc, cdims, dims, p)
        carve(whole, prolonged, "prolong_add")


def gspmd_expected(params, hist, inner_cycles):
    """Launches of a solve on the GSPMD engine's one-rank mesh: its
    per-cycle loop runs each executed cycle on the per-op schedule
    (launches_per_cycle with both legs refused), one cycle a batch, so no
    cycle is enqueued past the stop; the initial norm; Newton the initial
    F, and per step R(ũ) into levels 1..L−2, the inner cycles and F."""
    from gpusolve_tpu_torch.config import Mode
    from gpusolve_tpu_torch.ops import kernels as K
    from gpusolve_tpu_torch.ops.vcycle_batch import launches_per_cycle

    with per_op_schedule():
        per = launches_per_cycle(params)
    steps = len(hist) - 1
    newton = params.mode == Mode.NEWTON
    cycles = sum(inner_cycles) if newton else steps
    want = {name: 0 for name in K.KERNELS}
    for name, n in per.items():
        want[name] += n * cycles
    norms = steps + 1 if newton else 1
    want["residual_fas" if newton else K.variant("residual", params.mode)] \
        += norms
    want["finalize"] += norms
    if newton:
        want["restrict"] += steps * max(0, params.num_levels - 2)
    return nonzero(want)


def gspmd_main_path(params, label):
    """solve / newton_solve with ``shardings=level_shardings(params,
    make_mesh((1,1,1)))`` at 511³ (Newton: NEWTON_PLAIN_STEPS steps): the
    launch counts of gspmd_expected, no kernel's plain version on a CUDA
    tensor, and the same solve on the single-device per-op schedule
    (check_every=10; Newton the per-step loop): the history and every
    level's fields bit for bit."""
    import torch

    import gpusolve_tpu_torch as gt
    from gpusolve_tpu_torch.config import Mode
    from gpusolve_tpu_torch.ops import kernels as K
    from gpusolve_tpu_torch.ops import vcycle_batch

    newton = params.mode == Mode.NEWTON
    if newton:
        params = params.replace(maxiter=NEWTON_PLAIN_STEPS)
    shs = gt.level_shardings(params, gt.make_mesh((1, 1, 1)))
    solver = gt.newton_solve if newton else gt.solve
    K.reset_launches()
    reads0 = vcycle_batch.host_reads
    with counting_plain() as plain, counting_inner() as inner_cycles:
        state = gt.build_grid(params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, hist = solver(state, params, shardings=shs)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    counts = nonzero(K.launches)
    reads = vcycle_batch.host_reads - reads0
    print(f"gspmd main path {label}: {sum(sh.blocked for sh in shs)} blocked "
          f"levels, {sum(not sh.blocked for sh in shs)} replicated; "
          f"{len(hist) - 1} steps in {secs:.3f} s wall, {reads} host reads, "
          f"inner cycles {inner_cycles}, history {hist}")
    print(f"gspmd main path {label} launches: {counts}")
    check(not plain, f"gspmd {label}: plain ops ran on CUDA tensors: {plain}")
    want = gspmd_expected(params, hist, inner_cycles)
    check(counts == want, f"gspmd {label}: launch counts {counts} != "
          f"schedule {want}")
    with per_op_schedule():
        ref_state, ref_hist, ref_secs = run_solve(params, 1 if newton else 10)
    check(hist == ref_hist, f"gspmd {label}: history {hist} != the per-op "
          f"schedule's {ref_hist}")

    def fields(st):
        return [(f"level {i} {n}", getattr(lvl, n))
                for i, lvl in enumerate(st.levels)
                for n in ("v", "f", "rest_v", "newton_v")
                if getattr(lvl, n) is not None]

    differ = [n for (n, a), (_, b) in zip(fields(state), fields(ref_state))
              if not torch.equal(a, b)]
    check(not differ, f"gspmd {label}: fields differ from the per-op "
          f"schedule's: {differ}")
    print(f"gspmd vs per-op schedule {label}: histories identical True, "
          f"every level's fields bit-identical ({len(fields(state))} "
          f"fields), no plain op on the card; per-op run {ref_secs:.3f} s "
          "wall")
    del state, ref_state
    torch.cuda.empty_cache()
    return counts


def gspmd_cli():
    """--mesh 1,1,1 --dist-engine gspmd on the three examples (127³;
    --validate in modes 1 and 2) with --explain-backend: the engine's
    note and lines, the progress lines, the per-op kernels launched and
    no plain op on the card; --refine on it; and a single-level grid
    (127,127,1), which the spmd engine refuses, under --dist-engine auto:
    the reference's note, then the run."""
    from gpusolve_tpu_torch.ops import kernels as K

    kernel_line = ("backend: dist-engine=gspmd (box fetches over "
                   "torch.distributed; local compute: the per-op CUDA "
                   "kernels on each block (ops/dispatch))")
    with tempfile.TemporaryDirectory() as tmp:
        single = conf_with(tmp, CONFS["nonlinear"], "single.conf",
                           dims=(127, 127, 1))
        runs = [
            (CONFS["linear"], "Solving linear problem", ["--dist-engine",
                                                        "gspmd"]),
            (CONFS["nonlinear"], "Solving nonlinear problem",
             ["--dist-engine", "gspmd"]),
            (CONFS["newton"], "Solving newton problem", ["--dist-engine",
                                                        "gspmd"]),
            (CONFS["linear"], "Solving linear problem",
             ["--dist-engine", "gspmd", "--refine"]),
            (single, "Solving nonlinear problem", []),
        ]
        for conf, line, extra in runs:
            K.reset_launches()
            newton = line == "Solving newton problem"
            # The single-level grid is smoothed only: no --validate.
            validate = line != "Solving linear problem" and \
                extra == ["--dist-engine", "gspmd"]
            args = [conf, "--mesh", "1,1,1", "--explain-backend", *extra]
            args += ["--validate"] if validate else []
            with counting_plain() as plain:
                rc, out, err = run_cli(args)
            what = f"cli --mesh 1,1,1 {' '.join(extra) or '(auto)'} {line}"
            check(rc == 0, f"{what}: exited {rc}")
            lines = out.splitlines()
            check(line in lines, f"{what}: the mode line")
            progress(lines, newton=newton)
            check(kernel_line in err, f"{what}: the engine line")
            if extra:
                check("debugging" in err, f"{what}: the engine's note")
            else:
                check("note: using the gspmd engine (single-level grid)"
                      in err, f"{what}: the fallback note")
            check(not plain, f"{what}: plain ops on the card: {plain}")
            check(K.launches["finalize"] > 0 and sum(
                n for k, n in K.launches.items()
                if k.startswith("jacobi_sweep")) > 0,
                f"{what}: launches {nonzero(K.launches)}")
            if validate:
                m = [ln for ln in lines if ln.startswith("max-abs error")]
                err_v = float(m[0].split(": ")[1])
                check(math.isfinite(err_v) and err_v < 5e-4,
                      f"{what}: max-abs error {err_v}")
            print(f"{what}: rc 0, launches {nonzero(K.launches)}")


def busy_ms(prof):
    """Device ms of every kernel and copy in a Traced window, or None."""
    total = [us for _, us in device_events(prof)]
    return sum(total) / 1e3 if total else None


def time_gspmd(params, label, rate):
    """ms a 511³ cycle on the GSPMD engine's (1,1,1) mesh, in its loop (a
    batch of one cycle and a host read a cycle), beside the single-device
    per-op schedule and the batch engine on its legs (10-cycle batches),
    in turns (gspmd, per-op, legs, legs, per-op, gspmd): CUDA events and
    wall over 10 cycles, launches a cycle, peak memory (the state
    included), then a profiled run each: busy ms a cycle and the idle
    share of the profiled wall.  Returns {engine: [(events, busy), ...]}."""
    import torch

    import gpusolve_tpu_torch as gt
    from gpusolve_tpu_torch.dist import gspmd
    from gpusolve_tpu_torch.ops import dispatch
    from gpusolve_tpu_torch.ops import kernels as K
    from gpusolve_tpu_torch.ops import vcycle_batch

    k = 10
    p = params.replace(print_progress=False)
    shs = gt.level_shardings(p, gt.make_mesh((1, 1, 1)))
    sharded = gspmd.ShardedOps(shs)

    def gspmd_run(state, n):
        for _ in range(n):
            vcycle_batch.run(state, p, maxk=1, ops=sharded)

    def batch_run(state, n):
        vcycle_batch.run(state, p, maxk=n, ops=dispatch)

    engines = {"gspmd": (gspmd_run, contextlib.nullcontext),
               "per-op": (batch_run, per_op_schedule),
               "legs": (batch_run, contextlib.nullcontext)}
    out = {name: [] for name in engines}
    for name in ("gspmd", "per-op", "legs", "legs", "per-op", "gspmd"):
        fn, ctx = engines[name]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base_b = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        state = gt.build_grid(p)
        if name == "gspmd":
            state = gt.shard_state(state, shs)
        with ctx():
            fn(state, 2)  # warm
            torch.cuda.synchronize()
            K.reset_launches()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record()
            fn(state, k)
            b.record()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / k
            dev = a.elapsed_time(b) / k
            launches = sum(K.launches.values()) / k
            peak = (torch.cuda.max_memory_allocated() - base_b) / 2**30
            with Traced() as prof:
                t0 = time.perf_counter()
                fn(state, k)
                torch.cuda.synchronize()
                wall_p = (time.perf_counter() - t0) * 1e3
        busy = busy_ms(prof)
        busy_k = None if busy is None else busy / k
        out[name].append((dev, busy_k))
        idle = "not measured" if busy is None else \
            f"{1 - busy / wall_p:.3f} of the profiled wall " \
            f"({wall_p / k:.3f} ms/cycle)"
        print(f"gspmd timing {label} {name} (run {len(out[name])}): "
              f"{dev:.3f} ms/cycle events, {wall:.3f} wall, busy "
              f"{fmt_ms(busy_k)}, idle share {idle}; {launches:g} launches "
              f"a cycle; peak memory {peak:.2f} GiB")
        del state
    for i in range(2):
        (dg, bg), (dp, bp), (dl, bl) = (out[e][i] for e in engines)
        print(f"gspmd timing {label} pair {i + 1}: gspmd / per-op "
              f"{dg / dp:.3f} by events, gspmd / legs {dg / dl:.3f}"
              + (f"; busy {bg:.3f} / {bp:.3f} / {bl:.3f} ms"
                 if None not in (bg, bp, bl) else ""))
    return out


def time_gspmd_newton(params, steps=NEWTON_PLAIN_STEPS):
    """ms a 511³ Newton step (``steps`` steps from a fresh state, the
    initial F included) on the GSPMD engine's (1,1,1) mesh beside the
    single-device per-step loop on the per-op schedule and on the legs,
    in turns: CUDA events around newton_solve, host reads a solve, then a
    profiled run each: busy ms a step and the idle share."""
    import torch

    import gpusolve_tpu_torch as gt
    from gpusolve_tpu_torch.ops import vcycle_batch

    p = params.replace(maxiter=steps, print_progress=False)
    shs = gt.level_shardings(p, gt.make_mesh((1, 1, 1)))
    engines = {"gspmd": (shs, contextlib.nullcontext),
               "per-op": (None, per_op_schedule),
               "legs": (None, contextlib.nullcontext)}

    def run(name, window=contextlib.nullcontext()):
        sh, ctx = engines[name]
        state = gt.build_grid(p)
        torch.cuda.synchronize()
        reads0 = vcycle_batch.host_reads
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        with ctx(), window:
            t0 = time.perf_counter()
            a.record()
            _, hist = gt.newton_solve(state, p, shardings=sh)
            b.record()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        check(len(hist) == steps + 1, f"gspmd newton timing ran {hist}")
        return a.elapsed_time(b), wall, vcycle_batch.host_reads - reads0

    for name in engines:
        run(name)  # warm
    for name in ("gspmd", "per-op", "legs", "legs", "per-op", "gspmd"):
        dev, wall, reads = run(name)
        print(f"gspmd timing newton step 511^3 {name}: {dev / steps:.3f} "
              f"ms/step events, {wall / steps:.3f} wall, {reads} host reads "
              "a solve")
    for name in engines:
        window = Traced()
        _, wall_p, _ = run(name, window)
        busy = busy_ms(window.prof)
        print(f"gspmd timing newton step 511^3 {name}: busy "
              f"{fmt_ms(None if busy is None else busy / steps)} a step, "
              "idle share "
              + ("not measured" if busy is None else
                 f"{1 - busy / wall_p:.3f}"))


def gspmd_only(base, rec, rate):
    """``--gspmd``: the GSPMD engine alone (~4 min, the build included):
    the carved check, the three 511³ main paths against the per-op
    schedule, the CLI, and the timings.  Prints no contract line."""
    import gpusolve_tpu_torch as gt

    check_gspmd_carved(base, rec)
    for label in ("linear", "nonlinear", "newton"):
        gspmd_main_path(gt.parse_config(CONFS[label], grid_dim=BIG),
                        f"511^3 {label}")
    gspmd_cli()
    for label in ("linear", "nonlinear"):
        p = gt.parse_config(CONFS[label], grid_dim=BIG)
        time_gspmd(p, f"511^3 {p.mode.name} V(3,3)", rate)
    time_gspmd_newton(gt.parse_config(CONFS["newton"], grid_dim=BIG))
    print("chip_smoke --gspmd: done (no contract line)")
    return 0


def legs_only(base, rec, rate):
    """``--legs``: the fused legs alone, a quick loop for work on them
    (~4 min): their checks against the plain versions, then on each
    mode's 511³ solve (solve / newton_solve, check_every=10) the level-0
    legs' times, every level's legs against its per-op visit, and the
    V(3,3) cycle on both schedules.  Prints no contract line."""
    import torch

    import gpusolve_tpu_torch as gt
    from gpusolve_tpu_torch.config import Mode

    check_fused_legs(base, rec)
    check_legs_exact(base, rec)
    rows = {}
    for label in ("linear", "nonlinear", "newton"):
        p = gt.parse_config(CONFS[label], grid_dim=BIG,
                            print_progress=False)
        state, hist, wall = run_solve(p, 10)
        print(f"legs: 511^3 {label} solve, {len(hist) - 1} steps in "
              f"{wall:.3f} s wall, last norm {hist[-1]}")
        time_legs({p.mode: p}, {p.mode: state}, rate, rows)
        what = f"511^3 {p.mode.name} V(3,3)"
        time_leg_levels(p, state, what)
        time_cycle_schedules(p, state, rate, what)
        del state
        torch.cuda.empty_cache()
    print("chip_smoke --legs: done (no contract line)")
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        import gpusolve_tpu_torch as gt
        from gpusolve_tpu_torch.ops import kernels as K
        from gpusolve_tpu_torch.solver import vcycle as tvc
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 1

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {name} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    path, log = K.build()
    K.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{os.path.relpath(path, HERE)}")
    print_ptxas(log, "--pod-cycle" not in sys.argv[1:])
    print(f"finalize: one cluster of 8 blocks x 128 threads, "
          f"{K.lib().mg_finalize_stage_bytes()} bytes of dynamic shared "
          f"memory a block beside ptxas's static ones")
    rate = mem_rate(name)

    base = gt.parse_config(CONFS["linear"])
    print_leg_smem(base)
    rec = Record()
    if "--legs" in sys.argv[1:]:
        return legs_only(base, rec, rate)
    if "--gspmd" in sys.argv[1:]:
        return gspmd_only(base, rec, rate)
    if "--pod-cycle" in sys.argv[1:]:
        pod_cycle_times()
        print("chip_smoke --pod-cycle: done (no contract line)")
        return 0
    if "--pod-ranks" in sys.argv[1:]:
        pod_ranks({}, {})
        print("chip_smoke --pod-ranks: done (no contract line)")
        return 0
    check_kernels(base, rec)
    check_vcycle_fused(base, rec)
    check_block_kernels(base, rec)
    check_ghosts(base, rec)
    check_leg_kernels(base, rec)
    check_leg_ghosts(base, rec)
    check_pod_kernels(base, rec)
    check_junction_legs(base, rec)
    check_gspmd_carved(base, rec)
    rows = {}
    check_rdma_kernel(base, rec, rate, rows)
    rdma_ranks()
    check_fused_legs(base, rec)
    check_legs_exact(base, rec)

    # Phase 3: each main path with its own counts.
    launched = {kname: 0 for kname in K.KERNELS}
    states, batch_hist = {}, {}
    for label in ("linear", "nonlinear", "newton"):
        params = gt.parse_config(CONFS[label], grid_dim=BIG)
        plain_maxiter = NEWTON_PLAIN_STEPS if label == "newton" else None
        states[label], counts, batch_hist[label] = main_path(
            params, f"511^3 {label}", plain_maxiter=plain_maxiter
        )
        for kname, n in counts.items():
            launched[kname] += n
        legs_vs_per_op(params, f"511^3 {label}", states[label],
                       batch_hist[label])
        if label != "newton":
            other_cycles(gt.parse_config(CONFS[label]), label)
        # W and F past the sweep cap: each visit on the per-op kernels.
        counts = other_cycles(gt.parse_config(
            CONFS[label], pre_smoothing=6, post_smoothing=6),
            f"{label} V(6,6)")
        for kname, n in counts.items():
            launched[kname] += n
    # The batched Newton loop (the 511³ main path above, check_every=10)
    # against the per-step loop on the kernels, its synchronising calls,
    # and its outer stop inside a batch and at a batch's end at 127³.
    newton = gt.parse_config(CONFS["newton"], grid_dim=BIG)
    newton_loops_agree(newton, "511^3", 10,
                       batch=(states["newton"], batch_hist["newton"]))
    newton_sync_count(newton.replace(print_progress=False), 10)
    newton_stops_127()
    # V(6,6): past the batch engine's sweep cap, solve (and newton_solve's
    # inner solve) runs the v1 kernel.
    hist66 = {}
    for label in ("linear", "nonlinear", "newton"):
        params = gt.parse_config(CONFS[label], grid_dim=BIG,
                                 pre_smoothing=6, post_smoothing=6)
        check(tvc.engine(params, DEVICE) == "v1",
              f"V(6,6) {label} does not run the v1 engine")
        plain_maxiter = NEWTON_PLAIN_STEPS if label == "newton" else None
        _, counts, hist66[label] = main_path(
            params, f"511^3 V(6,6) {label}", plain_maxiter=plain_maxiter,
            identical=True, floor=1e-2)
        for kname, n in counts.items():
            launched[kname] += n
        torch.cuda.empty_cache()
    # The distributed engine on the one-rank mesh, each mode: V(3,3) on
    # the legs; V(6,6), past their sweep cap, on the per-op kernels; the
    # pod engine (fuse="pod", --fuse auto's choice) at V(3,3).
    leg_hist = {}
    for label in ("linear", "nonlinear", "newton"):
        params = gt.parse_config(CONFS[label], grid_dim=BIG)
        counts, leg_hist[label] = spmd_main_path(
            params, f"511^3 {label}", batch_hist[label])
        for kname, n in counts.items():
            launched[kname] += n
        # halo="rdma": the same engine with the legs' slabs from the
        # exchange kernel (its zero fill on one rank).
        counts = rdma_main_path(params, f"511^3 {label}", leg_hist[label])
        for kname, n in counts.items():
            launched[kname] += n
    for label in ("linear", "nonlinear", "newton"):
        params = gt.parse_config(CONFS[label], grid_dim=BIG,
                                 pre_smoothing=6, post_smoothing=6)
        counts, _ = spmd_main_path(params, f"511^3 V(6,6) {label}",
                                   hist66[label], legs=False)
        for kname, n in counts.items():
            launched[kname] += n
    pod_hist = {}
    for label in ("linear", "nonlinear", "newton"):
        params = gt.parse_config(CONFS[label], grid_dim=BIG)
        counts, pod_hist[label] = pod_main_path(
            params, f"511^3 {label}", batch_hist[label], leg_hist[label])
        for kname, n in counts.items():
            launched[kname] += n
        if label != "newton":
            pod_other_cycles(gt.parse_config(CONFS[label]), label)
    # The per-leg engine's replicated tail (tail="auto", the JAX package's
    # default plan on its accelerator).
    for label in ("linear", "nonlinear", "newton"):
        params = gt.parse_config(CONFS[label], grid_dim=BIG)
        counts = tail_main_path(params, f"511^3 {label}", batch_hist[label],
                                leg_hist[label], pod_hist[label])
        for kname, n in counts.items():
            launched[kname] += n
    # The GSPMD engine on the one-rank mesh: the per-op kernels on its
    # blocks, bit for bit the single-device per-op schedule.
    for label in ("linear", "nonlinear", "newton"):
        params = gt.parse_config(CONFS[label], grid_dim=BIG)
        counts = gspmd_main_path(params, f"511^3 {label}")
        for kname, n in counts.items():
            launched[kname] += n
    # The multi-rank pod engine on processes sharing the card.
    pod_ranks(rows, launched, rec)
    missing = [kname for kname, n in launched.items() if n == 0]
    check(not missing, f"kernels no main path launched: {missing}")

    # Phase 4: the CLI.
    cli_path(CONFS["linear"], "Solving linear problem")
    cli_path(CONFS["nonlinear"], "Solving nonlinear problem")
    cli_path(CONFS["newton"], "Solving newton problem", newton=True)
    with tempfile.TemporaryDirectory() as tmp:
        cli_flags(tmp)
    spmd_cli()
    with tempfile.TemporaryDirectory() as tmp:
        tail_checkpoint(tmp)
    gspmd_cli()

    # Phase 4b: the entry cycle, parity against the float64 host solver,
    # and the host solver on the CLI.
    for kname, n in entry_path().items():
        launched[kname] += n
    parity_phase()
    with tempfile.TemporaryDirectory() as tmp:
        native_cli(tmp)

    # Phase 5: times.
    lin = gt.parse_config(CONFS["linear"], grid_dim=BIG,
                          print_progress=False)
    fas = gt.parse_config(CONFS["nonlinear"], grid_dim=BIG,
                          print_progress=False)
    newt = gt.parse_config(CONFS["newton"], grid_dim=BIG,
                           print_progress=False)
    time_kernels(lin, states["linear"], rate, rows)
    time_mode_kernels(fas, states["nonlinear"], newt, states["newton"],
                      rate, rows)
    time_newton_kernels(newt, states["newton"], rate, rows)
    from gpusolve_tpu_torch.config import Mode

    time_legs({Mode.LINEAR: lin, Mode.NONLINEAR: fas, Mode.NEWTON: newt},
              {Mode.LINEAR: states["linear"],
               Mode.NONLINEAR: states["nonlinear"],
               Mode.NEWTON: states["newton"]}, rate, rows)
    sched = {}
    for p, key in ((lin, "linear"), (fas, "nonlinear"), (newt, "newton")):
        time_leg_levels(p, states[key], f"511^3 {p.mode.name} V(3,3)")
        sched[key] = time_cycle_schedules(p, states[key], rate,
                                          f"511^3 {p.mode.name} V(3,3)")
    lin_ms = sched["linear"]["legs"][0][0]
    fas_ms = sched["nonlinear"]["legs"][0][0]
    states.clear()
    torch.cuda.empty_cache()
    print("newton steps on the legs:")
    time_newton_steps(newt)
    print("newton steps on the per-op schedule:")
    with per_op_schedule():
        time_newton_steps(newt)
    batch66 = time_v1(base, rate, rows)
    time_block_kernels(base, rate, rows)
    time_leg_kernels(base, rate, rows)
    time_pod_kernels(base, rate, rows)
    for p, what, batch_ms in ((lin, "LINEAR", lin_ms), (fas, "FAS", fas_ms)):
        label = f"511^3 {what} V(3,3)"
        leg_ms = time_spmd_cycles(p, label, batch_ms, rate)
        time_spmd_cycles(p, label, batch_ms, rate, halo="rdma",
                         others=(("per-leg halo=ppermute", leg_ms),))
        pod_ms = time_spmd_cycles(p, label, batch_ms, rate, fuse="pod",
                                  others=(("per-leg", leg_ms),))
        time_spmd_cycles(p, label, batch_ms, rate, fuse="pod", npod=3,
                         others=(("per-leg", leg_ms), ("pod npod=1", pod_ms)))
        # The replicated tail beside the classic plan and the pod engine.
        time_spmd_cycles(p, label, batch_ms, rate, tail="auto",
                         others=(("per-leg classic plan", leg_ms),
                                 ("pod npod=1", pod_ms)))
    # V(6,6), past the legs' sweep cap: the per-leg engine's per-op path,
    # whose down step is residual_restrict_block at every distributed
    # level above the junction.
    for p, what in ((lin, "LINEAR"), (fas, "FAS")):
        time_spmd_cycles(p.replace(pre_smoothing=6, post_smoothing=6),
                         f"511^3 {what} V(6,6)", batch66[p.mode], rate)
    # The GSPMD engine beside the per-op schedule and the legs.
    for p, what in ((lin, "LINEAR"), (fas, "FAS")):
        time_gspmd(p, f"511^3 {what} V(3,3)", rate)
    time_gspmd_newton(newt)

    # The one zero flag a device lends the launches given no done flag:
    # no kernel may have written it.
    flags = {str(d): int(t.item()) for d, t in K._zero_done.items()}
    print(f"check cached zero done flag after the run: {flags}")
    check(flags and not any(flags.values()),
          f"the cached zero done flag was written: {flags}")

    kernels_line = []
    for kname in K.KERNELS:
        row = rows[kname]
        kernels_line.append({
            "name": kname, "route": "cuda",
            "source": (LEGS_SRC if kname.startswith(("down_leg", "up_leg"))
                       else V1_SRC if kname == "vcycle_fused" else
                       RDMA_SRC if kname == "rdma_exchange" else
                       POD_SRC if kname.startswith("pod_") else
                       LEG_SRC if kname.startswith("leg_block") else
                       SPMD_SRC if "_block" in kname else SRC),
            "replaces": REPLACES[kname], "launches": launched[kname],
            "max_abs_err": rec.errs[kname], "ms": row["ms"],
            "device_ms": row["device_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "library_device_ms": row["library_device_ms"],
        })
    print(smi)
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
