#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (gpusolve_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):
  1. the card (nvidia-smi name and power limit), versions, kernel build;
  2. every CUDA kernel against its plain PyTorch version on CUDA tensors at
     15³, 16³, (31,15,63), 127³ and the 511³ level-0 shape: fields to
     rtol 1e-5 with atol 1e-5·max|plain|, Σr² to rel 1e-5; a set ``done``
     flag must leave every output untouched;
  3. the main path: examples/linear_127.conf at grid_dim 511³ (9 levels)
     through build_grid + solve(check_every=10), with the launch counters
     zeroed just before and read just after; the counts must equal what
     the schedule implies, the history must fall and end by the stop test
     or maxiter, and the same solve on the plain ops (backend="ref") on
     the card must give the same history (rel 2e-4 while the residual is
     >= 1e-4·initial, a factor 1.5 nearer the float32 floor, a stop at
     most one cycle apart); then W and F cycles at 127³ likewise;
  4. the CLI on examples/linear_127.conf as it is;
  5. times at 511³ with CUDA events: device ms per cycle over a 10-cycle
     batch, a profiler breakdown by kernel, each kernel's time beside its
     bound (bytes over the card's memory rate, or operations over its
     float32 rate), its plain version's time and a PyTorch library call
     computing the same function, and a one-field copy as the stream
     ceiling.

The line before the last is the JSON object {"kernels": [...]}; the last
line is {"ok": true, "device": {...}}.
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
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CONF = os.path.join(HERE, "examples", "linear_127.conf")
SRC = "gpusolve_tpu_torch/ops/csrc/multigrid.cu"
SHAPES = [(15, 15, 15), (16, 16, 16), (31, 15, 63), (127, 127, 127),
          (511, 511, 511)]
BIG = (511, 511, 511)
RTOL = 1e-5
DEVICE = "cuda"

# The TPU kernel each CUDA kernel replaces (builder line of the Pallas
# kernel, or of the part of _vcycle2_call it stands for).
REPLACES = {
    "residual": "gpusolve_tpu/ops/pallas_kernels.py:292",
    "finalize": "gpusolve_tpu/ops/pallas_vcycle2.py:1370",
    "jacobi_sweep": "gpusolve_tpu/ops/pallas_vcycle2.py:421",
    "restrict_zero": "gpusolve_tpu/ops/pallas_vcycle2.py:484",
    "prolong_add": "gpusolve_tpu/ops/pallas_vcycle2.py:499",
}
F32_PEAK = 67e12  # H100 SXM float32 outside the tensor cores, FLOP/s


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def mem_rate(name: str) -> float:
    """Published device-memory rate of the card, bytes/s."""
    if "H200" in name:
        return 4.8e12
    if "H100" in name and "PCIe" in name:
        return 2.0e12
    if "H100" in name and "NVL" in name:
        return 3.9e12
    check("H100" in name, f"no memory rate on record for {name!r}")
    return 3.35e12


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
        self.vc = field(self.cdims, 0.05)


def close(got, want, what, errs, key):
    """Fields agree to rtol 1e-5 and atol 1e-5·max|want|."""
    import torch

    diff = (got - want).abs()
    err = float(diff.max())
    atol = RTOL * float(want.abs().max())
    ok = bool((diff <= atol + RTOL * want.abs()).all())
    errs[key] = max(errs.get(key, 0.0), err)
    check(ok, f"{what}: max_abs_err {err:.3e} over atol {atol:.3e}")
    return err, atol


def check_kernels(params_of, errs):
    import torch

    from gpusolve_tpu_torch.ops import kernels as K

    for n, dims in enumerate(SHAPES):
        p = params_of(dims)
        h = p.level_h(0)
        x = Fields(dims, seed=100 + n)
        tag = "x".join(map(str, dims))
        lines = []

        r_k, r_p = torch.zeros_like(x.v), torch.zeros_like(x.v)
        parts = K.residual(r_k, x.v, x.f, dims, p, h, with_norm=True)
        parts_p = K.residual_plain(r_p, x.v, x.f, dims, p, h,
                                   with_norm=True)
        ss_k, ss_p = x.v.new_empty(1), x.v.new_empty(1)
        K.finalize(parts, ss_k)
        K.finalize_plain(parts_p, ss_p)
        err, atol = close(r_k, r_p, f"residual {tag}", errs, "residual")
        rel = abs(float(ss_k) - float(ss_p)) / float(ss_p)
        check(rel <= RTOL, f"residual sum r^2 {tag}: rel err {rel:.3e}")
        lines.append(f"residual {tag}: max_abs_err={err:.3e} "
                     f"(atol {atol:.3e}) sumsq rel_err={rel:.3e}")

        # finalize alone: the kernel's partials through both versions.
        fin_p = x.v.new_empty(1)
        K.finalize_plain(parts, fin_p)
        err = abs(float(ss_k) - float(fin_p))
        errs["finalize"] = max(errs.get("finalize", 0.0), err)
        check(err <= RTOL * abs(float(fin_p)), f"finalize {tag}: {err:.3e}")
        lines.append(f"finalize {tag}: max_abs_err={err:.3e}")

        out_k, out_p = torch.zeros_like(x.v), torch.zeros_like(x.v)
        K.jacobi_sweep(out_k, x.v, x.f, dims, p, h)
        K.jacobi_sweep_plain(out_p, x.v, x.f, dims, p, h)
        err, atol = close(out_k, out_p, f"jacobi_sweep {tag}", errs,
                          "jacobi_sweep")
        lines.append(f"jacobi_sweep {tag}: max_abs_err={err:.3e} "
                     f"(atol {atol:.3e})")

        fc_k = 7.0 * x.vc  # stale values, zero halo
        vc_k = x.vc.clone()
        fc_p, vc_p = fc_k.clone(), vc_k.clone()
        K.restrict_zero(fc_k, vc_k, r_k, dims, x.cdims)
        K.restrict_zero_plain(fc_p, vc_p, r_k, dims, x.cdims)
        err, atol = close(fc_k, fc_p, f"restrict_zero {tag}", errs,
                          "restrict_zero")
        check(torch.equal(vc_k, vc_p), f"restrict_zero {tag}: coarse v")
        lines.append(f"restrict_zero {tag}: max_abs_err={err:.3e} "
                     f"(atol {atol:.3e})")

        v_k, v_p = x.v.clone(), x.v.clone()
        K.prolong_add(v_k, x.vc, dims, x.cdims)
        K.prolong_add_plain(v_p, x.vc, dims, x.cdims)
        err, atol = close(v_k, v_p, f"prolong_add {tag}", errs,
                          "prolong_add")
        lines.append(f"prolong_add {tag}: max_abs_err={err:.3e} "
                     f"(atol {atol:.3e})")

        # A set done flag: every kernel returns without writing.
        done = torch.ones(1, dtype=torch.int32, device=DEVICE)
        snap = [t.clone() for t in (r_k, ss_k, out_k, fc_k, vc_k, v_k)]
        K.residual(r_k, x.f, x.v, dims, p, h, done=done)
        K.finalize(parts, ss_k, 1e30, done)
        K.jacobi_sweep(out_k, x.f, x.v, dims, p, h, done)
        K.restrict_zero(fc_k, vc_k, x.v, dims, x.cdims, done)
        K.prolong_add(v_k, x.vc, dims, x.cdims, done)
        torch.cuda.synchronize()
        for a, b in zip(snap, (r_k, ss_k, out_k, fc_k, vc_k, v_k)):
            check(torch.equal(a, b), f"done flag ignored at {tag}")
        lines.append(f"done-flag skip {tag}: ok")
        for line in lines:
            print(f"check {line}")
        del x
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------


def histories_agree(got, want, what):
    """rel 2e-4 where the residual is >= 1e-4·initial; a factor 1.5 below
    (the float32 floor, where summation orders legitimately differ); the
    stop at most one cycle apart."""
    check(abs(len(got) - len(want)) <= 1,
          f"{what}: {len(got)} vs {len(want)} entries")
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if w >= 1e-4 * want[0]:
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
    state, hist = gt.solve(state, params, check_every=check_every)
    torch.cuda.synchronize()
    return state, hist, time.perf_counter() - t0


def expected_counts(params, hist, k):
    from gpusolve_tpu_torch.ops.vcycle_batch import launches_per_cycle

    executed = len(hist) - 1
    launched = min(params.maxiter, k * math.ceil(executed / k))
    per = launches_per_cycle(params)
    return {
        name: n * launched + (1 if name in ("residual", "finalize") else 0)
        for name, n in per.items()
    }


def main_path(params):
    import torch

    from gpusolve_tpu_torch.ops import kernels as K

    k = 10
    K.reset_launches()
    state, hist, secs = run_solve(params, k)
    counts = dict(K.launches)
    print(f"main path 511^3 V: {len(hist) - 1} cycles in {secs:.3f} s "
          f"wall ({1e3 * secs / (len(hist) - 1):.2f} ms per cycle, initial "
          f"residual included), history {hist}")
    print(f"main path launches: {counts}")
    want = expected_counts(params, hist, k)
    check(counts == want, f"launch counts {counts} != schedule {want}")
    check(all(n > 0 for n in counts.values()), "a kernel never launched")
    initial = hist[0]
    stop = [i for i, r in enumerate(hist[1:])
            if r <= initial / (1.0 / params.tol)]
    check(stop == [] and len(hist) - 1 == params.maxiter
          or stop == [len(hist) - 2],
          "the loop did not end by the stop test or maxiter")
    above = [r for r in hist if r >= 1e-4 * initial]
    check(all(b < a for a, b in zip(above, above[1:])),
          "the residual did not fall every cycle")

    K.reset_launches()
    ref_state, ref_hist, ref_secs = run_solve(params.replace(backend="ref"), k)
    check(all(n == 0 for n in K.launches.values()),
          "the plain path launched a kernel")
    print(f"plain path 511^3 V: {ref_secs:.3f} s wall "
          f"({1e3 * ref_secs / (len(ref_hist) - 1):.2f} ms per cycle), "
          f"history {ref_hist}")
    worst = histories_agree(hist, ref_hist, "511^3 kernels vs plain")
    v, vr = state.levels[0].v, ref_state.levels[0].v
    vdiff = float((v - vr).abs().max())
    scale = float(vr.abs().max())
    check(vdiff <= 2e-5 * scale + 2e-4 * scale,
          f"final v differs by {vdiff:.3e}")
    print(f"kernels vs plain at 511^3: worst history rel diff {worst:.3e}, "
          f"final v max_abs_diff {vdiff:.3e} (bit-identical: "
          f"{torch.equal(v, vr)})")
    del ref_state
    torch.cuda.empty_cache()
    return state, hist, counts


def other_cycles(params127):
    from gpusolve_tpu_torch.ops import kernels as K
    from gpusolve_tpu_torch.ops.vcycle_batch import launches_per_cycle

    for cyc in "WF":
        p = params127.replace(cycle_type=cyc, maxiter=3, tol=1e-12,
                              print_progress=False)
        K.reset_launches()
        _, hist, secs = run_solve(p, 3)
        counts = dict(K.launches)
        _, ref_hist, _ = run_solve(p.replace(backend="ref"), 3)
        worst = histories_agree(hist, ref_hist, f"127^3 {cyc}")
        per = launches_per_cycle(p)
        check(counts["jacobi_sweep"] == 3 * per["jacobi_sweep"],
              f"{cyc}: launch counts {counts}")
        print(f"127^3 {cyc}-cycle: history {hist} ({secs:.3f} s), worst rel "
              f"diff vs plain {worst:.3e}, launches {counts}")


def cli_path():
    from gpusolve_tpu_torch import cli
    from gpusolve_tpu_torch.ops import kernels as K

    K.reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([CONF, "--devices"])
    out = buf.getvalue()
    sys.stdout.write(out)
    check(rc == 0, f"cli exited {rc}")
    lines = out.splitlines()
    check(lines[0] == f"Using config file {CONF}", "cli: config line")
    check("Solving linear problem" in lines, "cli: mode line")
    init = [ln for ln in lines if ln.startswith("Inital residual: ")]
    iters = [re.match(r"^iter: (\d+) residual: (\S+) Took (\d+)ms", ln)
             for ln in lines if ln.startswith("iter: ")]
    check(len(init) == 1 and iters and all(iters), "cli: progress lines")
    check([int(m.group(1)) for m in iters] == list(range(len(iters))),
          "cli: iteration numbers")
    check(all(n > 0 for n in K.launches.values()),
          f"cli: a kernel never launched {dict(K.launches)}")
    print(f"cli launches: {dict(K.launches)}")


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


def time_kernels(params, state, rate):
    """Each kernel's device time at the 511³ level-0 shape, its bound, its
    plain version's time and a PyTorch call computing the same function."""
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
    pad = (dims[0] + 2) * (dims[1] + 2) * (dims[2] + 2)
    inner = dims[0] * dims[1] * dims[2]
    cpad = (cdims[0] + 2) * (cdims[1] + 2) * (cdims[2] + 2)
    cinner = cdims[0] * cdims[1] * cdims[2]
    ntaps = len(params.stencil.values)
    parts = K.residual(None, v, f, dims, params, h, write_r=False,
                       with_norm=True)
    ss = v.new_empty(1)
    taps_w = stencil_filter(params, 1.0 / (h * h))
    restrict_w = trilinear_filter(0.125)
    prolong_w = trilinear_filter(1.0)
    v5 = v[None, None]
    vc5 = vc[None, None]
    r5 = r[None, None]

    cases = {
        # name: (kernel, plain, library, bytes, flops)
        "residual": (
            lambda: K.residual(r, v, f, dims, params, h),
            lambda: K.residual_plain(r, v, f, dims, params, h),
            lambda: F.conv3d(v5, taps_w),
            4 * (2 * pad + inner), (2 * ntaps + 1) * inner,
        ),
        "finalize": (
            lambda: K.finalize(parts, ss),
            lambda: K.finalize_plain(parts, ss),
            lambda: torch.sum(parts),
            8 * parts.numel() + 4, parts.numel(),
        ),
        "jacobi_sweep": (
            lambda: K.jacobi_sweep(out, v, f, dims, params, h),
            lambda: K.jacobi_sweep_plain(out, v, f, dims, params, h),
            lambda: F.conv3d(v5, taps_w),
            4 * (2 * pad + inner), (2 * ntaps + 4) * inner,
        ),
        "restrict_zero": (
            lambda: K.restrict_zero(fc, vc, r, dims, cdims),
            lambda: K.restrict_zero_plain(fc, vc, r, dims, cdims),
            lambda: F.conv3d(r5, restrict_w, stride=2),
            4 * (pad + 2 * cinner), 53 * cinner,
        ),
        "prolong_add": (
            lambda: K.prolong_add(out, vc, dims, cdims),
            lambda: K.prolong_add_plain(out, vc, dims, cdims),
            lambda: F.conv_transpose3d(vc5, prolong_w, stride=2),
            4 * (pad + cpad + inner), 11.5 * inner,
        ),
    }
    rows = {}
    for name, (kern, plain, libcall, nbytes, flops) in cases.items():
        ms = cuda_ms(kern, reps=20)
        plain_ms = cuda_ms(plain, reps=3)
        library_ms = cuda_ms(libcall, reps=5)
        t_bytes = nbytes / rate * 1e3
        t_ops = flops / F32_PEAK * 1e3
        bound_ms = max(t_bytes, t_ops)
        rows[name] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=bound_ms,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            bytes=nbytes,
        )
        print(f"time {name} 511^3: {ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({rows[name]['bound_by']}, {nbytes / 1e9:.3f} GB), "
              f"{nbytes / ms / 1e6:.1f} GB/s = "
              f"{100 * bound_ms / ms:.1f}% of bound; plain {plain_ms:.3f} "
              f"ms; library {library_ms:.3f} ms")
    norm_only = cuda_ms(
        lambda: K.residual(None, v, f, dims, params, h, write_r=False,
                           with_norm=True), reps=20)
    print(f"time residual norm-only 511^3: {norm_only:.4f} ms, bound "
          f"{4 * 2 * pad / rate * 1e3:.4f} ms")
    dst = torch.empty_like(v)
    copy_ms = cuda_ms(lambda: dst.copy_(v), reps=20)
    print(f"time copy of one 511^3 field: {copy_ms:.4f} ms = "
          f"{2 * 4 * pad / copy_ms / 1e6:.1f} GB/s (stream ceiling)")
    return rows


def cycle_bytes(params):
    """Bytes one cycle of the per-op structure moves: sweeps and the
    written residual 3 fields, the norm-only residual 2, restriction the
    fine r plus coarse f and v, prolongation fine v twice plus coarse v."""
    from gpusolve_tpu_torch.ops.vcycle_batch import level_visits

    dims = params.level_dims()
    visits = level_visits(len(dims), params.cycle_type)
    sweeps = params.pre_smoothing + params.post_smoothing
    total = 0
    for i, d in enumerate(dims):
        dense = 4 * (d[0] + 2) * (d[1] + 2) * (d[2] + 2)
        total += visits[i] * sweeps * 3 * dense
        if i + 1 < len(dims):
            c = dims[i + 1]
            cdense = 4 * (c[0] + 2) * (c[1] + 2) * (c[2] + 2)
            total += visits[i] * (3 * dense + dense + 2 * cdense
                                  + 2 * dense + cdense)
    d0 = dims[0]
    return total + 2 * 4 * (d0[0] + 2) * (d0[1] + 2) * (d0[2] + 2)


def fused_cycle_bytes(params):
    """The least bytes a cycle with each leg fused into one pass moves (the
    TPU kernel's wavefront, ROADMAP's first perf item): per visit of a
    non-coarsest level a down pass reads v and f and writes v and the
    coarse f, an up pass reads v, f and the coarse v and writes v (the
    finest norm folded in); the coarsest reads v and f and writes v."""
    from gpusolve_tpu_torch.ops.vcycle_batch import level_visits

    dims = params.level_dims()
    visits = level_visits(len(dims), params.cycle_type)
    total = 0
    for i, d in enumerate(dims):
        dense = 4 * (d[0] + 2) * (d[1] + 2) * (d[2] + 2)
        if i + 1 < len(dims):
            c = dims[i + 1]
            cdense = 4 * (c[0] + 2) * (c[1] + 2) * (c[2] + 2)
            total += visits[i] * (6 * dense + 2 * cdense)
        else:
            total += visits[i] * 3 * dense
    return total


def time_cycles(params, state, rate):
    import torch

    from gpusolve_tpu_torch.ops import vcycle_batch

    k = 10
    vcycle_batch.run(state, params, maxk=2)  # warm
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    vcycle_batch.run(state, params, maxk=k)
    b.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / k
    dev = a.elapsed_time(b) / k
    nbytes = cycle_bytes(params)
    print(f"cycle 511^3 V(3,3): {dev:.3f} ms/cycle device (CUDA events over "
          f"a {k}-cycle batch), {wall:.3f} ms/cycle wall; "
          f"{nbytes / 1e9:.3f} GB/cycle -> {nbytes / dev / 1e6:.1f} GB/s, "
          f"bound {nbytes / rate * 1e3:.3f} ms/cycle")
    fused = fused_cycle_bytes(params)
    print(f"cycle 511^3 fused-leg bound: {fused / 1e9:.3f} GB/cycle -> "
          f"{fused / rate * 1e3:.3f} ms/cycle")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        vcycle_batch.run(state, params, maxk=k)
        torch.cuda.synchronize()
        wall_p = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, ev.count, ev.key[:70]))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e3
    if rows:
        for dev_us, count, key in rows:
            print(f"profile {key}: {dev_us / 1e3 / k:.3f} ms/cycle "
                  f"({count // k} launches/cycle)")
        print(f"profile busy {busy / k:.3f} ms/cycle of {wall_p / k:.3f} "
              f"wall -> idle share {1 - busy / wall_p:.3f}")
    else:
        print("profile: no device time recorded (not measured)")
    return dev


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
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}")
    rate = mem_rate(name)

    base = gt.parse_config(CONF)

    def params_of(dims):
        return base.replace(grid_dim=dims, print_progress=False)

    errs = {}
    check_kernels(params_of, errs)

    params = base.replace(grid_dim=BIG)
    state, hist, counts = main_path(params)
    other_cycles(base)
    cli_path()

    rows = time_kernels(params, state, rate)
    time_cycles(params.replace(print_progress=False), state, rate)

    kernels_line = []
    for kname in K.KERNELS:
        row = rows[kname]
        kernels_line.append({
            "name": kname, "route": "cuda", "source": SRC,
            "replaces": REPLACES[kname], "launches": counts[kname],
            "max_abs_err": errs[kname], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
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
