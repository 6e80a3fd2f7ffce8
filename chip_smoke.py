#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Builds the port's CUDA kernels from ``carla_social_force_model_tpu_torch/
csrc`` with nvcc, holds each kernel against its plain PyTorch version on the
card, drives the main path (BASELINE config #1: N = 10,000 pedestrians,
1,000 steps of dt = 0.05 s through ``api.synthetic.benchmark_bundle`` and
``models.stepper.make_rollout_fn``), counts the kernel launches that path
made, and checks a recorded 50-step rollout through the kernel against the
same rollout through the plain version.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card, nvcc (on PATH or under /usr/local/cuda) and no
network, and imports nothing of JAX.  Any failed phase exits non-zero; on
success the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N = 10_000
STEPS = 1_000
PARITY_STEPS = 50
#: kernel vs plain version, elementwise |got - want| <= ATOL + RTOL*|want|:
#: f32 summation order (the symmetric kernel's atomics change it from run
#: to run) and last-ulp differences of rsqrt/atan2/exp
ATOL = RTOL = 1e-4
#: end to end, 50 steps through the kernel vs through the plain version:
#: f32 summation order only, over a horizon short enough that the crowd's
#: chaotic divergence does not amplify it
POS_TOL_M = 1e-3
#: kernel vs the float64 numpy oracle (tests/oracle.py) on a small crowd
ORACLE_N = 200
ORACLE_TOL = 1e-4


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def seeded_crowd(n, seed, extent, alive_frac=0.9):
    """numpy-seeded planar crowd with dead agents and one coincident pair."""
    import numpy as np
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-extent, extent, (n, 2)).astype(np.float32)
    vel = rng.uniform(-2.0, 2.0, (n, 2)).astype(np.float32)
    radius = rng.uniform(0.2, 0.4, n).astype(np.float32)
    alive = rng.uniform(size=n) < alive_frac
    pos[1] = pos[0]
    alive[:2] = True
    return pos, vel, radius, alive


def to_planes(pos, vel, radius, alive, device):
    import numpy as np
    import torch
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (pos[:, 0], pos[:, 1], vel[:, 0], vel[:, 1], radius,
                      alive)]


def cuda_ms(fn, reps=20):
    """Mean device milliseconds of ``fn()`` over ``reps`` calls (CUDA
    events, after one warm-up call)."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an "
             "NVIDIA card")
    sys.path.insert(0, ROOT)
    try:
        from carla_social_force_model_tpu_torch.api.synthetic import (
            benchmark_bundle)
        from carla_social_force_model_tpu_torch.models import stepper
        from carla_social_force_model_tpu_torch.models.params import (
            MoussaidParams, moussaid_vector)
        from carla_social_force_model_tpu_torch.ops import cuda_forces, forces
        from carla_social_force_model_tpu_torch.utils import cuda_build
    except ImportError as exc:
        fail(f"the port package is not beside chip_smoke.py ({exc})")
    import dataclasses
    import numpy as np

    # -- phase 1: the card --------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    say(f"phase 1 card: {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvidia-smi: {card}")

    # -- phase 2: build the kernels from csrc/ --------------------------------
    t0 = time.perf_counter()
    cuda_build.build_kernels()
    cuda_build.load_kernels()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in cuda_build.BUILD_LOG.read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    say(f"phase 2 build: {build_s:.2f} s, {cuda_build.LIBRARY.name}; "
        f"ptxas: {' | '.join(ptxas)}")

    # -- phase 3: each kernel against its plain version, on the card ----------
    kernels = {"pair_force_sym": cuda_forces.pair_force_sym,
               "pair_force_dense": cuda_forces.pair_force_dense}
    extent = float(np.sqrt(N))
    cases = [(0.005, False), (0.005, True), (0.0, False), (0.0, True)]
    worst = {k: 0.0 for k in kernels}
    for epsilon, use_radius in cases:
        p = dataclasses.replace(MoussaidParams(), epsilon=epsilon)
        planes = to_planes(*seeded_crowd(N, 7, extent), dev)
        alive = planes[5]
        prm = moussaid_vector(p, dev)
        want = torch.stack(forces.pedestrian_force(
            *planes, p, use_ped_radius=use_radius))
        for name, kernel in kernels.items():
            got = torch.stack(kernel(*planes, prm, use_radius=use_radius))
            torch.cuda.synchronize()
            err = (got - want).abs()
            bound = ATOL + RTOL * want.abs()
            rel = (err / (1.0 + want.abs())).max().item()
            say(f"phase 3 {name} eps={epsilon} use_radius={use_radius}: "
                f"max abs err {err.max().item():.3e}, max err/(1+|f|) "
                f"{rel:.3e}, max |f| {want.abs().max().item():.3e}, "
                f"tolerance {ATOL:g} + {RTOL:g}*|f|")
            if not torch.isfinite(got).all():
                fail(f"{name} returned non-finite forces")
            if bool((err > bound).any()):
                fail(f"{name} disagrees with the plain version")
            if bool((got[:, ~alive] != 0).any()):
                fail(f"{name}: dead rows are not exactly zero")
            worst[name] = max(worst[name], err.max().item())
    # an independent float64 reference on a small crowd (no coincident pair:
    # the reference math is undefined there)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import oracle
    pos, vel, radius, alive = seeded_crowd(ORACLE_N, 3, 12.0)
    pos[1] += np.float32(0.5)
    p = MoussaidParams()
    want = oracle.pedestrian_force(pos.astype(np.float64),
                                   vel.astype(np.float64), radius, alive,
                                   p.lambda_, p.A, p.gamma, p.n, p.n_prime,
                                   p.epsilon)
    for name, kernel in kernels.items():
        got = torch.stack(kernel(*to_planes(pos, vel, radius, alive, dev),
                                 moussaid_vector(p, dev))).T.cpu().numpy()
        err = float(np.abs(got - want).max())
        say(f"phase 3 {name} vs float64 oracle, N={ORACLE_N}: max abs err "
            f"{err:.3e} (tolerance {ORACLE_TOL:g})")
        if err > ORACLE_TOL:
            fail(f"{name} disagrees with the float64 oracle")
    # times at the main path's shape
    p = MoussaidParams()
    planes = to_planes(*seeded_crowd(N, 7, extent), dev)
    prm = moussaid_vector(p, dev)
    plain_ms = cuda_ms(lambda: forces.pedestrian_force(*planes, p), reps=10)
    kernel_ms = {name: cuda_ms(lambda k=kernel: k(*planes, prm))
                 for name, kernel in kernels.items()}
    say(f"phase 3 times at N={N} ({card}): pair_force_sym "
        f"{kernel_ms['pair_force_sym']:.4f} ms, pair_force_dense "
        f"{kernel_ms['pair_force_dense']:.4f} ms, plain PyTorch "
        f"{plain_ms:.4f} ms")
    torch.cuda.synchronize()

    # -- phase 4: the main path ----------------------------------------------
    scene, params, cfg, state = benchmark_bundle(N, device=dev)
    launches = {}
    rates = {}
    for name, symmetric in (("pair_force_sym", True),
                            ("pair_force_dense", False)):
        run = stepper.make_rollout_fn(
            scene, params, dataclasses.replace(cfg, symmetric_pairs=symmetric),
            STEPS, record=False)
        run(state)
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(3):
            cuda_forces.reset_launch_counts()
            t0 = time.perf_counter()
            final, _ = run(state)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
            counts = dict(cuda_forces.LAUNCHES)
            if counts[name] != STEPS or sum(counts.values()) != STEPS:
                fail(f"main path launched {counts}, expected {STEPS} "
                     f"{name} launches per run")
        launches[name] = counts[name]
        if not bool(final.alive.all()):
            fail("agents died in the benchmark rollout")
        if not (torch.isfinite(final.pos_x).all()
                and torch.isfinite(final.pos_y).all()):
            fail("non-finite positions after the benchmark rollout")
        rates[name] = N * STEPS / best
        say(f"phase 4 main path via {name}: N={N}, {STEPS} steps, best of 3 "
            f"{best:.3f} s = {rates[name]:.1f} agent-steps/s, "
            f"{1e3 * best / STEPS:.4f} ms/step, launches {counts}; all "
            f"{N} alive and finite ({card})")

    # where a step's device time goes: a short profiled window
    from torch.profiler import ProfilerActivity, profile
    run20 = stepper.make_rollout_fn(scene, params, cfg, 20, record=False)
    run20(state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run20(state)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and "CUDA" in str(e.device_type)
              and getattr(e, "self_device_time_total", 0) > 0]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    if device_ms > 0:
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
        step_ms = 1e3 / rates["pair_force_sym"] * N
        busy = device_ms / 20
        say(f"phase 4 profile, 20 steps: wall {wall_ms:.3f} ms under the "
            f"profiler, device busy {device_ms:.3f} ms, "
            f"{sum(e.count for e in events) / 20:.0f} device kernels per "
            f"step; busy {busy:.4f} ms per step = "
            f"{100 * busy / step_ms:.1f}% of the unprofiled "
            f"{step_ms:.4f} ms step; top: "
            + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms"
                        f" x{e.count}" for e in top))
    else:
        say("phase 4 profile: no device time reported (not measured)")

    # -- phase 5: end to end, kernel vs plain version on the same card -------
    ref_cfg = dataclasses.replace(cfg, plain_pair_force=True)
    t0 = time.perf_counter()
    _, rec_plain = stepper.make_rollout_fn(scene, params, ref_cfg,
                                           PARITY_STEPS)(state)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    _, rec_kern = stepper.make_rollout_fn(scene, params, cfg,
                                          PARITY_STEPS)(state)
    torch.cuda.synchronize()
    linf = (rec_kern.pos - rec_plain.pos).abs().amax(dim=(1, 2)).cpu()
    say(f"phase 5 position L-inf kernel vs plain, N={N}, steps "
        f"1..{PARITY_STEPS}: " + " ".join(f"{v:.2e}" for v in linf.tolist()))
    say(f"phase 5 plain-path rollout: {N * PARITY_STEPS / plain_s:.1f} "
        f"agent-steps/s over {PARITY_STEPS} steps ({card})")
    if not torch.equal(rec_kern.alive, rec_plain.alive):
        fail("alive masks differ between the kernel and plain rollouts")
    if not torch.equal(rec_kern.mode, rec_plain.mode):
        fail("modes differ between the kernel and plain rollouts")
    if not torch.isfinite(rec_kern.pos).all():
        fail("non-finite positions in the recorded rollout")
    if linf[-1].item() > POS_TOL_M:
        fail(f"step-{PARITY_STEPS} position L-inf {linf[-1].item():.3e} m "
             f"exceeds {POS_TOL_M} m")

    replaces = {
        "pair_force_sym": "carla_social_force_model_tpu/ops/pallas_forces.py:239",
        "pair_force_dense": "carla_social_force_model_tpu/ops/pallas_forces.py:162",
    }
    say(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": "carla_social_force_model_tpu_torch/csrc/pair_forces.cu",
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": worst[name], "ms": kernel_ms[name],
         "plain_ms": plain_ms}
        for name in kernels]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
