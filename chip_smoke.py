#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Builds the port's CUDA kernels from ``carla_social_force_model_tpu_torch/
csrc`` with nvcc, holds each kernel against its plain PyTorch version on the
card, and drives the main paths through ``api.synthetic.benchmark_bundle``
and ``models.stepper.make_rollout_fn`` at N = 10,000 pedestrians, 1,000
steps of dt = 0.05 s each: BASELINE config #1 (the headless crowd: the
pair-force kernels), config #2 (+ sidewalk borders: ``env_exp``) and
config #3 (+ parked cars and moving vehicles: ``env_exp`` and
``env_moussaid``).  It counts the kernel launches of each path, and checks
recorded 50-step rollouts through the kernels against the same rollouts
through the plain versions.

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
#: environment kernel vs plain version: both pick the same closest point
#: and filter outcome (squared distances rounded after every operation on
#: both sides), so what is left is last-ulp differences of rsqrt, exp, atan2
#: and the division
ENV_ATOL = ENV_RTOL = 1e-5

#: the card's peak rates (NVIDIA H100 SXM data sheet; the f32 rate outside
#: the tensor cores) and its special-function units (CUDA C++ Programming
#: Guide, arithmetic throughput for compute capability 9.0: 16 results per
#: clock per SM for rsqrt, exp2, reciprocal) at the 1,980 MHz SM clock
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_MUFU_S = 132 * 16 * 1.98e9
#: f32 operations and special-function operations per pair, counted from
#: csrc/pair_forces.cuh (moussaid_pair: 2 rsqrt, 2 exp, 2 divisions, atan2)
#: and csrc/env_forces.cuh (the 5-operation distance of the closest-point
#: scan; exp_term: rsqrt, a division, exp)
PAIR_OPS, PAIR_MUFU = 85, 6
SCAN_OPS = 5
EXP_TERM_OPS, EXP_TERM_MUFU = 21, 3


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


def device_ms(fn, kernel, reps=20):
    """Mean device milliseconds of the kernel whose name contains
    ``kernel`` per call of ``fn()``, from the profiler's device times over
    ``reps`` calls (after one warm-up call); None when the profiler reports
    no device time for it.  Unlike CUDA events around the calls, this leaves
    out the wrapper's host time, which exceeds a short kernel's."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if kernel in e.key)
    return total / 1e3 / reps if total > 0 else None


def bound(n_bytes, ops, mufu):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over their peak rates (f32 and special-function)."""
    t_bytes = n_bytes / PEAK_BYTES_S
    t_ops = max(ops / PEAK_F32_S, mufu / PEAK_MUFU_S)
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes > t_ops else "operations")


def env_work(seg, px, py, alive, active, moussaid):
    """Bytes and operations one environment launch needs on these inputs:
    each input read once and each output written once; for every (segment,
    alive pedestrian) pair inside the segment's filter circle, the scan of
    the segment's real points and one force term."""
    from carla_social_force_model_tpu_torch.env.pointsets import PAD_COORD
    from carla_social_force_model_tpu_torch.ops.geometry import (
        segment_filter_mask)
    ok = segment_filter_mask(px, py, seg) & alive[None, :]
    if active is not None:
        ok = ok & active[:, None]
    real = (seg.x != PAD_COORD).sum(dim=1)
    ok = ok & (real > 0)[:, None]
    pairs = ok.sum(dim=1)
    n, s = px.shape[0], seg.num_segments
    term_ops, term_mufu = ((PAIR_OPS, PAIR_MUFU) if moussaid
                           else (EXP_TERM_OPS, EXP_TERM_MUFU))
    ops = int((pairs * (SCAN_OPS * real + term_ops)).sum())
    mufu = int(pairs.sum()) * term_mufu
    n_bytes = (n * 4 * (5 if moussaid else 3) + n + seg.x.numel() * 8
               + s * 4 * (5 if moussaid else 3) + n * 8)
    return n_bytes, ops, mufu, int(pairs.sum())


def reset_counts(*modules):
    for m in modules:
        m.reset_launch_counts()


def read_counts(*modules):
    counts = {}
    for m in modules:
        counts.update(m.LAUNCHES)
    return counts


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
        from carla_social_force_model_tpu_torch.models import stepper, vehicles
        from carla_social_force_model_tpu_torch.models.params import (
            MoussaidParams, moussaid_vector)
        from carla_social_force_model_tpu_torch.ops import (
            cuda_env, cuda_forces, forces)
        from carla_social_force_model_tpu_torch.ops.spatial import (
            morton_order)
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

    # -- phase 2: build the kernels from csrc/ (one nvcc per source) ---------
    t0 = time.perf_counter()
    cuda_build.build_kernels()
    cuda_build.load_kernels()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in cuda_build.BUILD_LOG.read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    say(f"phase 2 build: {build_s:.2f} s, {cuda_build.LIBRARY.name}; "
        f"ptxas: {' | '.join(ptxas)}")

    # -- phase 3: each pair kernel against its plain version, on the card ----
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
            lim = ATOL + RTOL * want.abs()
            rel = (err / (1.0 + want.abs())).max().item()
            say(f"phase 3 {name} eps={epsilon} use_radius={use_radius}: "
                f"max abs err {err.max().item():.3e}, max err/(1+|f|) "
                f"{rel:.3e}, max |f| {want.abs().max().item():.3e}, "
                f"tolerance {ATOL:g} + {RTOL:g}*|f|")
            if not torch.isfinite(got).all():
                fail(f"{name} returned non-finite forces")
            if bool((err > lim).any()):
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
    # times at the main path's shape, and the bound: every plane read once,
    # the forces written once; 5e7 unordered pairs (sym), 1e8 ordered pairs
    p = MoussaidParams()
    planes = to_planes(*seeded_crowd(N, 7, extent), dev)
    prm = moussaid_vector(p, dev)
    plain_ms = {}
    plain_ms["pair"] = cuda_ms(lambda: forces.pedestrian_force(*planes, p),
                               reps=10)
    kernel_ms = {name: cuda_ms(lambda k=kernel: k(*planes, prm))
                 for name, kernel in kernels.items()}
    pair_bytes = N * (5 * 4 + 1) + 6 * 4 + N * 8
    n_sym, n_dense = N * (N - 1) // 2, N * (N - 1)
    bounds = {
        "pair_force_sym": bound(pair_bytes, n_sym * (PAIR_OPS + 2),
                                n_sym * PAIR_MUFU),
        "pair_force_dense": bound(pair_bytes, n_dense * PAIR_OPS,
                                  n_dense * PAIR_MUFU)}
    say(f"phase 3 times at N={N} ({card}): pair_force_sym "
        f"{kernel_ms['pair_force_sym']:.4f} ms (bound "
        f"{bounds['pair_force_sym'][0]:.4f} ms, "
        f"{bounds['pair_force_sym'][1]}), pair_force_dense "
        f"{kernel_ms['pair_force_dense']:.4f} ms (bound "
        f"{bounds['pair_force_dense'][0]:.4f} ms, "
        f"{bounds['pair_force_dense'][1]}), plain PyTorch "
        f"{plain_ms['pair']:.4f} ms; f32-only bounds "
        f"{1e3 * n_sym * (PAIR_OPS + 2) / PEAK_F32_S:.4f} / "
        f"{1e3 * n_dense * PAIR_OPS / PEAK_F32_S:.4f} ms")
    torch.cuda.synchronize()

    launches = {}

    def drive(label, scene, params, cfg, state, steps, expect):
        """One main path: a warm-up run, then best of 3 timed runs, each
        with every count set to 0 just before and read just after; the
        counts must equal ``expect`` (per run) exactly."""
        run = stepper.make_rollout_fn(scene, params, cfg, steps, record=False)
        run(state)
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(3):
            reset_counts(cuda_forces, cuda_env)
            t0 = time.perf_counter()
            final, _ = run(state)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
            counts = read_counts(cuda_forces, cuda_env)
            if counts != expect:
                fail(f"{label} launched {counts}, expected {expect}")
        if not bool(final.alive.all()):
            fail(f"agents died in the {label} rollout")
        if not (torch.isfinite(final.pos_x).all()
                and torch.isfinite(final.pos_y).all()):
            fail(f"non-finite positions after the {label} rollout")
        n = state.capacity
        say(f"{label}: N={n}, {steps} steps, best of 3 {best:.3f} s = "
            f"{n * steps / best:.1f} agent-steps/s, "
            f"{1e3 * best / steps:.4f} ms/step, launches {counts}; all {n} "
            f"alive and finite ({card})")
        return counts, 1e3 * best / steps

    def profile_steps(scene, params, cfg, state, step_ms, label):
        """Device time per step under the profiler over 20 steps."""
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
        if device_ms <= 0:
            say(f"{label} profile: no device time reported (not measured)")
            return
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
        busy = device_ms / 20
        say(f"{label} profile, 20 steps: wall {wall_ms:.3f} ms under the "
            f"profiler, device busy {device_ms:.3f} ms, "
            f"{sum(e.count for e in events) / 20:.0f} device kernels per "
            f"step; busy {busy:.4f} ms per step = "
            f"{100 * busy / step_ms:.1f}% of the unprofiled "
            f"{step_ms:.4f} ms step ({card}); top: "
            + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms"
                        f" x{e.count}" for e in top))

    # -- phase 4: main path, config #1 (the pair kernels) -------------------
    scene, params, cfg, state = benchmark_bundle(N, device=dev)
    zero = {k: 0 for k in read_counts(cuda_forces, cuda_env)}
    step_ms = {}
    for name, symmetric in (("pair_force_sym", True),
                            ("pair_force_dense", False)):
        counts, step_ms[name] = drive(
            f"phase 4 config #1 via {name}", scene, params,
            dataclasses.replace(cfg, symmetric_pairs=symmetric), state, STEPS,
            dict(zero, **{name: STEPS}))
        launches[name] = counts[name]
    profile_steps(scene, params, cfg, state, step_ms["pair_force_sym"],
                  "phase 4 config #1")

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
    check_records("phase 5 config #1", rec_kern, rec_plain)
    say(f"phase 5 plain-path rollout: {N * PARITY_STEPS / plain_s:.1f} "
        f"agent-steps/s over {PARITY_STEPS} steps ({card})")

    # -- phase 6: the environment kernels at config #3's shapes --------------
    scene, params, cfg, state = benchmark_bundle(
        N, with_borders=True, with_obstacles=True, num_steps_hint=STEPS,
        device=dev)
    scene = stepper.prepare_scene(scene)
    state, _ = stepper.rollout(state, scene, params, cfg, 1, record=False)
    rng = np.random.default_rng(5)
    dead = torch.from_numpy(rng.uniform(size=N) < 0.1).to(dev)
    mode = torch.from_numpy(rng.integers(0, 5, N).astype(np.int32)).to(dev)
    state = dataclasses.replace(state, alive=state.alive & ~dead, mode=mode)
    perm, _ = morton_order(state.pos_x, state.pos_y, state.alive, "hilbert")
    px, py, vx, vy, rad, alive = (
        a[perm].contiguous() for a in (state.pos_x, state.pos_y, state.vel_x,
                                       state.vel_y, state.radius, state.alive))
    snap = vehicles.vehicle_snapshot_at(scene.vehicles, 0)
    pdyn = params.dynamic_obstacle
    dyn, dvel, dact = vehicles.snapshot_segment_pointset(
        snap, pdyn.perception_threshold)
    b = params.border
    env_cases = {
        "env_exp": ("borders", scene.borders_seg, None, None, b),
        "env_moussaid": ("parked cars", scene.static_obstacles_seg,
                         scene.static_obstacle_vel, None,
                         params.static_obstacle),
        "env_moussaid vehicles": ("vehicles", dyn, dvel.contiguous(), dact,
                                  pdyn)}

    def env_call(key, use_radius, plain):
        _, seg, ovel, active, prm_ = env_cases[key]
        if key == "env_exp":
            fn = forces.env_exp_force if plain else cuda_env.env_exp
            return fn(px, py, rad, alive, seg, prm_.a, prm_.b,
                      use_radius=use_radius)
        fn = forces.env_moussaid_force if plain else cuda_env.env_moussaid
        return fn(px, py, vx, vy, rad, alive, seg, ovel, prm_,
                  use_radius=use_radius, active=active)

    worst.update(env_exp=0.0, env_moussaid=0.0)
    for key in env_cases:
        for use_radius in (False, True):
            want = torch.stack(env_call(key, use_radius, plain=True))
            got = torch.stack(env_call(key, use_radius, plain=False))
            torch.cuda.synchronize()
            err = (got - want).abs()
            say(f"phase 6 {key} ({env_cases[key][0]}) use_radius="
                f"{use_radius}, N={N}, Hilbert-sorted, 10% dead: max abs err "
                f"{err.max().item():.3e}, max |f| "
                f"{want.abs().max().item():.3e}, tolerance {ENV_ATOL:g} + "
                f"{ENV_RTOL:g}*|f|")
            if not torch.isfinite(got).all():
                fail(f"{key} returned non-finite forces")
            if bool((err > ENV_ATOL + ENV_RTOL * want.abs()).any()):
                fail(f"{key} disagrees with the plain version")
            if bool((got[:, ~alive] != 0).any()):
                fail(f"{key}: dead agents' forces are not exactly zero")
            name = key.split()[0]
            worst[name] = max(worst[name], err.max().item())
    # the fused terms (one sort, crossing agents' border terms zeroed)
    # against the plain force terms, on the unsorted state
    fused = cuda_env.fused_environment_terms(state, scene, params, snap)
    plain = stepper.force_terms(
        state, scene, params, dataclasses.replace(cfg, plain_env_force=True),
        snap)
    for name, got in fused.items():
        got, want = torch.stack(got), torch.stack(plain[name])
        err = (got - want).abs()
        say(f"phase 6 fused {name}, N={N} with crossing and dead agents: "
            f"max abs err {err.max().item():.3e}")
        if bool((err > ENV_ATOL + ENV_RTOL * want.abs()).any()):
            fail(f"fused {name} disagrees with the plain force term")
    # the float64 oracle on a small config #3 scene
    env_oracle(dev, card)
    # times and bounds at the main path's shapes: the kernel's device time
    # (profiler), the wrapper's time (CUDA events around back-to-back calls:
    # host-bound where the kernel is short) and the plain version's
    env_ms, wrapper_ms, bounds_env, pairs = {}, {}, {}, {}
    for key in env_cases:
        _, seg, _, active, _ = env_cases[key]
        call = (lambda k=key: env_call(k, False, plain=False))
        wrapper_ms[key] = cuda_ms(call)
        env_ms[key] = device_ms(call, "env_force_kernel<" + (
            "false>" if key == "env_exp" else "true>"))
        if env_ms[key] is None:
            say(f"phase 6 {key}: the profiler reports no device time; the "
                f"kernel time below is the wrapper's (CUDA events)")
            env_ms[key] = wrapper_ms[key]
        plain_ms[key] = cuda_ms(lambda k=key: env_call(k, False, plain=True),
                                reps=5)
        n_bytes, ops, mufu, pairs[key] = env_work(
            seg, px, py, alive, active, key != "env_exp")
        bounds_env[key] = bound(n_bytes, ops, mufu)
        say(f"phase 6 time {key} ({env_cases[key][0]}, "
            f"{seg.num_segments} x {seg.points_per_segment} slots), N={N}: "
            f"kernel {env_ms[key]:.4f} ms on the device, wrapper "
            f"{wrapper_ms[key]:.4f} ms, plain {plain_ms[key]:.4f} ms, "
            f"bound {bounds_env[key][0]:.6f} ms ({bounds_env[key][1]}; "
            f"{pairs[key]} in-filter pairs, {ops:.3e} operations, "
            f"{mufu:.3e} special-function operations, {n_bytes} bytes) "
            f"({card})")
    torch.cuda.synchronize()

    # -- phase 7: main paths, configs #2 and #3 ------------------------------
    for label, with_obstacles in (("config #2", False), ("config #3", True)):
        scene, params, cfg, state = benchmark_bundle(
            N, with_borders=True, with_obstacles=with_obstacles,
            num_steps_hint=STEPS, device=dev)
        expect = dict(zero, pair_force_sym=STEPS, env_exp=STEPS,
                      env_moussaid=2 * STEPS if with_obstacles else 0)
        counts, step_ms[label] = drive(f"phase 7 {label}", scene, params, cfg,
                                       state, STEPS, expect)
        if with_obstacles:
            launches["env_exp"] = counts["env_exp"]
            launches["env_moussaid"] = counts["env_moussaid"]
            profile_steps(scene, params, cfg, state, step_ms[label],
                          f"phase 7 {label}")

    # -- phase 8: config #3 end to end, kernels vs plain versions ------------
    ref_cfg = dataclasses.replace(cfg, plain_pair_force=True,
                                  plain_env_force=True)
    t0 = time.perf_counter()
    _, rec_plain = stepper.make_rollout_fn(scene, params, ref_cfg,
                                           PARITY_STEPS)(state)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    _, rec_kern = stepper.make_rollout_fn(scene, params, cfg,
                                          PARITY_STEPS)(state)
    torch.cuda.synchronize()
    check_records("phase 8 config #3", rec_kern, rec_plain)
    say(f"phase 8 plain-path rollout, config #3: "
        f"{N * PARITY_STEPS / plain_s:.1f} agent-steps/s over "
        f"{PARITY_STEPS} steps ({card})")

    csrc = "carla_social_force_model_tpu_torch/csrc/"
    table = [
        ("pair_force_sym", csrc + "pair_forces.cu",
         "carla_social_force_model_tpu/ops/pallas_forces.py:239",
         kernel_ms["pair_force_sym"], plain_ms["pair"],
         bounds["pair_force_sym"]),
        ("pair_force_dense", csrc + "pair_forces.cu",
         "carla_social_force_model_tpu/ops/pallas_forces.py:162",
         kernel_ms["pair_force_dense"], plain_ms["pair"],
         bounds["pair_force_dense"]),
        ("env_exp", csrc + "env_forces.cu",
         "carla_social_force_model_tpu/ops/pallas_env.py:235",
         env_ms["env_exp"], plain_ms["env_exp"], bounds_env["env_exp"]),
        # the parked cars: the larger of the two env_moussaid launches
        ("env_moussaid", csrc + "env_forces.cu",
         "carla_social_force_model_tpu/ops/pallas_env.py:268",
         env_ms["env_moussaid"], plain_ms["env_moussaid"],
         bounds_env["env_moussaid"]),
    ]
    for name, *_ in table:
        if launches[name] == 0:
            fail(f"{name} was not launched on its main path")
    say(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": worst[name], "ms": ms, "plain_ms": p_ms,
         "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None}
        for name, source, replaces, ms, p_ms, bnd in table]}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def check_records(label, rec_kern, rec_plain):
    """Alive and modes equal, positions finite and within POS_TOL_M."""
    import torch
    linf = (rec_kern.pos - rec_plain.pos).abs().amax(dim=(1, 2)).cpu()
    say(f"{label} position L-inf kernels vs plain, steps 1..{PARITY_STEPS}: "
        + " ".join(f"{v:.2e}" for v in linf.tolist()))
    if not torch.equal(rec_kern.alive, rec_plain.alive):
        fail(f"{label}: alive masks differ between kernel and plain rollouts")
    if not torch.equal(rec_kern.mode, rec_plain.mode):
        fail(f"{label}: modes differ between kernel and plain rollouts")
    if not torch.isfinite(rec_kern.pos).all():
        fail(f"{label}: non-finite positions in the recorded rollout")
    if linf.max().item() > POS_TOL_M:
        fail(f"{label}: position L-inf {linf.max().item():.3e} m exceeds "
             f"{POS_TOL_M} m")


def env_oracle(dev, card):
    """The environment kernels against the float64 oracle (tests/oracle.py)
    on a small config #3 scene with dead agents and both radius modes."""
    import numpy as np
    import torch
    import oracle
    from carla_social_force_model_tpu_torch.api.synthetic import (
        benchmark_bundle)
    from carla_social_force_model_tpu_torch.env.pointsets import (
        _per_segment_points as per_segment_points)
    from carla_social_force_model_tpu_torch.models import stepper, vehicles
    from carla_social_force_model_tpu_torch.ops import cuda_env
    scene, params, _, _ = benchmark_bundle(
        ORACLE_N, extent=15.0, with_borders=True, with_obstacles=True,
        num_steps_hint=20, device=dev)
    scene = stepper.prepare_scene(scene)
    rng = np.random.default_rng(9)
    pos = rng.uniform(-15, 15, (ORACLE_N, 2)).astype(np.float32)
    vel = rng.uniform(-1.5, 1.5, (ORACLE_N, 2)).astype(np.float32)
    radius = rng.uniform(0.2, 0.4, ORACLE_N).astype(np.float32)
    alive = rng.uniform(size=ORACLE_N) < 0.9
    mode = np.full(ORACLE_N, 1, np.int32)
    planes = to_planes(pos, vel, radius, alive, dev)
    snap = vehicles.vehicle_snapshot_at(scene.vehicles, 10)
    p_dyn = params.dynamic_obstacle
    dyn, dvel, dact = vehicles.snapshot_segment_pointset(
        snap, p_dyn.perception_threshold)
    f64 = np.float64
    borders = [a.astype(f64) for a in per_segment_points(scene.borders)]
    statics = [a.astype(f64) for a in
               per_segment_points(scene.static_obstacles)]
    valid = snap.template_valid.cpu().numpy()
    outlines = [row[v] for row, v in zip(
        dyn.points.cpu().numpy().astype(f64), valid)]
    for use_radius in (False, True):
        b = params.border
        got = cuda_env.env_exp(planes[0], planes[1], planes[4], planes[5],
                               scene.borders_seg, b.a, b.b,
                               use_radius=use_radius)
        want = oracle.border_force(
            pos.astype(f64), mode, radius, alive, borders,
            scene.borders.centers.astype(f64),
            scene.borders.filter_radius.astype(f64), b.a, b.b,
            use_radius=use_radius)
        checks = [("env_exp", got, want)]
        for label, seg, ovel, act, prm, outl, centers, thr in (
                ("env_moussaid parked cars", scene.static_obstacles_seg,
                 scene.static_obstacle_vel, None, params.static_obstacle,
                 statics, scene.static_obstacles.centers,
                 params.static_obstacle.perception_threshold),
                ("env_moussaid vehicles", dyn, dvel.contiguous(), dact,
                 p_dyn, outlines, snap.center.cpu().numpy(),
                 p_dyn.perception_threshold)):
            got = cuda_env.env_moussaid(*planes, seg, ovel, prm,
                                        use_radius=use_radius, active=act)
            want = oracle.obstacle_force(
                pos.astype(f64), vel.astype(f64), radius, alive, outl,
                np.asarray(centers, f64), ovel.cpu().numpy().astype(f64),
                prm.lambda_, prm.A, prm.gamma, prm.n, prm.n_prime,
                prm.epsilon, thr, use_radius=use_radius,
                active=None if act is None else act.cpu().numpy())
            checks.append((label, got, want))
        for label, got, want in checks:
            got = torch.stack(got).T.cpu().numpy()
            err = float(np.abs(got - want).max())
            say(f"phase 6 {label} vs float64 oracle, N={ORACLE_N}, "
                f"use_radius={use_radius}: max abs err {err:.3e}, max |f| "
                f"{np.abs(want).max():.3e} (tolerance {ORACLE_TOL:g} + "
                f"{ORACLE_TOL:g}*|f|) ({card})")
            if np.any(np.abs(got - want) > ORACLE_TOL * (1 + np.abs(want))):
                fail(f"{label} disagrees with the float64 oracle")


if __name__ == "__main__":
    main()
