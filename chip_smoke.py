#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Builds the port's CUDA kernels from ``carla_social_force_model_tpu_torch/
csrc`` with nvcc, holds each kernel against its plain PyTorch version on
the card, and drives the main paths through
``api.synthetic.benchmark_bundle`` and ``models.stepper.make_rollout_fn``
at N = 10,000 pedestrians, timed runs of 200 steps of dt = 0.05 s each:
BASELINE config #1 (the headless crowd: the pair-force kernels), config #2
(+ sidewalk borders: ``env_exp``; 100 steps) and config #3 (+ parked cars
and moving vehicles: ``env_exp`` and ``env_moussaid``); then config #1 with
a 30 m interaction cutoff at 10,000, 50,000 and 1,000,000 pedestrians (100
steps each), through the cutoff forms of the pair kernels; then the urban
path, BASELINE config #4 (``api.synthetic.urban_bundle``: nav-graph routes,
a reactive autopilot fleet, gap-acceptance crossing, the compacted border
kernel ``env_exp_compact``) at N = 10,000 (a recorded run of 1,000 steps,
timed runs of 100), and config #3 with ``env_compact``
(``env_moussaid_compact`` on the parked cars); then the model families
(phases 15-17): the power-law and Helbing forms of the pair kernels against
their plain versions and float64 oracles, and config #1 under
``bench.py``'s family switches at N = 10,000 x 100 steps (the power law,
the Helbing ellipse, a mixed Moussaid / power-law / Helbing crowd, social
groups of four over half the crowd, the power law with the 30 m cutoff),
with shorter paths that launch the other forms; then the ORCA slice (phases
18-20): the analytic form of the border kernel (``env_exp_analytic`` and
its compacted form) and the wall-feed kernels (``seg_topk``,
``chunk_topk``, ``chunk_closest``) against their plain versions, and
``bench.py``'s ORCA switches: config #3 with ORCA and the analytic border
tier at N = 10,000 x 200 steps, and at 200 steps config #1 with ORCA, the
urban path with ORCA, a mixed Moussaid / power-law / ORCA crowd and config
#2 with ORCA at N = 50,000; then the scenario slice (phases 21-23): the
chunk scan of the chunked environment forces (``chunk_argmin``) against its
plain version bitwise, every shipped scenario through
``api.simulation.Simulation`` at its golden's horizon (with
``run_streamed`` and the CLI), and a Town02 crowd of 10,000 random
pedestrians built through ``api.scenario.build_scenario`` at 200 steps;
then agent sharding (phases 24-26): the rectangular forms of the dense
pair kernels, the full-block kernel ``pair_force_sym_dense`` and the
in-kernel ring ``ring_force`` against their plain versions, config #1 at
N = 10,000 over 4 virtual shards on the one card (a ``LocalMesh``) under
each column schedule (``gather``, ``ring``, the half-ring,
``ring_kernel``) and with the 30 m cutoff at N = 50,000, each step checked
against the single-device kernel path, then 100 timed steps; the urban
path, groups and config #3 + ORCA sharded, and a 1-rank NCCL
process-group run.  It counts the kernel launches of each path, and checks
every step of 50-step rollouts through the kernels against the same step
through the plain versions from the same state (and names the agent of
the worst step).  Phase 2 also counts the SASS instructions of the
symmetric and dense pair walks', the ring's, the environment kernel's,
the chunk scan's and the chunk top-k's inner loops
(``tools/sass_census.py``, with cuobjdump and nvdisasm), and the kernel
times of phases 3, 6, 9, 12, 18, 21 and 24 print the issue-rate floor
they give beside the bound (phase 15: the power law's symmetric and
dense forms and Helbing's dense form).

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card, nvcc (on PATH or under /usr/local/cuda) and no
network, and imports nothing of JAX.  Any failed phase exits non-zero; on
success the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N = 10_000
STEPS = 1_000
#: steps of the timed runs of the headline paths (configs #1 and #3, phases
#: 4 and 7; config #3 + ORCA, phase 19): cut from STEPS to keep the run
#: within half its time limit once the scenario phases came in (the urban
#: record keeps STEPS: its walkers need the time to reach the crossings)
MAIN_STEPS = 200
PARITY_STEPS = 50
#: kernel vs plain version, elementwise |got - want| <= ATOL + RTOL*|want|:
#: f32 summation order (the symmetric kernel's atomics change it from run
#: to run) and last-ulp differences of rsqrt/atan2/exp
ATOL = RTOL = 1e-4
#: end to end, one step from the same state through the kernels and through
#: the plain versions, at every step of a 50-step rollout: the kernels'
#: force error (ATOL/RTOL) moves an agent by at most dt^2 * 1e-4 * |f| (or,
#: velocity-capped, dt * 2 m/s * 1e-4), plus a few ulps of a 100 m position
POS_STEP_TOL_M = 1e-4
#: end to end, 50 free-running steps through the kernels vs through the
#: plain versions (config #1 only: no agent there amplifies a difference
#: within 50 steps; in config #3 an agent pinned against a border doubles
#: a one-ulp difference about every five steps, so that comparison is
#: printed, not held to a limit)
POS_TOL_M = 1e-3
#: the cutoff path: BASELINE config #1 with a 30 m interaction cutoff at
#: the sizes users run it (extent sqrt(N): 0.25 pedestrians/m^2); the
#: kernel checks use seeded crowds of CUT_CHECK_N and a row sample at CUT_BIG_N
CUTOFF_M = 30.0
CUT_CHECK_N = (10_000, 50_000)
CUT_N = 50_000
#: steps of the Moussaid cutoff paths at 10k and 50k (phase 10), of
#: config #2 (phase 7) and of the urban path's timed runs (phase 13; its
#: recorded run keeps STEPS): cut from 1,000 (and from 200 once the
#: scenario phases came in) to keep the run within half its time limit
CUT_STEPS = 100
#: steps of each main path's warm-up run before its timed runs
WARMUP_STEPS = 20
CUT_BIG_N = 1_000_000
CUT_BIG_STEPS = 100
SAMPLE_ROWS = 4_096
#: an explicit survivor-table width that forces the compacted kernels at
#: N = 10,000 (79 tiles of 128, 40 of 256 per row)
FORCED_MAX_SURV = 32
#: steps of the config #3 + env_compact main path (phase 14), which
#: launches env_moussaid_compact (cut from 200 when the sharding phases
#: came in)
C3_COMPACT_STEPS = 100
#: kernel vs the float64 numpy oracle (tests/oracle.py) on a small crowd
ORACLE_N = 200
ORACLE_TOL = 1e-4
#: environment kernel vs plain version: both pick the same closest point
#: and filter outcome (squared distances rounded after every operation on
#: both sides), so what is left is last-ulp differences of rsqrt, exp, atan2
#: and the division
ENV_ATOL = ENV_RTOL = 1e-5

#: the model-family main paths: bench.py's BENCH_LAW=powerlaw,
#: BENCH_LAW=helbing, BENCH_MIX=moussaid,powerlaw,helbing and
#: BENCH_GROUPS=0.5:4 switches on config #1 (phases 16 and 17)
FAMILY_SWITCHES = ("powerlaw", "helbing", "mix-moussaid-powerlaw-helbing",
                   "groups-0.5:4")
#: steps of every family path (phase 16): the headline ones (cut from STEPS,
#: then from 200 and 100, to keep the run within half its time limit as
#: later slices add paths) and those that exist to launch the other forms of
#: the family kernels (dense, dense cutoff, the tables at 50k)
FAMILY_FORM_STEPS = 50

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
#: the family laws per pair (csrc/pair_forces.cuh), counting only what the
#: function needs on these inputs (no per-pair work on the constant
#: parameters: v0/sigma, 1/sigma, 1/tau0 are computed once): the power
#: law's gate values (a, b, c, D, the compares) for every pair, its time to
#: collision (a root, a reciprocal of a) for the pairs on a collision
#: course, the rest (an exp, the reciprocals of tau and of s) for the pairs
#: that contribute; the Helbing ellipse for every pair: 4 reciprocal roots
#: (of |d|^2 and |d - y|^2, which give |d|, |d - y| and the two unit
#: vectors; of b^2, which gives b and 1/b; of the field-of-view |f|^2) and
#: an exp
PL_GATE_OPS = 16
PL_TAU_OPS, PL_TAU_MUFU = 4, 2
PL_FORCE_OPS, PL_FORCE_MUFU = 18, 3
HB_OPS, HB_MUFU = 50, 5
#: the ORCA slice per pair (csrc/env_forces.cuh closest_on_segment: the
#: projection of a pedestrian on a segment, clamp, closest point and squared
#: distance; csrc/statics.cuh topk_insert: a candidate's compares against
#: the running list)
SEG_OPS = 19
TOPK_OPS = 8

#: the ORCA paths (phases 18-20): bench.py's BENCH_LAW=orca switch with
#: BENCH_MODE=obstacles, borders or urban and BENCH_ENV_ANALYTIC=1, and
#: BENCH_MIX=moussaid,powerlaw,orca; the headline path (config #3) runs
#: STEPS, the others ORCA_FORM_STEPS (cut from 200 when the sharding
#: phases came in), the config #2 path at ORCA_BIG_N
ORCA_FORM_STEPS = 100
ORCA_BIG_N = 50_000
#: the urban path's survivor-table width: its 320 analytic border sections
#: make 5 groups of 64, which the auto width (5) never compacts
ORCA_URBAN_MAX_SURV = 4

#: the scenario slice (phases 21-23): the Town02 crowd built through
#: api/scenario.build_scenario from configs/scenarios/routed_town.toml with
#: the full Town02 sidewalk capture and walker.random_pedestrians (random
#: nav-graph origins and A* routes), on the jnp environment path
#: (env_chunked: the chunk_argmin kernel); its timed runs, and every
#: shipped scenario at its golden's horizon (tests/golden/README.md)
TOWN_N = 10_000
TOWN_STEPS = 200
#: operations per (point slot, pedestrian) pair of the chunk scan
#: (csrc/statics.cu chunk_argmin_kernel: two differences, two products, a
#: sum, the minimum and, for the first index, a compare and a select)
ARGMIN_OPS = 8
#: the goldens' scenarios, horizons (s) and force files (tests/golden)
#: agent sharding (phases 24-26): virtual shards on the one card (a
#: LocalMesh), the ring kernel's device counts, the timed run of each
#: sharded path, the groups and ORCA paths' checked steps, the steps of the
#: 50k path also checked against the sharded plain path (its plain cutoff
#: force evaluates all N^2 pairs) and those of the 1-rank NCCL run
SHARDS = 4
RING_DEVICES = (2, 3, 4, 8)
SHARD_STEPS = 100
SHARD_SIDE_STEPS = 20
SHARD_BIG_PLAIN_STEPS = 3
#: steps of the 10k paths also checked against the sharded plain path (the
#: rest against the single-device kernel path only), and of the sharded
#: timed runs' warm-up
SHARD_PLAIN_STEPS = 10
SHARD_WARMUP_STEPS = 5
NCCL_STEPS = 10
GOLDENS = (("corridor_counterflow", 15.0, None, None),
           ("road_crossing", 15.0, None, None),
           ("obstacle_evasion", 15.0, None, None),
           ("circle_holding", 15.0, None, None),
           ("orthogonal_crossing", 15.0, None, None),
           ("orthogonal_crossing", 90.0, "orthogonal_crossing_90s", None),
           ("jaywalking_reactive", 25.0, None, None),
           ("sidewalk_counterflow", 15.0, None, None),
           ("routed_town", 15.0, None, None),
           ("routed_town_walled", 15.0, None, None),
           ("vehicle_evasion", 15.0, None, None),
           ("destination_vehicle", 25.0, None, None),
           ("corridor_counterflow", 15.0, "orca_corridor", "sfm_orca.toml"),
           ("grouped_crossing", 15.0, None, "sfm_groups.toml"),
           ("mixed_crossing", 15.0, None, "sfm_mixed.toml"),
           ("antipodal_circle", 30.0, None, None),
           ("overtaking", 30.0, None, None))


def fail(msg: str) -> None:
    """Print the failure on both streams (a caller that keeps only the end
    of standard error still sees it) and exit 1."""
    print(f"FAIL: {msg}", flush=True)
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


#: the run's start on the host clock (main sets it)
START = [time.perf_counter()]


def lap(phase: str) -> None:
    """Print the seconds since the run started, as a phase begins (where
    the command's time goes)."""
    say(f"[{time.perf_counter() - START[0]:.1f} s] {phase}")


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


def kernel_activities(prof, kernel):
    """The device activities of a finished profile whose name contains
    ``kernel`` (every one when ``kernel`` is empty), each once:
    ``(own, raw, foreign)``, ``own`` {(correlation id, start ns): duration
    ns} of those whose launch (a CUDA API call of the same correlation id)
    the profile holds, ``raw`` the number of matching events it returned
    (an activity may come back more than once) and ``foreign`` the distinct
    ones launched outside it (an earlier profile's, delivered late)."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    calls = {e.correlation_id() for e in events
             if e.device_type() == DeviceType.CPU
             and e.name().startswith("cu")}
    distinct, raw = {}, 0
    for e in events:
        if e.device_type() != DeviceType.CUDA or kernel not in e.name():
            continue
        raw += 1
        distinct.setdefault((e.correlation_id(), e.start_ns()),
                            e.end_ns() - e.start_ns())
    own = {key: ns for key, ns in distinct.items() if key[0] in calls}
    return own, raw, len(distinct) - len(own)


def listing_note(prof, kernel, own, raw, foreign):
    """Why the profiler's table disagrees with its activities: the rows of
    ``key_averages()`` that the filter matches with their counts, the
    activities (raw, launched in the profile, launched outside it) and the
    first event returned twice."""
    rows = {e.key: e.count for e in prof.key_averages()
            if kernel in e.key and e.self_device_time_total > 0}
    seen, twice = set(), None
    for e in prof.profiler.kineto_results.events():
        if kernel not in e.name():
            continue
        key = (e.device_type(), e.correlation_id(), e.start_ns())
        if key in seen and twice is None:
            twice = (f"{e.name()[:60]} correlation {e.correlation_id()} "
                     f"device {e.device_type()} start {e.start_ns()} "
                     f"{e.end_ns() - e.start_ns()} ns stream "
                     f"{e.device_resource_id()}")
        seen.add(key)
    return (f"(profile of {kernel}: table rows {rows}; {raw} device events, "
            f"{len(own)} distinct launched in the profile, {foreign} "
            f"launched outside it; first repeat: {twice})")


def graph_ms(fn, reps=20):
    """Mean device milliseconds of ``fn()`` per call: ``reps`` calls
    captured in one CUDA graph and replayed between CUDA events (after a
    warm-up call on a side stream and one warm-up replay), so the kernels
    run back to back with no host time between them.  ``None`` when the
    calls cannot be captured (a host synchronisation inside)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
    except RuntimeError as e:
        say(f"(no CUDA graph of the calls: {str(e).splitlines()[0]})")
        torch.cuda.synchronize()
        return None
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


#: how the last ``device_ms`` timed its kernel
TIMED_BY = [""]


def device_ms(fn, kernel, reps=20):
    """Mean device milliseconds of the kernels whose name contains
    ``kernel`` (every kernel when ``kernel`` is empty) per call of
    ``fn()``, with no host time in it; each call must launch one such
    kernel.  First the profiler's device activities over ``reps`` calls
    (after one warm-up call), each counted once by its correlation id and
    start and only where the profile holds its launch call: the table of
    ``key_averages()`` once counted 39 launches of ``seg_topk`` in 20
    calls, and the profiler often misses some (2 or 3 of 20, 3 of 10), so
    the profile is believed only when it holds exactly ``reps`` such
    launches (any device time, without a filter), and a table that
    disagrees is printed with the activities.  Asked three times; then
    ``reps`` calls in a CUDA graph replayed between CUDA events
    (``graph_ms``); where the calls cannot be captured, the mean of the
    launches the last profile did record.  The printed note names the
    method (and ``TIMED_BY[0]`` keeps it); the phase fails when no method
    gives a time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    own = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        own, raw, foreign = kernel_activities(prof, kernel)
        total = sum(own.values())
        if kernel:
            listed = sum(e.count for e in prof.key_averages()
                         if kernel in e.key and e.self_device_time_total > 0)
            if listed != len(own) or raw != len(own):
                say(listing_note(prof, kernel, own, raw, foreign))
        if total > 0 and (not kernel or len(own) == reps):
            TIMED_BY[0] = (f"profiler, {len(own)} distinct launches in "
                           f"{reps} calls")
            return total / 1e6 / reps
        say(f"(the profiler recorded {len(own)} distinct launches of "
            f"{kernel or 'any kernel'} in {reps} calls, {total / 1e6:.4f} ms)")
    ms = graph_ms(fn, reps)
    if ms is not None:
        TIMED_BY[0] = f"CUDA graph of {reps} calls"
        say(f"(the next time of {kernel or 'all kernels'} is a CUDA graph of "
            f"{reps} calls replayed between CUDA events: device time of "
            f"every kernel of a call, no host time)")
        return ms
    if kernel and own:
        TIMED_BY[0] = f"profiler, mean of {len(own)} of {reps} launches"
        say(f"(the next time of {kernel} is the mean of the {len(own)} "
            f"launches the profiler recorded)")
        return sum(own.values()) / 1e6 / len(own)
    fail(f"no device time of {kernel or 'the calls'}: the profiler missed "
         f"launches and the calls cannot be captured in a CUDA graph")


def bound(n_bytes, ops, mufu):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over their peak rates (f32 and special-function)."""
    t_bytes = n_bytes / PEAK_BYTES_S
    t_ops = max(ops / PEAK_F32_S, mufu / PEAK_MUFU_S)
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes > t_ops else "operations")


#: the SASS census of phase 2 (tools/sass_census.py): {kernel label: its
#: inner loop's instructions per pair or scanned point, and its layout:
#: rows per thread R of a symmetric walk, lanes per pedestrian L of an
#: environment kernel}
CENSUS = {}


def floor_note(label, units):
    """The issue-rate floor of ``units`` pairs (or scanned points) through
    the inner loop of the census kernel ``label``, with its SASS
    instructions per unit and the layout."""
    from sass_census import floor_ms
    c = CENSUS[label]
    return (f"issue floor {floor_ms(c['per_unit'], units):.6f} ms "
            f"({c['per_unit']:.2f} SASS instructions per {c['unit']} x "
            f"{units} {c['unit']}s; {c['layout']})")


def scanned(seg, px, py, alive, active=None):
    """The slots an environment launch must scan on these inputs: each
    (section, alive pedestrian) pair inside the section's filter circle
    times the section's real points (or segments)."""
    from carla_social_force_model_tpu_torch.env.pointsets import PAD_COORD
    from carla_social_force_model_tpu_torch.ops.geometry import (
        segment_filter_mask)
    rows = seg.x if hasattr(seg, "x") else seg.ax
    real = (rows != PAD_COORD).sum(dim=1)
    ok = segment_filter_mask(px, py, seg) & alive[None, :]
    if active is not None:
        ok = ok & active[:, None]
    return int((ok.sum(dim=1) * real).sum())


def config3_env_inputs(dev):
    """Phase 6's inputs: config #3 at ``N`` after one step, 10% of it dead
    and the modes drawn at random (seed 5); its planes (x, y, vx, vy,
    radius, alive) Hilbert-sorted; the vehicles at step 0 and their rows
    (point set, velocities, active).  Returns ``(scene, params, cfg, state,
    snapshot, planes, rows)``."""
    import dataclasses
    import numpy as np
    import torch
    from carla_social_force_model_tpu_torch.api.synthetic import (
        benchmark_bundle)
    from carla_social_force_model_tpu_torch.models import stepper, vehicles
    from carla_social_force_model_tpu_torch.ops.spatial import morton_order
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
    planes = [a[perm].contiguous() for a in (
        state.pos_x, state.pos_y, state.vel_x, state.vel_y, state.radius,
        state.alive)]
    snap = vehicles.vehicle_snapshot_at(scene.vehicles, 0)
    dyn, dvel, dact = vehicles.snapshot_segment_pointset(
        snap, params.dynamic_obstacle.perception_threshold)
    return scene, params, cfg, state, snap, planes, (dyn, dvel.contiguous(),
                                                     dact)


def sorted_env_state(state, seed):
    """Phase 12's crowd: ``state`` with 10% of it dead and 10% crossing the
    road (``seed``); returns its planes (x, y, vx, vy, radius, alive)
    Hilbert-sorted, and the state."""
    import dataclasses
    import numpy as np
    import torch
    from carla_social_force_model_tpu_torch.models import modes
    from carla_social_force_model_tpu_torch.ops.spatial import morton_order
    rng = np.random.default_rng(seed)
    n, dev = state.capacity, state.pos_x.device
    dead = torch.from_numpy(rng.uniform(size=n) < 0.1).to(dev)
    cross = torch.from_numpy(rng.uniform(size=n) < 0.1).to(dev)
    state = dataclasses.replace(
        state, alive=state.alive & ~dead,
        mode=torch.where(cross, modes.CROSSING_ROAD, state.mode))
    perm, _ = morton_order(state.pos_x, state.pos_y, state.alive, "hilbert")
    return [a[perm].contiguous() for a in (
        state.pos_x, state.pos_y, state.vel_x, state.vel_y, state.radius,
        state.alive)], state


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


def sorted_crowd(n, seed, dev):
    """A seeded crowd (10% dead, one coincident pair, extent sqrt(N)) in the
    Hilbert order the cutoff path gives its kernels."""
    import numpy as np
    from carla_social_force_model_tpu_torch.ops.spatial import morton_order
    planes = to_planes(*seeded_crowd(n, seed, float(np.sqrt(n))), dev)
    perm, _ = morton_order(planes[0], planes[1], planes[5], "hilbert")
    return [t[perm].contiguous() for t in planes]


def cutoff_grids(planes):
    """The launch grids of the four cutoff kernels on ``planes``: each
    form with the table the auto gate would build, the compacted forms also
    with a table just wide enough for the widest row (the compact branch,
    never the overflow) and with one slot (every row with two or more hits
    overflows)."""
    from carla_social_force_model_tpu_torch.ops import pair_grid as pg
    x, y, alive = planes[0], planes[1], planes[5]
    row_bb = pg.box_planes(x, y, alive, pg.SYM_TILE)
    grids = {}
    for sym, base in ((True, "sym_"), (False, "")):
        col_bb = row_bb if sym else pg.box_planes(x, y, alive, pg.COL_TILE)
        hits = pg._bbox_hits(row_bb, col_bb, CUTOFF_M)
        if sym:
            hits &= pg.triangle_mask(hits.shape[0], hits.shape[1],
                                     pg.SYM_TILE, pg.SYM_TILE, hits.device)
        counts = hits.sum(dim=1)
        widest = max(int(counts.max()), 1)
        grids[base + "counts"] = (counts, hits.shape[1])
        grids[base + "cutoff"] = pg.cutoff_grid(x, y, alive, CUTOFF_M,
                                                symmetric=sym, compact=False)
        grids[base + "compact"] = pg.cutoff_grid(
            x, y, alive, CUTOFF_M, symmetric=sym, max_surv=widest)
        grids[base + "compact overflow"] = pg.cutoff_grid(
            x, y, alive, CUTOFF_M, symmetric=sym, max_surv=1)
    grids["dense_cutoff"] = grids.pop("cutoff")
    return grids


def pairs_within(planes, sym_counts_grid):
    """Unordered pairs of alive agents within the cutoff, counted over the
    tile pairs of a symmetric survivor table wide enough for every row
    (``cutoff_grids``'s ``"sym_compact"``; exact because the box test is
    conservative, which the brute-force count at 50k checks)."""
    import torch
    from carla_social_force_model_tpu_torch.ops.pair_grid import SYM_TILE
    x, y, alive = planes[0], planes[1], planes[5]
    n = x.shape[0]
    g = sym_counts_grid
    total = 0
    idx = torch.arange(SYM_TILE, device=x.device)
    # a batch of row tiles against their surviving column tiles at a time
    for r0 in range(0, g.surv.shape[0], 64):
        rows = torch.arange(r0, min(r0 + 64, g.surv.shape[0]),
                            device=x.device)
        ri = rows[:, None] * SYM_TILE + idx[None, :]           # (B, 128)
        tiles = g.surv[rows].long()                            # (B, S)
        ci = (tiles[:, :, None] * SYM_TILE + idx).flatten(1)   # (B, S*128)
        listed = (tiles[:, :, None] >= 0).expand(-1, -1, SYM_TILE).flatten(1)
        ri_c, ci_c = ri.clamp(max=n - 1), ci.clamp(0, n - 1)
        dx = x[ci_c][:, None, :] - x[ri_c][:, :, None]
        dy = y[ci_c][:, None, :] - y[ri_c][:, :, None]
        hit = ((dx * dx + dy * dy <= g.c2) & listed[:, None, :]
               & (ci[:, None, :] > ri[:, :, None]) & (ci[:, None, :] < n)
               & (ri[:, :, None] < n) & alive[ri_c][:, :, None]
               & alive[ci_c][:, None, :])
        total += int(hit.sum())
    return total


#: the cutoff kernels, the grid each is checked on (cutoff_grids), and
#: the N of the main path that runs it
CUTOFF_FORMS = {"pair_force_dense_cutoff": ("dense_cutoff", N),
                "pair_force_sym_cutoff": ("sym_cutoff", N),
                "pair_force_compact": ("compact", CUT_N),
                "pair_force_sym_compact": ("sym_compact", CUT_N)}


def cutoff_kernel_checks(dev, card):
    """Phase 9: the four cutoff kernels against the plain version (with
    ``cutoff``) on seeded Hilbert-sorted crowds at 10k and 50k, and on a
    4,096-row sample at 1M; the compacted kernel against the dense cutoff
    kernel bitwise, with a table that fits and one that overflows; the
    dense cutoff kernel at the f32-exact cutoff against the no-cutoff
    kernel bitwise.  Returns ``(worst, results)``: each kernel's largest
    error, and its device time, plain time and bound at its main path's N
    (with the timings at every N printed)."""
    import numpy as np
    import torch
    from carla_social_force_model_tpu_torch.models.params import (
        MoussaidParams, moussaid_vector)
    from carla_social_force_model_tpu_torch.ops import (
        cuda_forces, forces, pair_grid)
    p = MoussaidParams()
    prm = moussaid_vector(p, dev)
    worst = dict.fromkeys(CUTOFF_FORMS, 0.0)
    results = {}

    def run(planes, grid, use_radius=False):
        return torch.stack(cuda_forces.pair_force_cutoff(
            *planes[:5], planes[5], prm, grid, use_radius=use_radius))

    def check(label, got, want, dead, name):
        err = (got - want).abs()
        rel = (err / (1.0 + want.abs())).max().item()
        say(f"phase 9 {label}: max abs err {err.max().item():.3e}, max "
            f"err/(1+|f|) {rel:.3e}, max |f| {want.abs().max().item():.3e}, "
            f"tolerance {ATOL:g} + {RTOL:g}*|f|")
        if not torch.isfinite(got).all():
            fail(f"{label}: non-finite forces")
        if bool((err > ATOL + RTOL * want.abs()).any()):
            fail(f"{label}: disagrees with the plain version")
        if bool((got[:, dead] != 0).any()):
            fail(f"{label}: dead rows are not exactly zero")
        worst[name] = max(worst[name], err.max().item())

    def survivors(n, grids):
        for base, what in (("sym_", "symmetric, hits and triangle, "
                                    "128 x 128 tiles"),
                           ("", "dense, 128-row table rows x 256-column "
                                "tiles")):
            counts, n_cols = grids[base + "counts"]
            c = counts.float()
            say(f"phase 9 survivors per table row at N={n} ({what}): mean "
                f"{c.mean().item():.2f}, max {int(counts.max())}, of "
                f"{n_cols} column tiles; {counts.shape[0]} table rows; auto "
                f"table width {pair_grid.AUTO_MAX_SURV}, rows over it "
                f"{int((counts > pair_grid.AUTO_MAX_SURV).sum())}")

    def work(n, grids, pairs_u):
        out = {}
        for name, (key, _) in CUTOFF_FORMS.items():
            g = grids[key]
            n_bytes = (n * (5 * 4 + 1) + 6 * 4 + n * 8
                       + 4 * g.boxes.numel()
                       + (4 * (g.surv.numel() + g.counts.numel())
                          if g.surv is not None else 0))
            if key.startswith("sym"):
                out[name] = bound(n_bytes, pairs_u * (PAIR_OPS + 2),
                                  pairs_u * PAIR_MUFU)
            else:
                out[name] = bound(n_bytes, 2 * pairs_u * PAIR_OPS,
                                  2 * pairs_u * PAIR_MUFU)
        return out

    def times(n, planes, grids, pairs_u, reps):
        bounds = work(n, grids, pairs_u)
        ms = {}
        for name, (key, _) in CUTOFF_FORMS.items():
            kernel = ("pair_force_sym_kernel" if key.startswith("sym")
                      else "pair_force_dense_kernel")
            ms[name] = device_ms(lambda g=grids[key]: run(planes, g), kernel,
                                 reps=reps)
            if key.startswith("sym"):
                floor = "; " + floor_note(
                    "pair_force_sym<kTriangleBox, Moussaid>"
                    if grids[key].form == "sym_cutoff"
                    else "pair_force_sym<kSymTable, Moussaid>", pairs_u)
            else:  # the box-skip and table walks share one inner loop
                floor = "; " + floor_note(
                    "pair_force_dense<kTable, Moussaid>", 2 * pairs_u)
            say(f"phase 9 time {name} at N={n}, {CUTOFF_M:g} m cutoff: "
                f"{ms[name]:.4f} ms on the device, bound "
                f"{bounds[name][0]:.6f} ms ({bounds[name][1]}; "
                f"{pairs_u} unordered pairs within the cutoff){floor} "
                f"({card})")
        return ms, bounds

    for n in CUT_CHECK_N:
        planes = sorted_crowd(n, 11, dev)
        x, y, alive = planes[0], planes[1], planes[5]
        grids = cutoff_grids(planes)
        for key in ("dense_cutoff", "compact", "sym_cutoff", "sym_compact"):
            if grids[key].form != key:
                fail(f"N={n}: the {key} grid came out {grids[key].form}")
        survivors(n, grids)
        for use_radius in (False, True):
            want = torch.stack(forces.pedestrian_force(
                *planes[:5], alive, p, use_ped_radius=use_radius,
                cutoff=CUTOFF_M))
            outs = {}
            for key in ("dense_cutoff", "compact", "compact overflow",
                        "sym_cutoff", "sym_compact", "sym_compact overflow"):
                g = grids[key]
                outs[key] = run(planes, g, use_radius)
                torch.cuda.synchronize()
                check(f"{key} (max_surv {g.max_surv}) N={n} use_radius="
                      f"{use_radius}", outs[key], want, ~alive,
                      "pair_force_" + g.form)
            for key in ("compact", "compact overflow"):
                if not torch.equal(outs[key], outs["dense_cutoff"]):
                    fail(f"N={n}: {key} differs from dense_cutoff bitwise")
            say(f"phase 9 N={n} use_radius={use_radius}: compact == "
                f"dense_cutoff bitwise, with a fitting table and with "
                f"max_surv=1 (overflow)")
        # the f32-exact cutoff: every skipped pair's exp underflows to +0
        speed = torch.sqrt(planes[2] ** 2 + planes[3] ** 2)[alive].max()
        exact_m = float(np.ceil(110.0 * p.gamma
                                * (2.0 * p.lambda_ * speed.item() + 1.0)))
        big = pair_grid.cutoff_grid(x, y, alive, exact_m, symmetric=False,
                                    compact=False)
        got = run(planes, big)
        ref = torch.stack(cuda_forces.pair_force_dense(*planes[:5], alive,
                                                       prm))
        if not torch.equal(got, ref):
            fail(f"N={n}: dense_cutoff at the f32-exact cutoff {exact_m} m "
                 f"differs from pair_force_dense")
        # pairs within the cutoff: over the survivor table, and brute force
        pairs_u = pairs_within(planes, grids["sym_compact"])
        brute = 0
        idx = torch.arange(n, device=dev)
        for lo in range(0, n, 2048):
            dx = x[None, :] - x[lo:lo + 2048, None]
            dy = y[None, :] - y[lo:lo + 2048, None]
            d2 = dx * dx + dy * dy
            brute += int(((d2 <= grids["sym_compact"].c2)
                          & (idx[None, :] > idx[lo:lo + 2048, None])
                          & alive[None, :] & alive[lo:lo + 2048, None]).sum())
        if brute != pairs_u:
            fail(f"N={n}: {pairs_u} in-cutoff pairs over the table, {brute} "
                 f"by brute force: the box test skipped a pair")
        say(f"phase 9 N={n}: dense_cutoff at the f32-exact cutoff "
            f"{exact_m:g} m == pair_force_dense bitwise; {pairs_u} unordered "
            f"pairs within {CUTOFF_M:g} m (table and brute force agree)")
        ms, bounds = times(n, planes, grids, pairs_u, reps=10)
        plain = cuda_ms(lambda: forces.pedestrian_force(
            *planes[:5], alive, p, cutoff=CUTOFF_M), reps=2)
        grid_ms = {sym: cuda_ms(lambda s=sym: pair_grid.cutoff_grid(
            x, y, alive, CUTOFF_M, symmetric=s)) for sym in (True, False)}
        say(f"phase 9 N={n}: plain version with the cutoff {plain:.4f} ms; "
            f"launch grid (auto gate) {grid_ms[True]:.4f} ms symmetric, "
            f"{grid_ms[False]:.4f} ms dense (CUDA events) ({card})")
        for name, (_, n_main) in CUTOFF_FORMS.items():
            if n == n_main:
                results[name] = dict(ms=ms[name], plain_ms=plain,
                                     bound=bounds[name])

    # N = 1M: a row sample against the plain version for those rows only
    with ClockSampler() as sampler:
        n = CUT_BIG_N
        planes = sorted_crowd(n, 13, dev)
        x, y, alive = planes[0], planes[1], planes[5]
        grids = cutoff_grids(planes)
        survivors(n, grids)
        rng = np.random.default_rng(17)
        rows = torch.from_numpy(
            rng.choice(n, SAMPLE_ROWS, replace=False)).to(dev)
        dead = ~alive[rows]
        t0 = time.perf_counter()
        for use_radius in (False, True):
            want = torch.stack(forces.pedestrian_force(
                *planes[:5], alive, p, use_ped_radius=use_radius,
                cutoff=CUTOFF_M, rows=rows, row_block=64))
            torch.cuda.synchronize()
            if not use_radius:
                plain_rows_s = time.perf_counter() - t0
            outs = {}
            for key in ("dense_cutoff", "compact", "compact overflow",
                        "sym_cutoff", "sym_compact", "sym_compact overflow"):
                g = grids[key]
                outs[key] = run(planes, g, use_radius)
                torch.cuda.synchronize()
                check(f"{key} (max_surv {g.max_surv}) N={n}, {SAMPLE_ROWS} "
                      f"sampled rows, use_radius={use_radius}",
                      outs[key][:, rows], want, dead,
                      "pair_force_" + g.form)
            for key in ("compact", "compact overflow"):
                if not torch.equal(outs[key], outs["dense_cutoff"]):
                    fail(f"N={n}: {key} differs from dense_cutoff bitwise")
        pairs_u = pairs_within(planes, grids["sym_compact"])
        times(n, planes, grids, pairs_u, reps=3)
        say(f"phase 9 N={n}: compact == dense_cutoff bitwise (fitting table "
            f"and overflow); plain version for {SAMPLE_ROWS} rows "
            f"{1e3 * plain_rows_s:.1f} ms (host clock) ({card})")
    say(f"phase 9 N={CUT_BIG_N}: {sampler.summary()}")
    return worst, results


class ClockSampler:
    """Samples the card's SM clock, power draw and temperature with
    ``nvidia-smi -lms`` while a block runs; ``summary()`` reads them."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
             "--format=csv,noheader,nounits", "-lms", "200"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        self.rows = []
        for line in out.splitlines():
            try:
                self.rows.append([float(v) for v in line.split(",")])
            except ValueError:
                continue
        return False

    def summary(self):
        if not self.rows:
            return "no nvidia-smi samples"
        clk, pwr, tmp = zip(*self.rows)
        clk = sorted(clk)
        return (f"SM clock min {clk[0]:.0f} / median {clk[len(clk) // 2]:.0f}"
                f" / max {clk[-1]:.0f} MHz, power max {max(pwr):.1f} W, "
                f"temperature max {max(tmp):.0f} C over {len(clk)} samples")


def kernel_modules():
    """The port's modules that count kernel launches."""
    from carla_social_force_model_tpu_torch.ops import (cuda_env, cuda_forces,
                                                        cuda_ring, statics)
    return cuda_forces, cuda_env, statics, cuda_ring


def reset_counts():
    for m in kernel_modules():
        m.reset_launch_counts()


def read_counts():
    counts = {}
    for m in kernel_modules():
        counts.update(m.LAUNCHES)
    return counts


def family_scene(scene, params, switch):
    """bench.py's family switches (bench.py:101-169) on a config #1
    bundle: ``powerlaw`` / ``helbing`` swap the pair law for the power law
    or the Helbing ellipse; ``mix-<law>-<law>...`` splits ``law_id`` into
    equal contiguous chunks, one law each; ``groups-<frac>:<size>`` puts
    the first ``frac`` of the slots into parties of ``size`` and enables
    the group force."""
    import dataclasses
    import numpy as np
    import torch
    from carla_social_force_model_tpu_torch.models.groups import build_groups
    from carla_social_force_model_tpu_torch.models.spawn import LAW_IDS
    cap = scene.spawn.capacity
    dev = scene.spawn.step.device
    if switch in ("powerlaw", "helbing"):
        flag = ("enable_powerlaw" if switch == "powerlaw"
                else "enable_ped_repulsive")
        return scene, dataclasses.replace(params, enable_pedestrian=False,
                                          **{flag: True})
    if switch.startswith("mix-"):
        fams = switch[len("mix-"):].split("-")
        law = np.full(cap, -1, np.int32)
        for fam, chunk in zip(fams, np.array_split(np.arange(cap),
                                                   len(fams))):
            law[chunk] = LAW_IDS[fam]
        scene = dataclasses.replace(scene, spawn=dataclasses.replace(
            scene.spawn, law_id=torch.from_numpy(law).to(dev)))
        return scene, dataclasses.replace(
            params, enable_pedestrian="moussaid" in fams,
            enable_powerlaw="powerlaw" in fams,
            enable_ped_repulsive="helbing" in fams)
    frac, size = switch[len("groups-"):].split(":")
    k = int(float(frac) * cap)
    gid = np.full(cap, -1, np.int32)
    gid[:k] = np.arange(k) // int(size)
    return (dataclasses.replace(scene, groups=build_groups(
                gid, max_members=int(size), device=dev)),
            dataclasses.replace(params, enable_group=True))


def family_work(law, planes, cutoff, sym, grid=None):
    """``(bound_ms, bound_by, pairs)`` of one launch of ``law`` on these
    planes: each plane read once and the forces written once (with the
    grid's boxes and table); the ordered pairs of alive agents (within
    ``cutoff``) and, for the power law, how many of them are on a collision
    course and how many contribute, counted with the gate formulas on this
    data.  ``sym``: each unordered pair once, plus the column update."""
    import torch
    from carla_social_force_model_tpu_torch.ops.pair_grid import cutoff_sq
    from family_cases import family_params
    x, y, vx, vy, rad, alive, ex, ey = planes
    p = family_params(law)
    n = x.shape[0]
    idx = torch.arange(n, device=x.device)
    pairs = course = active = 0
    for lo in range(0, n, 512):
        hi = min(lo + 512, n)
        dx = x[None, :] - x[lo:hi, None]
        dy = y[None, :] - y[lo:hi, None]
        ok = (alive[lo:hi, None] & alive[None, :]
              & (idx[None, :] != idx[lo:hi, None]))
        if cutoff is not None:
            ok &= dx * dx + dy * dy <= cutoff_sq(cutoff)
        pairs += int(ok.sum())
        if law == "powerlaw":
            dvx = vx[lo:hi, None] - vx[None, :]
            dvy = vy[lo:hi, None] - vy[None, :]
            a = dvx * dvx + dvy * dvy
            b = -dx * dvx - dy * dvy
            rs = rad[lo:hi, None] + rad[None, :]
            c = dx * dx + dy * dy - rs * rs
            disc = b * b - a * c
            on = ok & (c > 0.0) & (disc > 0.0) & (a > 1e-8)
            tau = ((-b - torch.sqrt(torch.where(on, disc, 1.0)))
                   / torch.where(on, a, 1.0))
            course += int(on.sum())
            active += int((on & (tau > 0.0) & (tau < p.tau_max)).sum())
    if sym:
        pairs, course, active = pairs // 2, course // 2, active // 2
    if law == "powerlaw":
        ops = (pairs * (PL_GATE_OPS + (2 if sym else 0))
               + course * PL_TAU_OPS + active * PL_FORCE_OPS)
        mufu = course * PL_TAU_MUFU + active * PL_FORCE_MUFU
    else:
        ops, mufu = pairs * HB_OPS, pairs * HB_MUFU
    n_bytes = n * (4 * (5 if law == "powerlaw" else 6) + 1 + 8) + 4 * 6
    if grid is not None:
        n_bytes += 4 * grid.boxes.numel() + (
            4 * (grid.surv.numel() + grid.counts.numel())
            if grid.surv is not None else 0)
    return (*bound(n_bytes, ops, mufu), (pairs, course, active))


def powerlaw_oracle(pos, vel, rad, alive, p):
    """Loop-based float64 oracle of the time-to-collision power law (a copy
    of tests/test_powerlaw.py's, which imports JAX)."""
    import numpy as np
    pos = np.asarray(pos, np.float64)
    vel = np.asarray(vel, np.float64)
    rad = np.asarray(rad, np.float64)
    n = pos.shape[0]
    f = np.zeros((n, 2))
    for i in range(n):
        if not alive[i]:
            continue
        for j in range(n):
            if j == i or not alive[j]:
                continue
            x = pos[i] - pos[j]
            v = vel[i] - vel[j]
            r = rad[i] + rad[j]
            a = v @ v
            b = x @ v
            c = x @ x - r * r
            disc = b * b - a * c
            if c <= 0.0 or disc <= 0.0 or a <= 1e-8:
                continue
            s = np.sqrt(disc)
            tau = (-b - s) / a
            if tau <= 0.0 or tau >= p.tau_max:
                continue
            t = min(max(tau, p.tau_min), p.tau_max)
            mag = p.k * np.exp(-t / p.tau0) * (2.0 / t + 1.0 / p.tau0) / t**2
            f[i] += mag * (a * x - (s + b) * v) / (a * s)
    return f


#: the family kernels: law, form, and the N of the main path that runs it
#: (phase 16)
FAMILY_FORMS = {
    "powerlaw_sym": ("powerlaw", "sym", N),
    "powerlaw_dense": ("powerlaw", "dense", N),
    "helbing_dense": ("helbing", "dense", N),
    "powerlaw_sym_cutoff": ("powerlaw", "sym_cutoff", N),
    "powerlaw_dense_cutoff": ("powerlaw", "dense_cutoff", N),
    "helbing_dense_cutoff": ("helbing", "dense_cutoff", N),
    "powerlaw_sym_compact": ("powerlaw", "sym_compact", CUT_N),
    "powerlaw_compact": ("powerlaw", "compact", CUT_N),
    "helbing_compact": ("helbing", "compact", CUT_N)}


def family_kernel_checks(dev, card):
    """Phase 15: every power-law form and every Helbing form against its
    plain version on seeded crowds with random headings (dead agents, a
    coincident pair, a zero desired direction): the all-pairs forms at
    N = 10,000, the cutoff forms on Hilbert-sorted crowds at 10,000 and
    50,000 with the static grids, a table that fits and a one-slot table
    (every row with two or more hits overflows); each compacted kernel
    equal to its dense cutoff kernel bitwise; the float64 oracles on a
    small crowd.  The crowds, the launches, the plain versions and the
    tolerance are those of tests/test_torch_cuda.py, from
    tests/family_cases.py.  Returns ``(worst, results)``: each kernel's
    largest error, and its device time, plain time and bound at its main
    path's N."""
    import numpy as np
    import torch
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import oracle
    from family_cases import (TOLERANCE, family_params, family_plain,
                              family_planes, family_reference, family_run)
    worst = dict.fromkeys(FAMILY_FORMS, 0.0)
    results = {}

    def check(label, law, got, want, lim, dead, name):
        err = (got - want).abs()
        say(f"phase 15 {label}: max abs err {err.max().item():.3e}, max "
            f"err/limit {(err / lim).max().item():.3e}, max |f| "
            f"{want.abs().max().item():.3e}, tolerance {TOLERANCE[law]}")
        if not torch.isfinite(got).all():
            fail(f"{label}: non-finite forces")
        if bool((err > lim).any()):
            fail(f"{label}: disagrees with the plain version")
        if bool((got[:, dead] != 0).any()):
            fail(f"{label}: dead rows are not exactly zero")
        worst[name] = max(worst[name], err.max().item())

    def timed(name, planes, grid, cutoff):
        law, form, _ = FAMILY_FORMS[name]
        kernel = ("pair_force_sym_kernel" if form.startswith("sym")
                  else "pair_force_dense_kernel")
        ms = device_ms(lambda: family_run(law, planes, form, grid), kernel,
                       reps=10)
        plain = cuda_ms(lambda: family_plain(law, planes, cutoff), reps=2)
        bnd = family_work(law, planes, cutoff, form.startswith("sym"), grid)
        pairs, course, active = bnd[2]
        walk = {"sym": "kTriangle", "sym_cutoff": "kTriangleBox",
                "sym_compact": "kSymTable"}.get(
                    form if grid is None else grid.form)
        floor = ("" if law != "powerlaw" or walk is None else "; " +
                 floor_note(f"pair_force_sym<{walk}, PowerLaw>", pairs))
        dense = {"helbing": "Helbing", "powerlaw": "PowerLaw"}.get(law)
        if dense is not None and form == "dense":
            floor = "; " + floor_note(f"pair_force_dense<kAllTiles, {dense}>",
                                      pairs)
        say(f"phase 15 time {name} at N={planes[0].shape[0]}"
            + ("" if cutoff is None else f", {cutoff:g} m cutoff")
            + f": {ms:.4f} ms on the device, plain {plain:.4f} ms, bound "
            f"{bnd[0]:.6f} ms ({bnd[1]}; {pairs} pairs"
            + (f", {course} on a collision course, {active} contributing"
               if law == "powerlaw" else "") + f"){floor} ({card})")
        results[name] = dict(ms=ms, plain_ms=plain, bound=bnd[:2])

    # the all-pairs forms at N = 10k
    planes = family_planes(N, 31, dev)
    dead = ~planes[5]
    for law, forms in (("powerlaw", ("sym", "dense")), ("helbing", ("dense",))):
        want, limit = family_reference(law, planes)
        for form in forms:
            got = family_run(law, planes, form)
            torch.cuda.synchronize()
            check(f"{law}_{form} N={N}", law, got, want, limit, dead,
                  f"{law}_{form}")
    for name in ("powerlaw_sym", "powerlaw_dense", "helbing_dense"):
        timed(name, planes, None, None)

    # the float64 oracles on a small crowd
    pos, vel, radius, alive = seeded_crowd(ORACLE_N, 3, 12.0)
    small = to_planes(pos, vel, radius, alive, dev)
    e = np.random.default_rng(4).normal(size=(ORACLE_N, 2))
    e = (e / np.linalg.norm(e, axis=1, keepdims=True)).astype(np.float32)
    small += [torch.from_numpy(np.ascontiguousarray(e[:, k])).to(dev)
              for k in (0, 1)]
    pl, hb = family_params("powerlaw"), family_params("helbing")
    f64 = np.float64
    refs = {"powerlaw": (powerlaw_oracle(pos, vel, radius, alive, pl),
                         family_plain("powerlaw", small, magnitudes=True)),
            "helbing": (oracle.ped_repulsive_force(
                pos.astype(f64), vel.astype(f64), e.astype(f64), alive,
                hb.v0, hb.sigma, hb.fov_phi, hb.fov_factor, hb.step_width,
                hb.b_min), None)}
    # the JAX package's bounds against these oracles (tests/test_powerlaw.py
    # :66, tests/test_helbing_forces.py:29): the power law's tau^-3 near
    # contact amplifies f32 rounding to about 1e-3 relative
    tol = {"powerlaw": (5e-5, 1e-3), "helbing": (2e-4, 2e-3)}
    for law, form in (("powerlaw", "sym"), ("powerlaw", "dense"),
                      ("helbing", "dense")):
        want, mag = refs[law]
        got = family_run(law, small, form).T.cpu().numpy()
        atol, rtol = tol[law]
        scale = (np.abs(want) if mag is None
                 else np.maximum(np.abs(want), mag.T.cpu().numpy()))
        err = np.abs(got - want)
        say(f"phase 15 {law}_{form} vs float64 oracle, N={ORACLE_N}: max abs "
            f"err {err.max():.3e}, max |f| {np.abs(want).max():.3e} "
            f"(tolerance {atol:g} + {rtol:g}*"
            + ("|f|" if mag is None else "max(|f|, sum_j |f_ij|)") + ")")
        if np.any(err > atol + rtol * scale):
            fail(f"{law}_{form} disagrees with the float64 oracle")

    # the cutoff forms on Hilbert-sorted crowds at 10k and 50k
    for n in CUT_CHECK_N:
        planes = family_planes(n, 33, dev, sort=True)
        dead = ~planes[5]
        grids = cutoff_grids(planes)
        for law in ("powerlaw", "helbing"):
            want, limit = family_reference(law, planes, CUTOFF_M)
            keys = ["dense_cutoff", "compact", "compact overflow"]
            if law == "powerlaw":
                keys += ["sym_cutoff", "sym_compact", "sym_compact overflow"]
            outs = {}
            for key in keys:
                g = grids[key]
                outs[key] = family_run(law, planes, g.form, g)
                torch.cuda.synchronize()
                check(f"{law}_{g.form} (max_surv {g.max_surv}) N={n}", law,
                      outs[key], want, limit, dead, f"{law}_{g.form}")
            for key in ("compact", "compact overflow"):
                if not torch.equal(outs[key], outs["dense_cutoff"]):
                    fail(f"N={n}: {law} {key} differs from dense_cutoff "
                         f"bitwise")
            say(f"phase 15 N={n} {law}: compact == dense_cutoff bitwise, "
                f"with a fitting table and with max_surv=1 (overflow)")
        # times of the forms the main paths run at this N (auto grids)
        for name, (law, form, n_main) in FAMILY_FORMS.items():
            if n_main != n or form in ("sym", "dense"):
                continue
            from carla_social_force_model_tpu_torch.ops import pair_grid
            g = pair_grid.cutoff_grid(planes[0], planes[1], planes[5],
                                      CUTOFF_M,
                                      symmetric=form.startswith("sym"))
            if g.form != form:
                fail(f"N={n}: the auto grid for {name} came out {g.form}")
            timed(name, planes, g, CUTOFF_M)
    return worst, results


def family_paths(dev, zero, drive, profile_steps, step_ms, launches):
    """Phases 16 and 17: the family main paths through ``drive`` (main's
    warm-up, best of 2 and exact launch counts; ``launches`` takes each
    family kernel's count per run, ``step_ms`` each path's step), profiled
    where they run STEPS; then each headline family path step by step
    through the kernels against the plain versions."""
    import dataclasses
    import torch
    from carla_social_force_model_tpu_torch.api.synthetic import (
        benchmark_bundle)
    from carla_social_force_model_tpu_torch.models import stepper
    from carla_social_force_model_tpu_torch.ops import cuda_env, cuda_forces

    lap("phase 16")
    # -- phase 16: main paths, the model families ---------------------------
    # the four bench.py family switches and the power law with the 30 m
    # cutoff (profiled); then the paths that launch the other forms (the
    # dense kernels, the cutoff forms of Helbing and the survivor tables at
    # 50k); all FAMILY_FORM_STEPS
    cut = dict(interaction_cutoff=CUTOFF_M)
    dense = dict(symmetric_pairs=False)
    fam_paths = [
        ("powerlaw", "powerlaw", {}, N, True, ("powerlaw_sym",)),
        ("helbing", "helbing", {}, N, True, ("helbing_dense",)),
        ("mix-moussaid-powerlaw-helbing", "mix-moussaid-powerlaw-helbing",
         {}, N, True, ("pair_force_sym", "powerlaw_sym", "helbing_dense")),
        ("groups-0.5:4", "groups-0.5:4", {}, N, True, ("pair_force_sym",)),
        (f"powerlaw + {CUTOFF_M:g} m cutoff", "powerlaw", cut, N, True,
         ("powerlaw_sym_cutoff",)),
        ("powerlaw, dense kernel", "powerlaw", dense, N, False,
         ("powerlaw_dense",)),
        (f"powerlaw + {CUTOFF_M:g} m cutoff, dense kernel", "powerlaw",
         dict(cut, **dense), N, False, ("powerlaw_dense_cutoff",)),
        (f"helbing + {CUTOFF_M:g} m cutoff", "helbing", cut, N, False,
         ("helbing_dense_cutoff",)),
        (f"powerlaw + {CUTOFF_M:g} m cutoff", "powerlaw", cut, CUT_N, False,
         ("powerlaw_sym_compact",)),
        (f"powerlaw + {CUTOFF_M:g} m cutoff, dense kernel", "powerlaw",
         dict(cut, **dense), CUT_N, False, ("powerlaw_compact",)),
        (f"helbing + {CUTOFF_M:g} m cutoff", "helbing", cut, CUT_N, False,
         ("helbing_compact",))]
    steps = FAMILY_FORM_STEPS
    for label, switch, kw, n_f, profiled, names in fam_paths:
        scene, params, cfg, state = benchmark_bundle(n_f, device=dev)
        scene, params = family_scene(scene, params, switch)
        cfg = dataclasses.replace(cfg, **kw)
        label = f"phase 16 {label}, N={n_f}"
        counts, step_ms[label] = drive(
            label, scene, params, cfg, state, steps,
            dict(zero, **dict.fromkeys(names, steps)))
        for name in names:
            launches.setdefault(name, counts[name])
        if profiled:
            profile_steps(scene, params, cfg, state, step_ms[label], label)

    lap("phase 17")
    # -- phase 17: the family paths step by step, kernels vs plain -----------
    # the four switches and the power law with the cutoff, its table forced
    # by an explicit width (the compacted kernel in the rollout)
    for switch, kw, names in (
            ("powerlaw", {}, ("powerlaw_sym",)),
            ("helbing", {}, ("helbing_dense",)),
            ("mix-moussaid-powerlaw-helbing", {},
             ("pair_force_sym", "powerlaw_sym", "helbing_dense")),
            ("groups-0.5:4", {}, ("pair_force_sym",)),
            ("powerlaw", dict(cut, pair_max_surv=FORCED_MAX_SURV),
             ("powerlaw_sym_compact",))):
        scene, params, cfg, state = benchmark_bundle(N, device=dev)
        scene, params = family_scene(scene, params, switch)
        cfg = dataclasses.replace(cfg, **kw)
        label = f"phase 17 {switch}" + (
            f" + {CUTOFF_M:g} m cutoff (max_surv {FORCED_MAX_SURV})"
            if kw else "")
        _, rec_plain = stepper.make_rollout_fn(scene, params, plain_cfg(cfg),
                                               PARITY_STEPS)(state)
        torch.cuda.synchronize()
        reset_counts()
        check_rollout(label, scene, params, cfg, state, rec_plain,
                      free_limit=False)
        expect_counts(label, zero, **dict.fromkeys(names, PARITY_STEPS))


def feed_work(kind, planes, src, k, neigh_dist):
    """``(bound_ms, bound_by, pairs, kept, points)`` of one wall-feed launch
    on these planes: each input read once and each output written once; for
    every (feature, alive pedestrian) pair within the feature's circle
    inflated by the neighbour distance (what a spatial index would still
    have to look at), the projection on a segment or the scan of a chunk's
    real points, and for every candidate within the neighbour distance its
    insertion into the running list (``topk`` kinds).  ``points``: the
    chunk points those pairs scan (the census unit of the chunk top-k)."""
    import torch
    from carla_social_force_model_tpu_torch.env.pointsets import PAD_COORD
    from carla_social_force_model_tpu_torch.ops.geometry import (
        chunk_closest_plain, feature_closest_planes, squared_reach)
    x, y, alive = planes[0], planes[1], planes[5]
    n = x.shape[0]
    seg = kind == "seg_topk"
    if seg:
        cx, cy, rad = src.ccx, src.ccy, src.rad
        per = torch.full_like(cx, SEG_OPS)
        feat_bytes = 8 * 4 * cx.shape[0]
    else:
        cx, cy, rad = src.center_x, src.center_y, src.radius
        real = (src.x != PAD_COORD).sum(dim=1)
        per = SCAN_OPS * real.float()
        feat_bytes = 8 * src.x.numel() + 3 * 4 * cx.shape[0]
    nd2 = squared_reach(neigh_dist)
    pairs = kept = points = 0
    ops = 0.0
    for lo in range(0, n, 2048):
        px, py = x[lo:lo + 2048], y[lo:lo + 2048]
        dx = cx[:, None] - px[None, :]
        dy = cy[:, None] - py[None, :]
        reach = (rad.clamp(min=0.0) + neigh_dist)[:, None]
        ok = ((dx * dx + dy * dy <= reach * reach) & (rad >= 0)[:, None]
              & alive[None, lo:lo + 2048])
        pairs += int(ok.sum())
        ops += float((ok.float() * per[:, None]).sum())
        if not seg:
            points += int((ok.float() * real[:, None].float()).sum())
        if kind != "chunk_closest":
            closest = feature_closest_planes if seg else chunk_closest_plain
            d2 = closest(px, py, src, neigh_dist)[0]
            kept += int((ok & (d2 <= nd2)).sum())
    ops += kept * TOPK_OPS
    out = 3 * 4 * n * (k if kind != "chunk_closest" else cx.shape[0])
    n_bytes = 9 * n + feat_bytes + out
    return (*bound(n_bytes, ops, 0), pairs, kept, points)


def orca_kernel_checks(dev, card, urban):
    """Phase 18: the ORCA slice's kernels against their plain versions at
    the shapes of its paths.  On config #3 at N = 10,000 (Hilbert-sorted,
    10% dead, 10% on the road): the analytic border kernel (both radius
    modes), the segment top-k over the border features and the chunk
    top-k and chunk scan over the 169 parked cars (k = 3, ORCA's
    max_statics, and k = 8; the boxes of the alive rows and of every row),
    bitwise; on the urban crowd, the compacted analytic kernel with the
    path's table, a fitting one and one slot, bitwise equal to the dense
    kernel.  Each kernel's device time, its plain version's and its bound
    from this data.  ``urban``: the urban path's bundle.  Returns
    ``(worst, results)``."""
    import torch
    from orca_cases import (ENV_ATOL, ENV_RTOL, NEIGHBOR_DIST, analytic_run,
                            feed_call, feed_mismatch, feed_run, feed_scene)
    from carla_social_force_model_tpu_torch.env.pointsets import PAD_COORD
    from carla_social_force_model_tpu_torch.models import stepper
    from carla_social_force_model_tpu_torch.models.spawn import apply_spawn
    from carla_social_force_model_tpu_torch.ops import cuda_env, env_grid
    from carla_social_force_model_tpu_torch.ops.spatial import morton_order
    worst, results = {}, {}
    scene, params, planes = feed_scene(N, dev)
    geom, b = scene.borders_geom, params.border
    seg, cars = scene.borders_feat.seg, scene.obstacles_feat.rest
    m_real = int((geom.ax != PAD_COORD).sum())
    say(f"phase 18 config #3 sets, N={N}: borders {scene.borders.num_segments}"
        f" sections -> analytic {geom.num_segments} sections x M="
        f"{geom.max_segments} slots ({m_real} real segments), sampled "
        f"remainder "
        + ("none" if scene.borders_seg_rest is None else
           f"{scene.borders_seg_rest.num_segments} sections")
        + f"; ORCA feed: borders {seg.num_features} segment features, "
        + ("no" if scene.borders_feat.rest is None else
           str(scene.borders_feat.rest.num_chunks))
        + " chunks; parked cars "
        + ("no" if scene.obstacles_feat.seg is None else
           str(scene.obstacles_feat.seg.num_features))
        + f" segment features, {cars.num_chunks} chunks of "
        f"{cars.chunk_size} points")

    def env_check(label, name, got, want, alive):
        err = (got - want).abs()
        say(f"phase 18 {label}: max abs err {err.max().item():.3e}, max |f| "
            f"{want.abs().max().item():.3e}, tolerance {ENV_ATOL:g} + "
            f"{ENV_RTOL:g}*|f|")
        if not torch.isfinite(got).all():
            fail(f"{label}: non-finite forces")
        if bool((err > ENV_ATOL + ENV_RTOL * want.abs()).any()):
            fail(f"{label}: disagrees with the plain version")
        if bool((got[:, ~alive] != 0).any()):
            fail(f"{label}: dead agents' forces are not exactly zero")
        worst[name] = max(worst.get(name, 0.0), err.max().item())

    for use_radius in (False, True):
        want = analytic_run(planes, geom, b.a, b.b, use_radius, plain=True)
        got = analytic_run(planes, geom, b.a, b.b, use_radius)
        torch.cuda.synchronize()
        env_check(f"env_exp_analytic config #3 borders use_radius="
                  f"{use_radius}, N={N}", "env_exp_analytic", got, want,
                  planes[5])

    nd = NEIGHBOR_DIST
    feeds = {"seg_topk": seg, "chunk_topk": cars, "chunk_closest": cars}
    for kind, src in feeds.items():
        worst[kind] = 0.0
        for k in ((3, 8) if kind != "chunk_closest" else (0,)):
            want = feed_run(kind, planes, src, k, plain=True)
            for use_alive in (True, False):
                got = feed_run(kind, planes, src, k, use_alive=use_alive)
                torch.cuda.synchronize()
                rows = planes[5] if use_alive else torch.ones_like(planes[5])
                bad = feed_mismatch(kind, got, want, rows)
                fin = torch.isfinite(want[0][..., rows])
                err = (got[0][..., rows] - want[0][..., rows])[fin].abs()
                e = err.max().item() if err.numel() else 0.0
                say(f"phase 18 {kind} k={k or '-'} N={N} rows "
                    f"{'alive' if use_alive else 'all'}: {bad} elements "
                    f"differ from the plain version (d2, points, "
                    f"selection; bitwise), {int(fin.sum())} finite "
                    f"entries, max abs d2 err {e:.3e}")
                if bad:
                    fail(f"{kind} (k={k}) differs from its plain version")
                worst[kind] = max(worst[kind], e)

    # the compacted analytic kernel at the urban path's shapes, with the
    # path's table (ORCA_URBAN_MAX_SURV), a fitting one and one slot
    uscene, uparams, _, ustate = urban
    uscene = stepper.prepare_scene(uscene, analytic=True)
    ust = apply_spawn(ustate, uscene.spawn, 0)
    perm, _ = morton_order(ust.pos_x, ust.pos_y, ust.alive, "hilbert")
    uplanes = [a[perm].contiguous() for a in (
        ust.pos_x, ust.pos_y, ust.vel_x, ust.vel_y, ust.radius, ust.alive)]
    ugeom = uscene.borders_geom
    engage, group, ms = env_grid.env_gate(
        ugeom.num_segments, ugeom.max_segments, True, ORCA_URBAN_MAX_SURV)
    if not engage:
        fail("phase 18: the urban analytic borders do not engage the table")
    r2 = cuda_env.filter_r2(ugeom)
    x, y, alive = uplanes[0], uplanes[1], uplanes[5]
    hits = env_grid.group_hits(env_grid.block_boxes(x, y, alive),
                               ugeom.center_x, ugeom.center_y, r2, group)
    grids = {f"path ({ms})": env_grid.env_grid(x, y, alive, ugeom, r2, group,
                                               ms),
             "fitting": env_grid.env_grid(x, y, alive, ugeom, r2, group,
                                          max(int(hits.sum(dim=1).max()), 1)),
             "max_surv=1": env_grid.env_grid(x, y, alive, ugeom, r2, group,
                                             1)}
    say(f"phase 18 urban analytic borders: {ugeom.num_segments} sections x "
        f"M={ugeom.max_segments}, groups of {group}, groups per block mean "
        f"{hits.sum(dim=1).float().mean().item():.2f}, max "
        f"{int(hits.sum(dim=1).max())}")
    ub = uparams.border
    for use_radius in (False, True):
        want = analytic_run(uplanes, ugeom, ub.a, ub.b, use_radius,
                            plain=True)
        dense = analytic_run(uplanes, ugeom, ub.a, ub.b, use_radius)
        for label, g in grids.items():
            got = analytic_run(uplanes, ugeom, ub.a, ub.b, use_radius, grid=g)
            torch.cuda.synchronize()
            env_check(f"env_exp_analytic_compact urban table {label} "
                      f"use_radius={use_radius}, N={N}",
                      "env_exp_analytic_compact", got, want, alive)
            if not torch.equal(got, dense):
                fail(f"env_exp_analytic_compact ({label}) differs from the "
                     f"dense kernel bitwise")
    say("phase 18 env_exp_analytic_compact: equal to the dense kernel "
        "bitwise with every table, both radius modes")

    # times and bounds at the paths' shapes
    def analytic_bound(pl, g, table):
        xx, yy, al = pl[0], pl[1], pl[5]
        from carla_social_force_model_tpu_torch.ops.geometry import (
            segment_filter_mask)
        real = (g.ax != PAD_COORD).sum(dim=1)
        ok = segment_filter_mask(xx, yy, g) & al[None, :] & (real > 0)[:, None]
        per = ok.sum(dim=1)
        ops = int((per * (SEG_OPS * real + EXP_TERM_OPS)).sum())
        mufu = int(per.sum()) * EXP_TERM_MUFU
        n_bytes = (xx.shape[0] * (4 * 3 + 1 + 8) + 5 * 4 * g.ax.numel()
                   + 3 * 4 * g.num_segments)
        if table is not None:
            n_bytes += 4 * (table.surv.numel() + table.counts.numel())
        return (*bound(n_bytes, ops, mufu), int(per.sum()))

    timed = (("env_exp_analytic", planes, geom, b, None, "config #3 borders"),
             ("env_exp_analytic_compact", uplanes, ugeom, ub,
              grids[f"path ({ms})"], "urban borders"))
    for name, pl, g, prm, table, what in timed:
        ms_k = device_ms(lambda: analytic_run(pl, g, prm.a, prm.b,
                                              grid=table),
                         "env_force_kernel")
        plain = cuda_ms(lambda: analytic_run(pl, g, prm.a, prm.b, plain=True),
                        reps=3)
        bnd = analytic_bound(pl, g, table)
        census = ("env_force<exp, kAllSections, kAnalytic>" if table is None
                  else "env_force<exp, kTable, kAnalytic>")
        say(f"phase 18 time {name} ({what}, {g.num_segments} x "
            f"{g.max_segments}), N={N}: kernel {ms_k:.4f} ms on the device, "
            f"plain {plain:.4f} ms, bound {bnd[0]:.6f} ms ({bnd[1]}; "
            f"{bnd[2]} in-filter pairs); "
            f"{floor_note(census, scanned(g, pl[0], pl[1], pl[5]))} "
            f"({card})")
        results[name] = dict(ms=ms_k, plain_ms=plain, bound=bnd[:2])
    for kind, src in feeds.items():
        k = 3
        ms_k = device_ms(lambda: feed_call(kind, planes, src, k),
                         f"{kind}_kernel")
        timed_by = TIMED_BY[0]
        # device_ms's fallback beside it: the calls in a CUDA graph
        replay = graph_ms(lambda: feed_call(kind, planes, src, k))
        plain = cuda_ms(lambda: feed_call(kind, planes, src, k, plain=True),
                        reps=3)
        bnd = feed_work(kind, planes, src, k, nd)
        floor = "; " + floor_note(kind, bnd[2] if kind == "seg_topk"
                                  else bnd[4])
        say(f"phase 18 time {kind}"
            + ("" if kind == "chunk_closest" else f" (k={k})")
            + f", N={N}: kernel {ms_k:.4f} ms on "
            f"the device ({timed_by}; a CUDA graph of the calls "
            + ("could not be captured" if replay is None
               else f"{replay:.4f} ms a call") + f"), plain {plain:.4f} ms, "
            f"bound {bnd[0]:.6f} ms "
            f"({bnd[1]}; {bnd[2]} in-filter pairs, {bnd[3]} within "
            f"{nd:g} m){floor} ({card})")
        results[kind] = dict(ms=ms_k, plain_ms=plain, bound=bnd[:2])
    return worst, results


def orca_scene(path, n, steps, dev, urban):
    """bench.py's ORCA switches (bench.py:111-156, :186-187) applied by
    hand: ``headline`` BENCH_MODE=obstacles BENCH_LAW=orca
    BENCH_ENV_ANALYTIC=1 (config #3); ``pure`` BENCH_LAW=orca (config #1);
    ``urban`` BENCH_MODE=urban BENCH_LAW=orca BENCH_ENV_ANALYTIC=1 with an
    explicit ``env_max_surv`` (the compacted analytic kernel engages);
    ``mixed`` BENCH_MIX=moussaid,powerlaw,orca (config #1); ``borders``
    BENCH_MODE=borders BENCH_LAW=orca BENCH_ENV_ANALYTIC=1 (config #2).
    ``urban``: the urban path's bundle, built once.  Returns ``(scene,
    params, cfg, state, expect)``: ``expect`` the launches of a run of
    ``steps``."""
    import dataclasses
    import numpy as np
    import torch
    from carla_social_force_model_tpu_torch.api.synthetic import (
        benchmark_bundle)
    from carla_social_force_model_tpu_torch.models.spawn import LAW_IDS
    if path == "urban":
        scene, params, cfg, state = urban
    else:
        scene, params, cfg, state = benchmark_bundle(
            n, with_borders=path in ("headline", "borders"),
            with_obstacles=path == "headline", num_steps_hint=steps,
            device=dev)
    if path == "mixed":
        law = np.full(n, -1, np.int32)
        for fam, chunk in zip(("moussaid", "powerlaw", "orca"),
                              np.array_split(np.arange(n), 3)):
            law[chunk] = LAW_IDS[fam]
        scene = dataclasses.replace(scene, spawn=dataclasses.replace(
            scene.spawn, law_id=torch.from_numpy(law).to(dev)))
        params = dataclasses.replace(params, enable_powerlaw=True,
                                     enable_orca=True)
        return (scene, params, cfg, state,
                dict(pair_force_sym=steps, powerlaw_sym=steps))
    params = dataclasses.replace(params, enable_pedestrian=False,
                                 enable_orca=True)
    expect = {
        "headline": dict(env_exp_analytic=steps, env_moussaid=2 * steps,
                         seg_topk=steps, chunk_topk=steps),
        "pure": {},
        "urban": dict(env_exp_analytic_compact=steps, env_moussaid=steps,
                      seg_topk=steps),
        "borders": dict(env_exp_analytic=steps, seg_topk=steps)}[path]
    if path != "pure":
        cfg = dataclasses.replace(cfg, env_analytic=True)
    if path == "urban":
        cfg = dataclasses.replace(cfg, env_max_surv=ORCA_URBAN_MAX_SURV)
    return scene, params, cfg, state, expect


def orca_paths(dev, zero, drive, profile_steps, step_ms, launches, card,
               urban):
    """Phases 19 and 20: the ORCA main paths through ``drive`` (main's
    warm-up, best of 2 and exact launch counts), the headline one profiled,
    the urban one recorded (walkers through CHECKING_TRAFFIC and
    CROSSING_ROAD); then the headline and urban paths step by step through
    the kernels against the plain versions, the chunk scan (``chunk_closest``,
    the entry ``geometry.closest_point_per_chunk``) held against its plain
    version on the parked cars at every step of the headline path."""
    import torch
    from carla_social_force_model_tpu_torch.models import modes, stepper
    from carla_social_force_model_tpu_torch.ops import geometry, statics
    from carla_social_force_model_tpu_torch.ops.spatial import morton_order

    lap("phase 19")
    # -- phase 19: main paths, ORCA ------------------------------------------
    paths = (("headline", N, MAIN_STEPS), ("pure", N, ORCA_FORM_STEPS),
             ("urban", N, ORCA_FORM_STEPS), ("mixed", N, ORCA_FORM_STEPS),
             ("borders", ORCA_BIG_N, ORCA_FORM_STEPS))
    labels = {"headline": "config #3 + ORCA + env_analytic",
              "pure": "config #1 + ORCA",
              "urban": "urban + ORCA + env_analytic "
                       f"(env_max_surv {ORCA_URBAN_MAX_SURV})",
              "mixed": "config #1, mixed moussaid/powerlaw/orca",
              "borders": "config #2 + ORCA + env_analytic"}
    for path, n, steps in paths:
        scene, params, cfg, state, expect = orca_scene(path, n, steps, dev,
                                                       urban)
        label = f"phase 19 {labels[path]}, N={n}"
        counts, step_ms[label] = drive(label, scene, params, cfg, state,
                                       steps, dict(zero, **expect),
                                       all_alive=path != "urban")
        for name in expect:
            launches.setdefault(name, counts[name])
        if path == "headline":
            profile_steps(scene, params, cfg, state, step_ms[label], label)
        if path == "urban":
            final, (rec, _) = stepper.make_rollout_fn(scene, params, cfg,
                                                      steps)(state)
            torch.cuda.synchronize()
            alive, mode = rec.alive, rec.mode
            checking = (((mode == modes.CHECKING_TRAFFIC) & alive).any(dim=0)
                        | ((mode[:-1] == modes.WALKING_SIDEWALK)
                           & (mode[1:] == modes.CROSSING_ROAD)
                           & alive[1:]).any(dim=0))
            crossing = ((mode == modes.CROSSING_ROAD) & alive).any(dim=0)
            say(f"{label} record, {steps} steps: pedestrians that reached "
                f"CHECKING_TRAFFIC {int(checking.sum())}, CROSSING_ROAD "
                f"{int(crossing.sum())} (their wall constraints off while "
                f"on the road); alive at the end {int(final.alive.sum())} "
                f"({card})")
            if int(crossing.sum()) == 0:
                fail(f"{label}: no pedestrian crossed the road")

    lap("phase 20")
    # -- phase 20: the ORCA paths step by step, kernels vs plain -------------
    for path in ("headline", "urban"):
        scene, params, cfg, state, expect = orca_scene(path, N, PARITY_STEPS,
                                                       dev, urban)
        label = f"phase 20 {labels[path]}"
        out = stepper.make_rollout_fn(scene, params, plain_cfg(cfg),
                                      PARITY_STEPS)(state)
        rec_plain = out[1][0] if path == "urban" else out[1]
        torch.cuda.synchronize()
        reset_counts()
        check_rollout(label, scene, params, cfg, state, rec_plain,
                      free_limit=False)
        expect_counts(label, zero, **expect)
    # the chunk scan through its entry, at every step of the headline path
    scene, params, cfg, state, _ = orca_scene("headline", N, PARITY_STEPS,
                                              dev, urban)
    scene = stepper.prepare_scene(scene, analytic=True, orca=True)
    cars = scene.obstacles_feat.rest
    nd = params.orca.neighbor_dist
    s, calls = state, 0
    for k in range(PARITY_STEPS):
        s, _ = stepper.simulation_step(s, scene, params, cfg, k)
        perm, _ = morton_order(s.pos_x, s.pos_y, s.alive, "hilbert")
        x, y, alive = (a[perm].contiguous() for a in (s.pos_x, s.pos_y,
                                                      s.alive))
        before = statics.LAUNCHES["chunk_closest"]
        got = torch.stack(geometry.closest_point_per_chunk(x, y, cars, nd,
                                                           alive))
        calls += statics.LAUNCHES["chunk_closest"] - before
        want = torch.stack(geometry.chunk_closest_plain(x, y, cars, nd))
        fin = torch.isfinite(want[0][:, alive])
        bad = int(((got[0] != want[0])[:, alive]).sum()
                  + ((got[1:] != want[1:])[:, :, alive] & fin).sum())
        if bad:
            fail(f"phase 20 closest_point_per_chunk step {k}: {bad} "
                 f"elements differ from the plain version")
    launches["chunk_closest"] = calls
    say(f"phase 20 closest_point_per_chunk (the chunk_closest kernel) on the "
        f"parked cars at each of the {PARITY_STEPS} steps of the headline "
        f"path: {calls} launches, equal to the plain version bitwise on the "
        f"alive rows")


def read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def town_crowd(dev):
    """The Town02 crowd (phases 21 and 23): configs/scenarios/
    routed_town.toml with the full Town02 sidewalk capture (38 sections,
    15,966 points) and ``walker.random_pedestrians = TOWN_N`` (random
    nav-graph origins, A* routes), built through
    ``api.simulation.Simulation.from_config`` (``build_scenario``) for
    TOWN_STEPS steps on the scenarios' default engine.  Returns ``(sim,
    set-up seconds)``."""
    from carla_social_force_model_tpu_torch.api.simulation import Simulation
    from carla_social_force_model_tpu_torch.utils.config import load_config
    data = os.path.join(ROOT, "configs", "data")
    cfg = load_config(os.path.join(ROOT, "configs", "scenarios",
                                   "routed_town.toml"))
    cfg["map"] = {
        "nav_graph_npz": os.path.join(data, "town2_navgraph.npz"),
        "sidewalk_borders_npz": os.path.join(data, "town2_sidewalks_full.npz")}
    cfg["walker"]["random_pedestrians"] = TOWN_N
    t0 = time.perf_counter()
    sim = Simulation.from_config(cfg, os.path.join(ROOT, "configs",
                                                   "sfm.toml"),
                                 num_steps=TOWN_STEPS, device=dev)
    return sim, time.perf_counter() - t0


def scenario_kernel_checks(dev, card, town):
    """Phase 21: the chunk scan (``chunk_argmin``, the JAX package's
    ``_cp_kernel``) against its plain version on the card: at the Town02
    crowd's shapes (its 38 border sections at step 0, where agents stand
    stacked on nav-graph nodes, and at step 10), at CrossTown's walls
    (routed_town_walled) under a seeded crowd of TOWN_N, and on the seeded
    case of tests/scenario_cases.py (dead agents at the far sentinel, a
    chunk whose slots are all invalid, exact ties across the chunks of one
    segment).  dmin and idx must be equal bitwise, then the (S, N)
    ``dist, bx, by, has_point`` of ``geometry.closest_point_per_segment``.
    The kernel's device time at the Town02 crowd's shape (every launch
    recorded), its plain version's and its bound.  Returns ``(worst,
    result)``."""
    import numpy as np
    import torch
    from scenario_cases import (chunk_scan_pair, closest_mismatches,
                                closest_pair, scan_mismatches,
                                seeded_chunk_set, seeded_crowd_planes,
                                to_device)
    from carla_social_force_model_tpu_torch.api.scenario import (
        build_scenario)
    from carla_social_force_model_tpu_torch.env.pointsets import chunked_on
    from carla_social_force_model_tpu_torch.models import stepper
    from carla_social_force_model_tpu_torch.models.spawn import apply_spawn
    from carla_social_force_model_tpu_torch.ops import geometry, statics
    sim, _ = town
    b = sim.bundle
    scene = stepper.prepare_scene(b.scene, chunked=True)
    borders = scene.borders_chunked
    start = apply_spawn(b.initial_state, b.scene.spawn, 0)
    later, _ = stepper.make_rollout_fn(scene, b.params, b.cfg, 10,
                                       record=False)(b.initial_state)
    walled = build_scenario(
        os.path.join(ROOT, "configs", "scenarios", "routed_town_walled.toml"),
        os.path.join(ROOT, "configs", "sfm.toml"), 20, device=dev)
    walls = walled.scene.borders
    pts = walls.points[walls.valid]
    rng = np.random.default_rng(21)
    xy = rng.uniform(pts.min(0) - 5.0, pts.max(0) + 5.0,
                     (TOWN_N, 2)).astype(np.float32)
    cx, cy, _ = to_device(xy[:, 0].copy(), xy[:, 1].copy(),
                          np.ones(TOWN_N, bool), dev)
    sx, sy, _ = to_device(*seeded_crowd_planes(TOWN_N, seed=22), dev)
    cases = (
        ("Town02 crowd, step 0", start.pos_x, start.pos_y, borders),
        ("Town02 crowd, step 10", later.pos_x, later.pos_y, borders),
        ("CrossTown walls, seeded crowd", cx, cy, chunked_on(walls, dev)),
        ("seeded case (dead agents, an all-invalid chunk, ties across "
         "chunks)", sx, sy, chunked_on(seeded_chunk_set(21), dev)))
    worst = 0.0
    for label, px, py, pset in cases:
        got, want = chunk_scan_pair(px, py, pset)
        cgot, cwant = closest_pair(px, py, pset)
        torch.cuda.synchronize()
        c, kk = pset.valid.shape
        bad, cbad = scan_mismatches(got, want), closest_mismatches(cgot,
                                                                   cwant)
        err = (got[0] - want[0]).abs().max().item()
        say(f"phase 21 chunk_argmin, {label}: {pset.num_segments} segments, "
            f"{c} chunks of {kk}, N={px.shape[0]}: dmin/idx elements that "
            f"differ from the plain version {bad} of {2 * c * px.shape[0]}; "
            f"closest points that differ {cbad}; has_point "
            f"{int(cgot[3].sum())} of {cgot[3].numel()} (segment, "
            f"pedestrian) pairs")
        if bad or cbad:
            fail(f"phase 21 chunk_argmin ({label}) differs from its plain "
                 f"version")
        worst = max(worst, err)
    fx, fy = (a.contiguous() for a in geometry.staged_chunk_planes(borders))
    px, py = later.pos_x, later.pos_y
    ms = device_ms(lambda: statics.chunk_argmin(px, py, fx, fy),
                   "chunk_argmin_kernel")
    plain_ms = cuda_ms(lambda: geometry.chunk_argmin_plain(px, py, fx, fy),
                       reps=3)
    c, kk = fx.shape
    n = px.shape[0]
    n_bytes = 4 * (2 * c * kk + 2 * n) + 8 * c * n
    ops = ARGMIN_OPS * c * kk * n
    bnd = bound(n_bytes, ops, 0)
    say(f"phase 21 time chunk_argmin at the Town02 crowd's shape ({c} chunks "
        f"of {kk} points, N={n}): kernel {ms:.4f} ms on the device, plain "
        f"{plain_ms:.4f} ms; bound {bnd[0]:.6f} ms ({bnd[1]}; {c * kk * n} "
        f"pairs x {ARGMIN_OPS} operations, {n_bytes} bytes); "
        f"{floor_note('chunk_argmin', c * kk * n)} ({card})")
    return {"chunk_argmin": worst}, dict(ms=ms, plain_ms=plain_ms, bound=bnd)


def scenario_paths(dev, zero, drive, profile_steps, step_ms, launches, card,
                   town):
    """Phases 22 and 23.  Phase 22: every shipped scenario on the card
    through ``Simulation.from_config(...).run()`` at its golden's horizon,
    with the chunk scan launched on every step of a scene with borders or
    obstacles, the largest deviation from the golden printed (not held:
    the goldens are the JAX package's CPU runs), and every step of the
    first PARITY_STEPS against the plain versions' step from the same
    state; one ``run_streamed`` whose CSVs equal ``run()`` +
    ``write_csv()`` byte for byte (with the dense pair kernel, whose sums
    do not change from run to run as the symmetric kernel's atomics do),
    and one CLI run with ``--csv``.  Phase 23: the Town02 crowd's main
    path (``drive``: warm-up, best of 2 over TOWN_STEPS, exact launch
    counts), its profile and PARITY_STEPS steps against the plain
    versions."""
    import shutil
    import numpy as np
    import torch
    from carla_social_force_model_tpu_torch.api import cli
    from carla_social_force_model_tpu_torch.api.simulation import Simulation
    from carla_social_force_model_tpu_torch.models import stepper

    scen_dir = os.path.join(ROOT, "configs", "scenarios")
    out_root = os.path.join(ROOT, "output", "chip_smoke")

    lap("phase 22")
    # -- phase 22: every shipped scenario on the card -------------------------
    for scen, duration, fixture, sfm in GOLDENS:
        name = fixture or scen
        sim = Simulation.from_config(
            os.path.join(scen_dir, f"{scen}.toml"),
            os.path.join(ROOT, "configs", sfm or "sfm.toml"),
            duration=duration, device=dev)
        b = sim.bundle
        if not b.cfg.env_chunked:
            fail(f"phase 22 {name}: not on the jnp environment path")
        reset_counts()
        _, recs = sim.run()
        counts = read_counts()
        env = (b.scene.borders is not None
               or b.scene.static_obstacles is not None)
        if env and counts["chunk_argmin"] < b.num_steps:
            fail(f"phase 22 {name}: chunk_argmin launched "
                 f"{counts['chunk_argmin']} times in {b.num_steps} steps")
        want = np.load(os.path.join(ROOT, "tests", "golden", f"{name}.npz"))
        alive = want["alive"]
        pos = recs.pos.cpu().numpy()
        if not np.isfinite(pos[recs.alive.cpu().numpy()]).all():
            fail(f"phase 22 {name}: non-finite positions")
        dev_m = float(np.where(alive[..., None],
                               np.abs(pos - want["pos"]), 0.0).max())
        cells = int((recs.alive.cpu().numpy() != alive).sum())
        say(f"phase 22 {name}: N={b.capacity}, {b.num_steps} steps in "
            f"{sim.elapsed:.3f} s ({1e3 * sim.elapsed / b.num_steps:.3f} "
            f"ms/step), launches {({k: v for k, v in counts.items() if v})}"
            f"; largest deviation from the golden {dev_m:.3e} m, {cells} "
            f"(step, agent) cells alive otherwise (printed, not held) "
            f"({card})")
        out = stepper.make_rollout_fn(b.scene, b.params, plain_cfg(b.cfg),
                                      PARITY_STEPS)(b.initial_state)
        rec_plain = out[1][0] if b.scene.autopilot is not None else out[1]
        check_rollout(f"phase 22 {name}", b.scene, b.params, b.cfg,
                      b.initial_state, rec_plain, free_limit=False)
    shutil.rmtree(out_root, ignore_errors=True)
    for scen, duration, chunk in (("jaywalking_reactive", 25.0, 128),
                                  ("corridor_counterflow", 15.0, 100)):
        dirs = []
        for mode in ("memory", "streamed"):
            sim = Simulation.from_config(
                os.path.join(scen_dir, f"{scen}.toml"),
                os.path.join(ROOT, "configs", "sfm.toml"), duration=duration,
                device=dev, engine={"pallas_symmetric": False})
            if mode == "memory":
                sim.run()
                dirs.append(sim.write_csv(os.path.join(out_root, mode)))
            else:
                dirs.append(sim.run_streamed(os.path.join(out_root, mode),
                                             chunk_steps=chunk))
        sizes = []
        for csv_name in ("pedestrian.csv", "vehicle.csv", "borders.csv",
                         "obstacles.csv"):
            memory, streamed = (read_bytes(os.path.join(d, csv_name))
                                for d in dirs)
            if memory != streamed:
                fail(f"phase 22 {scen}: run_streamed's {csv_name} differs "
                     f"from run() + write_csv()")
            sizes.append(len(memory))
        say(f"phase 22 {scen}: run_streamed (segments of {chunk} steps) "
            f"wrote the bytes of run() + write_csv(), all four CSVs "
            f"({sizes} bytes)")
    rc = cli.main(["--scenario-config",
                   os.path.join(scen_dir, "obstacle_evasion.toml"),
                   "--steps", "40", "--csv", "--output",
                   os.path.join(out_root, "cli")])
    (cli_dir,) = os.listdir(os.path.join(out_root, "cli"))
    with open(os.path.join(out_root, "cli", cli_dir, "pedestrian.csv")) as f:
        header, rows = f.readline().strip(), len(f.readlines())
    if rc != 0 or header != "ped_id,frame,time,x,y,v_x,v_y,mode" or not rows:
        fail(f"phase 22 CLI run: exit {rc}, header {header!r}, {rows} rows")
    say(f"phase 22 CLI run (obstacle_evasion, 40 steps, --csv, on the card): "
        f"exit 0, the reference schema, {rows} pedestrian rows")
    shutil.rmtree(out_root, ignore_errors=True)

    lap("phase 23")
    # -- phase 23: the Town02 crowd at N = TOWN_N -----------------------------
    sim, setup_s = town
    b = sim.bundle
    label = (f"phase 23 Town02 crowd (routed_town, full Town02 borders, "
             f"{TOWN_N} random pedestrians), N={b.capacity}")
    say(f"{label}: set-up {setup_s:.2f} s (build_scenario: random A* "
        f"routes, {b.scene.borders.num_segments} border sections in "
        f"{b.scene.borders.num_chunks} chunks of "
        f"{b.scene.borders.chunk_size})")
    counts, step_ms[label] = drive(
        label, b.scene, b.params, b.cfg, b.initial_state, TOWN_STEPS,
        dict(zero, pair_force_sym=TOWN_STEPS, chunk_argmin=TOWN_STEPS),
        all_alive=False)
    launches["chunk_argmin"] = counts["chunk_argmin"]
    say(f"{label}: {sum(counts.values()) / TOWN_STEPS:.0f} kernel launches "
        f"of the port per step, chunk_argmin "
        f"{counts['chunk_argmin'] / TOWN_STEPS:.0f} per step")
    profile_steps(b.scene, b.params, b.cfg, b.initial_state, step_ms[label],
                  label)
    final, recs = sim.run()
    if not (torch.isfinite(final.pos_x).all()
            and torch.isfinite(final.pos_y).all()):
        fail(f"{label}: non-finite positions after Simulation.run()")
    say(f"{label}: Simulation.run() recorded {tuple(recs.pos.shape)} in "
        f"{sim.elapsed:.3f} s, {int(final.alive.sum())} alive at the end")
    _, rec_plain = stepper.make_rollout_fn(b.scene, b.params,
                                           plain_cfg(b.cfg),
                                           PARITY_STEPS)(b.initial_state)
    check_rollout(label, b.scene, b.params, b.cfg, b.initial_state,
                  rec_plain, free_limit=False)


def shard_kernel_checks(dev, card):
    """Phase 24: the agent-sharding kernels against their plain versions at
    the shapes of phase 25 (N = 10,000 over 4 shards): the rectangular
    dense, box-skip and table forms of one shard's 2,500 rows against a
    2,500-wide block and against the 10,000 gathered columns, and bitwise
    against the square kernels on equal planes; the full-block kernel
    ``pair_force_sym_dense`` (both antisymmetric laws, with and without
    the cutoff); the in-kernel ring ``ring_force`` at D = 2, 3, 4 and 8
    over N = 10,000 (three laws, with and without the cutoff) against the
    gathered dense kernel and against the plain ring, relaunched to show
    its counters reset.  Returns ``(worst, results)``: each new kernel's
    largest error and its time, plain time and bound."""
    import torch
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import shard_cases as sc
    from carla_social_force_model_tpu_torch.ops import (cuda_forces,
                                                        cuda_ring, pair_grid)
    worst = dict.fromkeys(("pair_force_sym_dense",
                           "pair_force_sym_dense_cutoff", "ring_force"), 0.0)
    results = {}

    def held(label, got, want, lim, name=None):
        err = (got - want).abs()
        say(f"phase 24 {label}: max abs err {err.max().item():.3e}, max "
            f"|f| {want.abs().max().item():.3e}, worst err/limit "
            f"{(err / lim).max().item():.3f} (limit {sc.ATOL:g} + "
            f"{sc.RTOL:g}*S)")
        if not torch.isfinite(got).all():
            fail(f"{label}: non-finite forces")
        if bool((err > lim).any()):
            fail(f"{label} disagrees with its plain version")
        if name is not None:
            worst[name] = max(worst[name], err.max().item())

    k = N // SHARDS
    # the rectangular forms of the dense walks
    for law in sc.LAWS:
        planes = sc.shard_planes(N, 24, dev, n_shards=SHARDS, sort=True)
        for gathered in (False, True):
            n_cols = N if gathered else k
            for cutoff, ms in ((None, 0), (CUTOFF_M, 0), (CUTOFF_M, 4)):
                got, want, lim = sc.rect_case(law, planes, SHARDS, 1, cutoff,
                                              gathered, max_surv=ms)
                torch.cuda.synchronize()
                form = ("dense" if cutoff is None
                        else "compact" if ms else "dense_cutoff")
                held(f"{law} {form}, {k} rows x {n_cols} columns", got,
                     want, lim)
    planes = sc.shard_planes(N, 25, dev, sort=True)
    x, y, vx, vy, rad, alive, ex, ey = planes
    p = sc.law_params("moussaid")
    prm = cuda_forces.law_vector("moussaid", p, dev)
    cols = (x, y, vx, vy, rad, alive)
    for form in ("dense", "dense_cutoff", "compact"):
        grid = None
        if form != "dense":
            grid = pair_grid.cutoff_grid(x, y, alive, CUTOFF_M,
                                         symmetric=False,
                                         max_surv=(FORCED_MAX_SURV
                                                   if form == "compact"
                                                   else 0))
        square = (cuda_forces.pair_force_dense(*cols, prm) if grid is None
                  else cuda_forces.pair_force_cutoff(*cols, prm, grid))
        rect = cuda_forces.pair_force_rect(*cols, prm, cols, grid=grid)
        again = cuda_forces.pair_force_rect(*cols, prm, cols, grid=grid)
        torch.cuda.synchronize()
        if grid is not None and grid.form != form:
            fail(f"the {form} check drew a {grid.form} grid")
        if not torch.equal(torch.stack(square), torch.stack(rect)):
            fail(f"the rectangular {form} form differs from the square one "
                 f"on equal planes")
        if not torch.equal(torch.stack(rect), torch.stack(again)):
            fail(f"two launches of the {form} form differ")
        say(f"phase 24 rectangular {form} == square {form} bitwise on equal "
            f"planes, N={N}, and relaunched bitwise equal")

    # the full-block kernel: shard 0's rows against shard 1's block
    for law in ("moussaid", "powerlaw"):
        for cutoff in (None, CUTOFF_M):
            pl = sc.shard_planes(N, 26, dev, n_shards=SHARDS,
                                 sort=cutoff is not None)
            rows, blk = sc.split(pl, 0, k), sc.split(pl, k, 2 * k)
            got_r, got_c, want_r, want_c, lim_r, lim_c = sc.sym_dense_case(
                law, rows, blk, cutoff)
            torch.cuda.synchronize()
            name = ("pair_force_sym_dense" if cutoff is None
                    else "pair_force_sym_dense_cutoff")
            form = f"{law} sym_dense{'' if cutoff is None else ' cutoff'}"
            held(f"{form} rows, {k} x {k}", got_r, want_r, lim_r, name)
            held(f"{form} columns, {k} x {k}", got_c, want_c, lim_c, name)

    # the in-kernel ring: every law, every device count, twice
    for n_dev in RING_DEVICES:
        n = (N // n_dev) * n_dev
        for law in sc.LAWS:
            for cutoff in (None, CUTOFF_M):
                pl = sc.shard_planes(n, 27, dev, n_shards=n_dev,
                                     sort=cutoff is not None)
                got, want, lim, dense = sc.ring_case(law, pl, n_dev, cutoff)
                again, *_ = sc.ring_case(law, pl, n_dev, cutoff)
                torch.cuda.synchronize()
                label = (f"ring_force {law} D={n_dev}, N={n}"
                         + ("" if cutoff is None else f", {CUTOFF_M:g} m"))
                held(label + " vs plain ring", got, want, lim, "ring_force")
                held(label + " vs gather + dense kernel", got, dense,
                     2 * lim)
                if not torch.equal(got, again):
                    fail(f"{label}: a second launch on the same buffers "
                         f"gives another result")
        say(f"phase 24 ring_force D={n_dev}: relaunched on the same buffers, "
            f"bitwise equal")

    # times at the main path's shapes (Moussaid, 4 shards of 2,500), each
    # beside its bound: the bytes each input is read once and each output
    # written once, and the pairs (operations, special functions)
    pl = sc.shard_planes(N, 28, dev, n_shards=SHARDS)
    rows, blk = sc.split(pl, 0, k), sc.split(pl, k, 2 * k)
    p = sc.law_params("moussaid")
    prm = cuda_forces.law_vector("moussaid", p, dev)
    side = lambda q: tuple(q[:6])  # noqa: E731
    n_rows, n_blk = int(rows[5].sum()), int(blk[5].sum())
    n_all = int(pl[5].sum())
    plane_bytes = 5 * 4 + 1

    def sym_dense():
        return cuda_forces.pair_force_sym_dense(*side(rows), prm, side(blk),
                                                col_offset=k)

    def gathered():
        return cuda_forces.pair_force_rect(*side(rows), prm, side(pl))

    def ring():
        return cuda_ring.ring_force(*side(pl), prm, SHARDS)

    def ring_plain():
        return cuda_ring.ring_force_plain(*side(pl), p, SHARDS)

    slot = 6 * k + 4 * -(-k // pair_grid.COL_TILE)
    timing = {
        "pair_force_sym_dense": (
            sym_dense, "pair_force_sym_dense_kernel",
            lambda: sc.plain_pairs("moussaid", rows, blk, 0, k, mirror=True),
            bound(2 * k * plane_bytes + 4 * 4 * k + 6 * 4,
                  n_rows * n_blk * (PAIR_OPS + 2), n_rows * n_blk * PAIR_MUFU),
            f"{k} x {k} block"),
        "pair_force_dense (rectangular)": (
            gathered, "pair_force_dense_kernel",
            lambda: sc.plain_pairs("moussaid", rows, pl, 0, 0),
            bound((k + N) * plane_bytes + 2 * 4 * k + 6 * 4,
                  n_rows * (n_all - 1) * PAIR_OPS,
                  n_rows * (n_all - 1) * PAIR_MUFU),
            f"{k} rows x {N} gathered columns"),
        "ring_force": (
            ring, "ring_force_kernel", ring_plain,
            bound(N * (plane_bytes + 8) + SHARDS * slot * 4
                  + 2 * SHARDS * (SHARDS - 1) * slot * 4 + 6 * 4,
                  n_all * (n_all - 1) * PAIR_OPS,
                  n_all * (n_all - 1) * PAIR_MUFU),
            f"D={SHARDS}, N={N}")}
    for name, (fn, kernel, plain, bnd, shape) in timing.items():
        t_ms = device_ms(fn, kernel)
        p_ms = cuda_ms(plain, reps=3)
        results[name] = dict(ms=t_ms, plain_ms=p_ms, bound=bnd)
        floor = "; " + {
            "pair_force_sym_dense": lambda: floor_note(
                "pair_force_sym_dense<false, Moussaid>", n_rows * n_blk),
            "pair_force_dense (rectangular)": lambda: floor_note(
                "pair_force_dense<kAllTiles, Moussaid>",
                n_rows * (n_all - 1)),
            "ring_force": lambda: floor_note(
                "ring_force<false, Moussaid>", n_all * (n_all - 1))}[name]()
        say(f"phase 24 time {name} ({shape}): kernel {t_ms:.4f} ms on the "
            f"device, plain {p_ms:.4f} ms, bound {bnd[0]:.6f} ms ({bnd[1]})"
            f"{floor} ({card})")
    # the full-block kernel with the cutoff at the 50k path's shape: shard
    # 0's sorted rows against shard 1's sorted block, 12,500 each
    kb = CUT_N // SHARDS
    pl = sc.shard_planes(CUT_N, 29, dev, n_shards=SHARDS, sort=True)
    rows, blk = sc.split(pl, 0, kb), sc.split(pl, kb, 2 * kb)
    grid = pair_grid.block_grid(
        pair_grid.box_planes(rows[0], rows[1], rows[5], pair_grid.SYM_TILE),
        pair_grid.box_planes(blk[0], blk[1], blk[5], pair_grid.SYM_TILE),
        CUTOFF_M)
    c2 = pair_grid.cutoff_sq(CUTOFF_M)
    within = 0
    for lo in range(0, kb, 1024):
        dx = blk[0][None, :] - rows[0][lo:lo + 1024, None]
        dy = blk[1][None, :] - rows[1][lo:lo + 1024, None]
        within += int((rows[5][lo:lo + 1024, None] & blk[5][None, :]
                       & (dx * dx + dy * dy <= c2)).sum())
    bnd = bound(2 * kb * plane_bytes + 4 * 4 * kb + 4 * grid.boxes.numel()
                + 4 * grid.row_boxes.numel() + 6 * 4,
                within * (PAIR_OPS + 2), within * PAIR_MUFU)
    t_ms = device_ms(lambda: cuda_forces.pair_force_sym_dense(
        *side(rows), prm, side(blk), col_offset=kb, grid=grid),
        "pair_force_sym_dense_kernel")
    p_ms = cuda_ms(lambda: sc.plain_pairs("moussaid", rows, blk, 0, kb,
                                          cutoff=CUTOFF_M, mirror=True),
                   reps=2)
    results["pair_force_sym_dense_cutoff"] = dict(ms=t_ms, plain_ms=p_ms,
                                                  bound=bnd)
    say(f"phase 24 time pair_force_sym_dense_cutoff ({kb} x {kb} sorted "
        f"block of the {CUT_N} path, {CUTOFF_M:g} m, {within} pairs within "
        f"it of {kb * kb}): kernel {t_ms:.4f} ms on the device, plain "
        f"{p_ms:.4f} ms, bound {bnd[0]:.6f} ms ({bnd[1]}); "
        f"{floor_note('pair_force_sym_dense<true, Moussaid>', within)} "
        f"({card})")
    return worst, results


def shard_paths(dev, zero, card, step_ms, launches, urban):
    """Phases 25 and 26: the sharded main paths on a LocalMesh of SHARDS
    virtual shards on the one card.  Each schedule's checked run steps the
    sharded kernel path and, from the same state, the single-device kernel
    path (and, for a few steps or all, the sharded plain path); its timed
    runs count every launch per step.  Then the rest of the step under
    sharding (the urban fleet, groups, config #3 + ORCA) and one 1-rank
    NCCL process-group run."""
    import dataclasses
    import socket
    import torch
    import torch.distributed as dist
    from carla_social_force_model_tpu_torch.api.synthetic import (
        benchmark_bundle)
    from carla_social_force_model_tpu_torch.models import stepper
    from carla_social_force_model_tpu_torch.models.state import PedState
    from carla_social_force_model_tpu_torch.parallel import (
        ProcessGroupAxis, make_mesh)
    from carla_social_force_model_tpu_torch.parallel.sharding import (
        make_sharded_rollout, prepare_sharded_scene, shard_of)
    mesh = make_mesh(SHARDS, device=dev)
    label4 = f"{SHARDS} virtual shards on one card"

    def gather_state(outs):
        return PedState(**{f.name: torch.cat([getattr(o, f.name)
                                              for o in outs])
                           for f in dataclasses.fields(PedState)})

    def prepared(scene, params, cfg):
        scene, cap = prepare_sharded_scene(scene, SHARDS)
        scene = stepper.prepare_scene(scene, analytic=cfg.env_analytic,
                                      orca=params.enable_orca,
                                      chunked=cfg.env_chunked)
        return scene, cap

    def sharded_step(shards, params, cfg, state, t, ap):
        def body(ax, st, scn):
            if ap is None:
                return stepper.simulation_step(st, scn, params, cfg, t,
                                               axis=ax)[0], None
            st, nap, _ = stepper.fleet_tick(st, ap, scn, params, cfg, t, ax)
            return st, nap
        outs = mesh.run(body, [shard_of(state, d, SHARDS)
                               for d in range(SHARDS)], shards)
        return gather_state([o[0] for o in outs]), outs[0][1]

    def check_steps(label, scene, params, cfg, steps, plain_steps):
        """``steps`` sharded kernel steps, each against the single-device
        kernel path's step from the same state, the first ``plain_steps``
        also against the sharded plain path's: positions within
        POS_STEP_TOL_M, modes, alive and the fleet state equal."""
        scene, cap = prepared(scene, params, cfg)
        shards = [dataclasses.replace(scene, spawn=shard_of(scene.spawn, d,
                                                            SHARDS))
                  for d in range(SHARDS)]
        ref_plain = plain_cfg(cfg)
        fleet = scene.autopilot
        ap = None if fleet is None else fleet.initial_state()
        s = PedState.empty(cap, device=dev)
        one, plain = [], []
        t0 = time.perf_counter()
        for t in range(steps):
            got, gap = sharded_step(shards, params, cfg, s, t, ap)
            if fleet is None:
                want, _ = stepper.simulation_step(s, scene, params, cfg, t)
                wap = None
            else:
                want, wap, _ = stepper.fleet_tick(s, ap, scene, params, cfg,
                                                  t)
            refs = [(want, wap, one)]
            if t < plain_steps:
                refs.append((*sharded_step(shards, params, ref_plain, s, t,
                                           ap), plain))
            for ref, rap, errs in refs:
                errs.append(max((got.pos_x - ref.pos_x).abs().max().item(),
                                (got.pos_y - ref.pos_y).abs().max().item()))
                if not (torch.equal(got.alive, ref.alive)
                        and torch.equal(got.mode, ref.mode)):
                    fail(f"{label}: step {t} gives other modes or alive "
                         f"masks sharded than on one device / plain")
                if rap is not None and not all(
                        torch.equal(getattr(gap, f), getattr(rap, f))
                        for f in gap.__dataclass_fields__):
                    fail(f"{label}: step {t} gives another fleet state "
                         f"sharded than on one device / plain")
            if not (torch.isfinite(got.pos_x).all()
                    and torch.isfinite(got.pos_y).all()):
                fail(f"{label}: non-finite positions after step {t}")
            s, ap = got, gap
        torch.cuda.synchronize()
        say(f"{label}: {steps} sharded steps ({label4}), one-step position "
            f"L-inf vs the single-device kernel path max {max(one):.3e} m, "
            f"vs the sharded plain path ({len(plain)} steps) max "
            f"{max(plain) if plain else float('nan'):.3e} m (limit "
            f"{POS_STEP_TOL_M:g} m); {int(s.alive.sum())} alive; "
            f"{time.perf_counter() - t0:.1f} s ({card})")
        if max(one) > POS_STEP_TOL_M or (plain and max(plain)
                                          > POS_STEP_TOL_M):
            fail(f"{label}: a sharded step lands more than "
                 f"{POS_STEP_TOL_M} m from its reference")

    def timed(label, scene, params, cfg, steps, expect, single_ms):
        """One timed sharded run of ``steps`` after a short warm-up, the
        counts set to 0 just before it and read just after: they must
        equal ``expect`` exactly."""
        scene, cap = prepared(scene, params, cfg)
        state = PedState.empty(cap, device=dev)
        make_sharded_rollout(mesh, scene, params, cfg,
                             SHARD_WARMUP_STEPS)(state)
        run = make_sharded_rollout(mesh, scene, params, cfg, steps)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        final, _ = run(state)
        torch.cuda.synchronize()
        best = time.perf_counter() - t0
        counts = read_counts()
        if counts != dict(zero, **expect):
            fail(f"{label} launched {counts}, expected "
                 f"{dict(zero, **expect)}")
        if not (torch.isfinite(final.pos_x).all()
                and torch.isfinite(final.pos_y).all()):
            fail(f"non-finite positions after the {label} run")
        per_step = {k: v / steps for k, v in expect.items()}
        say(f"{label}: N={cap}, {steps} steps, {label4}: one run "
            f"{1e3 * best / steps:.4f} ms/step = "
            f"{cap * steps / best:.1f} agent-steps/s; launches per step "
            f"{per_step}; single-device config #1 (phase 4, same call) "
            f"{single_ms:.4f} ms/step ({card})")
        return counts

    lap("phase 25")
    scene, params, cfg, _ = benchmark_bundle(N, device=dev)
    n_pairs = SHARDS * (SHARDS - 1) // 2
    schedules = (
        ("gather", True, dict(pair_force_dense=SHARDS)),
        ("ring", False, dict(pair_force_dense=SHARDS * SHARDS)),
        ("ring", True, dict(pair_force_sym=SHARDS,
                            pair_force_sym_dense=n_pairs)),
        ("ring_kernel", True, dict(ring_force=1)))
    for comm, symmetric, per_step in schedules:
        name = ("half-ring" if comm == "ring" and symmetric else
                "ring, symmetric_pairs=False" if comm == "ring" else comm)
        kcfg = dataclasses.replace(cfg, axis_comm=comm,
                                   symmetric_pairs=symmetric)
        label = f"phase 25 config #1 sharded, {name}"
        check_steps(label, scene, params, kcfg, PARITY_STEPS,
                    SHARD_PLAIN_STEPS)
        counts = timed(label, scene, params, kcfg, SHARD_STEPS,
                       {k: v * SHARD_STEPS for k, v in per_step.items()},
                       step_ms["pair_force_sym"])
        for k in per_step:
            if k in ("pair_force_sym_dense", "ring_force"):
                launches[k] = counts[k]
    scene, params, cfg, _ = benchmark_bundle(CUT_N, device=dev)
    kcfg = dataclasses.replace(cfg, axis_comm="ring",
                               interaction_cutoff=CUTOFF_M)
    label = (f"phase 25 config #1 + {CUTOFF_M:g} m cutoff, N={CUT_N}, "
             f"sharded half-ring (sorted)")
    check_steps(label, scene, params, kcfg, PARITY_STEPS,
                SHARD_BIG_PLAIN_STEPS)
    counts = timed(label, scene, params, kcfg, SHARD_STEPS,
                   dict(pair_force_sym_cutoff=SHARDS * SHARD_STEPS,
                        pair_force_sym_dense_cutoff=n_pairs * SHARD_STEPS),
                   step_ms.get(f"phase 10 config #1 + {CUTOFF_M:g} m cutoff, "
                               f"N={CUT_N}, via pair_force_sym_compact",
                               float("nan")))
    launches["pair_force_sym_dense_cutoff"] = counts[
        "pair_force_sym_dense_cutoff"]

    lap("phase 26")
    uscene, uparams, ucfg, _ = urban
    check_steps("phase 26 urban (BASELINE config #4) sharded, half-ring",
                uscene, uparams, dataclasses.replace(ucfg, axis_comm="ring"),
                PARITY_STEPS, 2)
    scene, params, cfg, _ = benchmark_bundle(N, device=dev)
    gscene, gparams = family_scene(scene, params, "groups-0.5:4")
    check_steps("phase 26 config #1 + groups-0.5:4 sharded, gather", gscene,
                gparams, dataclasses.replace(cfg, axis_comm="gather"),
                SHARD_SIDE_STEPS, 2)
    oscene, oparams, ocfg, _, _ = orca_scene("headline", N,
                                             SHARD_SIDE_STEPS, dev, urban)
    check_steps("phase 26 config #3 + ORCA + env_analytic sharded, gather",
                oscene, oparams, dataclasses.replace(ocfg,
                                                     axis_comm="gather"),
                SHARD_SIDE_STEPS, 2)
    # one process, one rank, NCCL: the process-group axis on CUDA tensors
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1,
                            device_id=torch.device(dev))
    try:
        axis = ProcessGroupAxis()
        one = stepper.make_rollout_fn(scene, params, cfg, NCCL_STEPS)(
            PedState.empty(N, device=dev))[1]
        for comm in ("gather", "ring_kernel"):
            reset_counts()
            _, rec = make_sharded_rollout(
                axis, stepper.prepare_scene(scene), params,
                dataclasses.replace(cfg, axis_comm=comm), NCCL_STEPS,
                record=True)(PedState.empty(N, device=dev))
            torch.cuda.synchronize()
            counts = {k: v for k, v in read_counts().items() if v}
            err = (rec.pos - one.pos).abs().max().item()
            say(f"phase 26 1-rank NCCL ProcessGroupAxis, config #1, "
                f"{comm}, {NCCL_STEPS} steps: launches {counts}; position "
                f"L-inf vs the single-device run {err:.3e} m (limit "
                f"{POS_TOL_M:g} m) ({card})")
            if err > POS_TOL_M or not torch.equal(rec.alive, one.alive):
                fail(f"the 1-rank NCCL run ({comm}) leaves the single-device "
                     f"run")
    finally:
        dist.destroy_process_group()


#: ensembles and sweeps (phases 27-29): BASELINE config #5 (bench.py's
#: BENCH_MODE=ensemble: benchmark_bundle(1000) with batched_crowds(256,
#: 1000), 100 steps after a 20-step warm-up), the model-family forms of
#: the batched pair kernels on the same batch (cut to 20 steps: they exist
#: to launch those forms), a 64-point sweep of pedestrian_A, config #3
#: under a batch of 16 and a sweep of border_a over 8 rows on config #2's
#: scene (50 steps each); the step-by-step checks run 50 steps at the
#: geometry phase's batch of 16
BATCH = 256
BATCH_N = 1_000
BATCH_STEPS = 100
BATCH_FAMILY_STEPS = 20
SWEEP_POINTS = 64
SWEEP_ROWS = (0, 21, 42, 63)
GEOM_BATCH = 16
GEOM_STEPS = 50
BORDER_SWEEP = 8


def batch_phases(dev, zero, card, launches, worst, profile_steps):
    """Phases 27-29: the batched kernels against their plain batched
    versions and, row by row, against the unbatched kernels; the ensemble
    and sweep paths through ``parallel/sweeps.py`` with their launches,
    rates and device-busy shares; every step of a 50-step batched rollout
    against the plain versions' step.  Returns ``{kernel: (source line,
    ms, plain_ms, bound)}`` for the kernels line."""
    import dataclasses
    import numpy as np
    import torch
    import batch_cases as bc
    from family_cases import TOLERANCE as TOLERANCE_OF
    from carla_social_force_model_tpu_torch.api.synthetic import (
        batched_crowds, benchmark_bundle)
    from carla_social_force_model_tpu_torch.models import stepper, vehicles
    from carla_social_force_model_tpu_torch.models.params import (
        section_rows)
    from carla_social_force_model_tpu_torch.models.state import PedState
    from carla_social_force_model_tpu_torch.ops import cuda_forces
    from carla_social_force_model_tpu_torch.parallel import sweeps
    table = {}

    def run_batch(label, make_run, arg, steps, expect, rows):
        """One batched main path: a warm-up run of WARMUP_STEPS, then best
        of 2 timed runs of ``steps``, each with every count set to 0 just
        before and read just after (they must equal ``expect``); finite
        positions.  Prints the rate, the step time and the launches per
        step."""
        make_run(min(steps, WARMUP_STEPS))(arg)
        run = make_run(steps)
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(2):
            reset_counts()
            t0 = time.perf_counter()
            final, _ = run(arg)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
            counts = read_counts()
            if counts != expect:
                fail(f"{label} launched {counts}, expected {expect}")
        if not (torch.isfinite(final.pos_x).all()
                and torch.isfinite(final.pos_y).all()):
            fail(f"non-finite positions after the {label} rollout")
        n = final.capacity
        per_step = {k: v / steps for k, v in counts.items() if v}
        say(f"{label}: B={rows} x N={n}, {steps} steps, best of 2 "
            f"{best:.3f} s = {rows * n * steps / best:.1f} agent-steps/s, "
            f"{1e3 * best / steps:.4f} ms/step, launches per step "
            f"{per_step} (one per batched kernel and term, for all "
            f"{rows} rows); {int(final.alive.sum())} of {rows * n} alive, "
            f"all finite ({card})")
        return counts, 1e3 * best / steps, final

    def check_steps(label, scene, params, cfg, state):
        """Every step of a PARITY_STEPS-step batched rollout through the
        kernels against the plain versions' step from the same state, per
        row: within POS_STEP_TOL_M, modes and alive equal, finite."""
        gaps = []
        for k, gap, equal, finite in bc.one_step_gaps(scene, params, cfg,
                                                      state, PARITY_STEPS):
            if not (equal and finite):
                fail(f"{label}: step {k} from the same state gives other "
                     f"modes or alive masks, or non-finite positions, "
                     f"through the kernels than through the plain versions")
            gaps.append(gap.max().item())
            if gaps[-1] > POS_STEP_TOL_M:
                row = int(gap.argmax())
                fail(f"{label}: step {k}, row {row}: one-step position "
                     f"L-inf {gaps[-1]:.3e} m exceeds {POS_STEP_TOL_M} m")
        say(f"{label} one-step position L-inf kernels vs plain from the same "
            f"state, worst row of each step 1..{PARITY_STEPS} (limit "
            f"{POS_STEP_TOL_M:g} m): " + " ".join(f"{v:.2e}" for v in gaps))

    def pair_checks(label, planes, p, forms):
        """The batched pair kernels of ``forms`` on ``planes`` with params
        ``p`` (a law's, shared or swept): against the plain batched version
        and row by row against the unbatched kernel (bitwise for the dense
        walk, twice the tolerance for the symmetric one)."""
        refs = {}
        for law, form in forms:
            q = p if p is not None else bc.law_params(law)
            if law not in refs:
                refs[law] = bc.batch_reference(law, planes, q)
            got = bc.batch_run(law, form, planes, q)
            torch.cuda.synchronize()
            m = bc.pair_mismatch(law, form, planes, q, got, refs[law])
            name = bc.PAIR_FORMS[law, form]
            tol = ("1e-4 + 1e-4*|f|" if law == "moussaid"
                   else TOLERANCE_OF[law])
            say(f"{label} {name}: max abs err {m['err']:.3e} vs the plain "
                f"batched version ({m['over']} over {tol}); rows vs the "
                f"unbatched kernel: "
                + ("bitwise equal" if m["rows_equal"] else
                   f"max diff {m['row_err']:.3e} ({m['row_over']} over "
                   f"twice the tolerance)"))
            if not torch.isfinite(got).all():
                fail(f"{name} returned non-finite forces")
            if bool((got[:, ~planes[5]] != 0).any()):
                fail(f"{name}: dead rows are not exactly zero")
            if m["over"]:
                fail(f"{name} disagrees with its plain batched version")
            if form == "dense" and not m["rows_equal"]:
                fail(f"{name}: a row differs from the unbatched kernel on "
                     f"that row")
            if m["row_over"]:
                fail(f"{name}: a row is farther from the unbatched kernel "
                     f"than twice the tolerance")
            worst[name] = max(worst.get(name, 0.0), m["err"])

    lap("phase 27")
    # -- phase 27: BASELINE config #5, the batched pair kernels ---------------
    planes = bc.batch_planes(BATCH, BATCH_N, seed=27, device=dev,
                             extent=35.0)
    pair_checks(f"phase 27 B={BATCH} x N={BATCH_N}", planes, None,
                sorted(bc.PAIR_FORMS))
    n_sym = BATCH_N * (BATCH_N - 1) // 2
    pair_bytes = BATCH * (BATCH_N * (5 * 4 + 1) + 6 * 4 + BATCH_N * 8)
    src = "carla_social_force_model_tpu/ops/pallas_forces.py:"
    lines = {"moussaid": {"sym": "239", "dense": "162"},
             "powerlaw": {"sym": "462", "dense": "462"},
             "helbing": {"dense": "528"}}
    kern = {"sym": "pair_force_sym_batched_kernel",
            "dense": "pair_force_dense_batched_kernel"}
    plain_of, counts_of = {}, {}
    for law, form in sorted(bc.PAIR_FORMS):
        name = bc.PAIR_FORMS[law, form]
        p = bc.law_params(law)
        ms = device_ms(lambda: bc.batch_run(law, form, planes, p),
                       kern[form])
        if law not in plain_of:
            # one plain timing and one count of the pairs per law: the
            # symmetric form's work is half the dense form's
            plain_of[law] = cuda_ms(lambda: cuda_forces.plain_batched_force(
                law, *planes[:6], p,
                desired=tuple(planes[6:]) if law == "helbing" else None),
                reps=2)
            if law != "moussaid":
                counts_of[law] = np.sum(
                    [family_work(law, [t[b] for t in planes], None,
                                 False)[2] for b in range(BATCH)], axis=0)
        plain = plain_of[law]
        sym = form == "sym"
        if law == "moussaid":
            pairs = n_sym if sym else 2 * n_sym
            bnd = bound(pair_bytes, BATCH * pairs * (PAIR_OPS + 2 * sym),
                        BATCH * pairs * PAIR_MUFU)
        else:
            pairs, course, active = (int(c) // (2 if sym else 1)
                                     for c in counts_of[law])
            if law == "powerlaw":
                ops = (pairs * (PL_GATE_OPS + 2 * sym)
                       + course * PL_TAU_OPS + active * PL_FORCE_OPS)
                mufu = course * PL_TAU_MUFU + active * PL_FORCE_MUFU
            else:
                ops, mufu = pairs * HB_OPS, pairs * HB_MUFU
            per_row = BATCH_N * (4 * (5 if law == "powerlaw" else 6) + 1
                                 + 8)
            bnd = bound(BATCH * per_row + 4 * 6 * BATCH, ops, mufu)
        table[name] = (src + lines[law][form], ms, plain, bnd)
        say(f"phase 27 time {name} at B={BATCH} x N={BATCH_N}: kernel "
            f"{ms:.4f} ms ({TIMED_BY[0]}; bound {bnd[0]:.4f} ms, "
            f"{bnd[1]}), plain batched version {plain:.3f} ms ({card})")

    scene, params, cfg, _ = benchmark_bundle(BATCH_N, device=dev)
    ens = dataclasses.replace(scene, spawn=batched_crowds(BATCH, BATCH_N,
                                                          device=dev))
    state = PedState.empty(BATCH_N, device=dev, batch=BATCH)
    paths = [("pair_force_sym_batched", True, params, BATCH_STEPS),
             ("pair_force_dense_batched", False, params, BATCH_STEPS),
             ("powerlaw_sym_batched", True, dataclasses.replace(
                 params, enable_pedestrian=False, enable_powerlaw=True),
              BATCH_FAMILY_STEPS),
             ("powerlaw_dense_batched", False, dataclasses.replace(
                 params, enable_pedestrian=False, enable_powerlaw=True),
              BATCH_FAMILY_STEPS),
             ("helbing_dense_batched", True, dataclasses.replace(
                 params, enable_pedestrian=False, enable_ped_repulsive=True),
              BATCH_FAMILY_STEPS)]
    for name, sym, prm_set, steps in paths:
        c = dataclasses.replace(cfg, symmetric_pairs=sym)
        label = f"phase 27 config #5 (ensemble) via {name}"
        counts, ms_step, _ = run_batch(
            label, lambda k, c=c, q=prm_set: sweeps.make_ensemble_rollout(
                ens, q, c, k), ens, steps, dict(zero, **{name: steps}),
            BATCH)
        launches[name] = counts[name]
        if steps == BATCH_STEPS:
            profile_steps(ens, prm_set, c, state, ms_step, label)
    small = dataclasses.replace(scene, spawn=batched_crowds(
        GEOM_BATCH, BATCH_N, device=dev))
    for sym in (True, False):
        check_steps(f"phase 27 config #5 at B={GEOM_BATCH}, "
                    f"symmetric_pairs={sym}", small, params,
                    dataclasses.replace(cfg, symmetric_pairs=sym),
                    PedState.empty(BATCH_N, device=dev, batch=GEOM_BATCH))

    lap("phase 28")
    # -- phase 28: a 64-point sweep of pedestrian_A --------------------------
    amps = torch.linspace(0.5, 12.0, SWEEP_POINTS, device=dev)
    swept = sweeps.batch_params(params, pedestrian_A=amps)
    for name, sym in (("pair_force_sym_batched", True),
                      ("pair_force_dense_batched", False)):
        c = dataclasses.replace(cfg, symmetric_pairs=sym)
        label = f"phase 28 sweep of pedestrian_A via {name}"
        counts, ms_step, final = run_batch(
            label, lambda k, c=c: sweeps.make_sweep_rollout(scene, c, k),
            swept, BATCH_STEPS, dict(zero, **{name: BATCH_STEPS}),
            SWEEP_POINTS)
        if sym:
            profile_steps(scene, swept, c,
                          PedState.empty(BATCH_N, device=dev,
                                         batch=SWEEP_POINTS), ms_step, label)
        apart = [max((final.pos_x[b] - final.pos_x[0]).abs().max().item(),
                     (final.pos_y[b] - final.pos_y[0]).abs().max().item())
                 for b in SWEEP_ROWS[1:]]
        say(f"{label}: final L-inf distance of rows {SWEEP_ROWS[1:]} from "
            f"row 0 (A = {amps[0].item():g}): "
            + " ".join(f"{v:.3e}" for v in apart) + " m (must exceed 1e-3)")
        if min(apart) <= 1e-3:
            fail(f"{label}: rows with different A do not end apart")
        # the sampled rows against the unbatched kernel path with that
        # row's parameters: bitwise through the dense walk, the distance
        # printed through the symmetric one (its atomics)
        rows = section_rows(swept.pedestrian, SWEEP_POINTS)
        for b in SWEEP_ROWS:
            one, _ = stepper.make_rollout_fn(
                scene, dataclasses.replace(params, pedestrian=rows[b]), c,
                BATCH_STEPS, record=False)(PedState.empty(BATCH_N,
                                                          device=dev))
            d = max((final.pos_x[b] - one.pos_x).abs().max().item(),
                    (final.pos_y[b] - one.pos_y).abs().max().item())
            same = (torch.equal(final.pos_x[b], one.pos_x)
                    and torch.equal(final.pos_y[b], one.pos_y)
                    and torch.equal(final.alive[b], one.alive))
            say(f"{label} row {b} (A = {rows[b].A:g}) vs the unbatched "
                f"kernel path, {BATCH_STEPS} steps: "
                + ("bitwise equal" if same else f"L-inf {d:.3e} m"))
            if not sym and not same:
                fail(f"{label}: row {b} differs from the unbatched dense "
                     f"kernel path with its parameters")
    # the swept kernels on the sweep's own state (row b with A_b)
    state1, _ = stepper.rollout(PedState.empty(BATCH_N, device=dev,
                                               batch=SWEEP_POINTS),
                                scene, swept, cfg, 1, record=False)
    pair_checks("phase 28 swept pedestrian_A", [
        t.contiguous() for t in (state1.pos_x, state1.pos_y, state1.vel_x,
                                 state1.vel_y, state1.radius, state1.alive,
                                 state1.vel_x, state1.vel_y)],
        swept.pedestrian, (("moussaid", "sym"), ("moussaid", "dense")))
    check_steps("phase 28 sweep of pedestrian_A", scene, swept, cfg,
                PedState.empty(BATCH_N, device=dev, batch=SWEEP_POINTS))

    lap("phase 29")
    # -- phase 29: geometry under a batch (config #3 x 16; border_a swept) ---
    scene3, params3, cfg3, _ = benchmark_bundle(
        BATCH_N, with_borders=True, with_obstacles=True,
        num_steps_hint=BATCH_STEPS, device=dev)
    extent = max(25.0, float(np.sqrt(BATCH_N)))
    ens3 = stepper.prepare_scene(dataclasses.replace(
        scene3, spawn=batched_crowds(GEOM_BATCH, BATCH_N, extent=extent,
                                     device=dev)))
    state3 = PedState.empty(BATCH_N, device=dev, batch=GEOM_BATCH)
    label = "phase 29 config #3 ensemble"
    expect = dict(zero, pair_force_sym_batched=GEOM_STEPS,
                  env_exp_batched=GEOM_STEPS,
                  env_moussaid_batched=2 * GEOM_STEPS)
    counts, ms_step, _ = run_batch(
        label, lambda k: sweeps.make_ensemble_rollout(ens3, params3, cfg3,
                                                      k),
        ens3, GEOM_STEPS, expect, GEOM_BATCH)
    for name in ("env_exp_batched", "env_moussaid_batched"):
        launches[name] = counts[name]
    profile_steps(ens3, params3, cfg3, state3, ms_step, label)
    check_steps(label, ens3, params3, cfg3, state3)

    def env_checks(label, scene_p, prm_set, cfg_p, state, times):
        """The batched environment kernels on the jobs of ``scene_p``
        (after one step; 10% dead): against the plain batched versions and,
        row by row, the unbatched kernels bitwise; with ``times``, their
        times, plain versions' and bounds."""
        st, _ = stepper.rollout(state, scene_p, prm_set, cfg_p, 1,
                                record=False)
        rng = np.random.default_rng(29)
        dead = torch.from_numpy(rng.uniform(size=tuple(st.pos_x.shape))
                                < 0.1).to(dev)
        st = dataclasses.replace(st, alive=st.alive & ~dead)
        planes = bc.sorted_rows(st)
        snap = (vehicles.vehicle_snapshot_at(scene_p.vehicles, 1)
                if scene_p.vehicles is not None else None)
        jobs = bc.env_jobs(scene_p, snap, prm_set) if snap is not None else {
            "borders": ("env_exp", scene_p.borders_seg,
                        (prm_set.border.a, prm_set.border.b), None)}
        for job, (kernel, seg, args, active) in jobs.items():
            got = bc.env_batch_run(kernel, planes, seg, args, active)
            torch.cuda.synchronize()
            err, over, equal = bc.env_mismatch(kernel, planes, seg, args,
                                               active, got)
            name = kernel + "_batched"
            say(f"{label} {name} ({job}): max abs err {err:.3e} vs the plain "
                f"batched version ({over} over {bc.ENV_ATOL:g} + "
                f"{bc.ENV_RTOL:g}*|f|); rows vs the unbatched kernel: "
                + ("bitwise equal" if equal else "DIFFERENT"))
            if not torch.isfinite(got).all() or bool(
                    (got[:, ~planes[5]] != 0).any()):
                fail(f"{name} ({job}): non-finite forces or dead rows not 0")
            if over:
                fail(f"{name} ({job}) disagrees with its plain version")
            if not equal:
                fail(f"{name} ({job}): a row differs from the unbatched "
                     f"kernel on that row")
            worst[name] = max(worst.get(name, 0.0), err)
            if not times or job == "vehicles":
                continue
            ms = device_ms(lambda: bc.env_batch_run(kernel, planes, seg,
                                                    args, active),
                           "env_force_batched_kernel")
            plain = cuda_ms(lambda: bc.env_batch_run(
                kernel, planes, seg, args, active, batched=False), reps=3)
            n_bytes = ops = mufu = 0
            moussaid = kernel == "env_moussaid"
            for b in range(planes[0].shape[0]):
                nb, o, m, _ = env_work(seg, planes[0][b], planes[1][b],
                                       planes[5][b], active, moussaid)
                n_bytes, ops, mufu = n_bytes + nb, ops + o, mufu + m
            # the shared point rows are read once for every row
            seg_bytes = seg.x.numel() * 8 + seg.num_segments * 4 * (
                5 if moussaid else 3)
            n_bytes -= (planes[0].shape[0] - 1) * seg_bytes
            bnd = bound(n_bytes, ops, mufu)
            table[name] = ("carla_social_force_model_tpu/ops/pallas_env.py:"
                           + ("268" if moussaid else "235"), ms, plain, bnd)
            say(f"{label} time {name} ({job}), B={planes[0].shape[0]} x "
                f"N={BATCH_N}: kernel {ms:.4f} ms ({TIMED_BY[0]}; bound "
                f"{bnd[0]:.5f} ms, {bnd[1]}), plain batched version "
                f"{plain:.3f} ms ({card})")

    env_checks("phase 29 config #3", ens3, params3, cfg3, state3, times=True)

    scene2, params2, cfg2, _ = benchmark_bundle(BATCH_N, with_borders=True,
                                                device=dev)
    swept2 = sweeps.batch_params(params2, border_a=torch.linspace(
        0.5, 12.0, BORDER_SWEEP, device=dev))
    label = f"phase 29 config #2 sweep of border_a over {BORDER_SWEEP} rows"
    run_batch(label, lambda k: sweeps.make_sweep_rollout(scene2, cfg2, k),
              swept2, GEOM_STEPS, dict(zero, pair_force_sym_batched=GEOM_STEPS,
                                       env_exp_batched=GEOM_STEPS),
              BORDER_SWEEP)
    scene2p = stepper.prepare_scene(scene2)
    state2 = PedState.empty(BATCH_N, device=dev, batch=BORDER_SWEEP)
    env_checks(label, scene2p, swept2, cfg2, state2, times=False)
    check_steps(label, scene2p, swept2, cfg2, state2)
    return table


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an "
             "NVIDIA card")
    START[0] = time.perf_counter()
    sys.path.insert(0, ROOT)
    try:
        from carla_social_force_model_tpu_torch.api.synthetic import (
            benchmark_bundle)
        from carla_social_force_model_tpu_torch.models import stepper
        from carla_social_force_model_tpu_torch.models.params import (
            MoussaidParams, moussaid_vector)
        from carla_social_force_model_tpu_torch.ops import (
            cuda_env, cuda_forces, forces)
        from carla_social_force_model_tpu_torch.utils import cuda_build
    except ImportError as exc:
        fail(f"the port package is not beside chip_smoke.py ({exc})")
    import dataclasses
    import numpy as np

    lap("phase 1")
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

    lap("phase 2")
    # -- phase 2: build the kernels from csrc/ (one nvcc per source) ---------
    t0 = time.perf_counter()
    cuda_build.build_kernels()
    cuda_build.load_kernels()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in cuda_build.BUILD_LOG.read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    say(f"phase 2 build: {build_s:.2f} s, {cuda_build.LIBRARY.name}; "
        f"ptxas: {' | '.join(ptxas)}")
    # the inner loops' SASS (cuobjdump, nvdisasm): instructions per pair or
    # per scanned point, the issue-rate floors of phases 3-24
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import sass_census
    try:
        CENSUS.update(sass_census.census(cuda_build.LIBRARY))
    except (RuntimeError, OSError, subprocess.CalledProcessError) as exc:
        fail(f"the SASS census failed: {exc}")
    missing = [k for k, c in CENSUS.items() if c is None]
    if missing:
        fail(f"the SASS census found no inner loop of {missing}")
    for label, c in CENSUS.items():
        g = c["groups_per_unit"]
        say(f"phase 2 SASS census {c['kernel']} ({label}): "
            f"{c['per_unit']:.2f} instructions per {c['unit']} (law "
            f"arithmetic {g['law']:.2f}, special functions "
            f"{g['special']:.2f}, memory and sync {g['memory']:.2f}, mask, "
            f"loop and select {g['control']:.2f}; {c['mufu_per_unit']:g} "
            f"MUFU), {c['units_per_trip']:g} {c['unit']}s per trip of "
            f"{c['loop_instructions']}; {c['layout']}")

    lap("phase 3")
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
        f"{1e3 * n_dense * PAIR_OPS / PEAK_F32_S:.4f} ms; pair_force_sym "
        f"{floor_note('pair_force_sym<kTriangle, Moussaid>', n_sym)}; "
        f"pair_force_dense "
        f"{floor_note('pair_force_dense<kAllTiles, Moussaid>', n_dense)}")
    torch.cuda.synchronize()

    launches = {}

    def drive(label, scene, params, cfg, state, steps, expect,
              all_alive=True):
        """One main path: a warm-up run of WARMUP_STEPS (every kernel and
        the allocator's pools warm), then best of 2 timed runs (3 before the
        sharding phases came in), each with
        every count set to 0 just before and read just after; the counts
        must equal ``expect`` (per run) exactly.  Every position ends
        finite, and with ``all_alive`` every agent alive."""
        scene = stepper.prepare_scene(scene, analytic=cfg.env_analytic,
                                      orca=params.enable_orca,
                                      chunked=cfg.env_chunked)
        run = stepper.make_rollout_fn(scene, params, cfg, steps, record=False)
        stepper.make_rollout_fn(scene, params, cfg, min(steps, WARMUP_STEPS),
                                record=False)(state)
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(2):
            reset_counts()
            t0 = time.perf_counter()
            final, _ = run(state)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
            counts = read_counts()
            if counts != expect:
                fail(f"{label} launched {counts}, expected {expect}")
        n, n_alive = state.capacity, int(final.alive.sum())
        if all_alive and n_alive != n:
            fail(f"agents died in the {label} rollout")
        if not (torch.isfinite(final.pos_x).all()
                and torch.isfinite(final.pos_y).all()):
            fail(f"non-finite positions after the {label} rollout")
        say(f"{label}: N={n}, {steps} steps, best of 2 {best:.3f} s = "
            f"{n * steps / best:.1f} agent-steps/s, "
            f"{1e3 * best / steps:.4f} ms/step, launches {counts}; "
            f"{n_alive} of {n} alive, all finite ({card})")
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

    lap("phase 4")
    # -- phase 4: main path, config #1 (the pair kernels) -------------------
    scene, params, cfg, state = benchmark_bundle(N, device=dev)
    zero = {k: 0 for k in read_counts()}
    step_ms = {}
    for name, symmetric in (("pair_force_sym", True),
                            ("pair_force_dense", False)):
        counts, step_ms[name] = drive(
            f"phase 4 config #1 via {name}", scene, params,
            dataclasses.replace(cfg, symmetric_pairs=symmetric), state,
            MAIN_STEPS, dict(zero, **{name: MAIN_STEPS}))
        launches[name] = counts[name]
    profile_steps(scene, params, cfg, state, step_ms["pair_force_sym"],
                  "phase 4 config #1")

    lap("phase 5")
    # -- phase 5: end to end, kernel vs plain version on the same card -------
    t0 = time.perf_counter()
    _, rec_plain = stepper.make_rollout_fn(scene, params, plain_cfg(cfg),
                                           PARITY_STEPS)(state)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    check_rollout("phase 5 config #1", scene, params, cfg, state, rec_plain,
                  free_limit=True)
    say(f"phase 5 plain-path rollout: {N * PARITY_STEPS / plain_s:.1f} "
        f"agent-steps/s over {PARITY_STEPS} steps ({card})")

    lap("phase 6")
    # -- phase 6: the environment kernels at config #3's shapes --------------
    scene, params, cfg, state, snap, planes, vrows = config3_env_inputs(dev)
    px, py, vx, vy, rad, alive = planes
    dyn, dvel, dact = vrows
    pdyn = params.dynamic_obstacle
    b = params.border
    env_cases = {
        "env_exp": ("borders", scene.borders_seg, None, None, b),
        "env_moussaid": ("parked cars", scene.static_obstacles_seg,
                         scene.static_obstacle_vel, None,
                         params.static_obstacle),
        "env_moussaid vehicles": ("vehicles", dyn, dvel, dact, pdyn)}

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
        env_ms[key] = device_ms(call, "env_force_kernel")
        plain_ms[key] = cuda_ms(lambda k=key: env_call(k, False, plain=True),
                                reps=5)
        n_bytes, ops, mufu, pairs[key] = env_work(
            seg, px, py, alive, active, key != "env_exp")
        bounds_env[key] = bound(n_bytes, ops, mufu)
        census = ("env_force<exp, kAllSections, kSampled>" if key == "env_exp"
                  else "env_force<moussaid, kAllSections, kSampled>")
        say(f"phase 6 time {key} ({env_cases[key][0]}, "
            f"{seg.num_segments} x {seg.points_per_segment} slots), N={N}: "
            f"kernel {env_ms[key]:.4f} ms on the device, wrapper "
            f"{wrapper_ms[key]:.4f} ms, plain {plain_ms[key]:.4f} ms, "
            f"bound {bounds_env[key][0]:.6f} ms ({bounds_env[key][1]}; "
            f"{pairs[key]} in-filter pairs, {ops:.3e} operations, "
            f"{mufu:.3e} special-function operations, {n_bytes} bytes); "
            f"{floor_note(census, scanned(seg, px, py, alive, active))} "
            f"({card})")
    torch.cuda.synchronize()

    lap("phase 7")
    # -- phase 7: main paths, configs #2 and #3 ------------------------------
    for label, with_obstacles, steps in (("config #2", False, CUT_STEPS),
                                         ("config #3", True, MAIN_STEPS)):
        scene, params, cfg, state = benchmark_bundle(
            N, with_borders=True, with_obstacles=with_obstacles,
            num_steps_hint=STEPS, device=dev)
        expect = dict(zero, pair_force_sym=steps, env_exp=steps,
                      env_moussaid=2 * steps if with_obstacles else 0)
        counts, step_ms[label] = drive(f"phase 7 {label}", scene, params, cfg,
                                       state, steps, expect)
        if with_obstacles:
            launches["env_exp"] = counts["env_exp"]
            launches["env_moussaid"] = counts["env_moussaid"]
            profile_steps(scene, params, cfg, state, step_ms[label],
                          f"phase 7 {label}")

    lap("phase 8")
    # -- phase 8: config #3 end to end, kernels vs plain versions ------------
    t0 = time.perf_counter()
    _, rec_plain = stepper.make_rollout_fn(scene, params, plain_cfg(cfg),
                                           PARITY_STEPS)(state)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    check_rollout("phase 8 config #3", scene, params, cfg, state, rec_plain,
                  free_limit=False)
    say(f"phase 8 plain-path rollout, config #3: "
        f"{N * PARITY_STEPS / plain_s:.1f} agent-steps/s over "
        f"{PARITY_STEPS} steps ({card})")

    lap("phase 9")
    # -- phase 9: the cutoff kernels against the plain version -------------
    cut_worst, cut = cutoff_kernel_checks(dev, card)
    worst.update(cut_worst)
    torch.cuda.synchronize()

    lap("phase 10")
    # -- phase 10: main paths, config #1 with the 30 m cutoff ----------------
    # below the gate (N = 10k) the static grids with the box test, above it
    # (50k, 1M) the survivor-table kernels
    for n_c, steps, symmetric, name in (
            (N, CUT_STEPS, True, "pair_force_sym_cutoff"),
            (N, CUT_STEPS, False, "pair_force_dense_cutoff"),
            (CUT_N, CUT_STEPS, True, "pair_force_sym_compact"),
            (CUT_N, CUT_STEPS, False, "pair_force_compact"),
            (CUT_BIG_N, CUT_BIG_STEPS, True, "pair_force_sym_compact")):
        scene, params, cfg, state = benchmark_bundle(n_c, device=dev)
        cfg = dataclasses.replace(cfg, interaction_cutoff=CUTOFF_M,
                                  symmetric_pairs=symmetric)
        label = (f"phase 10 config #1 + {CUTOFF_M:g} m cutoff, N={n_c}, via "
                 f"{name}")
        with ClockSampler() as clocks:
            counts, step_ms[label] = drive(label, scene, params, cfg, state,
                                           steps, dict(zero, **{name: steps}))
            if symmetric and n_c != N:
                profile_steps(scene, params, cfg, state, step_ms[label],
                              label)
        say(f"{label}: {clocks.summary()}")
        if n_c != CUT_BIG_N:
            launches[name] = counts[name]
        if n_c != N:
            # the kernel of the path's first step timed alone, right after
            from carla_social_force_model_tpu_torch.models.spawn import (
                apply_spawn)
            st = apply_spawn(state, scene.spawn, 0)
            one = device_ms(lambda: cuda_forces.pedestrian_force_sorted(
                st.pos_x, st.pos_y, st.vel_x, st.vel_y, st.radius, st.alive,
                params.pedestrian, CUTOFF_M, symmetric=symmetric),
                "pair_force_" + ("sym" if symmetric else "dense") + "_kernel",
                reps=5)
            say(f"{label}: its step-0 pair force alone, {one:.4f} ms of "
                f"kernel on the device ({card})")

    lap("phase 11")
    # -- phase 11: end to end with the cutoff, kernels vs plain versions -----
    # an explicit table width forces the compacted kernels at N = 10k
    for label, kw, forms in (
            ("config #1", {}, (("pair_force_sym_compact", True),
                               ("pair_force_compact", False))),
            ("config #3", dict(with_borders=True, with_obstacles=True,
                               num_steps_hint=PARITY_STEPS),
             (("pair_force_sym_compact", True),))):
        scene, params, cfg, state = benchmark_bundle(N, device=dev, **kw)
        for name, symmetric in forms:
            kcfg = dataclasses.replace(
                cfg, interaction_cutoff=CUTOFF_M, symmetric_pairs=symmetric,
                pair_max_surv=FORCED_MAX_SURV)
            _, rec_plain = stepper.make_rollout_fn(
                scene, params, plain_cfg(kcfg), PARITY_STEPS)(state)
            torch.cuda.synchronize()
            reset_counts()
            check_rollout(f"phase 11 {label} + {CUTOFF_M:g} m cutoff via "
                          f"{name} (max_surv {FORCED_MAX_SURV})", scene,
                          params, kcfg, state, rec_plain,
                          free_limit=label == "config #1")
            counts = read_counts()
            if counts[name] != PARITY_STEPS:
                fail(f"phase 11 {label}: {name} launched {counts[name]} "
                     f"times in {PARITY_STEPS} steps")

    lap("phase 12")
    # -- phase 12: the compacted environment kernels at their paths' shapes -
    comp_worst, comp = env_compact_checks(dev, card)
    worst.update(comp_worst)
    torch.cuda.synchronize()

    lap("phase 13")
    # -- phase 13: the urban main path (BASELINE config #4) ------------------
    from carla_social_force_model_tpu_torch.api.synthetic import urban_bundle
    scene, params, cfg, state = urban = urban_bundle(
        N, num_steps_hint=STEPS, device=dev)
    urban_record_checks(scene, params, cfg, state, card)
    counts, step_ms["urban"] = drive(
        "phase 13 urban (BASELINE config #4)", scene, params, cfg, state,
        CUT_STEPS, dict(zero, pair_force_sym=CUT_STEPS,
                        env_exp_compact=CUT_STEPS, env_moussaid=CUT_STEPS),
        all_alive=False)
    launches["env_exp_compact"] = counts["env_exp_compact"]
    profile_steps(scene, params, cfg, state, step_ms["urban"],
                  "phase 13 urban")

    lap("phase 14")
    # -- phase 14: the urban path and config #3 + env_compact, step by step --
    t0 = time.perf_counter()
    _, (rec_plain, _) = stepper.make_rollout_fn(
        scene, params, plain_cfg(cfg), PARITY_STEPS)(state)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    reset_counts()
    check_rollout("phase 14 urban", scene, params, cfg, state, rec_plain,
                  free_limit=False)
    expect_counts("phase 14 urban", zero, pair_force_sym=PARITY_STEPS,
                  env_exp_compact=PARITY_STEPS, env_moussaid=PARITY_STEPS)
    say(f"phase 14 plain-path rollout, urban: "
        f"{N * PARITY_STEPS / plain_s:.1f} agent-steps/s over "
        f"{PARITY_STEPS} steps ({card})")
    scene, params, cfg, state = benchmark_bundle(
        N, with_borders=True, with_obstacles=True, num_steps_hint=STEPS,
        device=dev)
    cfg = dataclasses.replace(cfg, env_compact=True)
    counts, step_ms["config #3 compact"] = drive(
        "phase 14 config #3 + env_compact", scene, params, cfg, state,
        C3_COMPACT_STEPS, dict(zero, pair_force_sym=C3_COMPACT_STEPS,
                               env_exp_compact=C3_COMPACT_STEPS,
                               env_moussaid_compact=C3_COMPACT_STEPS,
                               env_moussaid=C3_COMPACT_STEPS))
    launches["env_moussaid_compact"] = counts["env_moussaid_compact"]
    _, rec_plain = stepper.make_rollout_fn(scene, params, plain_cfg(cfg),
                                           PARITY_STEPS)(state)
    torch.cuda.synchronize()
    reset_counts()
    check_rollout("phase 14 config #3 + env_compact", scene, params, cfg,
                  state, rec_plain, free_limit=False)
    expect_counts("phase 14 config #3 + env_compact", zero,
                  pair_force_sym=PARITY_STEPS, env_exp_compact=PARITY_STEPS,
                  env_moussaid_compact=PARITY_STEPS,
                  env_moussaid=PARITY_STEPS)

    lap("phase 15")
    # -- phase 15: the family kernels against their plain versions ----------
    fam_worst, fam = family_kernel_checks(dev, card)
    worst.update(fam_worst)
    torch.cuda.synchronize()

    # -- phases 16 and 17: the family main paths, then step by step ---------
    family_paths(dev, zero, drive, profile_steps, step_ms, launches)

    lap("phase 18")
    # -- phase 18: the ORCA slice's kernels against their plain versions ----
    orca_worst, orc = orca_kernel_checks(dev, card, urban)
    worst.update(orca_worst)
    torch.cuda.synchronize()

    # -- phases 19 and 20: the ORCA main paths, then step by step -----------
    orca_paths(dev, zero, drive, profile_steps, step_ms, launches, card,
               urban)

    lap("phase 21")
    # -- phase 21: the chunk scan against its plain version ------------------
    town = town_crowd(dev)
    scn_worst, scn = scenario_kernel_checks(dev, card, town)
    worst.update(scn_worst)
    torch.cuda.synchronize()

    # -- phases 22 and 23: the shipped scenarios and the Town02 crowd -------
    scenario_paths(dev, zero, drive, profile_steps, step_ms, launches, card,
                   town)

    lap("phase 24")
    # -- phase 24: the agent-sharding kernels against their plain versions -
    shard_worst, shard = shard_kernel_checks(dev, card)
    worst.update(shard_worst)
    torch.cuda.synchronize()

    # -- phases 25 and 26: the sharded main paths, then the rest of the step
    shard_paths(dev, zero, card, step_ms, launches, urban)

    # -- phases 27-29: ensembles and sweeps (BASELINE config #5) -----------
    batched = batch_phases(dev, zero, card, launches, worst, profile_steps)

    lap("the kernels line")
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
        *((name, csrc + "pair_forces.cu",
           "carla_social_force_model_tpu/ops/pallas_forces.py:" + line,
           cut[name]["ms"], cut[name]["plain_ms"], cut[name]["bound"])
          for name, line in (("pair_force_dense_cutoff", "162"),
                             ("pair_force_sym_cutoff", "239"),
                             ("pair_force_compact", "205"),
                             ("pair_force_sym_compact", "239"))),
        *((name, csrc + "env_forces.cu",
           "carla_social_force_model_tpu/ops/pallas_env.py:" + line,
           comp[name]["ms"], comp[name]["plain_ms"], comp[name]["bound"])
          for name, line in (("env_exp_compact", "297"),
                             ("env_moussaid_compact", "327"))),
        *((name, csrc + "pair_forces.cu",
           "carla_social_force_model_tpu/ops/pallas_forces.py:"
           + ("462" if law == "powerlaw" else "528"),
           fam[name]["ms"], fam[name]["plain_ms"], fam[name]["bound"])
          for name, (law, _, _) in FAMILY_FORMS.items()),
        *((name, csrc + source, "carla_social_force_model_tpu/ops/" + line,
           orc[name]["ms"], orc[name]["plain_ms"], orc[name]["bound"])
          for name, source, line in (
              ("env_exp_analytic", "env_forces.cu", "pallas_env.py:235"),
              ("env_exp_analytic_compact", "env_forces.cu",
               "pallas_env.py:297"),
              ("seg_topk", "statics.cu", "pallas_statics.py:111"),
              ("chunk_topk", "statics.cu", "pallas_statics.py:137"),
              ("chunk_closest", "statics.cu", "geometry.py:214"))),
        ("chunk_argmin", csrc + "statics.cu",
         "carla_social_force_model_tpu/ops/geometry.py:117", scn["ms"],
         scn["plain_ms"], scn["bound"]),
        *((name, csrc + source, "carla_social_force_model_tpu/ops/" + line,
           shard[name]["ms"], shard[name]["plain_ms"], shard[name]["bound"])
          for name, source, line in (
              ("pair_force_sym_dense", "pair_forces.cu",
               "pallas_forces.py:296"),
              ("pair_force_sym_dense_cutoff", "pair_forces.cu",
               "pallas_forces.py:296"),
              ("ring_force", "ring.cu", "pallas_ring.py:65"))),
        *((name, csrc + ("env_forces.cu" if name.startswith("env")
                         else "pair_forces.cu"), replaces, ms, p_ms, bnd)
          for name, (replaces, ms, p_ms, bnd) in batched.items()),
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


def expect_counts(label, zero, **expect):
    """Fail unless the launch counts since the last reset are ``expect``
    exactly (every other kernel 0)."""
    from carla_social_force_model_tpu_torch.ops import cuda_env, cuda_forces
    counts = read_counts()
    if counts != dict(zero, **expect):
        fail(f"{label} launched {counts}, expected {dict(zero, **expect)}")
    say(f"{label}: launches {counts}")


def urban_record_checks(scene, params, cfg, state, card):
    """Phase 13: a recorded run of the urban main path whose record shows
    that the gap and hazard paths ran (walkers reached CHECKING_TRAFFIC and
    CROSSING_ROAD, vehicles braked) and whose positions stay finite."""
    import torch
    from carla_social_force_model_tpu_torch.models import modes, stepper
    label = "phase 13 urban (BASELINE config #4)"
    t0 = time.perf_counter()
    final, (rec, veh) = stepper.make_rollout_fn(scene, params, cfg,
                                                STEPS)(state)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    if not (torch.isfinite(final.pos_x).all()
            and torch.isfinite(final.pos_y).all()
            and torch.isfinite(rec.pos).all()):
        fail(f"{label}: non-finite positions")
    # a record is taken after gap acceptance: a walker whose gap is
    # accepted at once goes from WALKING_SIDEWALK in one record to
    # CROSSING_ROAD in the next, through CHECKING_TRAFFIC in between; one
    # seen in CHECKING_TRAFFIC waited at the curb for a vehicle
    alive, mode = rec.alive, rec.mode
    waited = ((mode == modes.CHECKING_TRAFFIC) & alive).any(dim=0)
    through = ((mode[:-1] == modes.WALKING_SIDEWALK)
               & (mode[1:] == modes.CROSSING_ROAD) & alive[1:]).any(dim=0)
    checking = waited | through
    crossing = ((mode == modes.CROSSING_ROAD) & alive).any(dim=0)
    fleet = scene.autopilot
    slowed = (veh.active[1:] & veh.active[:-1]
              & (veh.speed[1:] < veh.speed[:-1]))            # (T-1, V)
    below = slowed & (veh.speed[1:] < fleet.target_speed[None, :])
    n_braked = int(below.any(dim=0).sum())
    n_alive = int(final.alive.sum())
    n_gone = int((final.spawned & ~final.alive).sum())
    say(f"{label} record: alive at the end {n_alive}, despawned "
        f"{n_gone}, of {state.capacity}; pedestrians that reached "
        f"CHECKING_TRAFFIC {int(checking.sum())} (of them waited at the "
        f"curb {int(waited.sum())}), CROSSING_ROAD "
        f"{int(crossing.sum())}; vehicles {fleet.num_vehicles}, of which "
        f"{n_braked} braked below their target speed "
        f"({int(below.sum())} braking vehicle-steps); recorded run "
        f"{first_s:.3f} s ({card})")
    if int(checking.sum()) == 0 or int(crossing.sum()) == 0:
        fail(f"{label}: no pedestrian reached CHECKING_TRAFFIC or "
             f"CROSSING_ROAD (the gap-acceptance path did not run)")
    if n_braked == 0:
        fail(f"{label}: no vehicle ever braked (the hazard path did not "
             f"run)")


def env_compact_checks(dev, card):
    """Phase 12: the compacted environment kernels at their paths' shapes:
    ``env_exp_compact`` on the urban borders around the spawned urban crowd
    at N = 10,000 (Hilbert-sorted, 10% dead, crossing pedestrians), and
    ``env_moussaid_compact`` on config #3's parked cars.  Each against its
    plain version (both radius modes) and against the dense kernel bitwise
    with the auto table, a fitting one and one slot (every block with two
    or more groups overflows); survivors per block; device times of the
    dense and compacted kernels and of the plan; bounds from the in-filter
    pairs.  Returns ``(worst, results)``."""
    import dataclasses
    import torch
    from carla_social_force_model_tpu_torch.api.synthetic import (
        benchmark_bundle, urban_bundle)
    from carla_social_force_model_tpu_torch.models import (autopilot, modes,
                                                           stepper)
    from carla_social_force_model_tpu_torch.models.spawn import apply_spawn
    from carla_social_force_model_tpu_torch.ops import (cuda_env, env_grid,
                                                        forces)
    worst, results = {}, {}

    scene, params, cfg, state = urban_bundle(N, num_steps_hint=STEPS,
                                             device=dev)
    scene = stepper.prepare_scene(scene)
    planes, ustate = sorted_env_state(apply_spawn(state, scene.spawn, 0),
                                     21)
    n_cross = int((ustate.mode == modes.CROSSING_ROAD).sum())
    # the fused terms of an urban step (one sort, the table, the crossing
    # rule) against the plain terms, with the fleet as it moved at step 0
    fleet = scene.autopilot
    ap = autopilot.autopilot_step(
        fleet, fleet.initial_state(), (ustate.pos_x, ustate.pos_y),
        (ustate.vel_x, ustate.vel_y), ustate.alive, 0, cfg.dt)
    snap = autopilot.autopilot_snapshot(fleet, ap)
    fused = cuda_env.fused_environment_terms(ustate, scene, params, snap,
                                             compact=True)
    plain = stepper.force_terms(
        ustate, scene, params, dataclasses.replace(cfg, plain_env_force=True),
        snap)
    for name, got in fused.items():
        got, want = torch.stack(got), torch.stack(plain[name])
        err = (got - want).abs()
        say(f"phase 12 fused urban {name}, N={N} with crossing and dead "
            f"agents: max abs err {err.max().item():.3e}")
        if bool((err > ENV_ATOL + ENV_RTOL * want.abs()).any()):
            fail(f"fused urban {name} disagrees with the plain force term")
    b = params.border
    cases = {"env_exp_compact": ("urban borders", scene.borders_seg, None,
                                 (b.a, b.b))}
    scene3, params3, cfg3, state3 = benchmark_bundle(
        N, with_borders=True, with_obstacles=True, num_steps_hint=STEPS,
        device=dev)
    scene3 = stepper.prepare_scene(scene3)
    state3, _ = stepper.rollout(state3, scene3, params3, cfg3, 1,
                                record=False)
    planes3, _ = sorted_env_state(state3, 22)
    cases["env_moussaid_compact"] = (
        "config #3 parked cars", scene3.static_obstacles_seg,
        scene3.static_obstacle_vel, params3.static_obstacle)
    say(f"phase 12 urban crowd: N={N} spawned, "
        f"{int((~planes[5]).sum())} dead, {n_cross} in CROSSING_ROAD")

    for name, (what, seg, ovel, prm) in cases.items():
        pl = planes if name == "env_exp_compact" else planes3
        px, py, vx, vy, rad, alive = pl
        moussaid = name == "env_moussaid_compact"

        def call(grid, use_radius, plain=False):
            if moussaid:
                args = (px, py, vx, vy, rad, alive, seg, ovel, prm)
                if plain:
                    return forces.env_moussaid_force(*args,
                                                     use_radius=use_radius)
                if grid is None:
                    return cuda_env.env_moussaid(*args, use_radius=use_radius)
                return cuda_env.env_moussaid_compact(*args, grid,
                                                     use_radius=use_radius)
            args = (px, py, rad, alive, seg, *prm)
            if plain:
                return forces.env_exp_force(*args, use_radius=use_radius)
            if grid is None:
                return cuda_env.env_exp(*args, use_radius=use_radius)
            return cuda_env.env_exp_compact(*args, grid,
                                            use_radius=use_radius)

        engage, group, ms = env_grid.env_gate(
            seg.num_segments, seg.points_per_segment, True, 0)
        if not engage:
            fail(f"phase 12 {what}: the gate does not engage the table")
        r2 = cuda_env.filter_r2(seg)
        hits = env_grid.group_hits(env_grid.block_boxes(px, py, alive),
                                   seg.center_x, seg.center_y, r2, group)
        per_block = hits.sum(dim=1)
        c = per_block.float()
        say(f"phase 12 {name} ({what}, {seg.num_segments} sections x "
            f"{seg.points_per_segment} slots, groups of {group}): groups "
            f"per block mean {c.mean().item():.2f}, max "
            f"{int(per_block.max())}, of {hits.shape[1]} groups; "
            f"{hits.shape[0]} blocks; auto table width {ms}, blocks over it "
            f"{int((per_block > ms).sum())}")
        grids = {f"auto ({ms})": env_grid.env_grid(px, py, alive, seg, r2,
                                                   group, ms),
                 "fitting": env_grid.env_grid(
                     px, py, alive, seg, r2, group,
                     max(int(per_block.max()), 1)),
                 "max_surv=1": env_grid.env_grid(px, py, alive, seg, r2,
                                                 group, 1)}
        worst[name] = 0.0
        for use_radius in (False, True):
            want = torch.stack(call(None, use_radius, plain=True))
            dense = torch.stack(call(None, use_radius))
            for label, g in grids.items():
                got = torch.stack(call(g, use_radius))
                torch.cuda.synchronize()
                err = (got - want).abs()
                say(f"phase 12 {name} table {label} use_radius="
                    f"{use_radius}: max abs err {err.max().item():.3e}, max "
                    f"|f| {want.abs().max().item():.3e}, tolerance "
                    f"{ENV_ATOL:g} + {ENV_RTOL:g}*|f|")
                if not torch.isfinite(got).all():
                    fail(f"{name} returned non-finite forces")
                if bool((err > ENV_ATOL + ENV_RTOL * want.abs()).any()):
                    fail(f"{name} ({label}) disagrees with the plain "
                         f"version")
                if bool((got[:, ~alive] != 0).any()):
                    fail(f"{name}: dead agents' forces are not exactly zero")
                if not torch.equal(got, dense):
                    fail(f"{name} ({label}) differs from the dense kernel "
                         f"bitwise")
                worst[name] = max(worst[name], err.max().item())
        say(f"phase 12 {name}: equal to the dense kernel bitwise with every "
            f"table, both radius modes")
        auto = grids[f"auto ({ms})"]

        def plan():
            return env_grid.env_grid(px, py, alive, seg,
                                     cuda_env.filter_r2(seg), group, ms)

        ms_k = device_ms(lambda: call(auto, False), "env_force_kernel")
        dense_ms = device_ms(lambda: call(None, False), "env_force_kernel")
        plan_ms = device_ms(plan, "")
        plan_ev = cuda_ms(plan)
        plain_ms = cuda_ms(lambda: call(None, False, plain=True), reps=3)
        n_bytes, ops, mufu, pairs = env_work(seg, px, py, alive, None,
                                             moussaid)
        n_bytes += 4 * (auto.surv.numel() + auto.counts.numel())
        bnd = bound(n_bytes, ops, mufu)
        census = ("env_force<moussaid, kTable, kSampled>" if moussaid
                  else "env_force<exp, kTable, kSampled>")
        say(f"phase 12 time {name} ({what}), N={N}: compacted kernel "
            f"{ms_k:.4f} ms, dense kernel {dense_ms:.4f} ms on the device; "
            f"plan (boxes, hits, table) {plan_ms:.4f} ms of device kernels, "
            f"{plan_ev:.4f} ms with its launches (CUDA events); plain "
            f"{plain_ms:.4f} ms; bound {bnd[0]:.6f} ms ({bnd[1]}; {pairs} "
            f"in-filter pairs, {ops:.3e} operations, {mufu:.3e} "
            f"special-function operations, {n_bytes} bytes); "
            f"{floor_note(census, scanned(seg, px, py, alive))} ({card})")
        results[name] = dict(ms=ms_k, plain_ms=plain_ms, bound=bnd)
    return worst, results


def plain_cfg(cfg):
    """``cfg`` with every kernel replaced by its plain version."""
    import dataclasses
    return dataclasses.replace(cfg, plain_pair_force=True,
                               plain_env_force=True)


def one_step_walk(scene, params, cfg, state, steps):
    """The kernels' rollout of ``steps`` steps of a prepared scene, and from
    each of its states the plain versions' step (with a reactive fleet, from
    the kernels' own fleet state too).  Yields ``(k, s, nxt, ref, rec,
    fleet_equal)``: the state ``s`` before step k, the kernels' and the
    plain versions' next states, the kernels' record, and whether both
    fleet states agree."""
    import torch
    from carla_social_force_model_tpu_torch.models import stepper
    ref_cfg = plain_cfg(cfg)
    fleet = scene.autopilot
    ap = fleet.initial_state() if fleet is not None else None
    s = state
    for k in range(steps):
        fleet_equal = True
        if fleet is None:
            nxt, rec = stepper.simulation_step(s, scene, params, cfg, k)
            ref, _ = stepper.simulation_step(s, scene, params, ref_cfg, k)
        else:
            nxt, ap_k, rec = stepper.fleet_tick(s, ap, scene, params, cfg, k)
            ref, ap_r, _ = stepper.fleet_tick(s, ap, scene, params, ref_cfg,
                                              k)
            fleet_equal = all(torch.equal(getattr(ap_k, f), getattr(ap_r, f))
                              for f in ap_k.__dataclass_fields__)
            ap = ap_k
        yield k, s, nxt, ref, rec, fleet_equal
        s = nxt


def step_gap(nxt, ref):
    """Per-agent L-inf distance of two states' positions."""
    import torch
    return torch.maximum((nxt.pos_x - ref.pos_x).abs(),
                         (nxt.pos_y - ref.pos_y).abs())


def worst_agent_note(scene, params, cfg, k, s, nxt, ref):
    """Who set a step's one-step error: the agent whose position differs
    most between the kernels' step ``nxt`` and the plain versions' ``ref``
    from the state ``s`` of step k; its position and nearest neighbour, its
    net pair force through the kernels and the plain versions on ``s``,
    sum_j |f_ij| of its Moussaid pair forces (plain, pair by pair) with the
    float32 ulp of that sum, and whether the speed cap bound its velocity
    in either step.  Uncapped, a force difference df moves the position by
    dt^2 |df|; capped at v_max, by about dt v_max |df| / |F| (the
    direction turns)."""
    import torch
    from carla_social_force_model_tpu_torch.models import stepper
    from carla_social_force_model_tpu_torch.models.spawn import apply_spawn
    from carla_social_force_model_tpu_torch.ops import forces
    gap = step_gap(nxt, ref)
    i = int(gap.argmax())
    st = apply_spawn(s, scene.spawn, k)
    dist = torch.hypot(st.pos_x - st.pos_x[i], st.pos_y - st.pos_y[i])
    dist[i] = float("inf")
    dist[~st.alive] = float("inf")
    j = int(dist.argmin())
    note = (f"step {k}: agent {i} at ({st.pos_x[i].item():.6f}, "
            f"{st.pos_y[i].item():.6f}), gap {gap[i].item():.3e} m, nearest "
            f"alive agent {j} at {dist[j].item():.5f} m")
    # the callers count the launches of the rollout: these do not count
    saved = [dict(m.LAUNCHES) for m in kernel_modules()]
    kt = stepper.force_terms(st, scene, params, cfg)
    for m, launches in zip(kernel_modules(), saved):
        m.LAUNCHES.update(launches)
    pt = stepper.force_terms(st, scene, params, plain_cfg(cfg))
    for name in ("pedestrian_force", "powerlaw_force",
                 "ped_repulsive_force"):
        if name not in kt:
            continue
        fk = (kt[name][0][i].item(), kt[name][1][i].item())
        fp = (pt[name][0][i].item(), pt[name][1][i].item())
        df = ((fk[0] - fp[0]) ** 2 + (fk[1] - fp[1]) ** 2) ** 0.5
        note += (f"; {name} kernels ({fk[0]:.7g}, {fk[1]:.7g}), plain "
                 f"({fp[0]:.7g}, {fp[1]:.7g}), |df| {df:.4g}, |F| "
                 f"{(fp[0] ** 2 + fp[1] ** 2) ** 0.5:.6g}")
    if params.enable_pedestrian:
        ok = st.alive & st.alive[i]
        ok[i] = False
        if cfg.interaction_cutoff is not None:
            ok = ok & (dist <= float(cfg.interaction_cutoff))
        rsub = (st.radius[i] + st.radius) if params.use_ped_radius else 0.0
        fx, fy = forces._moussaid_pair_force(
            st.pos_x - st.pos_x[i], st.pos_y - st.pos_y[i], rsub,
            st.vel_x[i] - st.vel_x, st.vel_y[i] - st.vel_y,
            params.pedestrian, ok)
        mag = torch.hypot(fx, fy)
        total = float(mag.double().sum())
        ulp = 2.0 ** (math.floor(math.log2(max(total, 1e-30))) - 23)
        note += (f"; sum_j |f_ij| {total:.6g} over {int((mag > 0).sum())} "
                 f"pairs (largest {mag.max().item():.6g}), ulp of the sum "
                 f"{ulp:.3g}, dt^2 ulp {cfg.dt ** 2 * ulp:.3g} m")
    vmax = (torch.where(st.alive, st.fsm_target, st.applied_target)[i].item()
            * params.max_speed_factor)
    for tag, q in (("kernels", nxt), ("plain", ref)):
        speed = torch.hypot(q.vel_x[i], q.vel_y[i]).item()
        capped = speed >= vmax * (1.0 - 1e-5)
        note += (f"; {tag} speed {speed:.6f} of v_max {vmax:.6f} "
                 f"({'capped' if capped else 'not capped'})")
    return note


def check_rollout(label, scene, params, cfg, state, rec_plain, free_limit):
    """The kernels' PARITY_STEPS-step rollout against the plain versions'.

    At every step the plain versions step again from the kernels' own state
    (with a reactive fleet, the kernels' own fleet state too) and must land
    within POS_STEP_TOL_M of the kernels' step, with equal modes and alive
    masks (and an equal fleet state) and finite positions: the one-step
    error, which no earlier difference can amplify.  The agent of the
    worst step is named (``worst_agent_note``).  The free-running distance
    to the plain rollout ``rec_plain`` is printed, and, where
    ``free_limit``, held to POS_TOL_M with equal modes and alive masks."""
    import torch
    from carla_social_force_model_tpu_torch.models import stepper
    scene = stepper.prepare_scene(scene, analytic=cfg.env_analytic,
                                  orca=params.enable_orca,
                                  chunked=cfg.env_chunked)
    one, free, free_modes, worst = [], [], 0, None
    for k, s, nxt, ref, rec, fleet_equal in one_step_walk(
            scene, params, cfg, state, PARITY_STEPS):
        if not fleet_equal:
            fail(f"{label}: step {k} from the same state gives another "
                 f"fleet state through the kernels than through the "
                 f"plain versions")
        one.append(step_gap(nxt, ref).max().item())
        if worst is None or one[-1] > one[worst[0]]:
            worst = (k, s, nxt, ref)
        if not (torch.equal(nxt.alive, ref.alive)
                and torch.equal(nxt.mode, ref.mode)):
            fail(f"{label}: step {k} from the same state gives other modes "
                 f"or alive masks through the kernels than through the "
                 f"plain versions")
        if not (torch.isfinite(nxt.pos_x).all()
                and torch.isfinite(nxt.pos_y).all()):
            fail(f"{label}: non-finite positions after step {k}")
        free.append(max(
            (rec.pos_x - rec_plain.pos[k, :, 0]).abs().max().item(),
            (rec.pos_y - rec_plain.pos[k, :, 1]).abs().max().item()))
        free_modes += int((rec.mode != rec_plain.mode[k]).sum()
                          + (rec.alive != rec_plain.alive[k]).sum())
    say(f"{label} one-step position L-inf kernels vs plain from the same "
        f"state, steps 1..{PARITY_STEPS} (limit {POS_STEP_TOL_M:g} m): "
        + " ".join(f"{v:.2e}" for v in one))
    say(f"{label} worst one-step agent, "
        + worst_agent_note(scene, params, cfg, *worst))
    say(f"{label} free-running position L-inf kernels vs plain, steps "
        f"1..{PARITY_STEPS} ("
        + (f"limit {POS_TOL_M:g} m" if free_limit else "printed only") + "): "
        + " ".join(f"{v:.2e}" for v in free)
        + f"; {free_modes} (step, agent) cells with other modes or alive")
    if max(one) > POS_STEP_TOL_M:
        fail(f"{label}: one-step position L-inf {max(one):.3e} m exceeds "
             f"{POS_STEP_TOL_M} m")
    if free_limit and (max(free) > POS_TOL_M or free_modes):
        fail(f"{label}: free-running position L-inf {max(free):.3e} m "
             f"(limit {POS_TOL_M} m), {free_modes} cells with other modes "
             f"or alive")


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
