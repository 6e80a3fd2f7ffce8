#!/usr/bin/env python3
"""Repeat the checks of ``chip_smoke.py`` whose result can change from run
to run, and print how close each came to failing.

The symmetric pair kernels add each pair's force with atomics, so their f32
sums change order between launches; everything downstream of them (the
recorded rollouts' positions, modes and alive masks) can change too.  This
script runs each such check ``--reps`` times on one CUDA card and prints,
per check, the largest ratio of error to tolerance (a check fails above 1)
and the number of runs in which a recorded rollout's modes or alive masks
differed from the plain version's.  The rollouts are compared free-running
(``rollouts``), which ``chip_smoke.py`` holds to ``POS_TOL_M`` for config
#1 only; ``divergence`` shows, for config #3, the agent and the force terms
of any run that drifts apart.

    python3 tools/torch_smoke_repeat.py --reps 20 [--only rollouts,divergence]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def kernel_checks(dev, reps):
    """Phases 3 and 9: the symmetric kernels against the plain version."""
    import numpy as np
    import torch
    from carla_social_force_model_tpu_torch.models.params import (
        MoussaidParams, moussaid_vector)
    from carla_social_force_model_tpu_torch.ops import cuda_forces, forces
    p = MoussaidParams()
    prm = moussaid_vector(p, dev)

    def ratio(got, want):
        return ((got - want).abs()
                / (cs.ATOL + cs.RTOL * want.abs())).max().item()

    for epsilon, use_radius in ((0.005, False), (0.005, True), (0.0, False),
                                (0.0, True)):
        pe = dataclasses.replace(p, epsilon=epsilon)
        planes = cs.to_planes(*cs.seeded_crowd(cs.N, 7, float(np.sqrt(cs.N))),
                              dev)
        want = torch.stack(forces.pedestrian_force(
            *planes, pe, use_ped_radius=use_radius))
        worst = max(ratio(torch.stack(cuda_forces.pair_force_sym(
            *planes, moussaid_vector(pe, dev), use_radius=use_radius)), want)
            for _ in range(reps))
        cs.say(f"phase 3 pair_force_sym eps={epsilon} use_radius="
               f"{use_radius}: worst error/tolerance {worst:.4f} over {reps}")
    for n in cs.CUT_CHECK_N:
        planes = cs.sorted_crowd(n, 11, dev)
        grids = cs.cutoff_grids(planes)
        for use_radius in (False, True):
            want = torch.stack(forces.pedestrian_force(
                *planes[:5], planes[5], p, use_ped_radius=use_radius,
                cutoff=cs.CUTOFF_M))
            for key in ("sym_cutoff", "sym_compact", "sym_compact overflow"):
                worst = max(ratio(torch.stack(cuda_forces.pair_force_cutoff(
                    *planes[:5], planes[5], prm, grids[key],
                    use_radius=use_radius)), want) for _ in range(reps))
                cs.say(f"phase 9 {key} N={n} use_radius={use_radius}: worst "
                       f"error/tolerance {worst:.4f} over {reps}")


def rollout_checks(dev, reps):
    """Phases 5, 8 and 11: recorded 50-step rollouts through the kernels
    against the same rollouts through the plain versions."""
    import torch
    from carla_social_force_model_tpu_torch.api.synthetic import (
        benchmark_bundle)
    from carla_social_force_model_tpu_torch.models import stepper
    cases = []
    for label, kw in (("config #1", {}),
                      ("config #3", dict(with_borders=True,
                                         with_obstacles=True,
                                         num_steps_hint=cs.PARITY_STEPS))):
        scene, params, cfg, state = benchmark_bundle(cs.N, device=dev, **kw)
        cases.append((f"{label} (phase {5 if not kw else 8})", scene, params,
                      cfg, state))
        for symmetric in ((True, False) if not kw else (True,)):
            cases.append((
                f"{label} + cutoff, symmetric={symmetric} (phase 11)", scene,
                params, dataclasses.replace(
                    cfg, interaction_cutoff=cs.CUTOFF_M,
                    symmetric_pairs=symmetric,
                    pair_max_surv=cs.FORCED_MAX_SURV), state))
    for label, scene, params, cfg, state in cases:
        plain_cfg = dataclasses.replace(cfg, plain_pair_force=True,
                                        plain_env_force=True)
        _, ref = stepper.make_rollout_fn(scene, params, plain_cfg,
                                         cs.PARITY_STEPS)(state)
        changes = int((ref.mode[1:] != ref.mode[:-1]).sum())
        run = stepper.make_rollout_fn(scene, params, cfg, cs.PARITY_STEPS)
        worst, mode_runs, alive_runs, cells = 0.0, 0, 0, 0
        for _ in range(reps):
            _, rec = run(state)
            linf = (rec.pos - ref.pos).abs().max().item()
            worst = max(worst, linf / cs.POS_TOL_M)
            bad = rec.mode != ref.mode
            mode_runs += bool(bad.any())
            cells += int(bad.sum())
            alive_runs += not torch.equal(rec.alive, ref.alive)
        cs.say(f"{label}: worst position error/tolerance {worst:.4f}, runs "
               f"with modes differing {mode_runs} ({cells} cells), with alive "
               f"differing {alive_runs}, of {reps}; {changes} mode changes "
               f"in the plain rollout")


def divergence(dev, reps):
    """Config #3 (phase 8), step by step: each run of the kernels' rollout
    against the plain one.  For a run that drifts past a fifth of
    POS_TOL_M, the agent that ends farthest apart, at the step its gap grew
    most: its force terms through the kernels, through the plain versions
    on the same state, and on the plain trajectory."""
    import torch
    from carla_social_force_model_tpu_torch.api.synthetic import (
        benchmark_bundle)
    from carla_social_force_model_tpu_torch.models import stepper
    scene, params, cfg, state = benchmark_bundle(
        cs.N, device=dev, with_borders=True, with_obstacles=True,
        num_steps_hint=cs.PARITY_STEPS)
    scene = stepper.prepare_scene(scene)
    plain_cfg = dataclasses.replace(cfg, plain_pair_force=True,
                                    plain_env_force=True)
    captured = {}
    force_terms = stepper.force_terms

    def capture(*a, **k):
        terms = force_terms(*a, **k)
        captured["args"] = a
        captured["terms"] = {n: torch.stack(f) for n, f in terms.items()}
        return terms

    stepper.force_terms = capture

    def trajectory(step_cfg):
        s, states, calls = state, [], []
        for k in range(cs.PARITY_STEPS):
            states.append(s)
            s, _ = stepper.simulation_step(s, scene, params, step_cfg, k)
            calls.append((captured["args"], captured["terms"]))
        states.append(s)
        return states, calls

    def gap(a, b):
        return torch.maximum((a.pos_x - b.pos_x).abs(),
                             (a.pos_y - b.pos_y).abs())

    def fmt(f):
        return f"({f[0]:.7g}, {f[1]:.7g})"

    p_states, p_calls = trajectory(plain_cfg)
    for r in range(reps):
        k_states, k_calls = trajectory(cfg)
        gaps = torch.stack([gap(a, b) for a, b in zip(k_states, p_states)])
        worst = gaps.max().item()
        i = int(gaps[-1].argmax())
        row = gaps[:, i]
        k = int((row[1:] - row[:-1]).argmax())  # step k moved it most
        cs.say(f"run {r}: free-running L-inf {worst:.3e} m; agent {i} "
               f"moved apart most in step {k}: {row[k].item():.3e} -> "
               f"{row[k + 1].item():.3e} m")
        if worst <= 2 * cs.POS_TOL_M / 10:
            continue
        cs.say("    gap of agent %d by step: %s" % (i, " ".join(
            f"{v:.2e}" for v in row.tolist())))
        args, k_terms = k_calls[k]
        s = args[0]
        # the plain terms on the kernels' own state of that step, and the
        # plain trajectory's terms of the same step
        on_same = {n: torch.stack(f) for n, f in force_terms(
            s, args[1], args[2], plain_cfg, *args[4:]).items()}
        p_terms = p_calls[k][1]
        others = torch.hypot(s.pos_x - s.pos_x[i], s.pos_y - s.pos_y[i])
        others[i] = float("inf")
        others[~s.alive] = float("inf")
        j = int(others.argmin())
        ps = p_calls[k][0][0]
        cs.say(f"    step {k}, kernels' state: agent {i} at "
               f"({s.pos_x[i].item():.6f}, {s.pos_y[i].item():.6f}), plain "
               f"trajectory's at ({ps.pos_x[i].item():.6f}, "
               f"{ps.pos_y[i].item():.6f}); mode {int(s.mode[i])} / "
               f"{int(ps.mode[i])}, velocity ({s.vel_x[i].item():.5f}, "
               f"{s.vel_y[i].item():.5f}), nearest agent {j} at "
               f"{others[j].item():.5f} m")
        for name in k_terms:
            cs.say(f"    {name}: kernels {fmt(k_terms[name][:, i].tolist())}"
                   f", plain on the same state "
                   f"{fmt(on_same[name][:, i].tolist())}, plain trajectory "
                   f"{fmt(p_terms[name][:, i].tolist())}")
    stepper.force_terms = force_terms


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", default="kernels,rollouts,divergence",
                    help="comma-separated parts to run")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        cs.fail("this script needs a CUDA card")
    dev = torch.device("cuda", 0)
    parts = args.only.split(",")
    if "kernels" in parts:
        kernel_checks(dev, args.reps)
    if "rollouts" in parts:
        rollout_checks(dev, args.reps)
    if "divergence" in parts:
        divergence(dev, args.reps)


if __name__ == "__main__":
    main()
