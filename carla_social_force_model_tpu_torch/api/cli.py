"""Command-line entry point (port of api/cli.py: the reference's
run_simulation.py CLI surface).

Headless: the whole rollout runs on the card (``--platform cpu``: on the
CPU, through the plain PyTorch versions) with no real-time pacing.  Flags
mirror the JAX package's parser (run_simulation.py:243-268 plus headless
extensions, ``--duration``/``--steps``, ``--stream``); the engine flags map
onto the port's step configuration as ``api/scenario.py`` describes.
``--checkpoint-dir``/``--checkpoint-every``/``--resume`` run the rollout in
segments with an npz snapshot after each (``utils/checkpoint.py``), and
``--profile DIR`` writes a ``torch.profiler`` trace of the run, segmented,
streamed or whole (``utils/profiling.py``).

``--carla`` (with ``--carla-host``/``--carla-port``) attaches the CARLA
bridge (``bridge/carla_bridge.run_with_carla``): the reference's per-tick
sync with a live server and real-time pacing, the SFM core on the card;
``--steps`` bounds its loop (without it the loop runs until interrupted,
as the reference's does).  The bridge takes the scenarios' default engine
and writes no checkpoints or traces, so the engine flags, ``--stream``,
the checkpoint flags and ``--profile`` are refused together with
``--carla``, where the JAX package ignores them.

The TPU launch knobs and the JAX package's orbax checkpoint backend have no
counterpart: they stop the run with a parser error giving the reason, and
another configuration is never run in their place.

    python -m carla_social_force_model_tpu_torch.api.cli \
        --scenario-config configs/scenarios/corridor_counterflow.toml \
        --steps 40 --csv --platform cpu
"""
from __future__ import annotations

import argparse
import contextlib
import logging

log = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Social Force Model simulation (PyTorch/CUDA port)")
    p.add_argument("--scenario-config", type=str, required=True,
                   help="scenario configuration file (reference TOML surface)")
    p.add_argument("--sfm-config", type=str, default=None,
                   help="social force model configuration file")
    p.add_argument("--duration", type=float, default=60.0,
                   help="simulated seconds to roll out (headless)")
    p.add_argument("--steps", type=int, default=None,
                   help="number of steps (overrides --duration)")
    p.add_argument("--csv", action="store_true", help="output csv results")
    p.add_argument("--output", type=str, default="output",
                   help="path for output CSV files")
    p.add_argument("--carla", action="store_true",
                   help="attach the CARLA bridge (requires a CARLA server)")
    p.add_argument("--carla-host", default="127.0.0.1")
    p.add_argument("--carla-port", default=2000, type=int)
    p.add_argument("--strict-parity", action="store_true",
                   help="reproduce reference-inert config keys and quirks")
    p.add_argument("--pallas", action="store_true", default=None,
                   help="the JAX package's Pallas path: the fused "
                        "environment kernels, with --cutoff and the env "
                        "knobs applied")
    p.add_argument("--cutoff", type=float, default=None, metavar="METERS",
                   help="locality-sorted interaction cutoff (see BENCH.md)")
    p.add_argument("--spatial-order", choices=("morton", "hilbert"),
                   default=None,
                   help="space-filling curve for the cutoff sort")
    p.add_argument("--comm", choices=("gather", "ring", "ring_kernel"),
                   default=None,
                   help="column-state communication under agent-sharding "
                        "(StepConfig.axis_comm; one device ignores it)")
    p.add_argument("--exact-div", action="store_true", default=None,
                   help="exact division in the Pallas in-kernel atan2 "
                        "(refused: a TPU launch knob)")
    p.add_argument("--vmem-mb", type=int, default=None,
                   help="Mosaic scoped-VMEM limit for the Pallas kernels "
                        "(refused: a TPU launch knob)")
    p.add_argument("--env-compact", action="store_true", default=None,
                   help="compacted env-kernel grid (best for sparse street-"
                        "network borders, see BENCH.md)")
    p.add_argument("--env-analytic", action="store_true", default=None,
                   help="analytic border geometry: closest point ON Douglas-"
                        "Peucker-simplified segments instead of the "
                        "reference's 0.1 m sampled argmin (~10x less border "
                        "work; deviation bounded by the sampling "
                        "quantization, see PARITY.md/BENCH.md)")
    p.add_argument("--pallas-compact", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="compacted pairwise-kernel grid (takes effect with "
                        "--cutoff; default on -- auto-engages above ~33k "
                        "agents, making the cutoff kernel O(N) at fixed "
                        "density, see BENCH.md)")
    p.add_argument("--symmetric", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="Newton's-third-law pairwise launch: each unordered "
                        "pair computed once (default on; half the pairwise "
                        "work, f32-summation-order equal; single-device)")
    p.add_argument("--stream", action="store_true",
                   help="stream records to CSV in chunks (bounded memory "
                        "for long rollouts; implies --csv)")
    p.add_argument("--chunk-steps", type=int, default=2400,
                   help="segment length for --stream")
    p.add_argument("--record-stride", type=int, default=1,
                   help="record every k-th tick (--stream)")
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="capture a torch.profiler trace of the rollout to "
                        "DIR/trace.json")
    p.add_argument("--checkpoint-dir", type=str, default=None,
                   help="write state snapshots every --checkpoint-every "
                        "steps")
    p.add_argument("--checkpoint-every", type=int, default=200)
    p.add_argument("--checkpoint-backend", choices=("npz", "orbax"),
                   default="npz", help="snapshot format (npz; orbax, the "
                                       "JAX package's, is refused)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest checkpoint in "
                        "--checkpoint-dir")
    p.add_argument("--platform", type=str, default=None, metavar="NAME",
                   help="'cpu' runs on the CPU (the plain PyTorch versions); "
                        "the default is the card")
    p.add_argument("--debug", action="store_true")
    return p


DEFAULT_SFM_CONFIG = {
    "max_speed_multiplier": 1.3,
    "use_ped_radius": False,
    "forces": {"acceleration_force": True, "pedestrian_force": True,
               "border_force": True, "static_obstacle_force": True,
               "dynamic_obstacle_force": True},
}

#: flags the port refuses, with the reason (each is None or False when not
#: given)
REFUSED = {
    "vmem_mb": "a TPU launch knob with no counterpart on the port",
    "exact_div": "a TPU launch knob with no counterpart on the port",
}

#: flags the CARLA bridge has no use for: refused together with --carla
#: (each is None or False when not given)
BRIDGE_REFUSED = {
    "pallas": "an engine flag", "cutoff": "an engine flag",
    "spatial_order": "an engine flag", "comm": "an engine flag",
    "env_compact": "an engine flag", "env_analytic": "an engine flag",
    "pallas_compact": "an engine flag", "symmetric": "an engine flag",
    "stream": "a headless rollout's output mode",
    "checkpoint_dir": "a headless rollout's checkpoints",
    "resume": "a headless rollout's checkpoints",
    "profile": "a headless rollout's trace",
}

#: --platform values and the device each selects
PLATFORMS = {"cpu": "cpu", "cuda": "cuda", "gpu": "cuda"}


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    for name, why in REFUSED.items():
        value = getattr(args, name)
        if value is not None and value is not False:
            parser.error(f"--{name.replace('_', '-')}: {why}")
    if args.checkpoint_backend == "orbax":
        from ..utils.checkpoint import ORBAX_REFUSED
        parser.error(f"--checkpoint-backend orbax: {ORBAX_REFUSED}")
    if args.carla:
        for name, what in BRIDGE_REFUSED.items():
            value = getattr(args, name)
            if value is not None and value is not False:
                parser.error(f"--{name.replace('_', '-')} with --carla: "
                             f"{what}, which the CARLA bridge does not use "
                             f"(it steps the scenarios' default engine, "
                             f"tick by tick)")
    if args.stream and args.checkpoint_dir:
        # the checkpoint path runs the segmented in-memory rollout, which
        # is exactly the unbounded (T, N) record --stream exists to avoid;
        # refuse loudly rather than silently dropping one of the two
        parser.error("--stream and --checkpoint-dir cannot be combined "
                     "(checkpointed rollouts keep records in memory; use "
                     "--record-stride to bound them, or stream without "
                     "checkpoints)")
    if args.resume and not args.checkpoint_dir:
        parser.error("--resume needs --checkpoint-dir (the directory to "
                     "resume from)")
    if args.platform is not None and args.platform not in PLATFORMS:
        parser.error(f"--platform {args.platform}: one of "
                     f"{', '.join(PLATFORMS)} (default: the card)")
    device = PLATFORMS[args.platform or "cuda"]
    logging.basicConfig(format="%(levelname)s: %(message)s",
                        level=logging.DEBUG if args.debug else logging.INFO)

    sfm_config = args.sfm_config if args.sfm_config else dict(DEFAULT_SFM_CONFIG)

    if args.carla:
        from ..bridge.carla_bridge import run_with_carla
        return run_with_carla(args, sfm_config, max_steps=args.steps,
                              device=device)

    from .simulation import Simulation
    sim = Simulation.from_config(
        args.scenario_config, sfm_config,
        duration=args.duration, num_steps=args.steps,
        strict_parity=args.strict_parity, device=device,
        engine={"use_pallas": args.pallas,
                "interaction_cutoff": args.cutoff,
                "spatial_order": args.spatial_order,
                "env_compact": args.env_compact,
                "env_analytic": args.env_analytic,
                "pallas_compact": args.pallas_compact,
                "pallas_symmetric": args.symmetric,
                "axis_comm": args.comm})

    traced = contextlib.nullcontext()
    if args.profile:
        from ..utils.profiling import trace
        traced = trace(args.profile)
    with traced:
        if args.checkpoint_dir:
            from ..utils.checkpoint import (latest_checkpoint, load_state,
                                            run_segmented)
            b = sim.bundle
            state, start, ap = b.initial_state, 0, None
            if args.resume:
                ckpt = latest_checkpoint(args.checkpoint_dir)
                if ckpt:
                    state, start, ap = load_state(ckpt, with_autopilot=True,
                                                  device=device)
                    log.info("resuming from %s (step %d)", ckpt, start)
            final, recs = run_segmented(
                state, b.scene, b.params, b.cfg, b.num_steps - start,
                segment_steps=args.checkpoint_every,
                checkpoint_dir=args.checkpoint_dir, start_step=start,
                autopilot_state=ap, backend=args.checkpoint_backend)
            sim.set_results(final, recs)
        elif args.stream:
            out = sim.run_streamed(args.output, chunk_steps=args.chunk_steps,
                                   record_stride=args.record_stride)
            log.info("final population: %d alive of %d slots",
                     int(sim.final_state.alive.sum()), sim.bundle.capacity)
            log.info("CSV output written to %s", out)
            return 0
        else:
            sim.run()
    alive = int(sim.final_state.alive.sum())
    log.info("final population: %d alive of %d slots", alive,
             sim.bundle.capacity)
    if args.csv:
        out = sim.write_csv(args.output)
        log.info("CSV output written to %s", out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
