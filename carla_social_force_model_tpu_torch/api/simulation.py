"""High-level headless simulation API (port of api/simulation.py).

``Simulation`` is the headless counterpart of the reference's
``simulation_loop`` + ``SimulationRunner`` (run_simulation.py:17-229): build
everything from the two TOML documents (``api/scenario.build_scenario``),
run the whole rollout on the device (the eager step loop of
``models/stepper.rollout``; the kernels on a card), and optionally dump the
reference-schema CSVs.  There is no real-time pacing: the rollout runs as
fast as the card allows.
"""
from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from ..models.autopilot import records_to_vehicle_states
from ..models.spawn import apply_spawn
from ..models.stepper import (StepRecord, force_terms, make_rollout_fn,
                              prepare_scene, rollout)
from ..models.vehicles import vehicle_snapshot_at
from ..utils import csvout
from ..utils.config import load_config
from ..utils.device import DEFAULT_DEVICE
from .scenario import ScenarioBundle, build_scenario

log = logging.getLogger(__name__)


def _synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Simulation:
    """One headless scenario rollout."""

    def __init__(self, bundle: ScenarioBundle, record: bool = True):
        self.bundle = bundle
        self.record = record
        self._run = make_rollout_fn(bundle.scene, bundle.params, bundle.cfg,
                                    bundle.num_steps, record=record)
        self.final_state = None
        self.records = None
        self.veh_records = None   # AutopilotRecord stack on reactive runs
        self.elapsed = None

    @classmethod
    def from_config(cls, scenario_config, sfm_config,
                    duration: float | None = None,
                    num_steps: int | None = None, record: bool = True,
                    route_provider=None, strict_parity: bool = False,
                    device: torch.device | str = DEFAULT_DEVICE,
                    **build_kwargs) -> "Simulation":
        """Build from TOML paths/dicts on ``device``.

        ``duration`` (seconds) or ``num_steps`` bounds the rollout (the
        reference runs an infinite real-time loop; a headless rollout needs
        a horizon).  Default: 60 s.
        """
        scenario = load_config(scenario_config)
        dt = float(scenario.get("step_length", 0.05))
        if num_steps is None:
            num_steps = int(round((duration if duration is not None
                                   else 60.0) / dt))
        # pass the original (possibly a path: config-relative resources)
        bundle = build_scenario(scenario_config, sfm_config, num_steps,
                                route_provider=route_provider,
                                strict_parity=strict_parity, device=device,
                                **build_kwargs)
        return cls(bundle, record=record)

    def set_results(self, final, recs):
        """Store rollout results, splitting a reactive-autopilot record
        pair into ``records`` + ``veh_records``; returns ``records``."""
        if recs is not None and not isinstance(recs, StepRecord):
            recs, self.veh_records = recs
        self.final_state, self.records = final, recs
        return recs

    def run(self):
        """Execute the rollout; returns ``(final_state, records)``.  The
        time in ``elapsed`` ends when the card has finished."""
        state = self.bundle.initial_state
        start = time.perf_counter()
        final, recs = self._run(state)
        _synchronize(state.device)
        self.elapsed = time.perf_counter() - start
        recs = self.set_results(final, recs)
        steps = self.bundle.num_steps
        log.info("rollout: %d steps x %d slots in %.3fs (%.0f steps/s)",
                 steps, self.bundle.capacity, self.elapsed,
                 steps / max(self.elapsed, 1e-9))
        return final, recs

    def force_breakdown(self, state=None, t_idx: int = 0) -> dict:
        """Per-force diagnostic (the reference's per-force debug logging,
        forces.py:28-32): name -> (N, 2) numpy array on the given state
        (default: the scenario's initial state after its first spawn)."""
        b = self.bundle
        if state is None:
            state = apply_spawn(b.initial_state, b.scene.spawn, t_idx)
        snap = (vehicle_snapshot_at(b.scene.vehicles, t_idx)
                if b.scene.vehicles is not None else None)
        scene = prepare_scene(b.scene, analytic=b.cfg.env_analytic,
                              orca=b.params.enable_orca,
                              chunked=b.cfg.env_chunked)
        terms = force_terms(state, scene, b.params, b.cfg, snap)
        return {k: np.stack([fx.cpu().numpy(), fy.cpu().numpy()], axis=-1)
                for k, (fx, fy) in terms.items()}

    def run_streamed(self, output_path: str = "output",
                     chunk_steps: int = 2400, mode_text: bool | None = None,
                     record_stride: int = 1) -> str:
        """Segmented rollout streaming records straight to CSV.

        The in-memory path's recorded history is the memory ceiling for
        long rollouts ((T, N) x ~20 bytes); this runs the rollout in
        ``chunk_steps`` segments and drains segment k's record to the
        pedestrian/vehicle CSVs after segment k+1 has been issued to the
        card (the drain's copy to the host waits for segment k while k+1's
        kernels are queued).  Memory high-water: two segments' records
        instead of the whole horizon.  Output is byte-identical to ``run()``
        + ``write_csv()``.

        ``record_stride`` composes: every k-th tick is recorded and frames
        are numbered in recorded units with ``time = frame * dt * k`` (the
        same contract as the in-memory strided record).  ``chunk_steps``
        must then be a multiple of the stride.  Returns the output dir.
        """
        b = self.bundle
        if mode_text is None:
            mode_text = bool(b.params.strict_parity)
        total = b.num_steps
        fleet = b.scene.autopilot
        scene = prepare_scene(b.scene, analytic=b.cfg.env_analytic,
                              orca=b.params.enable_orca,
                              chunked=b.cfg.env_chunked)
        eff_dt = b.dt * record_stride
        if chunk_steps % record_stride != 0:
            raise ValueError("chunk_steps must be a multiple of record_stride")
        if total % record_stride != 0:
            # raised before any segment computes: the final partial segment
            # would otherwise hit the stepper's divisibility check midway
            raise ValueError(
                f"total steps ({total}) must be a multiple of "
                f"record_stride ({record_stride})")

        out = csvout._output_dir(output_path, b.scenario_name)
        ped_path = os.path.join(out, "pedestrian.csv")
        veh_path = os.path.join(out, "vehicle.csv")

        def drain(start, recs):
            vrec = None
            if fleet is not None:
                recs, vrec = recs
            offset = start // record_stride
            csvout.write_pedestrian_csv(ped_path, recs, eff_dt,
                                        mode_text=mode_text,
                                        frame_offset=offset,
                                        append=start > 0)
            if vrec is not None:
                vstates = records_to_vehicle_states(fleet, vrec)
                csvout.write_vehicle_csv(veh_path, vstates, eff_dt,
                                         vstates.pos.shape[0],
                                         frame_offset=offset,
                                         append=start > 0)

        start_t = time.perf_counter()
        state = b.initial_state
        ap = fleet.initial_state() if fleet is not None else None
        start = 0
        pending = None
        while start < total:
            steps = min(chunk_steps, total - start)
            final, recs = rollout(
                state, scene, b.params, b.cfg, steps, record=True,
                start_step=start, record_stride=record_stride,
                autopilot_state=ap,
                return_autopilot_state=fleet is not None)
            if fleet is not None:
                state, ap = final
            else:
                state = final
            if pending is not None:
                drain(*pending)     # waits on segment k; k+1 is queued
            pending = (start, recs)
            start += steps
        drain(*pending)
        _synchronize(state.device)
        self.elapsed = time.perf_counter() - start_t
        self.final_state = state

        if fleet is None:
            csvout.write_vehicle_csv(veh_path, b.scene.vehicles, b.dt, total)
        csvout.write_borders_csv(os.path.join(out, "borders.csv"),
                                 b.border_lines)
        csvout.write_obstacles_csv(os.path.join(out, "obstacles.csv"),
                                   b.obstacle_outlines, b.obstacle_centers)
        log.info("streamed rollout: %d steps x %d slots in %.3fs -> %s",
                 total, self.bundle.capacity, self.elapsed, out)
        return out

    def write_csv(self, output_path: str = "output",
                  mode_text: bool | None = None) -> str:
        """Dump the four reference-schema CSVs; returns the output dir.

        ``mode_text`` writes the ped ``mode`` column as the reference's
        stringified enum (output_generator.py:49) instead of the integer;
        defaults to the params' ``strict_parity`` flag."""
        if self.records is None:
            raise RuntimeError("run() the simulation before write_csv()")
        b = self.bundle
        if mode_text is None:
            mode_text = bool(b.params.strict_parity)
        vehicles = b.scene.vehicles
        if vehicles is None and self.veh_records is not None:
            vehicles = records_to_vehicle_states(b.scene.autopilot,
                                                 self.veh_records)
        return csvout.write_all(
            output_path, b.scenario_name, self.records, b.dt,
            vehicles=vehicles, num_steps=b.num_steps,
            border_lines=b.border_lines,
            obstacle_outlines=b.obstacle_outlines,
            obstacle_centers=b.obstacle_centers, mode_text=mode_text)
