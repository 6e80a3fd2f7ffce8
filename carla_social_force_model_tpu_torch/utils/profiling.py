"""Lightweight runtime observability (port of utils/profiling.py).

Host-side phase timers, the wall-clock throughput of a rollout, and a
``torch.profiler`` trace around any block (the CLI's ``--profile DIR``).

Device times come from a profile that holds every launch (or, where the
profiler misses launches, from a CUDA graph replay: ``chip_smoke.
device_ms``), never from the host clock: :func:`measure_rollout` reports
the wall time of whole rollouts, which includes the host's time between
launches, and says so in its keys.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time
from dataclasses import dataclass, field

import torch

log = logging.getLogger(__name__)


@dataclass
class PhaseTimer:
    """Accumulating host-side phase timers."""

    totals: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = [f"{name}: {total:.4f}s over {self.counts[name]} calls"
                 for name, total in sorted(self.totals.items())]
        return "\n".join(lines)


def _first_tensor(out):
    """The first tensor of a (nested) rollout result, or None."""
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, (tuple, list)):
        for o in out:
            t = _first_tensor(o)
            if t is not None:
                return t
    if hasattr(out, "__dataclass_fields__"):
        for name in out.__dataclass_fields__:
            t = _first_tensor(getattr(out, name))
            if t is not None:
                return t
    return None


def _finish(out) -> None:
    """Wait until the card has computed ``out`` (no-op on the CPU)."""
    t = _first_tensor(out)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def measure_rollout(run_fn, state, *, num_steps: int, capacity: int,
                    repeats: int = 3, warmup: bool = True) -> dict:
    """Wall-clock time of a rollout closure (``run_fn(state)``): the best
    of ``repeats`` windows, each ending in ``torch.cuda.synchronize`` on a
    card.  Returns ``seconds`` and the steps and agent-steps per wall
    second (host time included: not a device time)."""
    if warmup:
        _finish(run_fn(state))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        _finish(run_fn(state))
        best = min(best, time.perf_counter() - t0)
    return {
        "seconds": best,
        "steps_per_sec": num_steps / best,
        "agent_steps_per_sec": num_steps * capacity / best,
    }


#: the file name of the trace :func:`trace` writes into its directory
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str = os.path.join("output", "sfm_torch_trace")):
    """Capture a ``torch.profiler`` trace around a block: the host's
    operators and, with a card, every kernel launch and its device time.
    Writes ``<log_dir>/trace.json`` (Chrome trace format: chrome://tracing
    or Perfetto)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)
