"""PyTorch port: the analysis and visualisation tools (utils/metrics.py,
utils/visualize.py, utils/viz_cli.py) and the profiling helpers
(utils/profiling.py), on the CPU.

Every metric of the port on a port record equals the JAX package's on the
JAX record of the same scenario (and is the same function: bitwise on the
same arrays); the viz CLI's ``metrics``, ``graph`` and ``animate`` run on
the port's CSV output and graphs; the profiler writes a trace.
"""
import glob
import json
import os

import numpy as np
import pytest

from scenario_jax import one_torch_thread  # noqa: F401
from carla_social_force_model_tpu.api.simulation import Simulation as JSim
from carla_social_force_model_tpu.utils import metrics as jmetrics
from carla_social_force_model_tpu_torch.api import cli
from carla_social_force_model_tpu_torch.api.simulation import Simulation
from carla_social_force_model_tpu_torch.api.synthetic import benchmark_bundle
from carla_social_force_model_tpu_torch.models.stepper import make_rollout_fn
from carla_social_force_model_tpu_torch.routing.graph import NavGraphBuilder
from carla_social_force_model_tpu_torch.utils import metrics, profiling
from carla_social_force_model_tpu_torch.utils.viz_cli import main as viz_main

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCEN = os.path.join(REPO, "configs", "scenarios")
SFM = os.path.join(REPO, "configs", "sfm.toml")
REGION = (-14.0, -2.0, -2.0, 2.0)
GATE = ((-8.0, -3.0), (-8.0, 3.0))


@pytest.fixture(scope="module")
def records():
    """The corridor's record in both packages (120 steps: the first
    eastbound walkers pass the gate at x = -8)."""
    toml = os.path.join(SCEN, "corridor_counterflow.toml")
    _, got = Simulation.from_config(toml, SFM, num_steps=120,
                                    device=CPU).run()
    _, want = JSim.from_config(toml, SFM, num_steps=120).run()
    return got, want


def metric_calls(rec, lib):
    """Every metric of ``lib`` on ``rec``, by name."""
    t = np.asarray(rec.alive).shape[0] // 2
    pos, alive = np.asarray(rec.pos)[t], np.asarray(rec.alive)[t]
    dirs = np.sign(np.asarray(rec.vel)[t, :, 0])
    return {
        "mean_speed": lib.mean_speed(rec),
        "mean_speed_region": lib.mean_speed(rec, REGION),
        "density_grid": lib.density_grid(rec, REGION, cell=1.0)[0],
        "region_density": lib.region_density(rec, REGION),
        "gate_crossings": np.stack(lib.gate_crossings(rec, *GATE)),
        "flow_rate": np.array(list(lib.flow_rate(rec, *GATE,
                                                 dt=0.05).values())),
        "evacuation_curve": np.stack(lib.evacuation_curve(rec, 0.05)),
        "evacuation_time": np.array(lib.evacuation_time(rec, 0.05)),
        "fundamental_diagram": np.concatenate(
            lib.fundamental_diagram(rec, REGION, 0.05, bins=4)),
        "lane_order_parameter": np.array(lib.lane_order_parameter(
            pos[alive], dirs[alive], REGION, bins=4, slices=2,
            min_per_slice=1)),
    }


def test_metrics_equal_jax(records):
    got_rec, want_rec = records
    # the same functions: bitwise on the same (JAX) record
    same = metric_calls(want_rec, metrics)
    want = metric_calls(want_rec, jmetrics)
    for name in want:
        np.testing.assert_array_equal(same[name], want[name], name)
    # on the port's own record (positions within 1e-4 m of the JAX
    # package's, equal alive masks)
    got = metric_calls(got_rec, metrics)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    assert np.isfinite(got["mean_speed"]).any()
    assert got["gate_crossings"].sum() > 0


def test_metrics_take_tensors():
    """A record of tensors and one of numpy arrays give the same metrics."""
    scene, params, cfg, state = benchmark_bundle(16, extent=8.0, device=CPU)
    _, rec = make_rollout_fn(scene, params, cfg, 40)(state)
    as_np = type(rec)(*(r.numpy() for r in rec))
    a = metric_calls(rec, metrics)
    b = metric_calls(as_np, metrics)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], name)


def csv_run(tmp_path, scen="jaywalking_reactive", steps=80):
    out = str(tmp_path / "out")
    assert cli.main(["--scenario-config", os.path.join(SCEN, f"{scen}.toml"),
                     "--steps", str(steps), "--platform", "cpu", "--csv",
                     "--output", out]) == 0
    (run_dir,) = glob.glob(os.path.join(out, "*"))
    return run_dir


def test_viz_cli_metrics_report(tmp_path, capsys):
    """``viz_cli metrics`` on the port's CSV output: one JSON report with
    the gate flow and the window density."""
    run_dir = csv_run(tmp_path, "corridor_counterflow", 120)
    capsys.readouterr()
    assert viz_main(["metrics", "--csv-dir", run_dir, "--gate=-8,-3,-8,3",
                     "--region=-14,-2,-2,2"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["frames"] == 120 and abs(report["dt"] - 0.05) < 1e-6
    assert 0.0 < report["mean_speed"] <= report["peak_speed"] < 4.0
    assert report["gate"]["total"] > 0
    assert report["region"]["mean_density"] > 0


def test_viz_cli_animate_from_csv(tmp_path):
    """CSV -> dense records -> GIF, with the reactive fleet's rectangles."""
    run_dir = csv_run(tmp_path)
    gif = tmp_path / "run.gif"
    assert viz_main(["animate", "--csv-dir", run_dir, "--out", str(gif),
                     "--stride", "8", "--fps", "10"]) == 0
    assert os.path.getsize(gif) > 2000


def small_graph():
    b = NavGraphBuilder()
    b.add_polyline([[0, 0, 0], [10, 0, 0], [20, 0, 0]], 0)
    b.add_edge([10, 0, 0], [10, 10, 0], 1)
    b.add_edge([20, 0, 0], [20, 10, 0], 2)
    return b.build()


def test_viz_cli_graph_and_plots(tmp_path):
    """``viz_cli graph --npz`` and the two plots render PNGs."""
    from carla_social_force_model_tpu_torch.utils.visualize import (
        plot_nav_graph, plot_trajectories)
    npz = tmp_path / "g.npz"
    small_graph().save_npz(npz)
    out = tmp_path / "g.png"
    assert viz_main(["graph", "--npz", str(npz), "--out", str(out)]) == 0
    assert os.path.getsize(out) > 1000
    assert os.path.getsize(plot_nav_graph(small_graph(),
                                          str(tmp_path / "n.png"))) > 1000
    scene, params, cfg, state = benchmark_bundle(8, extent=8.0, device=CPU)
    _, recs = make_rollout_fn(scene, params, cfg, 30)(state)
    png = plot_trajectories(recs, str(tmp_path / "traj.png"),
                            border_lines=[np.array([[-9.0, -9], [9, -9]])])
    assert os.path.getsize(png) > 1000


def test_viz_cli_trajectories(tmp_path):
    run_dir = csv_run(tmp_path, "road_crossing", 40)
    out = tmp_path / "t.png"
    assert viz_main(["trajectories", "--csv-dir", run_dir, "--out",
                     str(out)]) == 0
    assert os.path.getsize(out) > 1000


def test_profiling_helpers(tmp_path):
    """PhaseTimer accumulates, measure_rollout reports wall-clock rates,
    trace writes a Chrome trace of the block."""
    timer = profiling.PhaseTimer()
    for _ in range(3):
        with timer.phase("a"):
            pass
    assert timer.counts == {"a": 3} and "a:" in timer.report()
    scene, params, cfg, state = benchmark_bundle(8, extent=8.0, device=CPU)
    run = make_rollout_fn(scene, params, cfg, 5, record=False)
    m = profiling.measure_rollout(run, state, num_steps=5, capacity=8,
                                  repeats=2)
    assert m["seconds"] > 0
    assert m["agent_steps_per_sec"] == pytest.approx(
        8 * m["steps_per_sec"])
    with profiling.trace(str(tmp_path / "prof")) as d:
        run(state)
    with open(os.path.join(d, profiling.TRACE_FILE)) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
