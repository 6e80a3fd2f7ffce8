"""PyTorch port: the simulation API, the CSV writers and the command line
against the JAX package's, on the CPU.

``Simulation.run_streamed`` must write the bytes of ``run()`` +
``write_csv()``; the native and the Python pedestrian writers agree byte
for byte; the port's CLI writes the reference schema and its parsed values
match the JAX package's CLI on the same scenario; the TPU launch knobs,
the orbax backend and the flags the CARLA bridge has no use for stop the
run with their reason, and the bridge's, the checkpoints' and the
profiler's flags run on the CPU.
"""
import glob
import os

import numpy as np
import pytest
import torch

from scenario_jax import one_torch_thread  # noqa: F401
from carla_social_force_model_tpu.api import cli as jcli
from carla_social_force_model_tpu.api.simulation import Simulation as JSim
from carla_social_force_model_tpu.utils import csvout as jcsvout
from carla_social_force_model_tpu_torch.api import cli
from carla_social_force_model_tpu_torch.api.simulation import Simulation
from carla_social_force_model_tpu_torch.utils import csvout, nativelib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCEN = os.path.join(REPO, "configs", "scenarios")
SFM = os.path.join(REPO, "configs", "sfm.toml")
CSVS = ("pedestrian.csv", "vehicle.csv", "borders.csv", "obstacles.csv")
HEADER = "ped_id,frame,time,x,y,v_x,v_y,mode"


def read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("scen,steps,chunk,stride", [
    ("corridor_counterflow", 150, 64, 1),       # uneven final segment
    ("jaywalking_reactive", 120, 50, 2),        # the fleet's vehicle.csv
])
def test_streamed_csv_equals_in_memory(tmp_path, scen, steps, chunk, stride):
    cfg = os.path.join(SCEN, f"{scen}.toml")
    ref = Simulation.from_config(cfg, SFM, num_steps=steps, device="cpu")
    final, recs = ref.run()
    assert ref.elapsed > 0 and final.pos_x.device.type == "cpu"
    if stride == 1:
        ref_dir = ref.write_csv(str(tmp_path / "mem"))
    else:   # the strided record, written as the streamed one numbers it
        ref_dir = str(tmp_path / "mem")
        os.makedirs(ref_dir)
        sub = type(recs)(*(r[::stride] for r in recs))
        csvout.write_pedestrian_csv(os.path.join(ref_dir, "pedestrian.csv"),
                                    sub, ref.bundle.dt * stride)
    sim = Simulation.from_config(cfg, SFM, num_steps=steps, device="cpu")
    out_dir = sim.run_streamed(str(tmp_path / "stream"), chunk_steps=chunk,
                               record_stride=stride)
    names = CSVS if stride == 1 else ("pedestrian.csv",)
    for name in names:
        assert read(os.path.join(out_dir, name)) == \
            read(os.path.join(ref_dir, name)), name
    assert torch.equal(sim.final_state.pos_x, ref.final_state.pos_x)
    assert torch.equal(sim.final_state.mode, ref.final_state.mode)
    with pytest.raises(ValueError, match="multiple of record_stride"):
        sim.run_streamed(str(tmp_path / "bad"), chunk_steps=chunk + 1,
                         record_stride=2)


def test_native_and_python_writers_agree(tmp_path):
    """The port's native trajectory writer (its own native/trajio.cpp,
    built with g++ at first use) and the Python writer write the same bytes,
    and those of the JAX package's Python writer, for every form a float
    takes; the reader inverts them."""
    assert nativelib.load("trajio") is not None
    sim = Simulation.from_config(os.path.join(SCEN, "circle_holding.toml"),
                                 SFM, num_steps=30, device="cpu")
    _, recs = sim.run()
    paths = {k: str(tmp_path / f"{k}.csv") for k in ("native", "python",
                                                       "jax")}
    csvout.write_pedestrian_csv(paths["native"], recs, 0.05, use_native=True)
    csvout.write_pedestrian_csv(paths["python"], recs, 0.05, use_native=False)
    jrecs = type("R", (), {k: getattr(recs, k).numpy()
                           for k in ("pos", "vel", "mode", "alive")})
    jcsvout.write_pedestrian_csv(paths["jax"], jrecs, 0.05, use_native=False)
    assert read(paths["native"]) == read(paths["python"]) == read(paths["jax"])
    back, dt = csvout.read_pedestrian_csv(paths["native"])
    assert dt == pytest.approx(0.05)
    np.testing.assert_array_equal(back.pos.numpy(), recs.pos.numpy())
    np.testing.assert_array_equal(back.mode.numpy(), recs.mode.numpy())
    # every float form: zeros, integral, tiny, huge, both notations
    vals = np.array([0.0, -0.0, 1.0, 10.0, 1e5, 1e15, 1e16, 1e-4, 9.9e-5,
                     -3e-7, 1 / 3, 3.4e38, 1e-45, -1e20, 1257302144.0,
                     123.456], np.float32)
    pos = np.stack([vals, -vals[::-1]], -1)[None]
    edge = type(recs)(pos=torch.from_numpy(pos),
                      vel=torch.from_numpy(pos[:, ::-1].copy()),
                      mode=torch.ones((1, len(vals)), dtype=torch.int32),
                      alive=torch.ones((1, len(vals)), dtype=torch.bool))
    for k, native in (("e_native", True), ("e_python", False)):
        csvout.write_pedestrian_csv(str(tmp_path / k), edge, 0.05,
                                    use_native=native, frame_offset=123457)
    assert read(str(tmp_path / "e_native")) == read(str(tmp_path / "e_python"))
    text = str(tmp_path / "text.csv")
    csvout.write_pedestrian_csv(text, recs, 0.05, mode_text=True)
    assert "PedMode.WALKING_SIDEWALK" in open(text).read()


def parse(out_root):
    (run_dir,) = glob.glob(os.path.join(out_root, "*"))
    with open(os.path.join(run_dir, "pedestrian.csv")) as f:
        assert f.readline().strip() == HEADER
    rec, dt = csvout.read_pedestrian_csv(
        os.path.join(run_dir, "pedestrian.csv"))
    return rec, dt, run_dir


@pytest.mark.parametrize("scen", ["corridor_counterflow", "vehicle_evasion"])
def test_cli_matches_jax_cli(tmp_path, scen):
    """``--platform cpu --steps 40 --csv``: the reference schema, and the
    parsed rows within 1e-4 m of the JAX package's CLI run; ``--stream``
    writes the same pedestrian rows."""
    args = ["--scenario-config", os.path.join(SCEN, f"{scen}.toml"),
            "--sfm-config", SFM, "--steps", "40", "--platform", "cpu"]
    assert cli.main(args + ["--csv", "--output", str(tmp_path / "port")]) == 0
    assert jcli.main(args + ["--csv", "--output", str(tmp_path / "jax")]) == 0
    got, dt, run_dir = parse(str(tmp_path / "port"))
    want, jdt, _ = parse(str(tmp_path / "jax"))
    assert dt == pytest.approx(jdt)
    np.testing.assert_array_equal(got.alive.numpy(), want.alive.numpy())
    np.testing.assert_array_equal(got.mode.numpy(), want.mode.numpy())
    assert np.abs(got.pos.numpy() - want.pos.numpy()).max() <= 1e-4
    for name in CSVS:
        assert os.path.isfile(os.path.join(run_dir, name))
    assert cli.main(args + ["--stream", "--chunk-steps", "16", "--output",
                            str(tmp_path / "stream")]) == 0
    (stream_dir,) = glob.glob(str(tmp_path / "stream" / "*"))
    assert read(os.path.join(stream_dir, "pedestrian.csv")) == \
        read(os.path.join(run_dir, "pedestrian.csv"))


@pytest.mark.parametrize("flag,item", [
    (["--vmem-mb", "64"], "TPU launch knob"),
    (["--exact-div"], "TPU launch knob"),
    (["--platform", "tpu"], "one of cpu"),
    (["--checkpoint-dir", "ck", "--checkpoint-backend", "orbax"],
     "orbax checkpoint backend is the JAX package's"),
    (["--carla", "--pallas"], "--pallas with --carla: an engine flag"),
    (["--carla", "--cutoff", "3"], "--cutoff with --carla: an engine flag"),
    (["--carla", "--checkpoint-dir", "ck"], "with --carla"),
    (["--resume"], "--resume needs --checkpoint-dir"),
    (["--stream", "--checkpoint-dir", "ck"], "cannot be combined"),
])
def test_cli_refuses_flags_not_ported(capsys, flag, item):
    """The TPU launch knobs, the orbax backend, and the engine, stream,
    checkpoint and profile flags together with ``--carla`` stop the run
    with their reason; nothing else runs in their place."""
    args = ["--scenario-config", os.path.join(SCEN, "road_crossing.toml"),
            "--steps", "5", "--platform", "cpu"]
    if flag[0] == "--platform":
        args = args[:-2]
    with pytest.raises(SystemExit) as exc:
        cli.main(args + flag)
    assert exc.value.code == 2
    assert item in capsys.readouterr().err


@pytest.mark.parametrize("flag", [
    ["--carla"], ["--carla", "--carla-host", "10.0.0.1"],
    ["--carla", "--carla-port", "2345"],
    ["--checkpoint-dir", "ck"], ["--checkpoint-dir", "ck", "--resume"],
    ["--checkpoint-dir", "ck", "--checkpoint-backend", "npz"],
    ["--profile", "prof"], ["--profile", "prof", "--checkpoint-dir", "ck"],
    ["--profile", "prof", "--stream"],
])
def test_cli_runs_bridge_checkpoint_and_profile_flags(tmp_path, monkeypatch,
                                                      flag):
    """Each flag of the bridge, the checkpoints and the profiler runs on the
    CPU: ``--carla`` against the fake CARLA server (the host and port reach
    its client; a scripted vehicle and the walkers go through the bridge),
    the checkpoint flags write and resume npz snapshots whose run equals
    the straight one, ``--profile`` writes its trace, also of a segmented
    or a streamed run."""
    import json
    import fake_carla
    monkeypatch.chdir(tmp_path)
    args = ["--scenario-config", os.path.join(SCEN, "road_crossing.toml"),
            "--platform", "cpu", "--csv", "--output", str(tmp_path / "out")]
    if flag[0] == "--carla":
        fake_carla.install_server()
        seen = []
        init = fake_carla.Client.__init__

        def spy(self, host="localhost", port=2000):
            seen.append((host, port))
            init(self, host, port)
        monkeypatch.setattr(fake_carla.Client, "__init__", spy)
        assert cli.main(args + ["--steps", "30"] + flag) == 0
        assert seen == [("10.0.0.1" if "--carla-host" in flag
                         else "127.0.0.1",
                         2345 if "--carla-port" in flag else 2000)]
        rec, _, run_dir = parse(str(tmp_path / "out"))
        assert rec.pos.shape[0] == 30 and rec.alive.any()
        assert os.path.getsize(os.path.join(run_dir, "vehicle.csv")) > 100
        return
    steps = ["--steps", "60"]
    if "--resume" in flag:
        # a run of the same horizon that stopped after its step-30
        # checkpoint, then the resumed rest
        assert cli.main(args[:-1] + [str(tmp_path / "first")] + steps
                        + ["--checkpoint-dir", "ck",
                           "--checkpoint-every", "30"]) == 0
        assert sorted(os.listdir("ck")) == ["ckpt_00000030.npz",
                                            "ckpt_00000060.npz"]
        os.remove(os.path.join("ck", "ckpt_00000060.npz"))
    assert cli.main(args + steps + ["--checkpoint-every", "25"] + flag) == 0
    got, _, _ = parse(str(tmp_path / "out"))
    assert cli.main(args[:-1] + [str(tmp_path / "straight")] + steps) == 0
    want, _, _ = parse(str(tmp_path / "straight"))
    if "--resume" in flag:
        want = type(want)(*(r[30:] for r in want))
    assert got.pos.shape == want.pos.shape
    np.testing.assert_array_equal(got.alive.numpy(), want.alive.numpy())
    np.testing.assert_array_equal(got.mode.numpy(), want.mode.numpy())
    np.testing.assert_array_equal(got.pos.numpy(), want.pos.numpy())
    if "--checkpoint-dir" in flag:
        assert "ckpt_00000060.npz" in os.listdir("ck")
    if "--profile" in flag:
        with open(os.path.join("prof", "trace.json")) as f:
            assert json.load(f)["traceEvents"]


def test_cli_accepts_comm(tmp_path, monkeypatch):
    """``--comm`` carries into ``StepConfig.axis_comm``, as in the JAX
    package; the CLI's ``Simulation`` runs one device, which ignores it."""
    args = ["--scenario-config", os.path.join(SCEN, "road_crossing.toml"),
            "--steps", "5", "--platform", "cpu", "--csv", "--output",
            str(tmp_path)]
    seen = []
    real = Simulation.from_config

    def spy(*a, **kw):
        sim = real(*a, **kw)
        seen.append(sim.bundle.cfg.axis_comm)
        return sim

    monkeypatch.setattr(Simulation, "from_config", spy)
    assert cli.main(args + ["--comm", "ring"]) == 0
    assert seen == ["ring"]


def test_force_breakdown_matches_jax():
    """The per-force diagnostic on a scenario's first spawned state: the
    same terms as the JAX package's, within the environment tolerance."""
    cfg = os.path.join(SCEN, "obstacle_evasion.toml")
    got = Simulation.from_config(cfg, SFM, num_steps=20,
                                 device="cpu").force_breakdown()
    want = JSim.from_config(cfg, SFM, num_steps=20).force_breakdown()
    assert set(got) == set(want) and "static_obstacle_force" in got
    for name in got:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   atol=1e-5, err_msg=name)
