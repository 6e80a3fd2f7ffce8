"""PyTorch port: differentiable calibration (``api/calibrate.py``) against
the JAX package's.

The same crowds (``benchmark_bundle``, equal in both packages) and the same
observed record -- the JAX package's recorded rollout, an input of both
loss functions -- go through the JAX package's ``make_loss_fn`` under
``jax.value_and_grad`` (its jnp path: its calibration drops its fused
kernels, which define no VJP) and the port's under torch autograd (the
same path: the chunked environment forces, the plain versions of the
kernels whose outputs carry the gradient, the chunk scan's kernel).  Both run on the CPU; theta
is made with numpy.  Tolerances: the loss within rtol 1e-5 and every
gradient within rtol 1e-4 (the per-agent ``pair_scale`` vector also atol
1e-7: its small entries are sums of opposing pair terms), as measured
against float32 reduction order over 40 ticks of a smooth law.  The stiff
laws (power law, ORCA) and ``grad_horizon`` are in
``tests/test_torch_calibrate_stiff.py``, the recovery of A and gamma in
``tests/test_torch_calibrate_recover.py``.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from carla_social_force_model_tpu.api import calibrate as jcal
from carla_social_force_model_tpu.api.synthetic import (
    benchmark_bundle as jax_benchmark_bundle)
from carla_social_force_model_tpu.models import groups as jgroups
from carla_social_force_model_tpu.models.stepper import (
    make_rollout_fn as jax_make_rollout_fn)
from carla_social_force_model_tpu_torch.api import calibrate as cal
from carla_social_force_model_tpu_torch.api import synthetic as psyn
from carla_social_force_model_tpu_torch.api.synthetic import benchmark_bundle
from carla_social_force_model_tpu_torch.models import groups, params as pparams
from carla_social_force_model_tpu_torch.models import stepper
from carla_social_force_model_tpu_torch.models.params import (
    MoussaidParams, PowerLawParams)
from carla_social_force_model_tpu_torch.models.stepper import (
    StepRecord, make_rollout_fn)
from carla_social_force_model_tpu_torch.ops import forces
from carla_social_force_model_tpu_torch.utils import csvout

CPU = "cpu"
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the crowds are tiny, and the test workers run
    side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def record_to_torch(rec) -> StepRecord:
    """A JAX package StepRecord as the port's (CPU tensors)."""
    return StepRecord(*(torch.from_numpy(np.array(a)) for a in rec))


def both(n, steps, jax_edit=None, port_edit=None, **kw):
    """``(jax (scene, params, cfg, state), port (...), observed)``: the
    same crowd in both packages (``extent=8.0``), each edited by its
    ``*_edit(scene, params) -> (scene, params)``, and the JAX package's
    recorded rollout of ``steps`` ticks."""
    js, jp, jc, jst = jax_benchmark_bundle(n, extent=8.0, use_pallas=False,
                                           **kw)
    ps, pp, pc, pst = benchmark_bundle(n, extent=8.0, device=CPU, **kw)
    if jax_edit is not None:
        js, jp = jax_edit(js, jp)
        ps, pp = port_edit(ps, pp)
    _, jobs = jax_make_rollout_fn(js, jp, jc, steps)(jst)
    return (js, jp, jc, jst), (ps, pp, pc, pst), jobs


def value_and_grad_both(jb, pb, jobs, steps, fit, theta, **kw):
    """The JAX package's and the port's ``(loss, grads)`` of
    ``make_loss_fn`` at ``theta`` (numpy float32 values)."""
    jl = jcal.make_loss_fn(jb[3], jb[0], jb[1], jb[2], jobs, steps,
                           fit=fit, **kw)
    pl = cal.make_loss_fn(pb[3], pb[0], pb[1], pb[2], record_to_torch(jobs),
                          steps, fit=fit, **kw)
    jv, jg = jax.value_and_grad(jl)({k: jnp.asarray(v)
                                     for k, v in theta.items()})
    pv, pg = cal.value_and_grad(pl, {k: torch.from_numpy(np.array(v))
                                     for k, v in theta.items()})
    return (float(jv), {k: np.asarray(g) for k, g in jg.items()},
            float(pv), {k: g.numpy() for k, g in pg.items()})


def log_theta(values) -> dict:
    return {k: np.log(np.asarray(v, np.float32)) for k, v in values.items()}


def assert_match(jv, jg, pv, pg, loss_rtol=LOSS_RTOL, grad_rtol=GRAD_RTOL,
                 grad_atol=0.0):
    np.testing.assert_allclose(pv, jv, rtol=loss_rtol, err_msg="loss")
    assert set(pg) == set(jg)
    for k in jg:
        assert np.all(np.isfinite(pg[k])), k
        np.testing.assert_allclose(pg[k], jg[k], rtol=grad_rtol,
                                   atol=grad_atol, err_msg=k)


# -- the path helpers and the loss --------------------------------------------

def test_param_path_helpers():
    _, params, _, _ = benchmark_bundle(4, device=CPU)
    assert cal.get_param(params, "pedestrian.A") == 4.5
    assert cal.get_param(params, "acceleration.tau") == 0.5
    p2 = cal.replace_param(params, "pedestrian.A", 2.0)
    assert cal.get_param(p2, "pedestrian.A") == 2.0
    assert (cal.get_param(p2, "pedestrian.gamma")
            == cal.get_param(params, "pedestrian.gamma"))
    p3 = cal.replace_params(params, {"pedestrian.gamma": 0.5,
                                     "border.a": 1.0})
    assert cal.get_param(p3, "pedestrian.gamma") == 0.5
    assert cal.get_param(p3, "border.a") == 1.0
    assert cal.get_param(params, "pedestrian.A") == 4.5
    assert cal.DEFAULT_FIT == jcal.DEFAULT_FIT
    assert cal.SCENE_PREFIX == jcal.SCENE_PREFIX


def test_trajectory_mse_masking():
    pos_a = torch.zeros((3, 2, 2))
    pos_b = torch.ones((3, 2, 2))
    alive = torch.ones((3, 2), dtype=torch.bool)
    vel = torch.zeros((3, 2, 2))
    mode = torch.zeros((3, 2), dtype=torch.int32)
    ra = StepRecord(pos=pos_a, vel=vel, mode=mode, alive=alive)
    rb = StepRecord(pos=pos_b, vel=vel, mode=mode, alive=alive)
    assert float(cal.trajectory_mse(ra, rb)) == pytest.approx(2.0)
    rb_dead = StepRecord(pos=pos_b, vel=vel, mode=mode, alive=~alive)
    assert float(cal.trajectory_mse(ra, rb_dead)) == 0.0
    # the velocity term, against the JAX package's
    vel_b = torch.full((3, 2, 2), 0.5)
    rv = StepRecord(pos=pos_b, vel=vel_b, mode=mode, alive=alive)
    want = jcal.trajectory_mse(*(
        jcal.StepRecord(*(jnp.asarray(a.numpy()) for a in r))
        for r in (ra, rv)), vel_weight=3.0)
    assert float(cal.trajectory_mse(ra, rv, vel_weight=3.0)) == float(want)


def test_loss_zero_at_truth_and_grads_finite():
    scene, params, cfg, state = benchmark_bundle(24, extent=8.0, device=CPU)
    _, observed = make_rollout_fn(scene, params, cfg, 80)(state)
    fit = cal.DEFAULT_FIT + ("acceleration.tau",)
    loss_fn = cal.make_loss_fn(state, scene, params, cfg, observed, 80,
                               fit=fit)
    truth = {k: torch.log(torch.tensor(cal.get_param(params, k),
                                       dtype=torch.float32)) for k in fit}
    with torch.no_grad():
        assert float(loss_fn(truth)) < 1e-10
    loss, grads = cal.value_and_grad(loss_fn, {k: v + 0.4
                                               for k, v in truth.items()})
    assert float(loss) > 1e-4
    for k, g in grads.items():
        assert torch.isfinite(g), k
    assert abs(float(grads["pedestrian.A"])) > 1e-6
    assert abs(float(grads["acceleration.tau"])) > 1e-6


@pytest.mark.parametrize("case", ["moussaid_tau", "border"])
def test_loss_and_grads_match_jax(case):
    """DEFAULT_FIT + ``acceleration.tau`` at 24 x 40, and ``border.a`` /
    ``border.b`` with borders at 16 x 40 (log space)."""
    if case == "moussaid_tau":
        n, kw = 24, {}
        theta = log_theta({"pedestrian.A": 3.0, "pedestrian.gamma": 0.45,
                           "pedestrian.lambda_": 2.5,
                           "acceleration.tau": 0.6})
    else:
        n, kw = 16, dict(with_borders=True)
        theta = log_theta({"border.a": 2.0, "border.b": 0.15})
    jb, pb, jobs = both(n, 40, **kw)
    assert_match(*value_and_grad_both(jb, pb, jobs, 40, tuple(theta),
                                      theta))


def test_calibration_runs_the_jnp_path_with_the_chunk_scan_kernel(
        monkeypatch):
    """The loss runs the JAX package's jnp path whatever ``cfg`` asks: the
    chunked environment forces (``env_analytic`` and ``env_compact``
    dropped), the pair and environment forces plain, and the chunk scan
    allowed its kernel (``plain=False``: on a card ``chunk_argmin``), once
    a tick.  ``fit_params`` captures no CUDA graph on the CPU."""
    from carla_social_force_model_tpu_torch.ops import geometry
    scene, params, cfg, state = benchmark_bundle(
        8, extent=8.0, with_borders=True, device=CPU)
    _, observed = make_rollout_fn(scene, params, cfg, 6)(state)
    cfg = dataclasses.replace(cfg, env_analytic=True, env_compact=True)
    scans = []
    scan = geometry.chunk_argmin

    def spy(*args, plain=False):
        scans.append(plain)
        return scan(*args, plain=plain)

    monkeypatch.setattr(geometry, "chunk_argmin", spy)
    loss_fn = cal.make_loss_fn(state, scene, params, cfg, observed, 6,
                               fit=("border.a",), remat=False)
    loss, grads = cal.value_and_grad(
        loss_fn, {"border.a": torch.tensor(np.log(2.0), dtype=torch.float32)})
    assert scans == [False] * 6
    assert torch.isfinite(loss) and float(grads["border.a"]) != 0.0
    assert not cal.graph_capturable(state, params)


def test_pair_scale_vector_grad_matches_jax():
    """The per-agent ``scene.spawn.pair_scale`` vector (the scene has
    none: the fit's vector takes its place), observed with heterogeneous
    true scales."""
    true_scale = np.random.default_rng(3).uniform(0.3, 1.7, 24).astype(
        np.float32)

    def jedit(s, p):
        return dataclasses.replace(s, spawn=dataclasses.replace(
            s.spawn, pair_scale=jnp.asarray(true_scale))), p

    jb, pb, jobs = both(24, 40, jedit, lambda s, p: (s, p))
    # the fit starts from the homogeneous scene of both packages
    jb = (jax_benchmark_bundle(24, extent=8.0, use_pallas=False)[0],
          *jb[1:])
    start = np.linspace(0.8, 1.2, 24).astype(np.float32)
    theta = {"scene.spawn.pair_scale": np.log(start)}
    jv, jg, pv, pg = value_and_grad_both(jb, pb, jobs, 40, tuple(theta),
                                         theta)
    assert pg["scene.spawn.pair_scale"].shape == (24,)
    assert_match(jv, jg, pv, pg, grad_atol=1e-7)


def test_group_betas_match_jax():
    gid = np.arange(24) // 4          # six 4-member parties

    def jedit(s, p):
        return (dataclasses.replace(s, groups=jgroups.build_groups(
            gid, max_members=4)), dataclasses.replace(p, enable_group=True))

    def pedit(s, p):
        return (dataclasses.replace(s, groups=groups.build_groups(
            gid, max_members=4, device=CPU)),
            dataclasses.replace(p, enable_group=True))

    jb, pb, jobs = both(24, 40, jedit, pedit)
    theta = log_theta({"group.beta_att": 1.0, "group.beta_vis": 1.5})
    assert_match(*value_and_grad_both(jb, pb, jobs, 40, tuple(theta),
                                      theta))


def test_remat_matches():
    """``remat`` on and off: the same loss (rtol 1e-6) and gradient (rtol
    1e-4)."""
    scene, params, cfg, state = benchmark_bundle(12, extent=8.0, device=CPU)
    _, observed = make_rollout_fn(scene, params, cfg, 40)(state)
    kw = dict(fit=("pedestrian.A",), log_space=False)
    theta = {"pedestrian.A": torch.tensor(3.0)}
    v_r, g_r = cal.value_and_grad(cal.make_loss_fn(
        state, scene, params, cfg, observed, 40, remat=True, **kw), theta)
    v_n, g_n = cal.value_and_grad(cal.make_loss_fn(
        state, scene, params, cfg, observed, 40, remat=False, **kw), theta)
    np.testing.assert_allclose(float(v_r), float(v_n), rtol=1e-6)
    np.testing.assert_allclose(float(g_r["pedestrian.A"]),
                               float(g_n["pedestrian.A"]), rtol=1e-4)


@pytest.mark.parametrize("knob", [dict(remat=True), dict(grad_horizon=5),
                                  dict(remat=True, grad_horizon=7)],
                         ids=["remat", "horizon", "both"])
def test_rollout_knobs_keep_the_forward_bitwise(knob):
    """``rollout(remat=, grad_horizon=)`` on the urban bundle (its reactive
    fleet: the carry is ``(PedState, AutopilotState)``) with a parameter
    that requires grad: the records (walkers and fleet) equal the plain
    rollout's bitwise, and the gradient reaches the parameter."""
    scene, params, cfg, state = psyn.urban_bundle(
        48, num_steps_hint=40, n_routes=8, n_roads=3, width=200.0,
        cross_spacing=80.0, vehicles_per_road=1, device=CPU)
    cfg = dataclasses.replace(cfg, plain_pair_force=True,
                              plain_env_force=True)
    a = torch.tensor(4.5, requires_grad=True)
    p = cal.replace_param(params, "pedestrian.A", a)
    _, (rec, ap) = stepper.rollout(state, scene, p, cfg, 40)
    _, (rec_k, ap_k) = stepper.rollout(state, scene, p, cfg, 40, **knob)
    for x, y in zip((*rec, *ap), (*rec_k, *ap_k)):
        assert torch.equal(x, y)
    assert bool(rec.alive.any()) and bool(ap.active.any())
    (g,) = torch.autograd.grad(rec_k.pos.sum(), a)
    assert torch.isfinite(g) and float(g) != 0.0


def test_rollout_rejects_a_nonpositive_horizon():
    scene, params, cfg, state = benchmark_bundle(4, device=CPU)
    for k in (0, -3):
        with pytest.raises(ValueError, match="grad_horizon"):
            stepper.rollout(state, scene, params, cfg, 2, grad_horizon=k)


def test_csv_roundtrip_feeds_calibration(tmp_path):
    """write_pedestrian_csv -> read_pedestrian_csv round-trips into a
    StepRecord (CPU tensors) that the calibration loss accepts (zero at
    the true parameters), as the JAX package's test has it."""
    scene, params, cfg, state = benchmark_bundle(10, extent=8.0, device=CPU)
    _, observed = make_rollout_fn(scene, params, cfg, 20)(state)
    path = str(tmp_path / "pedestrian.csv")
    csvout.write_pedestrian_csv(path, observed, cfg.dt, use_native=False)
    rec, dt = csvout.read_pedestrian_csv(path)
    assert dt == pytest.approx(cfg.dt)
    assert rec.pos.shape == observed.pos.shape
    assert torch.equal(rec.alive, observed.alive)
    a = observed.alive
    np.testing.assert_allclose(rec.pos[a].numpy(), observed.pos[a].numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(rec.vel[a].numpy(), observed.vel[a].numpy(),
                               rtol=1e-6)
    loss_fn = cal.make_loss_fn(state, scene, params, cfg, rec, 20,
                               fit=("pedestrian.A",))
    with torch.no_grad():
        assert float(loss_fn({"pedestrian.A": torch.log(
            torch.tensor(4.5))})) < 1e-9
    # mode-text (reference PedMode.<NAME>) files load too
    path2 = str(tmp_path / "pedestrian_text.csv")
    csvout.write_pedestrian_csv(path2, observed, cfg.dt, use_native=False,
                                mode_text=True)
    rec2, _ = csvout.read_pedestrian_csv(path2)
    assert torch.equal(rec2.mode[a], observed.mode[a])


# -- fit_params ---------------------------------------------------------------

def test_fit_params_tracks_jax():
    """Five Adam iterations (lr 0.05) of ``pedestrian.A`` and
    ``pedestrian.gamma`` from (2.0, 0.55) at 24 x 80: every iteration's
    loss, the callback's values and the fitted values within rtol 1e-4
    of the JAX package's ``fit_params`` (optax.adam; the port's
    ``torch.optim.Adam`` has its betas and eps)."""
    jb, pb, jobs = both(24, 80)
    fit = ("pedestrian.A", "pedestrian.gamma")
    start = {"pedestrian.A": 2.0, "pedestrian.gamma": 0.55}
    seen = {"jax": [], "port": []}
    jr = jcal.fit_params(jb[3], jb[0], jcal.replace_params(jb[1], start),
                         jb[2], jobs, 80, fit=fit, iters=5,
                         learning_rate=0.05,
                         callback=lambda i, l, v: seen["jax"].append(v))
    pr = cal.fit_params(pb[3], pb[0], cal.replace_params(pb[1], start),
                        pb[2], record_to_torch(jobs), 80, fit=fit, iters=5,
                        learning_rate=0.05,
                        callback=lambda i, l, v: seen["port"].append(v))
    np.testing.assert_allclose(pr.losses, jr.losses, rtol=1e-4)
    assert pr.losses[-1] < pr.losses[0]
    for pv, jv in zip(seen["port"], seen["jax"]):
        for k in fit:
            np.testing.assert_allclose(pv[k], jv[k], rtol=1e-4)
    for k in fit:
        np.testing.assert_allclose(pr.fitted[k], jr.fitted[k], rtol=1e-4)
        assert isinstance(cal.get_param(pr.params, k), float)
    np.testing.assert_allclose(pr.final_loss, jr.final_loss, rtol=1e-4)
    assert pr.initial_loss == pr.losses[0]


def test_fit_returns_the_scene_vector_on_its_device():
    scene, params, cfg, state = benchmark_bundle(8, extent=8.0, device=CPU)
    _, observed = make_rollout_fn(scene, params, cfg, 10)(state)
    result = cal.fit_params(state, scene, params, cfg, observed, 10,
                            fit=("scene.spawn.pair_scale",), iters=2)
    got = result.scene.spawn.pair_scale
    assert got.dtype == torch.float32 and got.shape == (8,)
    assert got.device == scene.spawn.step.device
    np.testing.assert_allclose(
        got.numpy(), result.fitted["scene.spawn.pair_scale"], rtol=1e-6)
    assert result.params == params


# -- refusals -----------------------------------------------------------------

def test_refuses_a_typod_theta_key():
    scene, params, cfg, state = benchmark_bundle(4, device=CPU)
    _, observed = make_rollout_fn(scene, params, cfg, 2)(state)
    loss_fn = cal.make_loss_fn(state, scene, params, cfg, observed, 2,
                               fit=("pedestrian.A",))
    with pytest.raises(ValueError, match="do not match"):
        loss_fn({"pedestrain.A": torch.tensor(1.0)})
    with pytest.raises(ValueError, match="frames"):
        cal.make_loss_fn(state, scene, params, cfg, observed, 4)


def test_refuses_a_none_scene_leaf_and_a_nonpositive_start():
    scene, params, cfg, state = benchmark_bundle(8, extent=8.0, device=CPU)
    _, observed = make_rollout_fn(scene, params, cfg, 10)(state)
    with pytest.raises(ValueError, match="initial"):
        cal.fit_params(state, scene, params, cfg, observed, 10,
                       fit=("scene.spawn.law_id",), iters=1)
    zero = cal.replace_param(params, "pedestrian.A", 0.0)
    with pytest.raises(ValueError, match="log_space"):
        cal.fit_params(state, scene, zero, cfg, observed, 10,
                       fit=("pedestrian.A",), iters=1)
    # log_space=False takes it
    r = cal.fit_params(state, scene, zero, cfg, observed, 10,
                       fit=("pedestrian.A",), iters=1, log_space=False)
    assert np.isfinite(r.final_loss)


GRAD = torch.tensor(4.5, requires_grad=True)


@pytest.mark.parametrize("build", [
    lambda: pparams.moussaid_vector(MoussaidParams(A=GRAD), CPU),
    lambda: pparams.powerlaw_vector(PowerLawParams(k=GRAD), CPU),
    lambda: pparams.helbing_vector(
        pparams.PedRepulsiveParams(v0=GRAD), CPU),
    lambda: pparams.law_rows("moussaid", MoussaidParams(gamma=GRAD), 3,
                             CPU),
    lambda: pparams.exp_rows(GRAD, 0.1, 3, CPU),
    lambda: pparams.section_rows(MoussaidParams(A=GRAD), 2),
    lambda: forces.number_rows(GRAD, 2),
], ids=["moussaid_vector", "powerlaw_vector", "helbing_vector", "law_rows",
        "exp_rows", "section_rows", "number_rows"])
def test_kernel_parameter_builders_refuse_a_grad_leaf(build):
    """The kernels define no gradient: a builder of their parameters given
    a leaf that requires grad raises, naming the leaf, instead of turning
    it into a detached number."""
    with pytest.raises(ValueError, match="requires grad"):
        build()


def test_zero_d_leaves_are_not_a_sweep():
    params = cal.replace_param(benchmark_bundle(4, device=CPU)[1],
                               "pedestrian.A", torch.tensor(4.5))
    assert pparams.param_batch(params) is None
    swept = cal.replace_param(params, "pedestrian.A",
                              torch.tensor([4.0, 4.5]))
    assert pparams.param_batch(swept) == 2
