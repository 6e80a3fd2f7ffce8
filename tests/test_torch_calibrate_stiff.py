"""PyTorch port: calibration of the stiff laws (the Karamouzas power law,
ORCA) and truncated BPTT (``rollout(grad_horizon=K)``) against the JAX
package.

As in ``tests/test_torch_calibrate.py``, the same crowd and the same
observed record (the JAX package's recorded rollout at the true
parameters) go through the JAX package's loss under ``jax.value_and_grad``
and the port's under torch autograd, both on the CPU; the tolerance is
rtol 1e-3 for the loss and every gradient.

Where the horizon is cut, and why.  The port's plain versions round every
operation on its own, as its CUDA kernels do, and equal the JAX package's
functions run op by op (``jax.disable_jit``) to 1e-7.  The JAX package's
loss is compiled, and XLA's CPU compiler contracts products into fused
multiply-adds.  The power law's time to collision divides by the root of
the discriminant ``b^2 - a*c``, which cancels catastrophically for a
grazing pair: at the true parameters, tick 5, agents 19 and 20 (5.2 m
apart), the fused and the per-operation discriminants are 0.003965 and
0.003990, and the pair force differs by 2.5e-3 relative.  The two forward
passes then part, and the stiff law amplifies the gap:

* teacher-forced with window 8, from the same observed resets (theta 0.4
  off in log space): the first window stays within 9.5e-6 m; the second
  parts at tick 12 (1.1e-5 m, 2.1e-4 m at tick 15), and windows 4-8 end
  0.02-0.11 m apart.  So window 8 is held over its first window (8 ticks),
  and window 2 (every window a reset and one predicted tick) over all 80;
* free-running (``grad_horizon``), at the same theta: the rollouts part at
  tick 8 (6.1e-5 m; 3.7e-3 m at tick 13).  So the power law is held over
  its first 8 ticks with K = 2, and K = 20 truncation over 80 ticks on the
  Moussaid law, whose rollouts do not part (5e-7 relative).

ORCA (16 x 120, window 8) is held over the whole horizon: its compiled
projection differs from the per-operation one at tick 0 only (agent 11,
2.4e-4 m/s).

How XLA contracts depends on the host's CPU, so the compiled loss is no
fixed reference: on a host with AVX-512 the power law's loss at window 2
came out 1.01492e-3 apart (relative), past RTOL.  So
:func:`assert_loss_and_grads_match` runs the JAX package's loss and
gradients op by op (``jax.disable_jit``).  The horizons above were cut
against the compiled loss and stay as they are; the observed record is
still the compiled rollout's, the same input to both packages.
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
from carla_social_force_model_tpu.models.stepper import (
    make_rollout_fn as jax_make_rollout_fn)
from carla_social_force_model_tpu_torch.api import calibrate as cal
from carla_social_force_model_tpu_torch.api import synthetic as psyn
from carla_social_force_model_tpu_torch.api.synthetic import benchmark_bundle
from carla_social_force_model_tpu_torch.models.stepper import (
    StepRecord, make_rollout_fn)

CPU = "cpu"
RTOL = 1e-3
#: the power law's fit, 0.4 off the truth (1.5, 3.0) in log space
PL_FIT = ("powerlaw.k", "powerlaw.tau0")
PL_THETA = {"powerlaw.k": np.log(np.float32(1.5)) + np.float32(0.4),
            "powerlaw.tau0": np.log(np.float32(3.0)) + np.float32(0.4)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the crowds are tiny, and the test workers run
    side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def powerlaw(scene, params):
    return scene, dataclasses.replace(params, enable_pedestrian=False,
                                      enable_powerlaw=True)


def orca(scene, params):
    return scene, dataclasses.replace(
        params, enable_pedestrian=False, enable_orca=True,
        orca=dataclasses.replace(params.orca, tau=1.5, window=0))


def both(n, steps, edit=None, extent=8.0):
    """The same crowd in both packages, each edited by ``edit(scene,
    params)``, and the JAX package's recorded rollout of ``steps`` ticks:
    ``(jax bundle, port bundle, observed)``."""
    jb = jax_benchmark_bundle(n, extent=extent, use_pallas=False)
    pb = benchmark_bundle(n, extent=extent, device=CPU)
    if edit is not None:
        jb = (*edit(*jb[:2]), *jb[2:])
        pb = (*edit(*pb[:2]), *pb[2:])
    _, jobs = jax_make_rollout_fn(*jb[:3], steps)(jb[3])
    return jb, pb, jobs


def first(jobs, steps):
    """The first ``steps`` frames of a JAX record."""
    return type(jobs)(*(a[:steps] for a in jobs))


def to_torch(rec) -> StepRecord:
    return StepRecord(*(torch.from_numpy(np.array(a)) for a in rec))


def assert_loss_and_grads_match(jb, pb, jobs, steps, fit, theta,
                                teacher=None, **kw):
    """The JAX package's and the port's loss and gradients at ``theta``
    within RTOL: ``make_teacher_forced_loss_fn`` with window ``teacher``,
    else ``make_loss_fn``."""
    js, jp, jc, jst = jb
    ps, pp, pc, pst = pb
    if teacher is not None:
        jl = jcal.make_teacher_forced_loss_fn(jst, js, jp, jc, jobs, steps,
                                              fit=fit, window=teacher, **kw)
        pl = cal.make_teacher_forced_loss_fn(pst, ps, pp, pc, to_torch(jobs),
                                             steps, fit=fit, window=teacher,
                                             **kw)
    else:
        jl = jcal.make_loss_fn(jst, js, jp, jc, jobs, steps, fit=fit, **kw)
        pl = cal.make_loss_fn(pst, ps, pp, pc, to_torch(jobs), steps,
                              fit=fit, **kw)
    with jax.disable_jit():  # op by op: see the module docstring
        jv, jg = jax.value_and_grad(jl)({k: jnp.asarray(v)
                                         for k, v in theta.items()})
    pv, pg = cal.value_and_grad(pl, {k: torch.tensor(v)
                                     for k, v in theta.items()})
    np.testing.assert_allclose(float(pv), float(jv), rtol=RTOL,
                               err_msg="loss")
    for k in fit:
        assert torch.isfinite(pg[k]).all(), k
        np.testing.assert_allclose(pg[k].numpy(), np.asarray(jg[k]),
                                   rtol=RTOL, err_msg=k)
    return float(pv), pg


@pytest.fixture(scope="module")
def powerlaw_case():
    return both(24, 80, powerlaw)


# -- the power law, teacher-forced --------------------------------------------

@pytest.mark.parametrize("window,steps", [(8, 8), (2, 80)])
def test_powerlaw_teacher_forced_matches_jax(powerlaw_case, window, steps):
    """``powerlaw.k`` and ``powerlaw.tau0`` at 24 agents, teacher-forced
    (the horizons: see the module docstring)."""
    jb, pb, jobs = powerlaw_case
    assert_loss_and_grads_match(jb, pb, first(jobs, steps), steps, PL_FIT,
                                PL_THETA, teacher=window)


def test_powerlaw_teacher_forced_zero_at_truth_and_bounded():
    """The JAX package's own checks on the port: windows restart from the
    observed data, so the loss at the true parameters is ~f32 epsilon; 0.4
    off, the gradients are finite and bounded, and k's is informative."""
    scene, params, cfg, state = benchmark_bundle(24, extent=8.0, device=CPU)
    scene, params = powerlaw(scene, params)
    _, observed = make_rollout_fn(scene, params, cfg, 80)(state)
    loss_fn = cal.make_teacher_forced_loss_fn(state, scene, params, cfg,
                                              observed, 80, fit=PL_FIT,
                                              window=8)
    truth = {k: torch.log(torch.tensor(cal.get_param(params, k),
                                       dtype=torch.float32)) for k in PL_FIT}
    with torch.no_grad():
        assert float(loss_fn(truth)) < 1e-8
    loss, grads = cal.value_and_grad(loss_fn, {k: torch.tensor(v)
                                               for k, v in PL_THETA.items()})
    assert float(loss) > 1e-5
    for k, g in grads.items():
        assert torch.isfinite(g) and abs(float(g)) < 1e3, (k, float(g))
    assert abs(float(grads["powerlaw.k"])) > 1e-7


# -- grad_horizon -------------------------------------------------------------

def test_grad_horizon_keeps_the_forward_bitwise(powerlaw_case):
    """``grad_horizon=20`` on the power law at 24 x 80: the same forward
    values bitwise (detaching is the identity forward), and the truncated
    gradients finite where full BPTT through the stiff law is not
    bounded."""
    _, (ps, pp, pc, pst), _ = powerlaw_case
    _, observed = make_rollout_fn(ps, pp, pc, 80)(pst)
    theta = {k: torch.tensor(v) for k, v in PL_THETA.items()}
    kw = dict(fit=PL_FIT, remat=False)
    loss_h = cal.make_loss_fn(pst, ps, pp, pc, observed, 80, grad_horizon=20,
                              **kw)
    loss_f = cal.make_loss_fn(pst, ps, pp, pc, observed, 80, **kw)
    with torch.no_grad():
        assert float(loss_h(theta)) == float(loss_f(theta))
    _, grads = cal.value_and_grad(loss_h, theta)
    for k, g in grads.items():
        assert torch.isfinite(g), k


@pytest.mark.parametrize("law,steps,horizon", [("moussaid", 80, 20),
                                               ("powerlaw", 8, 2)])
def test_grad_horizon_matches_jax(law, steps, horizon):
    """The truncated gradient against the JAX package's (the horizons: see
    the module docstring)."""
    if law == "powerlaw":
        jb, pb, jobs = both(24, steps, powerlaw)
        fit, theta = PL_FIT, PL_THETA
    else:
        jb, pb, jobs = both(24, steps)
        theta = {k: np.log(np.float32(v)) for k, v in (
            ("pedestrian.A", 3.0), ("pedestrian.gamma", 0.45),
            ("pedestrian.lambda_", 2.5), ("acceleration.tau", 0.6))}
        fit = tuple(theta)
    assert_loss_and_grads_match(jb, pb, jobs, steps, fit, theta,
                                grad_horizon=horizon)


# -- ORCA ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def orca_case():
    return both(16, 120, orca, extent=7.0)


def test_orca_tau_teacher_forced_matches_jax(orca_case):
    """``orca.tau`` (1.5 true, from 2.4) through the velocity projection,
    teacher-forced with window 8 and the velocity term, at 16 x 120: the
    candidate argmin and the fallback over the infeasible rows only (the
    JAX package computes every row) give the JAX package's gradient."""
    jb, pb, jobs = orca_case
    assert_loss_and_grads_match(jb, pb, jobs, 120, ("orca.tau",),
                                {"orca.tau": np.log(np.float32(2.4))},
                                teacher=8, vel_weight=1.0)


def test_orca_neighbor_dist_gradient_is_exactly_zero(orca_case):
    """``orca.neighbor_dist`` enters only through masks: its gradient is
    exactly 0.0 in both packages (not NaN from a masked root)."""
    jb, pb, jobs = orca_case
    js, jp, jc, jst = jb
    ps, pp, pc, pst = pb
    kw = dict(fit=("orca.neighbor_dist",), log_space=False)
    jg = jax.grad(jcal.make_loss_fn(jst, js, jp, jc, jobs, 120, **kw))(
        {"orca.neighbor_dist": jnp.asarray(12.0, jnp.float32)})
    loss, grads = cal.value_and_grad(
        cal.make_loss_fn(pst, ps, pp, pc, to_torch(jobs), 120, **kw),
        {"orca.neighbor_dist": torch.tensor(12.0)})
    assert torch.isfinite(loss)
    assert float(jg["orca.neighbor_dist"]) == 0.0
    assert float(grads["orca.neighbor_dist"]) == 0.0


# -- refusals -----------------------------------------------------------------

def test_teacher_forcing_refusals():
    """A scene with a reactive fleet (its state is not observed), a record
    whose stride is not 1, and a window that is not positive."""
    scene, params, cfg, state = psyn.urban_bundle(
        16, num_steps_hint=4, n_routes=8, n_roads=3, width=200.0,
        cross_spacing=80.0, vehicles_per_road=1, device=CPU)
    _, (observed, _) = make_rollout_fn(scene, params, cfg, 4)(state)
    with pytest.raises(NotImplementedError, match="autopilot"):
        cal.make_teacher_forced_loss_fn(state, scene, params, cfg, observed,
                                        4)
    scene, params, cfg, state = benchmark_bundle(8, device=CPU)
    _, observed = make_rollout_fn(scene, params, cfg, 4, record_stride=2)(
        state)
    with pytest.raises(ValueError, match="stride-1"):
        cal.make_teacher_forced_loss_fn(state, scene, params, cfg, observed,
                                        4)
    _, observed = make_rollout_fn(scene, params, cfg, 4)(state)
    for window in (0, -2):
        with pytest.raises(ValueError, match="window"):
            cal.make_teacher_forced_loss_fn(state, scene, params, cfg,
                                            observed, 4, window=window)
