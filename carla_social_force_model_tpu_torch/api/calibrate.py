"""Differentiable calibration: fit SFM parameters to observed trajectories
(port of api/calibrate.py onto torch autograd and ``torch.optim``).

The whole rollout is a differentiable function of the force parameters
(``models/stepper.rollout``), so any numeric leaf of the reference's
``sfm_config.toml`` surface can be fitted to observed pedestrian
trajectories by gradient descent through the simulation: autograd
backpropagates through the eager step loop, and ``rollout(remat=True)``
(``torch.utils.checkpoint``) keeps the activation memory at the per-tick
carries instead of every tick's pairwise intermediates.

* A fit name is a dotted path into :class:`..models.params.SfmParams`
  (``"pedestrian.A"``, ``"acceleration.tau"``, ``"group.beta_vis"``), or,
  with the ``"scene."`` prefix, into the scene: ``"scene.spawn.pair_scale"``
  fits each pedestrian's interaction sensitivity, a ``(capacity,)``
  vector.
* ``theta`` maps each fit name to a float32 tensor on the state's device:
  0-d for a parameter, ``(capacity,)`` for ``pair_scale``.  With
  ``log_space`` (the default) ``param = exp(theta)``, which keeps positive
  parameters positive under unconstrained steps.  The values reach the
  params and the scene by ``dataclasses.replace``, so a parameter leaf is
  a 0-d tensor that carries the gradient (``models/params.param_batch``
  takes it for one value, not a sweep's).
* The observation is a :class:`..models.stepper.StepRecord`: what a
  recorded rollout returns, or ``utils/csvout.read_pedestrian_csv`` of a
  ``pedestrian.csv`` (CPU tensors; the loss moves them to the state's
  device).

Calibration runs the JAX package's jnp path (its ``use_pallas=False``):
the environment forces on the chunked point sets (``env_chunked``), the
pair forces, the environment forces and ORCA's wall feed on their plain
PyTorch versions (``plain_pair_force``, ``plain_env_force``), whose CUDA
kernels define no gradient, as the JAX package's fused Pallas kernels
define no VJP.  The chunk scan stays on its kernel (``kernel_chunk_scan``:
``chunk_argmin`` on a card), as the JAX package's ``_cp_kernel`` runs on
a TPU under its calibration: it yields each segment's closest point's
index and ``has_point``, which carry no gradient.  The builders of the
other kernels' parameters refuse a leaf that requires grad
(``models/params.refuse_grad``).  A fitted parameter set
(:attr:`CalibrationResult.params`, Python floats) runs straight on the
kernel path.
"""
from __future__ import annotations

import dataclasses
import gc
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from ..models.params import SfmParams
from ..models.state import PedState
from ..models.stepper import (Scene, StepConfig, StepRecord, detach_carry,
                              prepare_scene, rollout, simulation_step)
from ..ops import vecmath

#: default fit set: the Moussaid interaction parameters (the ones with the
#: most trajectory leverage; reference forces.py:60-73)
DEFAULT_FIT = ("pedestrian.A", "pedestrian.gamma", "pedestrian.lambda_")

#: prefix selecting SCENE leaves instead of SfmParams leaves in a ``fit``
#: name -- e.g. ``"scene.spawn.pair_scale"`` fits the per-agent
#: interaction-sensitivity vector (SpawnSchedule.pair_scale), which
#: post-multiplies each agent's summed pair force
#: (``models/stepper.force_terms``)
SCENE_PREFIX = "scene."


def get_param(params, name: str):
    """Fetch a parameter by dotted path, e.g. ``"pedestrian.A"`` or
    ``"acceleration.tau"``."""
    obj = params
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


def replace_param(params, name: str, value):
    """Functional update of a (possibly nested) parameter by dotted path."""
    head, _, rest = name.partition(".")
    if rest:
        value = replace_param(getattr(params, head), rest, value)
    return dataclasses.replace(params, **{head: value})


def replace_params(params: SfmParams,
                   values: Mapping[str, object]) -> SfmParams:
    """Apply a ``{dotted-name: value}`` mapping to ``params``."""
    for name, value in values.items():
        params = replace_param(params, name, value)
    return params


def _apply_theta(params: SfmParams, scene: Scene, theta: Mapping[str, object],
                 log_space: bool):
    """Substitute theta (possibly log-space, possibly vector-valued) into
    the params / scene pair."""
    pvals, svals = {}, {}
    for name, v in theta.items():
        v = torch.exp(v) if log_space else v
        if name.startswith(SCENE_PREFIX):
            svals[name[len(SCENE_PREFIX):]] = v
        else:
            pvals[name] = v
    if pvals:
        params = replace_params(params, pvals)
    for name, v in svals.items():
        scene = replace_param(scene, name, v)
    return params, scene


def check_theta(theta: Mapping[str, object], fit: Sequence[str]) -> None:
    """Raise ``ValueError`` unless theta's keys are exactly ``fit``: a
    typo'd dotted name would otherwise fit the wrong parameter set
    (``replace_params`` raises only on names that do not exist at all)."""
    if set(theta) != set(fit):
        raise ValueError(
            f"theta keys {sorted(theta)} do not match fit={sorted(fit)}")


def _calibration_cfg(cfg: StepConfig) -> StepConfig:
    """``cfg`` on the JAX package's jnp path: the chunked environment
    forces, every kernel whose output a gradient passes through on its
    plain version, the chunk scan on its kernel (see the module's
    docstring)."""
    return dataclasses.replace(cfg, plain_pair_force=True,
                               plain_env_force=True, kernel_chunk_scan=True,
                               env_chunked=True, env_analytic=False,
                               env_compact=False)


def _on(observed: StepRecord, device) -> StepRecord:
    """The observed record's tensors on ``device``."""
    return StepRecord(*(torch.as_tensor(t).to(device) for t in observed))


def trajectory_mse(rec: StepRecord, observed: StepRecord,
                   vel_weight: float = 0.0) -> torch.Tensor:
    """Masked mean squared error between two recorded rollouts.

    Positions are compared only where BOTH records mark the slot alive (a
    parameter change that shifts an arrival tick by a step injects no
    discontinuous penalty; spawn schedules do not depend on the
    parameters).  ``vel_weight`` adds a weighted velocity-error term.
    """
    w = (rec.alive & observed.alive).to(rec.pos.dtype)
    denom = vecmath.maximum(w.sum(), 1.0)
    se = torch.square(rec.pos - observed.pos).sum(dim=-1)
    loss = (se * w).sum() / denom
    if vel_weight:
        sev = torch.square(rec.vel - observed.vel).sum(dim=-1)
        loss = loss + vel_weight * ((sev * w).sum() / denom)
    return loss


def make_loss_fn(state0: PedState, scene: Scene, params: SfmParams,
                 cfg: StepConfig, observed: StepRecord, num_steps: int,
                 fit: Sequence[str] = DEFAULT_FIT, log_space: bool = True,
                 record_stride: int = 1, vel_weight: float = 0.0,
                 remat: bool = True, grad_horizon: int | None = None
                 ) -> Callable[[dict], torch.Tensor]:
    """Scalar loss over the fitted parameters: ``loss_fn(theta)``, the
    :func:`trajectory_mse` of a rollout from ``state0`` against
    ``observed``.

    ``theta`` maps each dotted name in ``fit`` to a float32 tensor on the
    state's device (log-parameters with ``log_space``).  ``observed`` must
    have ``num_steps // record_stride`` frames (a rollout recorded with
    the same stride).  The scene is prepared and ``cfg`` switched to the
    jnp path here.  ``remat`` and ``grad_horizon=K`` are
    :func:`..models.stepper.rollout`'s: truncated BPTT over K-tick windows
    keeps the stiff power law's gradients finite; the Moussaid family's
    smooth exponentials take full BPTT, so the default is off.
    """
    cfg = _calibration_cfg(cfg)
    scene = prepare_scene(scene, analytic=cfg.env_analytic,
                          orca=params.enable_orca, chunked=cfg.env_chunked)
    t_obs = observed.pos.shape[0]
    if t_obs != num_steps // record_stride:
        raise ValueError(
            f"observed record has {t_obs} frames; expected "
            f"{num_steps // record_stride} (= num_steps/record_stride)")
    observed = _on(observed, state0.device)

    def loss_fn(theta: dict) -> torch.Tensor:
        check_theta(theta, fit)
        p, sc = _apply_theta(params, scene, theta, log_space)
        _, rec = rollout(state0, sc, p, cfg, num_steps, record=True,
                         record_stride=record_stride, remat=remat,
                         grad_horizon=grad_horizon)
        return trajectory_mse(rec, observed, vel_weight=vel_weight)

    return loss_fn


def make_teacher_forced_loss_fn(state0: PedState, scene: Scene,
                                params: SfmParams, cfg: StepConfig,
                                observed: StepRecord, num_steps: int,
                                fit: Sequence[str] = DEFAULT_FIT,
                                window: int = 8, log_space: bool = True,
                                vel_weight: float = 0.0,
                                ) -> Callable[[dict], torch.Tensor]:
    """Windowed teacher-forced loss: the mean squared ``<= window``-step
    prediction error.

    For stiff, hard-gated dynamics (the power law's collision-course gates,
    ORCA's projection) the full-trajectory MSE is chaotic in the
    parameters.  Every ``window`` ticks the simulated positions and
    velocities are reset from the observed record (where both mark the slot
    alive), starting from a detached copy of the state, so each window's
    gradient is exact and starts from data.  The reset tick's error is zero
    by construction and weighs 0.  The other state planes (modes, waypoint
    progress, timers) carry over from the simulation.  Needs a stride-1
    ``observed`` record and a scene without a reactive fleet (its state is
    not observed).
    """
    cfg = _calibration_cfg(cfg)
    scene = prepare_scene(scene, analytic=cfg.env_analytic,
                          orca=params.enable_orca, chunked=cfg.env_chunked)
    if scene.autopilot is not None:
        raise NotImplementedError(
            "teacher-forced calibration does not support reactive "
            "autopilot scenes (the fleet state is not observable)")
    if observed.pos.shape[0] != num_steps:
        raise ValueError(
            f"teacher forcing requires a stride-1 record: observed has "
            f"{observed.pos.shape[0]} frames, num_steps={num_steps}")
    if window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    obs = _on(observed, state0.device)
    opx, opy = obs.pos[..., 0], obs.pos[..., 1]
    ovx, ovy = obs.vel[..., 0], obs.vel[..., 1]

    def loss_fn(theta: dict) -> torch.Tensor:
        check_theta(theta, fit)
        p, sc = _apply_theta(params, scene, theta, log_space)
        st = state0
        acc_se = acc_w = torch.zeros((), dtype=torch.float32,
                                     device=state0.device)
        for t in range(num_steps):
            oal = obs.alive[t]
            reset = t % window == 0
            if reset:
                st = detach_carry(st)
                take = oal & st.alive
                st = dataclasses.replace(
                    st, pos_x=torch.where(take, opx[t], st.pos_x),
                    pos_y=torch.where(take, opy[t], st.pos_y),
                    vel_x=torch.where(take, ovx[t], st.vel_x),
                    vel_y=torch.where(take, ovy[t], st.vel_y))
            st, rec = simulation_step(st, sc, p, cfg, t)
            if reset:
                continue
            w = (rec.alive & oal).to(rec.pos_x.dtype)
            se = (torch.square(rec.pos_x - opx[t])
                  + torch.square(rec.pos_y - opy[t]))
            if vel_weight:
                se = se + vel_weight * (torch.square(rec.vel_x - ovx[t])
                                        + torch.square(rec.vel_y - ovy[t]))
            acc_se = acc_se + (se * w).sum()
            acc_w = acc_w + w.sum()
        return acc_se / vecmath.maximum(acc_w, 1.0)

    return loss_fn


@dataclasses.dataclass
class CalibrationResult:
    """Outcome of :func:`fit_params`."""

    params: SfmParams           #: params with the fitted values (floats)
    fitted: dict                 #: {dotted-name: float, or np.ndarray for
                                 #: vector-valued (per-agent) parameters}
    losses: np.ndarray           #: per-iteration loss curve
    initial_loss: float
    final_loss: float
    #: scene with the fitted ``scene.``-prefixed leaves (float32 tensors on
    #: the scene's device) substituted; None when no scene leaf was fit
    scene: Scene | None = None


def value_and_grad(loss_fn, theta: dict):
    """``(loss, {name: d loss / d theta[name]})`` at ``theta`` (the JAX
    ``value_and_grad``): the leaves are detached copies that require grad,
    and a leaf the loss does not reach gets a zero gradient (a parameter
    that enters only through masks, like ``orca.neighbor_dist``)."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in theta.items()}
    loss = loss_fn(leaves)
    grads = (torch.autograd.grad(loss, list(leaves.values()),
                                 allow_unused=True)
             if loss.requires_grad else [None] * len(leaves))
    return loss.detach(), {k: torch.zeros_like(v) if g is None else g
                           for (k, v), g in zip(leaves.items(), grads)}


def graph_capturable(state0: PedState, params: SfmParams) -> bool:
    """Whether :func:`fit_params` captures its loss and gradient as CUDA
    graphs: a state on a card and a loss that never waits for the host.
    ORCA's programs read a count of infeasible rows on the host, so an
    ORCA loss runs eagerly."""
    return state0.device.type == "cuda" and not params.enable_orca


def fit_params(state0: PedState, scene: Scene, params: SfmParams,
               cfg: StepConfig, observed: StepRecord, num_steps: int,
               fit: Sequence[str] = DEFAULT_FIT, iters: int = 150,
               learning_rate: float = 0.05,
               optimizer: Callable[[list], torch.optim.Optimizer]
               | None = None,
               log_space: bool = True, record_stride: int = 1,
               vel_weight: float = 0.0, remat: bool = True,
               grad_horizon: int | None = None,
               teacher_window: int | None = None,
               callback: Callable[[int, float, dict], None] | None = None,
               ) -> CalibrationResult:
    """Fit the named parameters to ``observed`` by Adam over the rollout
    loss.

    ``params`` (and, for ``scene.`` names, ``scene``) provide the initial
    guesses and the fixed values of everything else; ``pair_scale=None``
    starts at ones, any other scene leaf that is None raises.
    ``optimizer`` is a factory ``params_list -> torch.optim.Optimizer``
    (the counterpart of passing an optax transformation to the JAX
    function), called once on the list of theta tensors; the default is
    ``torch.optim.Adam(lr=learning_rate)``, optax.adam's betas (0.9,
    0.999) and eps 1e-8.  ``callback(i, loss, values)`` is called every
    iteration with the parameter-space values before the update.
    ``teacher_window=W`` switches the objective to
    :func:`make_teacher_forced_loss_fn` (``grad_horizon`` then has no
    effect).  The loss at theta_i is recorded before the i-th update; the
    final iterate is evaluated too, and the best theta seen is returned.

    On a card, where the loss can be captured (:func:`graph_capturable`),
    one evaluation of the loss and its gradient is captured as CUDA graphs
    (``torch.cuda.make_graphed_callables``, after its warm-up evaluations)
    and replayed every iteration, the counterpart of the JAX package's
    jitted update: the eager step is host-bound on a small crowd, some 200
    launches a tick forward and as many back.  The same values.  A replay
    launches the captured kernels without their wrappers, so the launch
    counts of ``ops/`` see the warm-up and the capture only.
    """
    if teacher_window is not None:
        loss_fn = make_teacher_forced_loss_fn(
            state0, scene, params, cfg, observed, num_steps, fit=fit,
            window=teacher_window, log_space=log_space,
            vel_weight=vel_weight)
    else:
        loss_fn = make_loss_fn(state0, scene, params, cfg, observed,
                               num_steps, fit=fit, log_space=log_space,
                               record_stride=record_stride,
                               vel_weight=vel_weight, remat=remat,
                               grad_horizon=grad_horizon)
    theta = {}
    for name in fit:
        if name.startswith(SCENE_PREFIX):
            v = get_param(scene, name[len(SCENE_PREFIX):])
            if v is None and name == "scene.spawn.pair_scale":
                # homogeneous crowds store None; start the per-agent fit
                # at the reference behavior (all ones)
                v = torch.ones((scene.spawn.capacity,))
            elif v is None:
                raise ValueError(
                    f"{name!r} is None on this scene; set an initial "
                    f"array before fitting it")
        else:
            v = get_param(params, name)
        v = torch.as_tensor(v, dtype=torch.float32).to(state0.device)
        if log_space and bool((v <= 0.0).any()):
            raise ValueError(
                f"log_space fit requires positive initial value(s) for "
                f"{name!r}; pass log_space=False")
        theta[name] = (torch.log(v) if log_space else v.clone()
                       ).requires_grad_(True)

    evaluate = loss_fn
    if graph_capturable(state0, params):
        names = list(theta)
        # A garbage-collection pass during the capture would run the
        # finalizers of dead objects that hold CUDA events, graphs or
        # memory, whose CUDA calls invalidate a capture: collect first and
        # hold collection off until both graphs are captured.
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            graphed = torch.cuda.make_graphed_callables(
                lambda *leaves: loss_fn(dict(zip(names, leaves))),
                tuple(v.detach().clone().requires_grad_(True)
                      for v in theta.values()), allow_unused_input=True)
        finally:
            if collecting:
                gc.enable()

        def evaluate(th):
            return graphed(*(th[k] for k in names))

    opt = (optimizer if optimizer is not None
           else lambda ps: torch.optim.Adam(ps, lr=learning_rate))(
               list(theta.values()))
    losses = []
    best_theta, best_loss = theta, np.inf
    for i in range(iters):
        loss, grads = value_and_grad(evaluate, theta)
        loss = float(loss)
        losses.append(loss)
        if loss < best_loss:
            best_theta = {k: v.detach().clone() for k, v in theta.items()}
            best_loss = loss
        if callback is not None:
            callback(i, loss, _theta_values(theta, log_space))
        for k, v in theta.items():
            v.grad = grads[k]
        opt.step()
    # the loss at theta_i is reported before the i-th update, so evaluate
    # the final iterate too and keep the best seen
    with torch.no_grad():
        final_loss = float(loss_fn(theta))
    if final_loss < best_loss:
        best_theta, best_loss = theta, final_loss

    fitted = _theta_values(best_theta, log_space)
    pfit = {k: v for k, v in fitted.items()
            if not k.startswith(SCENE_PREFIX)}
    sfit = {k[len(SCENE_PREFIX):]: v for k, v in fitted.items()
            if k.startswith(SCENE_PREFIX)}
    out_scene = None
    if sfit:
        out_scene = scene
        for name, v in sfit.items():
            out_scene = replace_param(out_scene, name, torch.as_tensor(
                v, dtype=torch.float32, device=scene.spawn.step.device))
    return CalibrationResult(
        params=replace_params(params, pfit), fitted=fitted,
        losses=np.asarray(losses, np.float64),
        initial_loss=float(losses[0]) if losses else float("nan"),
        final_loss=best_loss, scene=out_scene)


def _theta_values(theta: Mapping[str, torch.Tensor], log_space: bool) -> dict:
    """Parameter-space values: floats for scalars, numpy arrays for
    vectors."""
    out = {}
    for k, v in theta.items():
        v = (torch.exp(v) if log_space else v).detach()
        out[k] = float(v) if v.dim() == 0 else v.cpu().numpy()
    return out
