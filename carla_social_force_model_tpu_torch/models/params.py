"""Typed, validated Social-Force-Model parameters (port of models/params.py).

Plain frozen dataclasses of Python numbers: the JAX package needed pytree
registration so sweeps could trace its leaves; here the values that a
kernel reads on the device travel as a small tensor
(:func:`moussaid_vector`, :func:`powerlaw_vector`, :func:`helbing_vector`),
so nothing else has to be a tensor.

A parameter sweep (``parallel/sweeps.batch_params``) makes every numeric
leaf a float32 ``(B,)`` tensor, as the JAX package's batched pytree does;
the shape knobs of ``OrcaParams`` (``static`` in their field metadata)
stay numbers.  Such params never reach the cached vectors above (a frozen
dataclass with tensor leaves hashes by identity and cannot compare):
:func:`law_rows` builds the ``(B, P)`` parameter matrix of the batched
kernels uncached, :func:`section_rows` splits a section into its rows for
the plain versions and :func:`as_column` views the leaves as ``(B, 1)``
against the step's ``(B, N)`` planes.

Calibration (``api/calibrate.py``) puts 0-d float32 tensors that carry a
gradient into the leaves it fits.  :func:`param_batch` takes such a leaf
for one value, not a sweep's; the plain versions compute with it, and the
builders of the kernels' parameters (:func:`moussaid_vector` and its kin,
:func:`law_rows`, :func:`exp_rows`, :func:`section_rows`) refuse it with
``ValueError``, since the kernels define no gradient.

The TOML surface, the config-key quirks and ``strict_parity`` are those of
the JAX package (see its module docstring): the keys as written in the
config are honoured, falling back to the reference's read-keys and then to
the reference defaults.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass, field

import torch


@dataclass(frozen=True)
class AccelerationParams:
    """Helbing-Molnar (1995) relaxation force. Reference: forces.py:35-53."""

    tau: float = 0.5


@dataclass(frozen=True)
class MoussaidParams:
    """Moussaid et al. (2009) interaction-force parameters.

    Shared by the pedestrian-pedestrian force and the static/dynamic
    obstacle forces; ``perception_threshold`` is only read by the obstacle
    variants.
    """

    lambda_: float = 2.0
    A: float = 4.5
    gamma: float = 0.35
    n: float = 2.0
    n_prime: float = 3.0
    epsilon: float = 0.005
    perception_threshold: float = 20.0


@dataclass(frozen=True)
class BorderParams:
    """Exponential wall-repulsion parameters. Reference: forces.py:120-137."""

    a: float = 3.0
    b: float = 0.1


@dataclass(frozen=True)
class PedRepulsiveParams:
    """Helbing-Molnar (1995) elliptical pedestrian repulsion (see the JAX
    package for the ``b_min`` regularisation)."""

    v0: float = 2.1
    sigma: float = 0.3
    fov_phi: float = 100.0   # degrees
    fov_factor: float = 0.5
    step_width: float = 1.0  # Delta-t of the anticipation term [s]
    b_min: float = 0.1       # semi-minor-axis floor [m]


@dataclass(frozen=True)
class PowerLawParams:
    """Karamouzas-Skinner-Guy (PRL 2014) time-to-collision power law."""

    k: float = 1.5
    tau0: float = 3.0
    tau_max: float = 20.0
    tau_min: float = 1e-2


@dataclass(frozen=True)
class OrcaParams:
    """ORCA (van den Berg et al., ISRR 2011) velocity-projection law."""

    tau: float = 2.0
    neighbor_dist: float = 15.0
    tau_static: float = 2.0
    # shape knobs: never batched (the JAX package's static fields)
    max_neighbors: int = field(default=10, metadata={"static": True})
    window: int = field(default=64, metadata={"static": True})
    max_vehicles: int = field(default=4, metadata={"static": True})
    max_statics: int = field(default=3, metadata={"static": True})


@dataclass(frozen=True)
class SpaceRepulsiveParams:
    """Helbing-Molnar (1995) boundary repulsion U(d) = U0*exp(-d/R)."""

    u0: float = 10.0
    r: float = 0.2


@dataclass(frozen=True)
class GroupParams:
    """Moussaid et al. (2010) social-group forces."""

    beta_vis: float = 4.0
    beta_att: float = 3.0
    beta_rep: float = 1.0
    rep_distance: float = 0.55


def _moussaid_from_dict(section: dict, default_threshold: float) -> MoussaidParams:
    return MoussaidParams(
        lambda_=float(section.get("lambda", 2.0)),
        A=float(section.get("A", 4.5)),
        gamma=float(section.get("gamma", 0.35)),
        n=float(section.get("n", 2.0)),
        n_prime=float(section.get("n_prime", 3.0)),
        epsilon=float(section.get("epsilon", 0.005)),
        perception_threshold=float(section.get("perception_threshold", default_threshold)),
    )


@dataclass(frozen=True)
class SfmParams:
    """Full SFM parameter set (the reference's sfm_config.toml surface)."""

    acceleration: AccelerationParams = field(default_factory=AccelerationParams)
    pedestrian: MoussaidParams = field(default_factory=MoussaidParams)
    border: BorderParams = field(default_factory=BorderParams)
    static_obstacle: MoussaidParams = field(default_factory=MoussaidParams)
    dynamic_obstacle: MoussaidParams = field(
        default_factory=lambda: MoussaidParams(perception_threshold=50.0))
    max_speed_factor: float = 1.3
    use_ped_radius: bool = False
    # force on/off flags ([forces] table; pedestrian_simulation.py:32-55)
    enable_acceleration: bool = True
    enable_pedestrian: bool = True
    enable_border: bool = True
    enable_static_obstacle: bool = False
    enable_dynamic_obstacle: bool = False
    ped_repulsive: PedRepulsiveParams = field(default_factory=PedRepulsiveParams)
    space_repulsive: SpaceRepulsiveParams = field(
        default_factory=SpaceRepulsiveParams)
    enable_ped_repulsive: bool = False
    enable_space_repulsive: bool = False
    powerlaw: PowerLawParams = field(default_factory=PowerLawParams)
    enable_powerlaw: bool = False
    group: GroupParams = field(default_factory=GroupParams)
    enable_group: bool = False
    orca: OrcaParams = field(default_factory=OrcaParams)
    enable_orca: bool = False
    # reproduce reference-inert config keys & first-vehicle-extent quirk
    strict_parity: bool = False

    @staticmethod
    def from_dict(cfg: dict, strict_parity: bool = False) -> "SfmParams":
        """Build params from a parsed sfm_config.toml-style dict.

        Enabling the reference's dead force flags under ``strict_parity``
        raises, as in the JAX package.
        """
        forces = cfg.get("forces", {})
        if strict_parity:
            for dead in ("ped_repulsive_force", "space_repulsive_force",
                         "powerlaw_force", "group_force", "orca_law"):
                if forces.get(dead, False):
                    raise ValueError(
                        f"strict parity: force '{dead}' is a dead config path "
                        "in the reference (enabling it crashes init_forces "
                        "with an AttributeError); disable strict_parity to "
                        "use this framework's working implementation")

        goal = cfg.get("goal_force", {})
        accel = cfg.get("acceleration_force", {})
        if strict_parity:
            tau = float(goal.get("tau", 0.5))
            max_speed_factor = float(cfg.get("max_speed_factor", 1.3))
        else:
            tau = float(accel.get("tau", goal.get("tau", 0.5)))
            max_speed_factor = float(
                cfg.get("max_speed_multiplier", cfg.get("max_speed_factor", 1.3))
            )

        border_cfg = cfg.get("border_force", {})
        pr = cfg.get("ped_repulsive_force", {})
        sr = cfg.get("space_repulsive_force", {})
        pw = cfg.get("powerlaw_force", {})
        gr = cfg.get("group_force", {})
        oc = cfg.get("orca_law", {})
        return SfmParams(
            orca=OrcaParams(
                tau=float(oc.get("tau", 2.0)),
                neighbor_dist=float(oc.get("neighbor_dist", 15.0)),
                tau_static=float(oc.get("tau_static", 2.0)),
                max_neighbors=int(oc.get("max_neighbors", 10)),
                window=int(oc.get("window", 64)),
                max_vehicles=int(oc.get("max_vehicles", 4)),
                max_statics=int(oc.get("max_statics", 3))),
            enable_orca=bool(forces.get("orca_law", False))
            and not strict_parity,
            group=GroupParams(
                beta_vis=float(gr.get("beta_vis", 4.0)),
                beta_att=float(gr.get("beta_att", 3.0)),
                beta_rep=float(gr.get("beta_rep", 1.0)),
                rep_distance=float(gr.get("rep_distance", 0.55))),
            enable_group=bool(forces.get("group_force", False))
            and not strict_parity,
            powerlaw=PowerLawParams(
                k=float(pw.get("k", 1.5)),
                tau0=float(pw.get("tau0", 3.0)),
                tau_max=float(pw.get("tau_max", 20.0)),
                tau_min=float(pw.get("tau_min", 1e-2))),
            enable_powerlaw=bool(forces.get("powerlaw_force", False))
            and not strict_parity,
            ped_repulsive=PedRepulsiveParams(
                v0=float(pr.get("v0", 2.1)),
                sigma=float(pr.get("sigma", 0.3)),
                fov_phi=float(pr.get("fov_phi", 100.0)),
                fov_factor=float(pr.get("fov_factor", 0.5)),
                step_width=float(pr.get("step_width", 1.0)),
                b_min=float(pr.get("b_min", 0.1))),
            space_repulsive=SpaceRepulsiveParams(
                u0=float(sr.get("u0", 10.0)), r=float(sr.get("r", 0.2))),
            enable_ped_repulsive=bool(forces.get("ped_repulsive_force", False))
            and not strict_parity,
            enable_space_repulsive=bool(forces.get("space_repulsive_force", False))
            and not strict_parity,
            acceleration=AccelerationParams(tau=tau),
            pedestrian=_moussaid_from_dict(cfg.get("pedestrian_force", {}), 20.0),
            border=BorderParams(
                a=float(border_cfg.get("a", 3.0)), b=float(border_cfg.get("b", 0.1))
            ),
            static_obstacle=_moussaid_from_dict(cfg.get("static_obstacle_force", {}), 20.0),
            dynamic_obstacle=_moussaid_from_dict(cfg.get("dynamic_obstacle_force", {}), 50.0),
            max_speed_factor=max_speed_factor,
            use_ped_radius=bool(cfg.get("use_ped_radius", False)),
            enable_acceleration=bool(forces.get("acceleration_force", False)),
            enable_pedestrian=bool(forces.get("pedestrian_force", False)),
            enable_border=bool(forces.get("border_force", False)),
            enable_static_obstacle=bool(forces.get("static_obstacle_force", False)),
            enable_dynamic_obstacle=bool(forces.get("dynamic_obstacle_force", False)),
            strict_parity=strict_parity,
        )


def refuse_grad(where: str, *leaves) -> None:
    """Raise ``ValueError`` when a parameter section or leaf among
    ``leaves`` carries a gradient: ``where`` would turn it into a detached
    number for a kernel, and the kernels define no gradient."""
    for leaf in leaves:
        named = ([(f"{type(leaf).__name__}.{f.name}", getattr(leaf, f.name))
                  for f in dataclasses.fields(leaf)]
                 if dataclasses.is_dataclass(leaf) else [("a leaf", leaf)])
        for name, v in named:
            if isinstance(v, torch.Tensor) and v.requires_grad:
                raise ValueError(
                    f"{where}: the parameter {name} requires grad, and the "
                    f"CUDA kernels define no gradient; run the plain "
                    f"versions (StepConfig(plain_pair_force=True, "
                    f"plain_env_force=True), as api/calibrate.py does)")


@functools.lru_cache(maxsize=32)
def moussaid_vector(p: MoussaidParams, device: torch.device | str) -> torch.Tensor:
    """``(lambda_, A, gamma, n, n_prime, epsilon)`` as a float32 ``(6,)``
    tensor on ``device`` -- the counterpart of ``_params_vec`` in the JAX
    package's ops/pallas_forces.py.  The pair-force kernels read their
    parameters through this tensor's device pointer, so a step never copies
    them from the host.  Cached per (params, device): callers must not
    write to the returned tensor.  A leaf that requires grad raises
    (:func:`refuse_grad`)."""
    refuse_grad("moussaid_vector", p)
    return torch.tensor([p.lambda_, p.A, p.gamma, p.n, p.n_prime, p.epsilon],
                        dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=32)
def powerlaw_vector(p: PowerLawParams, device: torch.device | str
                    ) -> torch.Tensor:
    """``(k, tau0, tau_max, tau_min)`` as a float32 ``(4,)`` tensor on
    ``device``: the power-law kernels' parameters (the JAX package's
    ``_params_vec(p, "powerlaw")``).  Cached and guarded as
    :func:`moussaid_vector`."""
    refuse_grad("powerlaw_vector", p)
    return torch.tensor([p.k, p.tau0, p.tau_max, p.tau_min],
                        dtype=torch.float32, device=device)


def helbing_cos_phi(p: PedRepulsiveParams) -> float:
    """cos of the field-of-view half-angle, evaluated in float32 as the JAX
    package does (``jnp.cos(jnp.deg2rad(fov_phi))``), so that the plain
    version and the kernels decide the FoV test on the same float."""
    phi = torch.tensor(p.fov_phi, dtype=torch.float32)
    return float(torch.cos(torch.deg2rad(phi)))


@functools.lru_cache(maxsize=32)
def helbing_vector(p: PedRepulsiveParams, device: torch.device | str
                   ) -> torch.Tensor:
    """``(v0, sigma, cos_phi, fov_factor, step_width, b_min)`` as a float32
    ``(6,)`` tensor on ``device``: the Helbing kernels' parameters (the JAX
    package's ``_params_vec(p, "helbing")``; ``cos_phi`` from
    :func:`helbing_cos_phi`).  Cached and guarded as
    :func:`moussaid_vector`."""
    refuse_grad("helbing_vector", p)
    return torch.tensor([p.v0, p.sigma, helbing_cos_phi(p), p.fov_factor,
                         p.step_width, p.b_min],
                        dtype=torch.float32, device=device)


#: the numeric parameter sections of SfmParams, in the JAX package's order
SECTIONS = ("acceleration", "pedestrian", "border", "static_obstacle",
            "dynamic_obstacle", "ped_repulsive", "space_repulsive",
            "powerlaw", "group", "orca")


def param_batch(params: SfmParams) -> int | None:
    """B of swept params (``(B,)`` tensor leaves), None when every leaf is
    a number or a 0-d tensor (one value, as calibration fits it).  The
    step asks several times a tick, so the answer for the last params
    object is kept (by identity: the dataclasses are frozen)."""
    last, answer = _LAST_BATCH[0]   # one read: threads may share this
    if last is params:
        return answer
    answer = None
    for leaf in (params.max_speed_factor,
                 *(getattr(getattr(params, s), f.name) for s in SECTIONS
                   for f in dataclasses.fields(getattr(params, s)))):
        if isinstance(leaf, torch.Tensor) and leaf.dim() == 1:
            answer = leaf.shape[0]
            break
    _LAST_BATCH[0] = (params, answer)
    return answer


#: param_batch's last params object and its answer
_LAST_BATCH: list = [(None, None)]


def map_leaves(params: SfmParams, fn) -> SfmParams:
    """``params`` with ``fn`` applied to every tensor leaf."""
    def sec(section):
        upd = {f.name: fn(getattr(section, f.name))
               for f in dataclasses.fields(section)
               if isinstance(getattr(section, f.name), torch.Tensor)}
        return dataclasses.replace(section, **upd) if upd else section
    upd = {s: sec(getattr(params, s)) for s in SECTIONS}
    if isinstance(params.max_speed_factor, torch.Tensor):
        upd["max_speed_factor"] = fn(params.max_speed_factor)
    return dataclasses.replace(params, **upd)


def as_column(x):
    """A ``(B,)`` tensor leaf as ``(B, 1)``, so that it broadcasts against
    ``(B, N)`` planes as the JAX package's vmapped scalar does; a section
    with such leaves, each viewed so; a number unchanged."""
    if isinstance(x, torch.Tensor):
        return x[:, None]
    if dataclasses.is_dataclass(x):
        upd = {f.name: getattr(x, f.name)[:, None]
               for f in dataclasses.fields(x)
               if isinstance(getattr(x, f.name), torch.Tensor)}
        return dataclasses.replace(x, **upd) if upd else x
    return x


def section_rows(section, batch: int) -> list:
    """The ``batch`` rows of a parameter section as sections of Python
    numbers (each tensor leaf read once, as float32 values): the per-row
    parameters of the plain versions.  An unbatched section is every
    row's.  A leaf that requires grad raises (:func:`refuse_grad`)."""
    refuse_grad("section_rows", section)
    cols = {f.name: getattr(section, f.name).tolist()
            for f in dataclasses.fields(section)
            if isinstance(getattr(section, f.name), torch.Tensor)}
    if not cols:
        return [section] * batch
    return [dataclasses.replace(section, **{k: v[b] for k, v in cols.items()})
            for b in range(batch)]


def _leaf_rows(values, batch: int, device) -> torch.Tensor:
    """``(batch, P)`` float32 matrix of a parameter vector whose entries
    are numbers or ``(batch,)`` tensors (the numbers shared by every
    row)."""
    for v in values:
        if isinstance(v, torch.Tensor) and v.shape != (batch,):
            raise ValueError(f"a swept parameter leaf of shape "
                             f"{tuple(v.shape)} in a batch of {batch}")
    cols = [v.to(device=device, dtype=torch.float32)
            if isinstance(v, torch.Tensor)
            else torch.full((batch,), float(v), dtype=torch.float32,
                            device=device)
            for v in values]
    return torch.stack(cols, dim=-1)


def law_rows(law: str, p, batch: int, device) -> torch.Tensor:
    """``(batch, P)`` float32 parameter matrix of the batched kernels of
    ``law`` (``"moussaid"``, ``"powerlaw"``, ``"helbing"``; the vectors'
    order): row b holds row b's parameters.  Unbatched params expand their
    cached vector with stride 0 (no copy); swept params are stacked here,
    uncached.  A leaf that requires grad raises (:func:`refuse_grad`)."""
    refuse_grad("law_rows", p)
    fns = {"moussaid": moussaid_vector, "powerlaw": powerlaw_vector,
           "helbing": helbing_vector}
    if not any(isinstance(getattr(p, f.name), torch.Tensor)
               for f in dataclasses.fields(p)):
        vec = fns[law](p, device)
        return vec.expand(batch, vec.shape[0])
    if law == "moussaid":
        values = (p.lambda_, p.A, p.gamma, p.n, p.n_prime, p.epsilon)
    elif law == "powerlaw":
        values = (p.k, p.tau0, p.tau_max, p.tau_min)
    else:
        phi = p.fov_phi
        cos_phi = (torch.cos(torch.deg2rad(phi.to(torch.float32)))
                   if isinstance(phi, torch.Tensor) else helbing_cos_phi(p))
        values = (p.v0, p.sigma, cos_phi, p.fov_factor, p.step_width,
                  p.b_min)
    return _leaf_rows(values, batch, device)


@functools.lru_cache(maxsize=32)
def _pair_vector(a: float, b: float, device) -> torch.Tensor:
    return torch.tensor([a, b], dtype=torch.float32, device=device)


def exp_rows(a, b, batch: int, device) -> torch.Tensor:
    """``(batch, 2)`` float32 ``(a, b)`` of the batched exp kernel: numbers
    expand one cached vector with stride 0, ``(batch,)`` tensors are
    stacked.  A leaf that requires grad raises (:func:`refuse_grad`)."""
    refuse_grad("exp_rows", a, b)
    if not (isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor)):
        return _pair_vector(float(a), float(b), device).expand(batch, 2)
    return _leaf_rows((a, b), batch, device)
