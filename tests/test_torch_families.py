"""PyTorch port: the model-family slice against the JAX package.

The power-law and Helbing pair laws, their cutoff forms, the social-group
force, the per-agent ``law_id``/``pair_scale`` row masks and the rollouts of
the JAX package's ``bench.py`` family switches (``BENCH_LAW=powerlaw``,
``BENCH_LAW=helbing``, ``BENCH_MIX=moussaid,powerlaw,helbing``,
``BENCH_GROUPS=0.5:4``).  Inputs are drawn with numpy from a seed and fed to
both packages; the JAX side runs its jnp path, its Pallas kernels in
interpret mode and the float64 oracles (``tests/oracle.py``,
``tests/test_powerlaw.py``).  On the CPU the port's kernel wrappers take the
plain versions; the CUDA kernels are held against those on the card, in
``tests/test_torch_cuda.py``.

Tolerances.  The power law is singular at contact: near tau_min the force
scales as tau^-3, so an ulp of tau is a relative 3e-7 of the force, and
near c = 0 or D = 0 the rounding of b, c and D moves tau by many ulps.  The
JAX package's own tests bound two evaluations of its own law by rtol 2e-3
(test_powerlaw.py:83-87, jnp with two row blocks), its Pallas kernel
against its jnp path by 3e-4 and the jnp path against the float64 oracle by
rtol 1e-3, atol 5e-5; the comparisons here use those bounds.  A gate (c > 0,
D > 0, a > 1e-8, 0 < tau < tau_max, the Helbing ellipse and field of view)
that flips between the two packages moves a force by far more than these
bounds; :func:`assert_forces_close` then names the pair and the gate it sat
on within an ulp or two, and nothing is loosened for it.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import oracle
from test_powerlaw import powerlaw_oracle
from carla_social_force_model_tpu.api.synthetic import (
    benchmark_bundle as jax_benchmark_bundle)
from carla_social_force_model_tpu.models import groups as jgroups
from carla_social_force_model_tpu.models import stepper as jstepper
from carla_social_force_model_tpu.models.params import (
    GroupParams as JaxGroupParams, PedRepulsiveParams as JaxPedRepulsive,
    PowerLawParams as JaxPowerLaw)
from carla_social_force_model_tpu.models.spawn import LAW_IDS
from carla_social_force_model_tpu.ops import forces as jforces
from carla_social_force_model_tpu.ops import pallas_forces as jpf
from carla_social_force_model_tpu_torch.api.synthetic import benchmark_bundle
from carla_social_force_model_tpu_torch.models import groups, stepper
from carla_social_force_model_tpu_torch.models.params import (
    GroupParams, PedRepulsiveParams, PowerLawParams, helbing_vector,
    powerlaw_vector)
from carla_social_force_model_tpu_torch.ops import cuda_forces, forces
from carla_social_force_model_tpu_torch.utils import convert

CPU = "cpu"
#: the power law against the JAX jnp path and its interpret-mode kernel
#: (see the module docstring)
PL_RTOL, PL_ATOL = 2e-3, 2e-5
#: the power law against the float64 oracle (test_powerlaw.py:66)
PL_ORACLE_RTOL, PL_ORACLE_ATOL = 1e-3, 5e-5
#: Helbing against the JAX jnp path and kernel: ulps of the roots, the
#: exp and the divisions, and f32 summation order (test_helbing_forces.py:
#: 132-133); against the float64 oracle, the JAX package's bound (:138)
HB_RTOL, HB_ATOL = 2e-4, 2e-5
HB_ORACLE_RTOL, HB_ORACLE_ATOL = 2e-3, 2e-4
#: the group force: f32 summation order over at most 8 members and the
#: ulps of atan2 and the roots
GROUP_TOL = 1e-5
#: positions after one step from the JAX package's own state (the stepper
#: parity tests' bound)
POS_TOL_M = 1e-4


def fields_of(obj):
    """A JAX-package dataclass as nested dicts of numpy arrays and Python
    values (what utils/convert.py takes)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: fields_of(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    return np.asarray(obj)


def crowd(n, seed, extent, dead=0.1):
    """A numpy-seeded crowd: positions, velocities, radii, alive mask and
    unit desired directions, with one coincident live pair."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-extent, extent, (n, 2)).astype(np.float32)
    vel = rng.uniform(-2.0, 2.0, (n, 2)).astype(np.float32)
    rad = rng.uniform(0.2, 0.4, n).astype(np.float32)
    alive = rng.uniform(size=n) >= dead
    e = rng.normal(size=(n, 2))
    e = (e / np.linalg.norm(e, axis=1, keepdims=True)).astype(np.float32)
    pos[1] = pos[0]
    alive[:2] = True
    return pos, vel, rad, alive, e


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def port_force(law, pos, vel, rad, alive, e, p, cutoff=None, sort=False,
               row_block=32):
    """The port's force of ``law`` (the plain version, through the wrapper
    the stepper calls) as an (N, 2) array."""
    args = (t(pos[:, 0]), t(pos[:, 1]), t(vel[:, 0]), t(vel[:, 1]), t(rad),
            t(alive), p)
    desired = (t(e[:, 0]), t(e[:, 1])) if law == "helbing" else None
    if sort:
        f = cuda_forces.pedestrian_force_sorted(*args, cutoff, law=law,
                                                desired=desired,
                                                row_block=row_block)
    else:
        f = cuda_forces.pedestrian_force_kernel(*args, law=law,
                                                desired=desired,
                                                row_block=row_block)
    return np.stack([f[0].numpy(), f[1].numpy()], axis=-1)


def _gate_pairs(law, pos, vel, rad, alive, p, rows):
    """The pairs of ``rows`` that sit within two ulps of a gate of ``law``,
    recomputed in float64: ``[(i, j, gate)]``."""
    out = []
    for i in rows:
        for j in range(pos.shape[0]):
            if i == j or not (alive[i] and alive[j]):
                continue
            x = pos[i].astype(np.float64) - pos[j]
            if law == "powerlaw":
                v = vel[i].astype(np.float64) - vel[j]
                a, b = v @ v, x @ v
                c = x @ x - float(rad[i] + rad[j]) ** 2
                disc = b * b - a * c
                vals = {"c": (c, x @ x), "disc": (disc, b * b)}
                if a > 1e-8 and disc > 0:
                    vals["tau"] = ((-b - np.sqrt(disc)) / a - p.tau_max,
                                   p.tau_max)
            else:
                y = p.step_width * vel[j].astype(np.float64)
                s = np.linalg.norm(x) + np.linalg.norm(x - y)
                vals = {"b": (s * s - y @ y, s * s)}
            for gate, (val, scale) in vals.items():
                if abs(val) <= 4 * np.finfo(np.float32).eps * abs(scale):
                    out.append((i, j, gate))
    return out


def assert_forces_close(law, got, want, rtol, atol, inputs, p):
    """``got`` within ``atol + rtol*|want|`` of ``want``; a row outside it
    must hold a pair on a gate within two ulps (a gate flip, named in the
    failure message), or the test fails."""
    bad = np.nonzero((np.abs(got - want) > atol + rtol * np.abs(want))
                     .any(axis=1))[0]
    if bad.size == 0:
        return
    pos, vel, rad, alive, e = inputs
    flips = _gate_pairs(law, pos, vel, rad, alive, p, bad)
    rows = {i for i, _, _ in flips}
    unexplained = [int(i) for i in bad if i not in rows]
    assert not unexplained, (
        f"rows {unexplained} differ beyond rtol {rtol}, atol {atol}: "
        f"got {got[unexplained]}, want {want[unexplained]}")
    pytest.fail(f"gate flips between the packages (pairs within two ulps "
                f"of a gate, rows {sorted(rows)}): {flips}")


# -- the parameter vectors ----------------------------------------------------

@pytest.mark.parametrize("law,kw", [("powerlaw", {}),
                                    ("powerlaw", dict(k=2.0, tau0=2.9)),
                                    ("helbing", {}),
                                    ("helbing", dict(fov_phi=75.5,
                                                     sigma=0.29))])
def test_param_vectors_equal_jax(law, kw):
    """The kernels' parameter vectors equal the JAX package's
    ``_params_vec`` bitwise, ``cos_phi`` included (float32 cos of the
    float32 angle)."""
    if law == "powerlaw":
        got = powerlaw_vector(PowerLawParams(**kw), CPU)
        want = jpf._params_vec(JaxPowerLaw(**kw), "powerlaw")
    else:
        got = helbing_vector(PedRepulsiveParams(**kw), CPU)
        want = jpf._params_vec(JaxPedRepulsive(**kw), "helbing")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the power law ------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_powerlaw_force_matches_jax_and_oracle(seed):
    """The plain power law against the JAX jnp path and the float64
    oracle, with dead agents and a coincident pair (which, overlapping,
    gives exactly 0); dead rows exactly 0; the force sum over alive agents
    vanishes (Newton's third law)."""
    inputs = crowd(72, seed, 12.0)
    pos, vel, rad, alive, e = inputs
    p = PowerLawParams()
    got = port_force("powerlaw", pos, vel, rad, alive, e, p)
    want = np.asarray(jforces.powerlaw_force(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(rad),
        jnp.asarray(alive), JaxPowerLaw(), row_block=16))
    assert_forces_close("powerlaw", got, want, PL_RTOL, PL_ATOL, inputs, p)
    ref = powerlaw_oracle(pos, vel, rad, alive, JaxPowerLaw())
    assert_forces_close("powerlaw", got, ref, PL_ORACLE_RTOL, PL_ORACLE_ATOL,
                        inputs, p)
    assert np.all(got[~alive] == 0.0)
    # Newton's third law, up to the f32 rounding of the row sums
    assert np.all(np.abs(got.sum(axis=0))
                  <= 8 * np.finfo(np.float32).eps * np.abs(got).sum(axis=0))


@pytest.mark.parametrize("symmetric", [False, True])
def test_powerlaw_force_matches_pallas_interpret(symmetric):
    """Against the JAX package's ``_pair_tile_powerlaw`` in interpret mode
    (its dense and Newton's-third-law launches)."""
    inputs = crowd(90, 5, 12.0)
    pos, vel, rad, alive, e = inputs
    p = PowerLawParams()
    got = port_force("powerlaw", pos, vel, rad, alive, e, p)
    want = np.asarray(jpf.pedestrian_force_pallas(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(rad),
        jnp.asarray(alive), JaxPowerLaw(), law="powerlaw", row_tile=8,
        col_tile=16, interpret=True, symmetric=symmetric))
    assert_forces_close("powerlaw", got, want, PL_RTOL, PL_ATOL, inputs, p)


def test_powerlaw_head_on_pair():
    """Two head-on walkers on a collision course are pushed apart along
    the line of approach, equal and opposite; reversed, they feel
    nothing (the JAX package's physics check, test_powerlaw.py:146)."""
    pos = np.array([[-3.0, 0.0], [3.0, 0.0]], np.float32)
    vel = np.array([[1.3, 0.0], [-1.3, 0.0]], np.float32)
    rad = np.full(2, 0.3, np.float32)
    alive = np.ones(2, bool)
    e = np.zeros((2, 2), np.float32)
    f = port_force("powerlaw", pos, vel, rad, alive, e, PowerLawParams())
    assert f[0, 0] < 0.0 < f[1, 0]
    np.testing.assert_allclose(f[0], -f[1], rtol=1e-6)
    f = port_force("powerlaw", pos, -vel, rad, alive, e, PowerLawParams())
    assert np.all(f == 0.0)


# -- Helbing ------------------------------------------------------------------

@pytest.mark.parametrize("seed", [3, 4, 5])
def test_helbing_force_matches_jax_and_oracle(seed):
    """The plain Helbing law against the JAX jnp path and the float64
    oracle (dead agents, a coincident pair, a zero desired direction);
    dead rows exactly 0."""
    inputs = crowd(70, seed, 8.0, dead=0.15)
    pos, vel, rad, alive, e = inputs
    e[3] = 0.0                                   # standing on its waypoint
    p = PedRepulsiveParams()
    got = port_force("helbing", pos, vel, rad, alive, e, p)
    want = np.asarray(jforces.ped_repulsive_force(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(e),
        jnp.asarray(alive), JaxPedRepulsive(), row_block=16))
    assert_forces_close("helbing", got, want, HB_RTOL, HB_ATOL, inputs, p)
    ref = oracle.ped_repulsive_force(
        pos.astype(np.float64), vel.astype(np.float64),
        e.astype(np.float64), alive, p.v0, p.sigma, p.fov_phi, p.fov_factor,
        p.step_width, p.b_min)
    # the oracle's coincident pair: d = 0 is masked in both (nd > 0)
    assert_forces_close("helbing", got, ref, HB_ORACLE_RTOL, HB_ORACLE_ATOL,
                        inputs, p)
    assert np.all(got[~alive] == 0.0) and np.isfinite(got).all()


def test_helbing_force_matches_pallas_interpret():
    """Against the JAX package's ``_pair_tile_helbing`` in interpret mode
    (desired directions staged in its row velocity slots), and
    ``symmetric`` is ignored for this law on both sides."""
    inputs = crowd(70, 3, 8.0, dead=0.15)
    pos, vel, rad, alive, e = inputs
    p = PedRepulsiveParams()
    got = port_force("helbing", pos, vel, rad, alive, e, p)
    want = np.asarray(jpf.pedestrian_force_pallas(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(rad),
        jnp.asarray(alive), JaxPedRepulsive(), law="helbing",
        desired=(jnp.asarray(e[:, 0]), jnp.asarray(e[:, 1])), row_tile=16,
        col_tile=128, interpret=True))
    assert_forces_close("helbing", got, want, HB_RTOL, HB_ATOL, inputs, p)
    args = [t(a) for a in (pos[:, 0], pos[:, 1], vel[:, 0], vel[:, 1])]
    dense = cuda_forces.pedestrian_force_kernel(
        *args, None, t(alive), p, symmetric=False, law="helbing",
        desired=(t(e[:, 0]), t(e[:, 1])))
    sym = cuda_forces.pedestrian_force_kernel(
        *args, None, t(alive), p, symmetric=True, law="helbing",
        desired=(t(e[:, 0]), t(e[:, 1])))
    assert all(torch.equal(a, b) for a, b in zip(dense, sym))


def test_wrappers_refuse_mismatched_laws():
    """Helbing has no symmetric kernel and needs desired directions; the
    other laws take none; ``use_radius`` is the Moussaid law's alone.  (The
    checks run before anything touches a card.)"""
    z = torch.zeros(4)
    alive = torch.ones(4, dtype=torch.bool)
    prm = torch.zeros(6)
    with pytest.raises(ValueError, match="no sym kernel"):
        cuda_forces.pair_force_sym(z, z, z, z, None, alive, prm,
                                   law="helbing")
    with pytest.raises(ValueError, match="desired"):
        cuda_forces.pair_force_dense(z, z, z, z, None, alive, prm,
                                     law="helbing")
    with pytest.raises(ValueError, match="desired"):
        cuda_forces.pair_force_dense(z, z, z, z, z, alive, prm[:4],
                                     law="powerlaw", desired=(z, z))
    with pytest.raises(ValueError, match="use_radius"):
        cuda_forces.pair_force_dense(z, z, z, z, z, alive, prm[:4],
                                     use_radius=True, law="powerlaw")
    with pytest.raises(ValueError, match="unknown pair law"):
        cuda_forces.pair_force_dense(z, z, z, z, z, alive, prm, law="orca")


# -- the cutoff forms ---------------------------------------------------------

@pytest.mark.parametrize("law,cutoff", [("powerlaw", 6.0), ("helbing", 1.5)])
def test_cutoff_forms_match_pallas_sorted(law, cutoff):
    """The cutoff path (Hilbert sort, the plain version with the per-pair
    cutoff, unsort) against the JAX package's sorted, compacted kernel in
    interpret mode with a forced narrow table (``max_surv=4``).  The
    cutoff truncates here: the all-pairs force differs.  (The JAX jnp
    stepper ignores the cutoff for these laws, so it is no reference.)"""
    inputs = crowd(128, 9, 20.0)
    pos, vel, rad, alive, e = inputs
    p = PowerLawParams() if law == "powerlaw" else PedRepulsiveParams()
    jp = JaxPowerLaw() if law == "powerlaw" else JaxPedRepulsive()
    got = port_force(law, pos, vel, rad, alive, e, p, cutoff=cutoff,
                     sort=True)
    want = np.asarray(jpf.pedestrian_force_pallas_sorted(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(rad),
        jnp.asarray(alive), jp, cutoff=cutoff, law=law,
        desired=((jnp.asarray(e[:, 0]), jnp.asarray(e[:, 1]))
                 if law == "helbing" else None),
        row_tile=8, col_tile=16, interpret=True, compact=True, max_surv=4))
    rtol, atol = (PL_RTOL, PL_ATOL) if law == "powerlaw" else (HB_RTOL,
                                                               HB_ATOL)
    assert_forces_close(law, got, want, rtol, atol, inputs, p)
    full = port_force(law, pos, vel, rad, alive, e, p)
    assert np.abs(full - got).max() > 10 * atol
    # the plain cutoff force without the sort is the same sum
    unsorted = cuda_forces.plain_law_force(
        law, t(pos[:, 0]), t(pos[:, 1]), t(vel[:, 0]), t(vel[:, 1]), t(rad),
        t(alive), p, False, 32, cutoff, (t(e[:, 0]), t(e[:, 1])))
    np.testing.assert_allclose(np.stack([f.numpy() for f in unsorted], -1),
                               got, rtol=1e-5, atol=1e-6)


# -- social groups ------------------------------------------------------------

def group_case(seed=0):
    """60 slots in groups of 2-6 (ids not contiguous) and ungrouped slots:
    dead members, a group with one survivor, a fully dead group, two
    coincident members and a member standing on its waypoint (zero gaze)."""
    rng = np.random.default_rng(seed)
    n = 60
    gid = np.full(n, -1, np.int32)
    sizes = [2, 3, 4, 5, 6, 4, 3, 2, 4]
    slot = 0
    for g, size in enumerate(sizes):
        gid[slot:slot + size] = 3 * g + 1
        slot += size
    rng.shuffle(gid)
    pos = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
    vel = rng.uniform(-1.5, 1.5, (n, 2)).astype(np.float32)
    e = rng.normal(size=(n, 2))
    e = (e / np.linalg.norm(e, axis=1, keepdims=True)).astype(np.float32)
    alive = rng.uniform(size=n) > 0.15
    members = {g: np.nonzero(gid == g)[0] for g in np.unique(gid[gid >= 0])}
    ids = sorted(members)
    alive[members[ids[0]]] = [True, False]           # one survivor
    alive[members[ids[1]]] = False                   # fully dead
    a, b = members[ids[2]][:2]
    pos[b] = pos[a]                                  # coincident members
    alive[[a, b]] = True
    e[members[ids[3]][0]] = 0.0                      # on its waypoint
    alive[members[ids[3]][0]] = True
    return pos, vel, e, alive, gid


def test_build_groups_equals_jax():
    _, _, _, _, gid = group_case()
    got = groups.build_groups(gid, max_members=6, device=CPU)
    want = jgroups.build_groups(gid, max_members=6)
    np.testing.assert_array_equal(got.member_slot.numpy(),
                                  np.asarray(want.member_slot))
    assert got.member_slot.dtype == torch.int64
    assert (got.n_groups, got.max_members) == (9, 6)
    assert groups.build_groups(np.full(5, -1), device=CPU) is None
    with pytest.raises(ValueError, match="max_members"):
        groups.build_groups(gid, max_members=5, device=CPU)


def test_group_force_matches_jax_and_oracle():
    """The group force against the JAX package's and the float64 oracle:
    ungrouped slots, dead members and the last survivor of a group get
    exactly 0; nothing is NaN (coincident members, a zero gaze)."""
    pos, vel, e, alive, gid = group_case()
    g = groups.build_groups(gid, max_members=6, device=CPU)
    p = GroupParams()
    fx, fy = groups.group_force(t(pos[:, 0]), t(pos[:, 1]), t(vel[:, 0]),
                                t(vel[:, 1]), t(e[:, 0]), t(e[:, 1]),
                                t(alive), g, p)
    got = np.stack([fx.numpy(), fy.numpy()], axis=-1)
    jfx, jfy = jgroups.group_force(
        *(jnp.asarray(a) for a in (pos[:, 0], pos[:, 1], vel[:, 0],
                                   vel[:, 1], e[:, 0], e[:, 1], alive)),
        jgroups.build_groups(gid, max_members=6), JaxGroupParams())
    want = np.stack([np.asarray(jfx), np.asarray(jfy)], axis=-1)
    np.testing.assert_allclose(got, want, rtol=GROUP_TOL, atol=GROUP_TOL)
    ref = oracle.group_force(pos.astype(np.float64), vel.astype(np.float64),
                             e.astype(np.float64), alive, gid)
    # the JAX package's bound against this oracle (test_groups.py:65)
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-4)
    assert np.isfinite(got).all()
    lone = np.array([np.sum(alive[gid == k]) < 2 for k in gid]) | (gid < 0)
    assert np.all(got[~alive | lone] == 0.0)
    assert np.abs(got[alive & ~lone]).max() > 0.1


def test_scene_from_fields_builds_the_group_set():
    """A JAX scene's groups, carried over by utils/convert.py, equal the
    port's ``build_groups`` of the same group ids."""
    _, _, _, _, gid = group_case(3)
    js, _, _, _ = jax_benchmark_bundle(60, extent=6.0, use_pallas=False)
    js = dataclasses.replace(js, groups=jgroups.build_groups(gid,
                                                             max_members=6))
    got = convert.scene_from_fields(fields_of(js), CPU).groups
    want = groups.build_groups(gid, max_members=6, device=CPU)
    assert isinstance(got, groups.GroupSet)
    assert torch.equal(got.member_slot, want.member_slot)
    assert convert.scene_from_fields(
        fields_of(dataclasses.replace(js, groups=None)), CPU).groups is None


# -- the slice as a whole -----------------------------------------------------

FAMILIES = ("moussaid", "powerlaw", "helbing")


def bench_scene(scene, params, switch, jax_side):
    """``bench.py``'s family switches on a benchmark bundle of either
    package: ``powerlaw``/``helbing`` swap the pair law, ``mix-...`` splits
    ``law_id`` into equal contiguous chunks (bench.py:132-156),
    ``groups-<frac>:<size>`` groups the first ``frac`` of the slots
    (bench.py:157-169)."""
    cap = scene.spawn.capacity
    if switch in ("powerlaw", "helbing"):
        flag = ("enable_powerlaw" if switch == "powerlaw"
                else "enable_ped_repulsive")
        return scene, dataclasses.replace(params, enable_pedestrian=False,
                                          **{flag: True})
    if switch.startswith("mix-"):
        fams = switch[4:].split("-")
        law = np.full(cap, -1, np.int32)
        for fam, chunk in zip(fams, np.array_split(np.arange(cap),
                                                   len(fams))):
            law[chunk] = LAW_IDS[fam]
        law = jnp.asarray(law) if jax_side else torch.from_numpy(law)
        scene = dataclasses.replace(
            scene, spawn=dataclasses.replace(scene.spawn, law_id=law))
        return scene, dataclasses.replace(
            params, enable_pedestrian="moussaid" in fams,
            enable_powerlaw="powerlaw" in fams,
            enable_ped_repulsive="helbing" in fams)
    frac, size = switch[len("groups-"):].split(":")
    k = int(float(frac) * cap)
    gid = np.full(cap, -1, np.int32)
    gid[:k] = np.arange(k) // int(size)
    g = (jgroups.build_groups(gid, max_members=int(size)) if jax_side
         else groups.build_groups(gid, max_members=int(size), device=CPU))
    return (dataclasses.replace(scene, groups=g),
            dataclasses.replace(params, enable_group=True))


def both_bundles(n, extent, switch):
    js, jp, jc, jst = jax_benchmark_bundle(n, extent=extent,
                                           use_pallas=False)
    ps, pp, pc, _ = benchmark_bundle(n, extent=extent, device=CPU)
    js, jp = bench_scene(js, jp, switch, True)
    ps, pp = bench_scene(ps, pp, switch, False)
    return (js, jp, jc, jst), (ps, pp, pc)


def test_force_terms_with_law_id_and_pair_scale():
    """Every family and the group force at once, with a mixed ``law_id``
    (-1 = every family, 3 = ORCA's id with ORCA off: no pair force) and a
    per-agent ``pair_scale``: each term against the JAX package's, and the
    masked rows of each family exactly 0."""
    (js, jp, jc, jst), (ps, pp, pc) = both_bundles(90, 7.0, "groups-0.6:3")
    rng = np.random.default_rng(4)
    law = rng.integers(-1, 4, 90).astype(np.int32)
    scale = rng.uniform(0.5, 1.5, 90).astype(np.float32)
    js = dataclasses.replace(js, spawn=dataclasses.replace(
        js.spawn, law_id=jnp.asarray(law), pair_scale=jnp.asarray(scale)))
    ps = dataclasses.replace(ps, spawn=dataclasses.replace(
        ps.spawn, law_id=t(law), pair_scale=t(scale)))
    on = dict(enable_pedestrian=True, enable_powerlaw=True,
              enable_ped_repulsive=True)
    jp, pp = dataclasses.replace(jp, **on), dataclasses.replace(pp, **on)
    jstate, _ = jstepper.rollout(jst, js, jp, jc, 3, record=False)
    want = jstepper.force_terms(jstate, jstepper.prepare_scene(js), jp, jc,
                                None)
    pstate = convert.ped_state_from_fields(fields_of(jstate), CPU)
    got = stepper.force_terms(pstate, stepper.prepare_scene(ps), pp, pc)
    assert list(got) == list(want)
    tol = {"powerlaw_force": (PL_RTOL, PL_ATOL),
           "ped_repulsive_force": (HB_RTOL, HB_ATOL)}
    for name, (fx, fy) in got.items():
        g = np.stack([fx.numpy(), fy.numpy()], axis=-1)
        w = np.stack([np.asarray(a) for a in want[name]], axis=-1)
        rtol, atol = tol.get(name, (1e-5, 1e-5))
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=name)
    for name, fid in (("pedestrian_force", 0), ("powerlaw_force", 1),
                      ("ped_repulsive_force", 2)):
        off = (law >= 0) & (law != fid)
        assert all(np.all(c.numpy()[off] == 0.0) for c in got[name]), name
        assert np.abs(got[name][0].numpy()[~off]).max() > 0.0, name


@pytest.mark.parametrize("switch", ["powerlaw", "helbing",
                                    "mix-moussaid-powerlaw-helbing",
                                    "groups-0.5:4"])
def test_bench_scene_rollout_matches_jax_step_by_step(switch):
    """40 steps of each ``bench.py`` family scene (64 agents at 1 per
    m^2), the port stepped from the JAX package's own state at every step:
    positions within 1e-4 m, modes and alive equal."""
    (js, jp, jc, jst), (ps, pp, pc) = both_bundles(64, 8.0, switch)
    js = jstepper.prepare_scene(js)
    ps = stepper.prepare_scene(ps)
    jstep = jax.jit(lambda s, k: jstepper.simulation_step(s, js, jp, jc,
                                                          k)[0])
    worst = 0.0
    for k in range(40):
        pst = convert.ped_state_from_fields(fields_of(jst), CPU)
        got, _ = stepper.simulation_step(pst, ps, pp, pc, k)
        jst = jstep(jst, k)
        want = fields_of(jst)
        np.testing.assert_array_equal(got.alive.numpy(), want["alive"])
        np.testing.assert_array_equal(got.mode.numpy(), want["mode"])
        for name in ("pos_x", "pos_y"):
            worst = max(worst, float(np.abs(getattr(got, name).numpy()
                                            - want[name]).max()))
    assert worst <= POS_TOL_M, worst


def test_cutoff_step_sorts_once_for_every_family(monkeypatch):
    """With a cutoff, one Hilbert permutation per step serves the three
    pair families and the environment terms (config #2's borders), and the
    rollout equals the plain versions' (no sort)."""
    ps, pp, pc, pst = benchmark_bundle(48, extent=6.0, with_borders=True,
                                       device=CPU)
    ps, pp = bench_scene(ps, pp, "mix-moussaid-powerlaw-helbing", False)
    pc = dataclasses.replace(pc, interaction_cutoff=5.0)
    from carla_social_force_model_tpu_torch.ops import cuda_env, spatial
    calls = []

    def counted(*args, **kwargs):
        calls.append(1)
        return spatial.morton_order(*args, **kwargs)

    for mod in (stepper, cuda_forces, cuda_env):
        monkeypatch.setattr(mod, "morton_order", counted)
    _, rec = stepper.make_rollout_fn(ps, pp, pc, 3)(pst)
    assert len(calls) == 3
    ref = dataclasses.replace(pc, plain_pair_force=True, plain_env_force=True)
    _, want = stepper.make_rollout_fn(ps, pp, ref, 3)(pst)
    np.testing.assert_allclose(rec.pos.numpy(), want.pos.numpy(), atol=1e-5)


def test_check_supported_refuses_foreign_groups():
    ps, pp, pc, pst = benchmark_bundle(8, extent=5.0, device=CPU)
    with pytest.raises(TypeError, match="GroupSet"):
        stepper.simulation_step(
            pst, dataclasses.replace(ps, groups={"member_slot": np.zeros(
                (1, 2))}), dataclasses.replace(pp, enable_group=True), pc, 0)
