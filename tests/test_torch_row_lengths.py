"""The per-row real lengths of the port's segment-major point sets, which
the environment kernels read to stop each scan at a row's last real point
(``env/pointsets.segment_major``, ``analytic_split``): on config #3's
borders and parked cars, the urban path's curb borders and the full Town02
sidewalk capture, each length is the row's count of non-``PAD_COORD``
slots, every padding slot lies after the last real one, and the lengths
equal the real slots of the JAX package's rows for the same scene.  Runs
on the CPU.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from carla_social_force_model_tpu.api import synthetic as jsyn
from carla_social_force_model_tpu.env import borders as jborders
from carla_social_force_model_tpu.env import pointsets as jpointsets
from carla_social_force_model_tpu_torch.api import synthetic as psyn
from carla_social_force_model_tpu_torch.env import borders as pborders
from carla_social_force_model_tpu_torch.env import cache as pcache
from carla_social_force_model_tpu_torch.env import pointsets as ppointsets
from carla_social_force_model_tpu_torch.env.pointsets import PAD_COORD

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
#: config #3 at N = 10,000: benchmark_bundle's extent max(25, sqrt(N))
EXTENT = 100.0


def town2_sets():
    """The full Town02 sidewalk capture as a border set of each package
    (api/scenario.py's reading of ``sidewalk_borders_npz``)."""
    with np.load(ROOT / "configs" / "data" / "town2_sidewalks_full.npz",
                 allow_pickle=True) as data:
        hit = dict(data)
    lines = pcache.arrays_to_ragged(hit)
    args = (lines, list(hit["centers"]), list(hit["section_lengths"]))
    return pborders.build_border_set(*args), jborders.build_border_set(*args)


def scene_sets(which):
    """(port, JAX) host-side point sets of one of the scenes."""
    if which == "config3 borders":
        return psyn.synthetic_borders(EXTENT), jsyn.synthetic_borders(EXTENT)
    if which == "config3 parked cars":
        return (psyn.synthetic_obstacles(EXTENT),
                jsyn.synthetic_obstacles(EXTENT))
    if which == "urban borders":
        kw = dict(n_routes=8, num_steps_hint=40)
        return (psyn.urban_bundle(48, device=CPU, **kw)[0].borders,
                jsyn.urban_bundle(48, **kw)[0].borders)
    return town2_sets()


SCENES = ["config3 borders", "config3 parked cars", "urban borders",
          "town02 sidewalks"]


def check_tail_padding(rows, lengths):
    """``lengths`` counts each row's real slots, and every slot from a
    row's length on is padding."""
    real = rows != PAD_COORD
    assert torch.equal(lengths.long(), real.sum(dim=1))
    slot = torch.arange(rows.shape[1])[None, :]
    assert torch.equal(real, slot < lengths.long()[:, None])


@pytest.mark.parametrize("which", SCENES)
def test_segment_major_lengths_count_the_real_points(which):
    pset, jset = scene_sets(which)
    seg = ppointsets.segment_major(pset, CPU)
    assert seg.lengths.dtype == torch.int32
    assert seg.lengths.shape == (seg.num_segments,)
    check_tail_padding(seg.x, seg.lengths)
    check_tail_padding(seg.y, seg.lengths)
    assert int(seg.lengths.max()) <= seg.points_per_segment
    jseg = jpointsets.segment_major(jset, max_points_per_segment=1 << 30)
    jreal = (np.asarray(jseg.points)[..., 0] != PAD_COORD).sum(axis=1)
    np.testing.assert_array_equal(seg.lengths.numpy(), jreal)


@pytest.mark.parametrize("which", SCENES)
def test_analytic_lengths_count_the_real_segments(which):
    pset, _ = scene_sets(which)
    geom, rest = ppointsets.analytic_split(pset, device=CPU)
    if geom is not None:
        assert geom.lengths.dtype == torch.int32
        check_tail_padding(geom.ax, geom.lengths)
        assert bool((geom.lengths >= 1).all())
    if rest is not None:
        seg = ppointsets.segment_major(rest, CPU)
        check_tail_padding(seg.x, seg.lengths)


def test_lengths_follow_the_planes_to_a_device_and_stay_optional():
    """The vehicles' per-step rows carry no lengths (every slot is
    scanned), and a set built without lengths keeps None."""
    from carla_social_force_model_tpu_torch.models import vehicles
    vstates = psyn.synthetic_vehicles(30.0, 4, 0.05, 10, device=CPU)
    seg, _, _ = vehicles.snapshot_segment_pointset(
        vehicles.vehicle_snapshot_at(vstates, 0), 50.0)
    assert seg.lengths is None
    full = ppointsets.segment_major(psyn.synthetic_borders(10.0), CPU)
    bare = ppointsets.SegmentPointSet(full.x, full.y, full.center_x,
                                      full.center_y, full.filter_radius)
    assert bare.lengths is None
