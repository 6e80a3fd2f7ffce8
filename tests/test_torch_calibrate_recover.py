"""PyTorch port: calibration recovers force parameters (the JAX package's
``test_recover_pedestrian_params``, ``tests/test_calibrate.py``) on the
CPU, through the port's plain versions.  Apart from
``tests/test_torch_calibrate.py``, whose comparisons with the JAX package
fill its time: the 150 iterations here are the longest single test of the
calibration slice.
"""
import pytest
import torch

from carla_social_force_model_tpu_torch.api import calibrate as cal
from carla_social_force_model_tpu_torch.api.synthetic import benchmark_bundle
from carla_social_force_model_tpu_torch.models import params as pparams
from carla_social_force_model_tpu_torch.models.stepper import make_rollout_fn

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the crowd is tiny, and the test workers run
    side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_recover_pedestrian_params():
    """A and gamma come back from (2.0, 0.55) at 24 x 80 in 150 Adam
    iterations (the JAX package's recovery test; remat off, which changes
    no value, for the CPU's time): final loss below 1e-2 x the initial
    one, A within 15% of 4.5 and gamma within 20% of 0.35.  The fitted
    params are Python floats, everything else untouched."""
    scene, params, cfg, state = benchmark_bundle(24, extent=8.0, device=CPU)
    _, observed = make_rollout_fn(scene, params, cfg, 80)(state)
    start = cal.replace_params(params, {"pedestrian.A": 2.0,
                                        "pedestrian.gamma": 0.55})
    result = cal.fit_params(state, scene, start, cfg, observed, 80,
                            fit=("pedestrian.A", "pedestrian.gamma"),
                            iters=150, learning_rate=0.05, remat=False)
    assert result.final_loss < result.initial_loss * 1e-2
    assert abs(result.fitted["pedestrian.A"] - 4.5) / 4.5 < 0.15, \
        result.fitted
    assert abs(result.fitted["pedestrian.gamma"] - 0.35) / 0.35 < 0.2, \
        result.fitted
    assert cal.get_param(result.params, "pedestrian.A") == pytest.approx(
        result.fitted["pedestrian.A"])
    assert isinstance(result.params.pedestrian.A, float)
    assert cal.get_param(result.params, "pedestrian.n") == 2.0
    assert result.scene is None
    # the fitted params run straight on the kernel path's wrappers
    pparams.moussaid_vector(result.params.pedestrian, CPU)
