"""PyTorch port: every shipped scenario stepped from the JAX package's own
state, the first half of the scenarios (the second half is in
``test_torch_scenario_step_b.py``, so that ``--dist loadfile`` spreads
them).

For each scenario, each of its first 40 steps: the port steps once from the
JAX package's state (and fleet state) on the CPU, through the plain
versions and the chunked environment path, and lands within 1e-5 m of the
JAX package's step with equal modes, alive masks and fleet flags.
"""
import pytest

from scenario_jax import (assert_step_close, one_torch_thread,  # noqa: F401
                          step_both)


@pytest.mark.parametrize("scen,sfm", [
    ("corridor_counterflow", None), ("road_crossing", None),
    ("obstacle_evasion", None), ("circle_holding", None),
    ("orthogonal_crossing", None), ("jaywalking_reactive", None),
    ("sidewalk_counterflow", None), ("routed_town", None)])
def test_scenario_steps_match_jax(scen, sfm):
    assert step_both(scen, sfm, range(40), assert_step_close) == 40
