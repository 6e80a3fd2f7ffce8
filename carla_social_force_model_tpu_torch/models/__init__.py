"""Simulation model: state, FSM, spawning, the tick."""

from . import modes  # noqa: F401
from .params import SfmParams  # noqa: F401
from .state import PedState  # noqa: F401

__all__ = ["modes", "SfmParams", "PedState"]
