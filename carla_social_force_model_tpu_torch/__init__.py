"""PyTorch/CUDA port of the Social Force Model framework.

The counterpart of ``carla_social_force_model_tpu`` (the JAX package, which
stays the reference): the same headless crowd tick on planar ``(N,)``
tensors, with the pair forces (the Moussaid force, the power law, the
Helbing ellipse) and the environment forces in hand-written CUDA kernels
for Hopper (``csrc/``) and a plain PyTorch version of each kernel for the
CPU.  This package imports ``torch`` and never ``jax``.
"""

from .models.params import SfmParams
from .models.state import PedState
from .models import modes

__version__ = "0.1.0"

__all__ = ["SfmParams", "PedState", "modes", "__version__"]
