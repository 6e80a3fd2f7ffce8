"""Compute: plain PyTorch force math and the CUDA pair-force wrappers."""

from . import forces, vecmath  # noqa: F401

__all__ = ["forces", "vecmath"]
