"""Config loading, the CUDA kernel build, and conversion from the JAX package."""
