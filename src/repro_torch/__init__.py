"""PyTorch/CUDA port of the PM2Lat reproduction (``src/repro`` is the JAX
reference).  Imports torch, never jax, and nothing of ``repro``."""
