"""RecNet in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The port of the JAX package ``recnet_tpu``, module for module. It imports
``torch`` and never ``jax``; the jax-free parts of ``recnet_tpu`` (config,
vocab, frame transforms) are reused as a library. Parameters keep the JAX
layout (input-major weights), so both packages hold the same arrays.
"""

__version__ = "0.1.0"
