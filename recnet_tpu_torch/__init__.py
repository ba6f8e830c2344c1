"""RecNet in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The port of the JAX package ``recnet_tpu``, module for module. It imports
``torch`` and nothing of ``jax`` or ``recnet_tpu``: what it needs of the
JAX package's jax-free modules (the run config, the vocab, the frame and
text transforms, the datasets and the caption scorers) it keeps as its own
copies under the same module names (``config``, ``data``, ``metrics``).
Parameters keep the JAX layout (input-major weights), so both packages hold
the same arrays.
"""

__version__ = "0.1.0"
