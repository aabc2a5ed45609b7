"""PointRCNN in PyTorch + CUDA for NVIDIA Hopper.

The second package of this repository: a port of :mod:`pointrcnn_tpu`
(JAX, the reference) to PyTorch (the two-stage eval forward, both online
training stages and the KITTI eval entry point, ``python -m
pointrcnn_tpu_torch.eval``), with the reference's Pallas kernels rewritten
by hand in CUDA C++ for sm_90a (``csrc/``).  Module names and structure mirror the JAX package so each
function has an obvious counterpart.  Imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
