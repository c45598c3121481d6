"""PyTorch port of ``cycle_depth_estimation_tpu`` for one NVIDIA H100.

The package mirrors the JAX package's module names so each counterpart is
easy to find. Models take NCHW tensors and use the reference's state-dict
names; the two TPU kernels of the serving path are hand-written Hopper
kernels (``ops/kernels``). Entry points run on ``cuda`` unless the caller
passes ``device="cpu"`` (see ``device.py``).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
