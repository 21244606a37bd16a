"""alego_tpu_torch — the PyTorch/CUDA port of the alego_tpu SLAM engine.

A second package beside ``alego_tpu`` (the JAX reference, which stays as it
is): the same fixed-capacity masked state and the same frame step, written
as plain PyTorch tensor code, with the three Pallas TPU kernels of the
reference re-written by hand as CUDA kernels for Hopper (``csrc/``).

The package imports torch, numpy and the standard library only — never jax
and nothing of ``alego_tpu``; it keeps its own copies of the configuration,
the synthetic renderer and the trajectory metrics.
"""

import torch as _torch

# Geometry math must be full f32: the k-NN distances, normal equations and
# covariances contract map-frame coordinates (~1e2 m) where TF32's 10-bit
# mantissa is metres of squared-distance noise.  Counterpart of the
# reference's jax_default_matmul_precision="highest".
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from .config import PipelineConfig, LaserType, DEFAULT_CONFIG, tiny_config  # noqa: E402
from .device import resolve_device  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "PipelineConfig",
    "LaserType",
    "DEFAULT_CONFIG",
    "tiny_config",
    "resolve_device",
]
