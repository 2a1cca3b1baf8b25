"""contour_context_tpu_torch: the PyTorch + CUDA port of contour_context_tpu.

Runs the fused per-scan loop-closure stream (descriptor build -> query ->
append -> temporal window) on an explicit torch device. The two Pallas
kernels of the JAX package are hand-written CUDA kernels here
(ops/kernels.py, csrc/); every other stage is plain torch. The port imports
torch and never jax; it reuses the JAX package's jax-free modules (config,
utils, eval), and re-exports the configuration and point padding that
scripts such as chip_smoke.py need, so they import only this package.
"""

from contour_context_tpu.config import ContourManagerConfig, PipelineConfig
from contour_context_tpu.utils.io import pad_points

__all__ = ["ContourManagerConfig", "PipelineConfig", "pad_points"]
__version__ = "0.1.0"
