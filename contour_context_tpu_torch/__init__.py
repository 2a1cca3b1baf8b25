"""contour_context_tpu_torch: the PyTorch + CUDA port of contour_context_tpu.

Runs the fused per-scan loop-closure stream (descriptor build -> query ->
append -> temporal window) on an explicit torch device. The two Pallas
kernels of the JAX package are hand-written CUDA kernels here
(ops/kernels.py, csrc/); every other stage is plain torch. The port imports
torch and never jax, and nothing of the JAX package: it keeps its own copies
of the configuration (config.py), the data plane (utils/) and the evaluator
(eval/). It re-exports the configuration and point padding that scripts such
as chip_smoke.py need.
"""

from contour_context_tpu_torch.config import ContourManagerConfig, PipelineConfig
from contour_context_tpu_torch.utils.io import pad_points

__all__ = ["ContourManagerConfig", "PipelineConfig", "pad_points"]
__version__ = "0.1.0"
