"""contour_context_tpu_torch: the PyTorch + CUDA port of contour_context_tpu.

Runs the fused per-scan loop-closure stream (descriptor build -> query ->
append -> temporal window), the map path (build a map in blocks, checkpoint
and merge it, serve batched localization from it), the file pipeline and
its CLI, scoring and sweeps (eval/), and the online spinner on an explicit
torch device. The two Pallas kernels of the JAX package are hand-written
CUDA kernels here (ops/kernels.py, csrc/); every other stage is plain
torch, and scans are read by a native loader (utils/native_loader.py). The
port imports torch and never jax, and nothing of the JAX package: it keeps
its own copies of the configuration (config.py), the data plane (utils/),
the evaluation (eval/) and the live view (liveview.py).

The configuration and `pad_points` import eagerly; the DB, the pipeline and
the spinner on first use, as in the JAX package.
"""

from contour_context_tpu_torch.config import (
    CandidateScoreEnsemble,
    ContourDBConfig,
    ContourManagerConfig,
    ContourSimThresConfig,
    GMMOptConfig,
    PipelineConfig,
    ScoreConstellSim,
    ScorePairwiseSim,
    ScorePostProc,
    TreeBucketConfig,
    load_pipeline_config_yaml,
    mulran_pipeline_config,
)
from contour_context_tpu_torch.utils.io import pad_points

__all__ = ["CandidateScoreEnsemble", "ContourDBConfig", "ContourManagerConfig",
           "ContourSimThresConfig", "GMMOptConfig", "PipelineConfig",
           "ScoreConstellSim", "ScorePairwiseSim", "ScorePostProc",
           "TreeBucketConfig", "load_pipeline_config_yaml",
           "mulran_pipeline_config", "pad_points"]
__version__ = "0.1.0"

_LAZY = {"ContourDB": "db", "QueryHandle": "db", "drain_handles": "db",
         "LoopClosurePipeline": "pipeline", "run_batch": "pipeline",
         "OnlineSpinner": "online", "LoopDetection": "online",
         "ScanDesc": "types"}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(
            f"contour_context_tpu_torch.{_LAZY[name]}")
        return getattr(mod, name)
    raise AttributeError(name)
