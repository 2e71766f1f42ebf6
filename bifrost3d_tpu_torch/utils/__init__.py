"""Utilities: building and loading the CUDA kernels of ``csrc/``, trees of
tensors, caches keyed on tensor versions, checkpoint/resume and
profiling."""

from bifrost3d_tpu_torch.utils.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from bifrost3d_tpu_torch.utils.profiling import (
    FrameTimer,
    StageTimings,
    device_trace,
)

__all__ = [
    "save_checkpoint", "load_checkpoint", "latest_checkpoint",
    "FrameTimer", "StageTimings", "device_trace",
]
