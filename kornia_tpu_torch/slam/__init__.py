"""Visual SLAM loop (port of kornia_tpu/slam/, in part): the per-frame
tracking step and the configuration and result types around it."""

from kornia_tpu_torch.slam.system import (FrameResult, SlamConfig,
                                          TrackingState, TrackStepResult,
                                          track_step)

__all__ = ["FrameResult", "SlamConfig", "TrackingState", "TrackStepResult",
           "track_step"]
