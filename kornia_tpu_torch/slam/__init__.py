"""Visual SLAM loop: tracking, mapping, loop closure, evaluation (port of
kornia_tpu/slam/)."""

from kornia_tpu_torch.slam.map import Keyframe, SlamMap
from kornia_tpu_torch.slam.system import (
    FrameResult,
    MonocularSlam,
    SlamConfig,
    TrackingState,
    TrackStepResult,
    track_step,
)
from kornia_tpu_torch.slam.evaluate import (
    AteResult,
    RpeResult,
    absolute_trajectory_error,
    relative_pose_error,
    umeyama_alignment,
    poses7_to_t44,
)
from kornia_tpu_torch.slam.checkpoint import load_map, save_map

__all__ = [
    "Keyframe",
    "SlamMap",
    "MonocularSlam",
    "SlamConfig",
    "TrackingState",
    "FrameResult",
    "TrackStepResult",
    "track_step",
    "AteResult",
    "RpeResult",
    "absolute_trajectory_error",
    "relative_pose_error",
    "umeyama_alignment",
    "poses7_to_t44",
    "save_map",
    "load_map",
]
