"""AprilTag detection and pose (port of kornia_tpu/apriltag/).

The dense threshold runs on the card; the CCL, clustering and quad fit in
the port's native C++; the decode and the pose in float64 numpy on the
host. The 9 tag families are data tables copied from the reference.
"""

from kornia_tpu_torch.apriltag.families import (
    FAMILY_NAMES,
    TagFamily,
    get_family,
    render_tag,
)
from kornia_tpu_torch.apriltag.threshold import adaptive_threshold
from kornia_tpu_torch.apriltag.detector import (
    AprilTagDecoder,
    Detection,
    DetectorConfig,
)
from kornia_tpu_torch.apriltag.pose import (
    TagPose,
    TagPosePair,
    estimate_tag_pose,
)

__all__ = [
    "FAMILY_NAMES",
    "TagFamily",
    "get_family",
    "render_tag",
    "adaptive_threshold",
    "AprilTagDecoder",
    "Detection",
    "DetectorConfig",
    "TagPose",
    "TagPosePair",
    "estimate_tag_pose",
]
