"""Video sampling for VLM inference (port of kornia_tpu/models/video.py;
reference: kornia-vlm video.rs).

The reference holds a fixed-capacity circular buffer of frames with
timestamps (``VideoSample<N>``, video.rs:63), applies per-frame
processing once (``process_frames``, video.rs:142), and stacks to an
``(N, 3, H, W)`` f32 tensor (``into_tensor``, video.rs:199). The frames
stay host numpy until :func:`preprocess_video` moves them to the card in
one copy and resizes and normalises them as one batch.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from kornia_tpu_torch import resolve_device, upload
from kornia_tpu_torch.models.processor import normalize_batch
from kornia_tpu_torch.models.vlm import sample_video_frames


@dataclass
class VideoMetadata:
    """Timing/structure info (reference VideoMetadata, video.rs:42)."""

    fps: Optional[float] = None
    timestamps: List[float] = field(default_factory=list)
    duration: Optional[float] = None


class VideoSample:
    """Fixed-capacity frame ring with timestamps.

    ``capacity`` plays the role of the reference's const ``N``: pushing
    past it drops the oldest frame (FixedCircularBuffer semantics).
    Frames are host numpy (H, W, 3) u8 — device work happens once, in
    :func:`preprocess_video`.
    """

    def __init__(self, capacity: int = 32):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._frames: deque = deque(maxlen=capacity)
        self._processed: deque = deque(maxlen=capacity)
        self._meta = VideoMetadata()

    def __len__(self) -> int:
        return len(self._frames)

    def add_frame(self, frame: np.ndarray, timestamp: float) -> None:
        """Append one (H, W, 3) u8 frame (video.rs:107 add_frame)."""
        frame = np.asarray(frame)
        if frame.ndim != 3 or frame.shape[2] != 3:
            raise ValueError(f"expected (H, W, 3) frame, got {frame.shape}")
        self._frames.append(frame)
        self._processed.append(False)
        self._meta.timestamps.append(float(timestamp))
        del self._meta.timestamps[:-self.capacity]

    def process_frames(
        self, processor: Callable[[np.ndarray], np.ndarray]
    ) -> None:
        """Apply ``processor`` once per frame (video.rs:142 semantics:
        already-processed frames are skipped on repeat calls)."""
        for i in range(len(self._frames)):
            if self._processed[i]:
                continue
            self._frames[i] = np.asarray(processor(self._frames[i]))
            self._processed[i] = True

    @property
    def frames(self) -> List[np.ndarray]:
        return list(self._frames)

    @property
    def metadata(self) -> VideoMetadata:
        return self._meta

    def _stacked(self) -> np.ndarray:
        """The frames as one (N, H, W, 3) array; they must share a shape."""
        if not self._frames:
            raise ValueError("empty video")
        shapes = {f.shape for f in self._frames}
        if len(shapes) != 1:
            raise ValueError(f"frames disagree on shape: {sorted(shapes)}")
        return np.stack(self._frames)

    def as_tensor(self, dtype: torch.dtype = torch.float32,
                  device="cuda") -> torch.Tensor:
        """Stack to (N, 3, H, W) ``dtype`` on ``device`` — reference
        into_tensor (video.rs:199). Frames must share one shape."""
        stack = upload(self._stacked(), resolve_device(device))
        return stack.permute(0, 3, 1, 2).to(dtype)


def sample_video(reader, n_frames: int = 8,
                 capacity: Optional[int] = None) -> VideoSample:
    """Uniform temporal sampling from a video reader into a VideoSample.

    ``reader`` is any object with the VideoReader surface
    (``n_frames``/``fps``/``seek_frame``/``read`` — io/video.py or
    io/mjpeg_avi.py). The smolvlm2 video processor's strategy: pick
    ``n_frames`` indices spread evenly over the clip.
    """
    total = int(reader.n_frames)
    fps = float(reader.fps) if reader.fps else None
    sample = VideoSample(capacity=capacity or max(n_frames, 1))
    if total <= 0:
        # stream with unknown length: read sequentially
        i = 0
        while len(sample) < n_frames:
            f = reader.read()
            if f is None:
                break
            ts = i / fps if fps else float(i)
            sample.add_frame(f, ts)
            i += 1
        sample.metadata.fps = fps
        return sample

    idx = sample_video_frames(total, n_frames)
    for i in idx.tolist():
        reader.seek_frame(i)
        f = reader.read()
        if f is None:
            continue
        sample.add_frame(f, i / fps if fps else float(i))
    sample.metadata.fps = fps
    if fps and total:
        sample.metadata.duration = total / fps
    return sample


def preprocess_video(
    sample: VideoSample, image_size: int = 384,
    mean: Tuple[float, ...] = (0.5, 0.5, 0.5),
    std: Tuple[float, ...] = (0.5, 0.5, 0.5),
    device="cuda",
) -> torch.Tensor:
    """(N frames) → (N, S, S, 3) float32 on ``device``, normalised as
    :func:`processor.preprocess_image` does each frame, in one batched
    resize and normalise."""
    if not len(sample):
        raise ValueError("empty video")
    stack = upload(sample._stacked(), resolve_device(device))
    return normalize_batch(stack, image_size, mean, std)
