"""Native capture → grayscale → FAST corners live loop, FAST on the card
(port of examples/camera_capture.py; examples/v4l and the orb_detector
example's live loop). Works against real hardware (``--uri
v4l2:/dev/video0``) or, headless, against a directory of .ppm/.pgm frames
driven through the same native grab API (``--uri dir:PATH``; by default a
few frames are synthesized into a temporary directory).

    python -m kornia_tpu_torch.examples.camera_capture
        [--uri v4l2:/dev/video0] [--frames 10] [--threshold 20] [--cpu]
"""

from __future__ import annotations

import os
import tempfile

from kornia_tpu_torch.examples._common import base_parser, configure_backend
from kornia_tpu_torch.features import fast
from kornia_tpu_torch.io import FpsCounter, NativeCapture
from kornia_tpu_torch.ops import color


def _synth_dir() -> str:
    """Write four moving-square 240×320 PPM frames for the virtual camera
    through the port's native library."""
    import ctypes

    import numpy as np

    from kornia_tpu_torch.native import load_native_library

    d = tempfile.mkdtemp(prefix="kornia_cam_")
    lib = load_native_library()
    fn = lib.kornia_image_write_pnm
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
    rng = np.random.default_rng(0)
    base = rng.integers(0, 64, (240, 320, 3), np.uint8)
    for i in range(4):
        f = base.copy()
        x = 40 + 50 * i
        f[80:160, x: x + 80] = 255
        fc = np.ascontiguousarray(f)
        fn(os.path.join(d, f"frame_{i}.ppm").encode(),
           fc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
           240, 320, 3)
    return d


def main(argv=None) -> dict:
    p = base_parser(__doc__)
    p.add_argument("--uri", default=None,
                   help="v4l2:/dev/videoN or dir:PATH (default: "
                        "synthesized virtual camera)")
    p.add_argument("--frames", type=int, default=10)
    p.add_argument("--threshold", type=float, default=20.0)
    args = p.parse_args(argv)
    dev = configure_backend(args)

    uri = args.uri or ("dir:" + _synth_dir())

    def step(rgb):
        gray = color.rgb_to_gray(rgb, device=dev)[..., 0]
        return fast.fast_detect(gray, threshold=args.threshold,
                                max_keypoints=1024, device=dev)

    fps = FpsCounter()
    corners = []
    with NativeCapture(uri) as cap:
        for i in range(args.frames):
            rgb = cap.grab_frame()
            n = int(step(rgb).mask.sum())
            fps.tick()
            corners.append(n)
            print(f"frame {i}: {rgb.shape[1]}x{rgb.shape[0]} "
                  f"{n} corners  ({fps.fps():.1f} fps)")
    print("done")
    return {"corners": corners, "detect_calls": args.frames}


if __name__ == "__main__":
    main()
