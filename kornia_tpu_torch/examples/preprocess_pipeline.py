"""Fused DNN preprocess on the card: camera frame → normalized CHW tensor
(port of examples/preprocess_pipeline.py; examples/cuda_fusion and
cuda_camera_preprocess: resize, normalise and CHW in K6's one kernel).

    python -m kornia_tpu_torch.examples.preprocess_pipeline
        (--image PATH | --video clip.avi) [--size 640] [--cpu]
"""

from __future__ import annotations

from kornia_tpu_torch import io as kio
from kornia_tpu_torch.examples._common import (DOG_JPEG, base_parser,
                                               configure_backend,
                                               ms_per_call, require_file,
                                               synchronize)
from kornia_tpu_torch.ops import preprocess as pp

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def config(size: int) -> pp.PreprocessorConfig:
    return pp.PreprocessorConfig(
        out_size=(size, size), normalize=pp.NormalizeMode.MEAN_STD,
        mean=IMAGENET_MEAN, std=IMAGENET_STD)


def main(argv=None) -> dict:
    p = base_parser(__doc__)
    p.add_argument("--image", default=None)
    p.add_argument("--video", default=None)
    p.add_argument("--size", type=int, default=640)
    args = p.parse_args(argv)
    if not args.video:
        require_file(p, args.image, "--image", DOG_JPEG)
    dev = configure_backend(args)
    cfg = config(args.size)

    def fused(x):
        return pp.resize_normalize_to_tensor(x, cfg, device=dev)

    if args.video:
        fps = kio.FpsCounter()
        n = 0
        with kio.VideoReader(args.video) as r:
            for i, frame in enumerate(r):
                out = fused(frame)
                synchronize(dev)
                fps.tick()
                n += 1
                if i % 30 == 0:
                    print(f"frame {i}: {tuple(out.shape)} "
                          f"{fps.fps():.1f} fps")
        return {"frames": n, "preprocess_calls": n}

    img = kio.read_image_any_rgb8(args.image)
    out = fused(img)
    print(f"in {img.shape} u8 → out {tuple(out.shape)} "
          f"{str(out.dtype).removeprefix('torch.')}")
    reps = 50
    ms = ms_per_call(lambda: fused(img), reps, dev)
    print(f"fused preprocess: {ms:.4f} ms/frame")
    return {"tensor": out.cpu().numpy(), "ms": ms, "preprocess_calls": 1 + reps}


if __name__ == "__main__":
    main()
