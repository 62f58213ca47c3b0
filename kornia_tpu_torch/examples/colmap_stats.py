"""Read a COLMAP text model, print its stats, optionally export the cloud
(port of examples/colmap_stats.py; examples/colmap_rerun with a PLY
export as the sink). Host code: no device work.

    python -m kornia_tpu_torch.examples.colmap_stats MODEL_DIR
        [--export-ply out.ply] [--cpu]
"""

from __future__ import annotations

import numpy as np

from kornia_tpu_torch import io as kio
from kornia_tpu_torch.examples._common import base_parser, configure_backend


def main(argv=None) -> dict:
    p = base_parser(__doc__)
    p.add_argument("model_dir")
    p.add_argument("--export-ply", default=None)
    args = p.parse_args(argv)
    configure_backend(args)

    cams, imgs, pts = kio.read_colmap_model(args.model_dir)
    print(f"cameras: {len(cams)}")
    for cid, c in cams.items():
        print(f"  {cid}: {c.model} {c.width}x{c.height}")
    print(f"images: {len(imgs)}")
    track_lens = [len(pt.track) for pt in pts.values()]
    errs = [pt.error for pt in pts.values()]
    if pts:
        print(f"points3D: {len(pts)}  mean track {np.mean(track_lens):.1f}"
              f"  mean reproj err {np.mean(errs):.2f} px")
    centers = np.stack([im.camera_center() for im in imgs.values()]) \
        if imgs else np.empty((0, 3))
    span = None
    if len(centers):
        span = centers.max(0) - centers.min(0)
        print(f"trajectory span: {span.round(2)}")

    if args.export_ply and pts:
        xyz = np.stack([pt.xyz for pt in pts.values()])
        rgb = np.stack([pt.rgb for pt in pts.values()])
        kio.write_ply(args.export_ply, xyz, colors=rgb)
        print(f"wrote {args.export_ply} ({len(xyz)} points)")
    return {"cameras": len(cams), "images": len(imgs), "points": len(pts),
            "span": span}


if __name__ == "__main__":
    main()
