"""PnP demo: EPnP + RANSAC + LM on a synthetic distorted cube, on the card
(port of examples/pnp_demo.py; pnp_demo/src/main.rs:21-60 — a synthetic
cube with Brown-Conrady distortion).

    python -m kornia_tpu_torch.examples.pnp_demo [--noise 0.5]
        [--outliers 0.2] [--cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from kornia_tpu_torch.examples._common import base_parser, configure_backend
from kornia_tpu_torch.geometry import camera, liegroup as lg, pnp

K = np.array([[800.0, 0, 640], [0, 800.0, 360], [0, 0, 1]], np.float32)
DIST = np.array([-0.2, 0.05, 1e-3, -1e-3, 0.0], np.float32)


def scene(noise: float, outliers: float):
    """(world, px, t_true, n_out): the 27 cube corners and edge midpoints,
    their distorted pixels under a known pose with ``noise`` px of noise
    and a share ``outliers`` of them replaced by uniform draws
    (``default_rng(0)``). Made on the CPU in float32."""
    rng = np.random.default_rng(0)
    g = np.linspace(-0.5, 0.5, 3)
    world = np.array([[x, y, z] for x in g for y in g for z in g],
                     np.float32)
    # se3 twist is [rho(3); omega(3)] — translation block first
    xi = np.array([0.1, -0.05, 2.0, 0.1, -0.2, 0.05], np.float32)
    t_true = lg.se3_exp(torch.as_tensor(xi))
    cam = lg.se3_apply(t_true[None], torch.as_tensor(world)).numpy()
    xy_n = cam[:, :2] / cam[:, 2:]
    xy_d = camera.distort_points_polynomial(xy_n, DIST, device="cpu").numpy()
    px = xy_d * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
    px += rng.normal(0, noise, px.shape)
    n_out = int(len(px) * outliers)
    out_idx = rng.choice(len(px), n_out, replace=False)
    px[out_idx] = rng.uniform([0, 0], [1280, 720], (n_out, 2))
    return world, px, t_true.numpy(), n_out


def solve(world, px, device, sample_idx=None):
    """Undistort the pixels, then PnP-RANSAC (3 px) on ``device``: the
    hypotheses from a generator seeded 0 there (the reference's
    ``PRNGKey(0)``) or, given, ``sample_idx``."""
    px_u = camera.undistort_points(np.asarray(px, np.float32), K, DIST,
                                   device=device)
    gen = (None if sample_idx is not None
           else torch.Generator(device=device).manual_seed(0))
    return pnp.solve_pnp_ransac(world, px_u, K, threshold_px=3.0,
                                generator=gen, sample_idx=sample_idx,
                                device=device)


def errors(pose, t_true):
    """(rotation error in degrees, translation error) against the truth."""
    r_est = pose.rotation.cpu().numpy()
    t_est = pose.translation.cpu().numpy()
    r_true = lg.quat_to_matrix(lg.se3_quat(torch.as_tensor(t_true))).numpy()
    rot_err = np.rad2deg(np.arccos(np.clip(
        (np.trace(r_est @ r_true.T) - 1) / 2, -1, 1)))
    return float(rot_err), float(np.linalg.norm(t_est - t_true[4:]))


def main(argv=None) -> dict:
    p = base_parser(__doc__)
    p.add_argument("--noise", type=float, default=0.5)
    p.add_argument("--outliers", type=float, default=0.2)
    args = p.parse_args(argv)
    dev = configure_backend(args)

    world, px, t_true, n_out = scene(args.noise, args.outliers)
    print(f"{len(world)} points, {n_out} outliers, "
          f"noise σ={args.noise} px")
    pose, inliers, n_inl = solve(world, px, dev)
    rot_err, t_err = errors(pose, t_true)
    print(f"inliers: {int(n_inl)}/{len(world)}")
    print(f"rotation error: {rot_err:.3f}°, translation error: {t_err:.4f}")
    return {"inliers": int(n_inl), "rotation_error_deg": rot_err,
            "translation_error": t_err}


if __name__ == "__main__":
    main()
