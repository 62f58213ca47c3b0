"""Two-view relative pose, the monocular SLAM bootstrap (port of
kornia_tpu/geometry/twoview.py).

The epipolar RANSAC (the 8-point F, Sampson scoring; or with
``solver="5pt"`` Nistér's 5-point E on normalized coordinates, 6-point
samples, the LO refits as a weighted 8-point fit of E, Sampson residuals in
pixels through F = K2⁻ᵀ E K1⁻¹) and H-RANSAC (4-point DLT, symmetric
transfer scoring) run as batched programs; H wins when its support is at
least ``h_over_e_ratio`` of F's. The four (R, t) candidates of the winner
are voted on by cheirality, the winner is polished by the Sampson LM and
the inliers are triangulated.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from kornia_tpu_torch import resolve_device, to_device
from kornia_tpu_torch.geometry import epipolar as epi
from kornia_tpu_torch.geometry import triangulation as tri
from kornia_tpu_torch.geometry.camera import normalize_points
from kornia_tpu_torch.geometry.essential5pt import essential_5pt
from kornia_tpu_torch.geometry.ransac import ransac
from kornia_tpu_torch.geometry.refine import refine_pose_sampson, skew


@dataclasses.dataclass(frozen=True)
class TwoViewParams:
    """RANSAC and estimator settings, as kornia_tpu's TwoViewParams."""

    n_hypotheses: int = 512
    threshold_px: float = 1.5
    h_threshold_px: float = 3.0
    lo_iters: int = 2
    h_over_e_ratio: float = 0.9
    min_parallax_cos: float = 0.99998
    solver: str = "8pt"
    refine_iters: int = 12


class TwoViewResult(NamedTuple):
    rotation: torch.Tensor          # (3, 3) R: cam1 → cam2
    translation: torch.Tensor       # (3,) unit-norm t
    model: torch.Tensor             # (3, 3) winning F or H
    use_homography: torch.Tensor    # () bool
    inliers: torch.Tensor           # (N,) bool
    n_inliers: torch.Tensor         # () int
    points3d: torch.Tensor          # (N, 3) triangulated, cam1 frame
    cheirality_votes: torch.Tensor  # (4,)


def _essential_ransac(generator, x1, x2, k1, k2, mask,
                      params: TwoViewParams, sample_idx):
    """The 5-point E-RANSAC on normalized coordinates
    (kornia_tpu/geometry/twoview.py:79-110), its model returned as the
    pixel F = K2⁻ᵀ E K1⁻¹ of unit norm."""
    kinv1 = torch.linalg.inv_ex(k1)[0]
    kinv2 = torch.linalg.inv_ex(k2)[0]
    xn1 = normalize_points(x1, k1)
    xn2 = normalize_points(x2, k2)

    def solve_e(a, b, weights=None):
        if weights is not None:            # LO refit: weighted 8-point on E
            return epi.fundamental_8pt(a, b, weights)
        return essential_5pt(a, b)

    def resid_e(models, _a, _b):           # Sampson in pixels
        return epi.sampson_distance(kinv2.T @ models @ kinv1, x1, x2)

    e_res = ransac(generator, xn1, xn2, solve_e, resid_e, sample_size=6,
                   threshold=params.threshold_px, mask=mask,
                   n_hypotheses=params.n_hypotheses,
                   lo_iters=params.lo_iters, sample_idx=sample_idx)
    f = kinv2.T @ e_res.model @ kinv1
    f = f / torch.clamp(torch.linalg.vector_norm(f.reshape(9)), min=1e-12)
    return e_res._replace(model=f)


def estimate_relative_pose(
    x1, x2, k1, k2, mask=None, params: TwoViewParams = TwoViewParams(),
    generator: Optional[torch.Generator] = None,
    samples: Optional[Tuple] = None, device="cuda",
) -> TwoViewResult:
    """Two-view bootstrap on (N, 2) pixel correspondences on ``device``.

    ``generator`` drives both hypothesis draws; ``samples=(idx_f, idx_h)``
    ((B, 8) and (B, 4) indices, or (B, 6) and (B, 4) with
    ``solver="5pt"``) replaces them, so a test can hand in the reference's
    draws."""
    if params.solver not in ("8pt", "5pt"):
        raise ValueError(f"unknown epipolar solver {params.solver!r}; "
                         f"pass '8pt' or '5pt'")
    dev = resolve_device(device)
    x1 = to_device(x1, dev, torch.float32)
    x2 = to_device(x2, dev, torch.float32)
    k1 = to_device(k1, dev, torch.float32)
    k2 = to_device(k2, dev, torch.float32)
    n = x1.shape[0]
    mask = (torch.ones(n, dtype=torch.bool, device=dev) if mask is None
            else to_device(mask, dev, torch.bool))
    idx_f, idx_h = ((to_device(i, dev, torch.int64) for i in samples)
                    if samples is not None else (None, None))

    if params.solver == "5pt":
        f_res = _essential_ransac(generator, x1, x2, k1, k2, mask, params,
                                  idx_f)
    else:
        f_res = ransac(generator, x1, x2, epi.fundamental_8pt,
                       epi.sampson_distance,
                       sample_size=8, threshold=params.threshold_px,
                       mask=mask, n_hypotheses=params.n_hypotheses,
                       lo_iters=params.lo_iters, sample_idx=idx_f)
    h_res = ransac(generator, x1, x2, epi.homography_dlt,
                   epi.homography_transfer_error, sample_size=4,
                   threshold=params.h_threshold_px, mask=mask,
                   n_hypotheses=params.n_hypotheses,
                   lo_iters=params.lo_iters, sample_idx=idx_h)

    use_h = h_res.n_inliers.to(torch.float32) > (
        params.h_over_e_ratio * f_res.n_inliers.to(torch.float32))

    e = epi.essential_from_fundamental(f_res.model, k1, k2)
    rs_e, ts_e = epi.decompose_essential(e)
    rs_h, ts_h, _ = epi.decompose_homography(h_res.model, k1, k2)
    ts_h = ts_h / torch.clamp(torch.linalg.norm(ts_h, dim=-1, keepdim=True),
                              min=1e-12)
    rs = torch.where(use_h, rs_h, rs_e)
    ts = torch.where(use_h, ts_h, ts_e)
    inliers = torch.where(use_h, h_res.inliers, f_res.inliers)

    xn1 = normalize_points(x1, k1)
    xn2 = normalize_points(x2, k2)
    votes = tri.count_cheirality(rs, ts, xn1, xn2, mask=inliers,
                                 min_parallax_cos=params.min_parallax_cos)
    winner = torch.argmax(votes)
    r_best = rs[winner]
    t_best = ts[winner]

    if params.refine_iters > 0:
        r_best, t_best = refine_pose_sampson(
            r_best, t_best, x1, x2, k1, k2, inliers,
            iters=params.refine_iters, threshold_px=params.threshold_px)
        f_ref = (torch.linalg.inv(k2).T @ (skew(t_best) @ r_best)
                 @ torch.linalg.inv(k1))
        sq = epi.sampson_distance(f_ref, x1, x2)
        inliers = mask & (sq < params.threshold_px ** 2)

    eye3 = torch.eye(3, dtype=x1.dtype, device=dev)
    p1 = tri.projection_matrix(eye3, torch.zeros(3, dtype=x1.dtype,
                                                 device=dev), k1)
    p2 = tri.projection_matrix(r_best, t_best, k2)
    pts3d = tri.triangulate_dlt(p1, p2, x1, x2)
    return TwoViewResult(
        rotation=r_best,
        translation=t_best,
        model=torch.where(use_h, h_res.model, f_res.model),
        use_homography=use_h,
        inliers=inliers,
        n_inliers=torch.where(use_h, h_res.n_inliers, f_res.n_inliers),
        points3d=pts3d,
        cheirality_votes=votes,
    )
