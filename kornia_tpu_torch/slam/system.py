"""Monocular visual SLAM: tracking, keyframing, local BA, loop closure
(port of kornia_tpu/slam/system.py).

    frame → ORB (features.orb: K1, K2, K3)                      [device]
          → two-view bootstrap (geometry.twoview)              [device]
          → per frame :func:`track_step`: packed Hamming match against
            the local map → PnP RANSAC → reprojection LM       [device]
          → keyframe policy → triangulation + local Schur BA   [device]
          → BoW loop query (bow) → PnP check → PGO → global BA [device]

The stages take and give tensors on the loop's device; the map itself
(irregular, growing) is host numpy (:mod:`kornia_tpu_torch.slam.map`), as
in the reference, and the loop reads back what the reference reads back.
Frames can also be fed as keypoints and packed descriptors
(:meth:`MonocularSlam.process_observations`).

RANSAC draws come from a ``torch.Generator`` on the loop's device. Where
the reference takes a ``jax.random`` key (``_next_key``), the loop calls
``draws`` instead when one is given, so a caller can hand in draws of its
own (the parity tests hand in the reference's).

With a ``mesh`` (parallel.mesh) of more than one rank, global BA and PGO
run distributed (parallel.ba_dist, parallel.pgo_dist). Rank 0 runs the
loop and leads each solve (parallel.controller); every other rank runs
``parallel.follow(mesh)`` meanwhile, and rank 0 releases them with
``parallel.controller.stop(mesh)`` at the end.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from kornia_tpu_torch import resolve_device, to_device
from kornia_tpu_torch.bow import BowDatabase, Vocabulary
from kornia_tpu_torch.features import matching, orb
from kornia_tpu_torch.geometry import liegroup as lg
from kornia_tpu_torch.geometry import triangulation as tri
from kornia_tpu_torch.geometry import twoview as tv
from kornia_tpu_torch.geometry.pnp import PnPResult, solve_pnp_ransac
from kornia_tpu_torch.optim import ba as ba_mod
from kornia_tpu_torch.optim import pgo as pgo_mod
from kornia_tpu_torch.parallel import ba_dist, controller, pgo_dist
from kornia_tpu_torch.slam.map import Keyframe, SlamMap


class TrackingState(Enum):
    INITIALIZING = "initializing"
    TRACKING = "tracking"
    LOST = "lost"


@dataclass
class SlamConfig:
    n_features: int = 1000
    n_levels: int = 4
    match_max_distance: int = 64
    match_ratio: float = 0.8
    min_init_matches: int = 40
    min_init_inliers: int = 25
    min_track_points: int = 12
    pnp_threshold_px: float = 3.0
    keyframe_min_tracked_ratio: float = 0.6
    keyframe_min_interval: int = 3
    ba_window: int = 5
    ba_iterations: int = 10
    global_ba_iterations: int = 12
    global_ba_on_loop: bool = True
    loop_min_score: float = 0.25
    loop_min_kf_gap: int = 10
    loop_min_matches: int = 20
    seed: int = 0


@dataclass
class FrameResult:
    frame_idx: int
    state: TrackingState
    pose: Optional[np.ndarray]          # (7,) world→camera (None if lost)
    n_tracked: int
    is_keyframe: bool
    loop_closed_with: Optional[int] = None


class TrackStepResult(NamedTuple):
    pose: PnPResult            # world → camera
    inliers: torch.Tensor      # (N,) bool: PnP inlier and matched
    n_inliers: torch.Tensor    # () int64
    match_idx: torch.Tensor    # (N,) int32 map row, -1 if unmatched
    match_mask: torch.Tensor   # (N,) bool


def _pack(desc_bits: torch.Tensor) -> torch.Tensor:
    """(N, D) bits, D a multiple of 8 → (N, D/8) u8 on the tensor's
    device, as ``np.packbits(bits, axis=1)``: MSB first, any non-zero bit
    is 1."""
    b = (desc_bits != 0).to(torch.int32)
    weights = 1 << torch.arange(7, -1, -1, dtype=torch.int32,
                                device=b.device)
    return (b.reshape(b.shape[0], -1, 8) * weights).sum(-1).to(torch.uint8)


def _bucket(n: int, step: int) -> int:
    """Round n up to the bucket grid (powers-of-two multiples of step), so
    the step sees few distinct shapes."""
    b = step
    while b < n:
        b *= 2
    return b


def _pad_rows(arr: torch.Tensor, n_to: int, fill=0.0) -> torch.Tensor:
    """The first ``n_to`` rows of ``arr``, padded with ``fill``."""
    if arr.shape[0] >= n_to:
        return arr[:n_to]
    pad = torch.full((n_to - arr.shape[0],) + tuple(arr.shape[1:]), fill,
                     dtype=arr.dtype, device=arr.device)
    return torch.cat([arr, pad])


_DEFAULT = SlamConfig()


def track_step(frame_desc, frame_mask, frame_xy, map_desc, map_mask,
               map_xyz, k,
               max_distance: float = _DEFAULT.match_max_distance,
               ratio: float = _DEFAULT.match_ratio,
               threshold_px: float = _DEFAULT.pnp_threshold_px,
               generator: Optional[torch.Generator] = None,
               sample_idx=None, device="cuda") -> TrackStepResult:
    """One frame tracked against the local map on ``device``.

    frame_desc (N, 32) u8 packed descriptors, frame_mask (N,), frame_xy
    (N, 2) pixels; map_desc (M, 32), map_mask (M,), map_xyz (M, 3) world
    points; k (3, 3). Matching: Lowe ratio ``ratio``, Hamming distance
    ≤ ``max_distance``, cross-check; then ``solve_pnp_ransac`` with its
    defaults (EPnP, 256 hypotheses of 6 points, MSAC, 2 LO refits, 10 LM
    iterations) at ``threshold_px``. ``generator`` drives the draw;
    ``sample_idx`` (256, 6) replaces it."""
    dev = resolve_device(device)
    m = matching.match_descriptors_packed(
        frame_desc, map_desc, a_mask=frame_mask, b_mask=map_mask,
        max_distance=float(max_distance), ratio=float(ratio), device=dev)
    xyz = to_device(map_xyz, dev, torch.float32)
    world = xyz[torch.clamp(m.idx, min=0).to(torch.int64)]
    pose, inliers, n_inl = solve_pnp_ransac(
        world, frame_xy, k, threshold_px=float(threshold_px), mask=m.mask,
        generator=generator, sample_idx=sample_idx, device=dev)
    return TrackStepResult(pose=pose, inliers=inliers & m.mask,
                           n_inliers=n_inl, match_idx=m.idx,
                           match_mask=m.mask)


# solve_pnp_ransac's draw: 256 hypotheses of 6 points
_PNP_DRAW = (256, 6)
_IDENTITY7 = np.array([1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0])


def _on(arr: np.ndarray, n_to: int, device, dtype=None) -> torch.Tensor:
    """Host rows ``arr`` zero-padded (or cut) to ``n_to`` rows, on
    ``device``."""
    rows = _pad_rows(torch.from_numpy(np.ascontiguousarray(arr)), n_to)
    return rows.to(device=device, dtype=dtype)


def _valid(n: int, n_to: int, device) -> torch.Tensor:
    """(n_to,) bool: the first ``n`` rows."""
    return torch.arange(n_to, device=device) < n


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _hamming_match(desc_a: np.ndarray, desc_b: np.ndarray,
                   max_distance: int, ratio: float, device) -> np.ndarray:
    """(M, 2) mutual Lowe-ratio matches of packed u8 descriptors, on
    ``device`` at bucketed shapes (256-row steps); one read-back."""
    if len(desc_a) == 0 or len(desc_b) == 0:
        return np.empty((0, 2), np.int64)
    na = _bucket(len(desc_a), 256)
    nb = _bucket(len(desc_b), 256)
    res = matching.match_descriptors_packed(
        _on(desc_a, na, device), _on(desc_b, nb, device),
        a_mask=_valid(len(desc_a), na, device),
        b_mask=_valid(len(desc_b), nb, device),
        max_distance=float(max_distance), ratio=float(ratio), device=device)
    idx = _host(res.idx[: len(desc_a)])      # -1 where unmatched
    ok = idx >= 0
    return np.stack([np.nonzero(ok)[0], idx[ok]], 1).astype(np.int64)


# draws(kind, mask, sizes) → index sets: kind "twoview" takes sizes
# ((B, 8), (B, 4)) and returns (idx_f, idx_h); "track" and "loop_pnp" take
# (256, 6) and return one (256, 6) index set. mask: the valid rows.
Draws = Callable[[str, torch.Tensor, tuple], object]


class MonocularSlam:
    """Monocular SLAM/VO pipeline over a pinhole camera, on ``device``.

    ``generator``: the RANSAC draws' torch.Generator (default: one on
    ``device`` seeded with ``config.seed``). ``draws``: called where the
    reference takes a ``jax.random`` key (see :data:`Draws`); its index
    sets replace the generator's draw. ``mesh``: a parallel.mesh Mesh;
    when it spans more than one rank, global BA runs keyframe-sharded
    (the exchange feeding the summed Schur BA) and PGO over edge shards,
    led from this rank (rank 0; module docstring)."""

    def __init__(self, k: np.ndarray, config: SlamConfig = SlamConfig(),
                 vocabulary: Optional[Vocabulary] = None, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[Draws] = None, mesh=None):
        self.device = resolve_device(device)
        self.k = np.asarray(k, np.float64)
        self.config = config
        self.mesh = mesh
        self.map = SlamMap()
        self.state = TrackingState.INITIALIZING
        self.results: List[FrameResult] = []
        self._orb_cfg = orb.OrbConfig(
            n_features=config.n_features, n_levels=config.n_levels)
        self._gen = (generator if generator is not None else
                     torch.Generator(device=self.device).manual_seed(
                         config.seed))
        self._draws = draws
        self._k = torch.as_tensor(self.k, dtype=torch.float32,
                                  device=self.device)
        self._init_frame: Optional[Tuple[int, np.ndarray, np.ndarray]] = None
        self._last_pose = _IDENTITY7.copy()
        self._frame_idx = -1
        self._bow_db: Optional[BowDatabase] = (
            BowDatabase(vocabulary) if vocabulary is not None else None)
        self._last_kf_frame = -(10 ** 9)

    # ----------------------------------------------------------- frontend
    def _extract(self, gray) -> Tuple[np.ndarray, np.ndarray]:
        feats = orb.orb_detect_and_describe(gray, self._orb_cfg,
                                            device=self.device)
        mask = _host(feats.mask)
        xy = _host(feats.xy).astype(np.float64)[mask]
        desc = _host(_pack(feats.descriptors))[mask]
        return xy, desc

    def _sample(self, kind: str, mask: torch.Tensor, sizes):
        """The reference's ``_next_key()`` site: the caller's index sets,
        or None (the generator draws)."""
        return None if self._draws is None else self._draws(kind, mask,
                                                            sizes)

    # ------------------------------------------------------------- public
    def process_frame(self, gray) -> FrameResult:
        """Full pipeline entry: an (H, W) u8 image (numpy or tensor) in,
        pose out."""
        xy, desc = self._extract(gray)
        return self.process_observations(xy, desc)

    def process_observations(self, xy: np.ndarray,
                             desc: np.ndarray) -> FrameResult:
        """Frontend-bypass entry: keypoints + packed descriptors in."""
        self._frame_idx += 1
        xy = np.asarray(xy, np.float64)
        desc = np.asarray(desc, np.uint8)
        if self.state == TrackingState.INITIALIZING:
            res = self._initialize(xy, desc)
        else:
            res = self._track(xy, desc)
        self.results.append(res)
        return res

    def trajectory(self) -> np.ndarray:
        """(N_kf, 7) keyframe poses (world→camera)."""
        return np.stack([kf.pose for kf in self.map.keyframes])

    # -------------------------------------------------------------- init
    def _initialize(self, xy, desc) -> FrameResult:
        cfg = self.config
        dev = self.device
        if self._init_frame is None:
            self._init_frame = (self._frame_idx, xy, desc)
            return FrameResult(self._frame_idx, self.state, None, 0, False)
        f0_idx, xy0, desc0 = self._init_frame
        m = _hamming_match(desc0, desc, cfg.match_max_distance,
                           cfg.match_ratio, dev)
        if len(m) < cfg.min_init_matches:
            self._init_frame = (self._frame_idx, xy, desc)
            return FrameResult(self._frame_idx, self.state, None, len(m),
                               False)

        nb = _bucket(len(m), 128)
        valid = _valid(len(m), nb, dev)
        params = tv.TwoViewParams()
        samples = self._sample("twoview", valid,
                               ((params.n_hypotheses, 8),
                                (params.n_hypotheses, 4)))
        res = tv.estimate_relative_pose(
            _on(xy0[m[:, 0]], nb, dev, torch.float32),
            _on(xy[m[:, 1]], nb, dev, torch.float32), self._k, self._k,
            mask=valid, params=params, generator=self._gen, samples=samples,
            device=dev)
        inl = _host(res.inliers[: len(m)])
        n_inl = int(res.n_inliers)
        if n_inl < cfg.min_init_inliers:
            self._init_frame = (self._frame_idx, xy, desc)
            return FrameResult(self._frame_idx, self.state, None, n_inl,
                               False)

        pts3d = _host(res.points3d[: len(m)]).astype(np.float64)[inl]
        pos = pts3d[:, 2] > 1e-6
        pts3d = pts3d[pos]
        mi = m[inl][pos]
        # gauge: median depth = 1
        scale = 1.0 / max(np.median(pts3d[:, 2]), 1e-9)
        pts3d = pts3d * scale
        q1 = _host(lg.matrix_to_quat(res.rotation)).astype(np.float64)
        t = _host(res.translation).astype(np.float64) * scale
        pose0 = _IDENTITY7.copy()
        pose1 = np.concatenate([q1, t])

        kf0 = self.map.add_keyframe(f0_idx, pose0, xy0, desc0)
        kf1 = self.map.add_keyframe(self._frame_idx, pose1, xy, desc)
        obs = [[(kf0.kf_id, int(i0)), (kf1.kf_id, int(i1))]
               for i0, i1 in mi]
        pids = self.map.add_points(pts3d, desc[mi[:, 1]], obs)
        for pid, (i0, i1) in zip(pids, mi):
            kf0.point_ids[i0] = pid
            kf1.point_ids[i1] = pid
        self.map.add_edge(kf0.kf_id, kf1.kf_id,
                          self._relative_pose(pose0, pose1))
        self._register_bow(kf0)
        self._register_bow(kf1)

        self._local_ba()
        self._last_pose = self.map.keyframes[-1].pose.copy()
        self._last_kf_frame = self._frame_idx
        self.state = TrackingState.TRACKING
        return FrameResult(self._frame_idx, self.state,
                           self._last_pose.copy(), len(pts3d), True)

    # ------------------------------------------------------------- track
    def _track(self, xy, desc) -> FrameResult:
        cfg = self.config
        dev = self.device
        local_ids = self.map.local_point_ids(cfg.ba_window)
        if len(local_ids) < cfg.min_track_points:
            self.state = TrackingState.LOST
            return FrameResult(self._frame_idx, self.state, None, 0, False)

        # one step on the device: match + PnP + refine (bucketed shapes)
        na = _bucket(len(desc), 256)
        nbm = _bucket(len(local_ids), 256)
        ins = dict(
            frame_desc=_on(desc, na, dev), frame_mask=_valid(len(desc), na,
                                                             dev),
            frame_xy=_on(xy.astype(np.float32), na, dev),
            map_desc=_on(self.map.point_desc[local_ids], nbm, dev),
            map_mask=_valid(len(local_ids), nbm, dev),
            map_xyz=_on(self.map.point_xyz[local_ids].astype(np.float32),
                        nbm, dev))
        sample_idx = None
        if self._draws is not None:
            # the draw is over the step's match mask: the same match, first
            pre = matching.match_descriptors_packed(
                ins["frame_desc"], ins["map_desc"], ins["frame_mask"],
                ins["map_mask"], max_distance=float(cfg.match_max_distance),
                ratio=float(cfg.match_ratio), device=dev)
            sample_idx = self._sample("track", pre.mask, _PNP_DRAW)
        step = track_step(
            **ins, k=self._k, max_distance=cfg.match_max_distance,
            ratio=cfg.match_ratio, threshold_px=cfg.pnp_threshold_px,
            generator=self._gen, sample_idx=sample_idx, device=dev)
        midx = _host(step.match_idx[: len(desc)])    # -1 where unmatched
        mmask = midx >= 0
        m = np.stack([np.nonzero(mmask)[0], midx[mmask]], 1).astype(
            np.int64)
        if len(m) < cfg.min_track_points:
            self.state = TrackingState.LOST
            return FrameResult(self._frame_idx, self.state, None, len(m),
                               False)
        n_inl = int(step.n_inliers)
        if n_inl < cfg.min_track_points:
            self.state = TrackingState.LOST
            return FrameResult(self._frame_idx, self.state, None, n_inl,
                               False)
        pose = np.concatenate([
            _host(lg.matrix_to_quat(step.pose.rotation)),
            _host(step.pose.translation)]).astype(np.float64)
        self._last_pose = pose

        inl = _host(step.inliers[: len(desc)])[mmask]
        tracked_ratio = n_inl / max(len(local_ids), 1)
        is_kf = (tracked_ratio < cfg.keyframe_min_tracked_ratio
                 and self._frame_idx - self._last_kf_frame
                 >= cfg.keyframe_min_interval)
        loop_with = None
        if is_kf:
            loop_with = self._insert_keyframe(xy, desc, pose, m[inl],
                                              local_ids)
        return FrameResult(self._frame_idx, self.state, pose.copy(),
                           n_inl, is_kf, loop_with)

    # ---------------------------------------------------------- keyframes
    def _insert_keyframe(self, xy, desc, pose, matches,
                         local_ids) -> Optional[int]:
        kf = self.map.add_keyframe(self._frame_idx, pose, xy, desc)
        for fi, mi_local in matches:
            self.map.add_observation(int(local_ids[mi_local]), kf.kf_id,
                                     int(fi))
        prev = self.map.keyframes[kf.kf_id - 1]
        self.map.add_edge(prev.kf_id, kf.kf_id,
                          self._relative_pose(prev.pose, pose))
        self._triangulate_new(kf, prev)
        self._local_ba()
        self._last_kf_frame = self._frame_idx
        loop_with = self._try_loop_closure(kf)
        self._register_bow(kf)
        return loop_with

    def _triangulate_new(self, kf: Keyframe, prev: Keyframe) -> None:
        cfg = self.config
        dev = self.device
        un_a = np.nonzero(prev.point_ids < 0)[0]
        un_b = np.nonzero(kf.point_ids < 0)[0]
        if len(un_a) < 8 or len(un_b) < 8:
            return
        m = _hamming_match(prev.descriptors[un_a], kf.descriptors[un_b],
                           cfg.match_max_distance, cfg.match_ratio, dev)
        if len(m) == 0:
            return
        ia = un_a[m[:, 0]]
        ib = un_b[m[:, 1]]
        poses = torch.as_tensor(np.stack([prev.pose, kf.pose]),
                                dtype=torch.float32, device=dev)
        proj = self._k @ lg.se3_to_matrix(poses)[:, :3]       # (2, 3, 4)
        pts = tri.triangulate_dlt(
            proj[0], proj[1],
            torch.as_tensor(prev.xy[ia], dtype=torch.float32, device=dev),
            torch.as_tensor(kf.xy[ib], dtype=torch.float32, device=dev))
        # both views' camera coordinates in float32, as the reference's
        cams = _host(lg.se3_apply(poses[:, None], pts[None])).astype(
            np.float64)
        pts = _host(pts).astype(np.float64)
        # cheirality in both views + reprojection gate
        ok = np.ones(len(pts), bool)
        for cam, px_ in zip(cams, (prev.xy[ia], kf.xy[ib])):
            ok &= cam[:, 2] > 1e-3
            uv = cam[:, :2] / np.maximum(cam[:, 2:], 1e-9)
            uv = uv * [self.k[0, 0], self.k[1, 1]] + [self.k[0, 2],
                                                      self.k[1, 2]]
            ok &= np.linalg.norm(uv - px_, axis=1) < 2 * cfg.pnp_threshold_px
        if not ok.any():
            return
        obs = [[(prev.kf_id, int(a)), (kf.kf_id, int(b))]
               for a, b in zip(ia[ok], ib[ok])]
        pids = self.map.add_points(pts[ok], kf.descriptors[ib[ok]], obs)
        for pid, a, b in zip(pids, ia[ok], ib[ok]):
            prev.point_ids[a] = pid
            kf.point_ids[b] = pid

    # ---------------------------------------------------------------- BA
    def _local_ba(self) -> None:
        cfg = self.config
        kf_ids = [kf.kf_id for kf in self.map.keyframes[-cfg.ba_window:]]
        self._bundle_adjust(kf_ids, cfg.ba_iterations, distributed=False)

    def _distributed(self) -> bool:
        return self.mesh is not None and self.mesh.devices.size > 1

    def global_ba(self, iterations: Optional[int] = None,
                  distributed: Optional[bool] = None) -> bool:
        """Full-map BA over the whole keyframe graph (the solver picks the
        PCG reduced solve above 400 poses). With a mesh (and
        ``distributed`` not False) it runs the keyframe-sharded exchange
        → summed-Schur solve (parallel.ba_dist.bundle_adjust_schur_dist_kf)
        on every rank. Returns True if an update was applied."""
        if iterations is None:
            iterations = self.config.global_ba_iterations
        if distributed is None:
            distributed = self._distributed()
        kf_ids = [kf.kf_id for kf in self.map.keyframes]
        return self._bundle_adjust(kf_ids, iterations,
                                   distributed=distributed)

    def _bundle_adjust(self, kf_ids, iterations: int,
                       distributed: bool) -> bool:
        cams, pts_local, uvs, used = self.map.observations_for_ba(kf_ids)
        if len(used) < 8 or len(uvs) < 16:
            return False
        poses = np.stack([self.map.keyframes[i].pose for i in kf_ids])
        fixed = np.zeros(len(kf_ids), bool)
        fixed[0] = True
        if len(kf_ids) > 1 and kf_ids[0] == 0:
            fixed[min(1, len(kf_ids) - 1)] = True  # lock monocular scale

        # bucket shapes: dummy point absorbs padded zero-weight obs
        n_used = len(used)
        np_b = _bucket(n_used + 1, 64)
        m_b = _bucket(len(uvs), 256)
        pts_arr = np.ones((np_b, 3), np.float32)
        pts_arr[:n_used] = self.map.point_xyz[used]
        fixed_pts = np.zeros(np_b, bool)
        fixed_pts[n_used:] = True
        obs_w = np.zeros(m_b, np.float32)
        obs_w[: len(uvs)] = 1.0
        cams_b = np.zeros(m_b, np.int32)
        cams_b[: len(cams)] = cams
        pts_local_b = np.full(m_b, n_used, np.int32)      # → dummy point
        pts_local_b[: len(pts_local)] = pts_local
        uvs_b = np.zeros((m_b, 2), np.float32)
        uvs_b[: len(uvs)] = uvs
        counts = np.bincount(pts_local, minlength=np_b)
        k_b = _bucket(max(int(counts.max()), 1), 4)

        distributed = distributed and self.mesh is not None
        # a distributed solve plans on the host: build its problem there
        problem = ba_mod.build_problem(
            poses.astype(np.float32), pts_arr, self.k.astype(np.float32),
            cams_b, pts_local_b, uvs_b, obs_w=obs_w, fixed_poses=fixed,
            fixed_points=fixed_pts, max_obs_per_point=k_b,
            device="cpu" if distributed else self.device)
        params = ba_mod.BAParams(max_iterations=iterations, loss="huber",
                                 loss_scale=2.0)
        if distributed:
            sharded = ba_dist.shard_problem_by_keyframe(
                problem, self.mesh.devices.size)
            result = controller.lead(self.mesh, "ba_dist_kf", sharded,
                                     params)
        else:
            result = ba_mod.bundle_adjust_schur(problem, params)
        new_poses = _host(result.poses).astype(np.float64)
        new_points = _host(result.points).astype(np.float64)[:n_used]
        if not (np.isfinite(new_poses).all()
                and np.isfinite(new_points).all()):
            return False
        for i, kf_id in enumerate(kf_ids):
            self.map.keyframes[kf_id].pose = new_poses[i]
        self.map.point_xyz[used] = new_points
        if self.map.keyframes:
            self._last_pose = self.map.keyframes[-1].pose.copy()
        return True

    # -------------------------------------------------------- loop closure
    def _register_bow(self, kf: Keyframe) -> None:
        if self._bow_db is not None:
            self._bow_db.add(kf.descriptors)

    def _try_loop_closure(self, kf: Keyframe) -> Optional[int]:
        cfg = self.config
        dev = self.device
        if self._bow_db is None or len(self._bow_db) < cfg.loop_min_kf_gap:
            return None
        for r in self._bow_db.query(kf.descriptors, top_k=3):
            if kf.kf_id - r.entry_id < cfg.loop_min_kf_gap:
                continue
            if r.score < cfg.loop_min_score:
                continue
            old = self.map.keyframes[r.entry_id]
            m = _hamming_match(old.descriptors, kf.descriptors,
                               cfg.match_max_distance, cfg.match_ratio, dev)
            if len(m) < cfg.loop_min_matches:
                continue
            # geometric verification: PnP of the old keyframe's 3-D points
            # into the new frame
            has_pt = old.point_ids[m[:, 0]] >= 0
            if has_pt.sum() < cfg.loop_min_matches // 2:
                continue
            mm = m[has_pt]
            nb = _bucket(len(mm), 128)
            valid = _valid(len(mm), nb, dev)
            pose_res, inliers, n_inl = solve_pnp_ransac(
                _on(self.map.point_xyz[old.point_ids[mm[:, 0]]], nb, dev,
                    torch.float32),
                _on(kf.xy[mm[:, 1]], nb, dev, torch.float32), self._k,
                threshold_px=cfg.pnp_threshold_px, mask=valid,
                generator=self._gen,
                sample_idx=self._sample("loop_pnp", valid, _PNP_DRAW),
                device=dev)
            if int(n_inl) < cfg.loop_min_matches // 2:
                continue
            corrected = np.concatenate([
                _host(lg.matrix_to_quat(pose_res.rotation)),
                _host(pose_res.translation)]).astype(np.float64)
            self.map.add_edge(old.kf_id, kf.kf_id,
                              self._relative_pose(old.pose, corrected),
                              weight=5.0)
            # fuse the loop into the observation graph too: each PnP
            # inlier says "this new-frame feature observes that old map
            # point"; without these, global BA sees no loop constraint
            # (only PGO's edge) and can flex the trajectory back
            inl_m = _host(inliers[: len(mm)])
            for (fi_old, fi_new), ok in zip(mm, inl_m):
                old_pid = int(old.point_ids[fi_old])
                if not ok or old_pid < 0:
                    continue
                cur = int(kf.point_ids[fi_new])
                if cur < 0:
                    self.map.add_observation(old_pid, kf.kf_id, int(fi_new))
                elif cur != old_pid:
                    # a duplicate made during the drifted revisit
                    self._merge_points(old_pid, cur)
            self._run_pgo()
            # PGO and the point drag re-hang the map on the corrected
            # skeleton; global BA then refines every pose and point
            if cfg.global_ba_on_loop:
                self.global_ba()
            return old.kf_id
        return None

    def _run_pgo(self) -> None:
        dev = self.device
        kfs = self.map.keyframes
        edges = self.map.edges
        old_poses = np.stack([kf.pose for kf in kfs])
        # bucketed shapes: identity-padded fixed poses, weight-0 edges
        p_b = _bucket(len(kfs), 8)
        e_b = _bucket(len(edges), 32)
        poses_pad = np.tile(_IDENTITY7, (p_b, 1))
        poses_pad[: len(kfs)] = old_poses
        fixed = np.ones(p_b, bool)
        fixed[1: len(kfs)] = False
        ei = np.zeros(e_b, np.int32)
        ej = np.zeros(e_b, np.int32)
        ei[: len(edges)] = [e[0] for e in edges]
        ej[: len(edges)] = [e[1] for e in edges]
        meas = np.tile(_IDENTITY7, (e_b, 1))
        meas[: len(edges)] = np.stack([e[2] for e in edges])
        w = np.zeros(e_b, np.float32)
        w[: len(edges)] = [e[3] for e in edges]
        params = pgo_mod.PGOParams(max_iterations=15)
        if self._distributed():
            sharded = pgo_dist.shard_pgo(
                poses_pad.astype(np.float32), ei, ej, meas, w, fixed=fixed,
                n_devices=self.mesh.devices.size)
            result = controller.lead(self.mesh, "pgo_dist", sharded, params)
        else:
            result = pgo_mod.pose_graph_optimize(
                torch.as_tensor(poses_pad, dtype=torch.float32, device=dev),
                ei, ej, torch.as_tensor(meas, dtype=torch.float32,
                                        device=dev),
                w, fixed=fixed, params=params)
        new_f32 = result.poses[: len(kfs)].to(dev)
        new_poses = _host(new_f32).astype(np.float64)
        if not np.isfinite(new_poses).all():
            return
        for i, kf in enumerate(kfs):
            kf.pose = new_poses[i]
        self._last_pose = kfs[-1].pose.copy()
        # drag each map point with the correction of its first observing
        # keyframe, in float32 se3 ops
        ref_kf = np.asarray([obs[0][0] if obs else -1
                             for obs in self.map.point_obs], np.int64)
        has = ref_kf >= 0
        if not has.any():
            return
        old_f32 = torch.as_tensor(old_poses, dtype=torch.float32,
                                  device=dev)
        corr = lg.se3_compose(lg.se3_inverse(new_f32), old_f32)
        moved = lg.se3_apply(
            corr[torch.as_tensor(ref_kf[has], device=dev)],
            torch.as_tensor(self.map.point_xyz[has], dtype=torch.float32,
                            device=dev))
        self.map.point_xyz[has] = _host(moved).astype(np.float64)

    # ------------------------------------------------------------ helpers
    def _merge_points(self, keep: int, dup: int) -> None:
        """Fuse map point ``dup`` into ``keep`` (loop-closure duplicate):
        re-point every observation and keyframe slot, invalidate dup."""
        for kf_id, fi in self.map.point_obs[dup]:
            self.map.keyframes[kf_id].point_ids[fi] = keep
            self.map.point_obs[keep].append((kf_id, fi))
        self.map.point_obs[dup] = []
        self.map.point_valid[dup] = False

    def _relative_pose(self, pose_i: np.ndarray,
                       pose_j: np.ndarray) -> np.ndarray:
        """rel with pose_j = rel ∘ pose_i (both world→camera), in float32
        on the loop's device."""
        p = torch.as_tensor(np.stack([pose_i, pose_j]), dtype=torch.float32,
                            device=self.device)
        return _host(lg.se3_compose(p[1], lg.se3_inverse(p[0]))).astype(
            np.float64)
