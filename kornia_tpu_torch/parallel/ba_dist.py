"""Distributed Schur-complement bundle adjustment (port of
kornia_tpu/parallel/ba_dist.py).

Design:
  * **Sharding**: points are partitioned contiguously across the mesh's
    ranks. Observations can enter in either layout:
      - *point-co-located* (:func:`shard_problem`): each observation
        already lives on the shard owning its point — zero exchange;
      - *keyframe-sharded* (:func:`shard_problem_by_keyframe`): each
        observation starts on the shard that produced it (its keyframe's
        owner), and the solve first runs the ragged exchange
        (parallel.exchange) to move every observation to its point's
        owner, then sorts the arrivals by point with a permutation planned
        on the host (the receive order is static).
    Poses and intrinsics are replicated (6P is small).
  * **SPMD ranks, one host problem**: the ``shard_problem*`` planners are
    numpy and give the reference's padded (D, …) layout field for field.
    Every rank calls the ``*_dist`` entry point with that whole host
    problem and takes its own row ``mesh.rank`` to ``mesh.device``; every
    rank returns the replicated poses and costs and the full point array
    (one all-gather at the end).
  * **Per LM iteration**: each rank accumulates its partial pose blocks
    U, g_p, the Schur rhs and — when it fits (``_S_MAT_BYTES`` /
    ``_BC_MAT_BYTES``) — its partial materialized reduced camera system,
    all in ONE flat ``all_reduce``; the solve (dense Cholesky up to 400
    poses, replicated block-PCG on the summed S above) then needs no
    collective, and a second scalar ``all_reduce`` gives the cost that
    decides accept or reject. **2 collectives per LM iteration**; only
    where S cannot be materialized does the matrix-free PCG pay one more
    per CG step. Every rank solves the same summed system on the same
    bits, so the accept decisions agree and the ranks stay bit-equal.
  * **RGB-D depth** and **pose priors** ride both layouts: depth rows
    travel inside the packed exchange payload; priors touch only the
    replicated poses, so every rank adds the identical prior blocks after
    the sum.

Left out: the reference's per-shard tiled one-hot segment engine
(``_build_shard_engine``; the ``seg_oh``/``seg_ids``/``cam_oh`` fields
stay None). It turns scatters into matmuls because the TPU scatters at
scalar rate; a GPU scatters at memory rate, and the reference itself runs
``segment_sum`` on every other backend. The segmented sums here are
``optim/ba._seg_sum`` (the same bits every run on the card).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from kornia_tpu_torch import upload
from kornia_tpu_torch.geometry import liegroup as lg
from kornia_tpu_torch.geometry.linalg import solve_cholesky
from kornia_tpu_torch.optim import ba as ba_mod
from kornia_tpu_torch.optim.ba import BAParams, BAResult
from kornia_tpu_torch.optim.losses import LOSSES
from kornia_tpu_torch.parallel import exchange as ex_mod
from kornia_tpu_torch.parallel.mesh import Mesh

# materialization budgets (bytes, f32): the reduced camera system
# S (P, P, 6, 6) and the per-(point, cam) coupling aggregate
# Bc (Nl, P, 6, 3). Below these, every CG iteration is collective-free
# (replicated solve on the summed dense S); above, the matrix-free PCG
# sums a (P, 6) product per step.
_S_MAT_BYTES = 1 << 30
_BC_MAT_BYTES = 1 << 30

# per-shard observations are padded to a multiple of this, as the
# reference pads them to its segment-engine tile (ba._SEG_T = 1024)
_PAD_M = ba_mod._PAD_M

Array = Union[np.ndarray, torch.Tensor]


class ShardedBAProblem(NamedTuple):
    """Point-co-located sharded BA problem (host numpy, leading axis =
    shards)."""

    poses: Array              # (P, 7) replicated
    points: Array             # (D, Nl, 3) sharded
    k: Array                  # (3, 3) replicated
    obs_cam: Array            # (D, Ml) int32 global pose ids
    obs_pt: Array             # (D, Ml) int32 LOCAL point ids
    obs_uv: Array             # (D, Ml, 2)
    obs_w: Array              # (D, Ml) 0 = padding
    fixed_poses: Array        # (P,) replicated
    fixed_points: Array       # (D, Nl)
    n_points: int             # true (unpadded) point count
    # the reference's segment engine: always None here (module docstring)
    seg_oh: Optional[Array] = None
    seg_ids: Optional[Array] = None
    cam_oh: Optional[Array] = None
    # RGB-D depth channel
    obs_depth: Optional[Array] = None    # (D, Ml)
    obs_depth_w: Optional[Array] = None  # (D, Ml)
    # pose priors (replicated)
    prior_center: Optional[Array] = None  # (P, 3)
    prior_invs: Optional[Array] = None    # (P,)


class KeyframeShardedBA(NamedTuple):
    """Keyframe-sharded BA problem: observations live on their
    *producer* shard (keyframe owner), packed into the exchange payload
    for the routing to their point's owner shard; ``perm`` sorts the
    static post-exchange order by point."""

    poses: Array              # (P, 7) replicated
    points: Array             # (D, Nl, 3) sharded (contiguous ranges)
    k: Array                  # (3, 3) replicated
    # packed send payload: (D, D, B, C) [a2a] or tuple of (D, B_r, C)
    # [rounds]; columns per parallel.exchange
    payload: Union[Array, Tuple[Array, ...]]
    mode: str                 # "a2a" | "rounds"
    rounds: Tuple[int, ...]   # active offsets (rounds mode)
    perm: Array               # (D, Lp) int32 — sort-by-point permutation
    fixed_poses: Array        # (P,)
    fixed_points: Array       # (D, Nl)
    n_points: int
    recv_len: int             # L rows received per shard (pre-pad)
    pad: int                  # rows appended after the exchange to reach Lp
    has_depth: bool = False
    seg_oh: Optional[Array] = None
    seg_ids: Optional[Array] = None
    cam_oh: Optional[Array] = None
    prior_center: Optional[Array] = None  # (P, 3)
    prior_invs: Optional[Array] = None    # (P,)


def _host(x):
    if x is None:
        return None
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _padded_points(points, fixed_points, n_devices):
    """Points padded to D·ceil(N / D) (padding points fixed), as
    (D, Nl, 3) and (D, Nl)."""
    n = points.shape[0]
    nl = -(-n // n_devices)
    n_pad = nl * n_devices
    pts_pad = np.zeros((n_pad, 3), np.float32)
    pts_pad[:n] = points
    fixed_pad = np.ones(n_pad, bool)
    fixed_pad[:n] = fixed_points
    return pts_pad.reshape(n_devices, nl, 3), fixed_pad.reshape(n_devices,
                                                                nl)


def shard_problem(problem: ba_mod.BAProblem,
                  n_devices: int) -> ShardedBAProblem:
    """Partition a BAProblem on the host: contiguous point ranges per
    shard, each observation co-located with its point (in input order),
    everything padded to equal per-shard sizes."""
    obs_pt = _host(problem.obs_pt).astype(np.int64)
    obs_cam = _host(problem.obs_cam)
    points = _host(problem.points)
    n = points.shape[0]
    has_depth = problem.obs_depth is not None
    pts, fixed_pts = _padded_points(points, _host(problem.fixed_points),
                                    n_devices)
    nl = pts.shape[1]

    shard_of_obs = obs_pt // nl
    counts = np.bincount(shard_of_obs, minlength=n_devices)
    ml = max(int(counts.max()), 1)
    ml += -ml % _PAD_M
    # each observation's slot: its rank among its shard's, in input order
    order = np.argsort(shard_of_obs, kind="stable")
    slot = np.empty_like(shard_of_obs)
    slot[order] = (np.arange(len(order))
                   - (np.cumsum(counts) - counts)[shard_of_obs[order]])
    at = (shard_of_obs, slot)

    def fill(value, dtype, pad=0, trailing=()):
        out = np.full((n_devices, ml) + trailing, pad, dtype)
        out[at] = value
        return out

    # padding slots carry the shard's LAST local point id, so each shard's
    # observations stay sorted by point; their weight is 0
    return ShardedBAProblem(
        poses=_host(problem.poses),
        points=pts,
        k=_host(problem.k),
        obs_cam=fill(obs_cam, np.int32),
        obs_pt=fill(obs_pt - shard_of_obs * nl, np.int32, nl - 1),
        obs_uv=fill(_host(problem.obs_uv), np.float32, trailing=(2,)),
        obs_w=fill(_host(problem.obs_w), np.float32),
        fixed_poses=_host(problem.fixed_poses),
        fixed_points=fixed_pts,
        n_points=n,
        obs_depth=fill(_host(problem.obs_depth), np.float32)
        if has_depth else None,
        obs_depth_w=fill(_host(problem.obs_depth_w), np.float32)
        if has_depth else None,
        prior_center=_host(problem.prior_center),
        prior_invs=_host(problem.prior_invs),
    )


def keyframe_exchange_plan(
    problem: ba_mod.BAProblem, n_devices: int,
    cam_shard: Optional[np.ndarray] = None, mode: str = "auto",
) -> ex_mod.ExchangePlan:
    """The exchange plan of ``problem``'s keyframe layout: every real
    observation (build_problem's zero-weight padding rows are not shipped)
    from the shard owning its camera to the shard owning its point.

    ``cam_shard``: (P,) shard owner per camera; default = contiguous
    blocks of ceil(P / D) cameras. Point ownership is contiguous ranges
    of ceil(N / D), matching :func:`shard_problem`."""
    obs_w = _host(problem.obs_w)
    real = obs_w != 0.0
    obs_cam = _host(problem.obs_cam)[real]
    p = _host(problem.poses).shape[0]
    if cam_shard is None:
        per = -(-p // n_devices)
        cam_shard = np.minimum(np.arange(p) // per, n_devices - 1)
    cam_shard = np.asarray(cam_shard, np.int64)
    depth = problem.obs_depth is not None
    return ex_mod.build_exchange_plan(
        obs_src_shard=cam_shard[obs_cam], obs_cam=obs_cam,
        obs_pt=_host(problem.obs_pt)[real],
        obs_uv=_host(problem.obs_uv)[real], n_devices=n_devices,
        points_per_shard=-(-problem.points.shape[0] // n_devices),
        obs_w=obs_w[real],
        obs_depth=_host(problem.obs_depth)[real] if depth else None,
        obs_depth_w=_host(problem.obs_depth_w)[real] if depth else None,
        mode=mode)


def shard_problem_by_keyframe(
    problem: ba_mod.BAProblem, n_devices: int,
    cam_shard: Optional[np.ndarray] = None,
) -> KeyframeShardedBA:
    """Partition a BAProblem the way a sharded *front-end* produces it:
    each observation sits on the shard owning its keyframe (camera); the
    solve exchanges them to their point-owner shards
    (:func:`keyframe_exchange_plan`), then applies the pre-computed
    sort-by-point permutation."""
    pts, fixed_pts = _padded_points(_host(problem.points),
                                    _host(problem.fixed_points), n_devices)
    nl = pts.shape[1]
    plan = keyframe_exchange_plan(problem, n_devices, cam_shard)

    # the receive order is static → per dest shard, the stable
    # sort-by-point permutation (padding rows carry point id nl−1, so
    # they sort to the tail) over the padded length
    lp = plan.recv_len + (-plan.recv_len % _PAD_M)
    pad = lp - plan.recv_len
    perm = np.zeros((n_devices, lp), np.int32)
    for dd in range(n_devices):
        recv = ex_mod.host_receive_order(plan, dd, n_devices)
        pt_col = np.full(lp, nl - 1, np.int32)
        pt_col[:plan.recv_len] = recv[:, 1].astype(np.int32)
        perm[dd] = np.argsort(pt_col, kind="stable")

    return KeyframeShardedBA(
        poses=_host(problem.poses),
        points=pts,
        k=_host(problem.k),
        payload=plan.payload,
        mode=plan.mode,
        rounds=plan.rounds,
        perm=perm,
        fixed_poses=_host(problem.fixed_poses),
        fixed_points=fixed_pts,
        n_points=problem.points.shape[0],
        recv_len=plan.recv_len,
        pad=pad,
        has_depth=problem.obs_depth is not None,
        prior_center=_host(problem.prior_center),
        prior_invs=_host(problem.prior_invs),
    )


def _psum_packed(arrs, mesh: Mesh):
    """ONE collective for a list of tensors: flatten, concatenate,
    ``all_reduce``, unpack."""
    flat = mesh.all_reduce_(torch.cat([a.reshape(-1) for a in arrs]))
    res = []
    off = 0
    for a in arrs:
        res.append(flat[off:off + a.numel()].reshape(a.shape))
        off += a.numel()
    return res


def _local_cost(poses, points_l, k, obs_cam, obs_pt, obs_uv, obs_w, params,
                obs_depth=None, obs_depth_w=None):
    r, _, _ = ba_mod._project_with_jacobians(
        poses, points_l, k, obs_cam, obs_pt, obs_uv, obs_depth, obs_depth_w)
    sq = torch.sum(r * r, dim=-1)
    w = LOSSES[params.loss](sq, params.loss_scale)
    return 0.5 * torch.sum(obs_w * w * sq)


def _cg_on_dense_blocks(s, u_damped, rhs, free, iters):
    """Replicated PCG on the materialized, gauge-fixed reduced camera
    system ``s`` (6P, 6P) — zero collectives per step; block-Jacobi
    preconditioner from the damped U blocks. ``rhs`` (P, 6)."""
    p = rhs.shape[0]

    def matvec(v):
        return (s @ v.reshape(-1)).reshape(p, 6)

    return ba_mod._pcg(matvec, rhs, ba_mod._block_jacobi(u_damped,
                                                         free[:, None]),
                       iters)


def _solver_mode(params: BAParams, p: int, nl: int) -> str:
    """The reference's static pick: dense Cholesky up to 400 poses,
    replicated PCG on the materialized S while S and Bc fit, the
    matrix-free distributed PCG beyond."""
    s_fits = p * p * 36 * 4 <= _S_MAT_BYTES
    bc_fits = nl * p * 18 * 4 <= _BC_MAT_BYTES
    if params.solver == "dense" or (params.solver == "auto" and p <= 400):
        return "chol"
    if s_fits and bc_fits:
        return "cg_dense"        # materialized S, collective-free CG
    return "cg_matfree"          # one all_reduce per CG step


def _lm_schur_loop(poses, points_l, k, obs_cam, obs_pt, obs_uv, obs_w,
                   fixed_poses, fixed_points_l, params: BAParams,
                   mesh: Mesh, obs_depth=None, obs_depth_w=None,
                   prior_center=None, prior_invs=None):
    """The per-rank LM-Schur loop. ``points_l``/``obs_*``/
    ``fixed_points_l`` are this rank's blocks, poses/k/fixed_poses/priors
    are replicated. Returns (poses_f, points_f, c0, cost_f)."""
    p = poses.shape[0]
    nl = points_l.shape[0]
    free = (~fixed_poses).to(torch.float32)
    # a point participates iff it receives weighted observations
    has_obs = ba_mod._seg_sum(obs_w[:, None], obs_pt, nl)[:, 0] > 0.0
    active = (~fixed_points_l) & has_obs
    has_prior = prior_center is not None
    mode = _solver_mode(params, p, nl)

    def total_cost(ps, pts_l):
        cost = mesh.all_reduce_(_local_cost(
            ps, pts_l, k, obs_cam, obs_pt, obs_uv, obs_w, params,
            obs_depth, obs_depth_w))
        if has_prior:
            # priors depend only on replicated pose state: every rank
            # adds the identical term after the sum
            _, _, pc = ba_mod.prior_terms(ps, prior_center, prior_invs,
                                          fixed_poses, params.loss,
                                          params.loss_scale)
            cost = cost + pc
        return cost

    c0 = total_cost(poses, points_l)
    poses_c, points_c, cost = poses, points_l, c0
    segments = ba_mod._segments(obs_cam, obs_pt, p, nl)
    cams, pts = segments
    lam = torch.full((), params.lambda_init, dtype=torch.float32,
                     device=poses.device)
    for _ in range(params.max_iterations):
        r, j_pose, j_pt = ba_mod._project_with_jacobians(
            poses_c, points_c, k, obs_cam, obs_pt, obs_uv, obs_depth,
            obs_depth_w)
        sq = torch.sum(r * r, dim=-1)
        w = obs_w * LOSSES[params.loss](sq, params.loss_scale)
        wj_pose = j_pose * w[:, None, None]
        wj_pt = j_pt * w[:, None, None]
        u_b = torch.einsum("mki,mkj->mij", wj_pose, j_pose)
        v_b = torch.einsum("mki,mkj->mij", wj_pt, j_pt)
        b_b = torch.einsum("mki,mkj->mij", wj_pose, j_pt)
        gp_t = -ba_mod._mtv(wj_pose, r)
        gx_t = -ba_mod._mtv(wj_pt, r)

        u_partial = ba_mod._seg_sum(u_b, cams, p)
        gp_partial = ba_mod._seg_sum(gp_t, cams, p)
        # point blocks are fully local (observations sit with their points)
        V = ba_mod._seg_sum(v_b, pts, nl)
        g_x = ba_mod._seg_sum(gx_t, pts, nl)
        v_inv = ba_mod._point_inverses(V, lam, active)
        _, rhs_terms = ba_mod._schur_rhs_terms(b_b, v_inv, g_x, obs_pt)
        rhs_partial = ba_mod._seg_sum(rhs_terms, cams, p)

        # ---- the ONE packed collective of the iteration -------------
        if mode in ("chol", "cg_dense"):
            U, g_p, rhs_part, s_sum = _psum_packed(
                [u_partial, gp_partial, rhs_partial,
                 ba_mod._camera_coupling(b_b, v_inv, obs_pt, obs_cam, p)],
                mesh)
        else:
            U, g_p, rhs_part = _psum_packed(
                [u_partial, gp_partial, rhs_partial], mesh)
        if has_prior:
            du, dg, _ = ba_mod.prior_terms(
                poses_c, prior_center, prior_invs, fixed_poses,
                params.loss, params.loss_scale)
            U = U + du
            g_p = g_p + dg
        rhs_p = g_p - rhs_part
        u_damped = ba_mod._damp(U, lam)

        if mode in ("chol", "cg_dense"):
            s, rhs = ba_mod._gauge_fixed_system(-s_sum, u_damped, rhs_p,
                                                fixed_poses)
            if mode == "chol":
                # not positive definite → NaN, and the cost test rejects
                dp = solve_cholesky(s, rhs).reshape(p, 6)
            else:
                dp = _cg_on_dense_blocks(s, u_damped, rhs.reshape(p, 6),
                                         free, params.cg_iters)
        else:
            # matrix-free distributed PCG: each CG step is local O(M/D)
            # observation work + ONE all_reduce of the (P, 6) product
            free1 = free[:, None]

            def matvec(v):
                vf = v * free1
                sv = ba_mod._mv(u_damped, vf) - mesh.all_reduce_(
                    ba_mod._coupling_matvec(b_b, v_inv, vf, obs_cam, obs_pt,
                                            p, segments))
                return sv * free1 + v * (1.0 - free1)

            dp = ba_mod._pcg(matvec, rhs_p * free1,
                             ba_mod._block_jacobi(u_damped, free1),
                             params.cg_iters)
        dp = dp * free[:, None]

        # local point back-substitution
        dx = ba_mod._back_substitute(v_inv, b_b, g_x, dp, obs_cam,
                                     obs_pt, segments) * active[:, None]
        new_poses = lg.se3_retract(poses_c, dp)
        new_points = points_c + dx
        new_cost = total_cost(new_poses, new_points)
        accept = new_cost < cost
        poses_c = torch.where(accept, new_poses, poses_c)
        points_c = torch.where(accept, new_points, points_c)
        lam = torch.clamp(torch.where(accept, lam / params.lambda_factor,
                                      lam * params.lambda_factor),
                          1e-10, 1e8)
        cost = torch.where(accept, new_cost, cost)
    return poses_c, points_c, c0, cost


def _on(x, device, dtype=None):
    """A host array up to ``device`` without a host wait (pinned)."""
    return None if x is None else upload(x, device, dtype)


def _result(mesh: Mesh, out, n_points: int, params: BAParams) -> BAResult:
    poses_f, points_f, c0, cost_f = out
    points_full = mesh.all_gather(points_f).reshape(-1, 3)[:n_points]
    return BAResult(poses=poses_f, points=points_full, initial_cost=c0,
                    final_cost=cost_f, iterations=params.max_iterations)


def bundle_adjust_schur_dist(
    sharded: ShardedBAProblem, mesh: Mesh, params: BAParams = BAParams()
) -> BAResult:
    """The distributed LM-Schur loop on the point-co-located layout.
    Every rank of ``mesh`` calls it with the same host problem and runs
    row ``mesh.rank`` on ``mesh.device``."""
    dev, i = mesh.device, mesh.rank
    f32 = torch.float32
    depth = sharded.obs_depth is not None
    return _result(mesh, _lm_schur_loop(
        _on(sharded.poses, dev, f32), _on(sharded.points[i], dev, f32),
        _on(sharded.k, dev, f32), _on(sharded.obs_cam[i], dev),
        _on(sharded.obs_pt[i], dev), _on(sharded.obs_uv[i], dev, f32),
        _on(sharded.obs_w[i], dev, f32),
        _on(sharded.fixed_poses, dev, torch.bool),
        _on(sharded.fixed_points[i], dev, torch.bool), params, mesh,
        _on(sharded.obs_depth[i], dev, f32) if depth else None,
        _on(sharded.obs_depth_w[i], dev, f32) if depth else None,
        _on(sharded.prior_center, dev, f32),
        _on(sharded.prior_invs, dev, f32)), sharded.n_points, params)


def bundle_adjust_schur_dist_kf(
    sharded: KeyframeShardedBA, mesh: Mesh, params: BAParams = BAParams()
) -> BAResult:
    """Distributed BA from the *keyframe-sharded* layout: each rank
    sends its observations to their points' owners (parallel.exchange:
    one packed all_to_all, or skew-proof rounds), sorts the arrivals by
    point with the planned permutation, and runs the same LM-Schur loop.
    Every rank of ``mesh`` calls it with the same host problem."""
    dev, i = mesh.device, mesh.rank
    f32 = torch.float32
    nl = sharded.points.shape[1]
    send = ex_mod.send_block(sharded.payload, sharded.mode, i, dev)
    recv = ex_mod.exchange_payload_in_spmd(send, sharded.mode,
                                           sharded.rounds, mesh)
    if sharded.pad:
        pad_rows = torch.zeros((sharded.pad, recv.shape[-1]),
                               dtype=recv.dtype, device=dev)
        pad_rows[:, 1] = nl - 1
        recv = torch.cat([recv, pad_rows], dim=0)
    # one row gather per solve: the arrivals sorted by point
    recv = recv.index_select(0, _on(sharded.perm[i], dev).long())
    cam, pt, uv, w, depth, depth_w = ex_mod.unpack_payload(recv)
    return _result(mesh, _lm_schur_loop(
        _on(sharded.poses, dev, f32), _on(sharded.points[i], dev, f32),
        _on(sharded.k, dev, f32), cam, pt, uv, w,
        _on(sharded.fixed_poses, dev, torch.bool),
        _on(sharded.fixed_points[i], dev, torch.bool), params, mesh,
        depth, depth_w, _on(sharded.prior_center, dev, f32),
        _on(sharded.prior_invs, dev, f32)), sharded.n_points, params)
