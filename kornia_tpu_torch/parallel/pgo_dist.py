"""Distributed pose-graph optimisation (port of
kornia_tpu/parallel/pgo_dist.py).

Edges are sharded across the mesh (residual + Jacobian work is
O(edges)); poses are replicated (6P is small). Each rank accumulates its
partial block Hessian (P, P, 6, 6) and gradient from its own edges, one
``all_reduce`` sums both (packed in one buffer), and every rank runs the
identical gauge-fixed damped solve and retract on the same bits. A second
``all_reduce`` of the cost decides accept or reject, the same on every
rank. Two collectives per LM iteration; the accept decision, λ and the
cost stay on the device (``torch.where``), so NCCL ranks run the loop
without a host wait.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from kornia_tpu_torch import upload
from kornia_tpu_torch.geometry import liegroup as lg
from kornia_tpu_torch.optim import pgo as pgo_mod
from kornia_tpu_torch.parallel.mesh import Mesh


class ShardedPGOProblem(NamedTuple):
    """Host numpy, leading axis = shards (D)."""

    poses: np.ndarray       # (Np, 7) replicated
    edge_i: np.ndarray      # (D, El) int32
    edge_j: np.ndarray      # (D, El)
    edge_meas: np.ndarray   # (D, El, 7)
    edge_w: np.ndarray      # (D, El) 0 = padding
    fixed: np.ndarray       # (Np,) bool replicated


def shard_pgo(poses, edge_i, edge_j, edge_meas, edge_w=None,
              fixed=None, n_devices: int = 1) -> ShardedPGOProblem:
    """Host-side static partitioning: contiguous edge blocks of
    ceil(E / D), zero-weight identity padding."""
    edge_i = np.asarray(edge_i, np.int32)
    edge_j = np.asarray(edge_j, np.int32)
    edge_meas = np.asarray(edge_meas, np.float32)
    e = edge_i.shape[0]
    if edge_w is None:
        edge_w = np.ones(e, np.float32)
    edge_w = np.asarray(edge_w, np.float32)
    p = np.asarray(poses).shape[0]
    if fixed is None:
        fixed = np.zeros(p, bool)
        fixed[0] = True

    el = max(-(-e // n_devices), 1)
    pad = el * n_devices
    ei = np.zeros(pad, np.int32)
    ej = np.zeros(pad, np.int32)
    em = np.tile(np.array([1, 0, 0, 0, 0, 0, 0], np.float32), (pad, 1))
    ew = np.zeros(pad, np.float32)
    ei[:e], ej[:e], em[:e], ew[:e] = edge_i, edge_j, edge_meas, edge_w

    return ShardedPGOProblem(
        poses=np.asarray(poses, np.float32),
        edge_i=ei.reshape(n_devices, el),
        edge_j=ej.reshape(n_devices, el),
        edge_meas=em.reshape(n_devices, el, 7),
        edge_w=ew.reshape(n_devices, el),
        fixed=np.asarray(fixed, bool),
    )


def pose_graph_optimize_dist(
    problem: ShardedPGOProblem, mesh: Mesh,
    params: pgo_mod.PGOParams = pgo_mod.PGOParams(),
) -> pgo_mod.PGOResult:
    """LM over edge shards: every rank of ``mesh`` calls it with the same
    host problem and takes row ``mesh.rank`` to ``mesh.device``; partial
    H/g → one ``all_reduce`` → replicated solve. Every rank returns the
    same poses (on its device)."""
    dev, k = mesh.device, mesh.rank
    n_poses = problem.poses.shape[0]
    f32 = torch.float32
    poses = upload(problem.poses, dev, f32)
    edges = (upload(problem.edge_i[k], dev, torch.int64),
             upload(problem.edge_j[k], dev, torch.int64),
             upload(problem.edge_meas[k], dev, f32),
             upload(problem.edge_w[k], dev, f32))
    free = upload(~np.asarray(problem.fixed), dev, f32)

    def cost_fn(ps):
        return mesh.all_reduce_(pgo_mod.edge_cost(ps, *edges, params))

    n_h = n_poses * n_poses * 36
    c0 = cost_fn(poses)
    ps, cost = poses, c0
    lam = torch.full((), params.lambda_init, dtype=torch.float32, device=dev)
    for _ in range(params.max_iterations):
        h, g, _ = pgo_mod.pgo_normal_equations(ps, *edges, params)
        hg = mesh.all_reduce_(torch.cat([h.reshape(-1), g.reshape(-1)]))
        h = hg[:n_h].reshape(n_poses, n_poses, 6, 6)
        g = hg[n_h:].reshape(n_poses, 6)
        ps_new = lg.se3_retract(ps, pgo_mod.damped_step(h, g, free, lam))
        new_cost = cost_fn(ps_new)
        accept = new_cost < cost
        ps = torch.where(accept, ps_new, ps)
        lam = torch.clamp(torch.where(accept, lam / params.lambda_factor,
                                      lam * params.lambda_factor),
                          1e-12, 1e8)
        cost = torch.where(accept, new_cost, cost)
    return pgo_mod.PGOResult(poses=ps, initial_cost=c0, final_cost=cost,
                             iterations=params.max_iterations)
