"""Ragged cross-shard observation exchange (port of
kornia_tpu/parallel/exchange.py).

In a keyframe-sharded SLAM pipeline, observations are *produced* on the
shard that owns the observing keyframe but *consumed* (for Schur
reduction) on the shard that owns the 3D point. This module routes them:

  host plan (static topology)  →  one collective round trip per rank
  →  arrival order is deterministic, padding rows carry weight 0.

All observation fields (cam id, local point id, uv, weight, optional
RGB-D depth + depth weight) are packed into one f32 payload so the
exchange moves one buffer whatever the field count (integer ids < 2^24
are exact in f32).

Two wire layouts, chosen per plan by payload size:

* ``a2a``: buckets padded to the max pairwise count B, one
  ``all_to_all_single`` of (D, B, C) per rank. Payload per rank = D·B·C.
* ``rounds``: D−1 rounds at rank offsets r = 1..D−1, each padded only to
  that offset's own max count B_r (offset 0, self traffic, is a local
  slice). A round sends to ``(rank + r) % D`` and receives from
  ``(rank − r) % D``: an ``all_to_all_single`` with one non-empty split
  each way (a ppermute). A single hot co-visibility pair inflates ONE
  round instead of all D² buckets.

``mode="auto"`` picks whichever moves fewer bytes (rounds only at a real
saving, as it pays D−1 collective latencies).

The host planning (:func:`build_exchange_plan`, :func:`host_receive_order`)
is numpy and gives the reference's plan field for field.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from kornia_tpu_torch import upload
from kornia_tpu_torch.parallel.mesh import Mesh

# payload column layout (f32): cam id, local point id, u, v, weight
# [, depth, depth weight]
_COLS_BASE = 5
_COLS_DEPTH = 7


class ExchangePlan(NamedTuple):
    """Static routing plan built on the host from the (static) topology.

    ``payload`` is the packed send buffer, host numpy:

    * a2a:    one array (D, D, B, C) — row [s, d] holds what source
      shard s sends to dest d, padded to bucket B with weight-0 rows;
    * rounds: a tuple of arrays, one per active offset in ``rounds``;
      array for offset r has shape (D, B_r, C) — row s holds what
      source s sends to dest (s + r) % D.

    Receive order per dest shard is deterministic: a2a concatenates
    source shards 0..D−1; rounds concatenates offsets in ``rounds``
    order (source (d − r) % D at offset r).
    """

    payload: Union[np.ndarray, Tuple[np.ndarray, ...]]
    mode: str                  # "a2a" | "rounds"
    rounds: Tuple[int, ...]    # active offsets (rounds mode; () for a2a)
    bucket: int                # max pairwise count (diagnostic)
    n_cols: int                # C: 5, or 7 with depth
    recv_len: int              # rows received per shard (L)

    @property
    def payload_bytes(self) -> int:
        """Total bytes moved through the interconnect (all shards)."""
        if self.mode == "a2a":
            return int(self.payload.size) * 4
        return int(sum(p.size for p in self.payload)) * 4


def _pack(cam, pt, uv, w, depth=None, depth_w=None):
    cols = [cam.astype(np.float32)[..., None],
            pt.astype(np.float32)[..., None],
            uv.astype(np.float32),
            w.astype(np.float32)[..., None]]
    if depth is not None:
        cols += [depth.astype(np.float32)[..., None],
                 depth_w.astype(np.float32)[..., None]]
    return np.concatenate(cols, axis=-1)


def unpack_payload(x: torch.Tensor):
    """(..., C) payload → (cam i32, pt i32, uv, w[, depth, depth_w])."""
    cam = x[..., 0].to(torch.int32)
    pt = x[..., 1].to(torch.int32)
    uv = x[..., 2:4]
    w = x[..., 4]
    if x.shape[-1] >= _COLS_DEPTH:
        return cam, pt, uv, w, x[..., 5], x[..., 6]
    return cam, pt, uv, w, None, None


def build_exchange_plan(
    obs_src_shard: np.ndarray, obs_cam: np.ndarray, obs_pt: np.ndarray,
    obs_uv: np.ndarray, n_devices: int, points_per_shard: int,
    obs_w: Optional[np.ndarray] = None,
    obs_depth: Optional[np.ndarray] = None,
    obs_depth_w: Optional[np.ndarray] = None,
    mode: str = "auto",
) -> ExchangePlan:
    """Group observations by (producer shard, owner shard of the point).

    obs_src_shard: (M,) shard that currently holds each observation
    (e.g. the keyframe owner). Point ownership is contiguous:
    dest = obs_pt // points_per_shard; local id = obs_pt % points_per_shard.

    Padding rows carry weight 0 and local point id points_per_shard − 1
    (keeping per-dest receive buffers sortable-by-point without a
    special case; zero weight makes them self-masking downstream).
    """
    obs_src_shard = np.asarray(obs_src_shard, np.int64)
    obs_cam = np.asarray(obs_cam, np.int32)
    obs_pt = np.asarray(obs_pt, np.int64)
    obs_uv = np.asarray(obs_uv, np.float32)
    m = obs_cam.shape[0]
    if obs_w is None:
        obs_w = np.ones(m, np.float32)
    has_depth = obs_depth is not None
    if has_depth:
        obs_depth = np.asarray(obs_depth, np.float32)
        obs_depth_w = (np.ones(m, np.float32) if obs_depth_w is None
                       else np.asarray(obs_depth_w, np.float32))
    dest = obs_pt // points_per_shard
    local_pt = (obs_pt % points_per_shard).astype(np.int32)
    d = n_devices
    c = _COLS_DEPTH if has_depth else _COLS_BASE

    counts = np.zeros((d, d), np.int64)
    np.add.at(counts, (obs_src_shard, dest), 1)
    bucket = max(int(counts.max()), 1)

    # per-offset buckets: offset r carries pairs (s → (s+r) % d)
    src_ids = np.arange(d)
    b_r = np.array([counts[src_ids, (src_ids + r) % d].max()
                    for r in range(d)], np.int64)
    bytes_a2a = d * d * bucket * c
    bytes_rounds = d * int(b_r.sum()) * c
    if mode == "auto":
        mode = "rounds" if bytes_rounds * 2 < bytes_a2a else "a2a"

    pad_pt = points_per_shard - 1
    packed = _pack(obs_cam, local_pt, obs_uv, obs_w,
                   obs_depth if has_depth else None,
                   obs_depth_w if has_depth else None)
    # each observation's slot in its (source, dest) bucket: its rank
    # among that pair's observations in input order
    pair = obs_src_shard * d + dest
    order = np.argsort(pair, kind="stable")
    first = np.cumsum(counts.reshape(-1)) - counts.reshape(-1)
    slot = np.empty(m, np.int64)
    slot[order] = np.arange(m) - first[pair[order]]

    if mode == "a2a":
        payload = np.zeros((d, d, bucket, c), np.float32)
        payload[:, :, :, 1] = pad_pt
        payload[obs_src_shard, dest, slot] = packed
        return ExchangePlan(
            payload=payload, mode="a2a", rounds=(),
            bucket=bucket, n_cols=c, recv_len=d * bucket)

    active = tuple(int(r) for r in range(d) if b_r[r] > 0)
    if not active:
        active = (0,)
        b_r[0] = 1
    offset = (dest - obs_src_shard) % d
    payload = []
    for r in active:
        arr = np.zeros((d, int(b_r[r]), c), np.float32)
        arr[:, :, 1] = pad_pt
        sel = offset == r
        arr[obs_src_shard[sel], slot[sel]] = packed[sel]
        payload.append(arr)
    return ExchangePlan(
        payload=tuple(payload), mode="rounds", rounds=active,
        bucket=bucket, n_cols=c,
        recv_len=int(sum(b_r[r] for r in active)))


def host_receive_order(plan: ExchangePlan, dest: int, n_devices: int):
    """The (static, deterministic) receive buffer of shard ``dest`` as a
    host numpy array (L, C): what :func:`exchange_payload_in_spmd`
    delivers there. Lets callers pre-build sort permutations on the
    post-exchange ordering (ba_dist does)."""
    if plan.mode == "a2a":
        buf = np.asarray(plan.payload)[:, dest]          # (D, B, C)
        return buf.reshape(-1, plan.n_cols)
    parts = []
    for arr, r in zip(plan.payload, plan.rounds):
        src = (dest - r) % n_devices
        parts.append(np.asarray(arr)[src])
    return np.concatenate(parts, axis=0)


def send_block(plan_payload, plan_mode: str, rank: int, device):
    """This rank's row of a plan's payload, on ``device``: (D, B, C) for
    a2a, a tuple of (B_r, C) blocks for rounds."""
    if plan_mode == "a2a":
        return upload(plan_payload[rank], device)
    return tuple(upload(arr[rank], device) for arr in plan_payload)


def exchange_payload_in_spmd(payload, plan_mode: str,
                             rounds: Tuple[int, ...],
                             mesh: Mesh) -> torch.Tensor:
    """Run the exchange on this rank, inside a program every rank of
    ``mesh`` runs. ``payload``: this rank's send block (:func:`send_block`).
    Returns the received rows (L, C) in the deterministic order of
    :func:`host_receive_order`: one collective for a2a, one per nonzero
    offset for rounds."""
    d = mesh.size
    if plan_mode == "a2a":
        b, c = payload.shape[1], payload.shape[2]
        rows = [b] * d
        return mesh.all_to_all(payload.reshape(d * b, c), rows, rows)
    parts = []
    for x, r in zip(payload, rounds):
        if r % d != 0:
            b = x.shape[0]
            send = [b if t == (mesh.rank + r) % d else 0 for t in range(d)]
            recv = [b if s == (mesh.rank - r) % d else 0 for s in range(d)]
            x = mesh.all_to_all(x, send, recv)
        parts.append(x)
    return torch.cat(parts, dim=0)


def exchange_observations(
    plan: ExchangePlan, mesh: Mesh
) -> Tuple[torch.Tensor, ...]:
    """Run the exchange standalone: every shard receives the
    observations whose points it owns, and every rank returns all of
    them.

    Returns (obs_cam, obs_pt_local, obs_uv, obs_w), each with leading
    shape (D, L) — receive buffers per shard in deterministic order
    (see :func:`host_receive_order`), gathered by one all-gather. With
    depth columns in the plan, two extra fields (obs_depth, obs_depth_w)
    are appended.
    """
    send = send_block(plan.payload, plan.mode, mesh.rank, mesh.device)
    recv = exchange_payload_in_spmd(send, plan.mode, plan.rounds, mesh)
    fields = unpack_payload(mesh.all_gather(recv))
    return tuple(f for f in fields if f is not None)
