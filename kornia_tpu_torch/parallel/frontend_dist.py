"""Data-parallel feature front-end over a mesh of ranks (port of
kornia_tpu/parallel/frontend_dist.py).

A batch of frames is split on its leading axis: rank ``i`` of a D-rank
mesh runs ORB on frames ``[i·B/D, (i+1)·B/D)`` on its own device (K1 one
launch, K2 two, K3 one a frame), with no collective, and one all-gather
(every field packed into one byte buffer) gives every rank the whole
batch's features, as the reference's sharded ``vmap`` returns them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from kornia_tpu_torch.features import matching, orb
from kornia_tpu_torch.parallel.mesh import Mesh


def _stack(rows, cls):
    return cls(*(torch.stack(f) for f in zip(*rows)))


def _gather_rows(local: NamedTuple, mesh: Mesh) -> NamedTuple:
    """Each rank's (b, …) fields → every rank's (D·b, …), rank order, in
    one all-gather of the fields' bytes."""
    b = local[0].shape[0]
    parts = [t.contiguous().reshape(b, -1).view(torch.uint8) for t in local]
    flat = mesh.all_gather(torch.cat(parts, dim=1))
    flat = flat.reshape(mesh.size * b, -1)
    out, off = [], 0
    for t, part in zip(local, parts):
        n = part.shape[1]
        out.append(flat[:, off:off + n].contiguous().view(t.dtype).reshape(
            (mesh.size * b,) + tuple(t.shape[1:])))
        off += n
    return type(local)(*out)


def _my_rows(batch, mesh: Mesh):
    b = len(batch)
    if b % mesh.size:
        raise ValueError(f"batch of {b} over a mesh of {mesh.size} ranks: "
                         "B must be divisible by the mesh size")
    per = b // mesh.size
    return batch[mesh.rank * per:(mesh.rank + 1) * per]


def detect_and_describe_batch(
    gray_batch,
    cfg: orb.OrbConfig = orb.OrbConfig(),
    mesh: Optional[Mesh] = None,
    device="cuda",
) -> orb.OrbFeatures:
    """ORB over a (B, H, W) u8 batch (numpy or tensor), split across the
    mesh's ranks. B must be divisible by the mesh size. Returns
    OrbFeatures with a leading batch axis on every rank, on the rank's
    device. Without a mesh the whole batch runs on ``device``."""
    if mesh is None:
        return _stack([orb.orb_detect_and_describe(g, cfg, device=device)
                       for g in gray_batch], orb.OrbFeatures)
    local = _stack([orb.orb_detect_and_describe(g, cfg, device=mesh.device)
                    for g in _my_rows(gray_batch, mesh)], orb.OrbFeatures)
    return _gather_rows(local, mesh)


def match_batch(
    desc_a, desc_b, mask_a, mask_b,
    mesh: Optional[Mesh] = None,
    max_distance: int = 64, ratio: float = 0.8,
    device="cuda",
) -> matching.Matches:
    """Batched descriptor matching of (B, N, 256) frame pairs, split
    across the mesh's ranks as :func:`detect_and_describe_batch` splits
    frames; every rank returns the whole batch's Matches."""
    dev = device if mesh is None else mesh.device

    def run(rows):
        return _stack([matching.match_descriptors(
            da, db, a_mask=ma, b_mask=mb, max_distance=max_distance,
            ratio=ratio, device=dev) for da, db, ma, mb in zip(*rows)],
            matching.Matches)

    batch = (desc_a, desc_b, mask_a, mask_b)
    if mesh is None:
        return run(batch)
    return _gather_rows(run([_my_rows(x, mesh) for x in batch]), mesh)
