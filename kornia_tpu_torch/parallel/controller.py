"""One controller over SPMD ranks.

The reference drives its distributed solves from one process. Here every
rank is a process, and a solve needs every rank of the mesh to call it
with the same host problem. So one rank leads: rank 0 runs the program
(``MonocularSlam`` with ``mesh=``) and hands each distributed solve to
:func:`lead`, which broadcasts the solve's name and host problem before
running it; every other rank sits in :func:`follow`, which receives each
such job, joins the solve and waits for the next, until rank 0 calls
:func:`stop`. Every rank's input is rank 0's bytes, so the ranks cannot
drift apart on maps built apart.
"""

from __future__ import annotations

from kornia_tpu_torch.parallel import ba_dist, pgo_dist
from kornia_tpu_torch.parallel.mesh import Mesh

# the solves a follower may be asked to join, by name
JOBS = {
    "ba_dist": ba_dist.bundle_adjust_schur_dist,
    "ba_dist_kf": ba_dist.bundle_adjust_schur_dist_kf,
    "pgo_dist": pgo_dist.pose_graph_optimize_dist,
}


def lead(mesh: Mesh, job: str, problem, params):
    """On rank 0: send ``job`` (a name of :data:`JOBS`), its host problem
    and its parameters to the followers, run ``JOBS[job](problem, mesh,
    params)`` here and return its result."""
    if mesh.rank != 0:
        raise RuntimeError("only rank 0 leads")
    fn = JOBS[job]
    if mesh.size > 1:
        mesh.broadcast_object((job, problem, params))
    return fn(problem, mesh, params)


def follow(mesh: Mesh) -> int:
    """On every rank but 0: join each job rank 0 leads until it stops;
    returns the number of jobs joined."""
    n = 0
    while True:
        msg = mesh.broadcast_object(None)
        if msg is None:
            return n
        job, problem, params = msg
        JOBS[job](problem, mesh, params)
        n += 1


def stop(mesh: Mesh) -> None:
    """On rank 0: release the followers."""
    if mesh.size > 1:
        mesh.broadcast_object(None)
