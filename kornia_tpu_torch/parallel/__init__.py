"""Distributed layer (port of kornia_tpu/parallel/, over
``torch.distributed``): mesh helpers, sharded Schur BA, distributed PGO,
ragged observation exchange, data-parallel front-end, job resilience,
and the controller that lets one rank drive solves that every rank joins
(:func:`follow`). Importing it starts no process group."""

from kornia_tpu_torch.parallel import mesh
from kornia_tpu_torch.parallel import ba_dist
from kornia_tpu_torch.parallel import pgo_dist
from kornia_tpu_torch.parallel import exchange
from kornia_tpu_torch.parallel import frontend_dist
from kornia_tpu_torch.parallel import resilience
from kornia_tpu_torch.parallel import controller
from kornia_tpu_torch.parallel.controller import follow

__all__ = ["mesh", "ba_dist", "pgo_dist", "exchange", "frontend_dist",
           "resilience", "controller", "follow"]
