"""Non-linear least squares: LM, Schur bundle adjustment, pose-graph
optimisation (port of kornia_tpu/optim)."""

from kornia_tpu_torch.optim import losses
from kornia_tpu_torch.optim import lm
from kornia_tpu_torch.optim import ba
from kornia_tpu_torch.optim import pgo

__all__ = ["losses", "lm", "ba", "pgo"]
