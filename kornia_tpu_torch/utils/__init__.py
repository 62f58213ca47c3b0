"""Utilities: the tensor-ops parity layer, tracing and stage timing (port
of kornia_tpu/utils/); ``viz`` is imported on its own, as in the
reference."""

from kornia_tpu_torch.utils import tensor_ops
from kornia_tpu_torch.utils import tracing
from kornia_tpu_torch.utils.tracing import Tracer, env_variant, trace_enabled

__all__ = [
    "tensor_ops",
    "tracing",
    "Tracer",
    "env_variant",
    "trace_enabled",
]
