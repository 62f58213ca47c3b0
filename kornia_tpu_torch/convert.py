"""Carry state from the JAX package into the port.

There are no learned weights on the ported path. The state is the
configurations and, for stage-by-stage comparison, the reference's
intermediate arrays. Both arrive as plain numpy / Python values (so this
module imports nothing of the JAX package) and leave as the port's objects
and tensors on a given device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from kornia_tpu_torch import resolve_device, to_device
from kornia_tpu_torch.features.orb import OrbConfig
from kornia_tpu_torch.geometry.twoview import TwoViewParams


def _config(cls, values: Mapping[str, Any]):
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = set(values) - fields
    if unknown:
        raise ValueError(f"{cls.__name__}: unknown fields {sorted(unknown)}")
    return cls(**{k: (v.item() if isinstance(v, np.generic) else v)
                  for k, v in values.items()})


def orb_config(values: Mapping[str, Any]) -> OrbConfig:
    """``dataclasses.asdict`` of the reference's OrbConfig → OrbConfig."""
    return _config(OrbConfig, values)


def twoview_params(values: Mapping[str, Any]) -> TwoViewParams:
    """``dataclasses.asdict`` of the reference's TwoViewParams →
    TwoViewParams."""
    return _config(TwoViewParams, values)


def tensor(array, device="cpu", dtype: torch.dtype | None = None
           ) -> torch.Tensor:
    """One numpy array (pyramid level, keypoint xy, angles, descriptor
    bits, mask, ...) → a tensor of the same dtype on ``device``."""
    return to_device(np.asarray(array), resolve_device(device), dtype)


def tensors(arrays: Mapping[str, Any], device="cpu") -> Dict[str, Any]:
    """A dict of numpy arrays (or lists of them, e.g. pyramid levels) →
    the same keys holding tensors on ``device``."""
    out = {}
    for k, v in arrays.items():
        if isinstance(v, (list, tuple)):
            out[k] = [tensor(a, device) for a in v]
        else:
            out[k] = tensor(v, device)
    return out
