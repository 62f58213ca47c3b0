"""Elementwise tensor ops with the reference's contract (port of
kornia_tpu/utils/tensor_ops.py): explicit shape checks with typed errors
instead of silent broadcasting. Results keep the reference's dtypes: a
mean of integers is float32, a sum keeps the operand's dtype."""

from __future__ import annotations

import torch


class TensorOpsError(Exception):
    """Base error."""


class ShapeMismatchError(TensorOpsError):
    """Operand shapes differ (broadcasting intentionally NOT applied)."""


class DimOutOfBoundsError(TensorOpsError):
    """Reduction dim outside the operand's rank."""


def _check_same_shape(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.shape != b.shape:
        raise ShapeMismatchError(
            f"shape mismatch: {tuple(a.shape)} vs {tuple(b.shape)}")


def add(a, b):
    _check_same_shape(a, b)
    return a + b


def sub(a, b):
    _check_same_shape(a, b)
    return a - b


def mul(a, b):
    _check_same_shape(a, b)
    return a * b


def div(a, b):
    _check_same_shape(a, b)
    return a / b


def mul_scalar(a, s: float):
    return a * s


def powf(a, p: float):
    return torch.pow(a, p)


def powi(a, p: int):
    return torch.pow(a, p)


def abs(a):  # noqa: A001 - parity naming with the reference
    return torch.abs(a)


def element_min(a, b):
    _check_same_shape(a, b)
    return torch.minimum(a, b)


def mean(a):
    return torch.mean(a if a.is_floating_point() else a.to(torch.float32))


def sum_elements(a, dim: int):
    """Dim-wise sum with bounds checking."""
    if not -a.ndim <= dim < a.ndim:
        raise DimOutOfBoundsError(f"dim {dim} out of bounds for rank {a.ndim}")
    return torch.sum(a, dim=dim, dtype=a.dtype)


def dot_product1(a, b):
    """1-D dot product."""
    _check_same_shape(a, b)
    if a.ndim != 1:
        raise DimOutOfBoundsError(f"dot_product1 expects rank-1, got {a.ndim}")
    return torch.dot(a, b)


def cosine_similarity(a, b, eps: float = 1e-8):
    _check_same_shape(a, b)
    num = torch.sum(a * b)
    den = torch.sqrt(torch.sum(a * a)) * torch.sqrt(torch.sum(b * b))
    return num / torch.clamp(den, min=eps)


def cosine_distance(a, b, eps: float = 1e-8):
    return 1.0 - cosine_similarity(a, b, eps)
