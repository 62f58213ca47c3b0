"""BoW vector similarity scores (port of kornia_tpu/bow/scoring.py, plain
Python over dicts, copied: the port imports nothing of the JAX package).

Vectors are sparse ``{word: weight}`` dicts, L1-normalized by the
transform. All scores return "higher = more similar" except kl
(divergence, lower = more similar) — same contracts as the reference.
"""

from __future__ import annotations

import math
from typing import Dict

BowVector = Dict[int, float]


def score_l1(a: BowVector, b: BowVector) -> float:
    """DBoW2-style L1 score: 1 − ½·Σ|aᵢ − bᵢ| ∈ [0, 1]."""
    acc = 0.0
    for w, va in a.items():
        vb = b.get(w)
        if vb is not None:
            acc += abs(va - vb) - abs(va) - abs(vb)
    total = sum(abs(v) for v in a.values()) + sum(abs(v) for v in b.values())
    return 1.0 - 0.5 * (total + acc)


def score_l2(a: BowVector, b: BowVector) -> float:
    """1 − ½·‖a − b‖² over the (unit-normalized) common support."""
    dot = 0.0
    for w, va in a.items():
        vb = b.get(w)
        if vb is not None:
            dot += va * vb
    na = math.sqrt(sum(v * v for v in a.values()))
    nb = math.sqrt(sum(v * v for v in b.values()))
    if na == 0 or nb == 0:
        return 0.0
    return dot / (na * nb)


def score_dot(a: BowVector, b: BowVector) -> float:
    """Raw dot product."""
    return sum(va * b[w] for w, va in a.items() if w in b)


def score_chi_square(a: BowVector, b: BowVector) -> float:
    """χ² similarity: Σ 2·aᵢbᵢ/(aᵢ+bᵢ)."""
    acc = 0.0
    for w, va in a.items():
        vb = b.get(w)
        if vb is not None and va + vb > 0:
            acc += 2.0 * va * vb / (va + vb)
    return acc


def score_bhattacharyya(a: BowVector, b: BowVector) -> float:
    """Bhattacharyya coefficient: Σ √(aᵢ·bᵢ)."""
    acc = 0.0
    for w, va in a.items():
        vb = b.get(w)
        if vb is not None and va > 0 and vb > 0:
            acc += math.sqrt(va * vb)
    return acc


def score_kl(a: BowVector, b: BowVector, eps: float = 1e-12) -> float:
    """KL divergence D(a‖b); lower = more similar."""
    acc = 0.0
    for w, va in a.items():
        if va <= 0:
            continue
        vb = b.get(w, eps)
        acc += va * math.log(va / max(vb, eps))
    return acc


SCORES = {
    "l1": score_l1,
    "l2": score_l2,
    "dot": score_dot,
    "chi_square": score_chi_square,
    "bhattacharyya": score_bhattacharyya,
    "kl": score_kl,
}
