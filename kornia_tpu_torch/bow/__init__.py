"""Bag-of-words place recognition (port of kornia_tpu/bow)."""

from kornia_tpu_torch.bow.vocabulary import Vocabulary
from kornia_tpu_torch.bow.scoring import (
    SCORES,
    score_l1,
    score_l2,
    score_dot,
    score_chi_square,
    score_bhattacharyya,
    score_kl,
)
from kornia_tpu_torch.bow.database import BowDatabase, QueryResult

__all__ = [
    "Vocabulary",
    "BowDatabase",
    "QueryResult",
    "SCORES",
    "score_l1",
    "score_l2",
    "score_dot",
    "score_chi_square",
    "score_bhattacharyya",
    "score_kl",
]
