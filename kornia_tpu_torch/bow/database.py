"""BoW image database: inverted index + direct index for loop closure
(port of kornia_tpu/bow/database.py).

Add keyframes, query the inverted index for candidates, and match
features word by word through the direct index. Host Python over dicts;
the vocabulary's transform runs on its device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from kornia_tpu_torch.bow.scoring import SCORES, BowVector
from kornia_tpu_torch.bow.vocabulary import Vocabulary, _popcount_u8


@dataclass
class QueryResult:
    entry_id: int
    score: float


@dataclass
class BowDatabase:
    """Inverted-index database over BoW vectors."""

    vocabulary: Vocabulary
    use_direct_index: bool = True
    _vectors: List[BowVector] = field(default_factory=list)
    _direct: List[Optional[Dict[int, np.ndarray]]] = field(
        default_factory=list)
    _inverted: Dict[int, List[int]] = field(default_factory=dict)

    def add(self, descriptors: np.ndarray) -> int:
        """Add an image's descriptors; returns its entry id."""
        if self.use_direct_index:
            vec, direct = self.vocabulary.transform_with_direct_index(
                descriptors)
        else:
            vec = self.vocabulary.transform(descriptors)
            direct = None
        entry = len(self._vectors)
        self._vectors.append(vec)
        self._direct.append(direct)
        for w in vec:
            self._inverted.setdefault(w, []).append(entry)
        return entry

    def __len__(self) -> int:
        return len(self._vectors)

    def vector(self, entry_id: int) -> BowVector:
        return self._vectors[entry_id]

    def direct_index(self, entry_id: int) -> Optional[Dict[int, np.ndarray]]:
        return self._direct[entry_id]

    def query(self, descriptors: np.ndarray, top_k: int = 5,
              score: str = "l1",
              exclude: Tuple[int, ...] = ()) -> List[QueryResult]:
        """Rank stored entries against a query image."""
        if score not in SCORES:
            raise ValueError(f"unknown score {score!r}")
        vec = self.vocabulary.transform(descriptors)
        # candidates: any entry sharing at least one word
        cand: Dict[int, int] = {}
        for w in vec:
            for e in self._inverted.get(w, ()):
                cand[e] = cand.get(e, 0) + 1
        fn = SCORES[score]
        reverse = score != "kl"
        results = [QueryResult(e, fn(vec, self._vectors[e]))
                   for e in cand if e not in exclude]
        results.sort(key=lambda r: r.score, reverse=reverse)
        return results[:top_k]

    def match_via_direct_index(
        self, entry_a: int, entry_b: int,
        desc_a: np.ndarray, desc_b: np.ndarray,
        max_distance: int = 64,
    ) -> np.ndarray:
        """Feature matches between two stored entries using shared words.

        Only descriptor pairs that quantize to the same vocabulary word
        are compared (the DirectIndex trick) — returns (M, 2) index
        pairs (i_a, i_b).
        """
        da = self._direct[entry_a]
        db = self._direct[entry_b]
        if da is None or db is None:
            raise ValueError("direct index disabled")
        pairs = []
        for w, ia in da.items():
            ib = db.get(w)
            if ib is None:
                continue
            xa = np.asarray(desc_a, np.uint8)[ia]
            xb = np.asarray(desc_b, np.uint8)[ib]
            d = _popcount_u8(xa[:, None, :] ^ xb[None, :, :]).sum(-1)
            best = d.argmin(1)
            ok = d[np.arange(len(ia)), best] <= max_distance
            for i, j, o in zip(ia, ib[best], ok):
                if o:
                    pairs.append((i, j))
        return np.asarray(pairs, np.int64).reshape(-1, 2)
