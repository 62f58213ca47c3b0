"""AprilTag family tables and code matching (port of
kornia_tpu/apriltag/families.py).

The bit layouts and codebooks are data files under ``families/``, copies
of the reference's (a test holds their SHA-256 equal).

Conventions:
  * bit i lives at border-frame cell (bit_x[i], bit_y[i]); the black
    border square spans cells [0, width_at_border).
  * a set bit renders white; codes accumulate MSB-first over bit order.
Code matching is brute-force XOR + popcount over the whole codebook ×
4 rotations, vectorized.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np

_FAMILY_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "families")

FAMILY_NAMES = (
    "tag16h5", "tag25h9", "tag36h10", "tag36h11",
    "tagcircle21h7", "tagcircle49h12", "tagcustom48h12",
    "tagstandard41h12", "tagstandard52h13",
)


@dataclass(frozen=True)
class TagFamily:
    """One AprilTag family (reference: family/mod.rs TagFamily)."""

    name: str
    width_at_border: int
    reversed_border: bool
    total_width: int
    nbits: int
    bit_x: np.ndarray             # (nbits,) border-frame cell x
    bit_y: np.ndarray             # (nbits,) border-frame cell y
    min_hamming: int
    codes: np.ndarray             # (ncodes,) uint64
    rot_perm: Optional[np.ndarray] = field(default=None, compare=False)

    @property
    def max_safe_hamming(self) -> int:
        return (self.min_hamming - 1) // 2

    def bit_centers_tag(self) -> np.ndarray:
        """(nbits, 2) bit-cell centers in tag coords ([-1,1] spans the
        border square)."""
        wb = self.width_at_border
        cx = 2.0 * (self.bit_x + 0.5) / wb - 1.0
        cy = 2.0 * (self.bit_y + 0.5) / wb - 1.0
        return np.stack([cx, cy], axis=1)

    def rotate_code(self, code: int, k: int = 1) -> int:
        """Rotate an nbits observed code by k×90° via the bit permutation."""
        if self.rot_perm is None:
            raise ValueError(f"family {self.name} has no rotation symmetry")
        bits = np.array([(code >> (self.nbits - 1 - i)) & 1
                         for i in range(self.nbits)], np.uint64)
        for _ in range(k % 4):
            bits = bits[self.rot_perm]
        out = 0
        for b in bits:
            out = (out << 1) | int(b)
        return out

    def match(self, code: int, max_hamming: int = 2
              ) -> Optional[Tuple[int, int, int]]:
        """Find (tag_id, hamming, rotation) for an observed code, or None.

        Tries the code under all 4 rotations against the whole codebook
        (vectorized xor+popcount).
        """
        if max_hamming > self.max_safe_hamming:
            raise ValueError(
                f"max_hamming {max_hamming} > safe bound "
                f"{self.max_safe_hamming} for {self.name}")
        best = None
        c = code
        n_rot = 4 if self.rot_perm is not None else 1
        for r in range(n_rot):
            diff = np.bitwise_xor(self.codes, np.uint64(c))
            ham = np.bitwise_count(diff)
            i = int(np.argmin(ham))
            h = int(ham[i])
            if h <= max_hamming and (best is None or h < best[1]):
                best = (i, h, r)
            if r + 1 < n_rot:
                c = self.rotate_code(c, 1)
        return best


def _build_rot_perm(bx: np.ndarray, by: np.ndarray,
                    wb: int) -> Optional[np.ndarray]:
    """Permutation P with rotated_bits = bits[P]: bit at (x,y) of the
    90°-rotated tag came from (y, wb-1-x) of the original."""
    idx = {(int(x), int(y)): i for i, (x, y) in enumerate(zip(bx, by))}
    perm = np.empty(len(bx), np.int64)
    for i, (x, y) in enumerate(zip(bx, by)):
        src = (int(y), wb - 1 - int(x))
        if src not in idx:
            return None
        perm[i] = idx[src]
    return perm


@lru_cache(maxsize=None)
def get_family(name: str) -> TagFamily:
    """Load a family by name (e.g. ``tag36h11``)."""
    path = os.path.join(_FAMILY_DIR, name + ".json")
    if not os.path.exists(path):
        raise ValueError(f"unknown tag family {name!r}; "
                         f"available: {FAMILY_NAMES}")
    with open(path, "r", encoding="utf-8") as f:
        d = json.load(f)
    bx = np.asarray(d["bit_x"], np.int64)
    by = np.asarray(d["bit_y"], np.int64)
    return TagFamily(
        name=name,
        width_at_border=d["width_at_border"],
        reversed_border=d["reversed_border"],
        total_width=d["total_width"],
        nbits=d["nbits"],
        bit_x=bx,
        bit_y=by,
        min_hamming=d["min_hamming"],
        codes=np.asarray([int(c, 16) for c in d["codes"]], np.uint64),
        rot_perm=_build_rot_perm(bx, by, d["width_at_border"]),
    )


def render_tag(family: TagFamily, tag_id: int, scale: int = 8) -> np.ndarray:
    """Render a tag as a u8 grayscale image, `scale` px per cell.

    Matches the reference fixture convention (quiet zone white, border
    black, set bit = white cell).
    """
    if not 0 <= tag_id < len(family.codes):
        raise ValueError(f"tag_id {tag_id} out of range")
    tw = family.total_width
    wb = family.width_at_border
    off = (tw - wb) // 2
    cells = np.full((tw, tw), 255, np.uint8)
    border_val, data_one = (255, 0) if family.reversed_border else (0, 255)
    # border ring (frame cells 0 and wb-1)
    b0, b1 = off, off + wb - 1
    cells[b0:b1 + 1, b0] = border_val
    cells[b0:b1 + 1, b1] = border_val
    cells[b0, b0:b1 + 1] = border_val
    cells[b1, b0:b1 + 1] = border_val
    # interior default = opposite of a set bit
    inner = slice(b0 + 1, b1)
    cells[inner, inner] = 255 - data_one
    code = int(family.codes[tag_id])
    for i in range(family.nbits):
        bit = (code >> (family.nbits - 1 - i)) & 1
        y = int(family.bit_y[i]) + off
        x = int(family.bit_x[i]) + off
        if not (0 <= y < tw and 0 <= x < tw):
            raise ValueError(f"bit {i} of {family.name} outside canvas")
        cells[y, x] = data_one if bit else 255 - data_one
    return np.kron(cells, np.ones((scale, scale), np.uint8))
