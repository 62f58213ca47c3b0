"""Binary vocabulary interop with kornia-rs's kornia-bow format (port of
kornia_tpu/bow/binary_io.py, the same bytes both ways).

The reference persists vocabularies with ``Vocabulary::save`` /
``Vocabulary::load`` (crates/kornia-bow/src/io.rs:11-67) as a bincode-2
*standard-config* stream:

    u64 varint   B                  (branching factor)
    u32 varint   MetricType         (0 = Hamming, 1 = L2)
    Vocabulary:
        Vec<BlockCluster>           (u64 varint length, then blocks)
        u32 varint root_idx
    BlockCluster (lib.rs:40-68):
        [Feature<u64, W>; B]        (B x W u64 varints, no length prefix)
        BlockContent                (u32 varint discriminant:
                                     0 = Internal { children_base_idx: u32 }
                                     1 = Leaf { weights: [f32; B] })

bincode standard config = little-endian, variable-length integer
encoding (values < 251 are one byte; 0xFB + u16, 0xFC + u32, 0xFD + u64
escapes), floats fixed-width LE. ``W`` (descriptor width in u64 words)
is a compile-time type parameter on the reference side and is NOT stored
in the stream — pass ``desc_words`` when loading (4 for 256-bit ORB).

This module converts between that cache-blocked layout and the flat
tree in :class:`~kornia_tpu_torch.bow.vocabulary.Vocabulary`, so
vocabularies trained and saved by kornia-rs load here directly (and
vice versa). The block semantics mirrored from the reference
(orb_slam3.rs:151-242 ``build_vocabulary``):

* one block per internal node, holding the descriptors of its up-to-B
  children; an internal block's child *i* owns block
  ``children_base_idx + i``;
* a node whose children are all leaves collapses into one Leaf block;
* a leaf child of an otherwise-internal node becomes a single-entry
  leaf block;
* under-full blocks pad descriptor slots with a copy of slot 0 (strict
  argmin traversal then never selects the pad), and reserved-but-unused
  child block indices hold a self-terminating all-padding leaf block.
"""

from __future__ import annotations

import struct
from collections import deque
from typing import List, Optional, Tuple

import numpy as np

METRIC_HAMMING = 0
METRIC_L2 = 1

_TERMINATOR = object()  # sentinel for reserved-but-unused child blocks


# --------------------------------------------------------------- varints
def _write_uvarint(out: bytearray, v: int) -> None:
    if v < 251:
        out.append(v)
    elif v <= 0xFFFF:
        out.append(0xFB)
        out += struct.pack("<H", v)
    elif v <= 0xFFFFFFFF:
        out.append(0xFC)
        out += struct.pack("<I", v)
    else:
        out.append(0xFD)
        out += struct.pack("<Q", v)


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("corrupted vocabulary: truncated stream")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def uvarint(self) -> int:
        tag = self._take(1)[0]
        if tag < 251:
            return tag
        if tag == 0xFB:
            return struct.unpack("<H", self._take(2))[0]
        if tag == 0xFC:
            return struct.unpack("<I", self._take(4))[0]
        if tag == 0xFD:
            return struct.unpack("<Q", self._take(8))[0]
        raise ValueError("corrupted vocabulary: bad varint tag %d" % tag)

    def f32s(self, n: int) -> np.ndarray:
        return np.frombuffer(self._take(4 * n), dtype="<f4").copy()

    def done(self) -> bool:
        return self.pos == len(self.data)


# ------------------------------------------------------- block structures
class _Block:
    """One BlockCluster: B descriptors + Internal/Leaf content."""

    __slots__ = ("desc", "children_base", "weights")

    def __init__(self, desc: np.ndarray,
                 children_base: Optional[int] = None,
                 weights: Optional[np.ndarray] = None):
        self.desc = desc                    # (B, 8*W) u8
        self.children_base = children_base  # int for Internal, else None
        self.weights = weights              # (B,) f32 for Leaf, else None

    @property
    def is_leaf(self) -> bool:
        return self.weights is not None


def _pad_desc(width_bytes: int) -> np.ndarray:
    """The padding descriptor: Hamming::padding() = all-ones u64s."""
    return np.full(width_bytes, 0xFF, np.uint8)


def _is_terminator(block: _Block, width_bytes: int) -> bool:
    return (block.is_leaf
            and not block.weights.any()
            and bool((block.desc == 0xFF).all()))


def _encode_block(out: bytearray, block: _Block, words: int) -> None:
    u64s = block.desc.reshape(-1, 8).copy().view("<u8").reshape(-1)
    for v in u64s.tolist():
        _write_uvarint(out, v)
    if block.is_leaf:
        _write_uvarint(out, 1)
        out += np.asarray(block.weights, "<f4").tobytes()
    else:
        _write_uvarint(out, 0)
        _write_uvarint(out, block.children_base)


def _decode_block(r: _Reader, b: int, words: int) -> _Block:
    vals = np.asarray([r.uvarint() for _ in range(b * words)],
                      dtype=np.uint64)
    desc = vals.astype("<u8").view(np.uint8).reshape(b, 8 * words)
    disc = r.uvarint()
    if disc == 0:
        return _Block(desc, children_base=r.uvarint())
    if disc == 1:
        return _Block(desc, weights=r.f32s(b))
    raise ValueError("corrupted vocabulary: BlockContent discriminant %d"
                     % disc)


# ---------------------------------------------------------------- decode
def decode_vocabulary(data: bytes, desc_words: int = 4, device="cuda"):
    """Parse a kornia-rs ``Vocabulary::save`` stream into the flat tree.

    ``desc_words`` is the Hamming descriptor width in u64 words (the
    ``D`` of the reference's ``Hamming<D>`` type, 4 for ORB); it is not
    recorded in the stream. ``device`` is where the vocabulary's
    transforms run.
    """
    from kornia_tpu_torch.bow.vocabulary import Vocabulary

    r = _Reader(data)
    b = r.uvarint()
    metric = r.uvarint()
    if metric != METRIC_HAMMING:
        raise ValueError(
            "only Hamming vocabularies are supported (MetricType %d); the "
            "TPU tree stores binary descriptors" % metric)
    n_blocks = r.uvarint()
    blocks = [_decode_block(r, b, desc_words) for _ in range(n_blocks)]
    root_idx = r.uvarint()
    if not r.done():
        raise ValueError("corrupted vocabulary: %d trailing bytes"
                         % (len(r.data) - r.pos))
    if root_idx >= len(blocks):
        raise ValueError("corrupted vocabulary: root_idx out of range")
    for blk in blocks:
        if not blk.is_leaf and blk.children_base + b > len(blocks):
            raise ValueError(
                "corrupted vocabulary: children_base_idx out of range")

    width_bytes = 8 * desc_words

    # BFS blocks -> flat (children, node_desc) tree. Node 0 is the
    # implicit root; each block contributes its non-padded slots as the
    # children of the node that owns it.
    children_lists: List[List[int]] = [[]]
    node_desc: List[np.ndarray] = [np.zeros(width_bytes, np.uint8)]
    node_weight: List[float] = [0.0]
    node_is_leaf: List[bool] = [False]
    node_level: List[int] = [0]

    def _real_slots(block: _Block) -> int:
        """Padding is a suffix of slots duplicating slot 0 (leaf pads
        also carry weight 0; internal pads point at terminator blocks).
        Walk back from the end; a full block returns B unchanged."""
        n = b
        while n > 1:
            i = n - 1
            if not np.array_equal(block.desc[i], block.desc[0]):
                break
            if block.is_leaf:
                if block.weights[i] != 0.0:
                    break
            else:
                child = blocks[block.children_base + i]
                if not _is_terminator(child, width_bytes):
                    break
            n -= 1
        return n

    queue = deque([(root_idx, 0)])  # (block idx, owner node)
    seen = {root_idx}
    while queue:
        bi, owner = queue.popleft()
        block = blocks[bi]
        for i in range(_real_slots(block)):
            nid = len(children_lists)
            children_lists.append([])
            node_desc.append(block.desc[i])
            node_level.append(node_level[owner] + 1)
            children_lists[owner].append(nid)
            if block.is_leaf:
                node_is_leaf.append(True)
                node_weight.append(float(block.weights[i]))
            else:
                node_is_leaf.append(False)
                node_weight.append(0.0)
                ci = block.children_base + i
                if ci in seen:
                    raise ValueError(
                        "corrupted vocabulary: block %d referenced twice"
                        % ci)
                seen.add(ci)
                queue.append((ci, nid))

    n = len(children_lists)
    children = np.full((n, b), -1, np.int32)
    for nid, ch in enumerate(children_lists):
        children[nid, :len(ch)] = ch
    word_id = np.full(n, -1, np.int32)
    leaves = [i for i in range(n) if node_is_leaf[i]]
    for w, nd in enumerate(leaves):
        word_id[nd] = w
    return Vocabulary(
        k=b, depth=max(node_level),
        children=children,
        node_desc=np.stack(node_desc),
        word_id=word_id,
        word_weight=np.asarray([node_weight[nd] for nd in leaves],
                               np.float32),
        device=device)


# ---------------------------------------------------------------- encode
def encode_vocabulary(vocab) -> bytes:
    """Serialize the flat tree into the reference's bincode stream.

    Mirrors orb_slam3.rs:151 ``build_vocabulary``: BFS block layout,
    leaf-layer collapse, single-entry leaf blocks for leaves at internal
    layers, slot-0 descriptor padding, terminator fill blocks. The
    output loads bit-for-bit in kornia-rs ``Vocabulary::<B,
    Hamming<W>>::load``.
    """
    b = int(vocab.k)
    width_bytes = int(vocab.node_desc.shape[1])
    if width_bytes % 8:
        raise ValueError("descriptor width must be a multiple of 8 bytes")
    words = width_bytes // 8
    children = np.asarray(vocab.children)
    node_desc = np.asarray(vocab.node_desc, np.uint8)
    word_id = np.asarray(vocab.word_id)
    word_weight = np.asarray(vocab.word_weight, np.float32)

    def kids(nid: int) -> List[int]:
        return [int(c) for c in children[nid] if c >= 0]

    def is_leaf(nid: int) -> bool:
        return word_id[nid] >= 0

    pad = _pad_desc(width_bytes)
    terminator = _Block(np.tile(pad, (b, 1)), weights=np.zeros(b, "<f4"))

    blocks: List[object] = [_TERMINATOR]
    queue = deque([(kids(0), 0)])
    next_free = 1
    while queue:
        child_ids, block_idx = queue.popleft()
        nc = len(child_ids)
        if nc == 0 or nc > b:
            raise ValueError("node with %d children cannot be blocked" % nc)
        desc = np.tile(node_desc[child_ids[0]], (b, 1))
        for i, cid in enumerate(child_ids):
            desc[i] = node_desc[cid]
        if all(is_leaf(c) for c in child_ids):
            weights = np.zeros(b, "<f4")
            for i, cid in enumerate(child_ids):
                weights[i] = word_weight[word_id[cid]]
            block = _Block(desc, weights=weights)
        else:
            base = next_free
            block = _Block(desc, children_base=base)
            next_free += b
            while len(blocks) < next_free:
                blocks.append(_TERMINATOR)
            for i, cid in enumerate(child_ids):
                sub = [cid] if is_leaf(cid) else kids(cid)
                queue.append((sub, base + i))
        while len(blocks) <= block_idx:
            blocks.append(_TERMINATOR)
        blocks[block_idx] = block

    out = bytearray()
    _write_uvarint(out, b)
    _write_uvarint(out, METRIC_HAMMING)
    _write_uvarint(out, len(blocks))
    for blk in blocks:
        _encode_block(out, terminator if blk is _TERMINATOR else blk, words)
    _write_uvarint(out, 0)  # root_idx
    return bytes(out)
