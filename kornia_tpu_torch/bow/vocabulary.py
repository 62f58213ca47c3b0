"""Hierarchical binary vocabulary tree (bag-of-words) for place
recognition (port of kornia_tpu/bow/vocabulary.py).

k-medians tree construction over 256-bit ORB descriptors on the host
(numpy, the same ``np.random.Generator`` draws as the reference, so the
same descriptors and seed give the same tree array for array), the BoW
transform with tf-idf weights, save/load in the native npz form and in
kornia-rs's bincode form (``save_bin``/``load_bin`` via
:mod:`kornia_tpu_torch.bow.binary_io`), and ORB-SLAM's ORBvoc.txt import.

The tree is flat arrays, and the transform's descent runs on the
vocabulary's ``device``: all descriptors go down one level a step, each a
(N_desc, k) Hamming distance (XOR, a 256-entry popcount table) and an
argmin.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np
import torch

from kornia_tpu_torch import resolve_device

# set bits of every byte value: the popcount of u8 arrays on the host and
# on the device (np.bitwise_count needs numpy 2)
_POP8 = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def _popcount_u8(x: np.ndarray) -> np.ndarray:
    return _POP8[x]


def _kmedians_binary(desc: np.ndarray, k: int, rng: np.random.Generator,
                     iters: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Binary k-medians: centers = per-bit majority vote of members."""
    n = desc.shape[0]
    k = min(k, n)
    centers = desc[rng.choice(n, k, replace=False)].copy()
    assign = np.zeros(n, np.int64)
    bits = np.unpackbits(desc, axis=1)  # (n, 256)
    for _ in range(iters):
        d = _popcount_u8(desc[:, None, :] ^ centers[None, :, :]).sum(-1)
        new_assign = d.argmin(1)
        if np.array_equal(new_assign, assign):
            break
        assign = new_assign
        for c in range(k):
            members = bits[assign == c]
            if len(members):
                centers[c] = np.packbits(
                    members.mean(0) >= 0.5).astype(np.uint8)
    return centers, assign


@dataclass
class Vocabulary:
    """Flat-array vocabulary tree.

    Arrays (N = total nodes, W = words/leaves):
      children  (N, k) int32, -1 padded;  node_desc (N, 32) u8
      word_id   (N,) int32 (-1 for inner nodes);  word_weight (W,) f32
    ``device``: where the transform's descent runs.
    """

    k: int
    depth: int
    children: np.ndarray
    node_desc: np.ndarray
    word_id: np.ndarray
    word_weight: np.ndarray
    device: object = "cuda"
    # the tree's arrays on the device and the host arrays they came from
    _tree: tuple = field(default=(), init=False, repr=False, compare=False)

    @property
    def n_words(self) -> int:
        return len(self.word_weight)

    # ------------------------------------------------------------- build
    @classmethod
    def build(cls, descriptors: np.ndarray, k: int = 10, depth: int = 4,
              seed: int = 0, weighting: str = "idf",
              device="cuda") -> "Vocabulary":
        """Construct by recursive binary k-medians on the host
        (descriptors: (N, 32) u8); the idf weights come from the
        transform of the training set on ``device``."""
        descriptors = np.asarray(descriptors, np.uint8)
        rng = np.random.default_rng(seed)

        width = descriptors.shape[1]
        children: list = [np.full(k, -1, np.int32)]  # root = node 0
        node_desc: list = [np.zeros(width, np.uint8)]
        word_of_node: Dict[int, int] = {}

        def split(node: int, desc: np.ndarray, level: int):
            if len(desc) == 0:
                return
            if level == depth or len(desc) < k:
                word_of_node[node] = -2  # mark leaf; ids assigned later
                return
            centers, assign = _kmedians_binary(desc, k, rng)
            ch = np.full(k, -1, np.int32)
            for c in range(len(centers)):
                members = desc[assign == c]
                if len(members) == 0:
                    continue
                idx = len(children)
                children.append(np.full(k, -1, np.int32))
                node_desc.append(centers[c])
                ch[c] = idx
                split(idx, members, level + 1)
            children[node] = ch
            if np.all(ch == -1):
                word_of_node[node] = -2

        split(0, descriptors, 0)

        n = len(children)
        word_id = np.full(n, -1, np.int32)
        for w, nd in enumerate(sorted(word_of_node)):
            word_id[nd] = w
        vocab = cls(
            k=k, depth=depth,
            children=np.stack(children),
            node_desc=np.stack(node_desc),
            word_id=word_id,
            word_weight=np.ones(len(word_of_node), np.float32),
            device=device,
        )
        if weighting == "idf":
            # idf from the training set itself
            words, _ = vocab.transform_words(descriptors)
            counts = np.bincount(words, minlength=vocab.n_words)
            n_docs = max(1, len(descriptors))
            vocab.word_weight = np.log(
                n_docs / np.maximum(counts, 1)).astype(np.float32)
            vocab.word_weight = np.maximum(vocab.word_weight, 1e-3)
        return vocab

    # ---------------------------------------------------------- transform
    def _device_tree(self):
        """children, node_desc and word_id on the device, uploaded once
        for the arrays the vocabulary holds."""
        host = (self.children, self.node_desc, self.word_id)
        if len(self._tree) != 2 or any(
                a is not b for a, b in zip(self._tree[0], host)):
            dev = resolve_device(self.device)
            self._tree = (host, tuple(
                torch.as_tensor(np.asarray(a), device=dev) for a in host))
        return self._tree[1]

    def transform_words(self, descriptors: np.ndarray) -> Tuple[np.ndarray,
                                                                np.ndarray]:
        """(N, 32) u8 → (word ids (N,), weights (N,)). Batched descent."""
        descriptors = np.asarray(descriptors, np.uint8)
        if descriptors.size == 0:
            return (np.empty(0, np.int64), np.empty(0, np.float32))
        children, node_desc, word_id = self._device_tree()
        words = _descend(children, node_desc, word_id,
                         torch.as_tensor(descriptors,
                                         device=children.device),
                         self.depth).cpu().numpy()
        # unreached leaves (padded children) resolve to node 0 → word -1;
        # clamp into the valid range
        words = np.where(words >= 0, words, 0)
        return words, self.word_weight[words]

    def transform(self, descriptors: np.ndarray,
                  normalize: bool = True) -> Dict[int, float]:
        """BoW vector: sparse {word: weight} with tf·idf accumulation."""
        words, weights = self.transform_words(descriptors)
        vec: Dict[int, float] = {}
        for w, wt in zip(words.tolist(), weights.tolist()):
            vec[w] = vec.get(w, 0.0) + wt
        if normalize and vec:
            s = sum(abs(v) for v in vec.values())
            if s > 0:
                vec = {k_: v / s for k_, v in vec.items()}
        return vec

    def transform_with_direct_index(
        self, descriptors: np.ndarray, normalize: bool = True
    ) -> Tuple[Dict[int, float], Dict[int, np.ndarray]]:
        """BoW vector + DirectIndex {word: feature indices}."""
        words, weights = self.transform_words(descriptors)
        vec: Dict[int, float] = {}
        direct: Dict[int, list] = {}
        for i, (w, wt) in enumerate(zip(words.tolist(), weights.tolist())):
            vec[w] = vec.get(w, 0.0) + wt
            direct.setdefault(w, []).append(i)
        if normalize and vec:
            s = sum(abs(v) for v in vec.values())
            if s > 0:
                vec = {k_: v / s for k_, v in vec.items()}
        return vec, {w: np.asarray(v, np.int64) for w, v in direct.items()}

    # ----------------------------------------------------------- save/load
    def save(self, path: str) -> None:
        np.savez_compressed(
            path, k=self.k, depth=self.depth, children=self.children,
            node_desc=self.node_desc, word_id=self.word_id,
            word_weight=self.word_weight)

    @classmethod
    def load(cls, path: str, device="cuda") -> "Vocabulary":
        z = np.load(path)
        return cls(k=int(z["k"]), depth=int(z["depth"]),
                   children=z["children"], node_desc=z["node_desc"],
                   word_id=z["word_id"], word_weight=z["word_weight"],
                   device=device)

    def save_bin(self, path: str) -> None:
        """Save in kornia-rs's binary format: the output loads in
        kornia-rs ``Vocabulary::<k, Hamming<W>>::load`` (W = descriptor
        bytes / 8) and in the JAX package's ``load_bin``.
        """
        from kornia_tpu_torch.bow.binary_io import encode_vocabulary

        with open(path, "wb") as f:
            f.write(encode_vocabulary(self))

    @classmethod
    def load_bin(cls, path: str, desc_words: int = 4,
                 device="cuda") -> "Vocabulary":
        """Load a kornia-rs ``Vocabulary::save`` binary.

        ``desc_words`` = kornia-rs's ``Hamming<D>`` type parameter
        (descriptor width in u64 words; 4 for 256-bit ORB) — it is a
        compile-time type on the Rust side and not stored in the file.
        """
        from kornia_tpu_torch.bow.binary_io import decode_vocabulary

        with open(path, "rb") as f:
            return decode_vocabulary(f.read(), desc_words=desc_words,
                                     device=device)

    # ------------------------------------------------------- orbvoc import
    @classmethod
    def from_orbvoc_txt(cls, path: str, device="cuda") -> "Vocabulary":
        """Import an ORB-SLAM ORBvoc.txt vocabulary.

        Format (public DBoW2 text serialization): first line
        ``k L scoring weighting``; then one line per node:
        ``parent_id is_leaf d0 … d31 weight`` in depth-first parent order.
        """
        with open(path, "r", encoding="utf-8") as f:
            header = f.readline().split()
            k, depth = int(header[0]), int(header[1])
            rows = [line.split() for line in f if line.strip()]

        n = len(rows) + 1
        children_lists: Dict[int, list] = {}
        node_desc = np.zeros((n, 32), np.uint8)
        is_leaf = np.zeros(n, bool)
        leaf_weight = np.zeros(n, np.float32)
        for i, tokens in enumerate(rows, start=1):
            parent = int(tokens[0]) + 0  # DBoW2 text ids: 0 = root
            is_leaf[i] = tokens[1] == "1"
            node_desc[i] = np.asarray([int(t) for t in tokens[2:34]],
                                      np.uint8)
            leaf_weight[i] = float(tokens[34])
            children_lists.setdefault(parent, []).append(i)

        children = np.full((n, k), -1, np.int32)
        for p, ch in children_lists.items():
            children[p, : len(ch)] = ch[:k]
        word_id = np.full(n, -1, np.int32)
        leaves = np.nonzero(is_leaf)[0]
        word_id[leaves] = np.arange(len(leaves), dtype=np.int32)
        return cls(k=k, depth=depth, children=children,
                   node_desc=node_desc, word_id=word_id,
                   word_weight=leaf_weight[leaves].astype(np.float32),
                   device=device)


def _descend(children: torch.Tensor, node_desc: torch.Tensor,
             word_id: torch.Tensor, desc: torch.Tensor,
             depth: int) -> torch.Tensor:
    """All descriptors walk the tree one level per step.

    Each step: gather the k child descriptors of every descriptor's
    current node, Hamming distance to the query (XOR and a per-byte
    popcount table), first argmin. Invalid (-1) children get distance
    2³⁰. A node with no children (an early leaf) holds its position."""
    pop = torch.as_tensor(_POP8, device=desc.device).to(torch.int32)
    cur = torch.zeros(desc.shape[0], dtype=torch.int64, device=desc.device)
    for _ in range(depth + 1):
        ch = children.index_select(0, cur)                     # (n, k)
        valid = ch >= 0
        cd = node_desc[torch.clamp(ch, min=0).long()]          # (n, k, 32)
        x = torch.bitwise_xor(cd, desc[:, None, :])
        dist = pop[x.long()].sum(-1)
        dist = torch.where(valid, dist, torch.full_like(dist, 2 ** 30))
        best = torch.argmin(dist, dim=1)
        nxt = torch.gather(ch, 1, best[:, None])[:, 0].long()
        cur = torch.where(valid.any(dim=1), nxt, cur)
    return word_id.index_select(0, cur)
