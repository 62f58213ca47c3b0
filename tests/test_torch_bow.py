"""The port's bag-of-words package (kornia_tpu_torch/bow: vocabulary,
scores, database, kornia-rs binary I/O) against the JAX package's, on the
CPU. Everything here is integer or host Python over the same values, so
every comparison is exact: the vocabulary built from the same
descriptors and seed, word ids, weights, BoW vectors, scores, query
rankings, direct-index matches and the bytes of the binary files."""

import numpy as np
import pytest
import torch

from kornia_tpu import bow as jbow
from kornia_tpu.bow import binary_io as jbio

from kornia_tpu_torch import bow as tbow
from kornia_tpu_torch import convert
from kornia_tpu_torch.bow import binary_io as tbio

# One intra-op thread: these tests run many small ops, and torch's pool
# of a thread per core spins against the other test processes.
torch.set_num_threads(1)

_ARRAYS = ("children", "node_desc", "word_id", "word_weight")


def _flip(desc, rng, p):
    """Each bit of each descriptor flipped with probability p."""
    bits = np.unpackbits(desc, axis=1)
    return np.packbits(bits ^ (rng.random(bits.shape) < p), axis=1)


@pytest.fixture(scope="module")
def train_desc():
    """tests/test_bow.py's clustered descriptors: 8 bases × 60 copies with
    4% of the bits flipped."""
    rng = np.random.default_rng(3)
    bases = rng.integers(0, 256, (8, 32), np.uint8)
    return np.concatenate([_flip(np.tile(b, (60, 1)), rng, 0.04)
                           for b in bases])


@pytest.fixture(scope="module")
def vocabs(train_desc):
    """The same k = 4, depth = 3 vocabulary built by each package."""
    return (jbow.Vocabulary.build(train_desc, k=4, depth=3, seed=0),
            tbow.Vocabulary.build(train_desc, k=4, depth=3, seed=0,
                                  device="cpu"))


def _query(seed=5, n=200):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, 32), np.uint8)


@pytest.mark.parametrize("k, depth, seed", [(4, 3, 0), (6, 3, 3), (4, 2, 1),
                                            (10, 2, 2)])
def test_build_equal_array_for_array(train_desc, k, depth, seed):
    """The k-medians tree (numpy, the same Generator draws; the popcount
    by table here, np.bitwise_count there) and the idf weights (the
    transform on the device) equal the reference's, dtype included."""
    ref = jbow.Vocabulary.build(train_desc, k=k, depth=depth, seed=seed)
    got = tbow.Vocabulary.build(train_desc, k=k, depth=depth, seed=seed,
                                device="cpu")
    assert (got.k, got.depth, got.n_words) == (ref.k, ref.depth, ref.n_words)
    for name in _ARRAYS:
        r, g = getattr(ref, name), getattr(got, name)
        assert g.dtype == r.dtype, name
        np.testing.assert_array_equal(g, r, err_msg=name)


def test_unbalanced_tree_build_equal():
    """3 bases under k = 4: under-full nodes and early leaves."""
    rng = np.random.default_rng(1)
    desc = np.repeat(rng.integers(0, 256, (3, 32), np.uint8), 30, axis=0)
    ref = jbow.Vocabulary.build(desc, k=4, depth=2, seed=1)
    got = tbow.Vocabulary.build(desc, k=4, depth=2, seed=1, device="cpu")
    for name in _ARRAYS:
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
    q = _query(9, 64)
    np.testing.assert_array_equal(got.transform_words(q)[0],
                                  ref.transform_words(q)[0])


def test_popcount_table_equals_bitwise_count():
    x = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(tbow.vocabulary._popcount_u8(x),
                                  np.bitwise_count(x))


def test_convert_vocabulary_and_transforms(vocabs, train_desc):
    """convert.vocabulary carries the reference's arrays across; word ids
    and weights of transform_words, the BoW vector of transform and the
    direct index of transform_with_direct_index are equal."""
    ref, _ = vocabs
    got = convert.vocabulary({name: getattr(ref, name) for name in
                              ("k", "depth") + _ARRAYS}, device="cpu")
    q = np.concatenate([_query(), train_desc[::7]])
    w_r, wt_r = ref.transform_words(q)
    w_g, wt_g = got.transform_words(q)
    assert w_g.dtype == w_r.dtype and wt_g.dtype == wt_r.dtype
    np.testing.assert_array_equal(w_g, w_r)
    np.testing.assert_array_equal(wt_g, wt_r)
    assert got.transform(q) == ref.transform(q)
    assert got.transform(q, normalize=False) == ref.transform(
        q, normalize=False)
    vec_r, dir_r = ref.transform_with_direct_index(q)
    vec_g, dir_g = got.transform_with_direct_index(q)
    assert vec_g == vec_r and dir_g.keys() == dir_r.keys()
    for w in dir_r:
        np.testing.assert_array_equal(dir_g[w], dir_r[w])
    empty = np.empty((0, 32), np.uint8)
    assert got.transform_words(empty)[0].size == 0
    assert got.transform(empty) == {}
    with pytest.raises(ValueError):
        convert.vocabulary({"k": 4}, device="cpu")


def test_device_tree_follows_the_arrays(vocabs):
    """The device copy of the tree is made once and made again when an
    array is replaced."""
    _, got = vocabs
    tree = got._device_tree()
    assert got._device_tree() is tree
    v = tbow.Vocabulary(got.k, got.depth, got.children.copy(),
                        got.node_desc, got.word_id, got.word_weight,
                        device="cpu")
    first = v._device_tree()
    v.children = v.children.copy()
    assert v._device_tree() is not first


@pytest.mark.parametrize("name", sorted(jbow.SCORES))
def test_scores_equal(name, vocabs, train_desc):
    """Every score on the same BoW vectors equals the reference's (the
    port's scoring is a copy; the vectors come from each package)."""
    ref, got = vocabs
    rng = np.random.default_rng(11)
    a, b = train_desc[:60], _flip(train_desc[:60], rng, 0.03)
    c = train_desc[120:180]
    for x, y in ((a, b), (a, c), (b, c)):
        assert tbow.SCORES[name](got.transform(x), got.transform(y)) == \
            jbow.SCORES[name](ref.transform(x), ref.transform(y))


def test_database_query_and_direct_index(vocabs, train_desc):
    """Ranking, scores (top_k, exclude, every score) and direct-index
    matches equal the reference's database on the same entries."""
    ref, got = vocabs
    rng = np.random.default_rng(12)
    images = [train_desc[i * 60:(i + 1) * 60] for i in range(8)]
    dbs = (jbow.BowDatabase(ref), tbow.BowDatabase(got))
    for db in dbs:
        for im in images:
            db.add(im)
    noisy = _flip(images[3], rng, 0.02)
    for score in sorted(jbow.SCORES):
        for kwargs in ({"top_k": 3}, {"top_k": 8, "exclude": (3,)}):
            r = dbs[0].query(noisy, score=score, **kwargs)
            g = dbs[1].query(noisy, score=score, **kwargs)
            assert [(q.entry_id, q.score) for q in g] == \
                [(q.entry_id, q.score) for q in r]
    assert dbs[1].query(noisy, top_k=3)[0].entry_id == 3
    perm = rng.permutation(60)
    for db in dbs:
        db.add(images[0][perm])
    r = dbs[0].match_via_direct_index(0, 8, images[0], images[0][perm])
    g = dbs[1].match_via_direct_index(0, 8, images[0], images[0][perm])
    assert g.dtype == r.dtype
    np.testing.assert_array_equal(g, r)
    assert len(g) >= 40
    nodirect = tbow.BowDatabase(got, use_direct_index=False)
    nodirect.add(images[0])
    with pytest.raises(ValueError):
        nodirect.match_via_direct_index(0, 0, images[0], images[0])


def test_binary_io_bytes_and_cross_reading(vocabs, train_desc, tmp_path):
    """encode_vocabulary gives the reference's bytes; each package reads
    the other's files (binary and npz) to the same tree, and words."""
    ref, got = vocabs
    assert tbio.encode_vocabulary(got) == jbio.encode_vocabulary(ref)
    p_ref, p_got = str(tmp_path / "ref.bin"), str(tmp_path / "got.bin")
    ref.save_bin(p_ref)
    got.save_bin(p_got)
    a = tbow.Vocabulary.load_bin(p_ref, device="cpu")
    b = jbow.Vocabulary.load_bin(p_got)
    c = jbow.Vocabulary.load_bin(p_ref)
    for name in _ARRAYS:
        np.testing.assert_array_equal(getattr(a, name), getattr(c, name))
        np.testing.assert_array_equal(getattr(b, name), getattr(c, name))
    assert tbio.decode_vocabulary(open(p_ref, "rb").read(),
                                  device="cpu").n_words == c.n_words
    q = np.concatenate([_query(), train_desc[::5]])
    np.testing.assert_array_equal(a.transform_words(q)[0],
                                  c.transform_words(q)[0])
    n_ref, n_got = str(tmp_path / "ref.npz"), str(tmp_path / "got.npz")
    ref.save(n_ref)
    got.save(n_got)
    x = tbow.Vocabulary.load(n_ref, device="cpu")
    y = jbow.Vocabulary.load(n_got)
    for name in _ARRAYS:
        np.testing.assert_array_equal(getattr(x, name), getattr(ref, name))
        np.testing.assert_array_equal(getattr(y, name), getattr(ref, name))
    assert (x.k, x.depth, y.k, y.depth) == (ref.k, ref.depth) * 2
    with open(str(tmp_path / "l2.bin"), "wb") as f:
        f.write(bytes([2, 1, 0, 0]))
    with pytest.raises(ValueError, match="Hamming"):
        tbow.Vocabulary.load_bin(str(tmp_path / "l2.bin"), device="cpu")


def test_orbvoc_txt_equal(tmp_path):
    """The DBoW2 text import gives the reference's arrays and words."""
    rng = np.random.default_rng(4)
    lines = ["3 2 0 0"]
    descs = rng.integers(0, 256, (12, 32))
    for i in range(3):                      # three inner nodes under root
        lines.append("0 0 " + " ".join(map(str, descs[i])) + " 0.0")
    for i in range(3, 12):                  # three leaves under each
        lines.append(f"{(i - 3) // 3 + 1} 1 "
                     + " ".join(map(str, descs[i])) + f" {0.1 * i:.2f}")
    path = tmp_path / "ORBvoc.txt"
    path.write_text("\n".join(lines) + "\n")
    ref = jbow.Vocabulary.from_orbvoc_txt(str(path))
    got = tbow.Vocabulary.from_orbvoc_txt(str(path), device="cpu")
    for name in _ARRAYS:
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
    q = np.concatenate([descs.astype(np.uint8), _query(6, 40)])
    for a, b in zip(got.transform_words(q), ref.transform_words(q)):
        np.testing.assert_array_equal(a, b)


def test_cuda_default_without_card_raises(vocabs):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA transform runs")
    _, got = vocabs
    v = tbow.Vocabulary(got.k, got.depth, got.children, got.node_desc,
                        got.word_id, got.word_weight)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        v.transform_words(_query(7, 4))
