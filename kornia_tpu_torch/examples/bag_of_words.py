"""Bag-of-words place recognition over ORB descriptors, ORB and the
vocabulary descent on the card (port of examples/bag_of_words.py;
examples/bag-of-words and convert/load_orbvoc).

    python -m kornia_tpu_torch.examples.bag_of_words
        (--images a.png ... | --image PATH) [--vocab-k 8] [--vocab-depth 3] [--save-vocab PATH]
        [--cpu]

Without --images the places are the four quadrants of --image resized to
512×512.
"""

from __future__ import annotations

import numpy as np

from kornia_tpu_torch import bow
from kornia_tpu_torch import io as kio
from kornia_tpu_torch.examples._common import (DOG_JPEG, base_parser,
                                               configure_backend, require_file)
from kornia_tpu_torch.features import orb
from kornia_tpu_torch.ops import color

ORB_CONFIG = orb.OrbConfig(n_features=256, n_levels=3)


def quadrant_places(path: str, device):
    """The four 256×256 quadrants of the image's gray resized (cv2) to
    512×512."""
    import cv2

    img = kio.read_image_any_rgb8(path)
    gray = color.rgb_to_gray(img, device=device)[..., 0].cpu().numpy()
    big = cv2.resize(gray, (512, 512))
    return [big[:256, :256], big[:256, 256:], big[256:, :256],
            big[256:, 256:]]


def describe(frames, device):
    """Each place's valid ORB descriptors, packed to (n, 32) u8."""
    descs = []
    for f in frames:
        ft = orb.orb_detect_and_describe(np.ascontiguousarray(f), ORB_CONFIG,
                                         device=device)
        bits = ft.descriptors.cpu().numpy()[ft.mask.cpu().numpy()]
        descs.append(np.packbits(bits.astype(np.uint8), axis=1))
    return descs


def index_places(descs, k: int, depth: int, device):
    """(vocabulary, database): the vocabulary built from every place's
    descriptors (its descent on ``device``), each place added in order."""
    vocab = bow.Vocabulary.build(np.concatenate(descs), k=k, depth=depth,
                                 device=device)
    db = bow.BowDatabase(vocab)
    for d in descs:
        db.add(d)
    return vocab, db


def main(argv=None) -> dict:
    p = base_parser(__doc__)
    p.add_argument("--images", nargs="*", default=None)
    p.add_argument("--image", default=None,
                   help="the image whose quadrants are the places when "
                        "--images is not given")
    p.add_argument("--vocab-k", type=int, default=8)
    p.add_argument("--vocab-depth", type=int, default=3)
    p.add_argument("--save-vocab", default=None)
    args = p.parse_args(argv)
    if not args.images:
        require_file(p, args.image, "--image", DOG_JPEG)
    dev = configure_backend(args)

    if args.images:
        frames = [kio.read_image_any_gray8(f)[:, :, 0]
                  for f in args.images]
    else:
        frames = quadrant_places(args.image, dev)
    print(f"{len(frames)} places")

    descs = describe(frames, dev)
    vocab, db = index_places(descs, args.vocab_k, args.vocab_depth, dev)
    print(f"vocabulary: {vocab.n_words} words")
    if args.save_vocab:
        vocab.save(args.save_vocab)
        print(f"saved {args.save_vocab}")

    ranks = []
    for i, d in enumerate(descs):
        res = db.query(d, top_k=2)
        second = (f", runner-up {res[1].entry_id} ({res[1].score:.3f})"
                  if len(res) > 1 else "")
        print(f"query place {i}: best {res[0].entry_id} "
              f"({res[0].score:.3f}){second}")
        ranks.append([(r.entry_id, float(r.score)) for r in res])
    return {"n_words": vocab.n_words, "ranks": ranks,
            "orb_frames": len(frames)}


if __name__ == "__main__":
    main()
