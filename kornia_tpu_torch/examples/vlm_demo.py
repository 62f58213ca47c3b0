"""VLM inference demo on the card, random weights: an architecture
exercise (port of examples/vlm_demo.py; examples/smol_vlm* and
paligemma of kornia-vlm). Without network access no checkpoint can be
fetched; this runs the whole pipeline (image preprocess → vision tower →
connector → decode loop) end to end and shows where converted weights
plug in (models.load_params).

    python -m kornia_tpu_torch.examples.vlm_demo --image PATH
        [--max-new 16] [--arch smolvlm|paligemma] [--cpu]
"""

from __future__ import annotations

import time

from kornia_tpu_torch import io as kio
from kornia_tpu_torch import models as M
from kornia_tpu_torch.examples._common import (DOG_JPEG, base_parser,
                                               configure_backend, require_file,
                                               synchronize)


def config(arch: str):
    """The reference example's small configuration of ``arch``: a 2-layer
    ViT at 112 px and a 2-layer decoder of width 64, vocabulary 512."""
    vision = M.ViTConfig(image_size=112, patch_size=14, hidden_size=64,
                         intermediate_size=128, num_layers=2, num_heads=4)
    if arch == "paligemma":
        return M.PaliGemmaConfig(
            vision=vision,
            text=M.GemmaConfig(vocab_size=512, hidden_size=64,
                               intermediate_size=128, num_layers=2,
                               num_heads=4, num_kv_heads=1, head_dim=16,
                               max_seq_len=128),
            image_token_id=500)
    return M.VLMConfig(
        vision=vision,
        text=M.LLMConfig(vocab_size=512, hidden_size=64,
                         intermediate_size=128, num_layers=2, num_heads=4,
                         num_kv_heads=2, max_seq_len=128),
        pixel_shuffle_factor=2, image_token_id=500)


def build(arch: str, device):
    """(config, model with random weights from seed 0 on ``device``)."""
    cfg = config(arch)
    build_fn = M.build_paligemma if arch == "paligemma" else M.build_vlm
    return cfg, build_fn(cfg, seed=0, device=device)


def answer(model, cfg, img, max_new: int, device):
    """Preprocess ``img``, prompt ``<bos> <image>*N 10 11 12`` and decode
    greedily: (the streamed tokens, GenerationResult)."""
    pixels = M.preprocess_image(img, cfg.vision.image_size, device=device)
    tokens = M.build_prompt_tokens(
        [10, 11, 12], cfg.tokens_per_image, cfg.image_token_id)[None]
    toks = []
    res = M.generate(model, tokens, pixels, max_new_tokens=max_new,
                     stream_callback=toks.append, device=device)
    return toks, res


def main(argv=None) -> dict:
    p = base_parser(__doc__)
    p.add_argument("--image", default=None)
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--arch", default="smolvlm",
                   choices=("smolvlm", "paligemma"),
                   help="model family (reference: examples/smol_vlm* "
                        "vs examples/paligemma)")
    args = p.parse_args(argv)
    require_file(p, args.image, "--image", DOG_JPEG)
    dev = configure_backend(args)

    cfg, model = build(args.arch, dev)
    print(f"{args.arch}: {cfg.vision.num_layers}-layer ViT + "
          f"{cfg.text.num_layers}-layer decoder, "
          f"{cfg.tokens_per_image} tokens/image")

    img = kio.read_image_any_rgb8(args.image)
    synchronize(dev)
    t0 = time.perf_counter()
    toks, res = answer(model, cfg, img, args.max_new, dev)
    synchronize(dev)
    dt = time.perf_counter() - t0
    n = int(res.n_generated[0])
    print(f"generated {n} tokens in {dt * 1e3:.0f} ms: {toks}")
    return {"tokens": toks, "n_generated": n,
            "generated": res.tokens.cpu().numpy(), "ms": dt * 1e3}


if __name__ == "__main__":
    main()
