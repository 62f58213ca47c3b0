"""Seeded random augmentations (port of kornia_tpu/augmentations.py).

Each augmentation is a frozen dataclass of its settings. Calling it on an
(H, W, C) (or, for the geometric ones, (H, W)) u8 or f32 image draws its
random values from a ``torch.Generator`` and applies them. The reference
draws from a ``jax.random`` key instead, whose stream a generator cannot
reproduce, so every augmentation also takes ``draws=``: a dict with the
values the reference's ``jax.random`` calls give (:meth:`draw` returns the
same dict from a generator). With them it computes the reference's output:
this is the seam the tests replay the reference's draws through.

:class:`AugmentationPipeline` holds a generator seeded by ``seed`` (reset
by ``set_seed``) and applies its augmentations in order; its ``draws=`` is
a list with one dict per augmentation (per image in ``apply_batch``). The
ops run on the image's device with nothing read back: a random choice is a
``torch.where`` between both results, and ``RandomAffine`` warps through
:func:`kornia_tpu_torch.ops.warp.warp_affine`, one launch of the K7 kernel
on the card per image, its matrix made and inverted on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kornia_tpu_torch import resolve_device, to_device
from kornia_tpu_torch.ops import enhance, filters, geometry_utils, warp
from kornia_tpu_torch.ops.filters import div_scalar

# (img, generator=None, draws=None, device=...) -> img
Aug = Callable[..., torch.Tensor]
Draws = Dict[str, object]


def _uniform(gen, dev, lo: float = 0.0, hi: float = 1.0, shape=()):
    """Uniform float32 in [lo, hi) from ``gen`` on ``dev``."""
    u = torch.rand(shape, generator=gen, device=dev)
    return lo + (hi - lo) * u


def _bernoulli(gen, dev, p: float):
    return torch.rand((), generator=gen, device=dev) < p


def _on(v, dev, dtype=torch.float32) -> torch.Tensor:
    """A drawn value (a tensor, a numpy value or a Python number) as a
    tensor on ``dev``."""
    if not isinstance(v, torch.Tensor):
        v = torch.tensor(np.asarray(v))
    return to_device(v, dev, dtype)


def _as_float(img: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    if img.dtype == torch.uint8:
        return div_scalar(img.to(torch.float32), 255.0), True
    return img, False


def _to_u8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


def _restore(img: torch.Tensor, was_u8: bool) -> torch.Tensor:
    return _to_u8(img * 255.0) if was_u8 else img


class _Random:
    """Shared call: draw (or take ``draws``), then apply on ``device``."""

    def __call__(self, img, generator: Optional[torch.Generator] = None,
                 draws: Optional[Draws] = None, device="cuda"
                 ) -> torch.Tensor:
        dev = resolve_device(device)
        img = to_device(img, dev)
        if draws is None:
            draws = self.draw(generator, img)
        return self.apply(img, draws)

    def draw(self, generator, img) -> Draws:
        raise NotImplementedError

    def apply(self, img, draws: Draws) -> torch.Tensor:
        raise NotImplementedError


@dataclass(frozen=True)
class RandomHorizontalFlip(_Random):
    p: float = 0.5

    def draw(self, generator, img) -> Draws:
        """{"flip": bernoulli(p)}."""
        return {"flip": _bernoulli(generator, img.device, self.p)}

    def apply(self, img, draws: Draws) -> torch.Tensor:
        flip = _on(draws["flip"], img.device, torch.bool)
        return torch.where(flip, geometry_utils.hflip(img, device=img.device),
                           img)


@dataclass(frozen=True)
class RandomVerticalFlip(_Random):
    p: float = 0.5

    def draw(self, generator, img) -> Draws:
        """{"flip": bernoulli(p)}."""
        return {"flip": _bernoulli(generator, img.device, self.p)}

    def apply(self, img, draws: Draws) -> torch.Tensor:
        flip = _on(draws["flip"], img.device, torch.bool)
        return torch.where(flip, geometry_utils.vflip(img, device=img.device),
                           img)


@dataclass(frozen=True)
class ColorJitter(_Random):
    brightness: float = 0.2
    contrast: float = 0.2
    saturation: float = 0.2
    hue_deg: float = 10.0

    def draw(self, generator, img) -> Draws:
        """{"brightness", "contrast", "saturation": uniform(±setting),
        "hue": uniform(±hue_deg)} (saturation and hue are used on 3-channel
        images only)."""
        dev = img.device
        return {name: _uniform(generator, dev, -lim, lim) for name, lim in (
            ("brightness", self.brightness), ("contrast", self.contrast),
            ("saturation", self.saturation), ("hue", self.hue_deg))}

    def apply(self, img, draws: Draws) -> torch.Tensor:
        dev = img.device
        x, was_u8 = _as_float(img)
        b = 1.0 + _on(draws["brightness"], dev)
        c = 1.0 + _on(draws["contrast"], dev)
        x = torch.clamp(x * b, 0, 1)
        mean = x.mean(dim=(-3, -2, -1), keepdim=True)
        x = torch.clamp((x - mean) * c + mean, 0, 1)
        if img.ndim == 3 and img.shape[-1] == 3:
            s = 1.0 + _on(draws["saturation"], dev)
            gray = x.mean(dim=-1, keepdim=True)
            x = torch.clamp(gray + (x - gray) * s, 0, 1)
            x = enhance.adjust_hue(x, _on(draws["hue"], dev), device=dev)
        return _restore(x, was_u8)


@dataclass(frozen=True)
class RandomGaussianBlur(_Random):
    p: float = 0.5
    ksize: int = 5
    sigma_range: Tuple[float, float] = (0.3, 1.5)

    def draw(self, generator, img) -> Draws:
        """{"apply": bernoulli(p), "mix": uniform()}: the blur at a random
        sigma is the mix of the blurs at the two ends of the range."""
        dev = img.device
        return {"apply": _bernoulli(generator, dev, self.p),
                "mix": _uniform(generator, dev)}

    def apply(self, img, draws: Draws) -> torch.Tensor:
        dev = img.device
        x = img.to(torch.float32)
        k = (self.ksize, self.ksize)
        lo = filters.gaussian_blur(x, k, self.sigma_range[0])
        hi = filters.gaussian_blur(x, k, self.sigma_range[1])
        a = _on(draws["mix"], dev)
        out = torch.where(_on(draws["apply"], dev, torch.bool),
                          lo * (1 - a) + hi * a, x)
        return _to_u8(out) if img.dtype == torch.uint8 else out.to(img.dtype)


@dataclass(frozen=True)
class RandomAffine(_Random):
    degrees: float = 10.0
    translate: float = 0.05      # fraction of size
    scale_range: Tuple[float, float] = (0.9, 1.1)

    def draw(self, generator, img) -> Draws:
        """{"angle": uniform(±degrees), "translate": (2,) uniform(±translate),
        "scale": uniform(scale_range)}."""
        dev = img.device
        return {"angle": _uniform(generator, dev, -self.degrees, self.degrees),
                "translate": _uniform(generator, dev, -self.translate,
                                      self.translate, (2,)),
                "scale": _uniform(generator, dev, *self.scale_range)}

    def apply(self, img, draws: Draws) -> torch.Tensor:
        """Rotate and scale about the centre, then translate: the (2, 3)
        matrix is made on the image's device, and K7 warps by it."""
        dev = img.device
        h, w = img.shape[:2]
        ang = torch.deg2rad(_on(draws["angle"], dev))
        t = _on(draws["translate"], dev) * filters.const_on(
            (float(w), float(h)), dev)
        s = _on(draws["scale"], dev)
        c, si = torch.cos(ang) * s, torch.sin(ang) * s
        cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
        m = torch.stack([
            torch.stack([c, -si, cx - c * cx + si * cy + t[0]]),
            torch.stack([si, c, cy - si * cx - c * cy + t[1]]),
        ]).to(torch.float32)
        return warp.warp_affine(img, m, (h, w), device=dev)


@dataclass(frozen=True)
class RandomErasing(_Random):
    p: float = 0.5
    area: Tuple[float, float] = (0.02, 0.2)

    def draw(self, generator, img) -> Draws:
        """{"apply": bernoulli(p), "area": uniform(area), "x", "y", "fill":
        uniform()} (x and y place the box, fill is its value over the
        range)."""
        dev = img.device
        return {"apply": _bernoulli(generator, dev, self.p),
                "area": _uniform(generator, dev, *self.area),
                "x": _uniform(generator, dev), "y": _uniform(generator, dev),
                "fill": _uniform(generator, dev)}

    def apply(self, img, draws: Draws) -> torch.Tensor:
        dev = img.device
        h, w = img.shape[:2]
        side = torch.sqrt(_on(draws["area"], dev))
        eh = side * h
        ew = side * w
        y0 = _on(draws["y"], dev) * (h - eh)
        x0 = _on(draws["x"], dev) * (w - ew)
        ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
        xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
        inside = (ys >= y0) & (ys < y0 + eh) & (xs >= x0) & (xs < x0 + ew)
        if img.ndim == 3:
            inside = inside[:, :, None]
        fill = _on(draws["fill"], dev) * (255.0 if img.dtype == torch.uint8
                                          else 1.0)
        x = img.to(torch.float32)
        erased = torch.where(inside, fill, x)
        out = torch.where(_on(draws["apply"], dev, torch.bool), erased, x)
        return _to_u8(out) if img.dtype == torch.uint8 else out.to(img.dtype)


class AugmentationPipeline:
    """Seeded, replayable augmentation sequence.

    >>> pipe = AugmentationPipeline([RandomHorizontalFlip(), ColorJitter()],
    ...                             seed=0)
    >>> out = pipe(img)          # the generator advances
    >>> pipe.set_seed(0)
    >>> out_again = pipe(img)    # identical to ``out``
    """

    def __init__(self, augs: Sequence[Aug], seed: int = 0, device="cuda"):
        self.augs = list(augs)
        self.device = resolve_device(device)
        self._seed = seed
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

    def set_seed(self, seed: int) -> None:
        self._seed = seed
        self._gen.manual_seed(seed)

    def _apply(self, img, generator, draws: Optional[List[Draws]]):
        img = to_device(img, self.device)
        for i, aug in enumerate(self.augs):
            img = aug(img, generator=generator,
                      draws=None if draws is None else draws[i],
                      device=self.device)
        return img

    def __call__(self, img, draws: Optional[List[Draws]] = None
                 ) -> torch.Tensor:
        """``draws``: one dict per augmentation instead of the
        generator's."""
        return self._apply(img, self._gen, draws)

    def apply_batch(self, imgs, generator: Optional[torch.Generator] = None,
                    draws: Optional[List[List[Draws]]] = None
                    ) -> torch.Tensor:
        """Each image of the (B, H, W[, C]) batch with its own draws (from
        ``generator``, the pipeline's own by default, image after image; or
        ``draws[i]`` for image i), stacked."""
        gen = self._gen if generator is None else generator
        imgs = to_device(imgs, self.device)
        return torch.stack([
            self._apply(imgs[i], gen, None if draws is None else draws[i])
            for i in range(imgs.shape[0])])
