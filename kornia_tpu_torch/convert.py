"""Carry state from the JAX package into the port.

The learned weights are the models' (:func:`model_params`). The rest of
the state is the configurations (ORB, two-view, LK, preprocessor, SLAM, BA, PGO, ICP, the
augmentations), the stereo calibration, BA problems and the
distributed layer's sharded BA and PGO problems, bag-of-words
vocabularies, SLAM maps, images and, for stage-by-stage comparison, the
reference's intermediate arrays. The augmentations hold no weights: their
state across the packages is their settings, and the draws each call
takes (``draws=``, kornia_tpu_torch/augmentations.py). They
arrive as plain numpy / Python values (so this module imports nothing of
the JAX package) and leave as the port's objects and tensors on a given
device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from kornia_tpu_torch import augmentations as _aug
from kornia_tpu_torch import resolve_device, to_device
from kornia_tpu_torch.bow.vocabulary import Vocabulary
from kornia_tpu_torch.features.orb import OrbConfig
from kornia_tpu_torch.geometry.icp import ICPParams
from kornia_tpu_torch.geometry.stereo import StereoRectifier
from kornia_tpu_torch.geometry.twoview import TwoViewParams
from kornia_tpu_torch.image import ColorSpace, Image, ImageLayout
from kornia_tpu_torch.ops.optical_flow import PyrLKParams
from kornia_tpu_torch.ops.preprocess import (NormalizeMode,
                                             PreprocessorConfig, ResizeMode)
from kornia_tpu_torch.optim.ba import BAParams, BAProblem
from kornia_tpu_torch.optim.pgo import PGOParams
from kornia_tpu_torch.slam.map import Keyframe, SlamMap
from kornia_tpu_torch.slam.system import SlamConfig


def _config(cls, values: Mapping[str, Any]):
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = set(values) - fields
    if unknown:
        raise ValueError(f"{cls.__name__}: unknown fields {sorted(unknown)}")
    return cls(**{k: (v.item() if isinstance(v, np.generic) else v)
                  for k, v in values.items()})


def orb_config(values: Mapping[str, Any]) -> OrbConfig:
    """``dataclasses.asdict`` of the reference's OrbConfig → OrbConfig."""
    return _config(OrbConfig, values)


def twoview_params(values: Mapping[str, Any]) -> TwoViewParams:
    """``dataclasses.asdict`` of the reference's TwoViewParams →
    TwoViewParams."""
    return _config(TwoViewParams, values)


def pyrlk_params(values: Mapping[str, Any]) -> PyrLKParams:
    """``dataclasses.asdict`` of the reference's PyrLKParams → PyrLKParams."""
    return _config(PyrLKParams, values)


def slam_config(values: Mapping[str, Any]) -> SlamConfig:
    """``dataclasses.asdict`` of the reference's SlamConfig → SlamConfig."""
    return _config(SlamConfig, values)


def ba_params(values: Mapping[str, Any]) -> BAParams:
    """``dataclasses.asdict`` of the reference's BAParams → BAParams."""
    return _config(BAParams, values)


def pgo_params(values: Mapping[str, Any]) -> PGOParams:
    """``dataclasses.asdict`` of the reference's PGOParams → PGOParams."""
    return _config(PGOParams, values)


# the reference's tiled one-hot segment engine, which the port leaves out
_BA_ENGINE_FIELDS = ("seg_oh", "seg_ids", "cam_oh")


def ba_problem(fields: Mapping[str, Any], device="cuda") -> BAProblem:
    """``_asdict()`` of the reference's BAProblem, as numpy arrays (None
    for an absent optional field) → the port's BAProblem on ``device``,
    every array with its dtype and values; the engine fields
    (``seg_oh``, ``seg_ids``, ``cam_oh``) are dropped."""
    fields = {k: v for k, v in fields.items() if k not in _BA_ENGINE_FIELDS}
    missing = set(BAProblem._fields) - set(fields) - set(
        BAProblem._field_defaults)
    unknown = set(fields) - set(BAProblem._fields)
    if missing or unknown:
        raise ValueError(f"BAProblem fields: missing {sorted(missing)}, "
                         f"unknown {sorted(unknown)}")
    return BAProblem(**{k: None if v is None else tensor(v, device)
                        for k, v in fields.items()})


def sharded_problem(fields: Mapping[str, Any]):
    """``_asdict()`` of one of the reference's distributed problems
    (``parallel.ba_dist.ShardedBAProblem`` / ``KeyframeShardedBA``,
    ``parallel.pgo_dist.ShardedPGOProblem``), its arrays as numpy (None
    for an absent optional field; the rounds payload a tuple) → the
    port's NamedTuple of the same fields, host numpy like the port's
    planners give. The type is the one whose fields these are."""
    from kornia_tpu_torch.parallel import ba_dist, pgo_dist

    for cls in (ba_dist.ShardedBAProblem, ba_dist.KeyframeShardedBA,
                pgo_dist.ShardedPGOProblem):
        if set(fields) == set(cls._fields):
            break
    else:
        raise ValueError(f"not a distributed problem's fields: "
                         f"{sorted(fields)}")

    def host(v):
        if v is None or isinstance(v, (bool, int, str)):
            return v
        if isinstance(v, tuple) and all(isinstance(x, int) for x in v):
            return v                                  # rounds
        if isinstance(v, (tuple, list)):
            return tuple(np.asarray(x) for x in v)    # rounds payload
        return np.asarray(v)

    return cls(**{k: host(v) for k, v in fields.items()})


_VOCABULARY_FIELDS = ("k", "depth", "children", "node_desc", "word_id",
                      "word_weight")


def vocabulary(fields: Mapping[str, Any], device="cuda") -> Vocabulary:
    """``vars`` of the reference's Vocabulary (``k``, ``depth``,
    ``children``, ``node_desc``, ``word_id``, ``word_weight``) → the
    port's Vocabulary, its transforms on ``device``."""
    if set(fields) != set(_VOCABULARY_FIELDS):
        raise ValueError(f"Vocabulary fields: {sorted(fields)}, expected "
                         f"{sorted(_VOCABULARY_FIELDS)}")
    return Vocabulary(
        k=int(fields["k"]), depth=int(fields["depth"]),
        children=np.asarray(fields["children"], np.int32),
        node_desc=np.asarray(fields["node_desc"], np.uint8),
        word_id=np.asarray(fields["word_id"], np.int32),
        word_weight=np.asarray(fields["word_weight"], np.float32),
        device=device)


_SLAM_MAP_FIELDS = ("keyframes", "point_xyz", "point_desc", "point_valid",
                    "point_obs", "edges")
_KEYFRAME_FIELDS = ("kf_id", "frame_idx", "pose", "xy", "descriptors",
                    "point_ids")


def slam_map(fields: Mapping[str, Any]) -> SlamMap:
    """``dataclasses.asdict`` of the reference's SlamMap (keyframes as
    dicts of ``kf_id frame_idx pose xy descriptors point_ids``, points,
    observations, edges) → the port's SlamMap, host numpy in the
    reference's dtypes (float64 poses and points, u8 descriptors, int64
    point ids), every array copied."""
    if set(fields) != set(_SLAM_MAP_FIELDS):
        raise ValueError(f"SlamMap fields: {sorted(fields)}, expected "
                         f"{sorted(_SLAM_MAP_FIELDS)}")
    m = SlamMap()
    for kf in fields["keyframes"]:
        if set(kf) != set(_KEYFRAME_FIELDS):
            raise ValueError(f"Keyframe fields: {sorted(kf)}, expected "
                             f"{sorted(_KEYFRAME_FIELDS)}")
        m.keyframes.append(Keyframe(
            kf_id=int(kf["kf_id"]), frame_idx=int(kf["frame_idx"]),
            pose=np.array(kf["pose"], np.float64),
            xy=np.array(kf["xy"], np.float64),
            descriptors=np.array(kf["descriptors"], np.uint8),
            point_ids=np.array(kf["point_ids"], np.int64)))
    m.point_xyz = np.array(fields["point_xyz"], np.float64).reshape(-1, 3)
    m.point_desc = np.array(fields["point_desc"], np.uint8).reshape(-1, 32)
    m.point_valid = np.array(fields["point_valid"], bool)
    m.point_obs = [[(int(a), int(b)) for a, b in obs]
                   for obs in fields["point_obs"]]
    m.edges = [(int(i), int(j), np.array(rel, np.float64), float(w))
               for i, j, rel, w in fields["edges"]]
    return m


def preprocessor_config(values: Mapping[str, Any]) -> PreprocessorConfig:
    """``dataclasses.asdict`` of the reference's PreprocessorConfig →
    PreprocessorConfig. The two enum fields are matched by value (the
    reference's members, their ``.value`` strings or the port's members
    all do)."""
    values = dict(values)
    for key, enum_cls in (("resize_mode", ResizeMode),
                          ("normalize", NormalizeMode)):
        if key in values:
            v = values[key]
            values[key] = enum_cls(getattr(v, "value", v))
    for key in ("out_size", "mean", "std"):
        if key in values:
            values[key] = tuple(np.asarray(values[key]).tolist())
    return _config(PreprocessorConfig, values)


_RECTIFIER_FIELDS = ("k1", "d1", "k2", "d2", "image_size", "r1", "r2", "p1",
                     "p2", "q")


def stereo_rectifier_from_reference(fields: Mapping[str, Any]
                                    ) -> StereoRectifier:
    """``dataclasses.asdict`` (or ``vars``) of the reference's
    StereoRectifier — numpy ``k1 d1 k2 d2 image_size r1 r2 p1 p2 q`` — →
    the port's StereoRectifier, float64 as there (d1/d2 may be None)."""
    missing = set(_RECTIFIER_FIELDS) - set(fields)
    unknown = set(fields) - set(_RECTIFIER_FIELDS)
    if missing or unknown:
        raise ValueError(f"StereoRectifier fields: missing {sorted(missing)},"
                         f" unknown {sorted(unknown)}")

    def arr(v):
        return None if v is None else np.asarray(v, np.float64)

    return StereoRectifier(
        k1=arr(fields["k1"]), d1=arr(fields["d1"]), k2=arr(fields["k2"]),
        d2=arr(fields["d2"]),
        image_size=tuple(int(v) for v in fields["image_size"]),
        r1=arr(fields["r1"]), r2=arr(fields["r2"]), p1=arr(fields["p1"]),
        p2=arr(fields["p2"]), q=arr(fields["q"]))


def icp_params(values: Mapping[str, Any]) -> ICPParams:
    """``dataclasses.asdict`` of the reference's ICPParams → ICPParams."""
    return _config(ICPParams, values)


def image(fields: Mapping[str, Any], device="cuda") -> Image:
    """The reference Image's ``data`` (a numpy array), ``color_space`` and
    ``layout`` (its enum members or their ``.value`` strings) → an Image
    of the same tags, its data on ``device``."""
    unknown = set(fields) - {"data", "color_space", "layout"}
    if unknown or "data" not in fields:
        raise ValueError(f"Image fields: expected data, color_space, layout;"
                         f" got {sorted(fields)}")
    cs = fields.get("color_space", ColorSpace.UNKNOWN)
    lay = fields.get("layout", ImageLayout.HWC)
    return Image(tensor(fields["data"], device),
                 ColorSpace(getattr(cs, "value", cs)),
                 ImageLayout(getattr(lay, "value", lay)))


_AUGMENTATIONS = {cls.__name__: cls for cls in (
    _aug.RandomHorizontalFlip, _aug.RandomVerticalFlip, _aug.ColorJitter,
    _aug.RandomGaussianBlur, _aug.RandomAffine, _aug.RandomErasing)}


def augmentation(values: Mapping[str, Any]):
    """One augmentation: ``{"type": <the reference class's name>,
    **dataclasses.asdict(aug)}`` → the port's augmentation with the same
    settings (range pairs as tuples)."""
    values = dict(values)
    kind = values.pop("type", None)
    if kind not in _AUGMENTATIONS:
        raise ValueError(f"unknown augmentation type {kind!r}; expected one "
                         f"of {sorted(_AUGMENTATIONS)}")
    return _config(_AUGMENTATIONS[kind], {
        k: (tuple(np.asarray(v).tolist()) if isinstance(v, (list, tuple,
                                                            np.ndarray))
            else v) for k, v in values.items()})


def augmentation_pipeline(values: Mapping[str, Any], device="cuda"
                          ) -> "_aug.AugmentationPipeline":
    """``{"augs": [augmentation values, ...], "seed": int}`` → an
    AugmentationPipeline whose generator lives on ``device``."""
    return _aug.AugmentationPipeline(
        [augmentation(v) for v in values["augs"]],
        seed=int(values.get("seed", 0)), device=device)


# DenseGeneral kernels whose input is their first two axes (axis=(-2, -1))
_HEADS_IN = ("o", "proj")


def model_params(flat: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The reference's model params, flattened to numpy with ``'/'``-joined
    flax names (``flax.traverse_util.flatten_dict(params, sep="/")``; a
    leading ``params/`` optional) → the port's parameter names and
    layouts, as ``model.load_state_dict`` takes them (as numpy;
    ``models.load_params`` takes the flax names themselves and converts
    them here). DenseGeneral kernels (in…, out…) become Linear weights
    (out, in), the HWIO patch convolution OIHW, the embedding table the
    one ``tok_embed.weight`` that the lookup and the logits share,
    LayerNorm ``scale`` its ``weight``, and biases flat."""
    out = {}
    for key, arr in flat.items():
        a = np.asarray(arr)
        parts = key.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        leaf = parts[-1]
        mod = parts[-2] if len(parts) > 1 else ""
        if leaf == "kernel" and mod == "patch_embed":      # HWIO → OIHW
            a, leaf = a.transpose(3, 2, 0, 1), "weight"
        elif leaf == "kernel":
            n_in = a.ndim - 1 if mod in _HEADS_IN else 1
            a = a.reshape(int(np.prod(a.shape[:n_in])), -1).T
            leaf = "weight"
        elif leaf == "bias":
            a = a.reshape(-1)
        elif leaf in ("embedding", "scale"):
            leaf = "weight"
        out[".".join(parts[:-1] + [leaf])] = np.array(a)
    return out


def tensor(array, device="cuda", dtype: torch.dtype | None = None
           ) -> torch.Tensor:
    """One numpy array (pyramid level, keypoint xy, angles, descriptor
    bits, mask, ...) → a tensor of the same dtype on ``device`` (the card
    unless the caller asks for the CPU, as at every entry point)."""
    return to_device(np.asarray(array), resolve_device(device), dtype)


def tensors(arrays: Mapping[str, Any], device="cuda") -> Dict[str, Any]:
    """A dict of numpy arrays (or lists of them, e.g. pyramid levels) →
    the same keys holding tensors on ``device``."""
    out = {}
    for k, v in arrays.items():
        if isinstance(v, (list, tuple)):
            out[k] = [tensor(a, device) for a in v]
        else:
            out[k] = tensor(v, device)
    return out
