"""PCD (Point Cloud Data) read/write — ascii and binary encodings; port
of kornia_tpu/io/pcd.py, host numpy as there.

Capability parity with the reference's kornia-3d/src/io/pcd/. From-scratch
implementation of the public PCL .pcd format (v0.7): XYZ with optional
packed ``rgb`` float field and optional normals.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class PcdError(Exception):
    """Raised on malformed PCD files."""


_TYPE_MAP = {("F", 4): "f4", ("F", 8): "f8",
             ("I", 1): "i1", ("I", 2): "i2", ("I", 4): "i4",
             ("U", 1): "u1", ("U", 2): "u2", ("U", 4): "u4"}


def read_pcd(path: str) -> Dict[str, np.ndarray]:
    """Read a .pcd file; returns ``points`` (N,3) f64 and optionally
    ``colors`` (N,3) u8 (decoded from the packed float rgb field) and
    ``normals`` (N,3) f64."""
    header: Dict[str, list] = {}
    with open(path, "rb") as f:
        while True:
            line = f.readline()
            if not line:
                raise PcdError("unexpected EOF in PCD header")
            text = line.decode("ascii", "replace").strip()
            if not text or text.startswith("#"):
                continue
            key, *vals = text.split()
            header[key.upper()] = vals
            if key.upper() == "DATA":
                break

        try:
            fields = header["FIELDS"]
            sizes = [int(v) for v in header["SIZE"]]
            types = header["TYPE"]
            counts = [int(v) for v in header.get(
                "COUNT", ["1"] * len(fields))]
            n_points = int(header["POINTS"][0])
            data_mode = header["DATA"][0]
        except (KeyError, ValueError, IndexError) as e:
            raise PcdError(f"bad PCD header: {e}") from e
        if any(c != 1 for c in counts):
            raise PcdError("COUNT != 1 unsupported")

        np_fields = []
        for name, size, typ in zip(fields, sizes, types):
            key = (typ, size)
            if key not in _TYPE_MAP:
                raise PcdError(f"unsupported field {name} {typ}{size}")
            np_fields.append((name, "<" + _TYPE_MAP[key]))
        dtype = np.dtype(np_fields)

        if data_mode == "ascii":
            raw = np.loadtxt(f, dtype=np.float64, max_rows=n_points, ndmin=2)
            if raw.shape[0] != n_points:
                raise PcdError("PCD ascii body size mismatch")
            data = np.zeros(n_points, dtype)
            for i, (name, t) in enumerate(np_fields):
                if name == "rgb":
                    # ascii rgb is the packed u32 reinterpreted as float
                    data[name] = raw[:, i].astype(np.float32)
                else:
                    data[name] = raw[:, i].astype(t)
        elif data_mode == "binary":
            buf = f.read(dtype.itemsize * n_points)
            if len(buf) < dtype.itemsize * n_points:
                raise PcdError("PCD binary body truncated")
            data = np.frombuffer(buf, dtype, count=n_points)
        else:
            raise PcdError(f"unsupported DATA mode: {data_mode}")

    names = set(fields)
    if not {"x", "y", "z"} <= names:
        raise PcdError("PCD lacks x/y/z fields")
    out: Dict[str, np.ndarray] = {
        "points": np.stack([data["x"], data["y"], data["z"]],
                           axis=1).astype(np.float64)
    }
    if "rgb" in names:
        packed = data["rgb"].astype(np.float32).view(np.uint32)
        out["colors"] = np.stack(
            [(packed >> 16) & 0xFF, (packed >> 8) & 0xFF, packed & 0xFF],
            axis=1).astype(np.uint8)
    if {"normal_x", "normal_y", "normal_z"} <= names:
        out["normals"] = np.stack(
            [data["normal_x"], data["normal_y"], data["normal_z"]],
            axis=1).astype(np.float64)
    return out


def write_pcd(
    path: str,
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,
    binary: bool = True,
) -> None:
    """Write an (N, 3) pointcloud, colors packed into the float rgb field."""
    points = np.asarray(points, np.float32)
    if points.ndim != 2 or points.shape[1] != 3:
        raise PcdError(f"points must be (N, 3), got {points.shape}")
    n = points.shape[0]

    fields = ["x", "y", "z"]
    np_fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if colors is not None:
        colors = np.asarray(colors, np.uint8)
        fields.append("rgb")
        np_fields.append(("rgb", "<f4"))

    data = np.zeros(n, np.dtype(np_fields))
    data["x"], data["y"], data["z"] = points[:, 0], points[:, 1], points[:, 2]
    if colors is not None:
        packed = ((colors[:, 0].astype(np.uint32) << 16)
                  | (colors[:, 1].astype(np.uint32) << 8)
                  | colors[:, 2].astype(np.uint32))
        data["rgb"] = packed.view(np.float32)

    header = "\n".join([
        "# .PCD v0.7 - Point Cloud Data file format",
        "VERSION 0.7",
        "FIELDS " + " ".join(fields),
        "SIZE " + " ".join("4" for _ in fields),
        "TYPE " + " ".join("F" for _ in fields),
        "COUNT " + " ".join("1" for _ in fields),
        f"WIDTH {n}",
        "HEIGHT 1",
        "VIEWPOINT 0 0 0 1 0 0 0",
        f"POINTS {n}",
        "DATA " + ("binary" if binary else "ascii"),
    ]) + "\n"

    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(data.tobytes())
        else:
            for i in range(n):
                vals = [repr(float(data[name][i])) for name in fields]
                f.write((" ".join(vals) + "\n").encode("ascii"))
