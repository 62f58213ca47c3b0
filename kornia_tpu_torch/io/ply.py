"""PLY pointcloud read/write (ascii + binary_little_endian); port of
kornia_tpu/io/ply.py, host numpy as there.

Capability parity with the reference's kornia-3d/src/io/ply/ (read/write
of XYZ + optional RGB + optional normals). From-scratch implementation of
the public PLY format.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


class PlyError(Exception):
    """Raised on malformed PLY files."""


_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read a PLY file's vertex element.

    Returns a dict with ``points`` (N, 3) f64 and, when present,
    ``colors`` (N, 3) u8 and ``normals`` (N, 3) f64.
    """
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise PlyError(f"not a PLY file: {path}")
        fmt = None
        n_vertices = 0
        props = []  # (name, numpy dtype str) for the vertex element
        in_vertex = False
        while True:
            line = f.readline()
            if not line:
                raise PlyError("unexpected EOF in PLY header")
            tokens = line.decode("ascii", "replace").split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                in_vertex = tokens[1] == "vertex"
                if in_vertex:
                    n_vertices = int(tokens[2])
            elif tokens[0] == "property" and in_vertex:
                if tokens[1] == "list":
                    raise PlyError("list properties unsupported on vertex")
                if tokens[1] not in _PLY_DTYPES:
                    raise PlyError(f"unknown PLY type {tokens[1]}")
                props.append((tokens[2], _PLY_DTYPES[tokens[1]]))
            elif tokens[0] == "end_header":
                break

        if fmt not in ("ascii", "binary_little_endian"):
            raise PlyError(f"unsupported PLY format: {fmt}")
        if not props:
            raise PlyError("no vertex properties")

        if fmt == "ascii":
            dtype = np.dtype([(n, t) for n, t in props])
            raw = np.loadtxt(f, dtype=np.float64, max_rows=n_vertices,
                             ndmin=2)
            if raw.shape[0] != n_vertices or raw.shape[1] != len(props):
                raise PlyError("PLY ascii body size mismatch")
            data = np.zeros(n_vertices, dtype)
            for i, (name, t) in enumerate(props):
                data[name] = raw[:, i].astype(t)
        else:
            dtype = np.dtype([(n, "<" + t) for n, t in props])
            buf = f.read(dtype.itemsize * n_vertices)
            if len(buf) < dtype.itemsize * n_vertices:
                raise PlyError("PLY binary body truncated")
            data = np.frombuffer(buf, dtype, count=n_vertices)

    names = {n for n, _ in props}
    out: Dict[str, np.ndarray] = {}
    if not {"x", "y", "z"} <= names:
        raise PlyError("PLY vertex element lacks x/y/z")
    out["points"] = np.stack(
        [data["x"], data["y"], data["z"]], axis=1).astype(np.float64)
    if {"red", "green", "blue"} <= names:
        out["colors"] = np.stack(
            [data["red"], data["green"], data["blue"]], axis=1
        ).astype(np.uint8)
    if {"nx", "ny", "nz"} <= names:
        out["normals"] = np.stack(
            [data["nx"], data["ny"], data["nz"]], axis=1).astype(np.float64)
    return out


def write_ply(
    path: str,
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,
    normals: Optional[np.ndarray] = None,
    binary: bool = True,
) -> None:
    """Write an (N, 3) pointcloud with optional u8 colors / f64 normals."""
    points = np.asarray(points, np.float64)
    if points.ndim != 2 or points.shape[1] != 3:
        raise PlyError(f"points must be (N, 3), got {points.shape}")
    n = points.shape[0]

    fields = [("x", "<f8"), ("y", "<f8"), ("z", "<f8")]
    header = [
        "ply",
        "format binary_little_endian 1.0" if binary else "format ascii 1.0",
        f"element vertex {n}",
        "property double x", "property double y", "property double z",
    ]
    if normals is not None:
        normals = np.asarray(normals, np.float64)
        fields += [("nx", "<f8"), ("ny", "<f8"), ("nz", "<f8")]
        header += ["property double nx", "property double ny",
                   "property double nz"]
    if colors is not None:
        colors = np.asarray(colors, np.uint8)
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header.append("end_header")

    data = np.zeros(n, np.dtype(fields))
    data["x"], data["y"], data["z"] = points[:, 0], points[:, 1], points[:, 2]
    if normals is not None:
        data["nx"], data["ny"], data["nz"] = (
            normals[:, 0], normals[:, 1], normals[:, 2])
    if colors is not None:
        data["red"], data["green"], data["blue"] = (
            colors[:, 0], colors[:, 1], colors[:, 2])

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            f.write(data.tobytes())
        else:
            cols = [data[name].astype(object) for name, _ in fields]
            for row in zip(*cols):
                f.write((" ".join(str(v) for v in row) + "\n").encode())
