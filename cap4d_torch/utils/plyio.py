"""Minimal binary-little-endian PLY reader and writer on numpy structured
arrays (counterpart of ``cap4d_tpu/utils/plyio.py``).

Covers the subset the 3DGS checkpoints and the animated-avatar export need:
several named elements with f4/f8/u4/u1/i4 properties, no list properties.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

_DTYPE_TO_PLY = {
    np.dtype("float32"): "float",
    np.dtype("float64"): "double",
    np.dtype("uint8"): "uchar",
    np.dtype("int32"): "int",
    np.dtype("uint32"): "uint",
    np.dtype("int64"): "int",   # downcast on write
}
_PLY_TO_DTYPE = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "<i2", "ushort": "<u2", "int": "<i4", "int32": "<i4",
    "uint": "<u4", "uint32": "<u4",
}


def write_ply(path: str | Path, elements: List[Tuple[str, np.ndarray]]) -> None:
    """elements: list of (name, structured array) in file order."""
    header = ["ply", "format binary_little_endian 1.0"]
    for name, arr in elements:
        assert arr.dtype.names, f"element {name} must be a structured array"
        header.append(f"element {name} {len(arr)}")
        for field in arr.dtype.names:
            base = arr.dtype[field]
            ply_t = _DTYPE_TO_PLY[np.dtype(base.base if base.shape else base)]
            header.append(f"property {ply_t} {field}")
    header.append("end_header")

    with open(path, "wb") as fh:
        fh.write(("\n".join(header) + "\n").encode("ascii"))
        for _, arr in elements:
            out = arr
            # normalise int64 → int32 for the declared type
            if any(arr.dtype[f] == np.int64 for f in arr.dtype.names):
                newdt = np.dtype([
                    (f, "<i4" if arr.dtype[f] == np.int64 else arr.dtype[f].str)
                    for f in arr.dtype.names])
                out = arr.astype(newdt)
            fh.write(out.tobytes())


def read_ply(path: str | Path) -> Dict[str, np.ndarray]:
    """Returns {element_name: structured array}."""
    with open(path, "rb") as fh:
        line = fh.readline().strip()
        assert line == b"ply", "not a PLY file"
        fmt = fh.readline().strip().split()
        assert fmt[1] == b"binary_little_endian", "only binary_little_endian supported"

        elements = []  # (name, count, [(field, dtype)])
        while True:
            line = fh.readline().strip().decode("ascii")
            if line == "end_header":
                break
            parts = line.split()
            if parts[0] == "element":
                elements.append((parts[1], int(parts[2]), []))
            elif parts[0] == "property":
                assert parts[1] != "list", "list properties not supported"
                elements[-1][2].append((parts[2], _PLY_TO_DTYPE[parts[1]]))
            # comments ignored

        out = {}
        for name, count, fields in elements:
            dt = np.dtype(fields)
            buf = fh.read(dt.itemsize * count)
            out[name] = np.frombuffer(buf, dtype=dt, count=count).copy()
        return out


def structured(data: Dict[str, np.ndarray], dtype_char: str = "f4") -> np.ndarray:
    """Column dict → structured array (all same dtype)."""
    n = len(next(iter(data.values())))
    arr = np.empty(n, dtype=[(k, dtype_char) for k in data])
    for k, v in data.items():
        arr[k] = v
    return arr
