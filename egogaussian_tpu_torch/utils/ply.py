"""Minimal PLY reader/writer (binary little-endian + ascii), pure numpy.

Copy of `egogaussian_tpu/utils/ply.py` without its optional native-library
path: the same header and float32 body, so files are byte-identical to the
JAX package's. Implements the subset 3DGS checkpoints need: a single
'vertex' element of scalar properties.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

_PLY_DTYPES = {
    "char": "i1",
    "uchar": "u1",
    "short": "i2",
    "ushort": "u2",
    "int": "i4",
    "uint": "u4",
    "float": "f4",
    "double": "f8",
    "int8": "i1",
    "uint8": "u1",
    "int16": "i2",
    "uint16": "u2",
    "int32": "i4",
    "uint32": "u4",
    "float32": "f4",
    "float64": "f8",
}
_INV_DTYPES = {"f4": "float", "f8": "double", "i4": "int", "u4": "uint",
               "i1": "char", "u1": "uchar", "i2": "short", "u2": "ushort"}


def write_ply(
    path: str, names: List[str], columns: np.ndarray, binary: bool = True
) -> None:
    """Write a vertex-only PLY. columns: [N, len(names)] float32 (cast per
    column is uniform f4, matching the reference's save schema)."""
    n = columns.shape[0]
    header = ["ply"]
    header.append(
        "format binary_little_endian 1.0" if binary else "format ascii 1.0"
    )
    header.append(f"element vertex {n}")
    for name in names:
        header.append(f"property float {name}")
    header.append("end_header")
    data = np.ascontiguousarray(columns.astype("<f4"))
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            data.tofile(f)
        else:
            np.savetxt(f, data, fmt="%.8g")


def read_ply(path: str) -> Tuple[Dict[str, np.ndarray], int]:
    """Read the first (vertex) element of a PLY file.
    Returns ({property_name: [N] array}, N). Handles binary_little_endian and
    ascii; list properties are not supported (not used by 3DGS/COLMAP plys)."""
    with open(path, "rb") as f:
        # ---- header ----
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements: List[Tuple[str, int, List[Tuple[str, str]]]] = []
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            tokens = line.strip().split()
            if not tokens:
                continue
            if tokens[0] == b"format":
                fmt = tokens[1].decode()
            elif tokens[0] == b"comment":
                continue
            elif tokens[0] == b"element":
                elements.append((tokens[1].decode(), int(tokens[2]), []))
            elif tokens[0] == b"property":
                if tokens[1] == b"list":
                    raise ValueError(f"{path}: list properties unsupported")
                elements[-1][2].append(
                    (tokens[2].decode(), _PLY_DTYPES[tokens[1].decode()])
                )
            elif tokens[0] == b"end_header":
                break
        if not elements:
            return {}, 0
        name, count, props = elements[0]
        if fmt == "binary_little_endian":
            dtype = np.dtype([(p, "<" + d) for p, d in props])
            raw = np.fromfile(f, dtype=dtype, count=count)
        elif fmt == "ascii":
            rows = np.loadtxt(f, max_rows=count, ndmin=2)
            raw = np.rec.fromarrays(
                [rows[:, i].astype(d) for i, (_, d) in enumerate(props)],
                names=[p for p, _ in props],
            )
        else:
            raise ValueError(f"{path}: unsupported format {fmt}")
        return {p: np.asarray(raw[p]) for p, _ in props}, count
