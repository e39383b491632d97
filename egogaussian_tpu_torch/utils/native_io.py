"""ctypes bindings for the native IO runtime (native/egogs_io.cpp).

Port of `egogaussian_tpu/utils/native_io.py` (which imports no JAX; this
is the port's own copy of the loader). The C++ sources and their Makefile
under native/ are shared by both packages. This is a host I/O
accelerator, not a device kernel.

Loads `native/libegogs_io.so` if built (`make -C native`, or
build_native()); every entry point returns None (or False) when the
library is absent, and the callers (utils/ply.py, data/colmap.py) then
take their pure-numpy path, which reads the same values and writes the
same bytes.
The native path matters for large checkpoints: COLMAP points3D parsing is a
per-point python loop in both the reference (colmap_loader.py:125-154) and
our fallback, ~100x slower than the C++ single pass.
"""
from __future__ import annotations

import ctypes
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

_LIB = None
_TRIED = False


def _lib_path() -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "native",
        "libegogs_io.so",
    )


def load_native():
    """Load (and cache) the native library; returns None if unavailable."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _lib_path()
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    lib.egogs_read_points3d_bin.restype = ctypes.c_longlong
    lib.egogs_read_points3d_bin.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.egogs_read_images_bin.restype = ctypes.c_longlong
    lib.egogs_read_images_bin.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong,
    ]
    lib.egogs_ply_header.restype = ctypes.c_longlong
    lib.egogs_ply_header.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p,
        ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong),
    ]
    lib.egogs_ply_read_f32.restype = ctypes.c_longlong
    lib.egogs_ply_read_f32.argtypes = [
        ctypes.c_char_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int32, ctypes.c_void_p,
    ]
    lib.egogs_ply_write_f32.restype = ctypes.c_longlong
    lib.egogs_ply_write_f32.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int32, ctypes.c_void_p,
        ctypes.c_longlong,
    ]
    _LIB = lib
    return _LIB


def build_native(verbose: bool = True) -> bool:
    """Compile the native library via make. Returns True on success."""
    import subprocess

    native_dir = os.path.dirname(_lib_path())
    res = subprocess.run(
        ["make", "-C", native_dir], capture_output=True, text=True
    )
    if verbose and res.returncode != 0:
        print(res.stdout, res.stderr)
    global _TRIED
    _TRIED = False  # force re-probe
    return res.returncode == 0


def read_points3d_bin_native(path: str):
    """Native COLMAP points3D.bin -> (xyz f32 [N,3], rgb01 f32 [N,3], err).
    Returns None if the native lib is unavailable."""
    lib = load_native()
    if lib is None:
        return None
    n = lib.egogs_read_points3d_bin(path.encode(), None, None, None)
    if n < 0:
        raise IOError(f"egogs_io failed to read {path}")
    xyz = np.empty((n, 3), np.float32)
    rgb = np.empty((n, 3), np.uint8)
    err = np.empty(n, np.float64)
    out = lib.egogs_read_points3d_bin(
        path.encode(),
        xyz.ctypes.data_as(ctypes.c_void_p),
        rgb.ctypes.data_as(ctypes.c_void_p),
        err.ctypes.data_as(ctypes.c_void_p),
    )
    if out != n:
        raise IOError(f"egogs_io short read: {path}")
    return xyz, rgb.astype(np.float32) / 255.0, err


def read_images_bin_native(path: str):
    """Native COLMAP images.bin -> (ids, qvecs, tvecs, cam_ids, names) or
    None if unavailable."""
    lib = load_native()
    if lib is None:
        return None
    n = lib.egogs_read_images_bin(path.encode(), None, None, None, None, None, 0)
    if n < 0:
        raise IOError(f"egogs_io failed to read {path}")
    ids = np.empty(n, np.int32)
    qvecs = np.empty((n, 4), np.float64)
    tvecs = np.empty((n, 3), np.float64)
    cam_ids = np.empty(n, np.int32)
    cap = int(n) * 256
    buf = ctypes.create_string_buffer(cap)
    out = lib.egogs_read_images_bin(
        path.encode(),
        ids.ctypes.data_as(ctypes.c_void_p),
        qvecs.ctypes.data_as(ctypes.c_void_p),
        tvecs.ctypes.data_as(ctypes.c_void_p),
        cam_ids.ctypes.data_as(ctypes.c_void_p),
        buf, cap,
    )
    if out != n:
        raise IOError(f"egogs_io failed to read {path} ({out})")
    names: List[str] = []
    off = 0
    raw = buf.raw
    for _ in range(n):
        end = raw.index(b"\x00", off)
        names.append(raw[off:end].decode("utf-8"))
        off = end + 1
    return ids, qvecs, tvecs, cam_ids, names


def read_ply_native(path: str) -> Optional[Tuple[Dict[str, np.ndarray], int]]:
    """Native PLY read (f32 binary_little_endian vertex element only);
    None if unavailable or the file needs the generic python reader."""
    lib = load_native()
    if lib is None:
        return None
    nprops = ctypes.c_int32(0)
    offset = ctypes.c_longlong(0)
    buf = ctypes.create_string_buffer(8192)
    n = lib.egogs_ply_header(path.encode(), ctypes.byref(nprops), buf, 8192,
                             ctypes.byref(offset))
    if n == -3:
        return None  # not pure-f32 binary; generic reader handles it
    if n < 0:
        raise IOError(f"egogs_io failed to parse {path}")
    names: List[str] = []
    off = 0
    raw = buf.raw
    for _ in range(nprops.value):
        end = raw.index(b"\x00", off)
        names.append(raw[off:end].decode())
        off = end + 1
    data = np.empty((n, nprops.value), np.float32)
    out = lib.egogs_ply_read_f32(
        path.encode(), offset.value, n, nprops.value,
        data.ctypes.data_as(ctypes.c_void_p),
    )
    if out != n:
        raise IOError(f"egogs_io short read: {path}")
    return {name: data[:, i].copy() for i, name in enumerate(names)}, int(n)


def write_ply_native(path: str, names: List[str], columns: np.ndarray) -> bool:
    lib = load_native()
    if lib is None:
        return False
    blob = b"".join(s.encode() + b"\x00" for s in names)
    data = np.ascontiguousarray(columns, np.float32)
    out = lib.egogs_ply_write_f32(
        path.encode(), blob, len(names),
        data.ctypes.data_as(ctypes.c_void_p), data.shape[0],
    )
    if out != data.shape[0]:
        raise IOError(f"egogs_io failed to write {path}")
    return True
