"""Point-cloud IO: PCD read/write + KITTI .bin frames (host side).

The reference persists maps as PCD via ``pcl::io::savePCDFile``
(``LM.cpp:1049-1052``, hardcoded paths) and ingests scans
from rosbags.  Bags are not a portable interchange format; this module speaks
PCD (ascii + binary, the useful subset of the spec) and KITTI-style .bin, and
prefers the native C++ reader (``alego_tpu_torch/runtime``) when it builds
(a copy of the reference package's module).
"""

from __future__ import annotations

import os

import numpy as np

_FIELD_FMT = {("F", 4): "f4", ("F", 8): "f8", ("I", 4): "i4", ("U", 4): "u4",
              ("I", 1): "i1", ("U", 1): "u1", ("I", 2): "i2", ("U", 2): "u2"}


def read_pcd(path: str) -> np.ndarray:
    """Read a PCD file; returns [N, C] float32 (x, y, z, [intensity...])."""
    try:
        from ..runtime.io_native import native_read_pcd

        out = native_read_pcd(path)
        if out is not None:
            return out
    except Exception:
        pass
    return read_pcd_py(path)


def read_pcd_py(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        fields, sizes, types, counts = [], [], [], []
        n_points = 0
        data_mode = "ascii"
        while True:
            line = f.readline().decode("ascii", "ignore").strip()
            if not line or line.startswith("#"):
                continue
            key, _, rest = line.partition(" ")
            key = key.upper()
            if key == "FIELDS":
                fields = rest.split()
            elif key == "SIZE":
                sizes = [int(x) for x in rest.split()]
            elif key == "TYPE":
                types = rest.split()
            elif key == "COUNT":
                counts = [int(x) for x in rest.split()]
            elif key == "POINTS":
                n_points = int(rest)
            elif key == "DATA":
                data_mode = rest.strip()
                break
        if not counts:
            counts = [1] * len(fields)
        dtype = np.dtype([
            (name if counts[i] == 1 else f"{name}{j}",
             _FIELD_FMT[(types[i], sizes[i])])
            for i, name in enumerate(fields) for j in range(counts[i])])
        if data_mode == "ascii":
            raw = np.loadtxt(f, dtype=np.float64, max_rows=n_points)
            raw = raw.reshape(n_points, -1)
            arr = raw
        elif data_mode == "binary":
            buf = f.read(dtype.itemsize * n_points)
            rec = np.frombuffer(buf, dtype=dtype, count=n_points)
            arr = np.stack([rec[name].astype(np.float64)
                            for name in rec.dtype.names], -1)
        elif data_mode == "binary_compressed":
            raise NotImplementedError("binary_compressed PCD not supported")
        else:
            raise ValueError(f"unknown PCD DATA mode {data_mode}")
    return arr.astype(np.float32)


def write_pcd(path: str, points: np.ndarray, binary: bool = True):
    """Write [N, 3] or [N, 4] points as PCD (matching /save_map output)."""
    points = np.asarray(points, np.float32)
    n, c = points.shape
    fields = ["x", "y", "z", "intensity"][:c]
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {' '.join(fields)}\n"
        f"SIZE {' '.join(['4'] * c)}\n"
        f"TYPE {' '.join(['F'] * c)}\n"
        f"COUNT {' '.join(['1'] * c)}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(points.tobytes())
        else:
            np.savetxt(f, points, fmt="%.6f")


def read_kitti_bin(path: str) -> np.ndarray:
    """KITTI velodyne .bin: float32 x, y, z, intensity."""
    return np.fromfile(path, np.float32).reshape(-1, 4)


def save_map(out_dir: str, map_dict: dict):
    """/save_map equivalent: writes keypose/corner/surf/outlier PCDs
    (LM.cpp:1049-1052, minus the hardcoded home directory)."""
    os.makedirs(out_dir, exist_ok=True)
    kp = map_dict["keyposes"]
    kp_pts = np.concatenate(
        [kp[:, :3, 3], np.arange(len(kp), dtype=np.float32)[:, None]], -1)
    write_pcd(os.path.join(out_dir, "keypose.pcd"), kp_pts)
    for name in ("corner", "surf", "outlier"):
        write_pcd(os.path.join(out_dir, f"{name}.pcd"), map_dict[name])
