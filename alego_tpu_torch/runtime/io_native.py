"""ctypes bindings for the native IO runtime (``alego_io.cpp``), a copy of
the reference package's.

The library builds at first use with ``c++ -O2 -std=c++17 -fPIC -shared
-pthread`` into ``alego_tpu_torch/_build/`` (ignored by git), named by a
hash of its source; every caller falls back to the pure-Python
implementations in ``utils.io`` when no compiler is available.  This is host
file IO, not the device path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "alego_io.cpp"
_BUILD = Path(__file__).resolve().parent.parent / "_build"
_lock = threading.Lock()
_lib = None
_build_failed = False


def _lib_path() -> Path:
    digest = hashlib.sha1(_SRC.read_bytes()).hexdigest()[:12]
    return _BUILD / f"libalego_io-{digest}.so"


def _get_lib():
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path = _lib_path()
        if not path.exists():
            try:
                _BUILD.mkdir(parents=True, exist_ok=True)
                tmp = path.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run(
                    [os.environ.get("CXX", "c++"), "-O2", "-std=c++17", "-fPIC",
                     "-shared", "-pthread", "-o", str(tmp), str(_SRC)],
                    check=True, capture_output=True, timeout=120)
                os.replace(tmp, path)
            except Exception:
                _build_failed = True
                return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            _build_failed = True
            return None
        lib.alego_read_pcd.restype = ctypes.c_int64
        lib.alego_read_pcd.argtypes = [ctypes.c_char_p,
                                       ctypes.POINTER(ctypes.c_int)]
        lib.alego_copy_last.argtypes = [ctypes.POINTER(ctypes.c_float)]
        lib.alego_write_pcd.restype = ctypes.c_int
        lib.alego_write_pcd.argtypes = [ctypes.c_char_p,
                                        ctypes.POINTER(ctypes.c_float),
                                        ctypes.c_int64, ctypes.c_int]
        lib.alego_loader_create.restype = ctypes.c_void_p
        lib.alego_loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int,
            ctypes.c_int]
        lib.alego_loader_get.restype = ctypes.c_int64
        lib.alego_loader_get.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                         ctypes.POINTER(ctypes.c_int)]
        lib.alego_loader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _get_lib() is not None


def native_read_pcd(path: str):
    lib = _get_lib()
    if lib is None:
        return None
    stride = ctypes.c_int(0)
    n = lib.alego_read_pcd(path.encode(), ctypes.byref(stride))
    if n < 0:
        return None
    out = np.empty((n, stride.value), np.float32)
    lib.alego_copy_last(out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def native_write_pcd(path: str, points: np.ndarray) -> bool:
    lib = _get_lib()
    if lib is None:
        return False
    pts = np.ascontiguousarray(points, np.float32)
    rc = lib.alego_write_pcd(path.encode(),
                             pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                             pts.shape[0], pts.shape[1])
    return rc == 0


class FrameLoader:
    """Threaded prefetching loader over .pcd/.bin frame files.

    Hides disk latency behind the device compute of the previous frame — the
    native analogue of the reference's subscriber queues (depth 10, IP.cpp:73)
    without the serialize/deserialize copies.
    """

    def __init__(self, paths, n_threads: int = 2, queue_cap: int = 4):
        self._paths = [os.fspath(p) for p in paths]
        lib = _get_lib()
        self._lib = lib
        self._idx = 0
        if lib is not None:
            arr = (ctypes.c_char_p * len(self._paths))(
                *[p.encode() for p in self._paths])
            self._handle = lib.alego_loader_create(arr, len(self._paths),
                                                   n_threads, queue_cap)
        else:
            self._handle = None

    def __len__(self):
        return len(self._paths)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._idx >= len(self._paths):
            raise StopIteration
        idx = self._idx
        self._idx += 1
        if self._handle is not None:
            stride = ctypes.c_int(0)
            n = self._lib.alego_loader_get(self._handle, idx,
                                           ctypes.byref(stride))
            if n >= 0:
                out = np.empty((n, stride.value), np.float32)
                self._lib.alego_copy_last(
                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
                return out
        # fallback: synchronous python read
        from ..utils import io as pio

        p = self._paths[idx]
        return pio.read_kitti_bin(p) if p.endswith(".bin") else pio.read_pcd_py(p)

    def close(self):
        if self._handle is not None:
            self._lib.alego_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
