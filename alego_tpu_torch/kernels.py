"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, loaded through ``ctypes``; no PyTorch header is
compiled, so a build takes seconds.  Libraries are built at first use into
``alego_tpu_torch/_build/`` (ignored by git), named by a hash of their
source, so an edited source is rebuilt and a stale library is never loaded;
the compiler's output (``-Xptxas -v``: registers, stack frame, spills) is
kept beside each library (``lib<name>-<hash>.log``, :func:`build_log`).
Nothing here runs at import time.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
SOURCES = ("ccl", "gn", "nn", "nn1")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_libs: dict = {}

# Launches per kernel ("ccl", "nn1", "knn", "gn"): each wrapper adds one where it
# launches its kernel and nowhere else, so a run can show that its path went
# through the kernels.  ``LAUNCHES.clear()`` resets every count.  A frame
# replayed from a CUDA graph runs no wrapper: ``models.step_graph`` takes
# out what its warm-up and captures added (and keeps it) and adds the
# captured launches at each replay.
LAUNCHES: collections.Counter = collections.Counter()


def nvcc() -> str:
    """Path of the CUDA compiler."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _target(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:12]
    return BUILD / f"lib{name}-{digest}.so"


def _command(name: str, out: Path):
    return [nvcc(), ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names=SOURCES) -> dict:
    """Compile every missing library (or one built without its log), one
    ``nvcc`` per source, all started together.  Returns {name: compiler
    output} of the sources compiled; raises if any build fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists() and out.with_suffix(".log").exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(_command(name, tmp), stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{logs[name]}")
            continue
        tmp_log = tmp.with_suffix(".log")
        tmp_log.write_text(logs[name])
        os.replace(tmp, out)
        os.replace(tmp_log, out.with_suffix(".log"))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def build_log(name: str) -> str:
    """The compiler's output for ``csrc/<name>.cu`` as it stands, built
    first if it is not."""
    log = _target(name).with_suffix(".log")
    if not log.exists():
        build((name,))
    return log.read_text()


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        out = _target(name)
        if not out.exists():
            build((name,))
        lib = ctypes.CDLL(str(out))
        _libs[name] = lib
    return lib


def check(status: int, what: str):
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launcher."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {status}")
