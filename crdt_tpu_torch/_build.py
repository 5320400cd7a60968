"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled with ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, loaded with ``ctypes``.
Libraries go to ``build/kernels/`` at the repository root (git-ignored),
named by a hash of the sources and flags, so a changed source is rebuilt
and an unchanged one is reused.  Nothing here runs at import time: the
first kernel call builds what it needs, or ``build(SOURCES)`` builds every
library ahead of time, one nvcc per source, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# every kernel source of the package, by library name (csrc/<name>.cu)
SOURCES = ("lexn_union", "set_union", "set_floor", "set_member")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                           "crdt_tpu_torch's kernels")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _compile(names: Sequence[str]) -> None:
    """Run one nvcc per source in ``names``, all started together, and wait
    for every one of them."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc() if names else ""
    jobs = []
    for name in names:
        target = _target(name)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, target, tmp, proc))
    failed = []
    for name, target, tmp, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for csrc/{name}.cu:\n{out}")
            continue
        target.with_suffix(".log").write_text(out)
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("\n".join(failed))


def build(names: Sequence[str]) -> None:
    """Build every library of ``names`` that is not built yet, one nvcc per
    source, all in parallel."""
    with _LOCK:
        _compile([n for n in names if not _target(n).exists()])


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills) from
    the build of ``csrc/<name>.cu``, or "" when it was not built here."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            target = _target(name)
            if not target.exists():
                _compile([name])
            lib = _LIBS[name] = ctypes.CDLL(str(target))
    return lib
