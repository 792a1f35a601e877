"""Build of the port's CUDA kernels: ``nvcc`` at first use, loaded by ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``_build/lib<name>.so`` (listed in ``.gitignore``) for ``sm_90a``.
Nothing includes PyTorch's headers, so a build takes seconds.  A library
is rebuilt when its source is newer; ``build`` starts one ``nvcc`` per
source, all at once, and waits for every one.  Nothing here runs at
import: the CPU tests import every module and have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, Path]:
    """Kernel name -> its CUDA source."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return path


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named kernels (default: all) whose library is missing or
    older than its source, one ``nvcc`` each, in parallel.  Returns the
    seconds each compile took (empty when nothing was stale); the compiler's
    register and shared-memory report lands in ``_build/<name>.log``."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    stale = [n for n in names
             if not library_path(n).exists()
             or library_path(n).stat().st_mtime < srcs[n].stat().st_mtime]
    if not stale:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in stale:
        tmp = BUILD_DIR / f"lib{n}.so.{os.getpid()}.tmp"
        procs[n] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(srcs[n])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)
    seconds, failed = {}, []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        (BUILD_DIR / f"{n}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n}:\n{log}")
            continue
        os.replace(tmp, library_path(n))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if it is stale."""
    if name not in _LIBS:
        build([name])
        _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return _LIBS[name]
