"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each library is compiled at first use from the sources under
``src/repro_torch/csrc`` into ``<repo>/build/kernels/<name>-<hash>/``
(``.gitignore`` lists ``build/``), keyed on a hash of the sources and the
flags, so an edited source rebuilds and an unchanged one loads at once.
Nothing is built when a module is imported: ``nvcc`` is needed only when
a kernel is first launched.
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

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-Xptxas", "-v", "-lineinfo")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _digest(sources: Sequence[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def load_library(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """Compile ``sources`` (file names under ``csrc/``) into
    ``lib<name>.so`` unless the hashed build exists, then load it."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        paths = [CSRC / s for s in sources]
        out_dir = BUILD_ROOT / f"{name}-{_digest(paths)}"
        lib_path = out_dir / f"lib{name}.so"
        if not lib_path.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                   *[str(p) for p in paths]]
            res = subprocess.run(cmd, capture_output=True, text=True)
            (out_dir / "build.log").write_text(
                " ".join(cmd) + "\n" + res.stdout + res.stderr)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{res.stderr}")
            os.replace(tmp, lib_path)
        _LIBS[name] = ctypes.CDLL(str(lib_path))
        return _LIBS[name]


def build_log(name: str, sources: Sequence[str]) -> str:
    """The compiler output (``-Xptxas -v``: registers, shared memory,
    spills) of the current build of ``name``, or '' if none exists."""
    paths = [CSRC / s for s in sources]
    log = BUILD_ROOT / f"{name}-{_digest(paths)}" / "build.log"
    return log.read_text() if log.exists() else ""
