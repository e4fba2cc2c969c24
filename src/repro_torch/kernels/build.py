"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each library is compiled at first use from the sources under
``src/repro_torch/csrc`` into ``<repo>/build/kernels/<name>-<hash>/``
(``.gitignore`` lists ``build/``), keyed on a hash of the sources, every
header (``*.cuh``) beside them and the flags, so an edited source or
header rebuilds and an unchanged tree loads at once.
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
    """Hash of the flags, ``sources`` and every ``*.cuh`` header in their
    directories (a source may include any of them)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted({f for src in sources for f in src.parent.glob("*.cuh")})
    for f in [*sources, *headers]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _out_dir(name: str, sources: Sequence[str]) -> Path:
    return BUILD_ROOT / f"{name}-{_digest([CSRC / s for s in sources])}"


def _compile(libs: Dict[str, Sequence[str]]) -> None:
    """Compile each library of ``libs`` (name -> file names under
    ``csrc/``) whose hashed build is missing: one nvcc each, all started
    at once; raises if any fails."""
    jobs = []
    for name, sources in libs.items():
        out_dir = _out_dir(name, sources)
        if (out_dir / f"lib{name}.so").exists():
            continue
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               *[str(CSRC / s) for s in sources]]
        log = out_dir / "build.log"
        log.write_text(" ".join(cmd) + "\n")
        with open(log, "a") as f:
            proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
        jobs.append((name, proc, tmp, out_dir, log))
    failed = []
    for name, proc, tmp, out_dir, log in jobs:
        if proc.wait() != 0:
            failed.append(f"nvcc failed for {name}:\n{log.read_text()}")
        else:
            os.replace(tmp, out_dir / f"lib{name}.so")
    if failed:
        raise RuntimeError("\n".join(failed))


def build_all(libs: Dict[str, Sequence[str]]) -> None:
    """Build every missing library of ``libs`` at once (first use on a
    machine compiles them all in the time of the slowest)."""
    with _LOCK:
        _compile(libs)


def load_library(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """Compile ``sources`` (file names under ``csrc/``) into
    ``lib<name>.so`` unless the hashed build exists, then load it."""
    with _LOCK:
        if name not in _LIBS:
            _compile({name: sources})
            _LIBS[name] = ctypes.CDLL(
                str(_out_dir(name, sources) / f"lib{name}.so"))
        return _LIBS[name]


def build_log(name: str, sources: Sequence[str]) -> str:
    """The compiler output (``-Xptxas -v``: registers, shared memory,
    spills) of the current build of ``name``, or '' if none exists."""
    log = _out_dir(name, sources) / "build.log"
    return log.read_text() if log.exists() else ""
