"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/*.cu`` source compiles into its own shared library with a
plain C interface (no PyTorch headers, so a build takes seconds); the
``csrc/*.cuh`` headers they share are part of every source's key.  All
sources compile in parallel, into ``build/kernels/<hash>/`` at the root of
the checkout, keyed by a hash of the sources and the flags, so an edited
source rebuilds and an unchanged one is reused.  The build happens at the
first launch on a CUDA tensor (:func:`library`); nothing is compiled at
import.  A missing or failing ``nvcc`` raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
# source name -> the compiler's ``-Xptxas -v`` report of its last build
PTXAS_INFO: Dict[str, str] = {}


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME`` or
    ``/usr/local/cuda``; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin, "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> List[Path]:
    return sorted(CSRC.glob("*.cuh"))


def _digest(src: Path) -> str:
    """Key of a source's build: its text, every shared header's, the flags."""
    h = hashlib.sha256(src.read_bytes())
    for hdr in headers():
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, all at once (one
    ``nvcc`` process per source), and return source stem -> library path.
    Raises with the compiler's output on a failed build."""
    out: Dict[str, Path] = {}
    procs = []
    for src in sources():
        lib_dir = BUILD_ROOT / _digest(src)
        lib = lib_dir / f"lib{src.stem}.so"
        out[src.stem] = lib
        if lib.exists():
            continue
        lib_dir.mkdir(parents=True, exist_ok=True)
        tmp = lib_dir / f"lib{src.stem}.so.tmp{os.getpid()}"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, lib, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    for src, lib, tmp, cmd, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {src.name}:\n"
                f"{' '.join(cmd)}\n{log}")
        PTXAS_INFO[src.stem] = log
        os.replace(tmp, lib)          # atomic: a reader never sees half a file
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library built from ``csrc/<name>.cu``."""
    lib = _LIBS.get(name)
    if lib is None:
        for stem, path in build_all().items():
            if stem not in _LIBS:
                _LIBS[stem] = ctypes.CDLL(str(path))
        lib = _LIBS[name]
    return lib
