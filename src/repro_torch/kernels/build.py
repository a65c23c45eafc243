"""Build the port's CUDA sources with ``nvcc`` at first use; load them
with ctypes.

Each ``csrc/*.cu`` file becomes one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds).  Libraries go
to ``build/repro_torch/<source stem>-<hash>/`` under the repository root
(listed in ``.gitignore``), keyed by a hash of the source, its path,
the shared headers (``*.cuh`` under ``kernels/``) and the flags, so an
edited source rebuilds and an unchanged one loads at once (the path: an
A/B tool's other checkout may hold the same source beside other
headers).  Nothing
here runs at import time: the CPU tests import every module of the port.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

KERNELS_DIR = Path(__file__).resolve().parent
REPO_ROOT = KERNELS_DIR.parents[2]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-Xptxas", "-v"]

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels are built from source at first use")
    return found


def _lib_dir(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    h.update(str(src.resolve()).encode())
    for header in sorted(KERNELS_DIR.rglob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}"


def build(src: Path) -> Path:
    """Compile ``src`` to a shared library unless an identical build
    exists; returns the library path.  The compiler's resource report
    (``-Xptxas -v``) is kept beside it as ``ptxas.log``."""
    out_dir = _lib_dir(src)
    lib = out_dir / f"lib{src.stem}.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".lib{src.stem}.{os.getpid()}.so"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "ptxas.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) for {src}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)          # atomic: concurrent builders agree
    return lib


def load(src: Path) -> ctypes.CDLL:
    """Build (if needed) and load one source; cached per process."""
    key = str(src)
    lib = _LOADED.get(key)
    if lib is None:
        lib = ctypes.CDLL(str(build(src)))
        _LOADED[key] = lib
    return lib


def build_all(sources: Iterable[Path]) -> Dict[str, Path]:
    """Compile several sources at once: one ``nvcc`` per source, all
    started together.  Returns {source: library path}."""
    sources = list(sources)
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as ex:
        libs = list(ex.map(build, sources))
    return {str(s): lib for s, lib in zip(sources, libs)}


def ptxas_log(src: Path) -> str:
    path = _lib_dir(src) / "ptxas.log"
    return path.read_text() if path.exists() else ""
