"""Build and load the port's CUDA kernels.

Each source under ``kernels/**/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded
with ``ctypes``. Libraries are built on first use, from the sources in
the checkout alone, into ``build/repro_torch/`` at the root of the
checkout, named by a hash of the sources and flags: a changed source
gets a new library, and an unchanged one is reused. Each library is
written under a temporary name and moved into place with ``os.replace``,
so concurrent processes never load a half-written file. ``build``
starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence

_KERNELS = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS.parents[2] / "build" / "repro_torch"

# Every CUDA source of the port, built together by ``build(SOURCES)``. Code
# shared between sources lives in headers beside them (``*.cuh``) or in
# INCLUDE_DIRS (the tile products and ``cp.async`` helpers of
# ``sdc/csrc/tile_mma.cuh``, which ``binary_dot.cu`` uses too), all of which
# ``library_path`` hashes with the sources.
_SDC = _KERNELS / "sdc" / "csrc"
INCLUDE_DIRS = [_SDC]
BINARY_DOT = _KERNELS / "binary_dot" / "csrc" / "binary_dot.cu"
DOT_INTERACT = _KERNELS / "dot_interact" / "csrc" / "dot_interact.cu"
SOURCES: List[Path] = [_SDC / "sdc_topk.cu", _SDC / "gather_topk.cu", _SDC / "sdc_scores.cu",
                       BINARY_DOT, DOT_INTERACT]

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_loaded: Dict[Path, ctypes.CDLL] = {}


def nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def library_path(source: Path) -> Path:
    """Where the library of ``source`` lives: keyed by its directory's sources
    and the shared headers."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    files = sorted(source.parent.glob("*.cu*"))
    files += [f for d in INCLUDE_DIRS for f in sorted(d.glob("*.cuh"))]
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def build(sources: Sequence[Path] = SOURCES) -> List[Path]:
    """Compile every source whose library is missing, one nvcc each, in parallel.

    Returns the library paths. The compiler's output (register and
    shared-memory use per kernel) is kept beside each library as ``.log``.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    outs = [library_path(Path(s)) for s in sources]
    jobs = []
    for src, out in zip(sources, outs):
        if out.exists() or any(out == job[2] for job in jobs):  # built, or in this build
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, *(f"-I{d}" for d in INCLUDE_DIRS), "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((proc, tmp, out, cmd))
    failed = []
    for proc, tmp, out, cmd in jobs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return outs


def load(source: Path) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            (path,) = build([source])
            lib = ctypes.CDLL(str(path))
            _loaded[source] = lib
        return lib
