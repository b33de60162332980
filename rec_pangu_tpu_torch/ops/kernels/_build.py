"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each source under ``rec_pangu_tpu_torch/csrc/`` becomes one shared library
with a plain C interface, compiled for ``sm_90a``.  The library is built at
first use into ``rec_pangu_tpu_torch/_build/``, under a name keyed on a hash
of the source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.  A failed build raises with nvcc's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# library name -> its source under csrc/
SOURCES = {"embedding_lookup": "embedding_lookup.cu",
           "embedding_grad": "embedding_grad.cu",
           "fused_adam": "fused_adam.cu",
           "fused_encoder": "fused_encoder.cu",
           "global_attn": "global_attn.cu",
           "multimax_ce": "multimax_ce.cu",
           "row_topk": "row_topk.cu"}

_BUILD_TIMEOUT_S = 600
_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (looked on PATH, in $CUDA_HOME/bin and "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC_DIR / SOURCES[name]).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Build every named library that is not built yet, one nvcc process per
    source, all started together.  Returns name -> library path."""
    names = list(SOURCES if names is None else names)
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    try:
        for n in todo:
            tmp = paths[n].with_name(f"{paths[n].name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / SOURCES[n])]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp, cmd)
        for n, (proc, tmp, cmd) in procs.items():
            log, _ = proc.communicate(timeout=_BUILD_TIMEOUT_S)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {SOURCES[n]} "
                                   f"(exit {proc.returncode}): {' '.join(cmd)}\n{log}")
            os.replace(tmp, paths[n])  # atomic: a reader never sees half a file
    finally:
        for proc, tmp, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return paths


def load(name: str) -> ctypes.CDLL:
    """The built library ``name``, building it first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(str(build_all([name])[name]))
        return lib
