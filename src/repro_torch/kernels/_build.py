"""Build the port's CUDA kernels and load them with ctypes.

Each source under repro_torch/csrc/ is compiled by its own nvcc process
(all started together) into a shared library with a plain C interface —
no PyTorch headers, so a build takes seconds. Libraries are keyed by a
hash of source, shared headers (csrc/*.cuh) and flags, so an edited source
is rebuilt and an unchanged one is reused. Output goes to build/repro_torch/ at the checkout's root
(listed in .gitignore), beside each library the compiler's log, which
holds ptxas' register and spill report.

Nothing is built or loaded at import: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# src/repro_torch/kernels/_build.py -> <checkout>/build/repro_torch
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("cadc_matmul.cu", "cadc_conv.cu", "cadc_bwd.cu",
           "cadc_conv_bwd.cu", "paged_attention.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built")
    return found


def library_path(source: str) -> Path:
    src = CSRC / source
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build(sources: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every source whose library is missing, one nvcc per source,
    all at once. Returns {source: library path}; raises on any failure."""
    sources = tuple(sources)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in sources:
        out = library_path(name)
        if out.is_file():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / name)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)
        jobs.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n"
                          f"{log.decode(errors='replace')}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: library_path(name) for name in sources}


@functools.lru_cache(maxsize=None)
def library(source: str) -> ctypes.CDLL:
    """The loaded library of `source`, built first if needed."""
    return ctypes.CDLL(str(build((source,))[source]))


def check(lib: ctypes.CDLL, prefix: str, code: int) -> None:
    """Raise on a nonzero CUDA error code returned by a launch function."""
    if code:
        msg = getattr(lib, f"{prefix}_error_string")(code).decode()
        raise RuntimeError(f"{prefix}: CUDA error {code}: {msg}")
