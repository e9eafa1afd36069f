"""Compile a kernel source with ``nvcc`` into a shared library at first use.

Each kernel package keeps its CUDA C++ under ``csrc/`` and builds it into
``build/`` beside it (git-ignored). The library is named by the hash of the
source and the flags, so an edited source builds anew and a stale library
is never loaded. ``nvcc -Xptxas -v`` writes each kernel's registers, shared
memory and spills into a ``.log`` next to the library.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put the CUDA toolkit's bin "
                           "directory on PATH or set CUDA_HOME")
    return path


def library_path(source: Path) -> Path:
    digest = hashlib.sha1(source.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return source.parent.parent / "build" / f"lib{source.stem}-{digest}.so"


def build(source: Path) -> Path:
    """Compile ``source`` unless its library exists; returns the library
    path. Raises with nvcc's output on failure."""
    out = library_path(source)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out
