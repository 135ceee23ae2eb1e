"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``build/kernels/lib<name>-<hash>.so``
under the repository root (``.gitignore`` lists ``build/``).  The hash
covers the source, every ``csrc/*.cuh`` header and the flags, so an
edited kernel or header rebuilds and an unchanged one is reused.  Nothing
here runs at import time: the CPU tests import every module on machines
with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"


class KernelBuildError(RuntimeError):
    """A kernel failed to build (``nvcc``) or to load (``ctypes``).  The
    engine's chunk retry and degradation ladder re-raise it untouched: a
    missing kernel is never replaced by a path without it."""


NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise KernelBuildError("nvcc not found: the CUDA kernels are built "
                               "on a machine with the CUDA toolkit")
    return path


def source_digest(name: str, csrc: Path = CSRC,
                  flags: "tuple[str, ...]" = NVCC_FLAGS) -> str:
    """Hash of ``csrc/<name>.cu``, every ``csrc/*.cuh`` (sorted by name)
    and the flags: what a build of ``name`` depends on."""
    h = hashlib.sha256()
    for path in [csrc / f"{name}.cu", *sorted(csrc.glob("*.cuh"))]:
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def build(name: str) -> "tuple[Path, str]":
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists.

    Returns ``(library path, compiler log)``; the log holds ``ptxas``'s
    register and spill report, kept beside the library so that a reused
    library returns the log of the build that made it.
    """
    src = CSRC / f"{name}.cu"
    lib = BUILD_DIR / f"lib{name}-{source_digest(name)}.so"
    log_path = lib.with_suffix(".log")
    if lib.exists() and log_path.exists():
        return lib, log_path.read_text()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise KernelBuildError(f"nvcc failed on {src.name} "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
    log = proc.stdout + proc.stderr
    log_tmp = log_path.with_name(f"{log_path.name}.{os.getpid()}.tmp")
    log_tmp.write_text(log)
    os.replace(log_tmp, log_path)
    os.replace(tmp, lib)  # atomic: concurrent builders never see half a file
    return lib, log


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, loaded once per process."""
    path = build(name)[0]
    try:
        return ctypes.CDLL(str(path))
    except OSError as e:
        raise KernelBuildError(f"cannot load {path.name}: {e}") from e
