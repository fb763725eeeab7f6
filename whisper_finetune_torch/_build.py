"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, under ``build/kernels/`` at the
root of the checkout, at first use. Each library's file name carries a hash
of the sources and flags, so an edited kernel rebuilds and an unchanged one
loads from disk. All sources compile in parallel (one ``nvcc`` each, all
started together). Libraries load with ``ctypes``; pointers and the stream go
as ``ctypes.c_void_p``, and every C entry returns ``cudaGetLastError()``,
which :func:`check` turns into an exception.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-lineinfo",
)
# Per-source extra flags. No FMA contraction in the fused AdamW kernel: it
# follows its plain version operation by operation, so the two agree to the
# last rounding.
EXTRA_FLAGS = {"fused_adamw8": ("-fmad=false",)}


def _flags(src: Path) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS.get(src.stem, ())


class KernelLibraries:
    """The loaded kernel libraries, by source stem (``attention``,
    ``fused_adamw8``). Built on first :func:`libraries` call."""

    def __init__(self, libs: Dict[str, ctypes.CDLL], build_seconds: float,
                 ptxas_log: str):
        self.libs = libs
        self.build_seconds = build_seconds
        self.ptxas_log = ptxas_log

    def __getitem__(self, name: str) -> ctypes.CDLL:
        return self.libs[name]


_LOADED: Optional[KernelLibraries] = None


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def nvcc_command(src: Path, out: Path) -> list:
    """The command that compiles one kernel source into the library ``out``."""
    return [_nvcc(), *_flags(src), "-I", str(CSRC), "-o", str(out), str(src)]


def _digest(src: Path) -> str:
    h = hashlib.sha256()
    h.update(" ".join(_flags(src)).encode())
    for dep in sorted(CSRC.glob("*.cuh")) + [src]:
        h.update(dep.name.encode())
        h.update(dep.read_bytes())
    return h.hexdigest()[:16]


def build_all(verbose_ptxas: bool = False) -> KernelLibraries:
    """Compile (where not cached) and load every ``csrc/*.cu``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        out = BUILD_DIR / f"{src.stem}-{_digest(src)}.so"
        proc = None
        if not out.exists():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = nvcc_command(src, tmp)
            if verbose_ptxas:
                cmd.insert(1, "-Xptxas=-v")
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((src, out, tmp, proc))
        else:
            jobs.append((src, out, None, None))
    log = []
    try:
        for src, out, tmp, proc in jobs:
            if proc is None:
                continue
            text, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{text}")
            os.replace(tmp, out)
            log.append(f"== {src.name}\n{text}")
    finally:
        for _, _, _, proc in jobs:  # a failed build leaves no nvcc running
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
    libs = {}
    for src, out, _, _ in jobs:
        lib = ctypes.CDLL(str(out))
        lib.wft_error_string.argtypes = [ctypes.c_int]
        lib.wft_error_string.restype = ctypes.c_char_p
        libs[src.stem] = lib
    return KernelLibraries(libs, time.perf_counter() - t0, "\n".join(log))


def libraries(verbose_ptxas: bool = False) -> KernelLibraries:
    """The process's kernel libraries, built on first use (``verbose_ptxas``
    keeps each kernel's register and spill report in ``ptxas_log``)."""
    global _LOADED
    if _LOADED is None:
        _LOADED = build_all(verbose_ptxas)
    return _LOADED


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error (a refused launch never runs
    and ``torch.cuda.synchronize()`` would not report it)."""
    if rc != 0:
        name = lib.wft_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({name})")


def stream_ptr() -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
